"""Port parity, Mixture-of-Experts over a mesh (``models/moe.py``'s ``tp``
and ``ep`` modes against ``repro/models/moe.py``'s ``shard_map``).

One world of 4 ``gloo`` ranks (fresh processes, rendezvous by a file
under ``tmp_path``) runs reduced OLMoE-1B-7B's MoE layer (``ep``, 8
experts) and reduced granite-MoE-3B's (``tp``), in fp32 and bf16, on
(data, model) meshes of (1, 4), (2, 2) and (4, 1).  Each rank cuts its
block of the layer's parameters by ``distributed/sharding.py``'s specs
(``checkpoint.reshard``) and its data shard of the tokens, and saves its
output, its aux losses and the keep mask of its dispatch.  One JAX
subprocess with 4 fake host devices runs the reference's ``apply_moe``
under ``shard_map`` on the same parameters (initialised in JAX,
converted) and tokens (drawn with numpy).

Tolerances: fp32 within 1e-5 (summation order only: the same routing,
the sum over the model axis in another order); bf16 within the reference
test's ``atol=1e-2`` (``tests/test_sharding.py``: each rank's partial
output is rounded to bf16 before the bf16 sum).  Keep masks are held to
the bit: the union of a data shard's ranks' masks is the one-process
dispatch's on that shard's tokens (``ep``: the ranks' masks are
disjoint).  The reference's quirks are pinned: the capacity is counted
from a data shard's tokens, and every rank's aux is data shard 0's
(rtol 1e-5).  Then a forward of 2 groups of reduced OLMoE through
``run_layer_range`` under the mesh, only the MoE leaves cut
(``sharding.moe_only_specs``), against the port's one-process forward in
fp32; and the new collectives (``all_reduce``, ``broadcast``) to the bit.
The top-level imports stay free of jax: the ranks import this file.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import reduced_config
from repro_torch.distributed import collectives as coll
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.world import run_world
from repro_torch.launch.mesh import Mesh
from repro_torch.models import moe
from repro_torch.models import transformer as tr
from repro_torch.train import checkpoint

pytestmark = pytest.mark.multidevice

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
WORLD_TIMEOUT_S = 240
ARCHS = {"olmoe-1b-7b": "ep", "granite-moe-3b-a800m": "tp"}
DTYPES = ("float32", "bfloat16")
MESHES = ((1, 4), (2, 2), (4, 1))
LAYER_CASES = [(a, d, m) for a in ARCHS for d in DTYPES for m in MESHES]
B, S = 4, 16
#: the small model: reduced OLMoE (2 groups) in fp32, per mode and mesh
MODEL_CASES = (("ep", (1, 4)), ("ep", (2, 2)), ("tp", (1, 4)))
MODEL_B, MODEL_S = 4, 12
#: specs whose blocks on a (2, 2) mesh are held to jax's layout
LAYOUT_SPECS = ((("data", "model"),), (("model", "data"),),
                ("data", "model"), (None, ("data", "model")))
TOL = {"float32": dict(rtol=1e-5, atol=1e-5), "bfloat16": dict(atol=1e-2)}
#: bf16 partial sums, one a model rank, whose sum rounded once (260)
#: differs from a sum rounded after every add (256 in some orders)
PSUM_PARTS = (256.0, 1.0, 1.0, 1.0)

REFERENCE = """
import dataclasses, json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import reduced_config
from repro.jax_compat import make_mesh
from repro.models.moe import ShardCtx, apply_moe

out = sys.argv[1]
cases = json.load(open(os.path.join(out, "cases.json")))
data = dict(np.load(os.path.join(out, "inputs.npz")))
meshes = {tuple(m): make_mesh(tuple(m), ("data", "model"))
          for m in cases["meshes"]}
for arch, dtype, shape in cases["layers"]:
    cfg = dataclasses.replace(reduced_config(arch), param_dtype=dtype)
    tag = f"{arch}|{dtype}"
    p = {k.split("|")[-1]: jnp.asarray(v, jnp.float32 if k.endswith(
         "router") else dtype) for k, v in data.items()
         if k.startswith(tag + "|")}
    x = jnp.asarray(data["x"], dtype)
    ctx = ShardCtx(mesh=meshes[tuple(shape)], data_axes=("data",),
                   model_axis="model")
    y, aux = jax.jit(lambda p, x: apply_moe(p, x, cfg, ctx))(p, x)
    np.savez(os.path.join(out, f"ref|{tag}|{shape[0]}x{shape[1]}.npz"),
             y=np.asarray(y, np.float32),
             aux=np.array([aux["load_balance"], aux["router_z"]]))
from repro.jax_compat import shard_map
mesh = meshes[(1, 4)]
parts = jnp.asarray(np.array(cases["psum_parts"], np.float32)[:, None],
                    jnp.bfloat16)
psum = jax.jit(shard_map(lambda s: jax.lax.psum(s, "model"), mesh=mesh,
                         in_specs=P("model"), out_specs=P("model"),
                         check_vma=False))(parts)
np.save(os.path.join(out, "psum.npy"), np.asarray(psum, np.float32))
mesh = meshes[(2, 2)]
for i, spec in enumerate(cases["layout_specs"]):
    spec = P(*[tuple(e) if isinstance(e, list) else e for e in spec])
    where = NamedSharding(mesh, spec).devices_indices_map((8, 8))
    np.save(os.path.join(out, f"layout{i}.npy"), np.array(
        [[(s.start or 0, 8 if s.stop is None else s.stop) for s in where[d]]
         for d in mesh.devices.flat]))
"""


def _cfg(arch, dtype="float32", partitioning=None):
    cfg = dataclasses.replace(reduced_config(arch), param_dtype=dtype)
    if partitioning:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, partitioning=partitioning))
    return cfg


def _layer_params(data, arch, dtype):
    """The layer's parameters (converted from the reference's) in
    ``dtype``, the router fp32."""
    tag = f"{arch}|{dtype}|"
    return {k[len(tag):]: torch.tensor(v).to(
        torch.float32 if k.endswith("router") else getattr(torch, dtype))
        for k, v in data.items() if k.startswith(tag)}


def _inputs(dtype):
    return torch.from_numpy(np.random.default_rng(3).standard_normal(
        (B, S, reduced_config("olmoe-1b-7b").d_model)).astype(
            np.float32)).to(getattr(torch, dtype))


def _model_tokens():
    return torch.from_numpy(np.random.default_rng(4).integers(
        0, reduced_config("olmoe-1b-7b").vocab_size,
        (MODEL_B, MODEL_S)).astype(np.int32))


def _model_params():
    return tr.init_params(_cfg("olmoe-1b-7b"),
                          torch.Generator().manual_seed(5), "cpu")


def _record_keeps():
    """Patch ``moe._slots`` to append each dispatch's keep mask to the
    returned list; returns (list, undo)."""
    keeps, slots = [], moe._slots

    def recording(*args):
        out = slots(*args)
        keeps.append(out[1].clone())
        return out
    moe._slots = recording
    return keeps, lambda: setattr(moe, "_slots", slots)


def _rank_moe(rank, world_size, data, out):
    """One rank: every layer case, the small model, the collectives."""
    meshes = {m: Mesh(m, ("data", "model")) for m in MESHES}

    def save(name, **arrays):
        np.savez(os.path.join(out, f"{name}|r{rank}.npz"), **arrays)

    keeps, undo = _record_keeps()
    try:
        with torch.inference_mode():
            for arch, dtype, shape in LAYER_CASES:
                mesh, cfg = meshes[shape], _cfg(arch, dtype)
                ctx = shd.make_ctx(mesh)
                specs = shd.param_specs({"moe": _layer_params(
                    data, arch, dtype)}, cfg, mesh)["moe"]
                p = checkpoint.reshard(_layer_params(data, arch, dtype),
                                       shd.named(mesh, specs), device="cpu")
                x = shd.local_shard(_inputs(dtype),
                                    shd.P(ctx.data_axes, None, None), mesh)
                del keeps[:]
                y, aux = moe.apply_moe(p, x, cfg, ctx)
                save(f"{arch}|{dtype}|{shape[0]}x{shape[1]}",
                     y=y.float().numpy(),
                     aux=np.array([float(aux["load_balance"]),
                                   float(aux["router_z"])]),
                     keep=keeps[0].numpy(),
                     w_down=np.array(p["w_down"].shape),
                     contiguous=np.array([t.is_contiguous()
                                          for t in p.values()]))
            tokens, params = _model_tokens(), _model_params()
            for mode, shape in MODEL_CASES:
                mesh, cfg = meshes[shape], _cfg("olmoe-1b-7b",
                                                partitioning=mode)
                ctx = shd.make_ctx(mesh)
                local = checkpoint.reshard(params, shd.named(
                    mesh, shd.moe_only_specs(params, cfg, mesh)),
                    device="cpu")
                toks = shd.local_shard(tokens, shd.P(ctx.data_axes, None),
                                       mesh)
                x = tr.embed_tokens(local, toks, cfg)
                y = tr.run_layer_range(local, x, cfg, ctx, start_group=0,
                                       stop_group=cfg.num_groups(),
                                       positions=torch.arange(MODEL_S))
                save(f"model|{mode}|{shape[0]}x{shape[1]}", y=y.numpy())
    finally:
        undo()
    _rank_collectives(rank, meshes[(2, 2)], save)
    mesh = meshes[(1, 4)]
    part = torch.full((1, 1, 1), PSUM_PARTS[mesh.axis_index("model")],
                      dtype=torch.bfloat16)
    save("psum", y=moe._psum(part, shd.make_ctx(mesh)).float().numpy())


def _rank_collectives(rank, mesh, save):
    """all_reduce over the model axis (integer-valued fp32 and bf16, every
    sum exact) and broadcast over the data axis of a (2, 2) mesh."""
    rng = np.random.default_rng(rank)
    ints = torch.from_numpy(rng.integers(-8, 9, (6, 5)).astype(np.float32))
    before = ints.clone()
    stats = coll.HopStats()
    summed = coll.all_reduce(ints, "model", mesh=mesh, stats=stats)
    summed_bf16 = coll.all_reduce(ints.bfloat16(), "model", mesh=mesh)
    first = coll.broadcast(ints, "data", mesh=mesh)
    save("collectives", ints=ints.numpy(), summed=summed.numpy(),
         summed_bf16=summed_bf16.float().numpy(),
         bf16=np.array(summed_bf16.dtype == torch.bfloat16),
         first=first.numpy(), stats=np.array([stats.hops, stats.bytes]),
         untouched=np.array(torch.equal(ints, before)))


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """A loader: ``load(name, rank)`` a rank's saved arrays, ``load(name)``
    the reference's; and the inputs (``load("inputs")``)."""
    import jax
    from repro.configs import reduced_config as ref_reduced_config
    from repro.models import moe as ref_moe

    tmp = tmp_path_factory.mktemp("moe_sharded")
    data = {"x": _inputs("float32").numpy()}
    for i, (arch, dtype) in enumerate(
            (a, d) for a in ARCHS for d in DTYPES):
        cfg = dataclasses.replace(ref_reduced_config(arch),
                                  param_dtype=dtype)
        for k, v in ref_moe.init_moe(jax.random.PRNGKey(i), cfg).items():
            data[f"{arch}|{dtype}|{k}"] = np.asarray(v, np.float32)
    np.savez(tmp / "inputs.npz", **data)
    (tmp / "cases.json").write_text(json.dumps({
        "layers": LAYER_CASES, "meshes": MESHES,
        "layout_specs": LAYOUT_SPECS, "psum_parts": PSUM_PARTS}))
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", REFERENCE, str(tmp)], cwd=ROOT,
        env={**os.environ, "PYTHONPATH": "src", "JAX_PLATFORMS": "cpu"},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        (tmp / "ranks").mkdir()
        run_world(_rank_moe, WORLD, (data, str(tmp)), workdir=tmp / "ranks",
                  timeout=WORLD_TIMEOUT_S)
        _, err = jax_proc.communicate(timeout=WORLD_TIMEOUT_S)
    finally:
        if jax_proc.poll() is None:
            jax_proc.kill()
            jax_proc.wait()
    assert jax_proc.returncode == 0, err[-3000:]

    def load(name, rank=None):
        if name == "inputs":
            return data
        if rank is None and (name.startswith("layout") or name == "psum"):
            return np.load(tmp / f"{name}.npy")
        if rank is None:
            return dict(np.load(tmp / f"ref|{name}.npz"))
        return dict(np.load(tmp / f"{name}|r{rank}.npz"))
    return load


def _coords(shape, rank):
    return np.unravel_index(rank, shape)


def _name(arch, dtype, shape):
    return f"{arch}|{dtype}|{shape[0]}x{shape[1]}"


def _one_process(data, arch, dtype, rows):
    """The port's local layer on the tokens ``rows`` of the batch: its
    output, aux and keep mask."""
    cfg, p = _cfg(arch, dtype), _layer_params(data, arch, dtype)
    keeps, undo = _record_keeps()
    try:
        y, aux = moe.apply_moe(p, _inputs(dtype)[rows], cfg)
    finally:
        undo()
    return y, aux, keeps[0]


@pytest.mark.parametrize("arch,dtype,shape", LAYER_CASES)
def test_sharded_layer_matches_the_reference_s_shard_map(results, arch,
                                                         dtype, shape):
    """Every rank's output is its data shard's rows of the reference's;
    its parameters were cut to its block, fresh and contiguous."""
    want = results(_name(arch, dtype, shape))["y"]
    D, M = shape
    rows = B // D
    cfg = _cfg(arch)
    for rank in range(WORLD):
        got = results(_name(arch, dtype, shape), rank)
        d = _coords(shape, rank)[0]
        np.testing.assert_allclose(got["y"], want[d * rows:(d + 1) * rows],
                                   **TOL[dtype])
        E, f = cfg.moe.num_experts, cfg.moe.d_ff
        expect = ([E // M, f, cfg.d_model] if ARCHS[arch] == "ep"
                  else [E, f // M, cfg.d_model])
        assert got["w_down"].tolist() == expect
        assert got["contiguous"].all()


@pytest.mark.parametrize("arch,dtype,shape", LAYER_CASES)
def test_keep_masks_union_to_the_one_process_dispatch(results, arch, dtype,
                                                      shape):
    """Per data shard, the union of its ranks' keep masks is the local
    dispatch's on that shard's tokens alone (the capacity counted from
    them), to the bit; under ``ep`` no choice is kept twice."""
    D, M = shape
    rows = B // D
    for d in range(D):
        ranks = [r for r in range(WORLD) if _coords(shape, r)[0] == d]
        masks = np.stack([results(_name(arch, dtype, shape), r)["keep"]
                          for r in ranks])
        _, _, keep = _one_process(results("inputs"), arch, dtype,
                                  slice(d * rows, (d + 1) * rows))
        np.testing.assert_array_equal(masks.any(0), keep.numpy())
        if ARCHS[arch] == "ep" and M > 1:
            assert (masks.sum(0) <= 1).all()
        elif M > 1:
            assert (masks == masks[:1]).all()


@pytest.mark.parametrize("arch,dtype,shape", LAYER_CASES)
def test_every_rank_returns_data_shard_0_s_aux(results, arch, dtype, shape):
    """The reference's quirk: its aux ``out_specs`` is ``P()`` with
    ``check_vma=False``, so it returns data shard 0's losses; the port's
    ranks all return those, which are the local layer's on shard 0's
    tokens (and, for more than one shard, not shard 1's)."""
    D = shape[0]
    rows = B // D
    want = results(_name(arch, dtype, shape))["aux"]
    _, aux0, _ = _one_process(results("inputs"), arch, dtype, slice(0, rows))
    np.testing.assert_allclose(want, [float(aux0["load_balance"]),
                                      float(aux0["router_z"])], rtol=1e-5)
    for rank in range(WORLD):
        np.testing.assert_allclose(
            results(_name(arch, dtype, shape), rank)["aux"], want, rtol=1e-5)
    if D > 1:
        _, aux1, _ = _one_process(results("inputs"), arch, dtype,
                                  slice(rows, 2 * rows))
        assert float(aux1["load_balance"]) != pytest.approx(
            float(aux0["load_balance"]), rel=1e-5)


@pytest.mark.parametrize("mode,shape", MODEL_CASES)
def test_two_groups_of_olmoe_under_the_mesh(results, mode, shape):
    """``run_layer_range(0, G)`` with only the MoE leaves cut equals the
    port's one-process forward of each data shard's tokens, in fp32."""
    cfg = _cfg("olmoe-1b-7b", partitioning=mode)
    params, tokens = _model_params(), _model_tokens()
    D, rows = shape[0], MODEL_B // shape[0]
    with torch.inference_mode():
        want = [tr.run_layer_range(
            params, tr.embed_tokens(params, tokens[d * rows:(d + 1) * rows],
                                    cfg), cfg, moe.LOCAL_CTX,
            start_group=0, stop_group=cfg.num_groups(),
            positions=torch.arange(MODEL_S)) for d in range(D)]
    for rank in range(WORLD):
        got = results(f"model|{mode}|{shape[0]}x{shape[1]}", rank)["y"]
        np.testing.assert_allclose(got, want[_coords(shape, rank)[0]],
                                   rtol=1e-5, atol=1e-5)


def test_all_reduce_and_broadcast(results):
    """Exact sums over the model axis in fp32 and bf16 (the dtype kept),
    one hop of the tensor's bytes counted; the broadcast gives data
    index 0's tensor; the caller's tensor is left as it was."""
    shape = (2, 2)
    got = [results("collectives", r) for r in range(WORLD)]
    for rank in range(WORLD):
        d, m = _coords(shape, rank)
        partner = [r for r in range(WORLD)
                   if _coords(shape, r)[0] == d and r != rank][0]
        source = [r for r in range(WORLD)
                  if _coords(shape, r) == (0, m)][0]
        want = got[rank]["ints"] + got[partner]["ints"]
        np.testing.assert_array_equal(got[rank]["summed"], want)
        np.testing.assert_array_equal(got[rank]["summed_bf16"], want)
        assert got[rank]["bf16"]
        np.testing.assert_array_equal(got[rank]["first"],
                                      got[source]["ints"])
        assert got[rank]["stats"].tolist() == [1, 6 * 5 * 4]
        assert got[rank]["untouched"]


def test_the_sum_over_the_model_axis_rounds_once_as_xla_s(results):
    """bf16 partials summed as the reference's psum sums them: one
    rounding of the exact sum, on every rank."""
    want = results("psum")
    assert want.ravel().tolist() == [260.0] * 4
    for rank in range(WORLD):
        assert results("psum", rank)["y"].ravel().tolist() == [260.0]


@pytest.mark.parametrize("index", range(len(LAYOUT_SPECS)))
def test_local_shard_is_jax_s_layout(results, index):
    """Each rank's block on a (2, 2) mesh is the one jax places on the
    mesh's device of that rank (``devices_indices_map``)."""
    spec = LAYOUT_SPECS[index]
    mesh = Mesh((2, 2), ("data", "model"))
    a = torch.arange(64).reshape(8, 8)
    want = results(f"layout{index}")
    for rank in range(mesh.size):
        (r0, r1), (c0, c1) = want[rank]
        got = shd.local_shard(a, shd.P(*spec), mesh, rank=rank)
        assert torch.equal(got, a[r0:r1, c0:c1])


def _sharded_ctx(shape):
    mesh = Mesh(shape, ("data", "model"))
    return mesh, shd.make_ctx(mesh)


def test_ep_refuses_an_expert_count_the_model_axis_does_not_divide():
    cfg = _cfg("olmoe-1b-7b")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, num_experts=6))
    p = moe.init_moe(torch.Generator().manual_seed(0), cfg, "cpu")
    _, ctx = _sharded_ctx((1, 4))
    with pytest.raises(ValueError, match="6 experts do not split"):
        moe.apply_moe(p, torch.zeros(1, 4, cfg.d_model), cfg, ctx)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_sharded_layer_refuses_autograd_and_whole_weights(arch):
    """No backward through the sum over the model axis; and a rank handed
    the whole layer (not its block) is refused, not summed four times."""
    cfg = _cfg(arch)
    p = moe.init_moe(torch.Generator().manual_seed(0), cfg, "cpu")
    _, ctx = _sharded_ctx((1, 4))
    x = torch.zeros(1, 4, cfg.d_model, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        moe.apply_moe(p, x, cfg, ctx)
    with torch.no_grad(), pytest.raises(ValueError, match="block"):
        moe.apply_moe(p, x, cfg, ctx)
