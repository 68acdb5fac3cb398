"""Port parity, training over a mesh whose data axis and model axis are
both above 1 (``train/train_loop.py`` over (2, 2)) against the
reference's ``TrainLoop`` with a ctx on 4 fake host devices
(``make_ctx(make_host_mesh(2, 2))``, where GSPMD lays the step out).

One world of 4 ``gloo`` ranks (fresh processes, rendezvous by a file
under ``tmp_path``; rank r is data rank r // 2 and model rank r % 2)
trains reduced h2o-danube-1.8b (sequences of 64) and reduced smollm-135m
(sequences of 32, tied embeddings) in fp32 for STEPS steps of a global
batch of BATCH: each rank on its 2 rows and its ``param_specs`` blocks
(danube: 2 of the 4 query heads, the one kv head whole, half of ``d_ff``
and of the padded vocabulary; smollm: its 3 heads whole on both model
ranks, half of ``d_ff`` and of the vocabulary), the blocks' gradients
summed over the data ranks that share its model index, and its data
block of its model block of the masters, m and v (ZeRO-1).  Each rank
also takes, at the initial tree, its rows' gradients of its blocks and
their sum over the data axis, and gathers the data blocks of its model
blocks back.  One JAX subprocess with 4 fake host devices runs the
reference's ``TrainLoop`` from the same initial tree (drawn in JAX here,
converted, and handed to the ranks as numpy; never re-drawn).

Tolerances: losses and gradient norms rtol 1e-4 against the reference
(as ``tests/test_torch_train.py`` holds one device); the state's blocks
rtol 1e-4 against the reference's state, with an atol for elements near
zero (AdamW's first steps move a weight by about the learning rate
whatever its gradient's size, so the masters take STATE_ATOL; m and v
an atol of STATE_ATOL_OF_MAX of the leaf's largest value, as
``tests/test_torch_train_data_parallel.py`` holds them); the ranks'
summed gradients, gathered over the model axis, rtol 1e-5 against the
port's one-device gradients (the sums add in another order), with that
atol.  Held to the bit: the summed gradient against one process adding
the two data ranks' scaled gradients in rank order; after each step,
the ranks that share a model index on every leaf, and every leaf held
whole on all four ranks.  The top-level imports stay free of jax: the
ranks import this file.
"""
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import reduced_config
from repro_torch.convert import (from_jax_params, keystr,
                                tree_leaves_with_path, tree_map)
from repro_torch.data.pipeline import DataConfig, batch_for_config
from repro_torch.distributed import collectives, sharding
from repro_torch.distributed.world import run_world
from repro_torch.launch.mesh import Mesh, make_host_mesh
from repro_torch.models import transformer as tr
from repro_torch.train import checkpoint, optimizer, train_loop

pytestmark = pytest.mark.multidevice
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D, M = 2, 2
WORLD = D * M
WORLD_TIMEOUT_S = 240
ARCHS = ("h2o-danube-1.8b", "smollm-135m")
SEQ = {"h2o-danube-1.8b": 64, "smollm-135m": 32}
STEPS, BATCH = 3, 4
HP = dict(peak_lr=3e-3, warmup_steps=3, total_steps=20)
STATE = ("master", "m", "v")
GRAD_RTOL, GRAD_ATOL_OF_MAX = 1e-5, 1e-6
STATE_RTOL, STATE_ATOL, STATE_ATOL_OF_MAX = 1e-4, 1e-4, 1e-5

REFERENCE = """
import dataclasses, json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np, jax
from repro.configs import reduced_config
from repro.data.pipeline import DataConfig
from repro.distributed import sharding as shd
from repro.launch.mesh import make_host_mesh
from repro.models import transformer as tr
from repro.train.optimizer import AdamWConfig
from repro.train.train_loop import TrainConfig, TrainLoop

out = sys.argv[1]
case = json.load(open(os.path.join(out, "case.json")))
assert len(jax.devices()) == 4
ctx = shd.make_ctx(make_host_mesh(2, 2))
assert dict(ctx.mesh.shape) == {"data": 2, "model": 2}
keystr = jax.tree_util.keystr
init_params = tr.init_params
for arch, seq in case["runs"]:
    cfg = dataclasses.replace(reduced_config(arch), param_dtype="float32")
    init = dict(np.load(os.path.join(out, f"init|{arch}.npz")))
    shapes = jax.eval_shape(lambda k: init_params(cfg, k),
                            jax.random.PRNGKey(0))
    paths, treedef = jax.tree_util.tree_flatten_with_path(shapes)
    tree = jax.tree_util.tree_unflatten(
        treedef, [jax.numpy.asarray(init[keystr(p)]) for p, _ in paths])
    tr.init_params = lambda c, key: tree
    saved = {}

    def on_step(step, params, opt_state, metrics):
        if step + 1 != case["steps"]:
            return
        for name in ("master", "m", "v"):
            for p, leaf in jax.tree_util.tree_flatten_with_path(
                    opt_state[name])[0]:
                saved[name + "|" + keystr(p)] = np.asarray(leaf)

    loop = TrainLoop(cfg, DataConfig(cfg.vocab_size, seq, case["batch"]),
                     TrainConfig(optimizer=AdamWConfig(**case["hp"]),
                                 log_every=1), ctx=ctx)
    _, _, hist = loop.run(case["steps"], on_step=on_step)
    np.savez(os.path.join(out, f"ref|{arch}.npz"), **saved)
    with open(os.path.join(out, f"ref|{arch}.json"), "w") as f:
        json.dump([{k: float(h[k]) for k in ("step", "loss", "grad_norm")}
                   for h in hist], f)
"""


def _cfg(arch):
    return dataclasses.replace(reduced_config(arch), param_dtype="float32")


def _dc(arch):
    return DataConfig(vocab_size=_cfg(arch).vocab_size, seq_len=SEQ[arch],
                      global_batch=BATCH)


def _tc():
    return train_loop.TrainConfig(optimizer=optimizer.AdamWConfig(**HP),
                                  log_every=1)


def _mesh():
    return Mesh((D, M), ("data", "model"))


def _flat(tree):
    return {keystr(p): t.detach().numpy().copy()
            for p, t in tree_leaves_with_path(tree)}


def _torch_tree(tree, device="cpu"):
    """The reference's numpy tree as tensors in torch's own memory."""
    return tree_map(torch.clone, from_jax_params(tree, device))


def _by_key(specs):
    return {keystr(p): s for p, s in tree_leaves_with_path(
        specs, lambda x: isinstance(x, sharding.P))}


def _model_specs(arch):
    return _by_key(train_loop.model_specs(_cfg(arch),
                                          sharding.make_ctx(_mesh())))


def _zero1_specs(arch):
    """The reference's combined specs of the state (model and data axes)
    and the data-only specs a rank applies to its model blocks."""
    cfg, ctx = _cfg(arch), sharding.make_ctx(_mesh())
    whole = train_loop.zero1_specs(tr.init_params(cfg, torch.Generator(),
                                                  "meta"), cfg, ctx)
    return (_by_key(whole["master"]),
            _by_key(train_loop.state_specs(cfg, ctx)["master"]))


def _batch(arch, step=0):
    return {k: torch.from_numpy(v) for k, v in
            batch_for_config(_cfg(arch), _dc(arch), step).items()}


def _at_the_initial_tree(arch, tree, ctx):
    """This rank's rows' gradients of its blocks at the initial tree,
    its share of the mask, the gradients summed over the data axis, and
    its model blocks gathered back from their data blocks."""
    cfg = _cfg(arch)
    own = checkpoint.reshard(_torch_tree(tree), sharding.named(
        ctx.mesh, train_loop.model_specs(cfg, ctx)), "cpu")
    rows, share = train_loop._rows(_batch(arch), ctx)
    (_, metrics), grads = train_loop.value_and_grad(cfg, own, rows, ctx)
    summed, summed_metrics = train_loop.sum_over_data(grads, metrics, share,
                                                      ctx)
    specs = train_loop.state_specs(cfg, ctx)["master"]
    stats = collectives.HopStats()
    back = train_loop.gather_blocks(
        train_loop.local_blocks(own, specs, ctx), specs, ctx, stats)
    return {"grads": _flat(grads), "share": share.numpy().copy(),
            "summed": _flat(summed),
            "loss": float(summed_metrics["loss"]),
            "gather_equal": {k: bool(np.array_equal(v, _flat(own)[k]))
                             for k, v in _flat(back).items()},
            "gather_hops": dataclasses.asdict(stats)}


def _rank(rank, world_size, trees):
    ctx = sharding.make_ctx(make_host_mesh(D, M))
    assert dict(ctx.mesh.shape) == {"data": D, "model": M}
    out = {"data": ctx.mesh.axis_index("data"),
           "model": ctx.mesh.axis_index("model")}
    for arch in ARCHS:
        cfg = _cfg(arch)
        tr.init_params = lambda c, gen, dev: _torch_tree(trees[arch], dev)
        after_step = []

        def on_step(step, params, opt_state, metrics):
            after_step.append({"params": _flat(params),
                               "loss": float(metrics["loss"]),
                               "grad_norm": float(metrics["grad_norm"])})
        loop = train_loop.TrainLoop(cfg, _dc(arch), _tc(), ctx=ctx,
                                    device="cpu")
        params, opt_state, hist = loop.run(STEPS, on_step=on_step)
        out[arch] = {"hist": hist, "after_step": after_step,
                     "step": int(opt_state["step"]),
                     **{k: _flat(opt_state[k]) for k in STATE},
                     "hops": {k: dataclasses.asdict(v)
                              for k, v in loop.hop_stats.items()},
                     "initial": _at_the_initial_tree(arch, trees[arch], ctx)}
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    import jax
    from repro.configs import reduced_config as ref_reduced_config
    from repro.models import transformer as ref_tr
    tmp = tmp_path_factory.mktemp("train_2d")
    trees = {}
    for arch in ARCHS:
        ref_cfg = dataclasses.replace(ref_reduced_config(arch),
                                      param_dtype="float32")
        ref_params = jax.jit(lambda key: ref_tr.init_params(ref_cfg, key))(
            jax.random.PRNGKey(0))
        trees[arch] = jax.tree_util.tree_map(np.asarray, ref_params)
        np.savez(tmp / f"init|{arch}.npz", **{
            jax.tree_util.keystr(p): a for p, a in
            jax.tree_util.tree_flatten_with_path(trees[arch])[0]})
    with open(tmp / "case.json", "w") as f:
        json.dump({"runs": [[a, SEQ[a]] for a in ARCHS], "steps": STEPS,
                   "batch": BATCH, "hp": HP}, f)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    ref = subprocess.Popen([sys.executable, "-c", REFERENCE, str(tmp)],
                           cwd=ROOT, env=env, stdout=subprocess.PIPE,
                           stderr=subprocess.STDOUT, text=True)
    try:
        (tmp / "world").mkdir()
        ranks = run_world(_rank, WORLD, (trees,), workdir=tmp / "world",
                          timeout=WORLD_TIMEOUT_S)
        one = {}
        for arch in ARCHS:
            (loss, _), grads = train_loop.value_and_grad(
                _cfg(arch), _torch_tree(trees[arch]), _batch(arch))
            one[arch] = {"loss": float(loss), "grads": _flat(grads)}
        log, _ = ref.communicate(timeout=WORLD_TIMEOUT_S)
    finally:
        if ref.poll() is None:
            ref.kill()
    assert ref.returncode == 0, log
    want = {}
    for arch in ARCHS:
        with open(tmp / f"ref|{arch}.json") as f:
            want[arch] = {"hist": json.load(f), **dict(
                np.load(tmp / f"ref|{arch}.npz").items())}
    return {"ranks": ranks, "want": want, "one": one}


def _cuts_model(spec):
    return any("model" in (e if isinstance(e, tuple) else (e,))
               for e in spec)


def _close(got, want, rtol=GRAD_RTOL, err_msg=""):
    np.testing.assert_allclose(
        got, want, rtol=rtol,
        atol=GRAD_ATOL_OF_MAX * max(float(np.abs(want).max()), 1e-30),
        err_msg=err_msg)


def test_the_ranks_sit_row_major_on_the_mesh(run):
    assert [(r["data"], r["model"]) for r in run["ranks"]] == \
        [(d, m) for d in range(D) for m in range(M)]


@pytest.mark.parametrize("arch", ARCHS)
def test_losses_and_grad_norms_match_the_reference(run, arch):
    """Every rank's loss and gradient norm over STEPS steps against the
    reference's ``TrainLoop`` on a (2, 2) mesh of fake host devices."""
    want = run["want"][arch]["hist"]
    assert [h["step"] for h in want] == list(range(STEPS))
    for r in run["ranks"]:
        got = r[arch]["hist"]
        assert [h["step"] for h in got] == list(range(STEPS))
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose([h[key] for h in got],
                                       [h[key] for h in want], rtol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_summed_gradients_gathered_match_one_device(run, arch):
    """Each data rank's gradients of its blocks after the sum over the
    data axis, put together over the model axis, against the port's
    one-device gradients: every leaf, ``wk`` and ``wv`` (one kv head,
    whole on both model ranks) included; the summed loss too."""
    specs, one = _model_specs(arch), run["one"][arch]
    assert one["grads"].keys() == specs.keys()
    for d in range(D):
        group = run["ranks"][d * M:(d + 1) * M]
        for key, spec in specs.items():
            parts = [r[arch]["initial"]["summed"][key] for r in group]
            dim = next((i for i, e in enumerate(spec) if e == "model"), None)
            got = parts[0] if dim is None else np.concatenate(parts, dim)
            _close(got, one["grads"][key], err_msg=key)
        for r in group:
            np.testing.assert_allclose(r[arch]["initial"]["loss"],
                                       one["loss"], rtol=1e-6)
    kv = [k for k in specs if k.endswith(("['wk']", "['wv']"))]
    assert kv and all(not _cuts_model(specs[k]) for k in kv)
    assert all(np.abs(one["grads"][k]).max() > 0 for k in kv)


@pytest.mark.parametrize("arch", ARCHS)
def test_the_data_sum_equals_one_process_adding_the_ranks(run, arch):
    """The summed gradient of each block is, to the bit, one process's
    fp32 ``g0 * share0 + g1 * share1`` of the two data ranks that share
    the model index, in rank order (as
    ``tests/test_torch_train_data_parallel.py`` holds the data axis)."""
    ranks = run["ranks"]
    for m in range(M):
        first, second = (ranks[d * M + m][arch]["initial"] for d in range(D))
        s0, s1 = (torch.from_numpy(x["share"]) for x in (first, second))
        assert 0 < float(s0) < 1 and float(s0 + s1) == pytest.approx(1.0)
        for key, g0 in first["grads"].items():
            want = (torch.from_numpy(g0).float() * s0
                    + torch.from_numpy(second["grads"][key]).float() * s1)
            for x in (first, second):
                np.testing.assert_array_equal(x["summed"][key], want.numpy(),
                                              err_msg=key)


@pytest.mark.parametrize("arch", ARCHS)
def test_zero1_blocks_match_local_shard_of_the_reference_state(run, arch):
    """Each rank's masters, m and v after STEPS steps are ``local_shard``
    of the reference's whole state under the combined spec (the model
    axis on the cut dimension, the data axis on the first free one it
    divides), within the stated tolerances."""
    want = run["want"][arch]
    combined, _ = _zero1_specs(arch)
    for rank, r in enumerate(run["ranks"]):
        assert r[arch]["step"] == STEPS
        for kind in STATE:
            assert r[arch][kind].keys() == combined.keys()
            for key, block in r[arch][kind].items():
                ref = sharding.local_shard(
                    torch.from_numpy(want[f"{kind}|{key}"]), combined[key],
                    _mesh(), rank).numpy()
                assert block.shape == ref.shape, key
                atol = (STATE_ATOL if kind == "master" else
                        STATE_ATOL_OF_MAX * max(float(np.abs(ref).max()),
                                                1e-30))
                np.testing.assert_allclose(block, ref, rtol=STATE_RTOL,
                                           atol=atol, err_msg=f"{kind} {key}")


@pytest.mark.parametrize("arch", ARCHS)
def test_each_rank_holds_its_data_block_of_its_model_block(run, arch):
    """The parameters have ``sharding.local_shapes``' shapes; the state
    is cut over both axes wherever the data axis divides a free
    dimension (each rank a quarter of a leaf cut over the model axis, a
    half of a whole one), and its blocks add up to the whole state."""
    cfg = _cfg(arch)
    local = sharding.local_shapes(cfg, _mesh())
    combined, data = _zero1_specs(arch)
    whole = {keystr(p): tuple(t.shape) for p, t in tree_leaves_with_path(
        tr.init_params(cfg, torch.Generator(), "meta"))}
    assert any("data" in s and _cuts_model(s) for s in combined.values())
    assert all("model" not in s for s in data.values())
    for r in run["ranks"]:
        params = r[arch]["after_step"][-1]["params"]
        assert {k: v.shape for k, v in params.items()} == local
        for key, block in r[arch]["master"].items():
            assert block.shape == sharding.local_shape(
                whole[key], combined[key], _mesh()), key
    for kind in STATE:
        total = sum(r[arch][kind][k].size for r in run["ranks"]
                    for k in combined)
        # a leaf cut over both axes is held once, one cut over one axis
        # once by the ranks of each index of the other, one cut over
        # neither by every rank
        copies = {k: (1 if "data" in s else D) * (1 if _cuts_model(s) else M)
                  for k, s in combined.items()}
        assert total == sum(copies[k] * np.prod(whole[k]) for k in whole)


@pytest.mark.parametrize("arch", ARCHS)
def test_replicas_are_bit_equal_after_each_step(run, arch):
    """After each step the ranks that share a model index hold the same
    bits on every leaf, and every leaf held whole is the same on all four
    ranks; so are the loss and the gradient norm."""
    specs = _model_specs(arch)
    whole = [k for k, s in specs.items() if not _cuts_model(s)]
    assert whole
    ranks = run["ranks"]
    for step in range(STEPS):
        first = ranks[0][arch]["after_step"][step]
        for rank, r in enumerate(ranks):
            mine = r[arch]["after_step"][step]
            twin = ranks[rank % M][arch]["after_step"][step]
            assert (mine["loss"], mine["grad_norm"]) == \
                (first["loss"], first["grad_norm"]), step
            for key, leaf in twin["params"].items():
                np.testing.assert_array_equal(mine["params"][key], leaf,
                                              err_msg=f"{step} {key}")
            for key in whole:
                np.testing.assert_array_equal(mine["params"][key],
                                              first["params"][key],
                                              err_msg=f"{step} {key}")


@pytest.mark.parametrize("arch", ARCHS)
def test_gather_blocks_returns_the_model_block(run, arch):
    """``gather_blocks`` over the data axis of a rank's data blocks of its
    model blocks gives the model blocks back, not the whole leaves: one
    ring hop (D - 1) a leaf the data axis cuts."""
    _, data = _zero1_specs(arch)
    cut = sum("data" in s for s in data.values())
    assert cut
    for r in run["ranks"]:
        got = r[arch]["initial"]
        assert got["gather_equal"] and all(got["gather_equal"].values())
        assert got["gather_hops"]["hops"] == cut * (D - 1)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("arch", ARCHS)
def test_each_counter_takes_only_its_own_hops(run, arch):
    """``model_sum`` counts the sums over the model axis as
    ``chip_smoke.tp_train_sums`` works them out for a rank's rows, and
    no data hop; ``grad_sum`` one hop a step; ``param_gather`` the ring
    hops of the data blocks as ``chip_smoke.tp_train_gathers`` works them
    out from the data-only specs."""
    smoke, cfg = _chip_smoke(), _cfg(arch)
    sums = smoke.tp_train_sums(cfg, BATCH // D, SEQ[arch], M)
    gathers = smoke.tp_train_gathers(cfg, D, M)
    for r in run["ranks"]:
        hops = r[arch]["hops"]
        assert (hops["model_sum"]["hops"], hops["model_sum"]["bytes"]) == \
            (STEPS * len(sums) * (M - 1), STEPS * sum(sums) * (M - 1))
        assert hops["grad_sum"]["hops"] == STEPS
        assert (hops["param_gather"]["hops"],
                hops["param_gather"]["bytes"]) == \
            (STEPS * len(gathers) * (D - 1), STEPS * sum(gathers) * (D - 1))
