"""Port parity, training under dense tensor parallelism
(``train/train_loop.py`` over a (1, 4) mesh) against the reference's
``TrainLoop`` with a ctx on 4 fake host devices
(``make_ctx(make_host_mesh(1, 4))``).

One world of 4 ``gloo`` ranks (fresh processes, rendezvous by a file
under ``tmp_path``) trains reduced h2o-danube-1.8b (sliding window 32,
sequences of 64 that pass it) and reduced smollm-135m (tied embeddings)
in fp32 for STEPS steps, each rank on its ``param_specs`` blocks: one
query head of the four, the one kv head whole (each rank's gradient of
``wk`` and ``wv`` is its query head's share until it is summed over the
model axis), 32 of the 128 ``d_ff`` columns, 512 of the 2048 padded
vocabulary rows (ranks 1-3 hold padding only).  Each rank also takes the
gradients at the initial tree, the vocab-sharded ``lm_loss`` of a seeded
hidden state, and the ``psum`` / ``replicated`` pair on seeded tensors.
One JAX subprocess with 4 fake host devices runs the reference's
``TrainLoop`` from the same initial tree (initialised in JAX here,
converted, and handed to the ranks as numpy).

Tolerances: losses and gradient norms rtol 1e-4 against the reference
(as ``tests/test_torch_train.py`` holds one device); the ranks' gathered
gradients and the sharded loss rtol 1e-5 against the port's one-device
values (the sums over the model axis add in another order), with an
atol of 1e-6 of the leaf's largest value for elements near zero.  Held
to the bit: the leaves every rank holds whole, after each step, across
the ranks.  The top-level imports stay free of jax: the ranks import
this file.
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
WORLD = 4
WORLD_TIMEOUT_S = 240
ARCHS = ("h2o-danube-1.8b", "smollm-135m")
SEQ = {"h2o-danube-1.8b": 64, "smollm-135m": 32}
STEPS, BATCH = 3, 2
HP = dict(peak_lr=3e-3, warmup_steps=3, total_steps=20)
GRAD_RTOL, GRAD_ATOL_OF_MAX = 1e-5, 1e-6
#: the psum pair's tensors: (rows, columns)
PAIR_SHAPE = (3, 5)

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
ctx = shd.make_ctx(make_host_mesh(1, 4))
assert dict(ctx.mesh.shape) == {"data": 1, "model": 4}
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
    loop = TrainLoop(cfg, DataConfig(cfg.vocab_size, seq, case["batch"]),
                     TrainConfig(optimizer=AdamWConfig(**case["hp"]),
                                 log_every=1), ctx=ctx)
    _, _, hist = loop.run(case["steps"])
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


def _flat(tree):
    return {keystr(p): t.detach().numpy().copy()
            for p, t in tree_leaves_with_path(tree)}


def _torch_tree(tree, device="cpu"):
    """The reference's numpy tree as tensors in torch's own memory."""
    return tree_map(torch.clone, from_jax_params(tree, device))


def _specs(arch, mesh):
    cfg = _cfg(arch)
    specs = sharding.param_specs(tr.init_params(cfg, torch.Generator(),
                                                "meta"), cfg, mesh)
    return {keystr(p): s for p, s in tree_leaves_with_path(
        specs, lambda x: isinstance(x, sharding.P))}


def _batch(arch, step=0):
    return {k: torch.from_numpy(v) for k, v in
            batch_for_config(_cfg(arch), _dc(arch), step).items()}


def _loss_inputs(arch):
    """A seeded hidden state, targets and mask for ``lm_loss``."""
    cfg, rng = _cfg(arch), np.random.default_rng(11)
    S = SEQ[arch]
    hidden = rng.standard_normal((BATCH, S, cfg.d_model)).astype(np.float32)
    targets = rng.integers(0, cfg.vocab_size, (BATCH, S)).astype(np.int32)
    mask = (rng.random((BATCH, S)) < 0.9).astype(np.float32)
    return torch.from_numpy(hidden), torch.from_numpy(targets), \
        torch.from_numpy(mask)


def _head_key(cfg):
    return "embed" if cfg.tie_embeddings else "lm_head"


def _sharded_loss(params, cfg, ctx, hidden, targets, mask):
    """``lm_loss`` and its gradients of the hidden state and of the head
    (this rank's block of it where ``ctx`` has the model axis)."""
    key = _head_key(cfg)
    head = params[key].detach().clone().requires_grad_()
    h = hidden.clone().requires_grad_()
    with torch.enable_grad():
        loss = tr.lm_loss(dict(params, **{key: head}), h, targets, mask, cfg,
                          ctx=ctx)
        gh, gw = torch.autograd.grad(loss, [h, head])
    return float(loss.detach()), gh.numpy(), gw.numpy()


def _pair_inputs(rank):
    """The psum pair's seeded tensors: ``x`` (each rank its own), ``a``
    (the same on every rank) and the cotangents ``c`` (each rank its
    own) and ``d`` (the same on every rank)."""
    def draw(seed):
        return np.random.default_rng(seed).standard_normal(
            PAIR_SHAPE).astype(np.float32)
    return {"x": draw(100 + rank), "a": draw(7), "c": draw(200 + rank),
            "d": draw(8)}


def _pair(rank, ctx):
    """``psum`` forward and backward on each rank's ``x`` under the same
    cotangent ``d``; ``replicated`` forward and backward on the shared
    ``a`` under each rank's cotangent ``c``; the hops each counted."""
    inp = {k: torch.from_numpy(v) for k, v in _pair_inputs(rank).items()}
    stats = {"psum": collectives.HopStats(),
             "replicated": collectives.HopStats()}
    x = inp["x"].clone().requires_grad_()
    a = inp["a"].clone().requires_grad_()
    with torch.enable_grad():
        y = collectives.psum(x, "model", mesh=ctx.mesh, stats=stats["psum"])
        (gx,) = torch.autograd.grad((y * inp["d"]).sum(), [x])
        b = collectives.replicated(a, "model", mesh=ctx.mesh,
                                   stats=stats["replicated"])
        forward_hops = stats["replicated"].hops
        (ga,) = torch.autograd.grad((b * inp["c"]).sum(), [a])
    return {"y": y.detach().numpy(), "gx": gx.numpy(), "b": b.detach().numpy(),
            "ga": ga.numpy(), "replicated_forward_hops": forward_hops,
            "stats": {k: dataclasses.asdict(v) for k, v in stats.items()}}


def _rank(rank, world_size, trees):
    ctx = sharding.make_ctx(make_host_mesh(1, world_size))
    out = {"pair": _pair(rank, ctx)}
    for arch in ARCHS:
        cfg = _cfg(arch)
        tr.init_params = lambda c, gen, dev: _torch_tree(trees[arch], dev)
        specs = _specs(arch, ctx.mesh)
        whole_keys = [k for k, s in specs.items() if "model" not in s]
        after_step = []

        def on_step(step, params, opt_state, metrics):
            flat = _flat(params)
            after_step.append({"whole": {k: flat[k] for k in whole_keys},
                               "loss": float(metrics["loss"]),
                               "grad_norm": float(metrics["grad_norm"])})
        loop = train_loop.TrainLoop(cfg, _dc(arch), _tc(), ctx=ctx,
                                    device="cpu")
        params, opt_state, hist = loop.run(STEPS, on_step=on_step)
        own = checkpoint.reshard(_torch_tree(trees[arch]), sharding.named(
            ctx.mesh, train_loop.model_specs(cfg, ctx)), "cpu")
        (loss, _), grads = train_loop.value_and_grad(cfg, own, _batch(arch),
                                                     ctx)
        out[arch] = {"hist": hist, "after_step": after_step,
                     "loss0": float(loss), "grads": _flat(grads),
                     "shapes": {k: v.shape for k, v in _flat(params).items()},
                     "state_shapes": {k: v.shape for k, v in
                                      _flat(opt_state["master"]).items()},
                     "hops": dataclasses.asdict(loop.hop_stats["model_sum"]),
                     "lm_loss": _sharded_loss(own, cfg, ctx,
                                              *_loss_inputs(arch))}
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    import jax
    from repro.configs import reduced_config as ref_reduced_config
    from repro.models import transformer as ref_tr
    tmp = tmp_path_factory.mktemp("train_tp")
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
            cfg, params = _cfg(arch), _torch_tree(trees[arch])
            (loss, _), grads = train_loop.value_and_grad(cfg, params,
                                                         _batch(arch))
            one[arch] = {"loss0": float(loss), "grads": _flat(grads),
                         "lm_loss": _sharded_loss(params, cfg, tr.LOCAL_CTX,
                                                  *_loss_inputs(arch))}
        log, _ = ref.communicate(timeout=WORLD_TIMEOUT_S)
    finally:
        if ref.poll() is None:
            ref.kill()
    assert ref.returncode == 0, log
    want = {}
    for arch in ARCHS:
        with open(tmp / f"ref|{arch}.json") as f:
            want[arch] = json.load(f)
    return {"ranks": ranks, "want": want, "one": one}


def _gathered(ranks, arch, key, spec, blocks):
    """The whole leaf ``key`` from the ranks' ``blocks`` (rank i is model
    rank i on (1, 4)): put together along the dimension ``spec`` cuts,
    or rank 0's where it is whole."""
    parts = [r[arch][blocks][key] for r in ranks]
    for dim, entry in enumerate(spec):
        if entry == "model":
            return np.concatenate(parts, axis=dim)
    return parts[0]


def _close(got, want, err_msg=""):
    np.testing.assert_allclose(
        got, want, rtol=GRAD_RTOL,
        atol=GRAD_ATOL_OF_MAX * max(float(np.abs(want).max()), 1e-30),
        err_msg=err_msg)


@pytest.mark.parametrize("arch", ARCHS)
def test_losses_and_grad_norms_match_the_reference(run, arch):
    """Every rank's loss and gradient norm over STEPS steps against the
    reference's ``TrainLoop`` on a (1, 4) mesh of fake host devices."""
    want = run["want"][arch]
    for r in run["ranks"]:
        got = r[arch]["hist"]
        assert [h["step"] for h in got] == list(range(STEPS))
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose([h[key] for h in got],
                                       [h[key] for h in want], rtol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_gathered_gradients_match_one_device(run, arch):
    """The ranks' gradients at the initial tree, put together, against
    the port's one-device gradients: every leaf, ``wk`` and ``wv`` (whole
    on every rank, each rank's own share summed over the model axis)
    included, and every whole leaf the same on every rank to the bit."""
    specs = _specs(arch, Mesh((1, WORLD), ("data", "model")))
    one = run["one"][arch]
    assert one["grads"].keys() == specs.keys()
    for key, spec in specs.items():
        _close(_gathered(run["ranks"], arch, key, spec, "grads"),
               one["grads"][key], err_msg=key)
        if "model" not in spec:
            for r in run["ranks"]:
                np.testing.assert_array_equal(r[arch]["grads"][key],
                                              run["ranks"][0][arch]["grads"]
                                              [key], err_msg=key)
    for r in run["ranks"]:
        np.testing.assert_allclose(r[arch]["loss0"], one["loss0"], rtol=1e-6)
    # the leaves the ranks' query heads share, as the trap's witnesses
    kv = [k for k in specs if k.endswith(("['wk']", "['wv']"))]
    assert kv and all("model" not in specs[k] for k in kv)
    assert all(np.abs(one["grads"][k]).max() > 0 for k in kv)


@pytest.mark.parametrize("arch", ARCHS)
def test_whole_leaves_are_bit_equal_across_ranks_after_each_step(run, arch):
    first, *rest = run["ranks"]
    assert len(first[arch]["after_step"]) == STEPS
    assert first[arch]["after_step"][0]["whole"]
    for r in rest:
        for step, (a, b) in enumerate(zip(r[arch]["after_step"],
                                          first[arch]["after_step"])):
            assert a["loss"] == b["loss"] and \
                a["grad_norm"] == b["grad_norm"], step
            assert a["whole"].keys() == b["whole"].keys()
            for key in a["whole"]:
                np.testing.assert_array_equal(a["whole"][key],
                                              b["whole"][key],
                                              err_msg=f"step {step} {key}")


@pytest.mark.parametrize("arch", ARCHS)
def test_each_rank_holds_its_blocks_and_their_state(run, arch):
    """A rank's parameters and masters have ``sharding.local_shapes``'
    shapes: a quarter of every cut leaf."""
    cfg = _cfg(arch)
    want = sharding.local_shapes(cfg, Mesh((1, WORLD), ("data", "model")))
    for r in run["ranks"]:
        assert r[arch]["shapes"] == r[arch]["state_shapes"] == want
    assert want["['embed']"] == (cfg.padded_vocab() // WORLD, cfg.d_model)


@pytest.mark.parametrize("arch", ARCHS)
def test_the_vocab_sharded_loss_matches_one_device(run, arch):
    """``lm_loss`` over the ranks' vocabulary columns, on a seeded hidden
    state: the same loss on every rank, finite on ranks 1-3 whose columns
    are all padding, and held to the one-device loss; the hidden state's
    gradient whole on every rank, the head's gathered."""
    cfg = _cfg(arch)
    assert cfg.vocab_size <= cfg.padded_vocab() // WORLD
    loss, gh, gw = run["one"][arch]["lm_loss"]
    dim = 0 if cfg.tie_embeddings else 1
    heads = []
    for r in run["ranks"]:
        got, got_h, got_w = r[arch]["lm_loss"]
        assert np.isfinite(got) and np.isfinite(got_h).all()
        assert got == run["ranks"][0][arch]["lm_loss"][0]
        np.testing.assert_allclose(got, loss, rtol=GRAD_RTOL)
        _close(got_h, gh)
        heads.append(got_w)
    _close(np.concatenate(heads, axis=dim), gw)
    # ranks 1-3 hold padding only: their head blocks get no gradient
    assert all(not np.any(h) for h in heads[1:])


def test_psum_and_replicated_forward_and_backward(run):
    """``psum``: every rank's output is the sum of the ranks' ``x``, the
    same bits on every rank, and each rank's gradient is the output's
    (the identity, no hop).  ``replicated``: the identity forward with no
    hop, and the gradient of the shared ``a`` is the sum of the ranks'
    cotangents on every rank.  Each counts (M - 1) hops of its tensor."""
    inputs = [_pair_inputs(r) for r in range(WORLD)]
    sum_x = sum(i["x"].astype(np.float64) for i in inputs)
    sum_c = sum(i["c"].astype(np.float64) for i in inputs)
    nbytes = 4 * int(np.prod(PAIR_SHAPE))
    for rank, r in enumerate(run["ranks"]):
        p = r["pair"]
        np.testing.assert_allclose(p["y"], sum_x, rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(p["y"], run["ranks"][0]["pair"]["y"])
        np.testing.assert_array_equal(p["gx"], inputs[rank]["d"])
        np.testing.assert_array_equal(p["b"], inputs[rank]["a"])
        np.testing.assert_allclose(p["ga"], sum_c, rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(p["ga"], run["ranks"][0]["pair"]["ga"])
        assert p["replicated_forward_hops"] == 0
        for key in ("psum", "replicated"):
            assert (p["stats"][key]["hops"], p["stats"][key]["bytes"]) == \
                (WORLD - 1, (WORLD - 1) * nbytes), key


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("arch", ARCHS)
def test_the_sums_over_the_model_axis_are_counted(run, arch):
    """``TrainLoop.hop_stats["model_sum"]`` counts the step's hops over
    the model axis (the forward's, the recomputed groups', the
    backward's and the norm's) on every rank as
    ``chip_smoke.tp_train_sums`` works them out from the code, which the
    card's ``tp_train`` holds at full width: a sum gained or lost, or a
    recompute that stops elsewhere, shows here first."""
    sums = _chip_smoke().tp_train_sums(_cfg(arch), BATCH, SEQ[arch], WORLD)
    want = (STEPS * len(sums) * (WORLD - 1), STEPS * sum(sums) * (WORLD - 1))
    for r in run["ranks"]:
        assert (r[arch]["hops"]["hops"], r[arch]["hops"]["bytes"]) == want


def test_a_cut_product_s_fp32_partial_has_a_backward():
    """``common.matmul_f32`` under autograd in bf16 (a rank's partial of a
    cut product, whose ``torch.mm`` ``out_dtype`` form on the card has no
    derivative): the fp32 products forward, and the gradients in the
    operands' dtype, the bf16 products of the bf16 cotangent (which a
    sum rounded to bf16 hands back) with each operand."""
    from repro_torch.models import common
    rng = np.random.default_rng(3)

    def draw(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(torch.bfloat16)
    a, w, g = draw(2, 5, 16), draw(16, 8), draw(2, 5, 8)
    a.requires_grad_()
    w.requires_grad_()
    with torch.enable_grad():
        y = common.matmul_f32(a, w)
        assert y.dtype == torch.float32
        ga, gw = torch.autograd.grad(y, [a, w], g.float())
    torch.testing.assert_close(y.detach(), a.detach().float()
                               @ w.detach().float(), rtol=0, atol=0)
    assert ga.dtype == gw.dtype == torch.bfloat16
    assert torch.equal(ga, (g.reshape(-1, 8) @ w.detach().T).reshape(a.shape))
    assert torch.equal(gw, a.detach().reshape(-1, 16).T @ g.reshape(-1, 8))
