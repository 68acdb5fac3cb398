"""Port parity, data-parallel training with ZeRO-1 (``train/train_loop.py``
under a data mesh) against the reference's ``TrainLoop`` with a ctx on 2
fake host devices (``make_ctx(make_host_mesh(2, 1))``, where GSPMD splits
the batch and sums the gradients).

One world of 2 ``gloo`` ranks (fresh processes, rendezvous by a file
under ``tmp_path``) trains reduced smollm-135m and mamba2-780m in fp32 for
STEPS steps, each rank on its rows of the global batch, each holding its
ZeRO-1 blocks of the masters, m and v; smollm-135m writes a checkpoint at
its last step.  The ranks then resume STEPS more steps from that
checkpoint and from one written on one device, and train STEPS steps
with ``compress_grads="int8"``.  One JAX subprocess with
2 fake host devices runs the reference's ``TrainLoop`` from the same
initial tree (initialised in JAX here, converted, and handed to the ranks
as numpy), 2 x STEPS steps of smollm-135m and STEPS of mamba2-780m.

Tolerances: losses and gradient norms rtol 1e-4 (as
``tests/test_torch_train.py`` holds one device); parameters and masters
atol 1e-4 (ibid.: AdamW's first steps move a weight by about the learning
rate whatever its gradient's size, so a gradient near zero that differs
in the last bits moves it differently); m and v rtol 1e-3 with an atol of
1e-5 of the leaf's largest value (the gradients' summation order).  Held
to the bit: each rank's blocks against one process computing as the
ranks do (each rank's rows' gradients scaled by its share of the mask,
summed in fp32 in rank order, then ``apply_updates`` on the whole tree
and ``local_shard``), the ranks' parameters against each other, and a
checkpoint's whole leaves against the ranks' blocks.  The top-level
imports stay free of jax: the ranks import this file.
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
from repro_torch.convert import (from_jax_params, keystr, tree_leaves,
                                tree_leaves_with_path, tree_map,
                                tree_unflatten)
from repro_torch.data.pipeline import DataConfig, batch_for_config
from repro_torch.distributed import compression, sharding
from repro_torch.distributed.world import run_world
from repro_torch.launch.mesh import Mesh, make_host_mesh
from repro_torch.models import transformer as tr
from repro_torch.train import checkpoint, optimizer, train_loop

pytestmark = pytest.mark.multidevice
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
WORLD_TIMEOUT_S = 240
ARCHS = ("smollm-135m", "mamba2-780m")
CKPT_ARCH = "smollm-135m"
STEPS = 3
BATCH, SEQ = 4, 32
HP = dict(peak_lr=3e-3, warmup_steps=3, total_steps=20)
STATE = ("master", "m", "v")
#: leaves of no, first and second dimension cut by ZeRO-1 over 2 ranks
GATHER_SHAPES = {"odd": (3, 5), "rows": (4, 3), "cols": (3, 4)}

REFERENCE = """
import dataclasses, json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
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
assert len(jax.devices()) == 2
ctx = shd.make_ctx(make_host_mesh(2, 1))
keystr = jax.tree_util.keystr
init_params = tr.init_params
for arch, steps in case["runs"]:
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
        for name, t in (("params", params), ("master", opt_state["master"]),
                        ("m", opt_state["m"]), ("v", opt_state["v"])):
            for p, leaf in jax.tree_util.tree_flatten_with_path(t)[0]:
                saved[name + "|" + keystr(p)] = np.asarray(leaf)

    loop = TrainLoop(cfg, DataConfig(cfg.vocab_size, case["seq"],
                                     case["batch"]),
                     TrainConfig(optimizer=AdamWConfig(**case["hp"]),
                                 log_every=1), ctx=ctx)
    _, _, hist = loop.run(steps, on_step=on_step)
    np.savez(os.path.join(out, f"ref|{arch}.npz"), **saved)
    with open(os.path.join(out, f"ref|{arch}.json"), "w") as f:
        json.dump([{k: float(h[k]) for k in ("step", "loss", "grad_norm")}
                   for h in hist], f)
"""


def _cfg(arch):
    return dataclasses.replace(reduced_config(arch), param_dtype="float32")


def _dc(cfg):
    return DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ,
                      global_batch=BATCH)


def _tc(ckpt_dir=None, every=None, compress=None):
    return train_loop.TrainConfig(
        optimizer=optimizer.AdamWConfig(**HP), checkpoint_dir=ckpt_dir,
        checkpoint_every=every or 10 ** 9, log_every=1,
        compress_grads=compress)


def _flat(tree):
    return {keystr(p): t.detach().numpy().copy()
            for p, t in tree_leaves_with_path(tree)}


def _torch_tree(tree, device="cpu"):
    """The reference's numpy tree as tensors in torch's own memory: the
    bits of a CPU matmul depend on its operands' alignment, which
    numpy's allocations do not fix alike in two processes."""
    return tree_map(torch.clone, from_jax_params(tree, device))


def _hand_over(tree):
    """Make ``init_params`` return the reference's tree (in this
    process)."""
    tr.init_params = lambda c, gen, dev: _torch_tree(tree, dev)


def _gather_check(ctx):
    """Each leaf of GATHER_SHAPES cut by ZeRO-1's spec and gathered
    back: (specs, whether each came back whole and equal)."""
    whole = {k: torch.arange(float(np.prod(s))).reshape(s)
             for k, s in GATHER_SHAPES.items()}
    specs = {k: sharding.zero1_spec(s, sharding.P(), ctx.mesh,
                                    ctx.data_axes)
             for k, s in GATHER_SHAPES.items()}
    blocks = train_loop.local_blocks(whole, specs, ctx)
    back = train_loop.gather_blocks(blocks, specs, ctx)
    return ({k: tuple(s) for k, s in specs.items()},
            {k: bool(torch.equal(back[k], whole[k])) for k in whole})


def _rank(rank, world_size, trees, dirs):
    ctx = sharding.make_ctx(make_host_mesh(world_size, 1))
    out = {"gather": _gather_check(ctx)}
    for arch in ARCHS:
        cfg = _cfg(arch)
        _hand_over(trees[arch])
        every = STEPS if arch == CKPT_ARCH else None
        loop = train_loop.TrainLoop(
            cfg, _dc(cfg), _tc(dirs["two"] if every else None, every),
            ctx=ctx, device="cpu")
        params, opt_state, hist = loop.run(STEPS)
        out[arch] = {"hist": hist, "params": _flat(params),
                     "step": int(opt_state["step"]),
                     **{k: _flat(opt_state[k]) for k in STATE}}
    cfg = _cfg(CKPT_ARCH)
    _hand_over(trees[CKPT_ARCH])
    for name in ("two", "one"):
        _, _, hist = train_loop.TrainLoop(
            cfg, _dc(cfg), _tc(dirs[name]), ctx=ctx, device="cpu").run(STEPS)
        out[f"resumed_from_{name}"] = hist
    params, _, hist = train_loop.TrainLoop(
        cfg, _dc(cfg), _tc(compress="int8"), ctx=ctx, device="cpu").run(STEPS)
    out["int8"] = {"hist": hist, "params": _flat(params)}
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    import jax
    from repro.configs import reduced_config as ref_reduced_config
    from repro.models import transformer as ref_tr
    tmp = tmp_path_factory.mktemp("train_dp")
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
        json.dump({"runs": [[a, 2 * STEPS if a == CKPT_ARCH else STEPS]
                            for a in ARCHS], "steps": STEPS, "seq": SEQ,
                   "batch": BATCH, "hp": HP}, f)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    ref = subprocess.Popen([sys.executable, "-c", REFERENCE, str(tmp)],
                           cwd=ROOT, env=env, stdout=subprocess.PIPE,
                           stderr=subprocess.STDOUT, text=True)
    try:
        dirs = {name: str(tmp / name) for name in ("one", "two")}
        cfg = _cfg(CKPT_ARCH)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tr, "init_params", lambda c, gen, dev: _torch_tree(
                trees[CKPT_ARCH], dev))
            one_hist = train_loop.TrainLoop(
                cfg, _dc(cfg), _tc(dirs["one"], STEPS),
                device="cpu").run(STEPS)[2]
            (tmp / "world").mkdir()
            ranks = run_world(_rank, WORLD, (trees, dirs),
                              workdir=tmp / "world", timeout=WORLD_TIMEOUT_S)
            resumed_one_device = train_loop.TrainLoop(
                cfg, _dc(cfg), _tc(dirs["two"]), device="cpu").run(STEPS)[2]
        log, _ = ref.communicate(timeout=WORLD_TIMEOUT_S)
    finally:
        if ref.poll() is None:
            ref.kill()
    assert ref.returncode == 0, log
    want = {}
    for arch in ARCHS:
        with open(tmp / f"ref|{arch}.json") as f:
            hist = json.load(f)
        want[arch] = {"hist": hist, **{
            k: v for k, v in np.load(tmp / f"ref|{arch}.npz").items()}}
    return {"ranks": ranks, "want": want, "trees": trees, "dirs": dirs,
            "one_device": one_hist, "resumed_one_device": resumed_one_device}


def _curve(hist, key):
    return [h[key] for h in hist]


@pytest.mark.parametrize("arch", ARCHS)
def test_losses_and_grad_norms_match_the_reference(run, arch):
    want = run["want"][arch]["hist"][:STEPS]
    for r in run["ranks"]:
        got = r[arch]["hist"]
        assert _curve(got, "step") == list(range(STEPS))
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(_curve(got, key), _curve(want, key),
                                       rtol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_parameters_match_the_reference(run, arch):
    want = run["want"][arch]
    for r in run["ranks"]:
        got = r[arch]["params"]
        assert got.keys() == {k.split("|", 1)[1] for k in want
                              if k.startswith("params|")}
        for key, leaf in got.items():
            np.testing.assert_allclose(leaf, want["params|" + key], atol=1e-4,
                                       err_msg=key)


def _ref_state_block(want, kind, key, spec, rank):
    return sharding.local_shard(torch.from_numpy(want[f"{kind}|{key}"]), spec,
                                Mesh((WORLD, 1), ("data", "model")),
                                rank).numpy()


def _specs(arch):
    cfg = _cfg(arch)
    params = tr.init_params(cfg, torch.Generator(), "meta")
    ctx = sharding.make_ctx(Mesh((WORLD, 1), ("data", "model")))
    specs = train_loop.zero1_specs(params, cfg, ctx)["master"]
    return {keystr(p): s for p, s in tree_leaves_with_path(
        specs, lambda x: isinstance(x, sharding.P))}


@pytest.mark.parametrize("arch", ARCHS)
def test_zero1_blocks_match_local_shard_of_the_reference_state(run, arch):
    """Each rank holds half of every leaf of the state (every leaf of
    these trees has a dimension that 2 divides), within the stated
    tolerances of its block of the reference's whole state."""
    want, specs = run["want"][arch], _specs(arch)
    for rank, r in enumerate(run["ranks"]):
        assert r[arch]["step"] == STEPS
        for kind in STATE:
            for key, block in r[arch][kind].items():
                ref = _ref_state_block(want, kind, key, specs[key], rank)
                assert block.shape == ref.shape, key
                assert 2 * block.size == want[f"{kind}|{key}"].size, key
                if kind == "master":
                    tol = dict(atol=1e-4)
                else:
                    tol = dict(rtol=1e-3, atol=1e-5 * np.abs(ref).max())
                np.testing.assert_allclose(block, ref, err_msg=key, **tol)


def _as_ranks(arch, tree, compress=False):
    """One process computing as the ranks do: each rank's rows'
    gradients scaled by its share of the mask sum, summed in fp32 in rank
    order, (with ``compress``, round-tripped through int8,) then
    ``apply_updates`` on the whole tree."""
    cfg = _cfg(arch)
    params = _torch_tree(tree)
    state = optimizer.init_opt_state(params)
    opt_cfg = optimizer.AdamWConfig(**HP)
    rows = BATCH // WORLD
    for step in range(STEPS):
        batch = {k: torch.from_numpy(v) for k, v in
                 batch_for_config(cfg, _dc(cfg), step).items()}
        total = None
        for r in range(WORLD):
            mine = {k: v[r * rows:(r + 1) * rows] for k, v in batch.items()}
            share = mine["mask"].float().sum() / batch["mask"].float().sum()
            _, grads = train_loop.value_and_grad(cfg, params, mine)
            part = [g.float() * share for g in tree_leaves(grads)]
            total = part if total is None else [
                a + b for a, b in zip(total, part)]
        grads = tree_unflatten(params, total)
        if compress:
            grads, _ = compression.compress_tree_int8(grads)
        params, state, _ = optimizer.apply_updates(opt_cfg, params, grads,
                                                   state)
    return params, state


@pytest.mark.parametrize("arch", ARCHS)
def test_zero1_blocks_equal_one_process_computing_as_the_ranks_do(run, arch):
    params, state = _as_ranks(arch, run["trees"][arch])
    specs = _specs(arch)
    mesh = Mesh((WORLD, 1), ("data", "model"))
    for rank, r in enumerate(run["ranks"]):
        for key, leaf in _flat(params).items():
            np.testing.assert_array_equal(r[arch]["params"][key], leaf,
                                          err_msg=key)
        for kind in STATE:
            for key, leaf in _flat(state[kind]).items():
                want = sharding.local_shard(torch.from_numpy(leaf),
                                            specs[key], mesh, rank)
                np.testing.assert_array_equal(r[arch][kind][key],
                                              want.numpy(), err_msg=key)


@pytest.mark.parametrize("arch", ARCHS)
def test_every_rank_holds_the_same_parameters_and_history(run, arch):
    first, *rest = run["ranks"]
    for r in rest:
        assert r[arch]["params"].keys() == first[arch]["params"].keys()
        for key, leaf in first[arch]["params"].items():
            np.testing.assert_array_equal(r[arch]["params"][key], leaf)
        for key in ("loss", "grad_norm", "lr"):
            assert _curve(r[arch]["hist"], key) == \
                _curve(first[arch]["hist"], key)


def test_int8_compression_acts_on_the_summed_gradients(run):
    """``compress_grads="int8"`` over the mesh: each leaf of the summed
    gradient round-tripped through int8, then the global norm, the clip
    and AdamW (the reference's order): the ranks' parameters equal one
    process computing so, to the bit."""
    params, _ = _as_ranks(CKPT_ARCH, run["trees"][CKPT_ARCH], compress=True)
    plain = run["ranks"][0][CKPT_ARCH]["params"]
    for r in run["ranks"]:
        got = r["int8"]["params"]
        for key, leaf in _flat(params).items():
            np.testing.assert_array_equal(got[key], leaf, err_msg=key)
        assert any(not np.array_equal(got[k], plain[k]) for k in plain)
        assert all(h["compression_err"] > 0 for h in r["int8"]["hist"])


def test_two_ranks_match_one_device(run):
    """The same run on one device (it wrote the checkpoint the ranks
    resume from below)."""
    got = run["ranks"][0][CKPT_ARCH]["hist"]
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(_curve(got, key),
                                   _curve(run["one_device"], key), rtol=1e-4)


def test_a_checkpoint_of_two_ranks_holds_the_gathered_state(run):
    """Rank 0 wrote the whole tree in the one-device format: its
    parameters are the ranks', and its masters, m and v the ranks' blocks
    put together (``local_shard`` of each whole leaf is the rank's
    block, to the bit)."""
    cfg = _cfg(CKPT_ARCH)
    params = tr.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    template = {"params": params, "opt": optimizer.init_opt_state(params)}
    step, tree, meta = checkpoint.restore(run["dirs"]["two"], template,
                                          step=STEPS)
    assert step == STEPS and meta == {"model": cfg.name}
    assert int(tree["opt"]["step"]) == STEPS
    specs = _specs(CKPT_ARCH)
    mesh = Mesh((WORLD, 1), ("data", "model"))
    for rank, r in enumerate(run["ranks"]):
        for key, leaf in _flat(tree["params"]).items():
            np.testing.assert_array_equal(r[CKPT_ARCH]["params"][key], leaf)
        for kind in STATE:
            for key, leaf in _flat(tree["opt"][kind]).items():
                block = sharding.local_shard(torch.from_numpy(leaf),
                                             specs[key], mesh, rank)
                np.testing.assert_array_equal(r[CKPT_ARCH][kind][key],
                                              block.numpy(), err_msg=key)


@pytest.mark.parametrize("written_on, resumed_on", [
    ("two", "two ranks"), ("two", "one device"), ("one", "two ranks")])
def test_a_checkpoint_resumes_across_one_device_and_two_ranks(
        run, written_on, resumed_on):
    """From step STEPS, on 2 ranks or one device, from a checkpoint
    written on 2 ranks or one device: steps STEPS .. 2 STEPS - 1 continue
    the reference's uninterrupted run."""
    got = (run["resumed_one_device"] if resumed_on == "one device" else
           run["ranks"][0][f"resumed_from_{written_on}"])
    want = run["want"][CKPT_ARCH]["hist"][STEPS:]
    assert _curve(got, "step") == list(range(STEPS, 2 * STEPS))
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(_curve(got, key), _curve(want, key),
                                   rtol=1e-4)


def test_gather_puts_the_blocks_back_in_local_shard_s_layout(run):
    for r in run["ranks"]:
        specs, whole = r["gather"]
        assert specs == {"odd": (None, None), "rows": ("data", None),
                         "cols": (None, "data")}
        assert all(whole.values()), whole


def test_a_model_axis_above_one_raises():
    """A data axis and a model axis both at 2 build a step without a
    collective, ``data_parallel`` and ``model_parallel`` both true (the
    name is from when that mesh raised; what still raises over a model
    axis above 1, with a data axis of 2 too, is a checkpoint directory
    or ``compress_grads="int8"``, ROADMAP A10.2c-train-ckpt).  A model
    axis alone builds a step (dense tensor parallelism,
    ``tests/test_torch_train_tensor_parallel.py``), as a data axis
    alone does."""
    cfg = _cfg(CKPT_ARCH)
    ctx = sharding.make_ctx(Mesh((2, 2), ("data", "model")))
    assert callable(train_loop.make_train_step(cfg, _tc(), ctx))
    assert train_loop.data_parallel(ctx)
    assert train_loop.model_parallel(ctx)
    for tc in (_tc(compress="int8"), _tc(ckpt_dir="unused")):
        with pytest.raises(NotImplementedError, match="A10.2c-train-ckpt"):
            train_loop.make_train_step(cfg, tc, ctx)
        with pytest.raises(NotImplementedError, match="A10.2c-train-ckpt"):
            train_loop.TrainLoop(cfg, _dc(cfg), tc, ctx=ctx,
                                 device="cpu").init_or_resume()
    ctx = sharding.make_ctx(Mesh((1, 2), ("data", "model")))
    assert callable(train_loop.make_train_step(cfg, _tc(), ctx))
    assert not train_loop.data_parallel(ctx)
    assert train_loop.model_parallel(ctx)
    assert not train_loop.data_parallel(
        sharding.make_ctx(Mesh((1, 1), ("data", "model"))))
    ctx = sharding.make_ctx(Mesh((2, 1), ("data", "model")))
    assert train_loop.data_parallel(ctx)
    assert not train_loop.model_parallel(ctx)
