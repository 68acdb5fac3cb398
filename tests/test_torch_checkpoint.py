"""Port parity, checkpoints (``repro_torch/train/checkpoint.py``): the
reference's on-disk layout, so that a checkpoint the port writes restores
in the reference and the other way round, bf16 leaves (stored as their
uint16 view) and the optimizer's int32 step included, to the bit; the
manifest's keys as ``jax.tree_util.keystr`` writes them; ``LATEST``,
``latest_step``, ``prune_old``, and the copied
``fault_tolerance.recovery_procedure``, which restores through the
port's checkpoint.  One JAX init of reduced smollm-135m (bf16)."""
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as ref_reduced_config
from repro.models import transformer as ref_tr
from repro.train import checkpoint as ref_ckpt
from repro.train import optimizer as ref_opt
from repro_torch.convert import from_jax_params, tree_leaves, tree_map
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer
from repro_torch.train.fault_tolerance import (HeartbeatMonitor,
                                               recovery_procedure)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def trees():
    """The reference's {"params", "opt"} tree (bf16 params, fp32 state,
    int32 step) after one update, and the port's conversion of it."""
    cfg = ref_reduced_config("smollm-135m")
    params = jax.jit(lambda key: ref_tr.init_params(cfg, key))(
        jax.random.PRNGKey(2))
    state = ref_opt.init_opt_state(params)
    grads = jax.tree_util.tree_map(lambda a: a * 0.01 + 0.001, params)
    params, state, _ = ref_opt.apply_updates(ref_opt.AdamWConfig(), params,
                                             grads, state)
    ref_tree = {"params": params, "opt": state}
    port = from_jax_params(jax.tree_util.tree_map(np.asarray, ref_tree),
                           "cpu")
    return ref_tree, port


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _same(port_tree, ref_tree):
    got, want = tree_leaves(port_tree), jax.tree_util.tree_leaves(ref_tree)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.dtype == getattr(torch, w.dtype.name)
        assert tuple(g.shape) == w.shape
        g = g.view(torch.int16).numpy().view(np.uint16) if (
            g.dtype == torch.bfloat16) else g.numpy()
        np.testing.assert_array_equal(g, _bits(w))


def test_port_saves_the_reference_restores(trees, tmp_path):
    ref_tree, port = trees
    assert port["params"]["embed"].dtype == torch.bfloat16
    assert port["opt"]["step"].dtype == torch.int32
    ckpt.save(str(tmp_path), 7, port, metadata={"model": "smollm-135m"})
    step, back, meta = ref_ckpt.restore(str(tmp_path), ref_tree)
    assert step == 7 and meta == {"model": "smollm-135m"}
    for g, w in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(ref_tree)):
        assert np.asarray(g).dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(_bits(g), _bits(w))
    # the same manifest keys, shapes and dtypes as the reference writes
    ref_ckpt.save(str(tmp_path / "ref"), 7, ref_tree,
                  metadata={"model": "smollm-135m"})
    manifests = [json.loads((d / "step_00000007" / "manifest.json")
                            .read_text()) for d in (tmp_path,
                                                    tmp_path / "ref")]
    assert manifests[0] == manifests[1]
    assert "['params']['blocks']['b0']['wq']" in manifests[0]["leaves"]
    assert "['opt']['step']" in manifests[0]["leaves"]


def test_reference_saves_the_port_restores(trees, tmp_path):
    ref_tree, port = trees
    ref_ckpt.save(str(tmp_path), 3, ref_tree)
    step, back, meta = ckpt.restore(str(tmp_path), port)
    assert step == 3 and meta == {}
    _same(back, ref_tree)
    assert set(back) == {"params", "opt"}


def test_volumes_latest_and_prune(trees, tmp_path, monkeypatch):
    """Small volumes split the leaves over several shards; ``LATEST``
    names the newest step, a stale ``.tmp`` is never taken, a missing
    step falls back to scanning, and ``prune_old`` keeps the newest."""
    _, port = trees
    monkeypatch.setattr(ckpt, "_VOLUME_BYTES", 1 << 16)
    d = str(tmp_path)
    for s in (1, 2, 3, 4):
        ckpt.save(d, s, port)
    shards = [n for n in os.listdir(os.path.join(d, "step_00000004"))
              if n.startswith("shard_")]
    assert len(shards) > 1
    assert open(os.path.join(d, "LATEST")).read() == "4"
    os.makedirs(os.path.join(d, "step_99999999.tmp"))
    assert ckpt.latest_step(d) == ref_ckpt.latest_step(d) == 4
    ckpt.prune_old(d, keep=2)
    assert sorted(n for n in os.listdir(d) if not n.endswith(".tmp")
                  and n.startswith("step_")) == ["step_00000003",
                                                 "step_00000004"]
    with open(os.path.join(d, "LATEST"), "w") as f:
        f.write("9")                    # points at a deleted step
    assert ckpt.latest_step(d) == 4
    step, back, _ = ckpt.restore(d, port, step=3)
    assert step == 3
    for g, w in zip(tree_leaves(back), tree_leaves(port)):
        assert torch.equal(g, w)
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "empty"), port)


def test_recovery_procedure_restores_through_the_port(trees, tmp_path):
    ref_tree, port = trees
    ref_ckpt.save(str(tmp_path), 5, ref_tree)
    clock = [0.0]
    mon = HeartbeatMonitor(["w0", "w1"], timeout_s=10, clock=lambda: clock[0])
    clock[0] = 4.0
    mon.beat("w0")
    clock[0] = 12.0
    plan, step, back = recovery_procedure(mon, str(tmp_path), port,
                                          model_parallel=1)
    assert step == 5 and plan.dropped_workers == ("w1",)
    _same(back, ref_tree)


def test_optimizer_state_round_trips(trees, tmp_path):
    """A restored state carries on: the port's AdamW step from a restored
    state equals the step from the state that was saved."""
    _, port = trees
    ckpt.save(str(tmp_path), 1, port)
    _, back, _ = ckpt.restore(str(tmp_path), port)
    grads = tree_map(lambda t: t * 0.5, port["params"])
    out = []
    for tree in (port, back):
        state = tree_map(torch.clone, tree["opt"])
        out.append(optimizer.apply_updates(optimizer.AdamWConfig(),
                                           tree["params"], grads, state)[0])
    for a, b in zip(tree_leaves(out[0]), tree_leaves(out[1])):
        assert torch.equal(a, b)
