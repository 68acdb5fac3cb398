"""Port parity, the training launcher (ROADMAP A9c):
``repro_torch.launch.train.main`` against the reference's
``repro.launch.train.main`` on reduced smollm-135m in fp32, both started
from the reference's initial tree (one JAX init for the file; the port's
``transformer.init_params`` is monkeypatched to hand it over, as
``tests/test_torch_train.py`` does).  The reference's ``main`` takes its
arguments from ``sys.argv`` and prints its history; the port's takes an
argv and also returns the history.

Tolerances: the logged losses and gradient norms rtol 1e-4, as
``tests/test_torch_train.py`` holds ``TrainLoop`` over 10 steps; the
learning rates rtol 1e-6 (the same fp32 schedule); the printed numbers
within one unit of their last printed digit.
"""
import contextlib
import dataclasses
import io
import os
import re
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as ref_reduced_config
from repro.launch import train as ref_launch
from repro.models import transformer as ref_tr
from repro.train import train_loop as ref_loop
from repro_torch.configs import reduced_config
from repro_torch.convert import from_jax_params, tree_leaves
from repro_torch.data.pipeline import DataConfig, batch_for_config
from repro_torch.launch import train as launch
from repro_torch.models import transformer as tr
from repro_torch.train import checkpoint

torch.set_num_threads(1)

ARCH = "smollm-135m"
BATCH, SEQ = 2, 32
ARGS = ["--arch", ARCH, "--batch", str(BATCH), "--seq", str(SEQ)]
STEP_LINE = re.compile(r"^step +(\d+) loss (\S+) gnorm (\S+) lr (\S+)$")


def _fp32(reduced):
    return lambda arch: dataclasses.replace(reduced(arch),
                                            param_dtype="float32")


@pytest.fixture(scope="module")
def ref_tree():
    cfg = _fp32(ref_reduced_config)(ARCH)
    return jax.jit(lambda key: ref_tr.init_params(cfg, key))(
        jax.random.PRNGKey(0))


@pytest.fixture
def fp32_from_the_reference(monkeypatch, ref_tree):
    """Both launchers build the fp32 reduced config and start from the
    reference's tree."""
    monkeypatch.setattr(ref_launch, "reduced_config",
                        _fp32(ref_reduced_config))
    monkeypatch.setattr(launch, "reduced_config", _fp32(reduced_config))
    tree = jax.tree_util.tree_map(np.asarray, ref_tree)
    monkeypatch.setattr(tr, "init_params",
                        lambda c, gen, dev: from_jax_params(tree, dev))
    monkeypatch.setattr(ref_tr, "init_params", lambda c, key: ref_tree)


def _run(fn, *args):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        ret = fn(*args)
    return ret, out.getvalue().splitlines()


def _steps(lines):
    """The printed (step, loss, gnorm, lr) rows."""
    rows = [STEP_LINE.match(line) for line in lines]
    return [(int(m[1]), float(m[2]), float(m[3]), float(m[4]))
            for m in rows if m]


def test_main_prints_the_reference_history(fp32_from_the_reference,
                                           monkeypatch):
    ref_hist = []
    ref_run = ref_loop.TrainLoop.run

    def spy(self, *a, **k):
        out = ref_run(self, *a, **k)
        ref_hist.extend(out[2])
        return out

    monkeypatch.setattr(ref_loop.TrainLoop, "run", spy)
    monkeypatch.setattr(sys, "argv", ["train"] + ARGS + ["--steps", "10"])
    _, want = _run(ref_launch.main)
    hist, got = _run(launch.main, ARGS + ["--steps", "10", "--device", "cpu"])

    assert [h["step"] for h in hist] == [h["step"] for h in ref_hist] \
        == [0, 9]
    for key, rtol in (("loss", 1e-4), ("grad_norm", 1e-4), ("lr", 1e-6)):
        np.testing.assert_allclose([h[key] for h in hist],
                                   [h[key] for h in ref_hist], rtol=rtol)
    rows, ref_rows = np.array(_steps(got)), np.array(_steps(want))
    assert rows.shape == ref_rows.shape == (2, 4)
    np.testing.assert_array_equal(rows[:, 0], ref_rows[:, 0])
    np.testing.assert_allclose(rows[:, 1], ref_rows[:, 1], rtol=0,
                               atol=1.01e-4)
    np.testing.assert_allclose(rows[:, 2], ref_rows[:, 2], rtol=0,
                               atol=1.01e-3)
    np.testing.assert_allclose(rows[:, 3], ref_rows[:, 3], rtol=1.01e-2)
    # the summary, numbers aside, word for word (the mesh included)
    number = re.compile(r"\d+\.\d+")
    assert [number.sub("#", line) for line in got[2:]] == \
        [number.sub("#", line) for line in want[2:]] == \
        ["", f"{reduced_config(ARCH).name}: loss # -> # over 10 steps on "
             "mesh {'data': 1, 'model': 1}"]


@pytest.mark.parametrize("flag", [
    pytest.param("--data-parallel", marks=pytest.mark.multidevice),
    pytest.param("--model-parallel", marks=pytest.mark.multidevice),
    pytest.param("both", marks=pytest.mark.multidevice)])
def test_a_mesh_above_one_device_raises(flag, monkeypatch):
    """The reference clamps the mesh to the devices it finds; the port
    never trains on fewer than were asked for (the name is from when a
    mesh above one device raised: each case now trains on the whole mesh
    it asks for).  A data axis of 2, a model axis of 2, or both trains in
    the 2 or 4 ``gloo`` ranks that the launcher starts itself, on the
    port's own init (reduced smollm-135m in fp32): the reference's lines
    with ``{'data': 2, 'model': 1}``, ``{'data': 1, 'model': 2}`` or
    ``{'data': 2, 'model': 2}``, and a history within rtol 1e-4 of the
    one-device ``main``'s (the same global batch and tokens; over data
    ranks the gradient summed over the ranks in fp32, over model ranks
    each rank on its blocks, the sums over the model axis in fp32; over
    both, each rank on its rows and its blocks)."""
    argv = ARGS + ["--steps", "10", "--device", "cpu"]
    flags = {"--data-parallel": ["--data-parallel", "2"],
             "--model-parallel": ["--model-parallel", "2"],
             "both": ["--data-parallel", "2", "--model-parallel", "2"]}
    mesh = {"--data-parallel": (2, 1), "--model-parallel": (1, 2),
            "both": (2, 2)}[flag]
    monkeypatch.setattr(launch, "reduced_config", _fp32(reduced_config))
    one, _ = _run(launch.main, argv)
    hist, lines = _run(launch.main, argv + flags[flag])
    assert [h["step"] for h in hist] == [h["step"] for h in one] == [0, 9]
    for key, rtol in (("loss", 1e-4), ("grad_norm", 1e-4), ("lr", 1e-6)):
        np.testing.assert_allclose([h[key] for h in hist],
                                   [h[key] for h in one], rtol=rtol)
    assert [r[0] for r in _steps(lines)] == [0, 9]
    assert re.fullmatch(
        rf"{reduced_config(ARCH).name}: loss \d+\.\d{{3}} -> \d+\.\d{{3}} "
        rf"over 10 steps on mesh \{{'data': {mesh[0]}, 'model': {mesh[1]}\}}",
        lines[-1])


def _no_world(*args, **kwargs):
    raise AssertionError("a rank was started")


def test_a_moe_model_over_a_data_mesh_raises_before_any_rank_starts(
        monkeypatch):
    """Mixture-of-Experts training over a data mesh is ROADMAP
    A10.2b-moe: the reference counts the capacity per data shard and
    takes data shard 0's aux, whose gradient needs its own study."""
    monkeypatch.setattr(launch, "run_world", _no_world)
    with pytest.raises(NotImplementedError, match="ROADMAP A10.2b-moe"):
        launch.main(["--arch", "olmoe-1b-7b", "--batch", "2", "--seq", "16",
                     "--steps", "1", "--device", "cpu",
                     "--data-parallel", "2"])


@pytest.mark.parametrize("arch, extra, item", [
    ("recurrentgemma-9b", [], "A10.2c-train-rec"),
    ("mamba2-780m", [], "A10.2c-train-rec"),
    ("seamless-m4t-medium", [], "A10.2c-train-rec"),
    ("olmoe-1b-7b", [], "A10.2b-moe"),
    (ARCH, ["--ckpt-dir", "unused"], "A10.2c-train-ckpt"),
    (ARCH, ["--data-parallel", "2", "--ckpt-dir", "unused"],
     "A10.2c-train-ckpt")])
def test_what_a_model_axis_cannot_train_raises_before_any_rank_starts(
        arch, extra, item, monkeypatch):
    """Over a model axis of 2 (with a data axis of 1, or of 2): RG-LRU,
    SSD and encoder-decoder models (their blocks' backward over the
    axis), a Mixture-of-Experts model, and a checkpoint directory each
    raise naming their ROADMAP item."""
    monkeypatch.setattr(launch, "run_world", _no_world)
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        launch.main(["--arch", arch, "--batch", "2", "--seq", "16",
                     "--steps", "1", "--device", "cpu",
                     "--model-parallel", "2"] + extra)


def test_main_needs_a_gpu_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device is required"):
        launch.main(ARGS + ["--steps", "1"])


def test_a_second_run_resumes_at_step_100(tmp_path):
    """Two runs of 100 steps on one checkpoint directory: the first
    writes step 100, the second starts there, logs steps 100-199 and
    writes step 200; its step-100 loss is the loss of the restored
    parameters on the data of step 100."""
    argv = ["--arch", ARCH, "--batch", "2", "--seq", "16", "--steps", "100",
            "--ckpt-dir", str(tmp_path), "--device", "cpu"]
    first, lines = _run(launch.main, argv)
    assert [r[0] for r in _steps(lines)] == [0] + list(range(9, 100, 10))
    assert sorted(os.listdir(tmp_path)) == ["LATEST", "step_00000100"]
    second, lines = _run(launch.main, argv)
    assert [r[0] for r in _steps(lines)] == [100] + list(range(109, 200, 10))
    assert sorted(os.listdir(tmp_path)) == ["LATEST", "step_00000100",
                                            "step_00000200"]
    assert all(np.isfinite(h["loss"]) for h in first + second)

    cfg = reduced_config(ARCH)
    template = tr.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    _, params, meta = checkpoint.restore(str(tmp_path),
                                         {"params": template}, step=100)
    assert meta == {"model": cfg.name}
    batch = batch_for_config(cfg, DataConfig(cfg.vocab_size, 16, 2), 100)
    with torch.no_grad():
        loss, _ = tr.train_forward(
            params["params"],
            {k: torch.from_numpy(v) for k, v in batch.items()}, cfg)
    np.testing.assert_allclose(second[0]["loss"], float(loss), rtol=1e-5)
    assert [p.dtype for p in tree_leaves(params["params"])] == \
        [p.dtype for p in tree_leaves(template)]
