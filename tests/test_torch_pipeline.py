"""Port parity, the GPipe forward (``repro_torch/distributed/pipeline.py``
against ``repro/distributed/pipeline.py``).

Worlds of 4 and 2 ``gloo`` ranks (fresh processes, rendezvous by a file
under ``tmp_path``) run ``gpipe_forward`` and save every rank's outputs
as ``.npy``:

  * the reference test's problem (one ``tanh(x @ w)`` a stage, M = 6
    microbatches of 2 x 8, inputs drawn with numpy) over S = 4 and 2
    stages, held within the reference test's ``atol=1e-5`` to the
    reference's ``gpipe_forward`` (one JAX subprocess with 4 fake host
    devices, meshes of its first S), and to the bit to the port's
    sequential loop, microbatch by microbatch, in the same rank;
  * reduced Qwen2-7B (2 groups) in fp32 as a two-stage pipeline of
    ``run_layer_range``, its parameters converted from the reference's
    tree: to the bit against the port's one-process ``run_layer_range(0,
    G)`` (run in rank 0, one thread like the stages), and within 5e-5
    (``tests/test_torch_lm.py``'s fp32 tolerance) of the reference's.

A rank reads only its own stage: the stacked parameters it gets have
every other stage's slice set to NaN, or are its own stage expanded to
every stage's entry, and its outputs keep the same bits.
"""
import concurrent.futures
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.distributed import pipeline
from repro_torch.distributed.collectives import HopStats
from repro_torch.distributed.world import run_world
from repro_torch.launch.mesh import Mesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD_TIMEOUT_S = 240
TANH = dict(M=6, B=2, D=8)
STAGES = (4, 2)
QWEN_MICRO, QWEN_BATCH, QWEN_SEQ = 3, 2, 24


def _tanh_inputs(S):
    rng = np.random.default_rng(S)
    W = (rng.standard_normal((S, TANH["D"], TANH["D"])) * 0.3).astype(
        np.float32)
    x = rng.standard_normal((TANH["M"], TANH["B"], TANH["D"])).astype(
        np.float32)
    return W, x


REFERENCE = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np, jax.numpy as jnp
from repro.distributed.pipeline import gpipe_forward
from repro.jax_compat import make_mesh

out = sys.argv[1]
for S in (4, 2):
    data = np.load(os.path.join(out, f"tanh{S}.npz"))
    mesh = make_mesh((S,), ("stage",))
    got = gpipe_forward(lambda w, x: jnp.tanh(x @ w), jnp.asarray(data["W"]),
                        jnp.asarray(data["x"]), mesh=mesh, axis_name="stage")
    np.save(os.path.join(out, f"ref_tanh{S}.npy"), np.asarray(got))
"""


def _tanh(w, x):
    return torch.tanh(x @ w)


def _rank_pipelines(rank, S, W, x, out, qwen=None):
    """One rank: the tanh problem over S stages, then, given ``qwen`` (the
    reference's numpy tree and the microbatches), the Qwen2 stages."""
    _rank_tanh(rank, S, W, x, out)
    if qwen is not None:
        _rank_qwen(rank, S, *qwen, out)


def _rank_tanh(rank, S, W, x, out):
    mesh = Mesh((S,), ("stage",))
    W, x = torch.from_numpy(W), torch.from_numpy(x)
    stats = HopStats()
    got = pipeline.gpipe_forward(_tanh, W, x, mesh=mesh, axis_name="stage",
                                 stats=stats)
    np.save(os.path.join(out, f"tanh{S}_r{rank}.npy"), got.numpy())
    np.save(os.path.join(out, f"tanh{S}_hops_r{rank}.npy"),
            np.array([stats.hops, stats.bytes]))
    # the same run from parameters where only this rank's stage is real
    others = torch.full_like(W, float("nan"))
    others[rank] = W[rank]
    own = W[rank].clone().unsqueeze(0).expand(W.shape)
    for tag, params in (("nan", others), ("expanded", own)):
        got = pipeline.gpipe_forward(_tanh, params, x, mesh=mesh,
                                     axis_name="stage")
        np.save(os.path.join(out, f"tanh{S}_{tag}_r{rank}.npy"), got.numpy())
    seq = []
    for m in range(x.shape[0]):
        y = x[m]
        for s in range(S):
            y = _tanh(W[s], y)
        seq.append(y)
    np.save(os.path.join(out, f"tanh{S}_seq_r{rank}.npy"),
            torch.stack(seq).numpy())


def _qwen_cfg():
    from repro_torch.configs import reduced_config
    return dataclasses.replace(reduced_config("qwen2-7b"),
                               param_dtype="float32")


def _rank_qwen(rank, S, tree, x, out):
    from repro_torch.convert import from_jax_params
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tr

    cfg = _qwen_cfg()
    G = cfg.num_groups()
    params = from_jax_params(tree, "cpu")
    x = torch.from_numpy(x)
    positions = torch.arange(x.shape[2])

    def run(p, h, stop):
        return tr.run_layer_range(p, h, cfg, None, start_group=0,
                                  stop_group=stop, positions=positions,
                                  kernels=ops.kernel_registry())

    if cfg.tail_pattern() or G % S:
        raise ValueError(f"{G} groups and a tail do not split in {S}")
    stage_params = {"blocks": _by_stage(params["blocks"], S)}
    got = pipeline.gpipe_forward(lambda p, h: run(p, h, G // S),
                                 stage_params, x, mesh=Mesh((S,), ("stage",)),
                                 axis_name="stage")
    np.save(os.path.join(out, f"qwen_r{rank}.npy"), got.numpy())
    if rank == 0:
        one = torch.stack([run(params, x[m], G) for m in range(x.shape[0])])
        np.save(os.path.join(out, "qwen_one_process.npy"), one.numpy())


def _by_stage(tree, S):
    """Leaves of leading dim G as (S, G / S, ...): stage s's groups at
    [s] (views)."""
    if isinstance(tree, dict):
        return {k: _by_stage(v, S) for k, v in tree.items()}
    return tree.reshape((S, tree.shape[0] // S) + tuple(tree.shape[1:]))


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """A loader of saved arrays (``load(name)``), and the reference's
    fp32 ``run_layer_range`` of each Qwen2 microbatch."""
    import jax
    import jax.numpy as jnp
    from repro.configs import reduced_config as ref_reduced_config
    from repro.models import transformer as ref_tr

    tmp = tmp_path_factory.mktemp("pipeline")
    for S in STAGES:
        W, x = _tanh_inputs(S)
        np.savez(tmp / f"tanh{S}.npz", W=W, x=x)
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", REFERENCE, str(tmp)], cwd=ROOT,
        env={**os.environ, "PYTHONPATH": "src", "JAX_PLATFORMS": "cpu"},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    def world(S, qwen=None):
        workdir = tmp / f"ranks{S}"
        workdir.mkdir()
        run_world(_rank_pipelines, S, (*_tanh_inputs(S), str(tmp), qwen),
                  workdir=workdir, timeout=WORLD_TIMEOUT_S)

    pool = concurrent.futures.ThreadPoolExecutor(1)
    try:
        # the world of 4 runs while this process computes the reference's
        # Qwen2 (one world starts at a time)
        four = pool.submit(world, 4)
        ref_cfg = dataclasses.replace(ref_reduced_config("qwen2-7b"),
                                      param_dtype="float32")
        ref_params = jax.tree_util.tree_map(
            lambda a: a.astype(jnp.float32),
            ref_tr.init_params(ref_cfg, jax.random.PRNGKey(0)))
        toks = np.random.default_rng(7).integers(
            0, ref_cfg.vocab_size, (QWEN_MICRO * QWEN_BATCH, QWEN_SEQ))
        x = np.asarray(ref_tr.embed_inputs(
            ref_params, {"tokens": jnp.asarray(toks, jnp.int32)}, ref_cfg),
            np.float32).reshape(QWEN_MICRO, QWEN_BATCH, QWEN_SEQ, -1)
        G = ref_cfg.num_groups()
        ref_qwen = np.stack([np.asarray(ref_tr.run_layer_range(
            ref_params, jnp.asarray(x[m]), ref_cfg, None, start_group=0,
            stop_group=G, positions=jnp.arange(QWEN_SEQ)), np.float32)
            for m in range(QWEN_MICRO)])
        four.result()
        world(2, (jax.tree_util.tree_map(np.asarray, ref_params), x))
        _, err = jax_proc.communicate(timeout=WORLD_TIMEOUT_S)
    finally:
        pool.shutdown(wait=True)
        if jax_proc.poll() is None:
            jax_proc.kill()
            jax_proc.wait()
    assert jax_proc.returncode == 0, err[-3000:]

    def load(name):
        return np.load(tmp / f"{name}.npy")
    load.ref_qwen = ref_qwen
    return load


def test_bubble_fraction_matches_reference():
    from repro.distributed.pipeline import bubble_fraction as ref_bubble
    for S in range(1, 17):
        for M in range(1, 65):
            assert pipeline.bubble_fraction(M, S) == ref_bubble(M, S)
    assert pipeline.bubble_fraction(4, 4) == 3 / 7


@pytest.mark.multidevice
@pytest.mark.parametrize("S", STAGES)
def test_gpipe_matches_reference(results, S):
    want = results(f"ref_tanh{S}")
    for rank in range(S):
        np.testing.assert_allclose(results(f"tanh{S}_r{rank}"), want,
                                   atol=1e-5)


@pytest.mark.multidevice
@pytest.mark.parametrize("S", STAGES)
def test_gpipe_matches_sequential_to_the_bit(results, S):
    for rank in range(S):
        np.testing.assert_array_equal(
            results(f"tanh{S}_r{rank}").view(np.uint32),
            results(f"tanh{S}_seq_r{rank}").view(np.uint32))


@pytest.mark.multidevice
@pytest.mark.parametrize("S", STAGES)
@pytest.mark.parametrize("form", ["nan", "expanded"])
def test_gpipe_reads_only_its_own_stage(results, S, form):
    for rank in range(S):
        np.testing.assert_array_equal(
            results(f"tanh{S}_{form}_r{rank}").view(np.uint32),
            results(f"tanh{S}_r{rank}").view(np.uint32))


@pytest.mark.multidevice
@pytest.mark.parametrize("S", STAGES)
def test_gpipe_hops(results, S):
    """Each stage but the last sends its M activations once."""
    hop_bytes = TANH["B"] * TANH["D"] * 4
    for rank in range(S):
        sent = TANH["M"] if rank < S - 1 else 0
        np.testing.assert_array_equal(results(f"tanh{S}_hops_r{rank}"),
                                      [sent, sent * hop_bytes])


@pytest.mark.multidevice
def test_qwen2_two_stages_match_one_process_to_the_bit(results):
    want = results("qwen_one_process")
    for rank in range(2):
        np.testing.assert_array_equal(results(f"qwen_r{rank}").view(
            np.uint32), want.view(np.uint32))


@pytest.mark.multidevice
def test_qwen2_two_stages_match_reference(results):
    for rank in range(2):
        np.testing.assert_allclose(results(f"qwen_r{rank}"),
                                   results.ref_qwen, atol=5e-5, rtol=5e-5)


def test_stage_slice_checks_its_stages():
    tree = {"w": torch.zeros(3, 2), "b": {"c": torch.ones(3)}, "n": None}
    got = pipeline.stage_slice(tree, 1, 3)
    assert got["w"].shape == (2,) and got["n"] is None
    assert float(got["b"]["c"]) == 1.0
    mine = torch.arange(4.0)
    got = pipeline.stage_slice({"w": mine.unsqueeze(0).expand(3, 4)}, 2, 3)
    assert got["w"].data_ptr() == mine.data_ptr()
    with pytest.raises(ValueError):
        pipeline.stage_slice(tree, 0, 4)
