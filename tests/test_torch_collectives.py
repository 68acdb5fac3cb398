"""Port parity, the collectives (``repro_torch/distributed/collectives.py``
against ``repro/distributed/collectives.py``).

Worlds of 2 and 4 ``gloo`` ranks (fresh processes, rendezvous by a file
under ``tmp_path``) run the port's ring all-gather,
``make_ring_all_gather`` and ``reduce_scatter_then_gather`` on arrays
drawn with numpy, beside ``all_gather_into_tensor`` and ``all_reduce``,
and save what every rank got as ``.npy``.  One JAX subprocess with 4
fake host devices runs the reference's on the same arrays, on meshes of
its first 2 and 4 devices.  Everything is held to the bit: a gather
moves bits, and the reductions sum integer-valued fp32, where every sum
is exact.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.distributed import collectives as coll
from repro_torch.distributed.world import run_world
from repro_torch.launch.mesh import Mesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLDS = (2, 4)
WORLD_TIMEOUT_S = 240
#: arrays to gather: the reference test's arange, and random fp32 with
#: trailing dims (rows per rank, trailing shape)
GATHERED = {"arange": (4, (3,)), "normal": (6, (5, 7))}


def _inputs(n):
    """The arrays of a world of n, the same in the ranks and the
    reference."""
    rng = np.random.default_rng(100 + n)
    rows, trail = GATHERED["normal"]
    return {
        "arange": np.arange(n * 4 * 3, dtype=np.float32).reshape(n * 4, 3),
        "normal": rng.standard_normal((n * rows,) + trail).astype(
            np.float32),
        # integer-valued fp32 summed over n ranks: exact in any order
        "ints": rng.integers(-1000, 1001, (n * n * 2, 6)).astype(
            np.float32)}


REFERENCE = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.distributed.collectives import (make_ring_all_gather,
                                           reduce_scatter_then_gather)
from repro.jax_compat import make_mesh, shard_map

out = sys.argv[1]
for n in (2, 4):
    mesh = make_mesh((n,), ("x",))
    arrays = dict(np.load(os.path.join(out, f"inputs{n}.npz")))
    for name in ("arange", "normal"):
        got = make_ring_all_gather(mesh, "x")(jnp.asarray(arrays[name]))
        np.save(os.path.join(out, f"ref{n}_ring_{name}.npy"),
                np.asarray(got))
    ints = jnp.asarray(arrays["ints"])
    for tag, body in (("rsg", lambda s: reduce_scatter_then_gather(s, "x")),
                      ("psum", lambda s: jax.lax.psum(s, "x"))):
        got = jax.jit(shard_map(body, mesh=mesh, in_specs=P("x"),
                                out_specs=P("x"), check_vma=False))(ints)
        np.save(os.path.join(out, f"ref{n}_{tag}.npy"), np.asarray(got))
"""


def _bits(a):
    a = np.asarray(a)
    return a.view({2: np.uint16, 4: np.uint32}[a.dtype.itemsize])


def _rank_collectives(rank, world_size, arrays, out):
    """One rank: every collective of the module on its shards, saved."""
    n = world_size

    def save(name, t):
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        np.save(os.path.join(out, f"{name}_r{rank}.npy"), t.numpy())

    mesh = Mesh((n,), ("x",))
    group = mesh.group("x")
    for name in GATHERED:
        x = torch.from_numpy(arrays[name])
        chunk = x.shape[0] // n
        shard = x[rank * chunk:(rank + 1) * chunk]
        stats = coll.HopStats()
        save(f"ring_{name}",
             coll.ring_all_gather(shard, "x", mesh=mesh, stats=stats))
        save(f"stats_{name}", torch.tensor([stats.hops, stats.bytes]))
        save(f"ring_group_{name}", coll.ring_all_gather(shard, group=group))
        want = torch.empty_like(x)
        dist.all_gather_into_tensor(want, shard.contiguous(), group=group)
        save(f"agt_{name}", want)
        save(f"make_ring_{name}", coll.make_ring_all_gather(mesh, "x")(x))
        bf16 = x.to(torch.bfloat16)
        save(f"ring_bf16_{name}", coll.ring_all_gather(
            bf16[rank * chunk:(rank + 1) * chunk], "x", mesh=mesh))
        save(f"bf16_{name}", bf16)
    rows = arrays["ints"].shape[0] // n
    local = torch.from_numpy(arrays["ints"][rank * rows:(rank + 1) * rows])
    save("rsg", coll.reduce_scatter_then_gather(local, "x", mesh=mesh))
    summed = local.clone()
    dist.all_reduce(summed, group=group)
    save("all_reduce", summed)
    try:
        coll.reduce_scatter_then_gather(local[:n + 1], "x", mesh=mesh)
        save("uneven_raises", torch.tensor(0))
    except ValueError:
        save("uneven_raises", torch.tensor(1))
    if n == 4:
        # on a 2 x 2 mesh, along each axis: the rows of each rank's block
        mesh2 = Mesh((2, 2), ("data", "model"))
        x = torch.from_numpy(arrays["normal"])
        for axis in mesh2.axis_names:
            i, chunk = mesh2.axis_index(axis), x.shape[0] // 2
            save(f"ring2d_{axis}", coll.ring_all_gather(
                x[i * chunk:(i + 1) * chunk], axis, mesh=mesh2))
            save(f"make_ring2d_{axis}",
                 coll.make_ring_all_gather(mesh2, axis)(x))


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """A loader of saved arrays: ``load(n, name, rank)`` for the ranks of
    a world of n, ``load(n, name)`` for the reference, ``load(n,
    "inputs")`` for the inputs."""
    tmp = tmp_path_factory.mktemp("collectives")
    for n in WORLDS:
        np.savez(tmp / f"inputs{n}.npz", **_inputs(n))
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", REFERENCE, str(tmp)], cwd=ROOT,
        env={**os.environ, "PYTHONPATH": "src", "JAX_PLATFORMS": "cpu"},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        for n in WORLDS:
            out = tmp / f"world{n}"
            (out / "ranks").mkdir(parents=True)
            run_world(_rank_collectives, n, (_inputs(n), str(out)),
                      workdir=out / "ranks", timeout=WORLD_TIMEOUT_S)
        _, err = jax_proc.communicate(timeout=WORLD_TIMEOUT_S)
    finally:
        if jax_proc.poll() is None:
            jax_proc.kill()
            jax_proc.wait()
    assert jax_proc.returncode == 0, err[-3000:]

    def load(n, name, rank=None):
        if name == "inputs":
            return _inputs(n)
        if rank is None:
            return np.load(tmp / f"ref{n}_{name}.npy")
        return np.load(tmp / f"world{n}" / f"{name}_r{rank}.npy")
    return load


@pytest.mark.multidevice
@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("name", list(GATHERED))
def test_ring_all_gather_matches_reference(results, n, name):
    """Every rank's gather (by mesh axis, and by group) is the whole
    array, bit for bit the reference's ``make_ring_all_gather``."""
    want = results(n, f"ring_{name}")
    np.testing.assert_array_equal(_bits(want),
                                  _bits(results(n, "inputs")[name]))
    for rank in range(n):
        for tag in ("ring", "ring_group"):
            np.testing.assert_array_equal(
                _bits(results(n, f"{tag}_{name}", rank)), _bits(want))


@pytest.mark.multidevice
@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("name", list(GATHERED))
def test_ring_all_gather_matches_all_gather_into_tensor(results, n, name):
    for rank in range(n):
        np.testing.assert_array_equal(
            _bits(results(n, f"ring_{name}", rank)),
            _bits(results(n, f"agt_{name}", rank)))


@pytest.mark.multidevice
@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("name", list(GATHERED))
def test_make_ring_all_gather_returns_the_whole(results, n, name):
    want = results(n, f"ring_{name}")
    for rank in range(n):
        np.testing.assert_array_equal(
            _bits(results(n, f"make_ring_{name}", rank)), _bits(want))


@pytest.mark.multidevice
@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("name", list(GATHERED))
def test_ring_all_gather_moves_bf16_bits(results, n, name):
    """bf16, the dtype of the weights gathered on the card."""
    for rank in range(n):
        np.testing.assert_array_equal(results(n, f"ring_bf16_{name}", rank),
                                      results(n, f"bf16_{name}", rank))


@pytest.mark.multidevice
@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("name", list(GATHERED))
def test_ring_counts_its_hops(results, n, name):
    """N-1 sends a rank, each one shard."""
    rows, trail = GATHERED[name]
    shard_bytes = rows * int(np.prod(trail)) * 4
    for rank in range(n):
        np.testing.assert_array_equal(results(n, f"stats_{name}", rank),
                                      [n - 1, (n - 1) * shard_bytes])


@pytest.mark.multidevice
@pytest.mark.parametrize("n", WORLDS)
def test_reduce_scatter_then_gather_is_all_reduce(results, n):
    """To the bit against ``all_reduce`` on every rank, and against the
    reference's phases and its ``psum`` (each rank's rows of the
    reference's ``P("x")`` output)."""
    ints = results(n, "inputs")["ints"]
    rows = ints.shape[0] // n
    want = ints.reshape(n, rows, -1).sum(0)
    for rank in range(n):
        got = results(n, "rsg", rank)
        np.testing.assert_array_equal(_bits(got),
                                      _bits(results(n, "all_reduce", rank)))
        np.testing.assert_array_equal(got, want)
        for tag in ("rsg", "psum"):
            ref = results(n, tag)[rank * rows:(rank + 1) * rows]
            np.testing.assert_array_equal(_bits(got), _bits(ref))
        assert results(n, "uneven_raises", rank) == 1


@pytest.mark.multidevice
@pytest.mark.parametrize("axis", ["data", "model"])
def test_ring_along_each_axis_of_a_2d_mesh(results, axis):
    """Mesh (2, 2) in a world of 4: the ring runs inside each rank's
    group along ``axis`` and gathers the whole array."""
    x = results(4, "inputs")["normal"]
    for rank in range(4):
        for tag in ("ring2d", "make_ring2d"):
            np.testing.assert_array_equal(
                _bits(results(4, f"{tag}_{axis}", rank)), _bits(x))


def test_collectives_need_a_mesh_or_a_group():
    x = torch.zeros(4, 2)
    for fn in (coll.ring_all_gather, coll.reduce_scatter_then_gather):
        with pytest.raises(TypeError, match="mesh= .* or group="):
            fn(x, "x")
