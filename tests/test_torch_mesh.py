"""Port parity, the meshes (``repro_torch/launch/mesh.py`` against
``repro/launch/mesh.py``) and the world of ranks the distributed tests
run on (``repro_torch/distributed/world.py``).

The reference's meshes come from one JAX subprocess with 512 fake host
devices, so that the production meshes are real jax meshes.  Its
``make_host_mesh`` on a host of n devices is taken there by handing the
function's ``len(jax.devices())`` the first n: ``jax.make_mesh`` places
the first ``data * model`` devices whatever their number.  The port's
meshes are made in worlds of 2 and 4 ``gloo`` ranks (fresh processes,
rendezvous by a file under ``tmp_path``) and, for a world of 1, in the
test process without a process group.  Each world starts once for the
file; the checks are cases over its results.
"""
import json
import os
import subprocess
import sys

import pytest
import torch
import torch.distributed as dist

from repro_torch.distributed.world import run_world
from repro_torch.launch import mesh as port_mesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLDS = (2, 4)
WORLD_TIMEOUT_S = 240
#: (data, model) asked of make_host_mesh: under, at and over each world
HOST_GRID = ((1, 1), (2, 1), (1, 2), (2, 2), (4, 1), (1, 4), (8, 1),
             (1, 8), (3, 1), (2, 3), (4, 4))
ELASTIC_GRID = ((1, 2, 2), (2, 1, 2), (2, 16, 16), (1, 16, 16), (3, 2, 1))

REFERENCE = """
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import jax
from repro.launch import mesh as ref

def desc(m):
    return {"shape": list(dict(m.shape).items()), "axis_names":
            list(m.axis_names), "size": int(m.size),
            "devices": [d.id for d in m.devices.flat],
            "grid": list(m.devices.shape)}

grid, elastic = json.loads(sys.argv[2]), json.loads(sys.argv[3])
real = jax.devices
out = {"host": {}, "production": {}, "elastic": {}}
for n in (1, 2, 4):
    jax.devices = lambda n=n: real()[:n]
    out["host"][n] = {f"{d},{m}": desc(ref.make_host_mesh(d, m))
                      for d, m in grid}
jax.devices = real
for multi in (False, True):
    out["production"][str(multi)] = desc(
        ref.make_production_mesh(multi_pod=multi))
for p, d, m in elastic:
    out["elastic"][f"{p},{d},{m}"] = desc(ref.make_elastic_mesh(p, d, m))
with open(sys.argv[1], "w") as f:
    json.dump(out, f)
"""


def _desc(m):
    return {"shape": [[k, v] for k, v in dict(m.shape).items()],
            "axis_names": list(m.axis_names), "size": int(m.size),
            "devices": [int(r) for r in m.devices.flat],
            "grid": list(m.devices.shape)}


def _rank_meshes(rank, world_size, grid):
    """One rank: its host meshes, its groups' members and sums, and what
    a rank outside a mesh gets."""
    out = {"host": {f"{d},{m}": _desc(port_mesh.make_host_mesh(d, m))
                    for d, m in grid}}
    mesh = port_mesh.make_host_mesh(2, 2)       # (2, 1) in a world of 2
    out["groups"] = {}
    for axis in mesh.axis_names:
        group = mesh.group(axis)
        value = torch.tensor([float(rank + 1)])
        dist.all_reduce(value, group=group)
        out["groups"][axis] = {
            "members": dist.get_process_group_ranks(group),
            "sum": float(value), "index": mesh.axis_index(axis)}
    one = port_mesh.make_host_mesh(1, 1)
    out["outside_is_non_member"] = (
        one.group("data") is dist.GroupMember.NON_GROUP_MEMBER)
    try:
        port_mesh.Mesh((world_size + 1,), ("x",)).group("x")
        out["too_big_raises"] = False
    except ValueError:
        out["too_big_raises"] = True
    return out


def _rank_fails(rank, world_size):
    if rank == 0:
        raise ValueError("rank 0 fails on purpose")
    dist.barrier()                       # waits for rank 0, which is gone


def _rank_sleeps(rank, world_size):
    import time
    time.sleep(3600)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """{"reference": ..., 1: ..., 2: [...], 4: [...]}: the reference's
    meshes, the test process's and every rank's of each world."""
    tmp = tmp_path_factory.mktemp("mesh")
    ref_path = tmp / "reference.json"
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", REFERENCE, str(ref_path),
         json.dumps(HOST_GRID), json.dumps(ELASTIC_GRID)],
        cwd=ROOT, env={**os.environ, "PYTHONPATH": "src",
                       "JAX_PLATFORMS": "cpu"},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        out = {1: {"host": {f"{d},{m}": _desc(port_mesh.make_host_mesh(d, m))
                            for d, m in HOST_GRID}}}
        for n in WORLDS:
            workdir = tmp / f"world{n}"
            workdir.mkdir()
            out[n] = run_world(_rank_meshes, n, (HOST_GRID,),
                               workdir=workdir, timeout=WORLD_TIMEOUT_S)
        _, err = jax_proc.communicate(timeout=WORLD_TIMEOUT_S)
    finally:
        if jax_proc.poll() is None:
            jax_proc.kill()
            jax_proc.wait()
    assert jax_proc.returncode == 0, err[-3000:]
    out["reference"] = json.loads(ref_path.read_text())
    return out


@pytest.mark.multidevice
@pytest.mark.parametrize("world", (1,) + WORLDS)
@pytest.mark.parametrize("data,model", HOST_GRID)
def test_host_mesh_matches_reference(results, world, data, model):
    """Shape, axis names, size and the ranks in it, on every rank: the
    clamp to the world, and a mesh below the world on its first ranks."""
    want = results["reference"]["host"][str(world)][f"{data},{model}"]
    ranks = [results[1]] if world == 1 else results[world]
    for got in ranks:
        assert got["host"][f"{data},{model}"] == want


@pytest.mark.multidevice
def test_a_mesh_below_the_world_takes_its_first_ranks(results):
    """The reference's ``make_host_mesh(1, 1)`` on 4 devices is device 0
    alone, not all four (``jax.make_mesh`` takes the first devices)."""
    want = results["reference"]["host"]["4"]["1,1"]
    assert want["devices"] == [0] and want["size"] == 1
    assert results[4][3]["host"]["1,1"] == want


@pytest.mark.multidevice
@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_matches_reference(results, multi_pod):
    want = results["reference"]["production"][str(multi_pod)]
    got = port_mesh.make_production_mesh(multi_pod=multi_pod)
    assert _desc(got) == want
    # described without a world of 256 or 512: no process group here
    assert not dist.is_initialized()


@pytest.mark.multidevice
@pytest.mark.parametrize("pods,data,model", ELASTIC_GRID)
def test_elastic_mesh_matches_reference(results, pods, data, model):
    want = results["reference"]["elastic"][f"{pods},{data},{model}"]
    assert _desc(port_mesh.make_elastic_mesh(pods, data, model)) == want


@pytest.mark.multidevice
@pytest.mark.parametrize("world", WORLDS)
def test_groups_run_along_their_axis(results, world):
    """make_host_mesh(2, 2): in a world of 4, "data" groups ranks {0, 2}
    and {1, 3}, "model" {0, 1} and {2, 3}; in a world of 2 the mesh is
    (2, 1).  Each rank's all-reduce of rank + 1 sums its own group."""
    model = 2 if world == 4 else 1
    for rank, got in enumerate(results[world]):
        d, m = divmod(rank, model)
        data_members = [i * model + m for i in range(2)]
        model_members = [d * model + j for j in range(model)]
        assert got["groups"]["data"] == {
            "members": data_members, "index": d,
            "sum": float(sum(r + 1 for r in data_members))}
        assert got["groups"]["model"] == {
            "members": model_members, "index": m,
            "sum": float(sum(r + 1 for r in model_members))}


@pytest.mark.multidevice
@pytest.mark.parametrize("world", WORLDS)
def test_ranks_outside_a_mesh_get_no_group(results, world):
    flags = [got["outside_is_non_member"] for got in results[world]]
    assert flags == [False] + [True] * (world - 1)
    # a mesh larger than the world has no groups to make
    assert all(got["too_big_raises"] for got in results[world])


def test_mesh_is_a_plain_description():
    m = port_mesh.Mesh((2, 3), ("data", "model"))
    assert repr(m) == "Mesh({'data': 2, 'model': 3})"
    assert m.devices.tolist() == [[0, 1, 2], [3, 4, 5]]
    assert [m.axis_index("model", r) for r in range(6)] == [0, 1, 2] * 2
    assert [m.axis_index("data", r) for r in range(6)] == [0] * 3 + [1] * 3
    with pytest.raises(ValueError):
        m.axis_index("data", 6)
    for shape, names in (((2,), ("a", "b")), ((2, 2), ("a", "a")),
                         ((0, 2), ("a", "b"))):
        with pytest.raises(ValueError):
            port_mesh.Mesh(shape, names)


@pytest.mark.multidevice
def test_a_failing_rank_stops_the_world(tmp_path):
    """Rank 0 raises while rank 1 waits for it: the world is torn down
    and the error carries rank 0's traceback."""
    with pytest.raises(RuntimeError, match="rank 0 fails on purpose"):
        run_world(_rank_fails, 2, workdir=tmp_path, timeout=WORLD_TIMEOUT_S)


@pytest.mark.multidevice
def test_a_world_past_its_time_limit_is_killed(tmp_path):
    with pytest.raises(RuntimeError, match="not done after 2 s"):
        run_world(_rank_sleeps, 2, workdir=tmp_path, timeout=2)


def test_run_world_wants_an_empty_directory(tmp_path):
    (tmp_path / "stale").write_text("")
    with pytest.raises(ValueError, match="not empty"):
        run_world(_rank_sleeps, 2, workdir=tmp_path, timeout=2)
