"""Port parity: the port's own copies of the control plane decide and
encode exactly as the reference's modules do, and the port imports
nothing of the reference or of JAX."""
import ast
import dataclasses
import json
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest

from repro import configs as ref_configs
from repro.core import cost_model as ref_cost
from repro.core import planner as ref_planner
from repro.core import segmentation as ref_segmentation
from repro.core import telemetry as ref_telemetry
from repro.core import transport as ref_transport
from repro.models import moe as ref_moe
from repro_torch import configs
from repro_torch.core import (cost_model, planner, segmentation, telemetry,
                              transport)
from repro_torch.models import moe

ROOT = pathlib.Path(__file__).resolve().parents[1]
COPIED = ("cost_model", "telemetry", "capacity", "admission", "scheduler",
          "planner", "transport")
CONFIG_FILES = sorted(
    p.name for p in (ROOT / "src/repro/configs").glob("*.py"))
#: the scheduler's modules, copied whole with ``repro`` renamed
#: ``repro_torch`` wherever it stands as a word (``shard_sim`` also
#: imports the package itself, to put its root on a spawned child's path)
WORD_COPIED = ("core/sla.py", "serving/event_wheel.py",
               "serving/mobility.py", "serving/simulator.py",
               "serving/fleet_sim.py", "serving/shard_sim.py",
               "serving/__init__.py", "train/fault_tolerance.py",
               "train/__init__.py", "api.py", "data/pipeline.py",
               "data/__init__.py", "distributed/__init__.py",
               "roofline/hlo_parser.py", "roofline/__init__.py")


def _renamed(text):
    return re.sub(r"\brepro\b", "repro_torch", text)


def _cost(mod, t_lim):
    return mod.CostParams(r_cloud=40.0, n_total=50, n_step=5, t_lim=t_lim,
                          k_decode=1.0)


@pytest.mark.parametrize("name", COPIED)
def test_copies_differ_only_in_the_import_prefix(name):
    ref = (ROOT / "src/repro/core" / f"{name}.py").read_text()
    own = (ROOT / "src/repro_torch/core" / f"{name}.py").read_text()
    assert own == ref.replace("repro.", "repro_torch.")


@pytest.mark.parametrize("name", CONFIG_FILES)
def test_config_copies_differ_only_in_the_import_prefix(name):
    ref = (ROOT / "src/repro/configs" / name).read_text()
    own = (ROOT / "src/repro_torch/configs" / name).read_text()
    assert own == ref.replace("repro.", "repro_torch.")


@pytest.mark.parametrize("rel", WORD_COPIED)
def test_scheduler_copies_differ_only_in_the_package_name(rel):
    ref = (ROOT / "src/repro" / rel).read_text()
    own = (ROOT / "src/repro_torch" / rel).read_text()
    assert own == _renamed(ref)


def _without_function(text, name):
    """``text`` with the top-level function ``name`` cut out, and that
    function's source."""
    lines = text.splitlines(keepends=True)
    node = next(n for n in ast.parse(text).body
                if isinstance(n, ast.FunctionDef) and n.name == name)
    first = node.lineno - 1 - len(node.decorator_list)
    cut = "".join(lines[first:node.end_lineno])
    return "".join(lines[:first] + lines[node.end_lineno:]), cut


#: the two lines of the reference's replay module that tell its own
#: history (found by these fragments), and what the port's copy says there
REPLAY_HISTORY = {
    "validated every scheduling claim against a *modeled* simulator;":
    "The simulators validate every scheduling claim against a *model*;",
    "compile_seconds: float        # reported separately (the ":
    "    compile_seconds: float        # reported apart from gpu_seconds",
}


def test_replay_copy_differs_only_in_replay_through_engine():
    """Outside ``replay_through_engine`` the port's replay module is the
    reference's with the package renamed, plus the one import of the
    ``device`` argument's type and two reworded history notes; that
    function builds the torch engine."""
    ref, ref_fn = _without_function(
        (ROOT / "src/repro/serving/replay.py").read_text(),
        "replay_through_engine")
    own, own_fn = _without_function(
        (ROOT / "src/repro_torch/serving/replay.py").read_text(),
        "replay_through_engine")
    extra = "from repro_torch.compat import DeviceLike\n"
    assert own.count(extra) == 1
    lines = ref.splitlines(keepends=True)
    for fragment, port_line in REPLAY_HISTORY.items():
        hits = [i for i, ln in enumerate(lines) if fragment in ln]
        assert len(hits) == 1, fragment
        lines[hits[0]] = port_line + "\n"
    ref = "".join(lines)
    assert own.replace(extra, "") == _renamed(ref)
    assert "import jax" in ref_fn and "jax" not in own_fn
    assert "device: DeviceLike = None" in own_fn


def test_segmentation_copy_drops_only_the_unused_jax_imports():
    """The reference imports jax and jax.numpy and uses neither; the
    copy leaves those two lines out and changes nothing else."""
    ref = (ROOT / "src/repro/core/segmentation.py").read_text()
    own = (ROOT / "src/repro_torch/core/segmentation.py").read_text()
    unused = "import jax\nimport jax.numpy as jnp\n"
    assert unused in ref and "jax" not in ref.replace(unused, "")
    assert own == ref.replace(unused, "").replace("repro.", "repro_torch.")


@pytest.mark.parametrize("arch", ref_configs.ARCH_IDS)
def test_registry_and_reduced_configs_are_equal(arch):
    assert configs.ARCH_IDS == ref_configs.ARCH_IDS
    for get in ("get_config", "reduced_config"):
        assert (dataclasses.asdict(getattr(configs, get)(arch))
                == dataclasses.asdict(getattr(ref_configs, get)(arch)))


@pytest.mark.parametrize("arch", ref_configs.ARCH_IDS)
@pytest.mark.parametrize("batch,seq", [(1, 512), (4, 4096)])
def test_segmentation_results_are_equal(arch, batch, seq):
    cfg, ref_cfg = configs.get_config(arch), ref_configs.get_config(arch)
    for streaming in (False, True):
        for act_bytes in (1, 2):
            got = segmentation.layer_split_points(
                cfg, batch, seq, activation_bytes=act_bytes,
                streaming=streaming)
            want = ref_segmentation.layer_split_points(
                ref_cfg, batch, seq, activation_bytes=act_bytes,
                streaming=streaming)
            assert ([dataclasses.asdict(p) for p in got]
                    == [dataclasses.asdict(p) for p in want])
            assert ([dataclasses.asdict(c) for c in
                     segmentation.to_segment_costs(got)]
                    == [dataclasses.asdict(c) for c in
                        ref_segmentation.to_segment_costs(want)])
    assert (segmentation.boundary_state_bytes(cfg, batch, seq)
            == ref_segmentation.boundary_state_bytes(ref_cfg, batch, seq))
    for nb in (1, 2, 4):
        assert (segmentation.hidden_payload_bytes(cfg, batch, seq, nb)
                == ref_segmentation.hidden_payload_bytes(ref_cfg, batch, seq,
                                                         nb))
    for n_total, n_step in ((50, 5), (50, 1), (38, 3)):
        assert (segmentation.executable_count(n_total, n_step)
                == ref_segmentation.executable_count(n_total, n_step))


def test_shard_context_is_the_reference_s():
    fields = [(f.name, f.default) for f in dataclasses.fields(moe.ShardCtx)]
    assert fields == [(f.name, f.default)
                      for f in dataclasses.fields(ref_moe.ShardCtx)]
    assert (dataclasses.asdict(moe.LOCAL_CTX)
            == dataclasses.asdict(ref_moe.LOCAL_CTX))
    assert moe.LOCAL_CTX.model_size == ref_moe.LOCAL_CTX.model_size == 1


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("t_lim", [1.5, 3.0, 8.0])
def test_planner_decides_identically(seed, t_lim):
    ref_fleet = ref_telemetry.generate_fleet(64, 2.25, 0.8, seed=seed)
    fleet = telemetry.generate_fleet(64, 2.25, 0.8, seed=seed)
    assert [dataclasses.asdict(d) for d in fleet] == [
        dataclasses.asdict(d) for d in ref_fleet]
    ref_cp, cp = _cost(ref_cost, t_lim), _cost(cost_model, t_lim)
    ref_pl = ref_planner.Planner(ref_cp, policy="variable",
                                 solve_c_batch=ref_cp.c_batch)
    pl = planner.Planner(cp, policy="variable", solve_c_batch=cp.c_batch)
    assert pl.config_json() == ref_pl.config_json()
    for ref_d, d in zip(ref_fleet, fleet):
        assert (pl.plan_profile(d).n_final
                == ref_pl.plan_profile(ref_d).n_final)
        got = pl.plan(planner.PlanRequest(device=d)).to_json()
        want = ref_pl.plan(ref_planner.PlanRequest(device=ref_d)).to_json()
        assert json.dumps(got, sort_keys=True) == json.dumps(
            want, sort_keys=True)


def _boundary(seed, with_context=True):
    rng = np.random.default_rng(seed)
    latent = rng.standard_normal((4, 8, 8)).astype(np.float32) * 2
    context = (rng.standard_normal((2, 16, 64)).astype(np.float32)
               if with_context else None)
    return latent, context


@pytest.mark.parametrize("fmt", sorted(ref_transport.WIRE_FORMATS))
@pytest.mark.parametrize("with_context", [True, False])
def test_wire_payloads_are_byte_equal(fmt, with_context):
    assert sorted(transport.WIRE_FORMATS) == sorted(
        ref_transport.WIRE_FORMATS)
    latent, context = _boundary(5, with_context)
    got = transport.pack_boundary_wire(latent, context, fmt)
    want = ref_transport.pack_boundary_wire(latent, context, fmt)
    assert got == want
    lat, ctx = transport.unpack_boundary(got)
    ref_lat, ref_ctx = ref_transport.unpack_boundary(want)
    np.testing.assert_array_equal(lat, ref_lat)
    assert (ctx is None) == (ref_ctx is None) == (not with_context)
    if with_context:
        np.testing.assert_array_equal(ctx, ref_ctx)


@pytest.mark.parametrize("mode", ["paper", "int8"])
def test_legacy_payloads_are_byte_equal(mode):
    latent, context = _boundary(6)
    assert (transport.pack_boundary(latent, context, mode=mode)
            == ref_transport.pack_boundary(latent, context, mode=mode))


def test_sizes_and_times_are_equal():
    shapes = {"latent": (4, 64, 64), "context": (2, 77, 768)}
    for fmt in ("fp32", "fp16", "int8", "topk"):
        assert (transport.wire_nbytes(shapes, fmt)
                == ref_transport.wire_nbytes(shapes, fmt))
    with pytest.raises(ValueError):
        transport.wire_nbytes(shapes, "int8_zlib")
    for link, ref_link in ((transport.WAN_LINK, ref_transport.WAN_LINK),
                           (transport.LOCAL_LINK, ref_transport.LOCAL_LINK),
                           (transport.MOBILE_LINK,
                            ref_transport.MOBILE_LINK)):
        assert dataclasses.asdict(link) == dataclasses.asdict(ref_link)
        for n in (0, 1, 1448, 16_569, 134_973, 10_000_000):
            assert (transport.transmission_time(n, link)
                    == ref_transport.transmission_time(n, ref_link))


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0], node.lineno


def test_port_imports_neither_jax_nor_the_reference():
    files = sorted((ROOT / "src/repro_torch").rglob("*.py"))
    # the scripts run on the card, chip_smoke.py's helper quant_ab.py too
    files += [ROOT / n for n in ("chip_smoke.py", "decode_ab.py",
                                 "quant_ab.py")]
    names = {p.relative_to(ROOT).as_posix() for p in files}
    for module in ("kernels/flash_attention", "kernels/rglru_scan",
                   "kernels/ssd_scan", "models/ssd",
                   "models/attention", "models/rglru", "models/moe",
                   "models/transformer", "core/segmentation",
                   "configs/recurrentgemma_9b", "serving/fleet_sim",
                   "serving/replay", "api", "models/regnet",
                   "train/optimizer", "train/train_loop", "train/checkpoint",
                   "distributed/compression", "data/pipeline",
                   "roofline/analysis", "launch/dryrun", "launch/perf",
                   "launch/mesh", "distributed/collectives",
                   "distributed/pipeline", "distributed/world"):
        assert f"src/repro_torch/{module}.py" in names
    assert len(files) > 40
    # ml_dtypes too: the card's machine does not have it (the checkpoint
    # stores bf16 as its uint16 view without it)
    banned = {"jax", "jaxlib", "repro", "flax", "optax", "ml_dtypes"}
    bad = [f"{p.relative_to(ROOT)}:{line} imports {root}"
           for p in files for root, line in _imported_roots(p)
           if root in banned]
    assert not bad, bad


def test_api_facade_exports_the_reference_s_names_without_jax():
    """``import repro_torch.api`` loads neither jax nor the reference, and
    the facade exports the reference's names."""
    code = ("import sys, repro_torch.api as api; "
            "print(sorted(api.__all__)); "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'repro')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True,
                         env={**os.environ,
                              "PYTHONPATH": str(ROOT / "src")}
                         ).stdout.splitlines()
    import repro.api as ref_api
    assert out == [str(sorted(ref_api.__all__)), "[]"]
