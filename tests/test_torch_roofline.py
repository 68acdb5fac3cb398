"""Port parity of the roofline package: the three copied modules pinned to
the reference's text, and their functions equal to the reference's on
the same inputs.  The one deliberate difference: the port's module
target (``PEAK_FLOPS``, ``HBM_BW``, ``ICI_BW``) is the H100 of
``HW_SPECS["h100"]``, the card it runs on, where the reference's is a
TPU v5e; ``HW_SPECS`` itself is the reference's, value for value."""
import dataclasses
import gzip
import json
import pathlib
import re

import pytest

from repro import configs as ref_configs
from repro.roofline import analysis as ref_analysis
from repro.roofline import hlo_parser as ref_hlo
from repro.roofline import reanalyze as ref_reanalyze
from repro_torch import configs
from repro_torch.roofline import analysis, hlo_parser, reanalyze

ROOT = pathlib.Path(__file__).resolve().parents[1]

#: the port's analysis.py is the reference's with these lines replaced:
#: the module docstring's formulas, the module target, the comment over
#: HW_SPECS and its v5e entry (which keeps the TPU's numbers)
ANALYSIS_TARGET = {
    "    compute    = HLO_FLOPs  / (chips * 197e12  bf16 FLOP/s)      [v5e]":
    "    compute    = HLO_FLOPs  / (chips * 989e12  bf16 FLOP/s)      [H100]",
    "    memory     = HLO_bytes  / (chips * 819e9   HBM B/s)":
    "    memory     = HLO_bytes  / (chips * 3.35e12 HBM B/s)",
    "    collective = coll_bytes / (chips * 50e9    ICI B/s per link)":
    "    collective = coll_bytes / (chips * 450e9   NVLink B/s per link)",
    "PEAK_FLOPS = 197e12          # TPU v5e bf16 per chip":
    "PEAK_FLOPS = 989e12          # NVIDIA H100 dense bf16 per chip",
    "HBM_BW = 819e9               # bytes/s per chip":
    "HBM_BW = 3.35e12             # bytes/s per chip",
    "ICI_BW = 50e9                # bytes/s per link":
    "ICI_BW = 450e9               # NVLink bytes/s per link",
    "#: The hardware classes the calibration loop knows about.  v5e carries":
    "#: The hardware classes the calibration loop knows about.  h100 carries",
    "#: the module-level constants (the dry-run mesh target); the GPU entries":
    "#: the module-level constants (the card the port runs on); the other",
    "#: model the generations a mixed production pool would hold.":
    "#: entries model the generations a mixed production pool would hold.",
    '    "v5e": HardwareSpec("v5e", PEAK_FLOPS, HBM_BW, ICI_BW),':
    '    "v5e": HardwareSpec("v5e", 197e12, 819e9, 50e9),',
}


def _read(rel):
    return (ROOT / rel).read_text()


def _renamed(text):
    """The reference's text with ``repro`` renamed wherever it stands as
    a word, as every verbatim copy of the port is."""
    return re.sub(r"\brepro\b", "repro_torch", text)


def test_analysis_copy_differs_only_in_its_target():
    lines = _renamed(_read("src/repro/roofline/analysis.py")).splitlines(
        keepends=True)
    for ref_line, port_line in ANALYSIS_TARGET.items():
        hits = [i for i, ln in enumerate(lines) if ln.rstrip("\n") == ref_line]
        assert len(hits) == 1, ref_line
        lines[hits[0]] = port_line + "\n"
    assert _read("src/repro_torch/roofline/analysis.py") == "".join(lines)


@pytest.mark.parametrize("name", ["hlo_parser.py", "reanalyze.py",
                                  "__init__.py"])
def test_copies_differ_only_in_the_package_name(name):
    assert (_read(f"src/repro_torch/roofline/{name}")
            == _renamed(_read(f"src/repro/roofline/{name}")))


def test_the_port_s_target_is_the_h100_entry():
    h100 = analysis.HW_SPECS["h100"]
    assert (analysis.PEAK_FLOPS, analysis.HBM_BW, analysis.ICI_BW) == (
        h100.peak_flops, h100.hbm_bw, h100.ici_bw) == (989e12, 3.35e12, 450e9)
    # the port's text names no TPU rate as its own
    text = _read("src/repro_torch/roofline/analysis.py")
    assert "TPU" not in text and "197e12" not in text.split("HW_SPECS")[0]


def test_hardware_table_is_the_reference_s():
    assert list(analysis.HW_SPECS) == list(ref_analysis.HW_SPECS)
    for name, spec in analysis.HW_SPECS.items():
        assert dataclasses.astuple(spec) == dataclasses.astuple(
            ref_analysis.HW_SPECS[name])


STEPS = [(1e12, 1e9, 0.0), (3.1e15, 2.2e12, 4e9), (2.2e9, 8.1e9, 0.0),
         (0.0, 0.0, 0.0), (7.7e13, 1.0, 5e11)]


@pytest.mark.parametrize("flops,bytes_,coll", STEPS)
def test_r_cloud_estimates_equal_the_reference_s(flops, bytes_, coll):
    assert (analysis.r_cloud_estimates(flops, bytes_, coll)
            == ref_analysis.r_cloud_estimates(flops, bytes_, coll))
    for name, spec in analysis.HW_SPECS.items():
        assert (spec.step_time_s(flops, bytes_, coll)
                == ref_analysis.HW_SPECS[name].step_time_s(flops, bytes_,
                                                           coll))


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_model_flops_equal_the_reference_s(arch):
    for cell in configs.SHAPE_CELLS:
        assert analysis.model_flops(configs.get_config(arch), cell) == \
            ref_analysis.model_flops(ref_configs.get_config(arch),
                                     ref_configs.cell_by_name(cell.name))


@pytest.mark.parametrize("terms", [
    {"t_compute_s": 1.0, "t_memory_s": 2.0, "t_collective_s": 0.5},
    {"t_compute_s": 3.0, "t_memory_s": 2.0, "t_collective_s": 0.0},
    {"t_compute_s": 0.0, "t_memory_s": 0.0, "t_collective_s": 1e-9}])
def test_dominant_term_equals_the_reference_s(terms):
    assert analysis.dominant_term(terms) == ref_analysis.dominant_term(terms)


def test_roofline_terms_are_the_h100_arithmetic():
    terms = analysis.roofline_terms(989e12, 3.35e12, 450e9)  # 1 s each
    assert terms == {"t_compute_s": 1.0, "t_memory_s": 1.0,
                     "t_collective_s": 1.0}
    f, b, c = 1.154e13, 4.727e12, 3.2e9
    assert analysis.roofline_terms(f, b, c) == {
        "t_compute_s": f / 989e12, "t_memory_s": b / 3.35e12,
        "t_collective_s": c / 450e9}
    # and the reference's own terms are its v5e's
    assert ref_analysis.roofline_terms(197e12, 819e9, 50e9) == {
        "t_compute_s": 1.0, "t_memory_s": 1.0, "t_collective_s": 1.0}


@pytest.fixture(scope="module")
def lowered():
    """One reduced cell lowered through the reference on the CPU: OLMoE's
    prefill, whose HLO holds collectives even on a 1 x 1 mesh."""
    from repro.launch.dryrun import lower_cell
    from repro.launch.mesh import make_host_mesh
    lo, co = lower_cell("olmoe-1b-7b", "prefill_32k", make_host_mesh(),
                        cfg_override=ref_configs.reduced_config(
                            "olmoe-1b-7b"))
    return lo, co


SYNTHETIC_HLO = """\
HloModule m
ENTRY %main (p0: f32[128,1024]) -> f32[128,1024] {
  %p0 = f32[128,1024]{1,0} parameter(0)
  %ar = f32[128,1024]{1,0} all-reduce(%p0), replica_groups={}
  %ag = bf16[4,2048]{1,0} all-gather(%p0), dimensions={0}
  %cp = bf16[2,4096]{1,0} collective-permute-start(%p0)
  %rs = f32[64]{0} reduce-scatter(%p0), dimensions={0}
  ROOT %d = f32[128,1024]{1,0} dot(%ar, %p0), lhs_contracting_dims={1}
}
"""


@pytest.mark.parametrize("source", ["lowered", "synthetic"])
def test_hlo_analysis_equals_the_reference_s(source, request):
    if source == "lowered":
        text = request.getfixturevalue("lowered")[1].as_text()
    else:
        text = SYNTHETIC_HLO
    assert hlo_parser.analyze(text) == ref_hlo.analyze(text)
    scope = ("flash_attention", "decode_attention", "moe_dispatch")
    assert (hlo_parser.analyze(text, exclude_scope=scope)
            == ref_hlo.analyze(text, exclude_scope=scope))
    assert analysis.collective_bytes(text) == ref_analysis.collective_bytes(
        text)
    assert (hlo_parser.parse_computations(text)
            == ref_hlo.parse_computations(text))
    if source == "synthetic":
        assert analysis.collective_bytes(text)["all-reduce"] == 128 * 1024 * 4


def test_roofline_from_compiled_differs_only_in_the_target(lowered):
    """The copied ``roofline_from_compiled`` on the reference's lowering:
    the counts and the per-class rates are the reference's; the terms
    are the H100's."""
    lo, co = lowered
    args = ("olmoe-1b-7b", "prefill_32k", lo, co, 1)
    own = analysis.roofline_from_compiled(*args)
    ref = ref_analysis.roofline_from_compiled(*args)
    assert own.keys() == ref.keys()
    same = ("hlo_flops_per_device", "hlo_bytes_per_device",
            "collective_bytes_per_device", "collectives",
            "raw_flops_per_device", "raw_bytes_per_device", "r_cloud_est",
            "model_flops_per_device", "useful_flops_ratio")
    for k in same:
        assert own[k] == ref[k], k
    f, b = own["hlo_flops_per_device"], own["hlo_bytes_per_device"]
    assert own["t_compute_s"] == round(f / 989e12, 6)
    assert own["t_memory_s"] == round(b / 3.35e12, 6)


def test_reanalyze_differs_only_in_the_target(lowered, tmp_path,
                                              monkeypatch):
    """Both modules' ``main`` over one cached HLO file and one SKIP
    record: the same records, but for the terms, which follow each
    module's target."""
    hlo_dir = tmp_path / "hlo"
    hlo_dir.mkdir()
    with gzip.open(hlo_dir / "olmoe-1b-7b__prefill_32k__16x16.hlo.gz",
                   "wt") as f:
        f.write(lowered[1].as_text())
    base = tmp_path / "base.jsonl"
    base.write_text(json.dumps({"arch": "qwen2-7b", "cell": "long_500k",
                                "status": "SKIP(full-attn): x"}) + "\n")
    out = {}
    for name, mod in (("ref", ref_reanalyze), ("own", reanalyze)):
        path = tmp_path / f"{name}.jsonl"
        monkeypatch.setattr("sys.argv", [
            "reanalyze", "--hlo-dir", str(hlo_dir), "--merge", str(base),
            "--out", str(path)])
        mod.main()
        out[name] = [json.loads(ln) for ln in path.read_text().splitlines()]
    assert len(out["own"]) == len(out["ref"]) == 2
    terms = ("t_compute_s", "t_memory_s", "t_collective_s", "dominant",
             "roofline_fraction")
    for own, ref in zip(out["own"], out["ref"]):
        assert ({k: v for k, v in own.items() if k not in terms}
                == {k: v for k, v in ref.items() if k not in terms})
    own, ref = out["own"][0], out["ref"][0]
    assert own["t_memory_s"] == round(own["hlo_bytes_per_device"] / 3.35e12,
                                      6)
    assert ref["t_memory_s"] == round(ref["hlo_bytes_per_device"] / 819e9, 6)


def test_no_tpu_rate_is_the_port_s_target_in_its_text():
    """The port's roofline modules name no TPU as their target: v5e's
    numbers appear only in its HW_SPECS entry."""
    for rel in ("roofline/analysis.py", "roofline/reanalyze.py",
                "launch/dryrun.py", "launch/perf.py"):
        text = _read(f"src/repro_torch/{rel}")
        hits = [ln for ln in text.splitlines()
                if re.search(r"\b(197e12|819e9|50e9|v5e)\b", ln)]
        allowed = ['    "v5e": HardwareSpec("v5e", 197e12, 819e9, 50e9),']
        assert all(h in allowed for h in hits), (rel, hits)
