"""Port parity of the dry run (``repro_torch.launch.{dryrun,perf}``).

The shape stand-ins and the skip policy equal the reference's leaf for
leaf at full width; the helpers and the capacity artifact are the
reference's byte for byte; and ``count_cell``, the count of the port's
own step, is held to the reference's HLO count (``lower_cell`` +
``roofline.hlo_parser.analyze`` on a 1 x 1 host mesh) at reduced
configs, one architecture of each block kind.

The FLOPs agree within 1 % (5 % where an SSD runs) once the gaps named in
``reference_attention_flops`` and ``test_count_against_the_reference_s_
hlo`` are taken out; the bytes lie between what every step must move and
the reference's HLO byte model, and the kernels' part of them equals the
reference's own formula (``repro/launch/perf.py``) exactly.
"""
import dataclasses
import inspect
import json
import re

import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.launch import dryrun as ref_dryrun
from repro_torch import configs
from repro_torch.convert import tree_leaves
from repro_torch.core.capacity import CloudCapacity
from repro_torch.launch import dryrun, perf
from repro_torch.models import transformer as tr

CELLS = [c.name for c in configs.SHAPE_CELLS]


def _dtype_name(dt) -> str:
    if isinstance(dt, torch.dtype):
        return str(dt).replace("torch.", "")
    return np.dtype(dt).name


def _flat(tree, prefix=()):
    """{key path: (shape, dtype name)} of a nested dict / tuple of
    leaves with ``shape`` and ``dtype``."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    if isinstance(tree, tuple) and not isinstance(tree, dryrun.ShapeDtype):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, prefix + (i,)))
        return out
    return {prefix: (tuple(tree.shape), _dtype_name(tree.dtype))}


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_param_shapes_are_the_reference_s(arch):
    own = _flat(dryrun.param_shapes(configs.get_config(arch)))
    ref = _flat(ref_dryrun.param_shapes(ref_configs.get_config(arch)))
    assert own == ref
    assert all(t.device.type == "meta" for t in
               tree_leaves(dryrun.param_shapes(configs.get_config(arch))))


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
@pytest.mark.parametrize("cell", CELLS)
def test_input_specs_are_the_reference_s(arch, cell):
    cfg = configs.get_config(arch)
    c = configs.cell_by_name(cell)
    own_ok = dryrun.cell_supported(cfg, c)
    assert own_ok == ref_dryrun.cell_supported(
        ref_configs.get_config(arch), ref_configs.cell_by_name(cell))
    if not own_ok[0]:
        assert "SKIP" in own_ok[1]
        return
    own, ref = dryrun.input_specs(arch, cell), ref_dryrun.input_specs(arch,
                                                                      cell)
    assert _flat(own) == _flat(ref)
    assert _flat(own)                # a tree with leaves


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_meta_init_has_the_cpu_init_s_shapes_and_draws_nothing(
        arch, monkeypatch):
    """``init_params`` on ``meta`` gives the shapes and dtypes of the CPU
    init; no normal or truncated-normal draw runs (the embedding's did,
    a vocab x d_model fp32 table on the CPU, before ``embed_init`` learnt
    to skip it)."""
    cfg = configs.reduced_config(arch)
    cpu = _flat(tr.init_params(cfg, torch.Generator().manual_seed(0), "cpu"))

    def refuse(*a, **k):
        raise AssertionError("drew numbers for a meta tensor")
    monkeypatch.setattr(torch, "randn", refuse)
    monkeypatch.setattr(torch.nn.init, "trunc_normal_", refuse)
    meta = _flat(tr.init_params(cfg, torch.Generator(), "meta"))
    assert meta == cpu


def test_skip_policy_is_the_reference_s():
    own = {(a, c.name): dryrun.cell_supported(configs.get_config(a), c)
           for a in configs.ARCH_IDS for c in configs.SHAPE_CELLS}
    ref = {(a, c.name): ref_dryrun.cell_supported(ref_configs.get_config(a),
                                                  c)
           for a in ref_configs.ARCH_IDS for c in ref_configs.SHAPE_CELLS}
    assert own == ref
    assert {a for (a, c), (ok, _) in own.items()
            if c == "long_500k" and ok} == {
        "mamba2-780m", "recurrentgemma-9b", "h2o-danube-1.8b"}


def test_sweep_gives_a_record_for_every_cell():
    records = dryrun.sweep()
    assert [(r["arch"], r["cell"]) for r in records] == [
        (a, c) for a in configs.ARCH_IDS for c in CELLS]
    for r in records:
        ok, reason = ref_dryrun.cell_supported(
            ref_configs.get_config(r["arch"]),
            ref_configs.cell_by_name(r["cell"]))
        assert r["status"] == ("OK" if ok else reason)
        if ok:
            assert r["mesh"] == "1" and r["n_chips"] == 1
            assert set(r["r_cloud_est"]) == {"v5e", "a100", "h100",
                                              "rtx4090"}
            assert r["flops_per_device"] > 0 and r["hlo_bytes_per_device"] > 0
            assert r["collective_bytes_per_device"] == 0.0


def _records(cells=(("qwen2-7b", "decode_32k"), ("mamba2-780m", "train_4k"),
                    ("olmoe-1b-7b", "prefill_32k"))):
    return [dryrun.analyze_cell(a, c) for a, c in cells]


def test_record_has_the_reference_s_fields():
    from repro.roofline import analysis as ref_analysis
    from repro_torch.roofline import analysis
    rec = _records()[0]
    # the fields of the reference's analyze_cell and roofline_from_compiled
    fields = {"arch", "cell", "mesh", "status", "compile_s",
              "bytes_per_device", "argument_bytes", "output_bytes",
              "flops_per_device"}
    src = inspect.getsource(ref_analysis.roofline_from_compiled)
    roof = set(re.findall(r'"(\w+)":', src))
    roof |= {"t_compute_s", "t_memory_s", "t_collective_s"}
    assert fields | roof <= set(rec)
    cfg = configs.get_config("qwen2-7b")
    assert rec["model_flops_per_device"] == analysis.model_flops(
        cfg, configs.cell_by_name("decode_32k"))
    assert rec["r_cloud_est"] == {
        k: round(v, 4) for k, v in analysis.r_cloud_estimates(
            rec["flops_per_device"], rec["hlo_bytes_per_device"]).items()}
    assert rec["flops_per_device"] == sum(
        c["flops"] for c in rec["components"].values())


def test_write_capacity_writes_the_reference_s_bytes(tmp_path):
    records = _records()
    for cell in (None, "decode_32k"):
        paths = []
        for name, fn in (("own", dryrun.write_capacity),
                         ("ref", ref_dryrun.write_capacity)):
            path = tmp_path / f"{name}-{cell}.json"
            assert fn(records, str(path), cell=cell) == 4
            paths.append(path.read_bytes())
        assert paths[0] == paths[1]
    cap = CloudCapacity.from_json(json.loads(paths[0]))
    assert cap["h100"].r_cloud == records[0]["r_cloud_est"]["h100"]


def test_batch_calibration_is_the_reference_s():
    spec = "1:0.016,2:0.0256,4:0.051,8:0.09"
    assert dryrun.parse_batch_times(spec) == ref_dryrun.parse_batch_times(
        spec)
    pairs = dryrun.parse_batch_times(spec)
    assert dryrun.fit_batch_calibration(pairs) == \
        ref_dryrun.fit_batch_calibration(pairs)
    with pytest.raises(ValueError):
        dryrun.parse_batch_times("1:0.5")


def test_main_writes_records_and_the_capacity(tmp_path, capsys):
    out, cap = tmp_path / "d.jsonl", tmp_path / "cap.json"
    assert dryrun.main(["--arch", "qwen2-7b", "--out", str(out),
                        "--capacity-out", str(cap)]) == 0
    lines = [json.loads(ln) for ln in out.read_text().splitlines()]
    assert [r["cell"] for r in lines] == CELLS
    assert lines[-1]["status"].startswith("SKIP")
    classes = CloudCapacity.from_json(json.loads(cap.read_text()))
    assert classes["h100"].r_cloud > 0
    assert "3 cells run, 0 failures" in capsys.readouterr().out


@pytest.mark.parametrize("flags", [["--single-pod-only"],
                                   ["--multi-pod-only"],
                                   ["--save-hlo", "hlo"]])
def test_main_refuses_what_the_port_has_not(flags, tmp_path):
    with pytest.raises(NotImplementedError, match="A10|HLO"):
        dryrun.main(flags + ["--out", str(tmp_path / "x.jsonl")])


@pytest.mark.parametrize("Sq,Skv,causal,window,kv_len", [
    (7, 7, True, 0, None), (9, 9, True, 3, None), (5, 8, False, 0, None),
    (6, 6, True, 0, 4), (11, 11, True, 4, 9), (1, 1, True, 0, None)])
def test_pair_counts_are_the_masks_counts(Sq, Skv, causal, window, kv_len):
    q = np.arange(Sq)[:, None]
    k = np.arange(Skv)[None, :]
    m = np.ones((Sq, Skv), dtype=bool) & (k < (Skv if kv_len is None
                                               else kv_len))
    if causal:
        m = m & (k <= q)
    if window:
        m = m & (k > q - window)
    assert dryrun.causal_pairs(Sq, Skv, causal=causal, window=window,
                               kv_len=kv_len) == int(m.sum())
    if kv_len is None:
        # the backward's tiles: every tile of 2 x 2 that a visible pair
        # touches, whole
        chunk = 2
        tiles = sum(min(chunk, Sq - q0) * min(chunk, Skv - k0)
                    for q0 in range(0, Sq, chunk)
                    for k0 in range(0, Skv, chunk)
                    if m[q0:q0 + chunk, k0:k0 + chunk].any())
        assert dryrun.bwd_tile_pairs(Sq, Skv, causal=causal, window=window,
                                     chunk=chunk) == tiles


def test_decode_attention_counts_the_rows_it_reads():
    cfg = configs.get_config("qwen2-7b")
    cell = configs.ShapeCell("d", 4160, 8, "decode")
    at = [dryrun.count_cell(cfg, cell, position=p)["components"]["attention"]
          for p in (4095, 4159)]
    per_row = 4.0 * 8 * cfg.num_heads * cfg.resolved_head_dim() * \
        cfg.num_layers
    assert at[1]["flops"] - at[0]["flops"] == 64 * per_row
    with pytest.raises(ValueError):
        dryrun.count_cell(cfg, cell, position=4160)


# --------------------------------------------------------------------------
# perf variants
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch,cell,variant,changes", [
    ("qwen2-7b", "decode_32k", "int8_kv", True),
    ("qwen2-7b", "train_4k", "int8_kv", False),
    ("mamba2-780m", "decode_32k", "int8_kv", False),
    ("qwen2-7b", "train_4k", "micro4", True),
    ("qwen2-7b", "prefill_32k", "micro4", False),
    ("qwen2-7b", "train_4k", "micro1", False),
    ("qwen2-7b", "train_4k", "micro4+microloss", True),
    ("qwen2-7b", "train_4k", "microloss", False),
    ("qwen2-7b", "train_4k", "micro4+bf16grads", True),
    ("qwen2-7b", "train_4k", "bf16grads", False),
    ("qwen2-7b", "train_4k", "micro4+microloss+bf16grads", False),
])
def test_each_perf_variant_changes_the_count_or_raises(arch, cell, variant,
                                                       changes):
    base = perf.perf_record(arch, cell, "baseline")
    if not changes:
        with pytest.raises(ValueError, match="changes nothing"):
            perf.perf_record(arch, cell, variant)
        return
    rec = perf.perf_record(arch, cell, variant)
    assert (rec["hlo_flops_per_device"], rec["hlo_bytes_per_device"]) != (
        base["hlo_flops_per_device"], base["hlo_bytes_per_device"])
    assert rec["variant"] == variant


def test_flash_vmem_is_the_port_s_accounting():
    base = perf.perf_record("qwen2-7b", "prefill_32k", "baseline")
    vmem = perf.perf_record("qwen2-7b", "prefill_32k", "flash_vmem")
    assert {k: v for k, v in vmem.items() if k not in ("variant",
                                                       "compile_s")} == \
        {k: v for k, v in base.items() if k not in ("variant", "compile_s")}
    assert "flash_vmem" in vmem["accounting"]
    assert vmem["kernel_io_addback_bytes"] > 0
    with pytest.raises(SystemExit, match="unknown variant"):
        perf.perf_record("qwen2-7b", "prefill_32k", "fp8")


def test_int8_cache_moves_more_bytes_in_the_port():
    """The port's int8 decode dequantizes the whole cache to fp32 and
    then to bf16 before the kernel reads it, so it moves more bytes than
    the bf16 cache, not half of them (the reference's claim for its TPU
    kernel, which dequantizes on chip)."""
    base = perf.perf_record("qwen2-7b", "decode_32k", "baseline")
    int8 = perf.perf_record("qwen2-7b", "decode_32k", "int8_kv")
    assert int8["hlo_bytes_per_device"] > base["hlo_bytes_per_device"]
    assert int8["hlo_flops_per_device"] == base["hlo_flops_per_device"]


# --------------------------------------------------------------------------
# The count against the reference's HLO count, at reduced configs
# --------------------------------------------------------------------------
#: one architecture of each block kind, and the two with a frontend (the
#: encoder-decoder's encoder and cross-attention; a vision prefix)
HLO_ARCHS = ("qwen2-7b", "recurrentgemma-9b", "mamba2-780m", "olmoe-1b-7b",
             "seamless-m4t-medium", "internvl2-1b")
HLO_CELLS = ("train_4k", "prefill_32k", "decode_32k")
#: the reference's train step runs 8 microbatches unless told otherwise
REF_MICRO = 8
#: the FLOPs' tolerance once the named gaps are out, and the SSD's wider
#: one (see the test)
FLOPS_RTOL = 0.01
SSD_FLOPS_RTOL = 0.05


@pytest.fixture(scope="module")
def hlo_counts():
    """(arch, cell) -> the reference's analyze() of its lowering, made
    once a cell and shared by the module's tests."""
    return {}


def _hlo(cache, arch, cell):
    if (arch, cell) not in cache:
        from repro.launch.mesh import make_host_mesh
        from repro.roofline.hlo_parser import analyze
        with pytest.MonkeyPatch.context() as mp:
            for var in ("REPRO_TRAIN_MICROBATCHES", "REPRO_MICROBATCH_MODE",
                        "REPRO_GRAD_REDUCE_DTYPE"):
                mp.delenv(var, raising=False)
            _, compiled = ref_dryrun.lower_cell(
                arch, cell, make_host_mesh(),
                cfg_override=ref_configs.reduced_config(arch))
        cache[(arch, cell)] = analyze(compiled.as_text())
    return cache[(arch, cell)]


def reference_attention_flops(cfg, cell) -> float:
    """Named gap 1: the reference's CPU lowering runs self-attention over
    every key.  Its flash scan (S >= 2048, S a multiple of its 1024
    chunk) and its einsum compute all S x S (query, key) pairs and mask
    them afterwards, where the port's flash kernel visits only the pairs
    the causal mask and the window allow (RecurrentGemma's window is 32
    keys in the reduced config).  A product over all pairs of a layer is
    2 B Hq S S hd; prefill runs two a layer, train two in the forward,
    two more in the group's recompute and five in the custom backward.
    At decode both read every row of a full cache: no gap."""
    B, S = cell.global_batch, cell.seq_len
    assert S >= 2048 and S % 1024 == 0
    grouped = cfg.num_groups() * cfg.block_pattern.count("attn")
    n = grouped + cfg.tail_pattern().count("attn")
    unit = 2.0 * B * cfg.num_heads * S * S * cfg.resolved_head_dim()
    if cell.kind == "prefill":
        return 2 * unit * n
    return 7 * unit * n + 2 * unit * grouped


def reference_kernel_io(cfg, cell) -> float:
    """The kernels' HBM inputs and outputs by the reference's formula
    (``repro/launch/perf.py``'s add-back under ``flash_vmem``), one
    device."""
    hd = cfg.resolved_head_dim()
    kinds = list(cfg.pattern_for_layers())
    n_attn = kinds.count("attn") + cfg.encoder_layers
    n_rec, n_ssd = kinds.count("rec"), kinds.count("ssd")
    passes = 3 if cell.kind == "train" else 1
    toks = cell.global_batch * cell.seq_len
    add = 0.0
    if cell.kind == "decode":
        kv_len = cfg.effective_kv_len(cell.seq_len)
        width = 1 if cfg.kv_cache_dtype == "int8" else 2
        add += (2 * n_attn * cell.global_batch * kv_len * cfg.num_kv_heads
                * hd * width)
    elif n_attn:
        add += (passes * n_attn * toks * (2 * cfg.num_heads
                                          + 2 * cfg.num_kv_heads) * hd * 2)
    if n_rec and cell.kind != "decode":
        add += passes * n_rec * toks * (cfg.rglru.lru_width or cfg.d_model) * 8
    if n_ssd and cell.kind != "decode":
        add += passes * n_ssd * toks * cfg.ssm.d_inner(cfg.d_model) * 12
    if cfg.moe is not None and cell.kind != "decode":
        add += (passes * cfg.num_layers * toks * cfg.moe.top_k
                * cfg.d_model * 2 * 2)
    return add


@pytest.mark.parametrize("arch", HLO_ARCHS)
@pytest.mark.parametrize("cell", HLO_CELLS)
def test_count_against_the_reference_s_hlo(arch, cell, hlo_counts):
    """FLOPs, with the named gaps out:
      1. self-attention over every key in the reference
         (``reference_attention_flops`` replaces the port's pairs of
         ``attention``; ``encoder_attention``, non-causal, has no masked
         pair);
      2. the RG-LRU recurrence is elementwise work, which the HLO count
         (products only) does not see: the port's ``rglru_scan`` FLOPs
         come out;
      3. the SSD (5 % here): the reference's backward takes one vjp a
         chunk, whose products that its gradients do not read XLA
         removes (about 1.3 forward SSD passes a layer at train), and
         its decode step's outer product is a broadcast multiply, not a
         product; the port's backward (the plain version's vjp over the
         sequence) and its decode kernel do that work;
      4. under 0.5 %: XLA removes a few products of the recomputed
         forward whose outputs the backward does not read; the encoder's
         short self-attention (8 frames here) is the reference's einsum,
         whose backward takes four products where the port's flash
         backward takes five.
    Bytes: at least the parameters once and the kernels' I/O, which
    equals the reference's own formula (an encoder apart); at most the reference's HLO
    byte model, which writes every intermediate of its CPU lowering
    (the attention scores of all S x S pairs among them), where the
    port counts activations at block boundaries only."""
    cfg = configs.reduced_config(arch)
    c = configs.cell_by_name(cell)
    n_micro = REF_MICRO if c.kind == "train" else 1
    count = dryrun.count_cell(cfg, c, n_micro=n_micro)
    comps = count["components"]
    hlo = _hlo(hlo_counts, arch, cell)

    flops = count["flops"] - comps.get("rglru_scan", {}).get("flops", 0.0)
    if c.kind != "decode" and "attention" in comps:
        flops += reference_attention_flops(cfg, c) - comps["attention"][
            "flops"]
    rtol = SSD_FLOPS_RTOL if cfg.ssm is not None and c.kind != "prefill" \
        else FLOPS_RTOL
    assert flops == pytest.approx(hlo["flops"], rel=rtol)
    # where no gap applies the count is the HLO's to the FLOP
    if c.kind == "decode" and cfg.ssm is None:
        assert flops == hlo["flops"]

    kernel_io = sum(comps.get(k, {}).get("bytes", 0.0)
                    for k in dryrun.KERNEL_IO)
    # the reference's formula charges an encoder's layers at the
    # decoder's tokens, at decode too, and leaves cross-attention out;
    # the port counts both apart, under encoder_attention
    enc_io = comps.get("encoder_attention", {}).get("bytes", 0.0)
    assert kernel_io - enc_io == pytest.approx(reference_kernel_io(
        dataclasses.replace(cfg, encoder_layers=0), c), rel=1e-12)
    params = sum(t.numel() * t.element_size() for t in
                 tree_leaves(dryrun.param_shapes(cfg)))
    assert params + kernel_io <= count["bytes"] <= hlo["bytes"]
    assert hlo["collective_bytes"] >= count["collective_bytes"] == 0.0
