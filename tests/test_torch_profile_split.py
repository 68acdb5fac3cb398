"""The layer-split profiler (``repro_torch.serving.profile_split``): its
trace summary on hand-made events, and one CPU run on a reduced config."""
import numpy as np
import pytest
import torch

from repro_torch.configs import reduced_config
from repro_torch.core.transport import WAN_LINK
from repro_torch.models import transformer as tr
from repro_torch.serving import profile_split as ps
from repro_torch.serving.engine import LayerSplitDevice, LayerSplitEngine

torch.set_num_threads(1)


@pytest.mark.parametrize("name,cls", [
    ("void (anonymous namespace)::flash_attention_kernel<__nv_bfloat16, 16, "
     "16>(...)", "flash_attention"),
    ("void (anonymous namespace)::tc::flash_attention_kernel<256>(...)",
     "flash_attention"),
    ("void (anonymous namespace)::cc::flash_attention_kernel<16, 16>(...)",
     "flash_attention"),
    ("(anonymous namespace)::rglru_scan_kernel(float const*, ...)",
     "rglru_scan"),
    ("void (anonymous namespace)::decode_split_kernel<__nv_bfloat16, 32>"
     "(...)", "decode_attention"),
    ("void (anonymous namespace)::decode_merge_kernel<__nv_bfloat16>(...)",
     "decode_attention"),
    ("(anonymous namespace)::ssd_scan_kernel(float const*, ...)",
     "ssd_scan"),
    ("(anonymous namespace)::ssd_step_kernel(float const*, ...)",
     "ssd_scan"),
    ("(anonymous namespace)::ssd_chunk_state_kernel(float const*, ...)",
     "ssd_scan"),
    ("(anonymous namespace)::ssd_state_pass_kernel(float*, ...)",
     "ssd_scan"),
    ("(anonymous namespace)::ssd_chunk_out_kernel(float const*, ...)",
     "ssd_scan"),
    ("void (anonymous namespace)::tc::decode_split_kernel<128>(...)",
     "decode_attention"),
    ("nvjet_tst_128x256_64x4_1x2_h_bz_coopA_TNT", "gemm"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x256x64", "gemm"),
    ("void at::native::vectorized_elementwise_kernel<4, ...>", "other"),
])
def test_kernel_class(name, cls):
    assert ps.kernel_class(name) == cls


def test_summary_sums_classes_and_takes_the_union_for_idle():
    ev = [
        {"ph": "X", "cat": "kernel", "name": "flash_attention_kernel<f>",
         "ts": 0.0, "dur": 400.0},
        {"ph": "X", "cat": "kernel", "name": "nvjet_gemm", "ts": 300.0,
         "dur": 200.0},                       # overlaps the first by 100 us
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 700.0,
         "dur": 100.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0.0,
         "dur": 900.0},                       # host side: not device time
    ]
    s = ps.summarize_trace(ev, wall_s=1e-3)
    assert s["by_class"] == pytest.approx(
        {"flash_attention": 4e-4, "gemm": 2e-4, "copy": 1e-4})
    assert s["device_seconds"] == pytest.approx(7e-4)
    assert s["busy_seconds"] == pytest.approx(6e-4)
    assert s["idle_share"] == pytest.approx(0.4)
    assert s["kernels_in_trace"] == {"flash_attention": 1, "gemm": 1,
                                     "copy": 1}
    assert s["top"][0]["name"].startswith("flash_attention_kernel")


def test_no_device_events_means_not_measured():
    s = ps.summarize_trace([{"ph": "X", "cat": "cpu_op", "name": "aten::mm",
                             "ts": 0.0, "dur": 5.0}], wall_s=1.0)
    assert s["device_seconds"] is None and s["idle_share"] is None


def test_busy_beyond_the_wall_raises():
    ev = [{"ph": "X", "cat": "kernel", "name": "k", "ts": 0.0,
           "dur": 2000.0}]
    with pytest.raises(RuntimeError, match="busy"):
        ps.summarize_trace(ev, wall_s=1e-3)


def test_runs_on_the_cpu_when_asked():
    cfg = reduced_config("recurrentgemma-9b")
    params = tr.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    cloud = LayerSplitEngine(params, cfg, link=WAN_LINK, device="cpu")
    device = LayerSplitDevice(params, cfg, device="cpu")
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, 16)).astype(np.int32)
    g = cfg.num_groups() // 2
    with torch.inference_mode():
        with pytest.raises(RuntimeError, match="warmed"):
            ps.profile_round(cloud, device, tokens, g)
        out = ps.profile_round(cloud, device, tokens, g)
    assert (out["batch"], out["seq"], out["group"]) == (1, 16, g)
    assert out["side_seconds"]["device"] > 0
    # CPU tensors never reach the kernels
    assert out["wrapper_launches"] == {"flash_attention": 0,
                                       "decode_attention": 0,
                                       "rglru_scan": 0, "ssd_scan": 0}
    assert out["device_seconds"] is None


def test_profile_decode_runs_on_the_cpu_when_asked():
    """Two decode steps through a padded prefill cache: the cache is
    written in place at the two positions, nothing reaches a kernel."""
    cfg = reduced_config("qwen2-7b")
    params = tr.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 18)).astype(np.int32))
    with torch.inference_mode():
        _, cache = tr.prefill(params, {"tokens": tokens[:, :16]}, cfg,
                              pad_to=18)
        out = ps.profile_decode(params, cfg, tokens, cache, 16, 2)
    assert (out["batch"], out["start"], out["steps"]) == (2, 16, 2)
    assert out["wall_seconds"] > 0 and out["device_seconds"] is None
    assert set(out["wrapper_launches"].values()) == {0}
    assert cache["groups"]["b0"]["k"][:, :, 16:].abs().sum() > 0


# the CUDA kernels one SSD call enqueues: the step kernel alone for a
# decode step (S = 1), or the three phases
_SSD_KERNELS = {True: ["ssd_step_kernel"],
                False: ["ssd_chunk_state_kernel", "ssd_state_pass_kernel",
                        "ssd_chunk_out_kernel"]}


def _stub_ssd_kernels(monkeypatch, wrong_count=False):
    """The SSD wrapper counted and traced as on the card: each call on a
    CPU tensor adds to ``launch_count`` and ``kernel_count`` as a CUDA call
    does, and the trace holds the kernels it would have enqueued."""
    from repro_torch.kernels import ssd_scan as ssd
    events = []
    plain = ssd.ssd_scan

    def counted(x, dt, A, Bm, Cm, *, chunk_size, init_state=None):
        out = plain(x, dt, A, Bm, Cm, chunk_size=chunk_size,
                    init_state=init_state)
        step = x.shape[1] == 1
        ssd.launch_count += 1
        ssd.kernel_count += 1 if step and not wrong_count else 3
        for name in _SSD_KERNELS[step]:
            events.append({"ph": "X", "cat": "kernel", "ts": float(
                len(events)), "dur": 0.5, "name": f"(anonymous namespace)::"
                f"{name}(float const*, ...)"})
        return out
    monkeypatch.setattr(ssd, "ssd_scan", counted)
    monkeypatch.setattr(ps, "_trace_events", lambda prof: list(events))
    return events


@pytest.mark.parametrize("prompt", [32, 64])
def test_ssd_round_counts_the_kernels_each_call_enqueued(monkeypatch,
                                                         prompt):
    """A Mamba-2 round enqueues the three SSD phases a call, whether its
    prompt is one chunk (32 tokens, the reduced config's chunk) or two.
    The trace check takes the count from the wrapper."""
    cfg = reduced_config("mamba2-780m")
    params = tr.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    cloud = LayerSplitEngine(params, cfg, link=WAN_LINK, device="cpu")
    device = LayerSplitDevice(params, cfg, device="cpu")
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, prompt)).astype(np.int32)
    g = cfg.num_groups() // 2
    with torch.inference_mode():
        cloud.process({"tokens": tokens}, g)        # warm both engines
        device.complete(cloud.process({"tokens": tokens}, g)[0], g)
        events = _stub_ssd_kernels(monkeypatch)
        out = ps.profile_round(cloud, device, tokens, g)
    calls = out["wrapper_launches"]["ssd_scan"]
    assert calls == cfg.num_layers
    assert out["wrapper_kernels"]["ssd_scan"] == 3 * calls
    assert out["kernels_in_trace"] == {"ssd_scan": len(events)}
    assert len(events) == 3 * calls


def test_ssd_decode_steps_count_one_kernel_a_call(monkeypatch):
    """Decode steps of Mamba-2 call the SSD wrapper with one token: one
    kernel a call in the trace.  Had the wrapper counted three, the check
    would raise."""
    cfg = reduced_config("mamba2-780m")
    params = tr.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, 36)).astype(np.int32))
    with torch.inference_mode():
        _, cache = tr.prefill(params, {"tokens": tokens[:, :32]}, cfg,
                              pad_to=36)
        _stub_ssd_kernels(monkeypatch)
        out = ps.profile_decode(params, cfg, tokens, cache, 32, 2)
        assert out["wrapper_launches"]["ssd_scan"] == 2 * cfg.num_layers
        assert out["kernels_in_trace"] == {"ssd_scan": 2 * cfg.num_layers}
        _stub_ssd_kernels(monkeypatch, wrong_count=True)
        with pytest.raises(RuntimeError, match="enqueued"):
            ps.profile_decode(params, cfg, tokens, cache, 34, 2)


def test_time_by_scope_takes_the_innermost_scope():
    """A device event counts for the innermost ``SCOPES`` span (same host
    thread) that holds its launch, matched by correlation id; launches
    outside every span, or on another thread, count for none."""
    def span(name, ts, dur, tid=1):
        return {"ph": "X", "cat": "user_annotation", "name": name,
                "ts": ts, "dur": dur, "tid": tid}

    def launch(corr, ts, tid=1, cat="cuda_runtime"):
        return {"ph": "X", "cat": cat, "name": "cudaLaunchKernel", "ts": ts,
                "dur": 1.0, "tid": tid, "args": {"correlation": corr}}

    def kernel(corr, dur, cat="kernel"):
        return {"ph": "X", "cat": cat, "name": f"k{corr}", "ts": 5000.0,
                "dur": dur, "args": {"correlation": corr}}
    ev = [span("moe_dispatch", 0.0, 1000.0), span("moe_experts", 200.0, 300.0),
          span("other_scope", 600.0, 100.0),
          launch(1, 100.0), launch(2, 250.0, cat="cuda_driver"),
          launch(3, 2000.0), launch(4, 300.0, tid=2), launch(5, 650.0),
          kernel(1, 10.0), kernel(2, 20.0), kernel(3, 30.0),
          kernel(4, 40.0), kernel(5, 50.0, cat="gpu_memcpy")]
    s = ps.summarize_trace(ev, wall_s=1.0)
    assert s["by_scope"] == pytest.approx({"moe_dispatch": 6e-5,
                                           "moe_experts": 2e-5})
    assert ps.SCOPES == ("moe_dispatch", "moe_experts")


def test_summary_leaves_out_the_warmup_kernels():
    """Kernels launched inside the ``WARMUP_SCOPE`` span (``traced``'s
    first kernels) count in no class, scope, busy time or top list, only
    in ``warmup_kernels_in_trace``; a launch of the same thread outside
    it, or one of another thread inside its time, counts as usual."""
    def event(cat, name, ts, dur, corr=None, tid=1):
        e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
             "tid": tid}
        if corr is not None:
            e["args"] = {"correlation": corr}
        return e
    ev = [event("user_annotation", ps.WARMUP_SCOPE, 0.0, 100.0)]
    for i in range(3):
        ev += [event("cuda_runtime", "cudaLaunchKernel", 10.0 + i, 1.0, i),
               event("kernel", "warm", 20.0 + i, 1.0, i)]
    ev += [event("cuda_runtime", "cudaLaunchKernel", 50.0, 1.0, 7, tid=2),
           event("kernel", "gemm_other_thread", 300.0, 5.0, 7),
           event("cuda_runtime", "cudaLaunchKernel", 200.0, 1.0, 8),
           event("kernel", "ampere_gemm", 400.0, 10.0, 8)]
    s = ps.summarize_trace(ev, wall_s=1e-3)
    assert s["warmup_kernels_in_trace"] == 3
    assert s["kernels_in_trace"] == {"gemm": 2}
    assert s["device_seconds"] == pytest.approx(15e-6)
    assert s["busy_seconds"] == pytest.approx(15e-6)
    assert {t["name"] for t in s["top"]} == {"gemm_other_thread",
                                              "ampere_gemm"}
    only_warm = ps.summarize_trace(ev[:7], wall_s=1e-3)
    assert only_warm["device_seconds"] is None


def test_traced_on_the_cpu_launches_no_warmup():
    """On the CPU ``traced`` profiles the host alone: no warmup span, no
    device events, and a summary without device fields."""
    with ps.traced(torch.device("cpu")) as prof:
        torch.ones(4).sum()
    events = ps._trace_events(prof)
    assert not [e for e in events if e.get("name") == ps.WARMUP_SCOPE]
    s = ps.summarize_trace(events, wall_s=1.0)
    assert s["device_seconds"] is None and s["warmup_kernels_in_trace"] is None


def test_moe_round_on_the_cpu_records_its_scopes(monkeypatch):
    """Reduced OLMoE through the engines under the profiler: the trace
    holds one ``moe_dispatch`` and one ``moe_experts`` span a layer run
    (what ``time_by_scope`` attributes device time to on a GPU); on the
    CPU there is no device time to attribute."""
    cfg = reduced_config("olmoe-1b-7b")
    params = tr.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    cloud = LayerSplitEngine(params, cfg, link=WAN_LINK, device="cpu")
    device = LayerSplitDevice(params, cfg, device="cpu")
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 16)).astype(np.int32)
    seen = []
    real = ps._trace_events

    def keep(prof):
        seen.extend(real(prof))
        return seen
    monkeypatch.setattr(ps, "_trace_events", keep)
    with torch.inference_mode():
        device.complete(cloud.process({"tokens": tokens}, 1)[0], 1)
        out = ps.profile_round(cloud, device, tokens, 1)
    names = [e["name"] for e in seen if e.get("cat") == "user_annotation"]
    G = cfg.num_groups()
    assert names.count("moe_dispatch") == names.count("moe_experts") == G
    assert out["by_scope"] is None and out["device_seconds"] is None


def _trace_out(in_trace, enqueued):
    return {"kernels_in_trace": in_trace, "wrapper_kernels": enqueued}


def test_trace_check_lets_one_lost_record_through_and_reports_it():
    """191 of 192 SSD kernels in the trace (CUPTI lost one): accepted, the
    shortfall reported as ``trace_lost``."""
    out = ps._check_trace(_trace_out({"ssd_scan": 191, "gemm": 40},
                                     {"ssd_scan": 192, "flash_attention": 0}))
    assert out["trace_lost"] == {"ssd_scan": 1, "flash_attention": 0}
    out = ps._check_trace(_trace_out({"flash_attention": 990},
                                     {"flash_attention": 1000}))
    assert out["trace_lost"] == {"flash_attention": 10}
    assert ps._check_trace(_trace_out(None, {"ssd_scan": 3}))[
        "trace_lost"] is None


@pytest.mark.parametrize("in_trace,enqueued", [
    ({"gemm": 4}, {"ssd_scan": 1}),             # a whole class absent
    ({"ssd_scan": 0}, {"ssd_scan": 48}),
])
def test_trace_check_refuses_an_absent_class(in_trace, enqueued):
    with pytest.raises(RuntimeError, match="at most"):
        ps._check_trace(_trace_out(in_trace, enqueued))


@pytest.mark.parametrize("in_trace,enqueued", [
    ({"ssd_scan": 193}, {"ssd_scan": 192}),     # more than was enqueued
    ({"flash_attention": 1}, {"flash_attention": 0}),
    ({"ssd_scan": 190}, {"ssd_scan": 192}),     # two of 192 lost
    ({"flash_attention": 989}, {"flash_attention": 1000}),
])
def test_trace_check_refuses_a_surplus_or_a_larger_loss(in_trace, enqueued):
    with pytest.raises(RuntimeError, match="at most"):
        ps._check_trace(_trace_out(in_trace, enqueued))
