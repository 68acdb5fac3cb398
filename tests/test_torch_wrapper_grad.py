"""The CUDA wrappers under autograd.  A result filled through ``ctypes``
carries no ``grad_fn``, so the wrappers of the kernels that training
runs (flash attention, the RG-LRU and SSD scans) run as a
``torch.autograd.Function`` when grad is enabled and an input requires
it: the kernel in the forward, the backward in torch code.  Decode
attention has no backward (decode is never differentiated), so its
wrapper raises on CUDA tensors in that case, before it loads or launches
anything.  Without grad, or without an input that requires it, every
wrapper goes straight on to the library.  CPU tensors take the plain
versions, under the same Functions.

The card is stood in for by CPU tensors of a subclass that says it lies
on the card, by a library stub that raises when it is reached, and, for
a launch, by each module's ``_launch`` replaced with its plain version.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import decode_attention as dec
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import rglru_scan as lru
from repro_torch.kernels import ssd_scan as ssd


class _OnTheCard(torch.Tensor):
    """A CPU tensor that says it lies on the card."""

    @property
    def is_cuda(self):
        return True


class _Reached(Exception):
    """The wrapper got as far as loading the library."""


def _inputs(name):
    """{argument: tensor} of one small call of each wrapper, fp32, and
    the call itself."""
    rng = np.random.default_rng(0)

    def n(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    if name == "flash_attention":
        args = {"q": n(4, 8, 16), "k": n(2, 8, 16), "v": n(2, 8, 16)}
        return args, lambda a: fa.flash_attention(a["q"], a["k"], a["v"])
    if name == "decode_attention":
        args = {"q": n(2, 4, 16), "k": n(2, 8, 2, 16), "v": n(2, 8, 2, 16)}
        lengths = torch.tensor([8, 5], dtype=torch.int32)
        return args, lambda a: dec.decode_attention(a["q"], a["k"], a["v"],
                                                    lengths)
    if name == "rglru_scan":
        args = {"a": torch.rand((2, 8, 16), dtype=torch.float32),
                "b": n(2, 8, 16), "h0": n(2, 16)}
        return args, lambda a: lru.rglru_scan(a["a"], a["b"], a["h0"])
    args = {"x": n(1, 8, 2, 16), "dt": torch.rand((1, 8, 2)) + 0.1,
            "A": -torch.rand(2) - 0.5, "Bm": n(1, 8, 1, 16),
            "Cm": n(1, 8, 1, 16), "init_state": n(1, 2, 16, 16)}
    return args, lambda a: ssd.ssd_scan(a["x"], a["dt"], a["A"], a["Bm"],
                                        a["Cm"], chunk_size=8,
                                        init_state=a["init_state"])


WRAPPERS = {"flash_attention": fa, "decode_attention": dec,
            "rglru_scan": lru, "ssd_scan": ssd}
CASES = [(name, arg) for name in WRAPPERS for arg in _inputs(name)[0]]


def _on_the_card(args, grad_arg=None):
    return {k: v.as_subclass(_OnTheCard).requires_grad_(k == grad_arg)
            for k, v in args.items()}


@pytest.fixture
def stub_library(monkeypatch):
    def reached():
        raise _Reached
    monkeypatch.setattr(_build, "load_library", reached)


#: what each Function's node is called in a result's ``grad_fn``
FUNCTIONS = {"flash_attention": "FlashAttentionBackward",
             "rglru_scan": "RGLRUScanBackward", "ssd_scan": "SSDScanBackward"}


def _plain_launches(monkeypatch):
    """Each training kernel's ``_launch`` replaced by its plain version,
    counting its calls: what the card would return, without the card."""
    calls = []

    def flash(q, k, v, *, causal, window, kv_len, scale, want_lse):
        calls.append("flash_attention")
        o, lse = fa.flash_attention_ref(q, k, v, causal=causal, window=window,
                                        kv_len=kv_len, softmax_scale=scale,
                                        return_lse=True)
        return o, lse if want_lse else None

    def scan(a, b, h0):
        calls.append("rglru_scan")
        return lru.rglru_scan_ref(a, b, h0)

    def chunked(x, dt, A, Bm, Cm, Q, init_state):
        calls.append("ssd_scan")
        return ssd.ssd_chunked_ref(x, dt, A, Bm, Cm, Q, init_state)
    monkeypatch.setattr(fa, "_launch", flash)
    monkeypatch.setattr(lru, "_launch", scan)
    monkeypatch.setattr(ssd, "_launch", chunked)
    return calls


@pytest.mark.parametrize("name,arg", CASES)
def test_cuda_wrapper_refuses_inputs_that_require_grad(name, arg,
                                                       stub_library,
                                                       monkeypatch):
    """Decode attention refuses, launching nothing.  The training
    kernels' results carry their Function's ``grad_fn``; the forward
    launched the kernel once, and the gradient equals the plain
    version's on CPU tensors."""
    args, call = _inputs(name)
    if name == "decode_attention":
        before = WRAPPERS[name].launch_count
        with pytest.raises(RuntimeError, match="no backward"):
            call(_on_the_card(args, grad_arg=arg))
        assert WRAPPERS[name].launch_count == before
        return
    calls = _plain_launches(monkeypatch)
    on_card = _on_the_card(args, grad_arg=arg)
    out = call(on_card)
    out = out[0] if isinstance(out, tuple) else out
    assert type(out.grad_fn).__name__ == FUNCTIONS[name]
    assert calls == [name]
    out.square().sum().backward()
    cpu = {k: v.clone().requires_grad_(k == arg) for k, v in args.items()}
    want = call(cpu)
    want = want[0] if isinstance(want, tuple) else want
    want.square().sum().backward()
    np.testing.assert_allclose(on_card[arg].grad.numpy(),
                               cpu[arg].grad.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", WRAPPERS)
def test_cuda_wrapper_goes_on_under_no_grad(name, stub_library):
    """Every input requires grad, but grad is off: on to the library."""
    args, call = _inputs(name)
    on_card = {k: v.as_subclass(_OnTheCard).requires_grad_()
               for k, v in args.items()}
    with torch.no_grad(), pytest.raises(_Reached):
        call(on_card)


@pytest.mark.parametrize("name", WRAPPERS)
def test_cuda_wrapper_goes_on_without_grad_inputs(name, stub_library):
    """Grad is on, but no input requires it: on to the library."""
    args, call = _inputs(name)
    assert torch.is_grad_enabled()
    with pytest.raises(_Reached):
        call(_on_the_card(args))


@pytest.mark.parametrize("name", WRAPPERS)
def test_cpu_wrapper_is_differentiable(name, stub_library):
    """CPU tensors: the plain version, a gradient for every input that
    requires one, and the library never loaded."""
    args, call = _inputs(name)
    args = {k: v.requires_grad_() for k, v in args.items()}
    out = call(args)
    out = out[0] if isinstance(out, tuple) else out
    out.square().sum().backward()
    for k, v in args.items():
        assert v.grad is not None and bool(torch.isfinite(v.grad).all()), k
        assert float(v.grad.abs().sum()) > 0, k


def test_rglru_backward_launches_the_scan_on_the_card(stub_library,
                                                      monkeypatch):
    """The RG-LRU backward is the same kernel, once, on the time-reversed
    inputs: on tensors on the card it launches, and its gradients equal
    those of the plain version's autograd."""
    calls = _plain_launches(monkeypatch)
    args, _ = _inputs("rglru_scan")
    a, b, h0 = args["a"], args["b"], args["h0"]
    h = lru.rglru_scan_ref(a, b, h0)
    dh = torch.from_numpy(np.random.default_rng(1).standard_normal(
        tuple(h.shape)).astype(np.float32))
    card = [t.as_subclass(_OnTheCard) for t in (a, h, h0, dh)]
    got = lru.rglru_scan_bwd(*card)
    assert calls == ["rglru_scan"]
    leaves = [t.clone().requires_grad_() for t in (a, b, h0)]
    want = torch.autograd.grad(lru.rglru_scan_ref(*leaves), leaves, dh)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-5)


def test_flash_refuses_grad_for_bf16_beyond_head_dim_128(stub_library):
    """The bf16 kernel writes no lse above head_dim 128, so on the card
    the wrapper refuses autograd there before it loads the library; the
    same call without grad goes on to it."""
    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 8, 256)).astype(
        np.float32)).to(torch.bfloat16).as_subclass(_OnTheCard)
        for _ in range(3))
    before = fa.launch_count
    with pytest.raises(RuntimeError, match="no lse above 128"):
        fa.flash_attention(q.requires_grad_(), k, v)
    assert fa.launch_count == before
    with torch.no_grad(), pytest.raises(_Reached):
        fa.flash_attention(q, k, v)
