"""The CUDA wrappers under autograd.  The hand kernels have no backward
yet (ROADMAP A9): a result filled through ``ctypes`` carries no
``grad_fn``, so each wrapper of a kernel that models call (flash
attention, decode attention, the RG-LRU and SSD scans) raises on CUDA
tensors when grad is enabled and an input requires it, before it loads
or launches anything.  Without grad, or without an input that requires
it, the wrapper goes on to the library.  CPU tensors take the plain
versions, which autograd follows.

The card is stood in for by CPU tensors of a subclass that says it lies
on the card, and by a library stub that raises when it is reached.
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


@pytest.mark.parametrize("name,arg", CASES)
def test_cuda_wrapper_refuses_inputs_that_require_grad(name, arg,
                                                       stub_library):
    args, call = _inputs(name)
    before = WRAPPERS[name].launch_count
    with pytest.raises(RuntimeError, match="ROADMAP A9"):
        call(_on_the_card(args, grad_arg=arg))
    assert WRAPPERS[name].launch_count == before


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
