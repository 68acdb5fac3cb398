"""RG-LRU linear recurrence ``h_t = a_t * h_{t-1} + b_t``, per channel.

``rglru_scan`` launches the hand-written CUDA kernel
(``csrc/rglru_scan.cu``) for CUDA tensors and uses the plain PyTorch
version ``rglru_scan_ref`` only for tensors that lie on the CPU.
Counterpart of ``repro/kernels/rglru_scan.py``; the plain version is the
reference's oracle ``repro/models/rglru.py::lru_scan_ref``, an
associative scan with ``h0`` folded into the first step.

  a, b (B, S, W) fp32; h0 (B, W) fp32 or None -> h (B, S, W) fp32

Under autograd it runs as ``RGLRUScan``, whose backward is the same
recurrence run backwards in time (``rglru_scan_bwd``): through the same
dispatch, so on a CUDA tensor the same hand kernel carries it.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build

#: kernel launches made by ``rglru_scan`` in this process (incremented
#: where the kernel is launched, and nowhere else)
launch_count = 0


def _combine(left, right):
    a_l, b_l = left
    a_r, b_r = right
    return a_l * a_r, a_r * b_l + b_r


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """out[:, 0::2] = even, out[:, 1::2] = odd (even may be one longer)."""
    shape = list(even.shape)
    shape[1] = even.shape[1] + odd.shape[1]
    out = even.new_empty(shape)
    out[:, 0::2] = even
    out[:, 1::2] = odd
    return out


def _associative_scan(a: torch.Tensor, b: torch.Tensor):
    """The inclusive scan of ``_combine`` over axis 1, in the order
    ``jax.lax.associative_scan`` combines: pairs first, the odd
    positions by recursion, then the even ones."""
    n = a.shape[1]
    if n < 2:
        return a, b
    ra, rb = _combine((a[:, 0:-1:2], b[:, 0:-1:2]), (a[:, 1::2], b[:, 1::2]))
    oa, ob = _associative_scan(ra, rb)
    if n % 2 == 0:
        ea, eb = _combine((oa[:, :-1], ob[:, :-1]), (a[:, 2::2], b[:, 2::2]))
    else:
        ea, eb = _combine((oa, ob), (a[:, 2::2], b[:, 2::2]))
    ea = torch.cat([a[:, :1], ea], dim=1)
    eb = torch.cat([b[:, :1], eb], dim=1)
    return _interleave(ea, oa), _interleave(eb, ob)


def rglru_scan_ref(a: torch.Tensor, b: torch.Tensor,
                   h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version: associative scan of h_t = a_t h_{t-1} + b_t
    over axis 1, fp32."""
    if h0 is not None:
        b = b.clone()
        b[:, 0] += a[:, 0] * h0
    _, h = _associative_scan(a, b)
    return h


def _check(a, b, h0) -> None:
    if a.dim() != 3 or b.shape != a.shape:
        raise ValueError(f"rglru_scan: expected a, b (B,S,W) of one shape, "
                         f"got {tuple(a.shape)}, {tuple(b.shape)}")
    B, S, W = a.shape
    tensors = [("a", a), ("b", b)]
    if h0 is not None:
        if tuple(h0.shape) != (B, W):
            raise ValueError(f"rglru_scan: h0 {tuple(h0.shape)} != {(B, W)}")
        tensors.append(("h0", h0))
    for name, t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"rglru_scan: {name} must be float32, got "
                            f"{t.dtype}")
        if t.device != a.device or not t.is_contiguous():
            raise ValueError(f"rglru_scan: {name} must be contiguous and on "
                             f"{a.device}")


def _launch(a, b, h0):
    """One launch of the kernel on checked CUDA tensors -> h, on the
    current stream, without synchronising."""
    global launch_count
    B, S, W = a.shape
    lib = _build.load_library()
    h = torch.empty_like(a)
    if h.numel() == 0:
        return h
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.repro_rglru_scan(
            a.data_ptr(), b.data_ptr(),
            h0.data_ptr() if h0 is not None else None, h.data_ptr(),
            B, S, W, stream)
    _build.check_launch(lib, code, "rglru_scan")
    launch_count += 1
    return h


def _forward(a, b, h0):
    """The dispatch: the plain version on CPU tensors, the kernel on CUDA
    tensors (or a raise)."""
    if not a.is_cuda:
        if a.device.type != "cpu":
            raise ValueError(f"rglru_scan: unsupported device {a.device}")
        return rglru_scan_ref(a, b, h0)
    _check(a, b, h0)
    return _launch(a, b, h0)


def rglru_scan_bwd(a, h, h0, dh):
    """(da, db, dh0) of h = rglru_scan(a, b, h0) for the cotangent dh.
    The cotangent g of each h_t obeys g_t = dh_t + a_{t+1} g_{t+1}, the
    forward's recurrence run backwards: so g is the scan of the
    time-reversed, one-shifted a (a_{t+1}, and 0 past the end) and the
    reversed dh, reversed back.  Then db = g, da_t = g_t h_{t-1} (h_{-1}
    = h0, or 0) and dh0 = a_0 g_0."""
    a_next = torch.cat([a[:, 1:], torch.zeros_like(a[:, :1])], dim=1)
    g = _forward(a_next.flip(1).contiguous(), dh.flip(1).contiguous(),
                 None).flip(1)
    h_prev = torch.cat([h0[:, None] if h0 is not None
                        else torch.zeros_like(h[:, :1]), h[:, :-1]], dim=1)
    dh0 = a[:, 0] * g[:, 0] if h0 is not None else None
    return g * h_prev, g, dh0


class RGLRUScan(torch.autograd.Function):
    """``rglru_scan`` under autograd: the forward keeps a, h0 and h, the
    backward is ``rglru_scan_bwd``."""

    @staticmethod
    def forward(ctx, a, b, h0):
        h = _forward(a, b, h0)
        ctx.save_for_backward(a, h0, h)
        return h

    @staticmethod
    def backward(ctx, dh):
        a, h0, h = ctx.saved_tensors
        return rglru_scan_bwd(a, h, h0, dh.contiguous())


def rglru_scan(a: torch.Tensor, b: torch.Tensor,
               h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """a, b (B, S, W) fp32; h0 (B, W) fp32 or None -> h (B, S, W) fp32.

    CPU tensors go to the plain version.  CUDA tensors go to the kernel,
    on the current stream and without synchronising, or this raises: it
    never falls back.  When grad is enabled and an input requires it,
    the call runs as ``RGLRUScan``.
    """
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (a, b, h0)):
        return RGLRUScan.apply(a, b, h0)
    return _forward(a, b, h0)
