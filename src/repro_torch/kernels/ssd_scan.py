"""Mamba-2 SSD (state-space duality) chunked scan.

``ssd_scan`` launches the hand-written CUDA kernel (``csrc/ssd_scan.cu``)
for CUDA tensors and uses the plain PyTorch version ``ssd_chunked_ref``
only for tensors that lie on the CPU.  Counterpart of
``repro/kernels/ssd_scan.py``; the plain version transcribes the
reference's oracle ``repro/models/ssd.py::ssd_chunked_ref``: per chunk of
``Q = min(chunk_size, S)`` steps the quadratic intra-chunk term, then a
loop over chunks that carries the state and emits the state *entering*
each chunk for the inter-chunk term.

  x (b, S, H, P), dt (b, S, H) (already softplus'ed), A (H,) negative,
  Bm, Cm (b, S, G, N), init_state (b, H, P, N) or None, all fp32
  -> y (b, S, H, P), final_state (b, H, P, N) fp32;  S % Q == 0

Under autograd it runs as ``SSDScan``: the kernel (or, on the CPU, the
plain version) in the forward, and in the backward one vjp of the plain
``ssd_chunked_ref`` over the whole sequence, seeded with (dy, dstate),
device-agnostic torch code.  The reference's backward
(``repro/models/ssd.py::_ssd_bwd_rule_impl``) replays chunk by chunk from
saved entry states to hold one chunk's intermediates at a time; here the
training step recomputes one group at a time, so the whole-sequence vjp
fits and is one graph instead of one a chunk.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

#: kernel launches made by ``ssd_scan`` in this process (incremented
#: where the kernel is launched, and nowhere else)
launch_count = 0
#: CUDA kernels those launches enqueued: one for a decode step (S = 1),
#: three (chunk states, state pass, chunk outputs) for any other length
kernel_count = 0

#: what the kernel's tiles hold (csrc/ssd_scan.cu): P in one 64-wide
#: tile, N in two
MAX_HEAD_DIM = 64
MAX_STATE = 128


def _chunk_length(S: int, chunk_size: int) -> int:
    Q = min(chunk_size, S)
    if Q <= 0 or S % Q != 0:
        raise ValueError(f"ssd_scan: sequence length {S} is not a multiple "
                         f"of the chunk length {Q}")
    return Q


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """x (..., Q) -> (..., Q, Q) lower-triangular cumulative sums:
    out[i, j] = sum_{k in (j, i]} x[k] for i >= j, -inf otherwise."""
    Q = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]     # cum_i - cum_j
    mask = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    return out.masked_fill(~mask, float("-inf"))


def ssd_chunked_ref(x, dt, A, Bm, Cm, chunk_size: int, init_state=None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch chunked SSD: the reference's einsums, B and C
    repeated across the heads of a group."""
    b, S, H, Pd = x.shape
    G = Bm.shape[2]
    rep = H // G
    Q = _chunk_length(S, chunk_size)
    nc = S // Q

    def r(t):  # (b, S, ...) -> (b, nc, Q, ...)
        return t.reshape((b, nc, Q) + tuple(t.shape[2:]))

    xc, dtc = r(x), r(dt)
    Bc = torch.repeat_interleave(r(Bm), rep, dim=3)    # (b, nc, Q, H, N)
    Cc = torch.repeat_interleave(r(Cm), rep, dim=3)
    dA = dtc * A                                       # (b, nc, Q, H)
    cum = torch.cumsum(dA, dim=2)

    # intra-chunk (quadratic within the chunk)
    L = torch.exp(_segsum(dA.movedim(3, 2)))           # (b, nc, H, Q, Q)
    scores = torch.einsum("bcqhn,bckhn->bchqk", Cc, Bc)
    M = scores * L * dtc.movedim(3, 2)[..., None, :]   # * dt_j
    y = torch.einsum("bchqk,bckhp->bcqhp", M, xc)

    # chunk states
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)  # (b, nc, Q, H)
    states = torch.einsum("bcqh,bcqhn,bcqhp->bchpn", decay_to_end * dtc, Bc,
                          xc)                          # (b, nc, H, P, N)

    # inter-chunk scan: emit the state entering each chunk
    chunk_decay = torch.exp(dA.sum(dim=2))             # (b, nc, H)
    carry = (init_state if init_state is not None else
             torch.zeros((b, H, Pd, Bm.shape[-1]), dtype=x.dtype,
                         device=x.device))
    entering = []
    for c in range(nc):
        entering.append(carry)
        carry = chunk_decay[:, c, :, None, None] * carry + states[:, c]
    prev_states = torch.stack(entering, dim=1)         # (b, nc, H, P, N)

    y = y + torch.einsum("bcqh,bcqhn,bchpn->bcqhp", torch.exp(cum), Cc,
                         prev_states)
    return y.reshape(b, S, H, Pd), carry


def _check(x, dt, A, Bm, Cm, init_state) -> None:
    b, S, H, P = x.shape
    if Bm.dim() != 4 or Cm.shape != Bm.shape or tuple(Bm.shape[:2]) != (b, S):
        raise ValueError(f"ssd_scan: expected Bm, Cm (b,S,G,N) of one shape, "
                         f"got {tuple(Bm.shape)}, {tuple(Cm.shape)}")
    G, N = Bm.shape[2], Bm.shape[3]
    if H % G != 0 or P > MAX_HEAD_DIM or N > MAX_STATE:
        raise ValueError(f"ssd_scan: the kernel takes H a multiple of G, "
                         f"P <= {MAX_HEAD_DIM}, N <= {MAX_STATE}; got H={H}, "
                         f"G={G}, P={P}, N={N}")
    shapes = [("x", x, (b, S, H, P)), ("dt", dt, (b, S, H)), ("A", A, (H,)),
              ("Bm", Bm, (b, S, G, N)), ("Cm", Cm, (b, S, G, N))]
    if init_state is not None:
        shapes.append(("init_state", init_state, (b, H, P, N)))
    for name, t, want in shapes:
        if tuple(t.shape) != want:
            raise ValueError(f"ssd_scan: {name} {tuple(t.shape)} != {want}")
        if t.dtype != torch.float32:
            raise TypeError(f"ssd_scan: {name} must be float32, got "
                            f"{t.dtype}")
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"ssd_scan: {name} must be contiguous and on "
                             f"{x.device}")


def _launch(x, dt, A, Bm, Cm, Q: int, init_state):
    """One launch of the kernel on checked CUDA tensors -> (y, final), on
    the current stream, without synchronising."""
    global launch_count, kernel_count
    b, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    lib = _build.load_library()
    y = torch.empty_like(x)
    final = torch.empty((b, H, P, N), dtype=torch.float32, device=x.device)
    if y.numel() == 0:
        return y, final.zero_()
    # scratch of the three phases: each chunk's state (then the state
    # entering it) and its decay; a decode step (S = 1) needs none
    nc = S // Q
    states = decay = None
    if S > 1:
        states = torch.empty((b, H, nc, P, N), dtype=torch.float32,
                             device=x.device)
        decay = torch.empty((b, H, nc), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.repro_ssd_scan(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(),
            init_state.data_ptr() if init_state is not None else None,
            y.data_ptr(), final.data_ptr(),
            states.data_ptr() if states is not None else None,
            decay.data_ptr() if decay is not None else None,
            b, S, H, P, G, N, Q, stream)
    _build.check_launch(lib, code, "ssd_scan")
    launch_count += 1
    kernel_count += 1 if states is None else 3
    return y, final


def _forward(x, dt, A, Bm, Cm, chunk_size: int, init_state):
    """The dispatch: the plain version on CPU tensors, the kernel on CUDA
    tensors (or a raise)."""
    Q = _chunk_length(x.shape[1], chunk_size)
    if not x.is_cuda:
        if x.device.type != "cpu":
            raise ValueError(f"ssd_scan: unsupported device {x.device}")
        return ssd_chunked_ref(x, dt, A, Bm, Cm, chunk_size, init_state)
    _check(x, dt, A, Bm, Cm, init_state)
    return _launch(x, dt, A, Bm, Cm, Q, init_state)


class SSDScan(torch.autograd.Function):
    """``ssd_scan`` under autograd: the forward keeps its inputs, the
    backward is the vjp of the plain ``ssd_chunked_ref`` recomputed from
    them."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, chunk_size, init_state):
        ctx.save_for_backward(x, dt, A, Bm, Cm, init_state)
        ctx.chunk_size = chunk_size
        return _forward(x, dt, A, Bm, Cm, chunk_size, init_state)

    @staticmethod
    def backward(ctx, dy, dfinal):
        saved = ctx.saved_tensors
        ins = [t if t is None else t.detach().requires_grad_()
               for t in saved]
        wrt = [t for t in ins if t is not None]
        with torch.enable_grad():
            outs = ssd_chunked_ref(*ins[:5], ctx.chunk_size, ins[5])
            grads = iter(torch.autograd.grad(outs, wrt, (dy, dfinal)))
        dx, ddt, dA, dBm, dCm, dinit = (
            None if t is None else next(grads) for t in ins)
        return dx, ddt, dA, dBm, dCm, None, dinit


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, *, chunk_size: int,
             init_state: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (b,S,H,P), dt (b,S,H), A (H,), Bm/Cm (b,S,G,N), init_state
    (b,H,P,N) or None, fp32 -> (y (b,S,H,P), final (b,H,P,N)) fp32.

    CPU tensors go to the plain version.  CUDA tensors go to the kernel,
    on the current stream and without synchronising, or this raises: it
    never falls back.  Raises when S is not a multiple of
    ``min(chunk_size, S)``.  When grad is enabled and an input requires
    it, the call runs as ``SSDScan``.
    """
    if x.dim() != 4:
        raise ValueError(f"ssd_scan: expected x (b,S,H,P), got "
                         f"{tuple(x.shape)}")
    _chunk_length(x.shape[1], chunk_size)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, dt, A, Bm, Cm, init_state)):
        return SSDScan.apply(x, dt, A, Bm, Cm, chunk_size, init_state)
    return _forward(x, dt, A, Bm, Cm, chunk_size, init_state)
