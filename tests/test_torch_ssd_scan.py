"""Port parity: the SSD chunked scan.  The scan's wrapper (its plain
PyTorch version on the CPU) against the reference's oracle
``repro.models.ssd.ssd_chunked_ref``, its Pallas kernel in interpret mode
(``repro.kernels.ops.ssd_scan``) and a float64 step-by-step recurrence,
on the same numpy inputs.

Tolerances are the reference's own for its kernel (``tests/test_kernels.py``):
y 2e-4 and the final state 2e-5 absolute, with inputs drawn as it draws
them (x, B, C, init_state standard normal, dt in [0.001, 0.1], A in
[-2, -0.5]).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.models import ssd as ref_ssd
from repro_torch.kernels import _build, ops
from repro_torch.kernels import ssd_scan as ssd

# The inputs here are tiny: one thread each, or the test workers that
# share a machine fight over cores inside PyTorch's thread pool.
torch.set_num_threads(1)

Y_ATOL, FINAL_ATOL = 2e-4, 2e-5
# the reference's kernel grid (b, S, H, P, G, N, chunk_size), then one
# chunk holding the whole sequence (Q == S, chunk_size above S)
CASES = [(1, 256, 4, 64, 1, 128, 128), (2, 128, 8, 64, 2, 64, 64),
         (1, 512, 2, 32, 1, 16, 128), (2, 256, 8, 64, 2, 64, 512)]


def _inputs(b, S, H, P, G, N, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, S, H, P)).astype(np.float32)
    dt = rng.uniform(0.001, 0.1, size=(b, S, H)).astype(np.float32)
    A = -rng.uniform(0.5, 2, size=(H,)).astype(np.float32)
    Bm = rng.standard_normal((b, S, G, N)).astype(np.float32)
    Cm = rng.standard_normal((b, S, G, N)).astype(np.float32)
    st = rng.standard_normal((b, H, P, N)).astype(np.float32)
    return x, dt, A, Bm, Cm, st


def _recurrence_f64(x, dt, A, Bm, Cm, st):
    """S_t = exp(dt_t A) S_{t-1} + dt_t x_t B_t^T, y_t = S_t C_t, step by
    step in float64."""
    b, S, H, P = x.shape
    rep = H // Bm.shape[2]
    Bh = np.repeat(Bm, rep, axis=2).astype(np.float64)
    Ch = np.repeat(Cm, rep, axis=2).astype(np.float64)
    state = (np.zeros((b, H, P, Bm.shape[3])) if st is None
             else st.astype(np.float64))
    y = np.zeros((b, S, H, P))
    for t in range(S):
        d = dt[:, t].astype(np.float64)                          # (b, H)
        state = (np.exp(d * A)[..., None, None] * state
                 + np.einsum("bh,bhp,bhn->bhpn", d, x[:, t], Bh[:, t]))
        y[:, t] = np.einsum("bhpn,bhn->bhp", state, Ch[:, t])
    return y, state


@pytest.mark.parametrize("b,S,H,P,G,N,Q", CASES)
@pytest.mark.parametrize("with_init", [True, False])
def test_ssd_scan_matches_reference(b, S, H, P, G, N, Q, with_init):
    x, dt, A, Bm, Cm, st = _inputs(b, S, H, P, G, N)
    st = st if with_init else None
    t = [None if a is None else torch.from_numpy(a)
         for a in (x, dt, A, Bm, Cm, st)]
    y, final = ops.ssd_scan(*t[:5], chunk_size=Q, init_state=t[5])
    assert y.dtype == final.dtype == torch.float32
    assert y.shape == (b, S, H, P) and final.shape == (b, H, P, N)
    j = [None if a is None else jnp.asarray(a) for a in (x, dt, A, Bm, Cm,
                                                          st)]
    oracle = ref_ssd.ssd_chunked_ref(*j[:5], chunk_size=Q, init_state=j[5])
    pallas = ref_ops.ssd_scan(*j[:5], chunk_size=Q, init_state=j[5])
    exact = _recurrence_f64(x, dt, A, Bm, Cm, st)
    for what, (yr, fr) in (("oracle", oracle), ("pallas", pallas),
                           ("float64 recurrence", exact)):
        np.testing.assert_allclose(y.numpy(), np.asarray(yr), atol=Y_ATOL,
                                   rtol=0, err_msg=what)
        np.testing.assert_allclose(final.numpy(), np.asarray(fr),
                                   atol=FINAL_ATOL, rtol=0, err_msg=what)


def test_cpu_wrapper_is_the_plain_version(monkeypatch):
    """On CPU tensors the wrapper is the plain version, to the bit, and
    never asks for the CUDA library or counts a launch."""
    def no_library():
        raise AssertionError("the CUDA library was asked for on the CPU")
    monkeypatch.setattr(_build, "load_library", no_library)
    before = ssd.launch_count
    t = [torch.from_numpy(a) for a in _inputs(1, 64, 4, 16, 2, 16, seed=1)]
    got = ops.ssd_scan(*t[:5], chunk_size=32, init_state=t[5])
    want = ssd.ssd_chunked_ref(*t[:5], 32, t[5])
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert ssd.launch_count == before


@pytest.mark.parametrize("S,chunk", [(100, 64), (96, 80)])
def test_untiled_sequence_raises(S, chunk):
    """Both originals assert S % min(chunk_size, S) == 0; the wrapper and
    the plain version raise."""
    t = [torch.from_numpy(a) for a in _inputs(1, S, 2, 8, 1, 8)]
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ops.ssd_scan(*t[:5], chunk_size=chunk)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ssd.ssd_chunked_ref(*t[:5], chunk)


def test_registry_routes_both_scans_through_their_wrappers():
    assert ops.kernel_registry() == {"rglru": ops.rglru_scan,
                                     "ssd": ops.ssd_scan}


def test_segsum_masks_above_the_diagonal():
    x = torch.tensor([0.5, -1.0, 2.0, 0.25])
    got = ssd._segsum(x)
    want = np.asarray(ref_ssd._segsum(jnp.asarray(x.numpy())))
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.isneginf(got.triu(1)[0, 1:]).all()


# --------------------------------------------------------------------------
# The kernel's three phases (and its decode-step launch), transcribed in
# plain PyTorch
# --------------------------------------------------------------------------
BLOCK = 64                                 # query / key rows of a tile
PHASE_CASES = ([(c, w) for c in CASES for w in (True, False)]
               + [((2, 1, 4, 64, 1, 128, 256), w) for w in (True, False)])


def _kernel_cumsum(dts, a):
    """cum of the kernel's chunk_cumsum: each dt * a rounded to fp32, 32
    lanes each summing a contiguous segment in order, a Hillis-Steele
    scan of the lanes' totals, and the sum of the lanes before added to
    each partial sum.  dts (..., Q), a (...) -> (..., Q)."""
    Q = dts.shape[-1]
    seg = -(-Q // 32)
    prod = torch.zeros(dts.shape[:-1] + (32 * seg,))
    prod[..., :Q] = dts * a[..., None]
    prod = prod.reshape(dts.shape[:-1] + (32, seg))
    partial = prod.clone()
    for k in range(1, seg):
        partial[..., k] = partial[..., k - 1] + prod[..., k]
    incl = partial[..., -1]
    for off in (1, 2, 4, 8, 16):
        shifted = torch.zeros_like(incl)
        shifted[..., off:] = incl[..., :-off]
        incl = incl + shifted
    before = torch.zeros_like(incl)
    before[..., 1:] = incl[..., :-1]
    cum = partial + before[..., None]
    return cum.reshape(dts.shape[:-1] + (32 * seg,))[..., :Q]


def _by_chunk(x, dt, A, Bm, Cm, Q):
    """The inputs cut into chunks, B and C read by each head's group:
    x (b, nc, Q, H, P), B and C (b, nc, Q, H, N), and dt, cum (b, nc, H,
    Q)."""
    b, S, H, _ = x.shape
    rep = H // Bm.shape[2]

    def chunks(t):
        return t.reshape((b, S // Q, Q) + tuple(t.shape[2:]))
    dts = chunks(dt).movedim(3, 2)
    return (chunks(x), torch.repeat_interleave(chunks(Bm), rep, dim=3),
            torch.repeat_interleave(chunks(Cm), rep, dim=3), dts,
            _kernel_cumsum(dts, A[None, None, :]))


def _chunk_states(xc, Bc, dts, cum):
    """Phase 1: S_c = sum_j (x_j exp(cum_last - cum_j) dt_j)^T B_j (b, nc,
    H, P, N) and the decay exp(cum_last) (b, nc, H)."""
    wend = torch.exp(cum[..., -1:] - cum) * dts               # (b,nc,H,Q)
    xw = xc * wend.movedim(3, 2)[..., None]
    return (torch.einsum("bcqhp,bcqhn->bchpn", xw, Bc),
            torch.exp(cum[..., -1]))


def _state_pass(states, decay, init):
    """Phase 2: the state entering each chunk, and the final state."""
    b, nc, H, P, N = states.shape
    carry = init if init is not None else torch.zeros((b, H, P, N))
    entering = []
    for c in range(nc):
        entering.append(carry)
        carry = decay[:, c, :, None, None] * carry + states[:, c]
    return torch.stack(entering, dim=1), carry


def _chunk_outputs(xc, Bc, Cc, dts, cum, entering):
    """Phase 3: y (b, nc, Q, H, P) by 64-row query blocks, the entering
    state's term first, then each 64-key block up to the diagonal, exp
    taken only where key <= query."""
    b, nc, Q, H, P = xc.shape
    y = torch.zeros_like(xc)
    for r0 in range(0, Q, BLOCK):
        r1 = min(r0 + BLOCK, Q)
        Cq = Cc[:, :, r0:r1]
        acc = torch.zeros((b, nc, H, r1 - r0, P))
        if entering is not None:
            acc = (torch.einsum("bcihn,bchpn->bchip", Cq, entering)
                   * torch.exp(cum[..., r0:r1])[..., None])
        for k0 in range(0, r1, BLOCK):
            k1 = min(k0 + BLOCK, Q)
            s = torch.einsum("bcihn,bcjhn->bchij", Cq, Bc[:, :, k0:k1])
            keep = (torch.arange(k0, k1)[None, :]
                    <= torch.arange(r0, r1)[:, None])
            diff = torch.where(keep, cum[..., r0:r1, None]
                               - cum[..., None, k0:k1], 0.0)
            scores = torch.where(keep, s * torch.exp(diff)
                                 * dts[..., None, k0:k1], 0.0)
            acc = acc + torch.einsum("bchij,bcjhp->bchip", scores,
                                     xc[:, :, k0:k1])
        y[:, :, r0:r1] = acc.permute(0, 1, 3, 2, 4)
    return y


def _three_phases(x, dt, A, Bm, Cm, Q, init):
    xc, Bc, Cc, dts, cum = _by_chunk(x, dt, A, Bm, Cm, Q)
    states, decay = _chunk_states(xc, Bc, dts, cum)
    entering, final = _state_pass(states, decay, init)
    return _chunk_outputs(xc, Bc, Cc, dts, cum, entering).reshape(
        x.shape), final


def _one_step(x, dt, A, Bm, Cm, init):
    """The decode-step launch (S = 1): cum = dt a; phase 1's state (x dt)^T
    B, folded with the initial state as phase 2 folds it; phase 3's y =
    exp(cum) (C . state_p) + (C . B) dt x."""
    rep = x.shape[2] // Bm.shape[2]
    x0, dt0 = x[:, 0], dt[:, 0]                              # (b,H,P), (b,H)
    B0 = torch.repeat_interleave(Bm[:, 0], rep, dim=1)       # (b, H, N)
    C0 = torch.repeat_interleave(Cm[:, 0], rep, dim=1)
    dec = torch.exp(dt0 * A)
    final = torch.einsum("bhp,bhn->bhpn", x0 * dt0[..., None], B0)
    y = ((C0 * B0).sum(-1) * dt0)[..., None] * x0
    if init is not None:
        final = dec[..., None, None] * init + final
        y = y + torch.einsum("bhn,bhpn->bhp", C0, init) * dec[..., None]
    return y[:, None], final


@pytest.mark.parametrize("case,with_init", PHASE_CASES)
def test_three_phases_match_the_reference(case, with_init):
    """The transcription against the reference's oracle and its Pallas
    kernel in interpret mode, at tests/test_kernels.py's tolerances; at
    S = 1 the decode-step launch gives what the three phases give, up to
    the order of fp32 sums (chip_smoke.py holds the two kernels equal to
    the bit on the card)."""
    b, S, H, P, G, N, chunk = case
    Q = min(chunk, S)
    x, dt, A, Bm, Cm, st = _inputs(b, S, H, P, G, N, seed=3)
    st = st if with_init else None
    t = [None if a is None else torch.from_numpy(a)
         for a in (x, dt, A, Bm, Cm, st)]
    y, final = _three_phases(*t[:5], Q, t[5])
    if S == 1:
        one_y, one_final = _one_step(*t[:5], t[5])
        torch.testing.assert_close(one_y, y, rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(one_final, final, rtol=1e-6, atol=1e-7)
    j = [None if a is None else jnp.asarray(a) for a in (x, dt, A, Bm, Cm,
                                                          st)]
    oracle = ref_ssd.ssd_chunked_ref(*j[:5], chunk_size=chunk,
                                     init_state=j[5])
    pallas = ref_ops.ssd_scan(*j[:5], chunk_size=chunk, init_state=j[5])
    for what, (yr, fr) in (("oracle", oracle), ("pallas", pallas)):
        np.testing.assert_allclose(y.numpy(), np.asarray(yr), atol=Y_ATOL,
                                   rtol=0, err_msg=what)
        np.testing.assert_allclose(final.numpy(), np.asarray(fr),
                                   atol=FINAL_ATOL, rtol=0, err_msg=what)


def test_kernel_cumsum_is_a_cumulative_sum():
    """The lane-segmented scan is a cumulative sum of the rounded
    products, at any length (segments of 1 to 16, lanes left empty)."""
    rng = np.random.default_rng(4)
    for Q in (1, 5, 31, 32, 33, 100, 256, 512):
        dts = torch.from_numpy(rng.uniform(0.001, 0.1, Q).astype(np.float32))
        a = torch.tensor(-1.3)
        want = np.cumsum((dts * a).double().numpy())
        np.testing.assert_allclose(_kernel_cumsum(dts, a).numpy(), want,
                                   rtol=1e-5, atol=1e-6)
