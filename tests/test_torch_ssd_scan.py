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
