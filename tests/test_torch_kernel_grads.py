"""The backwards of the training kernels (flash attention, the RG-LRU and
SSD scans) on CPU tensors, against the reference's: its flash
``custom_vjp`` (``repro/models/attention.py::flash_self_attention``), JAX
autodiff of ``lru_scan_ref``, and its SSD ``custom_vjp``
(``repro/models/ssd.py::ssd_chunked_train``).  On the CPU each wrapper's
``torch.autograd.Function`` runs the plain forward and the very backward
the card runs.  Inputs come from numpy.

Tolerances: flash as ``tests/test_kernels.py::test_flash_custom_vjp_grads``
(loss relative 1e-6, here summed in float64 on both sides so that only
the outputs differ; gradients atol 1e-5), with an rtol of 1e-5 beside
it: dk and dv reach ~10 here, where summing ~500 fp32 terms in torch's
order rather than XLA's moves them by up to 2e-6 relative (bf16: a
relative L2 error of 2e-2, both sides rounding their outputs to bf16);
the RG-LRU atol 1e-5; the SSD rtol and atol 1e-4 (gradients of a few hundred, sums over chunks
in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as ref_attn
from repro.models import rglru as ref_rglru
from repro.models import ssd as ref_ssd
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops

torch.set_num_threads(1)


def _n(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _grads(fn, arrays):
    leaves = [torch.from_numpy(a).requires_grad_() for a in arrays]
    loss = fn(*leaves)
    loss.backward()
    return float(loss.detach()), [t.grad.numpy() for t in leaves]


# --------------------------------------------------------------------------
# flash attention: the layout of tests/test_kernels.py (GQA 4 on 2, d 64)
# --------------------------------------------------------------------------
@pytest.mark.parametrize("S,causal,window,chunk", [
    (256, True, 0, 1024),
    (256, True, 100, 1024),
    (256, False, 0, 1024),
    (256, True, 100, 96),        # tiles of 96: Sq is not a multiple
    (200, True, 0, 64),          # nor is S
])
def test_flash_backward_matches_the_custom_vjp(S, causal, window, chunk,
                                               monkeypatch):
    monkeypatch.setattr(fa, "BWD_CHUNK", chunk)
    B, Hq, Hkv, D = 2, 4, 2, 64
    rng = np.random.default_rng(S + window)
    q, k, v = _n(rng, B, S, Hq, D), _n(rng, B, S, Hkv, D), _n(rng, B, S,
                                                              Hkv, D)
    ref_chunk = 64 if S % 64 == 0 else S

    def ref_out(q, k, v):
        return ref_attn.flash_self_attention(q, k, v, causal, window,
                                             ref_chunk)

    @jax.jit
    def ref_vjp(q, k, v):
        o, vjp = jax.vjp(ref_out, q, k, v)
        return o, vjp(1.0 - jnp.tanh(o) ** 2)      # d sum(tanh(o)) / do

    want_o, want_g = ref_vjp(q, k, v)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    o = ops.flash_attention(*leaves, causal=causal, window=window)
    torch.tanh(o).sum().backward()
    # the loss, summed in float64 on both sides: only the outputs differ
    got, want = (np.tanh(np.asarray(t, np.float64)).sum()
                 for t in (o.detach().numpy(), want_o))
    assert abs(got - want) < 1e-6 * max(1.0, abs(want))
    for t, w in zip(leaves, want_g):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-5)


def test_flash_backward_in_bf16():
    B, S, Hq, Hkv, D = 2, 128, 4, 2, 64
    rng = np.random.default_rng(7)
    arrays = (_n(rng, B, S, Hq, D), _n(rng, B, S, Hkv, D),
              _n(rng, B, S, Hkv, D))
    w = _n(rng, B, S, Hq, D)

    def ref_loss(q, k, v):
        o = ref_attn.flash_self_attention(q, k, v, True, 48, 64)
        return jnp.sum(o.astype(jnp.float32) * w)

    jx = [jnp.asarray(a, jnp.bfloat16) for a in arrays]
    want_g = jax.jit(jax.grad(ref_loss, argnums=(0, 1, 2)))(*jx)
    leaves = [torch.from_numpy(a).to(torch.bfloat16).requires_grad_()
              for a in arrays]
    o = ops.flash_attention(*leaves, causal=True, window=48)
    (o.float() * torch.from_numpy(w)).sum().backward()
    for t, want in zip(leaves, want_g):
        assert t.grad.dtype == torch.bfloat16
        g = t.grad.float().numpy()
        want = np.asarray(want, np.float32)
        assert np.linalg.norm(g - want) <= 2e-2 * np.linalg.norm(want)


# --------------------------------------------------------------------------
# RG-LRU: the reverse recurrence against autodiff of the associative scan
# --------------------------------------------------------------------------
@pytest.mark.parametrize("with_h0", [True, False])
def test_rglru_backward_matches_autodiff(with_h0):
    B, S, W = 2, 77, 24
    rng = np.random.default_rng(3)
    a = rng.uniform(0.5, 0.999, (B, S, W)).astype(np.float32)
    b, h0, w = _n(rng, B, S, W), _n(rng, B, W), _n(rng, B, S, W)
    arrays = (a, b, h0) if with_h0 else (a, b)

    def ref_loss(*xs):
        return jnp.sum(ref_rglru.lru_scan_ref(*xs) * w)

    want_g = jax.jit(jax.grad(ref_loss, argnums=tuple(range(len(arrays)))))(
        *arrays)
    _, got_g = _grads(lambda *xs: (ops.rglru_scan(*xs) * torch.from_numpy(
        w)).sum(), arrays)
    for g, want in zip(got_g, want_g):
        np.testing.assert_allclose(g, np.asarray(want), atol=1e-5)


# --------------------------------------------------------------------------
# SSD: the plain version's vjp against the reference's chunk-replay
# custom_vjp
# --------------------------------------------------------------------------
@pytest.mark.parametrize("with_init,G", [(True, 2), (False, 1)])
def test_ssd_backward_matches_the_custom_vjp(with_init, G):
    b, S, H, P, N, Q = 2, 96, 4, 16, 8, 32
    rng = np.random.default_rng(5)
    x = _n(rng, b, S, H, P)
    dt = rng.uniform(0.01, 0.2, (b, S, H)).astype(np.float32)
    A = -rng.uniform(0.5, 2.0, (H,)).astype(np.float32)
    Bm, Cm = _n(rng, b, S, G, N), _n(rng, b, S, G, N)
    st = _n(rng, b, H, P, N)
    wy, wf = _n(rng, b, S, H, P), _n(rng, b, H, P, N)
    arrays = (x, dt, A, Bm, Cm) + ((st,) if with_init else ())

    def ref_loss(x, dt, A, Bm, Cm, *init):
        y, f = ref_ssd.ssd_chunked_train(x, dt, A, Bm, Cm, chunk_size=Q,
                                         init_state=init[0] if init else None)
        return jnp.sum(y * wy) + jnp.sum(f * wf)

    want, want_g = jax.jit(jax.value_and_grad(
        ref_loss, argnums=tuple(range(len(arrays)))))(*arrays)

    def loss(x, dt, A, Bm, Cm, *init):
        y, f = ops.ssd_scan(x, dt, A, Bm, Cm, chunk_size=Q,
                            init_state=init[0] if init else None)
        return (y * torch.from_numpy(wy)).sum() + (f * torch.from_numpy(
            wf)).sum()

    got, got_g = _grads(loss, arrays)
    np.testing.assert_allclose(got, float(want), rtol=1e-5)
    for g, w in zip(got_g, want_g):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4, atol=1e-4)
