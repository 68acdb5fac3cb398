"""Port parity: prefill attention.  The flash kernel's wrapper (its plain
PyTorch version on the CPU) against the reference's Pallas kernel in
interpret mode and its jnp oracle, and the attention paths of
``models/attention.py`` against the reference's, on the same numpy
inputs.

Tolerances: fp32 5e-6 (atol and rtol, as ``tests/test_kernels.py`` holds
the Pallas kernel; the two sides sum in another order), bf16 2e-2 (one
bf16 rounding of outputs up to ~3, plus the reference's bf16 rounding of
the softmax weights on its einsum path).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_oracle
from repro.models import attention as ref_attn
from repro_torch.kernels import _build, ops
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import attention

# The models here are tiny: one thread each, or the test workers that
# share a machine fight over cores inside PyTorch's thread pool.
torch.set_num_threads(1)

TOL = {"float32": 5e-6, "bfloat16": 2e-2}

# the reference's kernel grid (tests/test_kernels.py)
FLASH_GRID = [
    (2, 256, 256, 4, 2, 64, True, 0),
    (1, 128, 384, 8, 8, 128, True, 0),
    (2, 256, 256, 4, 1, 80, True, 64),      # MQA + window + d=80
    (1, 128, 128, 2, 2, 128, False, 0),     # non-causal (cross-attn)
    (1, 512, 512, 3, 3, 64, True, 128),     # odd heads
]


def _normal(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _pair(x, dtype):
    """The same values on both sides: a jnp array and a torch tensor."""
    j = jnp.asarray(x, getattr(jnp, dtype))
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        getattr(torch, dtype))
    return j, t


def _qkv(seed, B, Sq, Skv, Hq, Hkv, D, dtype):
    return [_pair(_normal(seed + i, B, S, H, D), dtype)
            for i, (S, H) in enumerate(((Sq, Hq), (Skv, Hkv), (Skv, Hkv)))]


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("B,Sq,Skv,Hq,Hkv,D,causal,win", FLASH_GRID)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_matches_pallas(B, Sq, Skv, Hq, Hkv, D, causal, win,
                                        dtype):
    (qj, qt), (kj, kt), (vj, vt) = _qkv(0, B, Sq, Skv, Hq, Hkv, D, dtype)
    want = ref_ops.flash_attention(qj, kj, vj, causal=causal, window=win,
                                   bq=128, bk=128)
    got = ops.flash_attention(qt, kt, vt, causal=causal, window=win)
    assert got.shape == (B, Sq, Hq, D) and got.dtype == qt.dtype
    _close(got, want, dtype)


@pytest.mark.parametrize("kv_len,scale", [(None, None), (200, None),
                                          (97, 0.3)])
def test_kernel_layout_matches_the_oracle(kv_len, scale):
    """``kv_len`` masks ragged keys and ``softmax_scale`` overrides
    d**-0.5, in the (B*H, S, d) layout, GQA group 3."""
    q, k, v = _normal(1, 6, 64, 32), _normal(2, 2, 256, 32), _normal(3, 2, 256,
                                                                     32)
    want = ref_oracle.flash_attention_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=False,
        window=0, kv_len=kv_len, softmax_scale=scale)
    got = fa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), causal=False, kv_len=kv_len,
                             softmax_scale=scale)
    _close(got, want, "float32")


def test_cpu_tensors_never_touch_the_kernel(monkeypatch):
    def no_library():
        raise AssertionError("the CUDA library was asked for on the CPU")
    monkeypatch.setattr(_build, "load_library", no_library)
    before = fa.launch_count
    (_, q), (_, k), (_, v) = _qkv(4, 1, 64, 64, 2, 1, 16, "float32")
    ops.flash_attention(q, k, v, causal=True, window=8)
    assert fa.launch_count == before


@pytest.mark.parametrize("shapes,dtype,msg", [
    (((4, 8, 258), (2, 8, 258)), torch.float32, "multiple of 4"),
    (((4, 8, 30), (2, 8, 30)), torch.float32, "multiple of 4"),
    (((3, 8, 16), (2, 8, 16)), torch.float32, "multiple"),
    (((4, 8, 16), (2, 8, 16)), torch.float16, "float32"),
])
def test_wrapper_refuses_what_the_kernel_does_not_take(shapes, dtype, msg):
    q = torch.zeros(shapes[0], dtype=dtype)
    k = torch.zeros(shapes[1], dtype=dtype)
    with pytest.raises((ValueError, TypeError), match=msg):
        fa._check(q, k, k, k.shape[1])


# --------------------------------------------------------------------------
# models/attention.py
# --------------------------------------------------------------------------
ATTN_CASES = [
    # B, Sq, Skv, Hq, Hkv, D, causal, window
    (2, 48, 48, 4, 2, 16, True, 0),
    (1, 40, 72, 6, 1, 32, False, 0),         # MQA, Sq != Skv, ragged chunks
    (2, 64, 64, 4, 4, 16, True, 24),         # sliding window
]


@pytest.mark.parametrize("case", ATTN_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("path", ["einsum", "chunked"])
def test_attention_paths_match(case, dtype, path):
    B, Sq, Skv, Hq, Hkv, D, causal, window = case
    (qj, qt), (kj, kt), (vj, vt) = _qkv(10, B, Sq, Skv, Hq, Hkv, D, dtype)
    # per-sequence valid keys, (B, Skv): the reference pads only a 2-D
    # kv_valid when Skv is not a multiple of the chunk
    kv_valid = (np.arange(Skv)[None] + np.arange(B)[:, None]) % 5 != 3
    kw = dict(causal=causal, window=window)
    if path == "chunked":
        kw["chunk_size"] = 16
    ref_fn = getattr(ref_attn, f"attention_{path}")
    fn = getattr(attention, f"attention_{path}")
    want = ref_fn(qj, kj, vj, q_positions=jnp.arange(Sq),
                  kv_positions=jnp.arange(Skv), kv_valid=jnp.asarray(kv_valid),
                  **kw)
    got = fn(qt, kt, vt, q_positions=torch.arange(Sq),
             kv_positions=torch.arange(Skv),
             kv_valid=torch.from_numpy(kv_valid), **kw)
    assert got.dtype == qt.dtype
    _close(got, want, dtype)


@pytest.mark.parametrize("flash_min_len", [32, 4096])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 40])
def test_self_attention_both_sides_of_flash_min_len(flash_min_len, dtype,
                                                     window):
    """S = 128 with ``flash_min_len`` 32 takes the chunked online softmax
    on both sides; with 4096 it takes the einsum."""
    (qj, qt), (kj, kt), (vj, vt) = _qkv(20, 2, 128, 128, 4, 1, 32, dtype)
    want = ref_attn.self_attention(qj, kj, vj, causal=True, window=window,
                                   chunk_size=32,
                                   flash_min_len=flash_min_len)
    got = attention.self_attention(qt, kt, vt, causal=True, window=window,
                                   chunk_size=32, flash_min_len=flash_min_len)
    _close(got, want, dtype)


def test_attend_dispatches_like_the_reference():
    (qj, qt), (kj, kt), (vj, vt) = _qkv(30, 1, 8, 2100, 2, 1, 16, "float32")
    want = ref_attn.attend(qj, kj, vj, q_positions=jnp.arange(8) + 2092,
                           kv_positions=jnp.arange(2100), window=64)
    got = attention.attend(qt, kt, vt, q_positions=torch.arange(8) + 2092,
                           kv_positions=torch.arange(2100), window=64)
    _close(got, want, "float32")
