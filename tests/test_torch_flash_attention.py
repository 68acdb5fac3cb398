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
import contextlib
import math
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as ref_flash
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


class _OnTheCard:
    """A CPU tensor that says it lies on the card: what the wrapper reads
    before it launches."""
    is_cuda = True
    device = torch.device("cuda", 0)
    requires_grad = False

    def __init__(self, t):
        self.t, self.shape, self.dtype = t, t.shape, t.dtype

    def dim(self):
        return self.t.dim()

    def is_contiguous(self):
        return True

    def data_ptr(self):
        return 0


@pytest.mark.parametrize("dtype,code", [(torch.bfloat16, 1),
                                        (torch.float32, 0)])
def test_wrapper_passes_the_dtype_code(dtype, code, monkeypatch):
    """bf16 goes to the tensor-core kernel (code 1) and fp32 to the
    CUDA-core one (code 0), through the one C entry."""
    calls = []

    class Library:
        def repro_flash_attention(self, *args):
            calls.append(args)
            return 0
    empty_like = torch.empty_like
    monkeypatch.setattr(_build, "load_library", Library)
    monkeypatch.setattr(torch, "empty_like",
                        lambda x: _OnTheCard(empty_like(x.t)))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    q = _OnTheCard(torch.zeros((6, 40, 36), dtype=dtype))
    kv = _OnTheCard(torch.zeros((2, 50, 36), dtype=dtype))
    before = fa.launch_count
    o = fa.flash_attention(q, kv, kv, causal=True, window=16, kv_len=45)
    assert fa.launch_count == before + 1 and o.shape == q.shape
    (args,) = calls
    assert args[4] is None               # no lse asked for
    assert args[5:13] == (6, 2, 40, 50, 36, 45, 1, 16)
    assert args[13] == pytest.approx(36 ** -0.5) and args[14] == code


# --------------------------------------------------------------------------
# The bf16 kernel's tile walk, emulated in plain PyTorch
# --------------------------------------------------------------------------
ROWS = 64                                # query rows a block: 4 warps x 16
KEY_TILE = {64: 64, 128: 64, 256: 32}    # keys a tile, by head-dim class
# chip_smoke.py's FLASH_GRID, its FLASH_RAGGED (with their kv_len), and
# windows narrower than a key tile, so that the window's lower edge and
# the diagonal fall in one tile: (B, Sq, Skv, Hq, Hkv, D, causal, window),
# kv_len
WALK_CASES = [(c, None) for c in FLASH_GRID] + [
    ((2, 100, 100, 4, 1, 16, True, 32), None),
    ((1, 77, 203, 6, 2, 32, False, 0), 150),
    ((1, 97, 150, 3, 1, 36, True, 24), 121),
    ((1, 192, 192, 2, 1, 64, True, 16), None),
    ((1, 100, 100, 2, 1, 256, True, 24), None),
]


def _emulate_tile_walk(q, k, v, *, causal, window, kv_len, scale):
    """What the bf16 kernel computes, in its order: blocks take query
    tiles of ROWS rows from the last to the first (heads innermost); a
    block walks the key tiles that hold keys from max(0, q0 - window + 1)
    to kv_len (to q0 + ROWS under the causal mask); rows past Sq, keys
    past kv_len and columns past d are zeros; only the tiles that cross a
    boundary are masked (an interior tile is checked to need no mask);
    scores are scaled by scale * log2(e) and exponentiated with exp2; a
    warp's rescale by exp2(m_old - m_new) is 1 where no max moved; P
    enters P V as two bf16 terms, hi = bf16(p) and lo = bf16(p - hi),
    while l sums the fp32 p; o = acc * (1 / max(l, 1e-30)), rounded to
    bf16."""
    BHq, Sq, d = q.shape
    BHkv, Skv, _ = k.shape
    group = BHq // BHkv
    D = 64 if d <= 64 else 128 if d <= 128 else 256
    kk = KEY_TILE[D]
    n_q = -(-Sq // ROWS)
    n_k = -(-kv_len // kk)
    qz = torch.zeros((BHq, n_q * ROWS, D))
    qz[:, :Sq, :d] = q.float()
    kz, vz = torch.zeros((BHkv, n_k * kk, D)), torch.zeros((BHkv, n_k * kk, D))
    kz[:, :kv_len, :d] = k[:, :kv_len].float()
    vz[:, :kv_len, :d] = v[:, :kv_len].float()
    scale_log2 = torch.tensor(scale, dtype=torch.float32) * torch.tensor(
        math.log2(math.e), dtype=torch.float32)
    o = torch.empty((BHq, Sq, d), dtype=torch.bfloat16)
    visited = []
    for block in range(BHq * n_q):
        bh, q0 = block % BHq, (n_q - 1 - block // BHq) * ROWS
        visited.append((bh, q0))
        k_hi = min(kv_len, q0 + ROWS) if causal else kv_len
        k_lo = max(0, q0 - window + 1) if window > 0 else 0
        rows = q0 + torch.arange(ROWS)[:, None]
        m = torch.full((ROWS,), -math.inf)
        l, acc = torch.zeros(ROWS), torch.zeros((ROWS, D))
        for t in range(k_lo // kk, -(-k_hi // kk)):
            k0 = t * kk
            kt = kz[bh // group, k0:k0 + kk]
            vt = vz[bh // group, k0:k0 + kk]
            s = (qz[bh, q0:q0 + ROWS] @ kt.T) * scale_log2
            keys = k0 + torch.arange(kk)[None, :]
            keep = keys < kv_len
            if causal:
                keep = keep & (keys <= rows)
            if window > 0:
                keep = keep & (keys > rows - window)
            edge = ((causal and k0 + kk - 1 > q0)
                    or (window > 0 and k0 <= q0 + ROWS - 1 - window)
                    or k0 + kk > kv_len)
            if edge:
                s = torch.where(keep, s, -math.inf)
            else:
                assert bool(keep.all()), (bh, q0, k0)
            mx = torch.maximum(m, s.max(dim=1).values)
            base = torch.where(mx == -math.inf, 0.0, mx)
            corr = torch.exp2(m - base)
            p = torch.exp2(s - base[:, None])
            l = l * corr + p.sum(dim=1)
            hi = p.bfloat16().float()
            lo = (p - hi).bfloat16().float()
            acc = acc * corr[:, None] + hi @ vt + lo @ vt
            m = mx
        out = acc * (1 / torch.clamp(l, min=1e-30))[:, None]
        n = min(ROWS, Sq - q0)
        o[bh, q0:q0 + n] = out[:n, :d].bfloat16()
    assert sorted(visited) == sorted(
        (bh, t * ROWS) for bh in range(BHq) for t in range(n_q))
    assert visited[0][1] == (n_q - 1) * ROWS     # the last tile first
    return o


@pytest.mark.parametrize("case,kv_len", WALK_CASES)
def test_tile_walk_matches_the_plain_version_and_pallas(case, kv_len):
    """At the bf16 tolerance of chip_smoke.py (atol 2e-3 + rtol 2e-2),
    against the port's plain version and the reference's Pallas kernel in
    interpret mode."""
    B, Sq, Skv, Hq, Hkv, D, causal, window = case
    rng = np.random.default_rng(40)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).bfloat16() for shape in ((B * Hq, Sq, D),
                                              (B * Hkv, Skv, D),
                                              (B * Hkv, Skv, D)))
    got = _emulate_tile_walk(q, k, v, causal=causal, window=window,
                             kv_len=Skv if kv_len is None else kv_len,
                             scale=D ** -0.5)
    plain = fa.flash_attention_ref(q, k, v, causal=causal, window=window,
                                   kv_len=kv_len)
    qj, kj, vj = (jnp.asarray(t.float().numpy(), jnp.bfloat16)
                  for t in (q, k, v))
    pallas = ref_flash.flash_attention(
        qj, kj, vj, causal=causal, window=window, kv_len=kv_len,
        bq=128 if Sq % 128 == 0 else Sq, bk=128 if Skv % 128 == 0 else Skv,
        interpret=True)
    for want in (plain.float().numpy(), np.asarray(pallas, np.float32)):
        np.testing.assert_allclose(got.float().numpy(), want, atol=2e-3,
                                   rtol=2e-2)


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
