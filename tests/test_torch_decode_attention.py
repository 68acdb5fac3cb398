"""Port parity: decode attention.  The decode kernel's plain PyTorch
version against the reference's ``ops.decode_attention`` (its Pallas
kernel in interpret mode) and its jnp oracle, and the model-layout
wrapper on views of a cache, on the same numpy inputs.

Tolerances: fp32 5e-6 (as ``tests/test_kernels.py`` holds the Pallas
kernel; the two sides sum in another order), bf16 2e-2 (one bf16
rounding of outputs up to ~3).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_oracle
from repro_torch.kernels import _build, ops
from repro_torch.kernels import decode_attention as dec

# The tensors here are small: one thread each, or the test workers that
# share a machine fight over cores inside PyTorch's thread pool.
torch.set_num_threads(1)

TOL = {"float32": 5e-6, "bfloat16": 2e-2}

# the reference's grid (tests/test_kernels.py), then Qwen2-7B's group of
# 7 at head_dim 128 and RecurrentGemma-9B's head_dim 256
CASES = [
    (4, 512, 8, 2, 64), (2, 384, 4, 4, 128), (3, 512, 16, 1, 80),
    (2, 96, 28, 4, 128), (2, 64, 16, 1, 256),
]


def _pair(x, dtype):
    """The same values on both sides: a jnp array and a torch tensor."""
    j = jnp.asarray(x, getattr(jnp, dtype))
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        getattr(torch, dtype))
    return j, t


def _inputs(seed, B, Skv, Hq, Hkv, D, dtype):
    rng = np.random.default_rng(seed)
    q, k, v = (_pair(rng.standard_normal(shape).astype(np.float32), dtype)
               for shape in ((B, 1, Hq, D), (B, Skv, Hkv, D),
                             (B, Skv, Hkv, D)))
    lens = rng.integers(1, Skv, size=B).astype(np.int32)
    return q, k, v, lens


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("B,Skv,Hq,Hkv,D", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_matches_pallas(B, Skv, Hq, Hkv, D, dtype):
    """Ragged lengths, model layout: the port's wrapper against the
    reference's Pallas kernel (interpret mode)."""
    (qj, qt), (kj, kt), (vj, vt), lens = _inputs(0, B, Skv, Hq, Hkv, D,
                                                 dtype)
    want = ref_ops.decode_attention(qj, kj, vj, jnp.asarray(lens), bk=128)
    got = ops.decode_attention(qt, kt, vt, torch.from_numpy(lens))
    assert got.shape == (B, 1, Hq, D) and got.dtype == qt.dtype
    _close(got, want, dtype)


@pytest.mark.parametrize("B,Skv,Hq,Hkv,D", CASES[:3])
def test_plain_version_matches_the_oracle(B, Skv, Hq, Hkv, D):
    """The reference's own layout, q (BHkv, G, d), k and v (BHkv, Skv, d),
    lengths (BHkv, 1), against ``ref.decode_attention_ref``."""
    G = Hq // Hkv
    rng = np.random.default_rng(1)
    q = rng.standard_normal((B * Hkv, G, D)).astype(np.float32)
    k = rng.standard_normal((B * Hkv, Skv, D)).astype(np.float32)
    v = rng.standard_normal((B * Hkv, Skv, D)).astype(np.float32)
    lens = rng.integers(1, Skv + 1, size=(B * Hkv, 1)).astype(np.int32)
    want = ref_oracle.decode_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                           jnp.asarray(v), jnp.asarray(lens))
    got = dec.decode_attention_ref(*map(torch.from_numpy, (q, k, v, lens)))
    _close(got, want, "float32")


@pytest.mark.parametrize("lo,hi", [(0, 1), (0, 96), (37, 90), (95, 96)])
def test_wrapper_on_a_view_equals_a_copy(lo, hi):
    """A narrowed view ``cache[:, lo:hi]`` (length 1, the whole cache, a
    window inside it, the last row) gives what its contiguous copy
    gives, lengths being the view's length."""
    (_, q), (_, k), (_, v), _ = _inputs(2, 2, 96, 28, 4, 128, "float32")
    lens = torch.full((2,), hi - lo, dtype=torch.int32)
    view = ops.decode_attention(q, k[:, lo:hi], v[:, lo:hi], lens)
    copy = ops.decode_attention(q, k[:, lo:hi].contiguous(),
                                v[:, lo:hi].contiguous(), lens)
    assert torch.equal(view, copy)


def test_lengths_mask_the_keys_past_them():
    """Keys at or past a sequence's length do not matter: changing them
    changes nothing."""
    (_, q), (_, k), (_, v), _ = _inputs(3, 3, 64, 8, 2, 64, "float32")
    lens = torch.tensor([1, 17, 64], dtype=torch.int32)
    want = ops.decode_attention(q, k, v, lens)
    k2, v2 = k.clone(), v.clone()
    for b, n in enumerate(lens.tolist()):
        k2[b, n:] = 1e3
        v2[b, n:] = -1e3
    assert torch.equal(ops.decode_attention(q, k2, v2, lens), want)


def test_cpu_tensors_never_touch_the_kernel(monkeypatch):
    def no_library():
        raise AssertionError("the CUDA library was asked for on the CPU")
    monkeypatch.setattr(_build, "load_library", no_library)
    before = dec.launch_count
    (_, q), (_, k), (_, v), lens = _inputs(4, 2, 32, 4, 1, 16, "float32")
    ops.decode_attention(q, k, v, torch.from_numpy(lens))
    assert dec.launch_count == before


def test_split_plan_covers_the_cache():
    """A tile for each warp a split, every key in exactly one split, no split
    past the cache, and about four blocks an SM at the path's shape."""
    for bh, skv in ((32, 4160), (1, 2048), (1, 1), (3, 513), (600, 40)):
        chunk, n = dec.split_plan(bh, skv)
        assert chunk % (dec.WARPS * dec.KEYS_PER_TILE) == 0
        assert chunk * (n - 1) < skv <= chunk * n
    assert dec.split_plan(32, 4160) == (256, 17)


def _bad(case):
    """Tensors the kernel does not take, and what the wrapper says."""
    q = torch.zeros((2, 8, 64))
    k = torch.zeros((2, 32, 2, 64))
    lens = torch.ones(2, dtype=torch.int32)
    if case == "dtype":
        return (q.half(), k.half(), k.half(), lens), "float32"
    if case == "mixed":
        return (q, k.bfloat16(), k.bfloat16(), lens), "float32"
    if case == "head_dim":
        return ((torch.zeros((2, 8, 60)), torch.zeros((2, 32, 2, 60)),
                 torch.zeros((2, 32, 2, 60)), lens), "multiple of 8")
    if case == "group":
        return ((torch.zeros((2, 34, 64)), k, k, lens), "at most 16")
    if case == "heads":
        return (torch.zeros((2, 7, 64)), k, k, lens), "does not match"
    if case == "lengths":
        return (q, k, k, lens.long()), "int32"
    if case == "layout":
        # (B, Skv, Hkv, d) with head_dim not contiguous
        kt = torch.zeros((2, 32, 64, 2)).transpose(2, 3)
        return (q, kt, kt, lens), "head_dim contiguous"
    raise ValueError(case)


@pytest.mark.parametrize("case", ["dtype", "mixed", "head_dim", "group",
                                  "heads", "lengths", "layout"])
def test_wrapper_refuses_what_the_kernel_does_not_take(case):
    args, msg = _bad(case)
    with pytest.raises((ValueError, TypeError), match=msg):
        dec._check(*args)


# --------------------------------------------------------------------------
# The bf16 kernel's walk over the cache, emulated in plain PyTorch
# --------------------------------------------------------------------------
ROWS = 16                                # query-head rows of an mma tile
# chip_smoke.py's DECODE_GRID: (B, Skv, Hq, Hkv, D)
WALK_CASES = [(4, 512, 8, 2, 64), (2, 384, 4, 4, 128), (3, 512, 16, 1, 80),
              (2, 1000, 28, 4, 128), (1, 2100, 16, 1, 256)]


def _emulate_split_walk(q, k, v, lens):
    """What the bf16 kernel computes, in its order: split_plan cuts each
    (sequence, kv head)'s keys into splits; a split wholly past the
    length is skipped; each of the WARPS warps of a split walks its own
    run of chunk / WARPS keys in tiles of KEYS_PER_TILE keys (keys past
    the run are zeros, masked to -inf) with its own running max m, sum l
    and accumulator; the G query heads are the first of 16 rows, the
    rest zero; S = Q K^T takes bf16 values with fp32 sums, scaled by
    scale * log2(e), and P = exp2(S - m) enters P V as hi = bf16(p) and
    lo = bf16(p - hi); the warps merge with weights exp2(m_w - M), the
    splits likewise, o = acc / max(l, 1e-30) rounded to bf16.  Returns o
    and what the walk met: warps without keys, splits past the length."""
    B, Skv, Hkv, D = k.shape
    G = q.shape[1] // Hkv
    chunk, n_splits = dec.split_plan(B * Hkv, Skv)
    run, tile = chunk // dec.WARPS, dec.KEYS_PER_TILE
    scale_log2 = torch.tensor(D ** -0.5, dtype=torch.float32) * torch.tensor(
        math.log2(math.e), dtype=torch.float32)
    o = torch.empty(q.shape, dtype=torch.bfloat16)
    met = {"idle_warps": 0, "splits_past_length": 0}
    for b in range(B):
        length = min(int(lens[b]), Skv)
        for h in range(Hkv):
            q16 = torch.zeros((ROWS, D))
            q16[:G] = q[b, h * G:(h + 1) * G].float()
            parts = []
            for split in range(n_splits):
                k_begin, k_end = split * chunk, min((split + 1) * chunk,
                                                    length)
                if k_begin >= k_end:
                    met["splits_past_length"] += 1
                    continue
                warps = []
                for w in range(dec.WARPS):
                    w_begin = k_begin + w * run
                    w_end = min(w_begin + run, k_end)
                    m = torch.full((ROWS,), -math.inf)
                    l, acc = torch.zeros(ROWS), torch.zeros((ROWS, D))
                    met["idle_warps"] += w_begin >= w_end
                    for t0 in range(w_begin, w_end, tile):
                        n = min(tile, w_end - t0)
                        kt, vt = torch.zeros((tile, D)), torch.zeros((tile, D))
                        kt[:n] = k[b, t0:t0 + n, h].float()
                        vt[:n] = v[b, t0:t0 + n, h].float()
                        s = torch.where(torch.arange(tile) < n,
                                        (q16 @ kt.T) * scale_log2, -math.inf)
                        mx = torch.maximum(m, s.max(dim=1).values)
                        corr = torch.exp2(m - mx)
                        p = torch.exp2(s - mx[:, None])
                        l = l * corr + p.sum(dim=1)
                        hi = p.bfloat16().float()
                        lo = (p - hi).bfloat16().float()
                        acc = acc * corr[:, None] + hi @ vt + lo @ vt
                        m = mx
                    warps.append((m, l, acc))
                M = torch.stack([w[0] for w in warps]).max(dim=0).values
                wt = [torch.exp2(w[0] - M) for w in warps]
                parts.append((M, sum(x * w[1] for x, w in zip(wt, warps)),
                              sum(x[:, None] * w[2]
                                  for x, w in zip(wt, warps))))
            M = torch.stack([p[0] for p in parts]).max(dim=0).values
            wt = [torch.exp2(p[0] - M) for p in parts]
            l = torch.clamp(sum(x * p[1] for x, p in zip(wt, parts)),
                            min=1e-30)
            acc = sum(x[:, None] * p[2] for x, p in zip(wt, parts))
            o[b, h * G:(h + 1) * G] = (acc / l[:, None])[:G].bfloat16()
    return o, met


@pytest.mark.parametrize("B,Skv,Hq,Hkv,D", WALK_CASES)
def test_split_walk_matches_the_plain_version_and_pallas(B, Skv, Hq, Hkv,
                                                          D):
    """Ragged lengths, one of them (5) shorter than a warp's run, so that
    warps find no keys and whole splits lie past the length: at
    chip_smoke.py's bf16 tolerance (atol 2e-3 + rtol 2e-2) against the
    port's plain version and the reference's Pallas kernel in interpret
    mode."""
    (qj, qt), (kj, kt), (vj, vt), lens = _inputs(50, B, Skv, Hq, Hkv, D,
                                                 "bfloat16")
    lens[0] = 5
    got, met = _emulate_split_walk(qt[:, 0], kt, vt, lens)
    assert met["idle_warps"] > 0 and met["splits_past_length"] > 0
    plain = dec.decode_attention_ref(qt[:, 0], kt, vt, torch.from_numpy(lens))
    pallas = ref_ops.decode_attention(qj, kj, vj, jnp.asarray(lens), bk=128)
    for want in (plain.float().numpy(), np.asarray(pallas[:, 0], np.float32)):
        np.testing.assert_allclose(got.float().numpy(), want, atol=2e-3,
                                   rtol=2e-2)
