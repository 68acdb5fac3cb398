// Prefill flash attention (online softmax), for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel
// repro/kernels/flash_attention.py::flash_attention (body _kernel).  In
// the kernel layout, with head minor in the folded leading dimension:
//     q (BHq, Sq, d), k and v (BHkv, Skv, d), o (BHq, Sq, d) in q's type,
//     kv head of q head bh = bh / (BHq / BHkv)          (GQA / MQA)
//     s = (q . k) * scale, masked where k_pos >= kv_len, or (causal)
//         k_pos > q_pos, or (window) k_pos <= q_pos - window
//     o = sum_k softmax(s)_k v_k, with running max m, sum l and
//         accumulator acc in fp32, o = acc / max(l, 1e-30);
//     on request (a non-null lse), the row log-sum-exp
//         lse (BHq, Sq) fp32 = m + log(max(l, 1e-30)),
//     the residual of the backward pass, which recomputes p as
//     exp(s - lse) (kernels/flash_attention.py::flash_attention_bwd).
//     The bf16 kernel writes it from separate instantiations (kLse), at
//     d <= 128 only: at d = 256 the kernel holds 255 registers, and the
//     lse's epilogue made it spill 16 bytes (NVIDIA H100, nvcc 12.9), so
//     the entry refuses an lse there and the wrapper refuses autograd.
//
// Bound: operations.  At the serving path's shape (64 q heads x 4096
// rows, d = 256, causal, window 2048) the work is 4 * d * sum_q min(q+1,
// 2048) per head, 0.41 TFLOP a layer, against 0.29 GB of q, k, v and o:
// about 1,400 operations a byte, far above the card's 295 for bf16.  So
// both products belong on the tensor cores, and the design is about
// feeding them.  One C entry, two kernels chosen by dtype:
//
// bf16 -- tensor cores, FlashAttention-2's shape.  One block of 4 warps
// per (q head, tile of 64 query rows); each warp owns 16 rows.
//   * Copies: Q once, then K and V tiles, global -> shared with cp.async
//     (16 bytes, or two of 8 where a row of d bf16 is not a multiple of
//     16 bytes) into a ring of two stages, so that tile n+1's copy runs
//     under tile n's products.  Rows past the end and columns past d are
//     zero-filled by cp.async's src-size operand: ragged Sq, Skv, kv_len
//     and d need no padding.  Shared memory is swizzled (16-byte chunk c
//     of row r sits at chunk c ^ (r & 7)), so the eight rows an ldmatrix
//     reads fall in eight bank groups.
//   * Products: S = Q K^T and O += P V on mma.sync m16n8k16 (bf16 in,
//     fp32 accumulate), fragments from ldmatrix (Q, K) and ldmatrix.trans
//     (V).  Q stays in shared memory and its fragments are loaded at
//     every step of k: at d = 256 the fp32 O accumulator alone takes 128
//     registers a thread, and at d <= 128 Q in registers was no faster.
//   * Registers: every ldmatrix address is a per-lane register XOR a
//     constant plus an immediate, a tile's copies share one index
//     computation for K and V, and the mask tests compare constants with
//     three per-tile values, so that at d = 256 the kernel fits 255
//     registers without spilling.
//   * Softmax: online, in registers, on the accumulator fragments.  A
//     row's max and sum are two quad shuffles each; scale * log2(e) is
//     one multiply and the exponential the SFU's ex2; m, l and O stay
//     fp32; a warp skips rescaling O when no row's max moved.  P is
//     rounded to bf16 in registers and used as it lies as the A operand
//     of P V (m16n8k16's C fragment is laid out as its A fragment), never
//     through shared memory.  This is a deliberate difference from the
//     reference, which computes P V in fp32.  One rounding of P would
//     move an output by up to 2^-8 of the mean |v| it averages, past the
//     bf16 tolerance where outputs cancel to near zero; so P goes in as
//     two bf16 terms, hi = bf16(p) and lo = bf16(p - hi), each a product
//     with the same V fragments: ~16 bits of P, for half again the
//     tensor-core work and no more shared-memory reads.  The epilogue
//     writes o = acc * (1 / max(l, 1e-30)) as bf16.
//   * Masks: the block walks key tiles from max(0, q0 - window + 1) to
//     kv_len, or to q0 + 64 under the causal mask, so wholly masked
//     tiles are never loaded; only the tiles that cross a boundary (the
//     diagonal, the window's lower edge, the last tile under kv_len)
//     test each element.  A query row that no key may see (only kv_len
//     or a window with Sq > Skv leave one) gets o = 0.
//   * Order: under a causal mask the last query tiles do the most work,
//     so blocks take the query tiles from the last to the first.
//   * Tiles: 64 keys at d <= 64 and d <= 128, 32 at d <= 256;
//     (64 + 4 keys) * D * 2 bytes of shared memory (40, 80, 96 KB), two
//     blocks (8 warps) an SM at d = 128 and 256, three at d = 64.
//
// fp32 -- CUDA cores, every product and sum in fp32 (tensor cores
// cannot hold fp32's 5e-6 tolerance).  One block of 256 threads per (q
// head, 64 rows); four neighbouring threads share a query row, each
// holding a quarter of its columns for q and the accumulator in
// registers.  K and V tiles of kKeys rows are staged in shared memory;
// a score is the four partial dots summed by two shuffles.  expf, IEEE
// division: within 5e-6 of the plain fp32 version.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "mma_common.cuh"

namespace {

// ------------------------------------------------------------------------
// bf16: tensor cores
// ------------------------------------------------------------------------
namespace tc {

using namespace tc_common;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;             // query rows a block

// D is the head-dim class (d <= D): 64, 128 or 256
template <int D>
__host__ __device__ constexpr int key_tile() { return D == 256 ? 32 : 64; }

template <int D>
__host__ __device__ constexpr size_t smem_bytes() {   // Q, 2 stages of K, V
  return static_cast<size_t>(kRows + 4 * key_tile<D>()) * D * 2;
}

// Rows [row0, row0 + ROWS) of the (., d) bf16 matrices at each g[i] into
// the swizzled [ROWS][D] tiles at dst[i] (Q alone, or K and V together);
// rows at or past row_end and columns at or past d are zero-filled.
// Every thread of the block takes part: kTpr threads share a row, so a
// pass covers 8 or 16 rows, all of a thread's rows have one r & 7, and
// its addresses differ by immediates.  A 16-byte chunk is one copy, or two
// of 8 bytes where a row of d bf16 is not a multiple of 16 bytes.
template <int D, int ROWS, int N>
__device__ __forceinline__ void load_rows(const uint32_t (&dst)[N],
                                          const __nv_bfloat16* const (&g)[N],
                                          int row0, int row_end, int d,
                                          bool vec16) {
  constexpr int kChunks = D / 8;
  constexpr int kTpr = kChunks < 16 ? kChunks : 16;     // threads a row
  constexpr int kRp = kThreads / kTpr;                  // rows a pass
  static_assert(ROWS % kRp == 0 && kRp % 8 == 0, "whole passes");
  const int rr = threadIdx.x / kTpr, cc = threadIdx.x % kTpr;
  const uint32_t s0 = rr * (D * 2) + ((cc ^ (rr & 7)) << 4);
#pragma unroll
  for (int it = 0; it < ROWS / kRp; ++it) {
    const int r = row0 + rr + it * kRp;
    const long long off = static_cast<long long>(r) * d + cc * 8;
#pragma unroll
    for (int u = 0; u < kChunks / kTpr; ++u) {
      const int c8 = (cc + u * kTpr) * 8;      // the chunk's first column
      const bool ok = r < row_end && c8 < d, ok_hi = ok && c8 + 4 < d;
      const uint32_t so = s0 + it * kRp * (D * 2) + u * kTpr * 16;
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const __nv_bfloat16* src = g[i] + off + u * kTpr * 8;
        if (vec16) {
          cp_async16(dst[i] + so, ok ? src : g[i], ok ? 16 : 0);
        } else {
          cp_async8(dst[i] + so, ok ? src : g[i], ok ? 8 : 0);
          cp_async8(dst[i] + so + 8, ok_hi ? src + 4 : g[i], ok_hi ? 8 : 0);
        }
      }
    }
  }
}

template <int D, bool kLse>
__global__ void __launch_bounds__(kThreads, 2)
flash_attention_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v,
                            __nv_bfloat16* __restrict__ o,
                            float* __restrict__ lse, int BHq,
                            int n_qtiles, int group, int Sq, int Skv, int d,
                            int kv_len, int causal, int window,
                            float scale_log2) {
  constexpr int kKeys = key_tile<D>();         // keys a tile
  constexpr int KD = D / 16;                   // k-steps of Q K^T
  constexpr int NS = kKeys / 8;                // n-tiles of S
  constexpr int KP = kKeys / 16;               // k-steps of P V
  constexpr int NO = D / 8;                    // n-tiles of O
  constexpr uint32_t kRowBytes = D * 2;
  constexpr uint32_t kTile = kKeys * kRowBytes;   // bytes of a K or V tile

  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sQ = smem_addr(smem);         // [kRows][D]
  const uint32_t sKV = sQ + kRows * kRowBytes; // stage s: K, then V

  // query tiles from the last to the first; heads innermost
  const int bh = blockIdx.x % BHq;
  const int q0 = (n_qtiles - 1 - static_cast<int>(blockIdx.x) / BHq) * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wrow = 16 * warp;                  // the warp's rows in the tile
  const int row = q0 + wrow + (lane >> 2);     // this thread's rows: row, +8
  const bool vec16 = (d & 7) == 0;

  const __nv_bfloat16* qg = q + static_cast<long long>(bh) * Sq * d;
  const long long kv_off = static_cast<long long>(bh / group) * Skv * d;
  const __nv_bfloat16* kg = k + kv_off;
  const __nv_bfloat16* vg = v + kv_off;

  // key tiles this block can see
  int k_hi = kv_len;
  if (causal) k_hi = min(k_hi, q0 + kRows);
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_lo = k_lo / kKeys;
  const int t_hi = (k_hi + kKeys - 1) / kKeys;

  load_rows<D, kRows, 1>({sQ}, {qg}, q0, Sq, d, vec16);
  if (t_lo < t_hi)
    load_rows<D, kKeys, 2>({sKV, sKV + kTile}, {kg, vg}, t_lo * kKeys,
                           kv_len, d, vec16);
  cp_async_commit();

  // ldmatrix addresses.  Each lane names one 16-byte row of an 8x8
  // matrix: rows of 128-byte-aligned tiles, where chunk c of row r sits
  // at chunk c ^ (r & 7).  Every row a lane names has r & 7 = lane & 7,
  // and its chunk is 2i + h for step i and a bit h of the lane, so the
  // chunk's byte offset is (row | ((h ^ (lane & 7)) << 4)) ^ (2 (i & 3)
  // << 4), plus 128 (i >> 2): one register a lane and operand, an XOR
  // and an immediate a step.
  //   Q (A, x4):   row wrow + (lane & 15), h = lane >> 4
  //   K (B, x4):   row 16j + (lane & 7) + 8 (lane >> 4 & 1), h = lane >> 3 & 1
  //   V (B, x4.t): row 16kp + (lane & 7) + 8 (lane >> 3 & 1), h = lane >> 4
  const int x = lane & 7;
  const uint32_t q_lane = ((wrow + (lane & 15)) * kRowBytes) |
                          (((lane >> 4) ^ x) << 4);
  const uint32_t k_lane = ((x + (((lane >> 4) & 1) << 3)) * kRowBytes) |
                          ((((lane >> 3) & 1) ^ x) << 4);
  const uint32_t v_lane = ((x + (((lane >> 3) & 1) << 3)) * kRowBytes) |
                          (((lane >> 4) ^ x) << 4);

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  // running max (in units of scale_log2 * s) and this thread's part of
  // the running sum, for rows `row` and `row + 8`
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int t = t_lo; t < t_hi; ++t) {
    const uint32_t sK = sKV + ((t - t_lo) & 1) * 2 * kTile;
    const uint32_t sV = sK + kTile;
    if (t + 1 < t_hi) {                        // tile t+1 into the other stage
      const uint32_t nK = sKV + ((t + 1 - t_lo) & 1) * 2 * kTile;
      load_rows<D, kKeys, 2>({nK, nK + kTile}, {kg, vg}, (t + 1) * kKeys,
                             kv_len, d, vec16);
    }
    cp_async_commit();
    cp_async_wait<1>();                        // tile t (and Q) has landed
    __syncthreads();

    // S = Q K^T: the warp's rows x kKeys keys (columns past d are zero
    // on both sides, so every k-step of the class runs)
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      const uint32_t flip = (2 * (kk & 3)) << 4, col = 128 * (kk >> 2);
      uint32_t a[4];
      ldsm_x4(a, sQ + ((q_lane ^ flip) + col));
#pragma unroll
      for (int j = 0; j < NS / 2; ++j) {
        uint32_t b[4];                       // keys 16j..16j+15
        ldsm_x4(b, sK + 16 * j * kRowBytes + ((k_lane ^ flip) + col));
        mma(s[2 * j], a, b[0], b[1]);
        mma(s[2 * j + 1], a, b[2], b[3]);
      }
    }

#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] *= scale_log2;
    const int k0 = t * kKeys;
    const bool edge = (causal && k0 + kKeys - 1 > q0) ||
                      (window > 0 && k0 <= q0 + kRows - 1 - window) ||
                      k0 + kKeys > kv_len;
    if (edge) {
      // element (j, e) pairs key kb + dk with row `row` + dq, dk = 8j +
      // (e & 1), dq = 8 (e >> 1): each test is a constant against a room
      const int kb = k0 + 2 * (lane & 3);
      const int len_room = kv_len - kb;      // keep dk < len_room
      const int causal_room = row - kb;      // keep dk - dq <= causal_room
      const int window_room = window - causal_room;  // dk - dq > -window_room
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int dk = 8 * j + (e & 1), dq = 8 * (e >> 1);
          bool keep = dk < len_room;
          if (causal) keep = keep && dk - dq <= causal_room;
          if (window > 0) keep = keep && dk - dq > -window_room;
          if (!keep) s[j][e] = -INFINITY;
        }
    }

    // online softmax on the fragments: a thread holds two columns of
    // each n-tile in rows `row` and `row + 8`; the quad holds the row
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
    }
    float base[2], corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      base[i] = mx[i] == -INFINITY ? 0.f : mx[i];  // a row with no key yet
      corr[i] = exp2_sfu(m[i] - base[i]);
    }
    // corr is exactly 1 where the max did not move: the warp skips the
    // rescale when that holds for all its rows
    if (!__all_sync(0xffffffffu, mx[0] == m[0] && mx[1] == m[1])) {
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        acc[n][0] *= corr[0]; acc[n][1] *= corr[0];
        acc[n][2] *= corr[1]; acc[n][3] *= corr[1];
      }
    }
    m[0] = mx[0];
    m[1] = mx[1];
    float rs[2] = {0.f, 0.f};

    // O += P V, 16 keys a k-step.  P goes in as the A fragment: n-tiles
    // 2kp and 2kp+1 of S are its first and second 8 keys.  It is split
    // into two bf16 terms, hi = bf16(p) and lo = bf16(p - hi), each a
    // product with the same V fragments, so that P V keeps ~16 bits of
    // P (one bf16 rounding would move an output by up to 2^-8 of the
    // mean |v| it averages, past the bf16 tolerance where outputs
    // cancel).
#pragma unroll
    for (int kp = 0; kp < KP; ++kp) {
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = 2 * kp + h;
        const float p0 = exp2_sfu(s[j][0] - base[0]);
        const float p1 = exp2_sfu(s[j][1] - base[0]);
        const float p2 = exp2_sfu(s[j][2] - base[1]);
        const float p3 = exp2_sfu(s[j][3] - base[1]);
        rs[0] += p0 + p1;
        rs[1] += p2 + p3;
        split_bf16(p0, p1, hi[2 * h], lo[2 * h]);
        split_bf16(p2, p3, hi[2 * h + 1], lo[2 * h + 1]);
      }
#pragma unroll
      for (int n = 0; n < NO / 2; ++n) {
        uint32_t b[4];                       // keys 16kp.., dims 16n..
        ldsm_x4_trans(b, sV + 16 * kp * kRowBytes +
                             ((v_lane ^ ((2 * (n & 3)) << 4)) +
                              128 * (n >> 2)));
        mma(acc[2 * n], hi, b[0], b[1]);
        mma(acc[2 * n + 1], hi, b[2], b[3]);
        mma(acc[2 * n], lo, b[0], b[1]);
        mma(acc[2 * n + 1], lo, b[2], b[3]);
      }
    }
    l[0] = l[0] * corr[0] + rs[0];
    l[1] = l[1] * corr[1] + rs[1];
    __syncthreads();                           // the stage may be refilled
  }

  // epilogue: o = acc / max(l, 1e-30) as bf16 (one reciprocal a row),
  // staged through the warp's own rows of the Q tile, then 16 (or 8)
  // bytes a lane to memory
  cp_async_wait<0>();
  __syncthreads();                             // every copy into Q has landed
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    inv[i] = __frcp_rn(fmaxf(l[i], 1e-30f));
    // lse in natural units: m counts in units of log2(e) * scale * s; a
    // row no key may see (m = -inf, o = 0) gets log(1e-30), so that the
    // backward's exp(s - lse) is 0 on its masked scores
    if constexpr (kLse) {
      if ((lane & 3) == 0 && row + 8 * i < Sq) {
        const float mb = m[i] == -INFINITY ? 0.f : m[i];
        lse[static_cast<long long>(bh) * Sq + row + 8 * i] =
            (mb + log2f(fmaxf(l[i], 1e-30f))) * 0.6931471805599453f;
      }
    }
  }
  const int r_lo = wrow + (lane >> 2);
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int b = 4 * (lane & 3);
    *reinterpret_cast<uint32_t*>(smem + swz<D>(r_lo, n) + b) =
        pack_bf16(acc[n][0] * inv[0], acc[n][1] * inv[0]);
    *reinterpret_cast<uint32_t*>(smem + swz<D>(r_lo + 8, n) + b) =
        pack_bf16(acc[n][2] * inv[1], acc[n][3] * inv[1]);
  }
  __syncwarp();
  __nv_bfloat16* og = o + static_cast<long long>(bh) * Sq * d;
  if (vec16) {
    constexpr int kChunks = D / 8;
#pragma unroll
    for (int i = lane; i < 16 * kChunks; i += 32) {
      const int r = i / kChunks, c = i % kChunks;
      const int qr = q0 + wrow + r;
      if (qr < Sq && c * 8 < d)
        *reinterpret_cast<uint4*>(og + static_cast<long long>(qr) * d + c * 8) =
            *reinterpret_cast<const uint4*>(smem + swz<D>(wrow + r, c));
    }
  } else {
    constexpr int kUnits = D / 4;
#pragma unroll
    for (int i = lane; i < 16 * kUnits; i += 32) {
      const int r = i / kUnits, u = i % kUnits;
      const int qr = q0 + wrow + r;
      if (qr < Sq && u * 4 < d)
        *reinterpret_cast<uint2*>(og + static_cast<long long>(qr) * d + u * 4) =
            *reinterpret_cast<const uint2*>(smem + swz<D>(wrow + r, u >> 1) +
                                            ((u & 1) << 3));
    }
  }
}

// Raise the instantiation's dynamic shared-memory limit, once a device.
template <int D, bool kLse>
cudaError_t opt_in() {
  static unsigned long long done = 0;          // bit i: device i
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && (done >> dev & 1ULL)) return cudaSuccess;
  err = cudaFuncSetAttribute(flash_attention_kernel<D, kLse>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_bytes<D>()));
  if (err == cudaSuccess && dev < 64) done |= 1ULL << dev;
  return err;
}

template <int D, bool kLse>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, long long BHq, long long BHkv, long long Sq,
                   long long Skv, long long d, long long kv_len, int causal,
                   long long window, float scale, cudaStream_t stream) {
  const long long n_qtiles = (Sq + kRows - 1) / kRows;
  const long long blocks = BHq * n_qtiles;
  if (blocks > 2147483647LL || BHq > 2147483647LL)
    return cudaErrorInvalidValue;
  const cudaError_t err = opt_in<D, kLse>();
  if (err != cudaSuccess) return err;
  // a window of Sq or more masks nothing, as no window does; the clamp
  // keeps the kernel's mask arithmetic inside int
  if (window > Sq) window = Sq;
  flash_attention_kernel<D, kLse>
      <<<static_cast<unsigned int>(blocks), kThreads, smem_bytes<D>(),
         stream>>>(
          static_cast<const __nv_bfloat16*>(q),
          static_cast<const __nv_bfloat16*>(k),
          static_cast<const __nv_bfloat16*>(v),
          static_cast<__nv_bfloat16*>(o), lse, static_cast<int>(BHq),
          static_cast<int>(n_qtiles), static_cast<int>(BHq / BHkv),
          static_cast<int>(Sq), static_cast<int>(Skv), static_cast<int>(d),
          static_cast<int>(kv_len), causal, static_cast<int>(window),
          scale * 1.4426950408889634f);
  return cudaGetLastError();
}

cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     float* lse, long long BHq, long long BHkv, long long Sq,
                     long long Skv, long long d, long long kv_len,
                     int causal, long long window, float scale,
                     cudaStream_t stream) {
  if (lse != nullptr) {            // d > 128 has no lse instantiation
    if (d <= 64)
      return launch<64, true>(q, k, v, o, lse, BHq, BHkv, Sq, Skv, d, kv_len,
                              causal, window, scale, stream);
    if (d <= 128)
      return launch<128, true>(q, k, v, o, lse, BHq, BHkv, Sq, Skv, d,
                               kv_len, causal, window, scale, stream);
    return cudaErrorInvalidValue;
  }
  if (d <= 64)
    return launch<64, false>(q, k, v, o, lse, BHq, BHkv, Sq, Skv, d, kv_len,
                             causal, window, scale, stream);
  if (d <= 128)
    return launch<128, false>(q, k, v, o, lse, BHq, BHkv, Sq, Skv, d, kv_len,
                              causal, window, scale, stream);
  return launch<256, false>(q, k, v, o, lse, BHq, BHkv, Sq, Skv, d, kv_len,
                            causal, window, scale, stream);
}

template <int D>
cudaError_t occupancy(int* smem, int* blocks_per_sm, int* threads) {
  cudaError_t err = opt_in<D, false>();
  if (err != cudaSuccess) return err;
  *smem = static_cast<int>(smem_bytes<D>());
  *threads = kThreads;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, flash_attention_kernel<D, false>, kThreads,
      smem_bytes<D>());
}

}  // namespace tc

// ------------------------------------------------------------------------
// fp32: CUDA cores
// ------------------------------------------------------------------------
namespace cc {

constexpr int kThreads = 256;
constexpr int kLanes = 4;                        // threads a query row
constexpr int kRows = kThreads / kLanes;         // query rows a block
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// NJ float4 groups a thread: head_dim up to 16 * NJ.  kKeys keys a tile.
template <int NJ, int kKeys>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            float* __restrict__ o, float* __restrict__ lse,
                            int n_qblocks, int group,
                            int Sq, int Skv, int d, int kv_len, int causal,
                            int window, float scale) {
  extern __shared__ float4 smem[];
  float* ks = reinterpret_cast<float*>(smem);    // [kKeys][d]
  float* vs = ks + kKeys * d;                    // [kKeys][d]

  const int bh = blockIdx.x / n_qblocks;
  const int q0 = (blockIdx.x % n_qblocks) * kRows;
  const int tid = threadIdx.x;
  const int qi = q0 + tid / kLanes;              // this thread's query row
  const int lane = tid % kLanes;
  const bool row_ok = qi < Sq;
  const long long kv_base = static_cast<long long>(bh / group) * Skv * d;

  float4 qr[NJ], acc[NJ];
  const float* qrow =
      q + (static_cast<long long>(bh) * Sq + (row_ok ? qi : 0)) * d;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int c = 16 * j + 4 * lane;
    qr[j] = (row_ok && c < d) ? load4(qrow + c)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
    acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float m = kNegInf, l = 0.f;

  // keys this block of rows can see
  int k_hi = min(Skv, kv_len);
  if (causal) k_hi = min(k_hi, q0 + kRows);
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int d4 = d / 4;

  for (int k0 = (k_lo / kKeys) * kKeys; k0 < k_hi; k0 += kKeys) {
    __syncthreads();                             // last tile consumed
    for (int i = tid; i < kKeys * d4; i += kThreads) {
      const int kr = i / d4;
      const int c = (i - kr * d4) * 4;
      float4 kv4 = make_float4(0.f, 0.f, 0.f, 0.f), vv4 = kv4;
      if (k0 + kr < Skv) {
        const long long off =
            kv_base + static_cast<long long>(k0 + kr) * d + c;
        kv4 = load4(k + off);
        vv4 = load4(v + off);
      }
      *reinterpret_cast<float4*>(ks + kr * d + c) = kv4;
      *reinterpret_cast<float4*>(vs + kr * d + c) = vv4;
    }
    __syncthreads();

    float s[kKeys];
    float m_cur = kNegInf;
#pragma unroll
    for (int kr = 0; kr < kKeys; ++kr) {
      const float* krow = ks + kr * d;
      float part = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = 16 * j + 4 * lane;
        if (c < d)
          part = dot4(qr[j], *reinterpret_cast<const float4*>(krow + c),
                      part);
      }
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      const int kp = k0 + kr;
      bool keep = kp < kv_len && kp < Skv;
      if (causal) keep = keep && kp <= qi;
      if (window > 0) keep = keep && kp > qi - window;
      s[kr] = keep ? part * scale : kNegInf;
      m_cur = fmaxf(m_cur, s[kr]);
    }
    const float m_new = fmaxf(m, m_cur);
    const float corr = expf(m - m_new);
    float p_sum = 0.f;
#pragma unroll
    for (int kr = 0; kr < kKeys; ++kr) {
      s[kr] = expf(s[kr] - m_new);
      p_sum += s[kr];
    }
    l = l * corr + p_sum;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      acc[j].x *= corr; acc[j].y *= corr; acc[j].z *= corr; acc[j].w *= corr;
    }
#pragma unroll
    for (int kr = 0; kr < kKeys; ++kr) {
      const float* vrow = vs + kr * d;
      const float p = s[kr];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = 16 * j + 4 * lane;
        if (c < d) {
          const float4 vv = *reinterpret_cast<const float4*>(vrow + c);
          acc[j].x = fmaf(p, vv.x, acc[j].x);
          acc[j].y = fmaf(p, vv.y, acc[j].y);
          acc[j].z = fmaf(p, vv.z, acc[j].z);
          acc[j].w = fmaf(p, vv.w, acc[j].w);
        }
      }
    }
    m = m_new;
  }

  if (!row_ok) return;
  const float denom = fmaxf(l, 1e-30f);
  // the four threads of a row hold the same m and l
  if (lse != nullptr && lane == 0)
    lse[static_cast<long long>(bh) * Sq + qi] = m + logf(denom);
  float* orow = o + (static_cast<long long>(bh) * Sq + qi) * d;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int c = 16 * j + 4 * lane;
    if (c < d) {
      *reinterpret_cast<float4*>(orow + c) =
          make_float4(acc[j].x / denom, acc[j].y / denom, acc[j].z / denom,
                      acc[j].w / denom);
    }
  }
}

template <int NJ, int kKeys>
size_t smem_bytes(long long d) {
  return 2 * kKeys * static_cast<size_t>(d) * sizeof(float);
}

template <int NJ, int kKeys>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, long long BHq, long long BHkv, long long Sq,
                   long long Skv, long long d, long long kv_len, int causal,
                   long long window, float scale, cudaStream_t stream) {
  const long long n_qblocks = (Sq + kRows - 1) / kRows;
  const long long blocks = BHq * n_qblocks;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  flash_attention_kernel<NJ, kKeys>
      <<<static_cast<unsigned int>(blocks), kThreads,
         smem_bytes<NJ, kKeys>(d), stream>>>(
          static_cast<const float*>(q), static_cast<const float*>(k),
          static_cast<const float*>(v), static_cast<float*>(o), lse,
          static_cast<int>(n_qblocks), static_cast<int>(BHq / BHkv),
          static_cast<int>(Sq), static_cast<int>(Skv), static_cast<int>(d),
          static_cast<int>(kv_len), causal, static_cast<int>(window), scale);
  return cudaGetLastError();
}

cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     float* lse, long long BHq, long long BHkv, long long Sq,
                     long long Skv, long long d, long long kv_len,
                     int causal, long long window, float scale,
                     cudaStream_t stream) {
  if (d <= 64)
    return launch<4, 32>(q, k, v, o, lse, BHq, BHkv, Sq, Skv, d, kv_len, causal,
                         window, scale, stream);
  if (d <= 128)
    return launch<8, 32>(q, k, v, o, lse, BHq, BHkv, Sq, Skv, d, kv_len, causal,
                         window, scale, stream);
  return launch<16, 16>(q, k, v, o, lse, BHq, BHkv, Sq, Skv, d, kv_len, causal,
                        window, scale, stream);
}

template <int NJ, int kKeys>
cudaError_t occupancy(long long d, int* smem, int* blocks_per_sm,
                      int* threads) {
  *smem = static_cast<int>(smem_bytes<NJ, kKeys>(d));
  *threads = kThreads;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, flash_attention_kernel<NJ, kKeys>, kThreads,
      smem_bytes<NJ, kKeys>(d));
}

}  // namespace cc

bool shape_ok(long long BHq, long long BHkv, long long Sq, long long Skv,
              long long d, long long kv_len, long long window) {
  return BHq > 0 && BHkv > 0 && BHq % BHkv == 0 && Sq > 0 && Skv > 0 &&
         d > 0 && d <= 256 && d % 4 == 0 && kv_len > 0 && kv_len <= Skv &&
         window >= 0 && Sq <= 2147483647LL && Skv <= 2147483647LL &&
         window <= 2147483647LL;
}

}  // namespace

// q (BHq, Sq, d), k and v (BHkv, Skv, d) contiguous and 16-byte aligned,
// o (BHq, Sq, d) of the same type, lse (BHq, Sq) fp32 or null (not
// written; bf16 takes one at d <= 128 only); dtype 0 = fp32 (CUDA cores), 1 = bf16
// (tensor cores).  d is a multiple of 4 up to 256, BHq a multiple of
// BHkv, 0 < kv_len <= Skv, window 0 = none.  Enqueues one launch on
// `stream` and returns its cudaError_t (0 = success); does not
// synchronise.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, void* lse,
                                     long long BHq,
                                     long long BHkv, long long Sq,
                                     long long Skv, long long d,
                                     long long kv_len, int causal,
                                     long long window, float scale,
                                     int dtype, void* stream) {
  if (!shape_ok(BHq, BHkv, Sq, Skv, d, kv_len, window))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = cc::dispatch(q, k, v, o, static_cast<float*>(lse), BHq, BHkv,
                       Sq, Skv, d, kv_len, causal, window, scale, s);
  } else if (dtype == 1) {
    err = tc::dispatch(q, k, v, o, static_cast<float*>(lse), BHq, BHkv,
                       Sq, Skv, d, kv_len, causal, window, scale, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// The launch the entry above makes at head_dim d and dtype: its dynamic
// shared memory a block, its threads a block, and how many of its blocks
// one SM of the current device holds.  Returns a cudaError_t.
extern "C" int repro_flash_attention_occupancy(long long d, int dtype,
                                               int* smem_bytes,
                                               int* blocks_per_sm,
                                               int* threads) {
  if (d <= 0 || d > 256 || d % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (dtype == 0) {
    err = d <= 64    ? cc::occupancy<4, 32>(d, smem_bytes, blocks_per_sm,
                                            threads)
          : d <= 128 ? cc::occupancy<8, 32>(d, smem_bytes, blocks_per_sm,
                                            threads)
                     : cc::occupancy<16, 16>(d, smem_bytes, blocks_per_sm,
                                             threads);
  } else if (dtype == 1) {
    err = d <= 64    ? tc::occupancy<64>(smem_bytes, blocks_per_sm, threads)
          : d <= 128 ? tc::occupancy<128>(smem_bytes, blocks_per_sm, threads)
                     : tc::occupancy<256>(smem_bytes, blocks_per_sm,
                                          threads);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
