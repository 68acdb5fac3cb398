// Decode attention (flash-decoding), for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel
// repro/kernels/decode_attention.py::decode_attention (body _kernel).
// One new query token per sequence attends to its KV cache, read in the
// cache's own layout:
//     q (B, Hq, d) contiguous; k and v (B, Skv, Hkv, d) with d contiguous
//     and any batch, sequence and head strides (a narrowed view of a
//     longer cache is read in place); lengths (B,) int32;
//     query head hq reads kv head hq / G, G = Hq / Hkv      (GQA / MQA)
//     s = (q . k) * scale over keys [0, min(lengths[b], Skv)), fp32;
//     o = sum_k softmax(s)_k v_k in q's type.
//
// Bound: bytes.  A decode step reads each valid key and value once and
// does 4 G d operations on each (G query heads, two products): at the
// Qwen2-7B path's shape (G = 7, d = 128, bf16) that is 7 operations a
// byte, far below the card's 295 for bf16 on tensor cores.  So the one
// thing that matters is to stream the valid part of the cache through
// every SM once, with enough copies in flight, and to keep the
// arithmetic and shared-memory traffic out of the way.
//
// Split, then merge (flash-decoding).  B * Hkv (32 at the path's shape)
// is far below 132 SMs, so the kv axis is split too: kernel 1 runs one
// block per (b, kv head, split of `chunk` keys) and writes the split's
// (m, l, acc) to fp32 scratch; keys at or past the valid length are
// never loaded, and a split wholly past it returns at once.  Kernel 2
// runs one block per (b, kv head, query head) and merges the valid
// splits:
//     M = max m_i,
//     o = sum_i e(m_i - M) acc_i / max(sum_i e(m_i - M) l_i, 1e-30),
// e = exp2 for the bf16 kernel (m in units of log2), exp for fp32.
//
// bf16 -- tensor cores (namespace tc).  A block is 4 warps; each warp
// owns its own contiguous run of chunk / 4 keys of the split, with its
// own running max m, sum l and accumulator, so no block-wide barrier
// runs inside the key loop.
//   * Products: S = Q K^T and O += P V on mma.sync m16n8k16 (bf16 in,
//     fp32 accumulate).  The G <= 16 query heads of the kv head are the
//     16 rows of A, padded with zero rows; Q sits in shared memory
//     (swizzled, staged once by the block) and its fragments come by
//     ldmatrix at each k-step; K fragments by ldmatrix, V by
//     ldmatrix.trans.  Columns past d are zeros, so every k-step runs.
//   * Softmax: online, on the accumulator fragments (a row's max and sum
//     are quad shuffles), scores scaled by scale * log2(e) and raised
//     with the SFU's ex2.  P enters P V as two bf16 terms, hi = bf16(p)
//     and lo = bf16(p - hi), as in the flash kernel: one bf16 rounding
//     of P would move an output by up to 2^-8 of the mean |v| it
//     averages, past the bf16 tolerance where outputs cancel.
//   * Copies: K and V stay bf16 in shared memory.  Each warp streams K0,
//     V0, K1, V1, ... (tiles of 16 keys) by 16-byte cp.async into a ring
//     of three slots of its own, swizzled (16-byte chunk c of row r at c
//     ^ (r & 7)), two loads ahead of the one it uses: while S_t is
//     formed, V_t and K_{t+1} are in flight, and the slot K_t leaves
//     takes V_{t+1}.  Keys past the warp's run are zero-filled by
//     cp.async's src-size operand and masked to -inf.
//   * Merge in the block: after the loop each warp leaves (m, l, acc) in
//     shared memory (reusing the rings), and the block writes one
//     partial of the split.
//   * Size: at d = 128 a block holds 4 KB of Q and 4 x 12 KB of rings
//     (52 KB), so four blocks (16 warps, up to 128 KB of copies in
//     flight) fit an SM; 2 at d = 256.
//
// fp32 -- CUDA cores (namespace cc), every product and sum in fp32, for
// the 5e-6 tolerance: one block of 128 threads per (b, kv head, split)
// holds the G query heads in shared memory, walks its keys in tiles of
// kTile (32 up to d = 128, 16 above) staged as fp32 with the next tile's
// 16-byte loads in flight in registers, and keeps m, l and acc (G x d).
// Scores: kTile keys x (128 / kTile) threads a key, reduced by warp
// shuffles; softmax: a warp a query head; acc: a thread a column group
// of four.  expf, IEEE division, no fast-math.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "mma_common.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kMaxGroup = 16;
constexpr int kMaxHeadDim = 256;
// keys a split is a whole number of: the bf16 kernel's 4 warps x 16 keys
// (and a multiple of the fp32 kernel's tiles of 32 and 16)
constexpr int kSplitUnit = 64;

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  const uint32_t b0 = __bfloat16_as_ushort(__float2bfloat16_rn(v.x));
  const uint32_t b1 = __bfloat16_as_ushort(__float2bfloat16_rn(v.y));
  const uint32_t b2 = __bfloat16_as_ushort(__float2bfloat16_rn(v.z));
  const uint32_t b3 = __bfloat16_as_ushort(__float2bfloat16_rn(v.w));
  *reinterpret_cast<uint2*>(p) = make_uint2(b0 | (b1 << 16), b2 | (b3 << 16));
}

// ------------------------------------------------------------------------
// bf16: tensor cores
// ------------------------------------------------------------------------
namespace tc {

using namespace tc_common;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kKeys = 16;                      // keys a tile
constexpr int kSlots = 3;                      // ring slots a warp
static_assert(kWarps * kKeys == kSplitUnit, "a split is whole warp runs");

// D is the head-dim class (d <= D): 64, 128 or 256
template <int D>
__host__ __device__ constexpr int min_blocks() { return D == 256 ? 2 : 4; }

// Q [16][D], then each warp's ring of kSlots tiles [kKeys][D], bf16
template <int D>
__host__ __device__ constexpr size_t smem_bytes() {
  return static_cast<size_t>(16 + kWarps * kSlots * kKeys) * D * 2;
}

// the warps' partials for the merge in the block, fp32 [kWarps][16][D + 8]
// (rows padded so the fragment stores spread over the banks), over the rings
template <int D>
__host__ __device__ constexpr size_t merge_bytes() {
  return static_cast<size_t>(kWarps) * 16 * (D + 8) * 4;
}
static_assert(merge_bytes<64>() <= smem_bytes<64>() - 16 * 64 * 2 &&
              merge_bytes<128>() <= smem_bytes<128>() - 16 * 128 * 2 &&
              merge_bytes<256>() <= smem_bytes<256>() - 16 * 256 * 2,
              "the merge fits in the rings");

// One block per (b * Hkv + h, split).
template <int D>
__global__ void __launch_bounds__(kThreads, min_blocks<D>())
decode_split_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const int* __restrict__ lengths,
                    float* __restrict__ part_acc,
                    float* __restrict__ part_ml, int Hkv, int G, int d,
                    int Skv, long long k_sb, long long k_ss, long long k_sh,
                    long long v_sb, long long v_ss, long long v_sh,
                    int chunk, float scale_log2) {
  constexpr int KD = D / 16;                   // k-steps of Q K^T
  constexpr int NO = D / 8;                    // n-tiles of O
  constexpr uint32_t kRowBytes = D * 2;
  constexpr uint32_t kTileBytes = kKeys * kRowBytes;
  constexpr int kChunks = D / 8;               // 16-byte chunks a row
  constexpr int kRpp = 32 / kChunks;           // rows a warp copies a pass
  constexpr int kPasses = kKeys / kRpp;
  constexpr int LD = D + 8;                    // row stride of the merge

  const int bh = blockIdx.x;
  const int split = blockIdx.y;
  const int n_splits = gridDim.y;
  const int b = bh / Hkv;
  const int h = bh - b * Hkv;
  const int len = min(lengths[b], Skv);
  const int k_begin = split * chunk;
  const int k_end = min(k_begin + chunk, len);
  if (k_begin >= k_end) return;              // the merge skips this split

  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float warp_m[kWarps][16], warp_l[kWarps][16];
  const uint32_t sQ = smem_addr(smem);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const uint32_t sRing = sQ + 16 * kRowBytes + warp * kSlots * kTileBytes;

  // this warp's keys [w_begin, w_end)
  const int run = chunk / kWarps;
  const int w_begin = k_begin + warp * run;
  const int w_end = min(w_begin + run, k_end);
  const int n_tiles = w_begin < w_end ? (w_end - w_begin + kKeys - 1) / kKeys
                                      : 0;
  const __nv_bfloat16* kb = k + b * k_sb + h * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + h * v_sh;

  // load i of the warp's stream K0, V0, K1, V1, ... into slot i % kSlots;
  // one commit group a load (an empty one past the end), so that
  // wait_group counts loads.  Lane: chunk cc of rows rr + kRpp * pass.
  const int rr = lane / kChunks, cc = lane % kChunks;
  const bool col_ok = cc * 8 < d;
  auto fetch = [&](int i) {
    if (i < 2 * n_tiles) {
      const bool is_v = i & 1;
      const __nv_bfloat16* base = is_v ? vb : kb;
      const long long ss = is_v ? v_ss : k_ss;
      const uint32_t dst = sRing + (i % kSlots) * kTileBytes;
      const int key0 = w_begin + (i >> 1) * kKeys + rr;
#pragma unroll
      for (int it = 0; it < kPasses; ++it) {
        const int r = rr + it * kRpp;
        const int key = key0 + it * kRpp;
        const bool ok = col_ok && key < w_end;
        const __nv_bfloat16* src = base + key * ss + cc * 8;
        cp_async16(dst + r * kRowBytes + ((cc ^ (r & 7)) << 4),
                   ok ? src : base, ok ? 16 : 0);
      }
    }
    cp_async_commit();
  };
  fetch(0);
  fetch(1);
  fetch(2);

  // Q: rows g < G of the kv head's query heads, zeros elsewhere
  const int Hq = Hkv * G;
  const __nv_bfloat16* qb = q + (static_cast<long long>(b) * Hq + h * G) * d;
  for (int i = threadIdx.x; i < 16 * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i - (i / kChunks) * kChunks;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < G && c * 8 < d)
      val = *reinterpret_cast<const uint4*>(qb + r * d + c * 8);
    *reinterpret_cast<uint4*>(smem + swz<D>(r, c)) = val;
  }
  __syncthreads();                             // Q staged

  // ldmatrix addresses, as in the flash kernel: every row a lane names
  // has r & 7 = lane & 7, so a step's chunk offset is a lane register
  // XOR a constant plus an immediate.
  //   Q (A, x4):   row lane & 15, h = lane >> 4
  //   K (B, x4):   row (lane & 7) + 8 (lane >> 4 & 1), h = lane >> 3 & 1
  //   V (B, x4.t): row (lane & 7) + 8 (lane >> 3 & 1), h = lane >> 4
  const int x = lane & 7;
  const uint32_t q_lane = ((lane & 15) * kRowBytes) |
                          (((lane >> 4) ^ x) << 4);
  const uint32_t k_lane = ((x + (((lane >> 4) & 1) << 3)) * kRowBytes) |
                          ((((lane >> 3) & 1) ^ x) << 4);
  const uint32_t v_lane = ((x + (((lane >> 3) & 1) << 3)) * kRowBytes) |
                          (((lane >> 4) ^ x) << 4);

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  // running max (units of scale_log2 * s) and this thread's part of the
  // running sum, for rows lane / 4 and lane / 4 + 8
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int t = 0; t < n_tiles; ++t) {
    // S = Q K^T for the tile's 16 keys (two n-tiles)
    cp_async_wait<2>();                        // K_t has landed
    __syncwarp();
    const uint32_t sK = sRing + ((2 * t) % kSlots) * kTileBytes;
    float s[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      const uint32_t flip = (2 * (kk & 3)) << 4, col = 128 * (kk >> 2);
      uint32_t a[4], bk[4];
      ldsm_x4(a, sQ + ((q_lane ^ flip) + col));
      ldsm_x4(bk, sK + ((k_lane ^ flip) + col));
      mma(s[0], a, bk[0], bk[1]);
      mma(s[1], a, bk[2], bk[3]);
    }
    __syncwarp();                              // every lane has read K_t
    fetch(2 * t + 3);                          // V_{t+1} into K_t's slot

    // element (j, e): key w_begin + 16 t + 8 j + 2 (lane & 3) + (e & 1)
    const int room = w_end - (w_begin + t * kKeys + 2 * (lane & 3));
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[j][e] = 8 * j + (e & 1) < room ? s[j][e] * scale_log2 : -INFINITY;

    // online softmax on the fragments (the tile's first key is valid, so
    // the new max is finite)
    float mx[2] = {m[0], m[1]}, corr[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      corr[i] = exp2_sfu(m[i] - mx[i]);
      m[i] = mx[i];
    }
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      acc[n][0] *= corr[0]; acc[n][1] *= corr[0];
      acc[n][2] *= corr[1]; acc[n][3] *= corr[1];
    }
    // P as the A fragment of P V (n-tiles 0 and 1 of S are its two
    // halves of keys), in two bf16 terms
    uint32_t hi[4], lo[4];
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float p0 = exp2_sfu(s[j][0] - m[0]);
      const float p1 = exp2_sfu(s[j][1] - m[0]);
      const float p2 = exp2_sfu(s[j][2] - m[1]);
      const float p3 = exp2_sfu(s[j][3] - m[1]);
      rs[0] += p0 + p1;
      rs[1] += p2 + p3;
      split_bf16(p0, p1, hi[2 * j], lo[2 * j]);
      split_bf16(p2, p3, hi[2 * j + 1], lo[2 * j + 1]);
    }
    l[0] = l[0] * corr[0] + rs[0];
    l[1] = l[1] * corr[1] + rs[1];

    // O += P V
    cp_async_wait<2>();                        // V_t has landed
    __syncwarp();
    const uint32_t sV = sRing + ((2 * t + 1) % kSlots) * kTileBytes;
#pragma unroll
    for (int n = 0; n < NO / 2; ++n) {
      uint32_t bv[4];                          // dims 16n..16n+15
      ldsm_x4_trans(bv, sV + ((v_lane ^ ((2 * (n & 3)) << 4)) +
                              128 * (n >> 2)));
      mma(acc[2 * n], hi, bv[0], bv[1]);
      mma(acc[2 * n + 1], hi, bv[2], bv[3]);
      mma(acc[2 * n], lo, bv[0], bv[1]);
      mma(acc[2 * n + 1], lo, bv[2], bv[3]);
    }
    __syncwarp();                              // every lane has read V_t
    fetch(2 * t + 4);                          // K_{t+2} into V_t's slot
  }
  cp_async_wait<0>();

  // the warps' (m, l, acc) into shared memory, over the rings
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  __syncthreads();                             // every ring is consumed
  float* sacc = reinterpret_cast<float*>(smem + 16 * kRowBytes);
  const int r0 = lane >> 2, c0 = 2 * (lane & 3);
  float* wacc = sacc + warp * 16 * LD;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    *reinterpret_cast<float2*>(wacc + r0 * LD + 8 * n + c0) =
        make_float2(acc[n][0], acc[n][1]);
    *reinterpret_cast<float2*>(wacc + (r0 + 8) * LD + 8 * n + c0) =
        make_float2(acc[n][2], acc[n][3]);
  }
  if ((lane & 3) == 0) {
    warp_m[warp][r0] = m[0];
    warp_m[warp][r0 + 8] = m[1];
    warp_l[warp][r0] = l[0];
    warp_l[warp][r0 + 8] = l[1];
  }
  __syncthreads();

  // the split's partial: a warp without keys has m = -inf and weight 0
  const long long part = static_cast<long long>(bh) * n_splits + split;
  const int ncg = d / 4;
  for (int e = threadIdx.x; e < G * ncg; e += kThreads) {
    const int g = e / ncg;
    const int c = (e - g * ncg) * 4;
    float M = warp_m[0][g];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) M = fmaxf(M, warp_m[w][g]);
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    float L = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wt = exp2f(warp_m[w][g] - M);
      const float4 p = *reinterpret_cast<const float4*>(
          sacc + (w * 16 + g) * LD + c);
      L = fmaf(wt, warp_l[w][g], L);
      a.x = fmaf(wt, p.x, a.x);
      a.y = fmaf(wt, p.y, a.y);
      a.z = fmaf(wt, p.z, a.z);
      a.w = fmaf(wt, p.w, a.w);
    }
    store4(part_acc + (part * G + g) * d + c, a);
    if (c == 0) {
      part_ml[(part * G + g) * 2] = M;
      part_ml[(part * G + g) * 2 + 1] = L;
    }
  }
}

// Raise the instantiation's dynamic shared-memory limit, once a device.
template <int D>
cudaError_t opt_in() {
  static unsigned long long done = 0;          // bit i: device i
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && (done >> dev & 1ULL)) return cudaSuccess;
  err = cudaFuncSetAttribute(decode_split_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_bytes<D>()));
  if (err == cudaSuccess && dev < 64) done |= 1ULL << dev;
  return err;
}

template <int D>
cudaError_t occupancy(int* smem, int* blocks_per_sm, int* threads) {
  const cudaError_t err = opt_in<D>();
  if (err != cudaSuccess) return err;
  *smem = static_cast<int>(smem_bytes<D>());
  *threads = kThreads;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, decode_split_kernel<D>, kThreads, smem_bytes<D>());
}

}  // namespace tc

// ------------------------------------------------------------------------
// fp32: CUDA cores
// ------------------------------------------------------------------------
namespace cc {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTileFloats = 4096;   // kTile * d at most: 32 x 128, 16 x 256

constexpr int kVec = 4;                 // floats a 16-byte load

// the row stride of a staged tile: >= d and 16 banks past a multiple of 32
__host__ __device__ constexpr int padded(int d) {
  return ((d + 16 + 31) / 32) * 32 - 16;
}

// One tile's 16-byte loads of k and v into registers, zeros past k_end:
// vector i is row i / rv, column (i % rv) * 4.
template <int kLoads>
__device__ __forceinline__ void load_tile(uint4 (&kr)[kLoads],
                                          uint4 (&vr)[kLoads],
                                          const float* kb, const float* vb,
                                          long long k_ss, long long v_ss,
                                          int k0, int k_end, int rv,
                                          int nvec) {
#pragma unroll
  for (int j = 0; j < kLoads; ++j) {
    const int i = threadIdx.x + j * kThreads;
    const int row = i / rv;
    const int key = k0 + row;
    kr[j] = vr[j] = make_uint4(0u, 0u, 0u, 0u);
    if (i < nvec && key < k_end) {
      const int col = (i - row * rv) * kVec;
      kr[j] = __ldg(reinterpret_cast<const uint4*>(kb + key * k_ss + col));
      vr[j] = __ldg(reinterpret_cast<const uint4*>(vb + key * v_ss + col));
    }
  }
}

// One block per (b * Hkv + h, split).
template <int kTile>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const int* __restrict__ lengths,
                    float* __restrict__ part_acc, float* __restrict__ part_ml,
                    int Hkv, int G, int d, int Skv, long long k_sb,
                    long long k_ss, long long k_sh, long long v_sb,
                    long long v_ss, long long v_sh, int chunk, float scale) {
  constexpr int kLanes = kThreads / kTile;          // threads a key
  constexpr int kLoads = kTileFloats / kVec / kThreads;
  // query heads an acc thread owns: head rows of column groups >= 2
  constexpr int kHeadsPerThread = kMaxGroup / 2;

  const int bh = blockIdx.x;
  const int split = blockIdx.y;
  const int n_splits = gridDim.y;
  const int b = bh / Hkv;
  const int h = bh - b * Hkv;
  const int len = min(lengths[b], Skv);
  const int k_begin = split * chunk;
  const int k_end = min(k_begin + chunk, len);
  if (k_begin >= k_end) return;              // the merge skips this split

  extern __shared__ float4 smem4[];
  const int ld = padded(d);
  float* qs = reinterpret_cast<float*>(smem4);  // [G][d]
  float* ks = qs + G * d;                        // [kTile][ld]
  float* vs = ks + kTile * ld;                   // [kTile][ld]
  float* ss = vs + kTile * ld;                   // [G][kTile] scores, then p
  float* sm = ss + G * kTile;                    // [G] running max
  float* sl = sm + G;                            // [G] running sum
  float* sc = sl + G;                            // [G] this tile's rescale

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int Hq = Hkv * G;

  const float* qb = q + (static_cast<long long>(b) * Hq + h * G) * d;
  for (int i = tid; i < G * d; i += kThreads) qs[i] = qb[i];
  for (int g = tid; g < G; g += kThreads) {
    sm[g] = kNegInf;
    sl[g] = 0.f;
  }
  const float* kb = k + b * k_sb + h * k_sh;
  const float* vb = v + b * v_sb + h * v_sh;

  const int rv = d / kVec;
  const int nvec = kTile * rv;
  uint4 kr[kLoads], vr[kLoads];

  // acc ownership: column group c4 of head rows gr, gr + R, gr + 2R, ...
  const int ncg = d / 4;
  int C = 1;
  while (C < ncg) C <<= 1;                       // column groups a head row
  const int R = kThreads / C;                    // head rows at a time
  const int c4 = tid % C;
  const int gr = tid / C;
  const bool col_ok = c4 < ncg;
  float4 acc[kHeadsPerThread];
#pragma unroll
  for (int i = 0; i < kHeadsPerThread; ++i)
    acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);

  // score ownership: key kk, column groups sj, sj + kLanes, ...
  const int kk = tid / kLanes;
  const int sj = tid % kLanes;

  load_tile<kLoads>(kr, vr, kb, vb, k_ss, v_ss, k_begin, k_end, rv,
                      nvec);
  for (int k0 = k_begin; k0 < k_end; k0 += kTile) {
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int i = tid + j * kThreads;
      if (i < nvec) {
        const int row = i / rv;
        const int col = (i - row * rv) * kVec;
        *reinterpret_cast<uint4*>(ks + row * ld + col) = kr[j];
        *reinterpret_cast<uint4*>(vs + row * ld + col) = vr[j];
      }
    }
    __syncthreads();                             // tile (and q, m, l) staged
    if (k0 + kTile < k_end) {
      load_tile<kLoads>(kr, vr, kb, vb, k_ss, v_ss, k0 + kTile, k_end, rv,
                           nvec);
    }

    // scores of key kk for every query head
    float s[kMaxGroup];
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g) s[g] = 0.f;
    const float* krow = ks + kk * ld;
    for (int c = sj; c < ncg; c += kLanes) {
      const float4 kv4 = *reinterpret_cast<const float4*>(krow + 4 * c);
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g) {
        if (g < G) {
          const float4 qv = *reinterpret_cast<const float4*>(qs + g * d + 4 * c);
          s[g] = fmaf(qv.x, kv4.x, s[g]);
          s[g] = fmaf(qv.y, kv4.y, s[g]);
          s[g] = fmaf(qv.z, kv4.z, s[g]);
          s[g] = fmaf(qv.w, kv4.w, s[g]);
        }
      }
    }
    const bool key_ok = k0 + kk < k_end;
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g) {
      if (g < G) {
        float part = s[g];
#pragma unroll
        for (int off = kLanes / 2; off > 0; off >>= 1)
          part += __shfl_xor_sync(0xffffffffu, part, off);
        if (sj == 0) ss[g * kTile + kk] = key_ok ? part * scale : kNegInf;
      }
    }
    __syncthreads();

    // online softmax: a warp a query head, a lane a key
    for (int g = warp; g < G; g += kWarps) {
      const float x = lane < kTile ? ss[g * kTile + lane] : kNegInf;
      const float m_old = sm[g];
      const float m_new = fmaxf(m_old, warp_max(x));
      const float p = lane < kTile ? expf(x - m_new) : 0.f;
      const float p_sum = warp_sum(p);
      if (lane < kTile) ss[g * kTile + lane] = p;
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        sc[g] = corr;
        sl[g] = sl[g] * corr + p_sum;
        sm[g] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * corr + p . v, for the owned heads and columns
    if (col_ok) {
#pragma unroll
      for (int i = 0; i < kHeadsPerThread; ++i) {
        const int g = gr + i * R;
        if (g < G) {
          const float corr = sc[g];
          acc[i].x *= corr; acc[i].y *= corr; acc[i].z *= corr; acc[i].w *= corr;
        }
      }
      for (int key = 0; key < kTile; ++key) {
        const float4 vv = *reinterpret_cast<const float4*>(vs + key * ld + 4 * c4);
#pragma unroll
        for (int i = 0; i < kHeadsPerThread; ++i) {
          const int g = gr + i * R;
          if (g < G) {
            const float p = ss[g * kTile + key];
            acc[i].x = fmaf(p, vv.x, acc[i].x);
            acc[i].y = fmaf(p, vv.y, acc[i].y);
            acc[i].z = fmaf(p, vv.z, acc[i].z);
            acc[i].w = fmaf(p, vv.w, acc[i].w);
          }
        }
      }
    }
    __syncthreads();                             // ks, vs, ss free again
  }

  const long long part = static_cast<long long>(bh) * n_splits + split;
  if (col_ok) {
#pragma unroll
    for (int i = 0; i < kHeadsPerThread; ++i) {
      const int g = gr + i * R;
      if (g < G) store4(part_acc + (part * G + g) * d + 4 * c4, acc[i]);
    }
  }
  for (int g = tid; g < G; g += kThreads) {
    part_ml[(part * G + g) * 2] = sm[g];
    part_ml[(part * G + g) * 2 + 1] = sl[g];
  }
}


}  // namespace cc

// Kernel 2: one block of 64 threads per (b * Hkv + h, query head g):
// merge the splits that hold keys.  Warp 0 finds M and L over the
// splits; then a thread a column group of four sums its columns over the
// splits, eight splits' loads in flight at a time.  kLog2: the splits' m
// are in units of log2 (the bf16 kernel's).
constexpr int kMergeThreads = 64;

template <typename T, bool kLog2>
__global__ void __launch_bounds__(kMergeThreads)
decode_merge_kernel(const float* __restrict__ part_acc,
                    const float* __restrict__ part_ml,
                    const int* __restrict__ lengths, T* __restrict__ o,
                    int Hkv, int G, int d, int Skv, int chunk, int n_splits) {
  __shared__ float Ms, Ls;
  auto ex = [](float x) { return kLog2 ? exp2f(x) : expf(x); };
  const int bh = blockIdx.x;
  const int g = blockIdx.y;
  const int b = bh / Hkv;
  const int h = bh - b * Hkv;
  const int len = min(lengths[b], Skv);
  const int used = len > 0 ? min(n_splits, (len + chunk - 1) / chunk) : 0;
  const int tid = threadIdx.x;
  // (m, l) of split i at ml[2 G i], its acc row at acc + G d i
  const long long row0 = static_cast<long long>(bh) * n_splits * G + g;
  const float* ml = part_ml + row0 * 2;
  const float* acc = part_acc + row0 * d;

  if (tid < 32) {
    float m = kNegInf;
    for (int i = tid; i < used; i += 32) m = fmaxf(m, ml[2 * G * i]);
    m = warp_max(m);
    float l = 0.f;
    for (int i = tid; i < used; i += 32)
      l += ex(ml[2 * G * i] - m) * ml[2 * G * i + 1];
    l = warp_sum(l);
    if (tid == 0) {
      Ms = m;
      Ls = fmaxf(l, 1e-30f);
    }
  }
  __syncthreads();

  const int c = 4 * tid;
  if (c >= d) return;
  const float M = Ms;
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
  for (int i = 0; i < used; ++i) {
    const float w = ex(ml[2 * G * i] - M);
    const float4 p = *reinterpret_cast<const float4*>(
        acc + static_cast<long long>(G) * d * i + c);
    a.x = fmaf(w, p.x, a.x);
    a.y = fmaf(w, p.y, a.y);
    a.z = fmaf(w, p.z, a.z);
    a.w = fmaf(w, p.w, a.w);
  }
  const float L = Ls;
  store4(o + (static_cast<long long>(b) * Hkv * G + h * G + g) * d + c,
         make_float4(a.x / L, a.y / L, a.z / L, a.w / L));
}

template <typename T, bool kLog2>
cudaError_t launch_merge(const float* part_acc, const float* part_ml,
                         const int* lengths, void* o, long long B,
                         long long Hkv, long long G, long long d,
                         long long Skv, long long chunk, long long n_splits,
                         cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned int>(B * Hkv),
                  static_cast<unsigned int>(G));
  decode_merge_kernel<T, kLog2><<<grid, kMergeThreads, 0, stream>>>(
      part_acc, part_ml, lengths, static_cast<T*>(o), static_cast<int>(Hkv),
      static_cast<int>(G), static_cast<int>(d), static_cast<int>(Skv),
      static_cast<int>(chunk), static_cast<int>(n_splits));
  return cudaGetLastError();
}

template <int kTile>
cudaError_t launch_cc(const void* q, const void* k, const void* v,
                      const int* lengths, void* o, float* part_acc,
                      float* part_ml, long long B, long long Hkv, long long G,
                      long long Skv, long long d, const long long* ks,
                      const long long* vs, long long chunk,
                      long long n_splits, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      static_cast<size_t>(G * d + 2 * kTile * cc::padded(static_cast<int>(d)) +
                          G * kTile + 3 * G);
  auto kernel = cc::decode_split_kernel<kTile>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(static_cast<unsigned int>(B * Hkv),
                  static_cast<unsigned int>(n_splits));
  kernel<<<grid, cc::kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), lengths, part_acc, part_ml,
      static_cast<int>(Hkv), static_cast<int>(G), static_cast<int>(d),
      static_cast<int>(Skv), ks[0], ks[1], ks[2], vs[0], vs[1], vs[2],
      static_cast<int>(chunk), scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_merge<float, false>(part_acc, part_ml, lengths, o, B, Hkv, G,
                                    d, Skv, chunk, n_splits, stream);
}

template <int D>
cudaError_t launch_tc(const void* q, const void* k, const void* v,
                      const int* lengths, void* o, float* part_acc,
                      float* part_ml, long long B, long long Hkv, long long G,
                      long long Skv, long long d, const long long* ks,
                      const long long* vs, long long chunk,
                      long long n_splits, float scale, cudaStream_t stream) {
  cudaError_t err = tc::opt_in<D>();
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned int>(B * Hkv),
                  static_cast<unsigned int>(n_splits));
  tc::decode_split_kernel<D><<<grid, tc::kThreads, tc::smem_bytes<D>(),
                               stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), lengths, part_acc, part_ml,
      static_cast<int>(Hkv), static_cast<int>(G), static_cast<int>(d),
      static_cast<int>(Skv), ks[0], ks[1], ks[2], vs[0], vs[1], vs[2],
      static_cast<int>(chunk), scale * 1.4426950408889634f);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_merge<__nv_bfloat16, true>(part_acc, part_ml, lengths, o, B,
                                           Hkv, G, d, Skv, chunk, n_splits,
                                           stream);
}

}  // namespace

// q (B, Hq, d) contiguous; k and v (B, Skv, Hkv, d) with d contiguous and
// strides (batch, seq, head) in elements; lengths (B,) int32; o (B, Hq,
// d) of q's type; scratch part_acc (B*Hkv, n_splits, G, d) and part_ml
// (B*Hkv, n_splits, G, 2) fp32.  dtype 0 = fp32 (CUDA cores), 1 = bf16
// (tensor cores).  d a multiple of 8 up to 256, G = Hq / Hkv at most 16,
// chunk a multiple of 64 keys with chunk * n_splits >= Skv.  All pointers
// and strides 16-byte aligned.  Enqueues two launches on `stream` and
// returns the cudaError_t (0 = success); does not synchronise.
extern "C" int repro_decode_attention(
    const void* q, const void* k, const void* v, const void* lengths,
    void* o, void* part_acc, void* part_ml, long long B, long long Hq,
    long long Hkv, long long Skv, long long d, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, long long chunk, long long n_splits, float scale,
    int dtype, void* stream) {
  if (B <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > kMaxGroup ||
      Hq / Hkv <= 0 || Skv <= 0 || Skv > 2147483647LL || d <= 0 ||
      d > kMaxHeadDim || d % 8 != 0 || chunk <= 0 ||
      chunk % kSplitUnit != 0 || n_splits <= 0 || n_splits > 65535 ||
      chunk * n_splits < Skv || chunk * (n_splits - 1) >= Skv ||
      B * Hkv > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long G = Hq / Hkv;
  const long long ks[3] = {k_sb, k_ss, k_sh};
  const long long vs[3] = {v_sb, v_ss, v_sh};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(lengths);
  float* pa = static_cast<float*>(part_acc);
  float* pm = static_cast<float*>(part_ml);
  cudaError_t err;
  if (dtype == 0 && d <= 128) {
    err = launch_cc<32>(q, k, v, len, o, pa, pm, B, Hkv, G, Skv, d, ks, vs,
                        chunk, n_splits, scale, s);
  } else if (dtype == 0) {
    err = launch_cc<16>(q, k, v, len, o, pa, pm, B, Hkv, G, Skv, d, ks, vs,
                        chunk, n_splits, scale, s);
  } else if (dtype == 1 && d <= 64) {
    err = launch_tc<64>(q, k, v, len, o, pa, pm, B, Hkv, G, Skv, d, ks, vs,
                        chunk, n_splits, scale, s);
  } else if (dtype == 1 && d <= 128) {
    err = launch_tc<128>(q, k, v, len, o, pa, pm, B, Hkv, G, Skv, d, ks, vs,
                         chunk, n_splits, scale, s);
  } else if (dtype == 1) {
    err = launch_tc<256>(q, k, v, len, o, pa, pm, B, Hkv, G, Skv, d, ks, vs,
                         chunk, n_splits, scale, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// The bf16 split kernel's launch at head_dim d: its dynamic shared memory
// a block, its threads a block, and how many of its blocks one SM of the
// current device holds.  Returns a cudaError_t.
extern "C" int repro_decode_attention_occupancy(long long d, int* smem_bytes,
                                                int* blocks_per_sm,
                                                int* threads) {
  if (d <= 0 || d > kMaxHeadDim || d % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err =
      d <= 64    ? tc::occupancy<64>(smem_bytes, blocks_per_sm, threads)
      : d <= 128 ? tc::occupancy<128>(smem_bytes, blocks_per_sm, threads)
                 : tc::occupancy<256>(smem_bytes, blocks_per_sm, threads);
  return static_cast<int>(err);
}
