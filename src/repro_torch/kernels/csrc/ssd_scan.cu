// Mamba-2 SSD (state-space duality) chunked scan, for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel repro/kernels/ssd_scan.py::ssd_scan
// (body _kernel).  For x (b, S, H, P), dt (b, S, H), A (H,), B and C
// (b, S, G, N), all fp32, head h reading group g = h / (H / G), and
// chunks of Q steps (S % Q == 0), with dA = dt * A and cum its in-chunk
// cumulative sum, per (batch, head) and chunk c:
//     y_i    = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//              + exp(cum_i) (C_i @ state_c^T)      (state entering chunk c)
//     state_{c+1} = exp(cum_{Q-1}) state_c
//              + sum_j x_j^T (B_j exp(cum_{Q-1} - cum_j) dt_j)
// state_0 is init_state (or 0); y (b, S, H, P) fp32 and the state after
// the last chunk, final (b, H, P, N) fp32, are written out.
//
// Bound: operations.  A chunk needs Q(Q+1)/2 (query, key) pairs of N + P
// multiply-adds (the scores and their product with x) and 2 Q N P more
// (the state's contribution and its update): at the serving path's shape
// (b 4, S 4096, H 48, P 64, N 128, Q 256) 6.5e10 FLOP in fp32 against
// 0.43 GB of x, y, B, C, dt and the final state, ~150 operations a byte.
// The port runs fp32 with TF32 off, so the products are fp32 FMAs on
// CUDA cores; the design is about keeping all 132 SMs busy with them.
//
// Design: the three phases of Mamba-2's GPU algorithm, so that only a
// short pass over the chunks is sequential.
//   1. Chunk states (ssd_chunk_state_kernel): one block per (b, h, chunk,
//      64 columns of N) forms the chunk's cumulative sum and
//      S_c = sum_j (x_j exp(cum_last - cum_j) dt_j)^T B_j, (P, N), and
//      the chunk's decay exp(cum_last), into fp32 scratch.
//   2. State passing (ssd_state_pass_kernel): one thread per (b, h, p,
//      n) walks the chunks in order, state_c = decay_{c-1} state_{c-1} +
//      S_{c-1}, overwriting S_c with the state entering chunk c, and
//      writes the final state.
//   3. Chunk outputs (ssd_chunk_out_kernel): one block per (b, h, chunk,
//      64 query rows) computes exp(cum_i) C_i state_c^T, then for each
//      64-key block up to the diagonal the masked, decayed scores (exp
//      only where j <= i, so no inf * 0 arises) and their product with
//      x; blocks take the query blocks from the last (the most key
//      blocks) to the first.
// A decode step (S = 1) is one launch (ssd_step_kernel), a block per (b,
// h) doing the three phases' arithmetic for one step without their
// 64-row tiles or scratch.  Any other S, one chunk included, takes the
// three phases.
//
// Every product is a 64 x 64 output tile of a block of 64 threads, each
// thread an 8 x 8 register tile (rows ty + 8 r and columns tx + 8 c in
// phase 3, rows 8 ty + r and columns 8 tx + c in phase 1), so a float
// read from shared memory serves 8 FMAs; most reads are 16 bytes, and
// rows of staged slices are padded (36 or 68 floats) so that the rows a
// warp reads fall in distinct banks.  Operands arrive by cp.async
// (16-byte copies where P and N are multiples of 4 and the pointers
// aligned, else 4-byte ones) in slices of 32 along the contraction,
// double-buffered, zero-filled past the edges.  Shared memory: 55 KB for
// phase 3 at Q = 256 (four blocks an SM; the masked scores reuse the
// stages), 35 KB for phase 1.  The decay is exp of a difference of
// cumulative sums (never a product of per-step factors), expf without
// fast-math; the cumulative sum is a warp scan of per-lane sequential
// sums, each dt * A rounded before it is added, as the reference's dA is.
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_common.cuh"

namespace {

using namespace tc_common;

constexpr int kThreads = 64;                   // 8 x 8 threads
constexpr int kTile = 64;                      // an output tile's side
constexpr int kSlice = 32;                     // contraction a stage
constexpr int kLdNT = kSlice + 4;              // staged row stride (NT)
constexpr int kLdS = kTile + 4;                // masked scores' row stride
constexpr int kMaxP = 64;
constexpr int kMaxN = 128;

__host__ __device__ constexpr int padded_q(int Q) {
  return (Q + kTile - 1) / kTile * kTile;
}

// Shared memory of each role, in floats
__host__ __device__ constexpr size_t out_floats(int Q) {
  // cum, dts; 2 stages of C and B (or state) slices, which the masked
  // scores reuse between products; x of a key block
  return 2 * static_cast<size_t>(padded_q(Q)) + 2 * 2 * kTile * kLdNT +
         kTile * kTile;
}
static_assert(kTile * kLdS <= 2 * 2 * kTile * kLdNT,
              "the masked scores fit in the stages");

__host__ __device__ constexpr size_t state_floats(int Q) {
  // cum, dts, wend; 2 stages of x and B key slices
  return 3 * static_cast<size_t>(padded_q(Q)) + 2 * 2 * kSlice * kTile;
}

// Where a (b, h) pair's rows lie
struct Rows {
  const float* x;       // x row t at x + t * xs
  const float* B;       // B row t at B + t * bs
  const float* C;
  float* y;
  long long xs, bs;
};

__device__ __forceinline__ Rows rows_of(const float* x, const float* Bm,
                                        const float* Cm, float* y, int bi,
                                        int h, int S, int H, int P, int G,
                                        int N) {
  const int g = h / (H / G);
  Rows r;
  r.xs = static_cast<long long>(H) * P;
  r.bs = static_cast<long long>(G) * N;
  r.x = x + static_cast<long long>(bi) * S * r.xs +
        static_cast<long long>(h) * P;
  r.y = y == nullptr ? nullptr
                     : y + static_cast<long long>(bi) * S * r.xs +
                           static_cast<long long>(h) * P;
  r.B = Bm + static_cast<long long>(bi) * S * r.bs +
        static_cast<long long>(g) * N;
  r.C = Cm == nullptr ? nullptr
                      : Cm + static_cast<long long>(bi) * S * r.bs +
                            static_cast<long long>(g) * N;
  return r;
}

// Rows [0, ROWS) x columns [col0, col0 + WIDTH) of a row-major matrix
// (row r at src + r * stride) into dst (row stride ld) by cp.async;
// rows at or past `rows` and columns at or past `cols` are zero-filled.
template <int ROWS, int WIDTH>
__device__ __forceinline__ void stage(float* dst, int ld, const float* src,
                                      long long stride, int rows, int col0,
                                      int cols, bool vec4) {
  if (vec4) {                                  // cols % 4 == 0
    constexpr int kVecs = WIDTH / 4;
    for (int e = threadIdx.x; e < ROWS * kVecs; e += kThreads) {
      const int r = e / kVecs, c = col0 + 4 * (e - r * kVecs);
      const bool ok = r < rows && c < cols;
      cp_async16(smem_addr(dst + r * ld + (c - col0)),
                 ok ? src + r * stride + c : src, ok ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < ROWS * WIDTH; e += kThreads) {
      const int r = e / WIDTH, c = col0 + (e - r * WIDTH);
      const bool ok = r < rows && c < cols;
      cp_async4(smem_addr(dst + r * ld + (c - col0)),
                ok ? src + r * stride + c : src, ok ? 4 : 0);
    }
  }
}

// dts[i] = dt_i and cum[i] = sum_{k <= i} round(dts[k] * a) for i < Q.
// The sum is by lane of warp 0: each lane sums a contiguous segment, a
// shuffle scan adds the segments before it.  Ends with a barrier.
__device__ __forceinline__ void chunk_cumsum(const float* dtb, long long H,
                                             float a, float* cum,
                                             float* dts, int Q) {
  for (int i = threadIdx.x; i < Q; i += kThreads) dts[i] = dtb[i * H];
  __syncthreads();
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const int seg = (Q + 31) / 32;
    const int lo = min(lane * seg, Q);
    const int hi = min(lo + seg, Q);
    float run = 0.f;
    for (int i = lo; i < hi; ++i) {
      run = __fadd_rn(run, __fmul_rn(dts[i], a));
      cum[i] = run;
    }
    float incl = run;
    for (int off = 1; off < 32; off <<= 1) {
      const float v = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += v;
    }
    float before = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) before = 0.f;
    for (int i = lo; i < hi; ++i) cum[i] += before;
  }
  __syncthreads();
}

// acc[r][c] += sum_k A[ty + 8r][k] B[tx + 8c][k] over k in [0, K): A is
// 64 rows of a matrix at a (row stride as, `arows` valid), B 64 rows at b
// (row stride bs, `brows` valid), both read in slices of kSlice columns
// through the two stages at ring.  `extra` stages more copies with the
// first slice (they have landed when this returns).  Leaves every thread
// past a barrier with the ring free.
template <typename Extra>
__device__ __forceinline__ void gemm_nt(float (&acc)[8][8], float* ring,
                                        const float* a, long long as,
                                        int arows, const float* b,
                                        long long bs, int brows, int K,
                                        bool vec4, Extra extra) {
  const int ty = threadIdx.x >> 3, tx = threadIdx.x & 7;
  const int ns = (K + kSlice - 1) / kSlice;
  auto fetch = [&](int s) {
    float* as_ = ring + (s & 1) * 2 * kTile * kLdNT;
    stage<kTile, kSlice>(as_, kLdNT, a, as, arows, s * kSlice, K, vec4);
    stage<kTile, kSlice>(as_ + kTile * kLdNT, kLdNT, b, bs, brows,
                         s * kSlice, K, vec4);
  };
  fetch(0);
  extra();
  cp_async_commit();
  for (int s = 0; s < ns; ++s) {
    if (s + 1 < ns) {
      fetch(s + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* as_ = ring + (s & 1) * 2 * kTile * kLdNT;
    const float* bs_ = as_ + kTile * kLdNT;
    // four k at a time by 16-byte reads, the columns in two halves (two
    // tiles of accumulators are live in phase 3): 24 reads for 256 FMAs
#pragma unroll 1
    for (int k = 0; k < kSlice; k += 4) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float4 bv[4];
#pragma unroll
        for (int c = 0; c < 4; ++c)
          bv[c] = *reinterpret_cast<const float4*>(
              bs_ + (tx + 8 * (4 * half + c)) * kLdNT + k);
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const float4 av = *reinterpret_cast<const float4*>(
              as_ + (ty + 8 * r) * kLdNT + k);
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            float& o = acc[r][4 * half + c];
            float t = fmaf(av.x, bv[c].x, o);
            t = fmaf(av.y, bv[c].y, t);
            t = fmaf(av.z, bv[c].z, t);
            o = fmaf(av.w, bv[c].w, t);
          }
        }
      }
    }
    __syncthreads();
  }
}

// Phase 3 for one (b, h, chunk c, query block qi): y of rows
// [qi * 64, qi * 64 + 64) of the chunk.  st: the (P, N) state entering the
// chunk.
__device__ void chunk_out(float* smem, const Rows& rw, const float* dtb,
                          long long H, float a, const float* st, int t0,
                          int qi, int P, int N, int Q, bool vec4) {
  const int Qp = padded_q(Q);
  float* cum = smem;
  float* dts = cum + Qp;
  float* ring = dts + Qp;                      // 2 x (C, B) slices
  float* xs = ring + 2 * 2 * kTile * kLdNT;    // (64 keys, 64) x
  float* ss = ring;                  // (64, kLdS) masked scores, between
                                     // the products that use the ring
  const int ty = threadIdx.x >> 3, tx = threadIdx.x & 7;

  chunk_cumsum(dtb + static_cast<long long>(t0) * H, H, a, cum, dts, Q);
  const int r0 = qi * kTile;
  const int rq = min(kTile, Q - r0);
  const float* crow = rw.C + static_cast<long long>(t0 + r0) * rw.bs;

  float acc[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;

  // the state entering the chunk: exp(cum_i) (C_i @ state^T)
  gemm_nt(acc, ring, crow, rw.bs, rq, st, N, P, N, vec4, [] {});
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int i = r0 + ty + 8 * r;
    const float e = i < Q ? expf(cum[i]) : 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] *= e;
  }

  for (int kj = 0; kj <= qi; ++kj) {
    const int k0 = kj * kTile;
    const int rk = min(kTile, Q - k0);
    const float* xrow = rw.x + static_cast<long long>(t0 + k0) * rw.xs;
    // scores C_i . B_j, with x of the key block staged alongside
    float s[8][8];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) s[r][c] = 0.f;
    gemm_nt(s, ring, crow, rw.bs, rq,
            rw.B + static_cast<long long>(t0 + k0) * rw.bs, rw.bs, rk, N,
            vec4, [&] {
              stage<kTile, kTile>(xs, kTile, xrow, rw.xs, rk, 0, P, vec4);
            });
    // the causal mask, the decay and dt_j (gemm_nt has left the ring)
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int i = r0 + ty + 8 * r;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int j = k0 + tx + 8 * c;
        ss[(ty + 8 * r) * kLdS + tx + 8 * c] =
            (j <= i && i < Q) ? s[r][c] * expf(cum[i] - cum[j]) * dts[j]
                              : 0.f;
      }
    }
    __syncthreads();
    // y_i += sum_j scores_ij x_j  (rows j >= rk are zero in ss and xs),
    // four j at a time
#pragma unroll 1
    for (int jj = 0; jj < kTile; jj += 4) {
      float xv[4][8];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int c = 0; c < 8; ++c)
          xv[u][c] = xs[(jj + u) * kTile + tx + 8 * c];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const float4 sv =
            *reinterpret_cast<const float4*>(ss + (ty + 8 * r) * kLdS + jj);
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          float t = fmaf(sv.x, xv[0][c], acc[r][c]);
          t = fmaf(sv.y, xv[1][c], t);
          t = fmaf(sv.z, xv[2][c], t);
          acc[r][c] = fmaf(sv.w, xv[3][c], t);
        }
      }
    }
    __syncthreads();                           // xs and the ring free again
  }

#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int row = ty + 8 * r;
    if (row >= rq) continue;
    float* yr = rw.y + static_cast<long long>(t0 + r0 + row) * rw.xs;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int p = tx + 8 * c;
      if (p < P) yr[p] = acc[r][c];
    }
  }
}

// Phase 1 for one (b, h, chunk, columns [n0, n0 + 64) of N), a thread the
// 8 x 8 tile of rows 8 ty.. and columns 8 tx..: the chunk's
// state S_c = sum_j (x_j exp(cum_last - cum_j) dt_j)^T B_j into out (P, N;
// row stride N), and the decay exp(cum_last) into *decay.
__device__ void chunk_state(float* smem, const Rows& rw, const float* dtb,
                            long long H, float a, int t0, int n0, int P,
                            int N, int Q, bool vec4, float* out,
                            float* decay) {
  const int Qp = padded_q(Q);
  float* cum = smem;
  float* dts = cum + Qp;
  float* wend = dts + Qp;                      // exp(cum_last - cum_j) dt_j
  float* ring = wend + Qp;                     // 2 x (x, B) key slices
  const int ty = threadIdx.x >> 3, tx = threadIdx.x & 7;

  chunk_cumsum(dtb + static_cast<long long>(t0) * H, H, a, cum, dts, Q);
  const float cum_last = cum[Q - 1];
  for (int i = threadIdx.x; i < Qp; i += kThreads)
    wend[i] = i < Q ? expf(cum_last - cum[i]) * dts[i] : 0.f;

  const float* xrow = rw.x + static_cast<long long>(t0) * rw.xs;
  const float* brow = rw.B + static_cast<long long>(t0) * rw.bs;
  auto fetch = [&](int s) {
    float* xs = ring + (s & 1) * 2 * kSlice * kTile;
    const int j0 = s * kSlice;
    stage<kSlice, kTile>(xs, kTile, xrow + j0 * rw.xs, rw.xs, Q - j0, 0, P,
                         vec4);
    stage<kSlice, kTile>(xs + kSlice * kTile, kTile, brow + j0 * rw.bs + n0,
                         rw.bs, Q - j0, 0, N - n0, vec4);
  };

  float acc[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;
  const int ns = (Q + kSlice - 1) / kSlice;
  fetch(0);
  cp_async_commit();
  for (int s = 0; s < ns; ++s) {
    if (s + 1 < ns) {
      fetch(s + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();                           // the slice (and wend) landed
    const float* xs = ring + (s & 1) * 2 * kSlice * kTile;
    const float* bs = xs + kSlice * kTile;
#pragma unroll 4
    for (int jj = 0; jj < kSlice; ++jj) {
      const float w = wend[s * kSlice + jj];
      const float4* xr =
          reinterpret_cast<const float4*>(xs + jj * kTile + 8 * ty);
      const float4* br =
          reinterpret_cast<const float4*>(bs + jj * kTile + 8 * tx);
      const float4 x0 = xr[0], x1 = xr[1], b0 = br[0], b1 = br[1];
      const float xv[8] = {x0.x * w, x0.y * w, x0.z * w, x0.w * w,
                           x1.x * w, x1.y * w, x1.z * w, x1.w * w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(xv[r], bv[c], acc[r][c]);
    }
    __syncthreads();
  }

  if (n0 == 0 && threadIdx.x == 0) *decay = expf(cum_last);
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int p = 8 * ty + r;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int n = n0 + 8 * tx + c;
      if (p < P && n < N) out[p * N + n] = acc[r][c];
    }
  }
}

// Phase 1: one block per ((bi * H + h) * nc + c) * nnb + nb.
__global__ void __launch_bounds__(kThreads)
ssd_chunk_state_kernel(const float* __restrict__ x,
                       const float* __restrict__ dt,
                       const float* __restrict__ A,
                       const float* __restrict__ Bm,
                       float* __restrict__ states, float* __restrict__ decay,
                       int S, int H, int P, int G, int N, int Q, int nnb,
                       bool vec4) {
  extern __shared__ __align__(16) float smem[];
  const int nc = S / Q;
  const int nb = blockIdx.x % nnb;
  const int unit = blockIdx.x / nnb;           // (bi * H + h) * nc + c
  const int c = unit % nc;
  const int bh = unit / nc;
  const int bi = bh / H, h = bh - (bh / H) * H;
  const Rows rw = rows_of(x, Bm, nullptr, nullptr, bi, h, S, H, P, G, N);
  chunk_state(smem, rw, dt + static_cast<long long>(bi) * S * H + h, H, A[h],
              c * Q, nb * kTile, P, N, Q, vec4,
              states + static_cast<long long>(unit) * P * N, decay + unit);
}

// Phase 2: one thread per (bi * H + h, element e of the (P, N) state).
__global__ void __launch_bounds__(256)
ssd_state_pass_kernel(float* __restrict__ states,
                      const float* __restrict__ decay,
                      const float* __restrict__ init, float* __restrict__ fin,
                      int nc, int PN) {
  const int bh = blockIdx.x;
  const int e = blockIdx.y * blockDim.x + threadIdx.x;
  if (e >= PN) return;
  const long long base = static_cast<long long>(bh) * PN + e;
  float carry = init != nullptr ? init[base] : 0.f;
  float* st = states + static_cast<long long>(bh) * nc * PN + e;
  const float* dc = decay + static_cast<long long>(bh) * nc;
  // eight chunks' loads in flight at a time
  constexpr int kBatch = 8;
  for (int c0 = 0; c0 < nc; c0 += kBatch) {
    float sv[kBatch], dv[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (c0 + u < nc) {
        sv[u] = st[static_cast<long long>(c0 + u) * PN];
        dv[u] = dc[c0 + u];
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (c0 + u < nc) {
        st[static_cast<long long>(c0 + u) * PN] = carry;
        carry = fmaf(dv[u], carry, sv[u]);
      }
    }
  }
  fin[base] = carry;
}

// Phase 3: one block per qi' * (b * H * nc) + (bi * H + h) * nc + c, the
// query block qi = nqb - 1 - qi' (the last, and longest, first).
__global__ void __launch_bounds__(kThreads)
ssd_chunk_out_kernel(const float* __restrict__ x,
                     const float* __restrict__ dt,
                     const float* __restrict__ A,
                     const float* __restrict__ Bm,
                     const float* __restrict__ Cm,
                     const float* __restrict__ states, float* __restrict__ y,
                     int units, int S, int H, int P, int G, int N, int Q,
                     int nqb, bool vec4) {
  extern __shared__ __align__(16) float smem[];
  const int nc = S / Q;
  const int qi = nqb - 1 - static_cast<int>(blockIdx.x) / units;
  const int unit = blockIdx.x % units;
  const int c = unit % nc;
  const int bh = unit / nc;
  const int bi = bh / H, h = bh - (bh / H) * H;
  const Rows rw = rows_of(x, Bm, Cm, y, bi, h, S, H, P, G, N);
  chunk_out(smem, rw, dt + static_cast<long long>(bi) * S * H + h, H, A[h],
            states + static_cast<long long>(unit) * P * N, c * Q, qi, P, N,
            Q, vec4);
}

// A decode step (S == 1), one block per (b, h): what the three phases
// compute for a single one-step chunk, operation for operation, with no
// scratch and no padded tiles.  cum = dt a (chunk_cumsum at Q = 1), the
// decay exp(cum); phase 1's S = (x dt)^T B (its weight exp(cum_last -
// cum_0) dt_0 is dt), folded with the initial state as phase 2 folds it;
// phase 3's y = exp(cum) (C . state_p) + ((C . B) exp(0) dt) x, each dot
// product a sequential chain of fmaf over n, as gemm_nt sums it.
constexpr int kStepThreads = 256;

__global__ void __launch_bounds__(kStepThreads)
ssd_step_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const float* __restrict__ Bm,
                const float* __restrict__ Cm, const float* __restrict__ init,
                float* __restrict__ y, float* __restrict__ fin, int H, int P,
                int G, int N) {
  __shared__ float xs[kMaxP], bs[kMaxN], cs[kMaxN];
  __shared__ float st[kMaxP * (kMaxN + 1)];    // init, rows padded
  const int bh = blockIdx.x;
  const int bi = bh / H, h = bh - bi * H;
  const long long bc = (static_cast<long long>(bi) * G + h / (H / G)) * N;
  const long long base = static_cast<long long>(bh) * P * N;
  const float dtv = dt[bh];
  const float cum = __fadd_rn(0.f, __fmul_rn(dtv, A[h]));
  const float dec = expf(cum);
  const float w = expf(cum - cum) * dtv;       // phase 1's weight, = dt
  for (int i = threadIdx.x; i < P; i += kStepThreads)
    xs[i] = x[static_cast<long long>(bh) * P + i];
  for (int i = threadIdx.x; i < N; i += kStepThreads) {
    bs[i] = Bm[bc + i];
    cs[i] = Cm[bc + i];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < P * N; e += kStepThreads) {
    const int p = e / N, n = e - p * N;
    const float s = fmaf(xs[p] * w, bs[n], 0.f);
    if (init != nullptr) {
      const float v = init[base + e];
      st[p * (kMaxN + 1) + n] = v;
      fin[base + e] = fmaf(dec, v, s);
    } else {
      fin[base + e] = s;
    }
  }
  __syncthreads();
  for (int p = threadIdx.x; p < P; p += kStepThreads) {
    float acc = 0.f;
    if (init != nullptr) {
      for (int n = 0; n < N; ++n)
        acc = fmaf(cs[n], st[p * (kMaxN + 1) + n], acc);
      acc *= dec;
    }
    float score = 0.f;
    for (int n = 0; n < N; ++n) score = fmaf(cs[n], bs[n], score);
    y[static_cast<long long>(bh) * P + p] =
        fmaf(score * expf(cum - cum) * dtv, xs[p], acc);
  }
}

// A kernel's dynamic shared-memory limit on each device, as raised so far
struct SmemLimit {
  size_t bytes[64] = {};
};

// Raise a kernel's dynamic shared-memory limit when it needs more than
// the default 48 KB, within what the device allows a block.  The device's
// opt-in and each raise are remembered, so a call that needs no more than
// an earlier one on its device makes no attribute call.
cudaError_t fit_smem(const void* kernel, size_t bytes, SmemLimit& limit) {
  static int optin[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (optin[dev] == 0) {
    err = cudaDeviceGetAttribute(&optin[dev],
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return err;
  }
  if (bytes > static_cast<size_t>(optin[dev])) return cudaErrorInvalidValue;
  if (bytes <= 48 * 1024 || bytes <= limit.bytes[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess) limit.bytes[dev] = bytes;
  return err;
}

SmemLimit state_limit, out_limit;

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

// x, y (b, S, H, P); dt (b, S, H); A (H,); Bm, Cm (b, S, G, N); init
// (b, H, P, N) or null; fin (b, H, P, N); all fp32 and contiguous.
// P <= 64, N <= 128, H a multiple of G, S a multiple of Q.  Scratch:
// states (b, H, S / Q, P, N) and decay (b, H, S / Q) fp32, which may both
// be null when S == 1.  Enqueues on `stream` the three phases, or, at
// S == 1 with no scratch, the step kernel (the same result in one
// launch); returns the cudaError_t (0 = success); does not synchronise.
extern "C" int repro_ssd_scan(const void* x, const void* dt, const void* A,
                              const void* Bm, const void* Cm,
                              const void* init, void* y, void* fin,
                              void* states, void* decay, long long b,
                              long long S, long long H, long long P,
                              long long G, long long N, long long Q,
                              void* stream) {
  if (b <= 0 || S <= 0 || H <= 0 || P <= 0 || P > kMaxP || G <= 0 ||
      H % G != 0 || N <= 0 || N > kMaxN || Q <= 0 || S % Q != 0 ||
      S > 2147483647LL || b * H > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long nc = S / Q;
  const bool phases = states != nullptr && decay != nullptr;
  if (!phases && (S != 1 || states != nullptr || decay != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec4 = P % 4 == 0 && N % 4 == 0 && aligned16(x) &&
                    aligned16(Bm) && aligned16(Cm) &&
                    (init == nullptr || aligned16(init)) &&
                    (states == nullptr || aligned16(states));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bH = static_cast<int>(b * H);
  const int nqb = static_cast<int>((Q + kTile - 1) / kTile);
  const int nnb = static_cast<int>((N + kTile - 1) / kTile);
  const size_t out_smem = sizeof(float) * out_floats(static_cast<int>(Q));
  const size_t state_smem = sizeof(float) * state_floats(static_cast<int>(Q));
  const float* xf = static_cast<const float*>(x);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  const float* Bf = static_cast<const float*>(Bm);
  const float* Cf = static_cast<const float*>(Cm);
  const float* initf = static_cast<const float*>(init);
  float* yf = static_cast<float*>(y);
  float* finf = static_cast<float*>(fin);
  cudaError_t err;

  if (!phases) {
    ssd_step_kernel<<<static_cast<unsigned int>(bH), kStepThreads, 0, s>>>(
        xf, dtf, Af, Bf, Cf, initf, yf, finf, static_cast<int>(H),
        static_cast<int>(P), static_cast<int>(G), static_cast<int>(N));
    return static_cast<int>(cudaGetLastError());
  }

  float* st = static_cast<float*>(states);
  float* dc = static_cast<float*>(decay);
  const long long units = b * H * nc;
  if (units * nqb > 2147483647LL || units * nnb > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  err = fit_smem(reinterpret_cast<const void*>(ssd_chunk_state_kernel),
                 state_smem, state_limit);
  if (err == cudaSuccess)
    err = fit_smem(reinterpret_cast<const void*>(ssd_chunk_out_kernel),
                   out_smem, out_limit);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_chunk_state_kernel<<<static_cast<unsigned int>(units * nnb), kThreads,
                           state_smem, s>>>(
      xf, dtf, Af, Bf, st, dc, static_cast<int>(S), static_cast<int>(H),
      static_cast<int>(P), static_cast<int>(G), static_cast<int>(N),
      static_cast<int>(Q), nnb, vec4);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int PN = static_cast<int>(P * N);
  ssd_state_pass_kernel<<<dim3(static_cast<unsigned int>(bH),
                               static_cast<unsigned int>((PN + 255) / 256)),
                          256, 0, s>>>(st, dc, initf, finf,
                                       static_cast<int>(nc), PN);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_chunk_out_kernel<<<static_cast<unsigned int>(units * nqb), kThreads,
                         out_smem, s>>>(
      xf, dtf, Af, Bf, Cf, st, yf, static_cast<int>(units),
      static_cast<int>(S), static_cast<int>(H), static_cast<int>(P),
      static_cast<int>(G), static_cast<int>(N), static_cast<int>(Q), nqb,
      vec4);
  return static_cast<int>(cudaGetLastError());
}
