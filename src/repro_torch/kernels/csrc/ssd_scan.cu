// Mamba-2 SSD (state-space duality) chunked scan, for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel repro/kernels/ssd_scan.py::ssd_scan
// (body _kernel).  For x (b, S, H, P), dt (b, S, H), A (H,), B and C
// (b, S, G, N), all fp32, head h reading group g = h / (H / G), and
// chunks of Q steps (S % Q == 0), with dA = dt * A and cum its in-chunk
// cumulative sum, per (batch, head) and chunk:
//     y_i   = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//             + exp(cum_i) (C_i @ state^T)          (state entering the chunk)
//     state = exp(cum_{Q-1}) state
//             + sum_j x_j^T (B_j exp(cum_{Q-1} - cum_j) dt_j)
// state (P, N) starts at init_state (or 0); y (b, S, H, P) fp32 and the
// state after the last chunk, final (b, H, P, N) fp32, are written out.
//
// Bound: operations.  A chunk needs Q(Q+1)/2 (query, key) pairs of N + P
// multiply-adds (the scores and their product with x) and 2 Q N P more
// (the state's contribution and its update): at the serving path's shape
// (b 4, S 4096, H 48, P 64, N 128, Q 256) 6.5e10 FLOP in fp32 against
// 0.43 GB of x, y, B, C, dt and the final state, ~150 operations a byte.
//
// Design (simple first: fp32 FMAs on CUDA cores; the port runs with TF32
// off, so no tensor-core mma).  One block of 256 threads (16 x 16) per
// (batch, head) walks its chunks in order, as the TPU kernel's innermost
// grid axis did, and keeps the (P, N) state in shared memory across them.
// A whole chunk does not fit on chip at Q = 256 (its (Q, Q) score tile
// alone is 256 KB), so it is tiled by 64 rows: for each 64-row block of
// queries, C's rows are staged once, and key blocks are visited only up
// to the diagonal (the upper triangle of the decay matrix is zero); each
// key block stages B and x, forms the 64 x 64 masked, decayed scores in
// shared memory and adds their product with x to the queries' y, held in
// registers (4 x 4 a thread).  The last query block visits every key
// block of the chunk, so it also accumulates the state update in
// registers (4 x 8 a thread), which replaces the state after the chunk's
// queries have read it.  B and C are indexed by group and never repeated
// across heads.  Rows of B, C and the state are padded to N + 1 floats so
// that 16 threads reading one column hit 16 banks.  Shared memory is
// (P + 128)(N + 1) + 64 (P + 64) + 3 Q floats, 131 KB at the path's shape,
// above the default 48 KB: the launch opts in.  The decay is exp of a
// difference of cumulative sums (never a product of per-step factors),
// expf without fast-math, and exp is taken only where j <= i, so no
// inf * 0 arises when cum falls far below zero.  The cumulative sum is a
// warp scan of per-lane sequential sums; each dt * A is rounded before it
// is added, as the reference's dA is.
#include <cuda_runtime.h>

namespace {

constexpr int kSide = 16;                      // threads a side of the tile
constexpr int kThreads = kSide * kSide;
constexpr int kRows = 64;                      // rows of a query / key block
constexpr int kMaxP = 64;
constexpr int kMaxN = 128;
constexpr int kRT = kRows / kSide;             // query rows a thread
constexpr int kKT = kRows / kSide;             // key columns a thread
constexpr int kPT = kMaxP / kSide;             // head-dim columns a thread
constexpr int kNT = kMaxN / kSide;             // state columns a thread

// rows [0, rows) of a (kRows, cols) block from src (row stride `stride`)
// into dst (row stride `ld`); rows [rows, kRows) are zero.
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          long long stride, int rows,
                                          int cols, int ld) {
  for (int e = threadIdx.x; e < kRows * cols; e += kThreads) {
    const int r = e / cols;
    const int k = e - r * cols;
    dst[r * ld + k] = r < rows ? __ldg(src + r * stride + k) : 0.f;
  }
}

// cum[i] = sum_{k <= i} round(dts[k] * a), by lane of warp 0: each lane
// sums a contiguous segment, a shuffle scan adds the segments before it.
__device__ __forceinline__ void chunk_cumsum(const float* dts, float a,
                                             float* cum, int Q, int lane) {
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

__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const float* __restrict__ Bm,
                const float* __restrict__ Cm,
                const float* __restrict__ init, float* __restrict__ y,
                float* __restrict__ fin, int S, int H, int P, int G, int N,
                int Q) {
  extern __shared__ float smem[];
  const int NP = N + 1;
  float* st = smem;                            // (P, NP) state
  float* cs = st + P * NP;                     // (kRows, NP) C of the queries
  float* bs = cs + kRows * NP;                 // (kRows, NP) B of the keys
  float* xs = bs + kRows * NP;                 // (kRows, P) x of the keys
  float* ss = xs + kRows * P;                  // (kRows, kRows) masked scores
  float* cum = ss + kRows * kRows;             // (Q)
  float* dts = cum + Q;                        // (Q)
  float* wend = dts + Q;                       // (Q) exp(cum_last - cum_j) dt_j

  const int tid = threadIdx.x;
  const int ty = tid / kSide;
  const int tx = tid - ty * kSide;
  const int bh = blockIdx.x;                   // bi * H + h
  const int bi = bh / H;
  const int h = bh - bi * H;
  const int g = h / (H / G);
  const float a = A[h];
  const long long xstep = static_cast<long long>(H) * P;
  const long long bstep = static_cast<long long>(G) * N;
  const float* xb = x + static_cast<long long>(bi) * S * xstep +
                    static_cast<long long>(h) * P;
  float* yb = y + static_cast<long long>(bi) * S * xstep +
              static_cast<long long>(h) * P;
  const float* dtb = dt + static_cast<long long>(bi) * S * H + h;
  const float* Bb = Bm + static_cast<long long>(bi) * S * bstep +
                    static_cast<long long>(g) * N;
  const float* Cb = Cm + static_cast<long long>(bi) * S * bstep +
                    static_cast<long long>(g) * N;
  const long long sbase = static_cast<long long>(bh) * P * N;

  for (int e = tid; e < P * N; e += kThreads) {
    const int p = e / N;
    st[p * NP + (e - p * N)] = init != nullptr ? init[sbase + e] : 0.f;
  }

  const int nsub = (Q + kRows - 1) / kRows;
  const int nchunks = S / Q;
  for (int c = 0; c < nchunks; ++c) {
    const long long t0 = static_cast<long long>(c) * Q;
    __syncthreads();                 // the last chunk is done with smem
    for (int i = tid; i < Q; i += kThreads) dts[i] = dtb[(t0 + i) * H];
    __syncthreads();
    if (tid < 32) chunk_cumsum(dts, a, cum, Q, tid);
    __syncthreads();
    const float cum_last = cum[Q - 1];
    for (int i = tid; i < Q; i += kThreads) {
      wend[i] = expf(cum_last - cum[i]) * dts[i];
    }

    float acc_st[kRT][kNT];          // state (ty + 16 r, tx + 16 k)
    for (int qi = 0; qi < nsub; ++qi) {
      const int r0 = qi * kRows;
      const int rq = min(kRows, Q - r0);
      load_rows(cs, Cb + (t0 + r0) * bstep, bstep, rq, N, NP);
      __syncthreads();               // cs (and wend) visible

      // the state entering the chunk: exp(cum_i) (C_i @ state^T)
      float acc[kRT][kPT];
#pragma unroll
      for (int r = 0; r < kRT; ++r)
#pragma unroll
        for (int k = 0; k < kPT; ++k) acc[r][k] = 0.f;
      for (int n = 0; n < N; ++n) {
        float cv[kRT], sv[kPT];
#pragma unroll
        for (int r = 0; r < kRT; ++r) cv[r] = cs[(ty + kSide * r) * NP + n];
#pragma unroll
        for (int k = 0; k < kPT; ++k) {
          const int p = tx + kSide * k;
          sv[k] = p < P ? st[p * NP + n] : 0.f;
        }
#pragma unroll
        for (int r = 0; r < kRT; ++r)
#pragma unroll
          for (int k = 0; k < kPT; ++k) acc[r][k] = fmaf(cv[r], sv[k], acc[r][k]);
      }
#pragma unroll
      for (int r = 0; r < kRT; ++r) {
        const int i = r0 + ty + kSide * r;
        const float e = i < Q ? expf(cum[i]) : 0.f;
#pragma unroll
        for (int k = 0; k < kPT; ++k) acc[r][k] *= e;
      }

      // the last query block sees every key block: it also updates the state
      const bool last = qi == nsub - 1;
      if (last) {
        const float decay = expf(cum_last);
#pragma unroll
        for (int r = 0; r < kRT; ++r) {
          const int p = ty + kSide * r;
#pragma unroll
          for (int k = 0; k < kNT; ++k) {
            const int n = tx + kSide * k;
            acc_st[r][k] = (p < P && n < N) ? decay * st[p * NP + n] : 0.f;
          }
        }
      }

      for (int kj = 0; kj <= qi; ++kj) {
        const int k0 = kj * kRows;
        const int rk = min(kRows, Q - k0);
        load_rows(bs, Bb + (t0 + k0) * bstep, bstep, rk, N, NP);
        load_rows(xs, xb + (t0 + k0) * xstep, xstep, rk, P, P);
        __syncthreads();

        // scores C_i . B_j, then the causal mask, the decay and dt_j
        float s[kRT][kKT];
#pragma unroll
        for (int r = 0; r < kRT; ++r)
#pragma unroll
          for (int k = 0; k < kKT; ++k) s[r][k] = 0.f;
        for (int n = 0; n < N; ++n) {
          float cv[kRT], bv[kKT];
#pragma unroll
          for (int r = 0; r < kRT; ++r) cv[r] = cs[(ty + kSide * r) * NP + n];
#pragma unroll
          for (int k = 0; k < kKT; ++k) bv[k] = bs[(tx + kSide * k) * NP + n];
#pragma unroll
          for (int r = 0; r < kRT; ++r)
#pragma unroll
            for (int k = 0; k < kKT; ++k) s[r][k] = fmaf(cv[r], bv[k], s[r][k]);
        }
#pragma unroll
        for (int r = 0; r < kRT; ++r) {
          const int i = r0 + ty + kSide * r;
#pragma unroll
          for (int k = 0; k < kKT; ++k) {
            const int j = k0 + tx + kSide * k;
            ss[(ty + kSide * r) * kRows + tx + kSide * k] =
                (j <= i && i < Q)
                    ? s[r][k] * expf(cum[i] - cum[j]) * dts[j] : 0.f;
          }
        }
        __syncthreads();

        // y_i += sum_j scores_ij x_j  (rows j >= rk are zero in ss and xs)
        for (int jj = 0; jj < kRows; ++jj) {
          float sv[kRT], xv[kPT];
#pragma unroll
          for (int r = 0; r < kRT; ++r) sv[r] = ss[(ty + kSide * r) * kRows + jj];
#pragma unroll
          for (int k = 0; k < kPT; ++k) {
            const int p = tx + kSide * k;
            xv[k] = p < P ? xs[jj * P + p] : 0.f;
          }
#pragma unroll
          for (int r = 0; r < kRT; ++r)
#pragma unroll
            for (int k = 0; k < kPT; ++k) acc[r][k] = fmaf(sv[r], xv[k], acc[r][k]);
        }

        if (last) {
          // state += x_j^T (B_j exp(cum_last - cum_j) dt_j)
          for (int jj = 0; jj < rk; ++jj) {
            const float w = wend[k0 + jj];
            float xv[kRT], bv[kNT];
#pragma unroll
            for (int r = 0; r < kRT; ++r) {
              const int p = ty + kSide * r;
              xv[r] = p < P ? xs[jj * P + p] * w : 0.f;
            }
#pragma unroll
            for (int k = 0; k < kNT; ++k) {
              const int n = tx + kSide * k;
              bv[k] = n < N ? bs[jj * NP + n] : 0.f;
            }
#pragma unroll
            for (int r = 0; r < kRT; ++r)
#pragma unroll
              for (int k = 0; k < kNT; ++k)
                acc_st[r][k] = fmaf(xv[r], bv[k], acc_st[r][k]);
          }
        }
        __syncthreads();             // bs, xs and ss are free again
      }

#pragma unroll
      for (int r = 0; r < kRT; ++r) {
        const int row = ty + kSide * r;
        if (row >= rq) continue;
        float* yr = yb + (t0 + r0 + row) * xstep;
#pragma unroll
        for (int k = 0; k < kPT; ++k) {
          const int p = tx + kSide * k;
          if (p < P) yr[p] = acc[r][k];
        }
      }
    }

    // every read of the entering state is behind the last barrier
#pragma unroll
    for (int r = 0; r < kRT; ++r) {
      const int p = ty + kSide * r;
#pragma unroll
      for (int k = 0; k < kNT; ++k) {
        const int n = tx + kSide * k;
        if (p < P && n < N) st[p * NP + n] = acc_st[r][k];
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < P * N; e += kThreads) {
    const int p = e / N;
    fin[sbase + e] = st[p * NP + (e - p * N)];
  }
}

}  // namespace

// x, y (b, S, H, P); dt (b, S, H); A (H,); Bm, Cm (b, S, G, N); init
// (b, H, P, N) or null; fin (b, H, P, N); all fp32 and contiguous.
// P <= 64, N <= 128, H a multiple of G, S a multiple of Q.  Enqueues one
// launch on `stream` and returns its cudaError_t (0 = success); does not
// synchronise.
extern "C" int repro_ssd_scan(const void* x, const void* dt, const void* A,
                              const void* Bm, const void* Cm,
                              const void* init, void* y, void* fin,
                              long long b, long long S, long long H,
                              long long P, long long G, long long N,
                              long long Q, void* stream) {
  if (b <= 0 || S <= 0 || H <= 0 || P <= 0 || P > kMaxP || G <= 0 ||
      H % G != 0 || N <= 0 || N > kMaxN || Q <= 0 || S % Q != 0 ||
      S > 2147483647LL || b * H > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = sizeof(float) *
      static_cast<size_t>((P + 2 * kRows) * (N + 1) + kRows * P +
                          kRows * kRows + 3 * Q);
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem > static_cast<size_t>(optin)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(ssd_scan_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  ssd_scan_kernel<<<static_cast<unsigned int>(b * H), kThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const float*>(Bm),
      static_cast<const float*>(Cm), static_cast<const float*>(init),
      static_cast<float*>(y), static_cast<float*>(fin), static_cast<int>(S),
      static_cast<int>(H), static_cast<int>(P), static_cast<int>(G),
      static_cast<int>(N), static_cast<int>(Q));
  return static_cast<int>(cudaGetLastError());
}
