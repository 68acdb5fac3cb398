// Per-row symmetric int8 quantisation of the split boundary, for Hopper
// (sm_90a): a whole group of row segments in one launch, into one buffer.
//
// Replaces the TPU Pallas kernel repro/kernels/int8_quant.py::int8_quantize
// (body _kernel).  For each row segment x (T, d) fp32:
//     s[r]   = max(max_j |x[r, j]| / 127, 1e-12)
//     q[r,j] = clip(round_half_even(x[r, j] / s[r]), -127, 127)  as int8
//
// The result has to be bit-equal to the reference, so both divides are
// IEEE round-to-nearest (__fdiv_rn, never a multiply by the reciprocal)
// and the rounding is rintf (half to even).  Build without
// --use_fast_math and with denormals kept (-ftz=false, nvcc's default).
// A max is exact in any order, so splitting a row changes no bit.
//
// Bound: bytes.  Each element is read once as fp32 and written once as
// int8, each row adds one fp32 scale: 5 B per element + 4 B per row.  A
// diffusion group of B requests is its latent (4B, 4096) and its context
// (2B, 59136): 0.66 MB a request, a fifth of a microsecond at 3.35 TB/s,
// so the launch itself is the floor; what the design can still lose is
// launches, an unfilled card and copies around the kernel.
//
// Design.  One launch takes a table of up to 8 row segments by value (a
// kernel parameter, so no copy of the table to the device), and writes
// every segment's codes and scales into one output buffer at the byte
// offsets the table gives, so that one copy brings the whole group out.
// Each row is split across a thread-block cluster of C blocks (C up to 8,
// the same for the whole launch: the least that keeps every block's slice
// of the widest row in registers, kKeep floats a block).  A block reads
// its slice once into registers and reduces max|x| over it (warp shuffles,
// then one shared-memory step), and publishes the result in its shared
// memory.  After a cluster barrier every block reads the C partial maxima
// through distributed shared memory, computes the row's scale (rank 0
// stores it) and quantises its slice from registers; a second barrier
// keeps every block's shared memory alive until the others have read it.
// A cluster of one block (rows up to kKeep wide) takes block barriers
// instead: on the card a cluster barrier there cost ~1.3 µs a launch.
// x is read from device memory once.  A slice wider than the registers
// hold (rows wider than 8 * kKeep) is read again, from L2.  Loads are 16
// bytes a thread (float4 in, char4 out) where the row's start allows it,
// the row's last d % 4 elements are done by the last block, and a row
// that does not start on 16 bytes takes a scalar path.  Nothing is
// padded: T and d are bounds in the kernel.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 8;                  // float4 a thread keeps in registers
constexpr long long kKeep4 = static_cast<long long>(kVec) * kThreads;
constexpr long long kKeep = 4 * kKeep4;  // floats a block keeps: 8192
constexpr int kMaxCluster = 8;           // the portable cluster size
constexpr int kMaxSegments = 8;

struct Segment {
  const float* x;      // (rows, d) fp32, contiguous
  long long rows;
  long long d;
  long long q_off;     // byte offset of the segment's codes in the output
  long long s_off;     // byte offset of its scales (a multiple of 4)
};

struct Group {
  Segment seg[kMaxSegments];
  long long first_row[kMaxSegments];  // the segment's first row in the grid
  int n_seg;
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, offset));
  }
  return v;
}

__device__ __forceinline__ float abs_max4(float m, const float4 v) {
  return fmaxf(fmaxf(m, fmaxf(fabsf(v.x), fabsf(v.y))),
               fmaxf(fabsf(v.z), fabsf(v.w)));
}

__device__ __forceinline__ signed char quantize_one(float x, float scale) {
  float r = rintf(__fdiv_rn(x, scale));
  r = fminf(fmaxf(r, -127.0f), 127.0f);
  return static_cast<signed char>(static_cast<int>(r));
}

__device__ __forceinline__ char4 quantize4(const float4 v, float scale) {
  char4 o;
  o.x = quantize_one(v.x, scale);
  o.y = quantize_one(v.y, scale);
  o.z = quantize_one(v.z, scale);
  o.w = quantize_one(v.w, scale);
  return o;
}

// Grid: C blocks (one cluster) a row, rows numbered segment after segment.
__global__ void __launch_bounds__(kThreads)
int8_quantize_group_kernel(const __grid_constant__ Group g,
                           unsigned char* __restrict__ out) {
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const long long grid_row = blockIdx.x / csize;
  const int tid = threadIdx.x;

  // the segment that holds this row: a walk with constant indices, so the
  // table stays in parameter space
  Segment sg = g.seg[0];
  long long first = 0;
#pragma unroll
  for (int k = 1; k < kMaxSegments; ++k) {
    if (k < g.n_seg && grid_row >= g.first_row[k]) {
      sg = g.seg[k];
      first = g.first_row[k];
    }
  }
  const long long row = grid_row - first;
  const long long d = sg.d;
  const float* xr = sg.x + row * d;
  signed char* qr = reinterpret_cast<signed char*>(out + sg.q_off) + row * d;

  // this block's slice [lo, hi): float4 groups where the row starts on 16
  // bytes (its d % 4 last floats then go to the last block), else floats
  const bool vec = (reinterpret_cast<uintptr_t>(xr) & 15u) == 0 &&
                   (reinterpret_cast<uintptr_t>(qr) & 3u) == 0;
  const int di = static_cast<int>(d);        // d < 2^30: the C entry checks
  const int n = vec ? (di >> 2) : di;
  const int per = (n + csize - 1) / csize;
  const int lo = min(n, rank * per);
  const int hi = min(n, lo + per);
  const int cnt = hi - lo;
  const int tail = (vec && rank == csize - 1) ? (n << 2) : di;
  const bool keep = vec && cnt <= kKeep4;
  const float4* x4 = reinterpret_cast<const float4*>(xr) + lo;
  char4* q4 = reinterpret_cast<char4*>(qr) + lo;

  // pass 1: max |x| over the slice, kept in registers where it fits (all
  // loads issued before the first max)
  float m = 0.0f;
  float4 v[kVec];
  if (keep) {
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const int i = tid + k * kThreads;
      v[k] = (i < cnt) ? x4[i] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
#pragma unroll
    for (int k = 0; k < kVec; ++k) m = abs_max4(m, v[k]);
  } else if (vec) {
    for (int i = tid; i < cnt; i += kThreads) m = abs_max4(m, x4[i]);
  } else {
    for (int j = lo + tid; j < hi; j += kThreads) m = fmaxf(m, fabsf(xr[j]));
  }
  for (int j = tail + tid; j < di; j += kThreads) m = fmaxf(m, fabsf(xr[j]));

  // the row's max: the block's (warp shuffles, one shared-memory step),
  // then the cluster's through distributed shared memory.  A cluster of
  // one block takes block barriers: a cluster barrier costs more.
  __shared__ float warp_m[kWarps];
  __shared__ float block_m;     // max |x| over this block's slice
  __shared__ float scale_sh;
  m = warp_max(m);
  if ((tid & 31) == 0) warp_m[tid >> 5] = m;
  __syncthreads();
  if (tid < 32) {
    const float b = warp_max((tid < kWarps) ? warp_m[tid] : 0.0f);
    if (tid == 0) block_m = b;
  }
  if (csize > 1) cluster.sync(); else __syncthreads();
  if (tid < 32) {
    float r = 0.0f;
    if (tid < csize) {
      r = (csize > 1) ? *cluster.map_shared_rank(&block_m, tid) : block_m;
    }
    r = warp_max(r);
    if (tid == 0) {
      const float scale = fmaxf(__fdiv_rn(r, 127.0f), 1e-12f);
      scale_sh = scale;
      if (rank == 0) reinterpret_cast<float*>(out + sg.s_off)[row] = scale;
    }
  }
  // scale_sh is visible to the block, and no block of a cluster leaves
  // (freeing its shared memory) while another still reads its block_m
  if (csize > 1) cluster.sync(); else __syncthreads();
  const float scale = scale_sh;

  // pass 2: quantise the slice
  if (keep) {
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const int i = tid + k * kThreads;
      if (i < cnt) q4[i] = quantize4(v[k], scale);
    }
  } else if (vec) {
    for (int i = tid; i < cnt; i += kThreads) q4[i] = quantize4(x4[i], scale);
  } else {
    for (int j = lo + tid; j < hi; j += kThreads) {
      qr[j] = quantize_one(xr[j], scale);
    }
  }
  for (int j = tail + tid; j < di; j += kThreads) {
    qr[j] = quantize_one(xr[j], scale);
  }
}

// The same grid and cluster with no work: the floor of a launch.
__global__ void __launch_bounds__(kThreads) int8_empty_kernel() {}

// Blocks a row: the fewest that keep each block's slice of the widest row
// in registers, at most the portable cluster size.
int cluster_size(long long max_d) {
  const long long c = (max_d + kKeep - 1) / kKeep;
  return static_cast<int>(c < 1 ? 1 : (c > kMaxCluster ? kMaxCluster : c));
}

// Enqueues `kernel` with C blocks (one cluster) for each of `rows` rows.
cudaError_t launch_clusters(const void* kernel, void** args, long long rows,
                            long long max_d, cudaStream_t stream) {
  const int cluster = cluster_size(max_d);
  if (rows <= 0 || rows * cluster > 2147483647LL) {
    return cudaErrorInvalidValue;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned int>(rows * cluster));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned int>(cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelExC(&cfg, kernel, args);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

// n_seg row segments: xs[k] (rows[k], ds[k]) fp32 contiguous, on the
// device of `stream` -> the codes of segment k at byte q_offs[k] of `out`
// (rows[k] * ds[k] int8, row-major) and its scales at byte s_offs[k]
// (rows[k] fp32).  Enqueues one launch and returns the launch's
// cudaError_t (0 = success), a refused cluster launch included; does not
// synchronise.
extern "C" int repro_int8_quantize_group(
    const void* const* xs, const long long* rows, const long long* ds,
    const long long* q_offs, const long long* s_offs, int n_seg, void* out,
    void* stream) {
  if (n_seg < 1 || n_seg > kMaxSegments || out == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Group g = {};
  long long total = 0, max_d = 0;
  for (int k = 0; k < n_seg; ++k) {
    if (xs[k] == nullptr || rows[k] <= 0 || ds[k] <= 0 ||
        ds[k] >= (1LL << 30) || q_offs[k] < 0 || s_offs[k] < 0 ||
        (s_offs[k] & 3) != 0) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    g.seg[k] = {static_cast<const float*>(xs[k]), rows[k], ds[k], q_offs[k],
                s_offs[k]};
    g.first_row[k] = total;
    total += rows[k];
    if (ds[k] > max_d) max_d = ds[k];
  }
  g.n_seg = n_seg;
  unsigned char* q = static_cast<unsigned char*>(out);
  void* args[] = {&g, &q};
  return static_cast<int>(launch_clusters(
      reinterpret_cast<const void*>(int8_quantize_group_kernel), args, total,
      max_d, static_cast<cudaStream_t>(stream)));
}

// The grid and cluster a group of `rows` rows of width at most `max_d`
// gets, launched with no work: what no design of this kernel can beat.
extern "C" int repro_int8_empty_launch(long long rows, long long max_d,
                                       void* stream) {
  return static_cast<int>(launch_clusters(
      reinterpret_cast<const void*>(int8_empty_kernel), nullptr, rows, max_d,
      static_cast<cudaStream_t>(stream)));
}
