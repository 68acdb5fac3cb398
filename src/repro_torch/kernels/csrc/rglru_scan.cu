// RG-LRU linear recurrence, for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel repro/kernels/rglru_scan.py::rglru_scan
// (body _kernel).  For a, b (B, S, W) fp32 and h0 (B, W) fp32 or none:
//     h[:, t] = a[:, t] * h[:, t-1] + b[:, t],   h[:, -1] = h0 (or 0)
// per channel, every h (B, S, W) fp32 written out.
//
// Bound: bytes.  Each element of a and b is read once and each h written
// once, 12 bytes for two operations: at the serving path's (4, 4096,
// 4096) that is 0.81 GB, 0.24 ms at 3.35 TB/s.
//
// Design: one thread per (batch, channel) walks time itself, as the TPU
// kernel's innermost grid axis did; neighbouring threads take
// neighbouring channels, so each time step is one coalesced row of a
// warp.  The loads of kUnroll steps are issued before the recurrence
// consumes them (they do not depend on h), which keeps 2 * kUnroll loads
// in flight a thread.  At B * W = 16,384 threads the path fills about
// one wave of the card; a time-blocked parallel scan would be the next
// step if the walk proves latency-bound.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;
constexpr int kUnroll = 8;

__global__ void __launch_bounds__(kThreads)
rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  const float* __restrict__ h0, float* __restrict__ h,
                  long long B, long long S, long long W) {
  const long long idx = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= B * W) return;
  const long long bi = idx / W;
  const long long c = idx - bi * W;
  float hv = h0 != nullptr ? h0[idx] : 0.f;
  long long off = bi * S * W + c;
  long long t = 0;
  for (; t + kUnroll <= S; t += kUnroll) {
    float av[kUnroll], bv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      av[u] = __ldg(a + off + u * W);
      bv[u] = __ldg(b + off + u * W);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      hv = fmaf(av[u], hv, bv[u]);
      h[off + u * W] = hv;
    }
    off += kUnroll * W;
  }
  for (; t < S; ++t, off += W) {
    hv = fmaf(__ldg(a + off), hv, __ldg(b + off));
    h[off] = hv;
  }
}

}  // namespace

// a, b, h (B, S, W) fp32 contiguous; h0 (B, W) fp32 contiguous or null.
// Enqueues one launch on `stream` and returns its cudaError_t (0 =
// success); does not synchronise.
extern "C" int repro_rglru_scan(const void* a, const void* b, const void* h0,
                                void* h, long long B, long long S,
                                long long W, void* stream) {
  if (B <= 0 || S <= 0 || W <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long blocks = (B * W + kThreads - 1) / kThreads;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  rglru_scan_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(h0), static_cast<float*>(h), B, S, W);
  return static_cast<int>(cudaGetLastError());
}
