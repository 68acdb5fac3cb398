// Per-row symmetric int8 quantisation of the split boundary, for Hopper
// (sm_90a).
//
// Replaces the TPU Pallas kernel repro/kernels/int8_quant.py::int8_quantize
// (body _kernel).  For x (T, d) fp32:
//     s[r]   = max(max_j |x[r, j]| / 127, 1e-12)
//     q[r,j] = clip(round_half_even(x[r, j] / s[r]), -127, 127)  as int8
//
// The result has to be bit-equal to the reference, so both divides are
// IEEE round-to-nearest (__fdiv_rn, never a multiply by the reciprocal)
// and the rounding is rintf (half to even).  Build without
// --use_fast_math and with denormals kept (-ftz=false, nvcc's default).
//
// Bound: bytes.  Each element is read once as fp32 and written once as
// int8, each row adds one fp32 scale: 5 B per element + 4 B per row.  On
// the serving path the latent is (4, 4096), 80 KB, and the context is
// (2, 59136), 577 KB: well under a microsecond at 3.35 TB/s, so launch
// latency is the real floor, and two rows fill two of the card's 132 SMs.
//
// Design: one thread block per row.  Pass 1 is a block-stride loop for
// max|x| (warp shuffles, then one shared-memory step); pass 2 reads the
// row again (it sits in L2 at these sizes), divides, rounds, clamps and
// stores int8.  Loads are 16 bytes a thread (float4 in, char4 out) when
// the row is 16-byte aligned, scalar otherwise; a ragged d is finished by
// a scalar tail.  Nothing is padded: T and d are bounds in the kernel.
// Splitting a wide row across blocks and quantising a whole group in one
// launch are the later redesign.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

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

__global__ void __launch_bounds__(kThreads)
int8_quantize_rows_kernel(const float* __restrict__ x,
                          signed char* __restrict__ q,
                          float* __restrict__ s,
                          long long T, long long d) {
  const long long row = blockIdx.x;
  if (row >= T) return;
  const int tid = threadIdx.x;
  const float* xr = x + row * d;
  signed char* qr = q + row * d;

  const bool aligned =
      (reinterpret_cast<uintptr_t>(xr) & 15u) == 0 &&
      (reinterpret_cast<uintptr_t>(qr) & 3u) == 0;
  const long long n4 = aligned ? (d >> 2) : 0;   // float4 groups in the row
  const float4* x4 = reinterpret_cast<const float4*>(xr);
  char4* q4 = reinterpret_cast<char4*>(qr);

  // pass 1: max |x| over the row
  float m = 0.0f;
  for (long long i = tid; i < n4; i += kThreads) {
    m = abs_max4(m, x4[i]);
  }
  for (long long j = (n4 << 2) + tid; j < d; j += kThreads) {
    m = fmaxf(m, fabsf(xr[j]));
  }
  __shared__ float warp_m[kWarps];
  __shared__ float scale_sh;
  m = warp_max(m);
  if ((tid & 31) == 0) warp_m[tid >> 5] = m;
  __syncthreads();
  if (tid < 32) {
    float v = (tid < kWarps) ? warp_m[tid] : 0.0f;
    v = warp_max(v);
    if (tid == 0) {
      const float scale = fmaxf(__fdiv_rn(v, 127.0f), 1e-12f);
      scale_sh = scale;
      s[row] = scale;
    }
  }
  __syncthreads();
  const float scale = scale_sh;

  // pass 2: quantise
  for (long long i = tid; i < n4; i += kThreads) {
    const float4 v = x4[i];
    char4 o;
    o.x = quantize_one(v.x, scale);
    o.y = quantize_one(v.y, scale);
    o.z = quantize_one(v.z, scale);
    o.w = quantize_one(v.w, scale);
    q4[i] = o;
  }
  for (long long j = (n4 << 2) + tid; j < d; j += kThreads) {
    qr[j] = quantize_one(xr[j], scale);
  }
}

}  // namespace

// x (T, d) fp32 contiguous -> q (T, d) int8, s (T,) fp32, all on the
// device of `stream`.  Enqueues one launch and returns the launch's
// cudaError_t (0 = success); does not synchronise.
extern "C" int repro_int8_quantize_rows(const void* x, void* q, void* s,
                                        long long T, long long d,
                                        void* stream) {
  if (T <= 0 || d <= 0 || T > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int8_quantize_rows_kernel<<<static_cast<unsigned int>(T), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<signed char*>(q),
      static_cast<float*>(s), T, d);
  return static_cast<int>(cudaGetLastError());
}
