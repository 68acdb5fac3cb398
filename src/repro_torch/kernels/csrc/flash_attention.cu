// Prefill flash attention (online softmax), for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel
// repro/kernels/flash_attention.py::flash_attention (body _kernel).  In
// the kernel layout, with head minor in the folded leading dimension:
//     q (BHq, Sq, d), k and v (BHkv, Skv, d), o (BHq, Sq, d) in q's type,
//     kv head of q head bh = bh / (BHq / BHkv)          (GQA / MQA)
//     s = (q . k) * scale, masked where k_pos >= kv_len, or (causal)
//         k_pos > q_pos, or (window) k_pos <= q_pos - window, to -1e30
//     o = sum_k softmax(s)_k v_k, with running max m, sum l and
//         accumulator acc in fp32, o = acc / max(l, 1e-30).
// fp32 and bf16 inputs; every product and sum is fp32.
//
// Bound: operations.  At the serving path's shape (64 q heads x 4096
// rows, d = 256, causal, window 2048) the work is 4 * d * sum_q min(q+1,
// 2048) per head, 0.41 TFLOP a layer, against 0.29 GB of q, k, v and o:
// about 1,400 operations a byte, far above the card's 295 for bf16.
//
// Design (simple first: CUDA cores, no tensor cores, TMA or wgmma yet).
// One block of 256 threads per (q head, 64-row block of queries); four
// neighbouring threads share one query row, each holding a quarter of
// its columns (float4 groups 16 columns apart) for q and for the
// accumulator, in registers.  The block walks key tiles of kKeys rows
// from max(0, q_start - window + 1) to the causal limit, so tiles wholly
// outside the window or above the diagonal are never loaded.  A tile of
// k and v is staged in shared memory as fp32 (at d = 256 and 16 keys:
// 32 KB, inside the default 48 KB, so no opt-in is needed).  A score is
// the four threads' partial dots summed by two warp shuffles; every
// thread of the row then keeps the row's softmax state itself.  expf,
// IEEE division, no fast-math: the result stays within 5e-6 of the
// plain fp32 version.  Ragged Sq, Skv and kv_len are bounds, not
// padding.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 4;                        // threads a query row
constexpr int kRows = kThreads / kLanes;         // query rows a block
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  // four bf16, low half first: a bf16 is the top 16 bits of an fp32
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
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

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// NJ float4 groups a thread: head_dim up to 16 * NJ.  kKeys keys a tile.
template <typename T, int NJ, int kKeys>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o,
                       int n_qblocks, int group, int Sq, int Skv, int d,
                       int kv_len, int causal, int window, float scale) {
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
  const T* qrow = q + (static_cast<long long>(bh) * Sq + (row_ok ? qi : 0)) * d;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int c = 16 * j + 4 * lane;
    qr[j] = (row_ok && c < d) ? load4(qrow + c) : make_float4(0.f, 0.f, 0.f, 0.f);
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
        const long long off = kv_base + static_cast<long long>(k0 + kr) * d + c;
        kv4 = load4(k + off);
        vv4 = load4(v + off);
      }
      store4(ks + kr * d + c, kv4);
      store4(vs + kr * d + c, vv4);
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
        if (c < d) part = dot4(qr[j], *reinterpret_cast<const float4*>(krow + c), part);
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
  T* orow = o + (static_cast<long long>(bh) * Sq + qi) * d;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int c = 16 * j + 4 * lane;
    if (c < d) {
      store4(orow + c, make_float4(acc[j].x / denom, acc[j].y / denom,
                                   acc[j].z / denom, acc[j].w / denom));
    }
  }
}

template <typename T, int NJ, int kKeys>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   long long BHq, long long BHkv, long long Sq, long long Skv,
                   long long d, long long kv_len, int causal, long long window,
                   float scale, cudaStream_t stream) {
  const long long n_qblocks = (Sq + kRows - 1) / kRows;
  const long long blocks = BHq * n_qblocks;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  const size_t smem = 2 * kKeys * static_cast<size_t>(d) * sizeof(float);
  flash_attention_kernel<T, NJ, kKeys>
      <<<static_cast<unsigned int>(blocks), kThreads, smem, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<T*>(o),
          static_cast<int>(n_qblocks), static_cast<int>(BHq / BHkv),
          static_cast<int>(Sq), static_cast<int>(Skv), static_cast<int>(d),
          static_cast<int>(kv_len), causal, static_cast<int>(window), scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_head_dim(const void* q, const void* k, const void* v,
                              void* o, long long BHq, long long BHkv,
                              long long Sq, long long Skv, long long d,
                              long long kv_len, int causal, long long window,
                              float scale, cudaStream_t stream) {
  if (d <= 64)
    return launch<T, 4, 32>(q, k, v, o, BHq, BHkv, Sq, Skv, d, kv_len,
                            causal, window, scale, stream);
  if (d <= 128)
    return launch<T, 8, 32>(q, k, v, o, BHq, BHkv, Sq, Skv, d, kv_len,
                            causal, window, scale, stream);
  return launch<T, 16, 16>(q, k, v, o, BHq, BHkv, Sq, Skv, d, kv_len,
                           causal, window, scale, stream);
}

}  // namespace

// q (BHq, Sq, d), k and v (BHkv, Skv, d) contiguous and 16-byte aligned,
// o (BHq, Sq, d) of the same type; dtype 0 = fp32, 1 = bf16.  d is a
// multiple of 4 up to 256, BHq a multiple of BHkv, 0 < kv_len <= Skv,
// window 0 = none.  Enqueues one launch on `stream` and returns its
// cudaError_t (0 = success); does not synchronise.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, long long BHq,
                                     long long BHkv, long long Sq,
                                     long long Skv, long long d,
                                     long long kv_len, int causal,
                                     long long window, float scale,
                                     int dtype, void* stream) {
  if (BHq <= 0 || BHkv <= 0 || BHq % BHkv != 0 || Sq <= 0 || Skv <= 0 ||
      d <= 0 || d > 256 || d % 4 != 0 || kv_len <= 0 || kv_len > Skv ||
      window < 0 || Sq > 2147483647LL || Skv > 2147483647LL ||
      window > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = dispatch_head_dim<float>(q, k, v, o, BHq, BHkv, Sq, Skv, d, kv_len,
                                   causal, window, scale, s);
  } else if (dtype == 1) {
    err = dispatch_head_dim<__nv_bfloat16>(q, k, v, o, BHq, BHkv, Sq, Skv, d,
                                           kv_len, causal, window, scale, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
