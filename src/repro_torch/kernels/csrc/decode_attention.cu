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
// fp32 and bf16 inputs; every product and sum is fp32.
//
// Bound: bytes.  A decode step reads each valid key and value once and
// does 4 G d operations on each (G query heads, two products): at the
// Qwen2-7B path's shape (G = 7, d = 128, bf16) that is 7 operations a
// byte, far below the card's 20 for fp32 on CUDA cores and 295 for bf16
// on tensor cores.  So: fp32 FMAs on CUDA cores, no tensor cores, and
// the one thing that matters is to stream the valid part of the cache
// through the SMs once, with 16-byte loads, on every SM.
//
// Design.  B * Hkv (32 at the path's shape) is far below 132 SMs, so the
// kv axis is split too (flash-decoding): kernel 1 runs one block of 128
// threads per (b, kv head, split of `chunk` keys).  The block holds the
// G query heads of its kv head in shared memory (fp32), walks its keys in
// tiles of kTile (32 up to d = 128, 16 above), staged in shared memory as
// fp32 with the next tile's 16-byte loads in flight in registers while
// the current one is used, and keeps fp32 running max m, sum l and
// accumulator acc (G x d) per query head.  Keys at or past the valid
// length are never loaded; a split wholly past it returns at once.  It
// writes (m, l, acc) of its split to fp32 scratch.  Kernel 2 runs one
// block per (b, kv head) and merges the valid splits:
//     M = max m_i,  o = sum_i exp(m_i - M) acc_i / max(sum_i exp(m_i - M) l_i, 1e-30).
// Scores: kTile keys x (128 / kTile) threads a key, each thread a strided
// quarter (or eighth) of d, reduced by warp shuffles.  Softmax: a warp a
// query head, a lane a key.  acc: a thread a column group of four and
// every (128 / column groups)-th query head, so each value it loads from
// shared memory serves all its heads.  Rows of the staged tiles are
// padded to 16 banks mod 32 so a quarter-warp's 16-byte reads hit 32
// banks.  expf, IEEE division, no fast-math.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGroup = 16;
constexpr int kMaxHeadDim = 256;
constexpr float kNegInf = -1e30f;
constexpr int kTileFloats = 4096;   // kTile * d at most: 32 x 128, 16 x 256

// 16 bytes of T: 4 fp32 or 8 bf16
template <typename T> struct Vec;
template <> struct Vec<float> { static constexpr int n = 4; };
template <> struct Vec<__nv_bfloat16> { static constexpr int n = 8; };

// the row stride of a staged tile: >= d and 16 banks past a multiple of 32
__host__ __device__ constexpr int padded(int d) {
  return ((d + 16 + 31) / 32) * 32 - 16;
}

__device__ __forceinline__ void store_vec(float* dst, uint4 u, float) {
  *reinterpret_cast<uint4*>(dst) = u;
}

__device__ __forceinline__ void store_vec(float* dst, uint4 u,
                                          __nv_bfloat16) {
  // eight bf16, low half first: a bf16 is the top 16 bits of an fp32
  float4 a = make_float4(__uint_as_float(u.x << 16),
                         __uint_as_float(u.x & 0xffff0000u),
                         __uint_as_float(u.y << 16),
                         __uint_as_float(u.y & 0xffff0000u));
  float4 b = make_float4(__uint_as_float(u.z << 16),
                         __uint_as_float(u.z & 0xffff0000u),
                         __uint_as_float(u.w << 16),
                         __uint_as_float(u.w & 0xffff0000u));
  reinterpret_cast<float4*>(dst)[0] = a;
  reinterpret_cast<float4*>(dst)[1] = b;
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
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

// One tile's 16-byte loads of k and v into registers, zeros past k_end:
// vector i is row i / rv, column (i % rv) * (16 / sizeof(T)).
template <typename T, int kLoads>
__device__ __forceinline__ void load_tile(uint4 (&kr)[kLoads],
                                          uint4 (&vr)[kLoads],
                                          const T* kb, const T* vb,
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
      const int col = (i - row * rv) * Vec<T>::n;
      kr[j] = __ldg(reinterpret_cast<const uint4*>(kb + key * k_ss + col));
      vr[j] = __ldg(reinterpret_cast<const uint4*>(vb + key * v_ss + col));
    }
  }
}

// Kernel 1: one block per (b * Hkv + h, split).
template <typename T, int kTile>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ lengths,
                    float* __restrict__ part_acc, float* __restrict__ part_ml,
                    int Hkv, int G, int d, int Skv, long long k_sb,
                    long long k_ss, long long k_sh, long long v_sb,
                    long long v_ss, long long v_sh, int chunk, float scale) {
  constexpr int kVec = Vec<T>::n;
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

  const T* qb = q + (static_cast<long long>(b) * Hq + h * G) * d;
  for (int i = tid; i < G * d; i += kThreads) qs[i] = to_float(qb[i]);
  for (int g = tid; g < G; g += kThreads) {
    sm[g] = kNegInf;
    sl[g] = 0.f;
  }
  const T* kb = k + b * k_sb + h * k_sh;
  const T* vb = v + b * v_sb + h * v_sh;

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
  for (int i = 0; i < kHeadsPerThread; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);

  // score ownership: key kk, column groups sj, sj + kLanes, ...
  const int kk = tid / kLanes;
  const int sj = tid % kLanes;

  load_tile<T, kLoads>(kr, vr, kb, vb, k_ss, v_ss, k_begin, k_end, rv,
                      nvec);
  for (int k0 = k_begin; k0 < k_end; k0 += kTile) {
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int i = tid + j * kThreads;
      if (i < nvec) {
        const int row = i / rv;
        const int col = (i - row * rv) * kVec;
        store_vec(ks + row * ld + col, kr[j], T());
        store_vec(vs + row * ld + col, vr[j], T());
      }
    }
    __syncthreads();                             // tile (and q, m, l) staged
    if (k0 + kTile < k_end) {
      load_tile<T, kLoads>(kr, vr, kb, vb, k_ss, v_ss, k0 + kTile, k_end, rv,
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

// Kernel 2: one block per (b * Hkv + h): merge the splits that hold keys.
template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_merge_kernel(const float* __restrict__ part_acc,
                    const float* __restrict__ part_ml,
                    const int* __restrict__ lengths, T* __restrict__ o,
                    int Hkv, int G, int d, int Skv, int chunk, int n_splits) {
  __shared__ float Ms[kMaxGroup], Ls[kMaxGroup];
  const int bh = blockIdx.x;
  const int b = bh / Hkv;
  const int h = bh - b * Hkv;
  const int len = min(lengths[b], Skv);
  const int used = len > 0 ? min(n_splits, (len + chunk - 1) / chunk) : 0;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const long long base = static_cast<long long>(bh) * n_splits;

  for (int g = tid >> 5; g < G; g += kWarps) {
    float m = kNegInf;
    for (int i = lane; i < used; i += 32)
      m = fmaxf(m, part_ml[((base + i) * G + g) * 2]);
    m = warp_max(m);
    float l = 0.f;
    for (int i = lane; i < used; i += 32) {
      const float* ml = part_ml + ((base + i) * G + g) * 2;
      l += expf(ml[0] - m) * ml[1];
    }
    l = warp_sum(l);
    if (lane == 0) {
      Ms[g] = m;
      Ls[g] = fmaxf(l, 1e-30f);
    }
  }
  __syncthreads();

  const int ncg = d / 4;
  const int Hq = Hkv * G;
  for (int e = tid; e < G * ncg; e += kThreads) {
    const int g = e / ncg;
    const int c = (e - g * ncg) * 4;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int i = 0; i < used; ++i) {
      const float w = expf(part_ml[((base + i) * G + g) * 2] - Ms[g]);
      const float4 p = *reinterpret_cast<const float4*>(
          part_acc + ((base + i) * G + g) * d + c);
      a.x = fmaf(w, p.x, a.x);
      a.y = fmaf(w, p.y, a.y);
      a.z = fmaf(w, p.z, a.z);
      a.w = fmaf(w, p.w, a.w);
    }
    const float L = Ls[g];
    store4(o + (static_cast<long long>(b) * Hq + h * G + g) * d + c,
           make_float4(a.x / L, a.y / L, a.z / L, a.w / L));
  }
}

template <typename T, int kTile>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* lengths, void* o, float* part_acc,
                   float* part_ml, long long B, long long Hkv, long long G,
                   long long Skv, long long d, const long long* ks,
                   const long long* vs, long long chunk, long long n_splits,
                   float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      static_cast<size_t>(G * d + 2 * kTile * padded(static_cast<int>(d)) +
                          G * kTile + 3 * G);
  auto kernel = decode_split_kernel<T, kTile>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(static_cast<unsigned int>(B * Hkv),
                  static_cast<unsigned int>(n_splits));
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, part_acc, part_ml,
      static_cast<int>(Hkv), static_cast<int>(G), static_cast<int>(d),
      static_cast<int>(Skv), ks[0], ks[1], ks[2], vs[0], vs[1], vs[2],
      static_cast<int>(chunk), scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_merge_kernel<T><<<static_cast<unsigned int>(B * Hkv), kThreads, 0,
                           stream>>>(
      part_acc, part_ml, lengths, static_cast<T*>(o), static_cast<int>(Hkv),
      static_cast<int>(G), static_cast<int>(d), static_cast<int>(Skv),
      static_cast<int>(chunk), static_cast<int>(n_splits));
  return cudaGetLastError();
}

}  // namespace

// q (B, Hq, d) contiguous; k and v (B, Skv, Hkv, d) with d contiguous and
// strides (batch, seq, head) in elements; lengths (B,) int32; o (B, Hq,
// d) of q's type; scratch part_acc (B*Hkv, n_splits, G, d) and part_ml
// (B*Hkv, n_splits, G, 2) fp32.  dtype 0 = fp32, 1 = bf16.  d a multiple
// of 8 up to 256, G = Hq / Hkv at most 16, chunk a multiple of the tile
// (32 keys up to d = 128, 16 above) with chunk * n_splits >= Skv.  All
// pointers and strides 16-byte aligned.  Enqueues two launches on
// `stream` and returns the cudaError_t (0 = success); does not
// synchronise.
extern "C" int repro_decode_attention(
    const void* q, const void* k, const void* v, const void* lengths,
    void* o, void* part_acc, void* part_ml, long long B, long long Hq,
    long long Hkv, long long Skv, long long d, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, long long chunk, long long n_splits, float scale,
    int dtype, void* stream) {
  const int tile = d <= 128 ? 32 : 16;
  if (B <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > kMaxGroup ||
      Hq / Hkv <= 0 || Skv <= 0 || Skv > 2147483647LL || d <= 0 ||
      d > kMaxHeadDim || d % 8 != 0 || chunk <= 0 || chunk % tile != 0 ||
      n_splits <= 0 || n_splits > 65535 || chunk * n_splits < Skv ||
      chunk * (n_splits - 1) >= Skv || B * Hkv > 2147483647LL) {
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
  if (dtype == 0 && tile == 32) {
    err = launch<float, 32>(q, k, v, len, o, pa, pm, B, Hkv, G, Skv, d, ks,
                            vs, chunk, n_splits, scale, s);
  } else if (dtype == 0) {
    err = launch<float, 16>(q, k, v, len, o, pa, pm, B, Hkv, G, Skv, d, ks,
                            vs, chunk, n_splits, scale, s);
  } else if (dtype == 1 && tile == 32) {
    err = launch<__nv_bfloat16, 32>(q, k, v, len, o, pa, pm, B, Hkv, G, Skv,
                                    d, ks, vs, chunk, n_splits, scale, s);
  } else if (dtype == 1) {
    err = launch<__nv_bfloat16, 16>(q, k, v, len, o, pa, pm, B, Hkv, G, Skv,
                                    d, ks, vs, chunk, n_splits, scale, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
