// Decode attention for Hopper (sm_90a): one query token against a
// ring-buffer KV cache, bfloat16 or float32.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/decode_attention/kernel.py::decode_attention_kernel.
// For q (B,Hq,hd), a cache k, v (B,T,Hkv,hd) with slot positions
// kv_pos (B,T) (INT32_MAX marks an empty slot) and the query positions
// q_pos (B,), it computes per q head h, with kv head h / (Hq / Hkv),
//     o = sum_t softmax_t(q . k[t] / sqrt(hd)) v[t]
// where slot t counts when kv_pos[t] <= q_pos (and q_pos - kv_pos[t] <
// window when a window is set). Masked scores are -1e30, as in the
// reference, so the result equals its dense softmax.
//
// What bounds it on an H100: the cache. Each K and V slot that the mask
// allows is needed once per (b, kv head) and used for 2 hd operations per
// q head, far below the ~295 operations per byte where the tensor cores
// would start to bind: at B = 2, Hkv = 2, hd = 128 in bf16 with 544
// slots filled, about 1.1 MB, or 0.34 us at 3.35 TB/s. This kernel reads
// every slot of the cache (T = 1024: 2.1 MB), masked or not.
//
// Design. The TPU grid is (b, q head, kv block), so every q head of a
// GQA group streams the same K/V blocks again. Here one block per
// (kv head, b) computes all G = Hq / Hkv query heads of its group, so
// each K/V tile is read from device memory once. The block loops over T
// in tiles of 64 slots staged through shared memory in f32 (rows padded
// to hd + 1 words so that threads walking slots hit distinct banks): the
// G x 64 scores are computed one (head, slot) pair per thread, one warp
// per head updates that head's online softmax (m, l), and one thread per
// (head, dim) rescales and accumulates its output in shared memory. The
// mask is read from kv_pos, never from slot indices, so a wrapped ring
// needs nothing special. At B = 2, Hkv = 2 the grid is only 4 blocks on
// 132 SMs; splitting T across blocks (flash-decoding) is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBT = 64;           // cache slots per shared-memory tile
constexpr float kMasked = -1e30f; // the reference's mask value
constexpr size_t kMaxSmem = 232448;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Strides {  // in elements
  long long b, s, h;
};

size_t smem_bytes(int hd, int G) {
  return sizeof(float) * (2 * (size_t)kBT * (hd + 1) + 2 * (size_t)G * hd
                          + (size_t)G * kBT + 3 * (size_t)G)
         + sizeof(int) * kBT;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const int* __restrict__ kv_pos,
                        const int* __restrict__ q_pos, T* __restrict__ o,
                        Strides qs, Strides ks, Strides vs, int T_, int hd,
                        int G, int window, float scale) {
  extern __shared__ float smem[];
  const int ld = hd + 1;
  float* k_s = smem;                      // kBT x ld
  float* v_s = k_s + kBT * ld;            // kBT x ld
  float* q_s = v_s + kBT * ld;            // G x hd, pre-scaled
  float* acc = q_s + G * hd;              // G x hd
  float* p_s = acc + G * hd;              // G x kBT scores, then weights
  float* m_s = p_s + G * kBT;             // G
  float* l_s = m_s + G;                   // G
  float* c_s = l_s + G;                   // G: this tile's rescale factor
  int* pos_s = reinterpret_cast<int*>(c_s + G);  // kBT

  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const long long qp = q_pos[b];

  for (int e = tid; e < G * hd; e += kThreads) {
    const int g = e / hd;
    const int d = e % hd;
    q_s[e] = to_f32(q[b * qs.b + (long long)(hk * G + g) * qs.h + d]) * scale;
    acc[e] = 0.0f;
  }
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = kMasked;
    l_s[g] = 0.0f;
  }

  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;
  const int* pb = kv_pos + (long long)b * T_;
  for (int t0 = 0; t0 < T_; t0 += kBT) {
    const int n = min(kBT, T_ - t0);
    __syncthreads();                      // the previous tile is consumed
#pragma unroll 4
    for (int e = tid; e < kBT * hd; e += kThreads) {
      const int j = e / hd;
      const int d = e % hd;
      const bool in = j < n;
      k_s[j * ld + d] = in ? to_f32(kb[(long long)(t0 + j) * ks.s + d]) : 0.0f;
      v_s[j * ld + d] = in ? to_f32(vb[(long long)(t0 + j) * vs.s + d]) : 0.0f;
    }
    for (int j = tid; j < kBT; j += kThreads) pos_s[j] = j < n ? pb[t0 + j] : 0;
    __syncthreads();

    // scores, one (head, slot) pair per thread
    for (int e = tid; e < G * kBT; e += kThreads) {
      const int g = e / kBT;
      const int j = e % kBT;
      float s = -INFINITY;                // past T: no such slot
      if (j < n) {
        const float* qr = q_s + g * hd;
        const float* kr = k_s + j * ld;
        float dot = 0.0f;
        for (int d = 0; d < hd; ++d) dot = fmaf(qr[d], kr[d], dot);
        const long long kp = pos_s[j];
        bool ok = kp <= qp;
        if (window) ok = ok && (qp - kp < window);
        s = ok ? dot : kMasked;
      }
      p_s[e] = s;
    }
    __syncthreads();

    // online softmax, one warp per head
    for (int g = warp; g < G; g += kWarps) {
      float* pr = p_s + g * kBT;
      float mx = -INFINITY;
      for (int j = lane; j < kBT; j += 32) mx = fmaxf(mx, pr[j]);
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.0f;
      for (int j = lane; j < kBT; j += 32) {
        const float p = expf(pr[j] - m_new);
        pr[j] = p;
        sum += p;
      }
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      __syncwarp();
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        c_s[g] = corr;
        l_s[g] = l_s[g] * corr + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // rescale and accumulate, one (head, dim) per thread
    for (int e = tid; e < G * hd; e += kThreads) {
      const int g = e / hd;
      const int d = e % hd;
      const float* pr = p_s + g * kBT;
      float a = acc[e] * c_s[g];
      for (int j = 0; j < n; ++j) a = fmaf(pr[j], v_s[j * ld + d], a);
      acc[e] = a;
    }
  }
  __syncthreads();

  for (int e = tid; e < G * hd; e += kThreads) {
    const int g = e / hd;
    const float l = l_s[g];
    const float den = (l == 0.0f) ? 1.0f : l;
    o[((long long)b * G * gridDim.x + (long long)hk * G) * hd + e] =
        from_f32<T>(acc[e] / den);
  }
}

template <typename T>
int launch_typed(const void* q, const void* k, const void* v,
                 const int* kv_pos, const int* q_pos, void* o, Strides qs,
                 Strides ks, Strides vs, int B, int T_, int Hq, int Hkv,
                 int hd, int window, cudaStream_t stream) {
  const int G = Hq / Hkv;
  const size_t smem = smem_bytes(hd, G);
  cudaError_t err = cudaFuncSetAttribute(
      decode_attention_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(Hkv, B);
  decode_attention_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), kv_pos, q_pos, static_cast<T*>(o), qs, ks,
      vs, T_, hd, G, window, 1.0f / sqrtf((float)hd));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches on `stream`; returns a cudaError_t (0 = ok). q (B,Hq,hd) and
// k, v (B,T,Hkv,hd) are device pointers with the given element strides
// (for q the sequence stride is unused) and a contiguous head dim;
// kv_pos (B,T) and q_pos (B,) are contiguous int32; o (B,Hq,hd) is
// contiguous. dtype: 0 = float32, 1 = bfloat16. hd must be a multiple of
// 8 up to 256, Hq a multiple of Hkv, and the block's shared memory
// (2 * 64 * (hd + 1) + 2 * G * hd + 64 * G + 3 * G floats and 64 ints,
// G = Hq / Hkv) at most 227 KB.
int decode_attention_launch(const void* q, const void* k, const void* v,
                            const int* kv_pos, const int* q_pos, void* o,
                            long long qsb, long long qsh, long long ksb,
                            long long kss, long long ksh, long long vsb,
                            long long vss, long long vsh, int B, int T_,
                            int Hq, int Hkv, int hd, int window, int dtype,
                            void* stream) {
  if (hd <= 0 || hd > 256 || hd % 8 || Hkv <= 0 || Hq % Hkv ||
      B > 65535 || Hkv > 65535 || (dtype != 0 && dtype != 1) ||
      smem_bytes(hd, Hq / Hkv) > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0 || Hq <= 0) return 0;
  const Strides qs{qsb, 0, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_typed<float>(q, k, v, kv_pos, q_pos, o, qs, ks, vs, B, T_,
                               Hq, Hkv, hd, window, st);
  return launch_typed<__nv_bfloat16>(q, k, v, kv_pos, q_pos, o, qs, ks, vs,
                                     B, T_, Hq, Hkv, hd, window, st);
}

const char* decode_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
