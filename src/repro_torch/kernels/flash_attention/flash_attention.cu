// Causal GQA flash attention for Hopper (sm_90a), bfloat16 or float32.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention/kernel.py::flash_attention_kernel.
// For q (B,Sq,Hq,hd) and k, v (B,Skv,Hkv,hd) it computes, per q head h
// and its kv head h / (Hq / Hkv),
//     o[i] = sum_j softmax_j(q[i] . k[j] / sqrt(hd)) v[j]
// over the keys j that the mask allows (j <= i when causal, i - j <
// window when a window is set; the q row at index i has position i).
// Masked scores are -1e30, as in the reference, and a row whose running
// sum is 0 is divided by 1 (the `_emit` guard of the TPU kernel).
//
// What bounds it on an H100: 4 hd operations per allowed (q, k) pair,
// against the q, k, v and o bytes read or written once. At the prefill
// shape (B = 2, S = 512, Hq = 12, Hkv = 2, hd = 128, bf16) that is
// 1.6 GFLOP against 7.3 MB: 1.6 us on the tensor cores, 2.2 us of bytes,
// so the bytes bound it, barely. At S = 4096 the 52 GFLOP bind (52 us
// against 8.8 us of bytes); at the split-serving shape (S = 32) the
// 0.46 MB of bytes do (0.14 us). This kernel does its products on the
// f32 CUDA cores (67 TFLOP/s), each multiply-add fed by a shared-memory
// load, not on the tensor cores, so it cannot reach the bound; it is the
// simple, right version that later work makes fast.
//
// Design. The TPU grid walks kv blocks in order with the softmax state
// in scratch; on Hopper blocks run in parallel and in no order, so the kv
// loop lives inside a block. One block per (q tile of 64 rows, q head,
// batch row); causal tiles are issued longest first. Each q row belongs
// to MAXD / 32 neighbouring threads, each holding 32 of its head dims
// (interleaved, so the threads of a row read neighbouring shared-memory
// words) of q, pre-scaled by 1/sqrt(hd), and of the f32 accumulator.
// K and V tiles of 64 rows are staged through shared memory in f32; a row
// reduces its dot products with warp shuffles and updates its online
// softmax (m, l, acc) every 16 keys. Tiles wholly above the diagonal or
// outside the window are never loaded. Ragged Sq and Skv are masked here:
// nothing is padded or copied. Strides are taken for the batch, sequence
// and head dims; the head dim must be contiguous.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBQ = 64;           // q rows per block
constexpr int kBK = 64;           // kv rows per shared-memory tile
constexpr int kChunk = 16;        // kv rows per online-softmax update
constexpr int kSlice = 32;        // head dims held by one thread
constexpr float kMasked = -1e30f; // the reference's mask value

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

template <typename T, int MAXD>
__global__ void __launch_bounds__(kBQ * (MAXD / kSlice))
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o,
                       Strides qs, Strides ks, Strides vs, Strides os,
                       int Sq, int Skv, int hd, int group, int causal,
                       int window, float scale) {
  constexpr int TPR = MAXD / kSlice;      // threads per q row
  constexpr int NT = kBQ * TPR;
  extern __shared__ float smem[];
  float* k_s = smem;                      // kBK x MAXD
  float* v_s = smem + kBK * MAXD;         // kBK x MAXD

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // longest rows first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / group;
  const int tid = threadIdx.x;
  const int sl = tid % TPR;
  const int qi = q0 + tid / TPR;          // this thread's q row
  const bool live = qi < Sq;

  float qr[kSlice];
  float acc[kSlice];
  const T* qp = q + b * qs.b + (long long)(live ? qi : 0) * qs.s + h * qs.h;
#pragma unroll
  for (int i = 0; i < kSlice; ++i) {
    const int d = i * TPR + sl;
    qr[i] = (live && d < hd) ? to_f32(qp[d]) * scale : 0.0f;
    acc[i] = 0.0f;
  }
  float m = kMasked;
  float l = 0.0f;

  // the kv tiles some row of this q tile may attend to
  const int q_last = min(q0 + kBQ, Sq) - 1;
  const int kv_end = causal ? min(Skv, q_last + 1) : Skv;
  const int kv_begin = window ? max(0, q0 - window + 1) : 0;
  const int t_lo = kv_begin / kBK;
  const int t_hi = (kv_end + kBK - 1) / kBK;

  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;
  for (int t = t_lo; t < t_hi; ++t) {
    const int k0 = t * kBK;
    const int n_here = min(kBK, Skv - k0);
    __syncthreads();                      // the previous tile is consumed
    for (int e = tid; e < kBK * MAXD; e += NT) {
      const int j = e / MAXD;
      const int d = e % MAXD;
      const bool in = j < n_here && d < hd;
      k_s[e] = in ? to_f32(kb[(long long)(k0 + j) * ks.s + d]) : 0.0f;
      v_s[e] = in ? to_f32(vb[(long long)(k0 + j) * vs.s + d]) : 0.0f;
    }
    __syncthreads();
    for (int c = 0; c < n_here; c += kChunk) {
      float sc[kChunk];
      float cmax = kMasked;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const float* kr = k_s + (c + jj) * MAXD;
        float dot = 0.0f;
#pragma unroll
        for (int i = 0; i < kSlice; ++i) dot = fmaf(qr[i], kr[i * TPR + sl], dot);
#pragma unroll
        for (int off = TPR / 2; off > 0; off >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        const int j = k0 + c + jj;
        float s;
        if (c + jj >= n_here) {
          s = -INFINITY;                  // past Skv: no such key
        } else {
          bool ok = !causal || j <= qi;
          if (window) ok = ok && (qi - j < window);
          s = ok ? dot : kMasked;
        }
        sc[jj] = s;
        cmax = fmaxf(cmax, s);
      }
      const float m_new = fmaxf(m, cmax);
      const float corr = expf(m - m_new);
      l *= corr;
#pragma unroll
      for (int i = 0; i < kSlice; ++i) acc[i] *= corr;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const float p = expf(sc[jj] - m_new);
        l += p;
        const float* vr = v_s + (c + jj) * MAXD;
#pragma unroll
        for (int i = 0; i < kSlice; ++i) acc[i] = fmaf(p, vr[i * TPR + sl], acc[i]);
      }
      m = m_new;
    }
  }

  if (live) {
    const float den = (l == 0.0f) ? 1.0f : l;
    T* op = o + b * os.b + (long long)qi * os.s + h * os.h;
#pragma unroll
    for (int i = 0; i < kSlice; ++i) {
      const int d = i * TPR + sl;
      if (d < hd) op[d] = from_f32<T>(acc[i] / den);
    }
  }
}

template <typename T, int MAXD>
int launch_typed(const void* q, const void* k, const void* v, void* o,
                 Strides qs, Strides ks, Strides vs, Strides os, int B,
                 int Sq, int Skv, int Hq, int Hkv, int hd, int causal,
                 int window, cudaStream_t stream) {
  constexpr int threads = kBQ * (MAXD / kSlice);
  const size_t smem = 2 * (size_t)kBK * MAXD * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, MAXD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + kBQ - 1) / kBQ, Hq, B);
  flash_attention_kernel<T, MAXD><<<grid, threads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), qs, ks, vs, os, Sq, Skv,
      hd, Hq / Hkv, causal, window, 1.0f / sqrtf((float)hd));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dispatch(const void* q, const void* k, const void* v, void* o,
                    Strides qs, Strides ks, Strides vs, Strides os, int B,
                    int Sq, int Skv, int Hq, int Hkv, int hd, int causal,
                    int window, cudaStream_t stream) {
  if (hd <= 64)
    return launch_typed<T, 64>(q, k, v, o, qs, ks, vs, os, B, Sq, Skv, Hq,
                               Hkv, hd, causal, window, stream);
  if (hd <= 128)
    return launch_typed<T, 128>(q, k, v, o, qs, ks, vs, os, B, Sq, Skv, Hq,
                                Hkv, hd, causal, window, stream);
  return launch_typed<T, 256>(q, k, v, o, qs, ks, vs, os, B, Sq, Skv, Hq,
                              Hkv, hd, causal, window, stream);
}

}  // namespace

extern "C" {

// Launches on `stream`; returns a cudaError_t (0 = ok). q (B,Sq,Hq,hd),
// k and v (B,Skv,Hkv,hd) and o (B,Sq,Hq,hd) are device pointers with the
// given element strides for the batch, sequence and head dims and a
// contiguous head dim. dtype: 0 = float32, 1 = bfloat16. hd must be a
// multiple of 8 up to 256, and Hq a multiple of Hkv.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, long long qsb, long long qss,
                           long long qsh, long long ksb, long long kss,
                           long long ksh, long long vsb, long long vss,
                           long long vsh, long long osb, long long oss,
                           long long osh, int B, int Sq, int Skv, int Hq,
                           int Hkv, int hd, int causal, int window,
                           int dtype, void* stream) {
  if (hd <= 0 || hd > 256 || hd % 8 || Hkv <= 0 || Hq % Hkv || B > 65535 ||
      Hq > 65535 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0 || Sq <= 0 || Hq <= 0) return 0;
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh},
      os{osb, oss, osh};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_dispatch<float>(q, k, v, o, qs, ks, vs, os, B, Sq, Skv,
                                  Hq, Hkv, hd, causal, window, st);
  return launch_dispatch<__nv_bfloat16>(q, k, v, o, qs, ks, vs, os, B, Sq,
                                        Skv, Hq, Hkv, hd, causal, window, st);
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
