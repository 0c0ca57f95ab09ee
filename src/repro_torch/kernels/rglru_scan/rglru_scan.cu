// RG-LRU diagonal affine scan for Hopper (sm_90a), bfloat16 or float32.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/rglru_scan/kernel.py::rglru_scan_kernel.
// For a, b (B,S,R) of one dtype and h0 (B,R) in float32 it computes, per
// batch row and channel,
//     h_t = a_t * h_{t-1} + b_t,   h_{-1} = h0,
// and writes every h_t (in a's dtype) and the last one (float32).
//
// What bounds it on an H100: bytes. Each (b, t, r) element is read twice
// (a and b) and written once, with one fused multiply-add between: at the
// prefill shape (B 2, S 512, R 2560, float32) that is 31.5 MB, or 9.4 us
// at 3.35 TB/s, against 2.6 M multiply-adds. A decode step (S = 1) reads
// and writes 2 B R values and h: a few tens of KB.
//
// Design. The TPU grid is (batch, channel blocks, chunks) with the state
// carried in VMEM across the sequential chunk axis. Here the loop over t
// lives inside the thread: one thread per (b, r) channel keeps h in a
// register, and neighbouring threads hold neighbouring channels, so each
// step's loads and stores coalesce. To keep loads in flight, a thread
// first loads kUnroll steps of a and b into registers, then runs the
// kUnroll dependent multiply-adds and stores their results. Blocks are
// small (64 threads), so the B R threads spread over as many SMs as they
// can fill (80 blocks at the prefill shape): only B R threads exist, so
// the scan is bound by memory latency, not by the card's bandwidth;
// splitting S across blocks with a carry pass is later work. Ragged R is
// masked in the kernel and S needs no padding. Each thread reads its h0
// before it writes h_last, so h_last may be the h0 buffer (in place).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;
constexpr int kUnroll = 8;

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
rglru_scan_kernel(const T* __restrict__ a, const T* __restrict__ b,
                  const float* h0, T* __restrict__ hs, float* h_last,
                  long long asb, long long ass, long long bsb, long long bss,
                  int S, int R) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= R) return;
  const long long bi = blockIdx.y;
  const T* ap = a + bi * asb + r;
  const T* bp = b + bi * bsb + r;
  T* hp = hs + bi * (long long)S * R + r;
  float h = h0[bi * R + r];
  int t = 0;
  for (; t + kUnroll <= S; t += kUnroll) {
    float av[kUnroll], bv[kUnroll];
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      av[i] = to_f32(ap[(long long)(t + i) * ass]);
      bv[i] = to_f32(bp[(long long)(t + i) * bss]);
    }
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      h = av[i] * h + bv[i];
      hp[(long long)(t + i) * R] = from_f32<T>(h);
    }
  }
  for (; t < S; ++t) {
    h = to_f32(ap[(long long)t * ass]) * h + to_f32(bp[(long long)t * bss]);
    hp[(long long)t * R] = from_f32<T>(h);
  }
  h_last[bi * R + r] = h;
}

template <typename T>
int launch_typed(const void* a, const void* b, const float* h0, void* hs,
                 float* h_last, long long asb, long long ass, long long bsb,
                 long long bss, int B, int S, int R, cudaStream_t stream) {
  const dim3 grid((R + kThreads - 1) / kThreads, B);
  rglru_scan_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), h0,
      static_cast<T*>(hs), h_last, asb, ass, bsb, bss, S, R);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches on `stream`; returns a cudaError_t (0 = ok). a and b (B,S,R)
// are device pointers with the given element strides (batch, step) and a
// contiguous channel dim; h0 and h_last (B,R) float32 and hs (B,S,R) are
// contiguous, and h_last may be h0. dtype: 0 = float32, 1 = bfloat16.
int rglru_scan_launch(const void* a, const void* b, const float* h0,
                      void* hs, float* h_last, long long asb, long long ass,
                      long long bsb, long long bss, int B, int S, int R,
                      int dtype, void* stream) {
  if (B > 65535 || S < 0 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0 || R <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_typed<float>(a, b, h0, hs, h_last, asb, ass, bsb, bss, B,
                               S, R, st);
  return launch_typed<__nv_bfloat16>(a, b, h0, hs, h_last, asb, ass, bsb,
                                     bss, B, S, R, st);
}

const char* rglru_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
