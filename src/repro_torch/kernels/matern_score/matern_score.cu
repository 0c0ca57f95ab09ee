// Batched masked Matern-5/2 scoring for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/matern_score/kernel.py::matern_score_kernel.
// For scenario s and candidate c it computes the standardized GP
// posterior mean
//     out[s, c] = sum_i mask[s,i] * alpha[s,i] * k(cand[s,c], x[s,i])
//     k = sv * (1 + sqrt5 r + 5 r^2 / 3) * exp(-sqrt5 r),
//     r = sqrt(max(|c - x_i|^2, 1e-16)) / ls.
//
// What bounds it on an H100: at the main path's shapes (S = 16 scenarios,
// N = 4,178 candidates, n <= 64 training points, d = 2) the work is about
// 4.3 M (candidate, point) pairs, each of 3d + 10 f32 operations plus one
// sqrt and one exp, against ~0.8 MB of traffic. The sqrt and exp run on
// the special-function units at 1/16 of the 67 TFLOP/s f32 rate: about
// 2.0 us, against 1.0 us of f32 arithmetic and 0.25 us of bytes at
// 3.35 TB/s (chip_smoke.py::matern_bound). So operations bound it, and at
// that size launch latency dominates either. d = 2 leaves nothing for
// tensor cores.
//
// Design: one thread per candidate, a grid of (ceil(N / 256), S) blocks.
// Each block stages its scenario's training set (x, alpha, mask) in
// shared memory, in tiles when n is large, and every thread sums its
// candidate's score over the points in f32, so the (N, n) cross-kernel
// never reaches device memory; the only traffic is the candidates in and
// the scores out. The ragged N edge is masked in the kernel (no padding),
// n and d are runtime values. expf/sqrtf without fast math keep the
// result within 1e-5 of the plain PyTorch version.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRegDim = 8;          // candidate coords kept in registers
constexpr int kSmemFloats = 12288;     // 48 KB of dynamic shared memory
constexpr float kSqrt5 = 2.23606797749979f;

__global__ void matern_score_kernel(const float* __restrict__ cand,
                                    const float* __restrict__ x,
                                    const float* __restrict__ alpha,
                                    const float* __restrict__ mask,
                                    const float* __restrict__ ls,
                                    const float* __restrict__ sv,
                                    float* __restrict__ out,
                                    int N, int n, int d, int tile) {
  extern __shared__ float smem[];
  float* sx = smem;                    // tile * d
  float* sa = sx + (size_t)tile * d;   // tile
  float* sm = sa + tile;               // tile

  const int s = blockIdx.y;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = c < N;
  const float l = ls[s];
  const float v = sv[s];
  const float* xs = x + (size_t)s * n * d;
  const float* as = alpha + (size_t)s * n;
  const float* ms = mask + (size_t)s * n;
  const float* cp = cand + ((size_t)s * N + (live ? c : 0)) * d;

  const bool in_reg = d <= kMaxRegDim;
  float creg[kMaxRegDim];
#pragma unroll
  for (int k = 0; k < kMaxRegDim; ++k)
    creg[k] = (live && in_reg && k < d) ? cp[k] : 0.0f;

  float acc = 0.0f;
  for (int base = 0; base < n; base += tile) {
    const int cnt = min(tile, n - base);
    __syncthreads();                   // the previous tile is consumed
    for (int j = threadIdx.x; j < cnt * d; j += blockDim.x)
      sx[j] = xs[(size_t)base * d + j];
    for (int j = threadIdx.x; j < cnt; j += blockDim.x) {
      sa[j] = as[base + j];
      sm[j] = ms[base + j];
    }
    __syncthreads();
    if (!live) continue;
    for (int i = 0; i < cnt; ++i) {
      const float* xi = sx + (size_t)i * d;
      float d2 = 0.0f;
      if (in_reg) {
#pragma unroll
        for (int k = 0; k < kMaxRegDim; ++k) {
          if (k < d) {
            const float t = creg[k] - xi[k];
            d2 += t * t;
          }
        }
      } else {
        for (int k = 0; k < d; ++k) {
          const float t = cp[k] - xi[k];
          d2 += t * t;
        }
      }
      const float r = sqrtf(fmaxf(d2, 1e-16f)) / l;
      const float kv = v * (1.0f + kSqrt5 * r + 5.0f * r * r / 3.0f)
                       * expf(-kSqrt5 * r);
      acc += (kv * sm[i]) * sa[i];
    }
  }
  if (live) out[(size_t)s * N + c] = acc;
}

}  // namespace

extern "C" {

// Launches on `stream`; returns the cudaError_t of the launch (0 = ok).
// All pointers are device pointers to contiguous float32 arrays:
// cand (S,N,d), x (S,n,d), alpha (S,n), mask (S,n), ls (S,), sv (S,),
// out (S,N).
int matern_score_launch(const float* cand, const float* x,
                        const float* alpha, const float* mask,
                        const float* ls, const float* sv, float* out,
                        int S, int N, int n, int d, void* stream) {
  if (S <= 0 || N <= 0) return 0;
  int tile = kSmemFloats / (d + 2);
  if (tile > n) tile = n;
  if (tile < 1) tile = 1;
  const size_t smem = (size_t)tile * (d + 2) * sizeof(float);
  const dim3 grid((N + kThreads - 1) / kThreads, S);
  matern_score_kernel<<<grid, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      cand, x, alpha, mask, ls, sv, out, N, n, d, tile);
  return static_cast<int>(cudaGetLastError());
}

const char* matern_score_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
