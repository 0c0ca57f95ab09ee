// Batched masked Matern-5/2 scoring and candidate-block posterior for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/matern_score/kernel.py::matern_score_kernel (:38) and,
// around it, the jnp posterior the reference computes for a candidate
// block, src/repro/core/gp.py::posterior_with_grad_batch. Per scenario s,
// candidate a and training point i (x_i, alpha_i, mask_i):
//     r_i = sqrt(max(|a - x_i|^2, 1e-16)) / ls,  e_i = exp(-sqrt5 r_i),
//     k_i = sv (1 + sqrt5 r_i + 5 r_i^2 / 3) e_i,  ks_i = mask_i k_i.
// Two entry points share the loop over points, so their means agree bit
// for bit:
//  - matern_score_launch: the TPU kernel's function, the standardized
//    mean sum_i alpha_i ks_i, at any n and d;
//  - matern_posterior_launch (d = 2, n <= 64, ls <= 5000): the whole
//    posterior on the raw scale, as posterior_with_grad_batch returns it:
//      mu    = y_sigma sum_i alpha_i ks_i + y_mu,
//      sigma = y_sigma sqrt(max(sv - |L^-1 ks|^2, 1e-12)),
//      dmu   = y_sigma sum_i alpha_i mask_i dk/dr (a - x_i) / (ls^2 r_i),
//    with L the lower Cholesky factor of the scenario's training kernel.
//    The (S, n, N) cross-kernel never reaches device memory.
//
// What bounds it on an H100: operations. At the batched engine's shape
// (S 16 scenarios, N 4,178 candidates, n 32 points) a call reads and
// writes 1.6 MB (0.5 us at 3.35 TB/s) but does about n^2 + 27 n f32
// operations per candidate (the pair loop ~26 n, the triangular solve
// n (n + 1) / 2 FMAs) and 2 n + 1 sqrt/exp: 1.9 us at the 67 TFLOP/s f32
// peak, 5.9 us at n 64 (chip_smoke.py::posterior_bound). That peak
// counts an FMA as two operations; only the solve is FMAs, and the pair
// loop issues about one instruction an operation, so in practice the
// kernel is bound by instruction issue. The mean alone is bound by its
// sqrt and exp on the special-function units (2.0 us at n 64,
// chip_smoke.py::matern_bound).
//
// Design. One thread per candidate; every quantity that does not depend
// on the candidate is taken once: 1/ls, sqrt5 sv and (5/3) sv a scenario,
// w_i = alpha_i mask_i (and w_i (-5/3) sv / ls^2 for the gradient) a
// point, staged in shared memory, so the loop over points holds no IEEE
// division; its sqrt and exp are the special-function units' sqrt.approx
// and ex2.approx, one instruction each and no branch (sqrtf's branch to a
// slow path kept the compiler from interleaving points). The posterior
// kernel is templated on NMAX in {16, 32, 48, 64} (the GP's dataset
// buckets; the caller picks the instance and the block size,
// ops.posterior_plan); it keeps ks[NMAX] in registers and solves L v = ks
// right-looking: for j = 0..n-1, v = ks_j / L_jj, s += v^2,
// ks_i -= L_ij v for i > j, independent FMAs. L is staged once a block,
// transposed: the kernel takes the factor in column-major order (as
// torch.linalg.cholesky_ex returns it), so column j is one row of shared
// memory, copied in with cp.async (16 bytes a copy, all in flight at
// once, no transposing pass) and read as float4 broadcasts (every thread
// reads the same address); the copies land while the loop over points
// runs, and 1/L_jj is taken once a block. A smaller n is padded in
// shared memory (L with identity rows, w and mask with 0), so padded rows
// give v = 0 exactly; on the main path n is a bucket and nothing is
// padded. Blocks of 128 threads (fewer when that leaves SMs idle: S = 1
// at N 4,178 takes 131 blocks of 32) keep the grid spread over the 132
// SMs. The gradient's factor r / max(r, 1e-12) is 1 for every pair as
// long as ls <= 5000 (r >= 1e-8 / ls > 1e-12), so the loop leaves it out;
// the GP's fit keeps ls within [0.02, 3].
//
// No tensor cores, on purpose: TF32 is not allowed on the GP path
// (jitter 1e-6), and an explicit L^-1 product would change the
// cancellation in sv - |v|^2, so the solve stays a substitution on the
// f32 cores. The variance is clamped as var < 1e-12 ? 1e-12 : var, not
// with fmaxf: a lane whose Cholesky failed has NaN in L, and its sigma
// must stay NaN (torch.clamp and jnp.maximum propagate it; the argmax
// takes NaN as the maximum), where fmaxf would return 1e-12. The same
// holds for the distance floor. The results stay within the tolerances
// chip_smoke.py holds them to against the plain PyTorch versions.
#include <cuda_runtime.h>

namespace {

constexpr float kSqrt5 = 2.23606797749979f;
constexpr float kFiveThirds = 5.0f / 3.0f;
constexpr float kNegSqrt5Log2e = -2.23606797749979f * 1.4426950408889634f;

// ---- the loop over points, shared by both entries -------------------------

// the special-function units' square root and power of two, one
// instruction each and no branch (sqrtf and expf take several, and
// sqrtf a branch to a slow path that keeps the compiler from
// interleaving the points)
__device__ __forceinline__ float sqrt_approx(float v) {
  float out;
  asm("sqrt.approx.ftz.f32 %0, %1;" : "=f"(out) : "f"(v));
  return out;
}

__device__ __forceinline__ float exp2_approx(float v) {
  float out;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(out) : "f"(v));
  return out;
}

struct Scenario {
  float inv_ls;                         // 1 / ls
  float exp_scale;                      // -sqrt5 log2(e) / ls
  float sv, c1, c2;                     // sv, sqrt5 sv, (5/3) sv
};

__device__ __forceinline__ Scenario scenario(float ls, float sv) {
  const float inv_ls = 1.0f / ls;
  return {inv_ls, __fmul_rn(kNegSqrt5Log2e, inv_ls), sv,
          __fmul_rn(kSqrt5, sv), __fmul_rn(kFiveThirds, sv)};
}

__device__ __forceinline__ float add_square(float acc, float t) {
  return __fmaf_rn(t, t, acc);
}

struct Pair {
  float r, e, k;
};

// r, exp(-sqrt5 r) and k for a squared distance d2; explicit roundings,
// so the compiler contracts nothing differently in the two entries. The
// floor is a select, not fmaxf, so that a NaN distance stays NaN.
__device__ __forceinline__ Pair matern_pair(float d2, const Scenario& p) {
  const float q = sqrt_approx(d2 < 1e-16f ? 1e-16f : d2);
  const float r = __fmul_rn(q, p.inv_ls);
  const float e = exp2_approx(__fmul_rn(q, p.exp_scale));
  return {r, e, __fmul_rn(__fmaf_rn(r, __fmaf_rn(r, p.c2, p.c1), p.sv), e)};
}

// ---- matern_score: the standardized mean ----------------------------------

constexpr int kScoreThreads = 128;
constexpr int kMaxRegDim = 8;          // candidate coords kept in registers
constexpr int kSmemFloats = 12288;     // 48 KB of dynamic shared memory

__global__ void __launch_bounds__(kScoreThreads)
matern_score_kernel(const float* __restrict__ cand,
                    const float* __restrict__ x,
                    const float* __restrict__ alpha,
                    const float* __restrict__ mask,
                    const float* __restrict__ ls,
                    const float* __restrict__ sv, float* __restrict__ out,
                    int N, int n, int d, int tile) {
  extern __shared__ float smem[];
  float* sx = smem;                    // tile * d
  float* sw = sx + (size_t)tile * d;   // tile: alpha * mask

  const int s = blockIdx.y;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = c < N;
  const Scenario p = scenario(ls[s], sv[s]);
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
    for (int j = threadIdx.x; j < cnt; j += blockDim.x)
      sw[j] = __fmul_rn(as[base + j], ms[base + j]);
    __syncthreads();
    if (!live) continue;
#pragma unroll 4
    for (int i = 0; i < cnt; ++i) {
      const float* xi = sx + (size_t)i * d;
      float d2 = 0.0f;
      if (in_reg) {
#pragma unroll
        for (int k = 0; k < kMaxRegDim; ++k)
          if (k < d) d2 = add_square(d2, __fsub_rn(creg[k], xi[k]));
      } else {
        for (int k = 0; k < d; ++k)
          d2 = add_square(d2, __fsub_rn(cp[k], xi[k]));
      }
      acc = __fmaf_rn(sw[i], matern_pair(d2, p).k, acc);
    }
  }
  if (live) out[(size_t)s * N + c] = acc;
}

// ---- matern_posterior: mean, sigma and mean gradient ----------------------

constexpr int kPostThreads = 128;      // a block at most

// global -> shared copies that the thread does not wait for
__device__ __forceinline__ unsigned smem_address(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void copy_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_address(dst)), "l"(src));
}

__device__ __forceinline__ void copy_async16(float4* dst, const float4* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_address(dst)), "l"(src));
}

template <int NMAX>
struct PosteriorSmem {
  float4 lt[NMAX * NMAX / 4];          // row j: column j of L, padded
  float4 pt[NMAX];                     // x_i, w_i = alpha_i mask_i and
                                       // w_i (-5/3) sv / ls^2
  float m[NMAX];                       // mask
  float inv_diag[NMAX];                // 1 / L_jj
};

// The loop over points for candidate a: the mean's and the gradient's
// sums, and ks_i = mask_i k_i. The reference's gradient factor
// r / max(r, 1e-12) is 1 here (ls <= 5000).
template <int NMAX>
__device__ __forceinline__ void posterior_pairs(
    const PosteriorSmem<NMAX>& sh, float2 a, const Scenario& p,
    float (&ks)[NMAX], float& mu, float& g0, float& g1) {
#pragma unroll
  for (int i = 0; i < NMAX; ++i) {
    const float4 pt = sh.pt[i];
    const float t0 = __fsub_rn(a.x, pt.x);
    const float t1 = __fsub_rn(a.y, pt.y);
    const Pair q = matern_pair(add_square(add_square(0.0f, t0), t1), p);
    mu = __fmaf_rn(pt.z, q.k, mu);
    ks[i] = __fmul_rn(sh.m[i], q.k);
    const float g =
        __fmul_rn(pt.w, __fmul_rn(__fmaf_rn(kSqrt5, q.r, 1.0f), q.e));
    g0 = __fmaf_rn(g, t0, g0);
    g1 = __fmaf_rn(g, t1, g1);
  }
}

// Lt is the factor in column-major order (Lt[s][j][i] = L[s][i][j]):
// column j of L is one contiguous row
template <int NMAX>
__global__ void __launch_bounds__(kPostThreads)
matern_posterior_kernel(const float* __restrict__ cand,
                        const float* __restrict__ x,
                        const float* __restrict__ alpha,
                        const float* __restrict__ mask,
                        const float* __restrict__ Lt,
                        const float* __restrict__ ls,
                        const float* __restrict__ sv,
                        const float* __restrict__ y_mu,
                        const float* __restrict__ y_sigma,
                        float* __restrict__ mu_out,
                        float* __restrict__ sigma_out,
                        float* __restrict__ dmu_out, int N, int n) {
  __shared__ PosteriorSmem<NMAX> sh;
  const int s = blockIdx.y;
  const Scenario p = scenario(ls[s], sv[s]);
  const float gc = __fmul_rn(__fmul_rn(-kFiveThirds, p.sv),
                             __fmul_rn(p.inv_ls, p.inv_ls));

  // the candidate's load flies while the block stages its scenario
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = c < N;
  const size_t o = (size_t)s * N + (live ? c : 0);
  const float2 a = reinterpret_cast<const float2*>(cand)[o];
  // the columns of L into shared memory, every copy in flight at once:
  // 16 bytes a copy when n is the instance's, else 4 bytes a copy and the
  // padding (identity rows past n) written beside them
  const float* Ls = Lt + (size_t)s * n * n;
  float* lt = reinterpret_cast<float*>(sh.lt);
  if (n == NMAX && (reinterpret_cast<size_t>(Ls) & 15) == 0) {
    for (int e = threadIdx.x; e < NMAX * NMAX / 4; e += blockDim.x)
      copy_async16(&sh.lt[e], reinterpret_cast<const float4*>(Ls) + e);
  } else {
    for (int e = threadIdx.x; e < NMAX * NMAX; e += blockDim.x) {
      const int j = e / NMAX, i = e % NMAX;
      if (i < n && j < n)
        copy_async4(lt + e, Ls + j * n + i);
      else
        lt[e] = i == j ? 1.0f : 0.0f;
    }
  }
  // meanwhile the points' terms and 1/L_jj
  for (int i = threadIdx.x; i < NMAX; i += blockDim.x) {
    const bool real = i < n;
    const size_t at = (size_t)s * n + i;
    const float mk = real ? mask[at] : 0.0f;
    const float w = real ? __fmul_rn(alpha[at], mk) : 0.0f;
    sh.pt[i] = real ? make_float4(x[2 * at], x[2 * at + 1], w,
                                  __fmul_rn(w, gc))
                    : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    sh.m[i] = mk;
    sh.inv_diag[i] = real ? 1.0f / Ls[i * n + i] : 1.0f;
  }
  __syncthreads();                     // the points' terms are in

  // the loop over points runs while L is still arriving
  float ks[NMAX];
  float mu = 0.0f, g0 = 0.0f, g1 = 0.0f;
  if (live) posterior_pairs<NMAX>(sh, a, p, ks, mu, g0, g1);
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();
  if (!live) return;                   // after the last barrier

  float ss = 0.0f;                     // |L^-1 ks|^2
#pragma unroll
  for (int j = 0; j < NMAX; ++j) {
    const float v = __fmul_rn(ks[j], sh.inv_diag[j]);
    ss = __fmaf_rn(v, v, ss);
#pragma unroll
    for (int q = (j + 1) / 4; q < NMAX / 4; ++q) {
      const float4 l = sh.lt[j * (NMAX / 4) + q];
      if (4 * q + 0 > j) ks[4 * q + 0] = __fmaf_rn(-l.x, v, ks[4 * q + 0]);
      if (4 * q + 1 > j) ks[4 * q + 1] = __fmaf_rn(-l.y, v, ks[4 * q + 1]);
      if (4 * q + 2 > j) ks[4 * q + 2] = __fmaf_rn(-l.z, v, ks[4 * q + 2]);
      if (4 * q + 3 > j) ks[4 * q + 3] = __fmaf_rn(-l.w, v, ks[4 * q + 3]);
    }
  }
  float var = __fsub_rn(p.sv, ss);
  var = var < 1e-12f ? 1e-12f : var;   // NaN stays NaN
  const float ys = y_sigma[s];
  mu_out[o] = __fadd_rn(__fmul_rn(mu, ys), y_mu[s]);
  sigma_out[o] = __fmul_rn(sqrtf(var), ys);
  reinterpret_cast<float2*>(dmu_out)[o] =
      make_float2(__fmul_rn(g0, ys), __fmul_rn(g1, ys));
}

struct PostCall {
  const float *cand, *x, *alpha, *mask, *Lt, *ls, *sv, *y_mu, *y_sigma;
  float *mu, *sigma, *dmu;
  int S, N, n, threads;
  cudaStream_t stream;
};

enum Op { kLaunch, kSmem, kRegisters, kBlocksPerSm };

// one instance: launch it, or report its shared memory, registers or
// occupancy; a negative cudaError_t on failure
template <int NMAX>
int post_act(Op op, const PostCall& c) {
  if (op == kSmem || op == kRegisters) {
    cudaFuncAttributes attr;
    const cudaError_t err =
        cudaFuncGetAttributes(&attr, matern_posterior_kernel<NMAX>);
    if (err != cudaSuccess) return -static_cast<int>(err);
    return op == kSmem ? static_cast<int>(attr.sharedSizeBytes)
                       : attr.numRegs;
  }
  if (op == kBlocksPerSm) {
    int blocks = 0;
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, matern_posterior_kernel<NMAX>, c.threads, 0);
    return err == cudaSuccess ? blocks : -static_cast<int>(err);
  }
  const dim3 grid((c.N + c.threads - 1) / c.threads, c.S);
  matern_posterior_kernel<NMAX><<<grid, c.threads, 0, c.stream>>>(
      c.cand, c.x, c.alpha, c.mask, c.Lt, c.ls, c.sv, c.y_mu, c.y_sigma,
      c.mu, c.sigma, c.dmu, c.N, c.n);
  return -static_cast<int>(cudaGetLastError());
}

int post_dispatch(Op op, int nmax, const PostCall& c) {
  switch (nmax) {
    case 16: return post_act<16>(op, c);
    case 32: return post_act<32>(op, c);
    case 48: return post_act<48>(op, c);
    case 64: return post_act<64>(op, c);
    default: return -static_cast<int>(cudaErrorInvalidValue);
  }
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
  int tile = kSmemFloats / (d + 1);
  if (tile > n) tile = n;
  if (tile < 1) tile = 1;
  const size_t smem = (size_t)tile * (d + 1) * sizeof(float);
  const dim3 grid((N + kScoreThreads - 1) / kScoreThreads, S);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  matern_score_kernel<<<grid, kScoreThreads, smem, st>>>(
      cand, x, alpha, mask, ls, sv, out, N, n, d, tile);
  return static_cast<int>(cudaGetLastError());
}

// Launches instance `nmax` (16, 32, 48 or 64; n <= nmax) in blocks of
// `threads` (32, 64 or 128) on `stream`; returns a cudaError_t (0 = ok).
// Contiguous float32 device arrays: cand (S,N,2) 8-byte aligned, x (S,n,2),
// alpha, mask (S,n), Lt (S,n,n) the lower factor in column-major order
// (Lt[s][j][i] = L[s][i][j]), ls, sv, y_mu, y_sigma (S,); writes mu, sigma
// (S,N) and dmu (S,N,2), 8-byte aligned.
int matern_posterior_launch(const float* cand, const float* x,
                            const float* alpha, const float* mask,
                            const float* Lt, const float* ls, const float* sv,
                            const float* y_mu, const float* y_sigma,
                            float* mu, float* sigma, float* dmu, int S,
                            int N, int n, int nmax, int threads,
                            void* stream) {
  if (S < 0 || S > 65535 || N < 0 || n < 0 || n > nmax ||
      (threads != 32 && threads != 64 && threads != kPostThreads))
    return static_cast<int>(cudaErrorInvalidValue);
  if (S == 0 || N == 0) return 0;
  const PostCall c{cand, x, alpha, mask, Lt, ls, sv, y_mu, y_sigma, mu,
                   sigma, dmu, S, N, n, threads,
                   static_cast<cudaStream_t>(stream)};
  return -post_dispatch(kLaunch, nmax, c);
}

// Instance `nmax`'s shared memory a block, registers a thread, and the
// blocks of `threads` threads one SM of the current device holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor); each a negative
// cudaError_t on failure.
int matern_posterior_smem_bytes(int nmax) {
  return post_dispatch(kSmem, nmax, PostCall{});
}
int matern_posterior_registers(int nmax) {
  return post_dispatch(kRegisters, nmax, PostCall{});
}
int matern_posterior_blocks_per_sm(int nmax, int threads) {
  PostCall c{};
  c.threads = threads;
  return post_dispatch(kBlocksPerSm, nmax, c);
}

const char* matern_score_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
