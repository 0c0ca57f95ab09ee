// Backward of the causal GQA flash attention (flash_attention.cu), for
// Hopper (sm_90a), bfloat16 or float32.
//
// Replaces no TPU kernel: the reference has no backward kernel. Its
// training step differentiates the jnp naive_attention with XLA
// (use_pallas_kernels is False, src/repro/configs/base.py:86), and none
// of its Pallas kernels has a custom_vjp. The port runs its forward
// kernel on every CUDA tensor, so a training step on the card needs this
// backward. For q (B,Sq,Hq,hd), k, v (B,Skv,Hkv,hd), the output o and its
// cotangent do (B,Sq,Hq,hd), and the forward's row log-sum-exp L (base 2,
// float32 (B,Hq,Sq)), it computes what the gradient of the plain version
// computes:
//     P[i,j]  = exp2(q[i] . k[j] * log2(e) / sqrt(hd) - L[i])  (0 if masked)
//     D[i]    = do[i] . o[i]
//     dS[i,j] = P[i,j] (do[i] . v[j] - D[i])
//     dq[i]   = sum_j dS[i,j] k[j] / sqrt(hd)
//     dk[j]   = sum_(i, q heads of j's group) dS[i,j] q[i] / sqrt(hd)
//     dv[j]   = sum_(i, q heads of j's group) P[i,j] do[i]
// with the forward's masks (j <= i when causal, i - j < window when a
// window is set; keys past Skv do not exist). A masked score is -1e30 in
// the plain version, so its P is exactly 0 there too.
//
// Four kernels on one stream, in this order, with no atomics, so a call
// gives the same bits every time (a resumed training run equals an
// uninterrupted one):
//   1. D = rowsum(do * o) in float32, one warp a row;
//   2. dq: one block per (q tile, q head, batch row) walks the key tiles
//      the mask allows, staged through shared memory;
//   3. dk, dv per q head: one block per (key tile, q head, batch row)
//      walks the q tiles that attend to its keys and writes its head's
//      float32 partial into scratch (B,Skv,Hq,hd);
//   4. the partials of a kv head's group summed in the order g = 0..G-1
//      and cast to the output's dtype.
// Splitting the group's heads over blocks (3) and summing them in a fixed
// order (4) keeps Hq blocks in flight where a block per kv head would
// have only Hkv (2 at Qwen2-1.5B's 12/2 heads: 32 blocks on 132 SMs).
//
// The arithmetic runs on the float32 CUDA cores for both dtypes, as the
// forward's float32 kernel does: a row (or key) belongs to MAXD / 32
// neighbouring threads, each holding 32 of its head dims as 8 runs of 4
// (dims (c * TPR + sl) * 4 .. + 3), so that one 16-byte shared-memory
// read feeds four FMAs; the dot products reduce with xor shuffles, which
// give every thread of a row the same bits. bfloat16 inputs widen to
// float32 on load (P and dS are never rounded), and the outputs round to
// the input dtype once, at the end.
//
// What bounds it on an H100: at Qwen2-1.5B's training shape (B 2 x S
// 512, Hq 12, Hkv 2, hd 128, causal, bf16) the 3,151,872 allowed (q, k)
// pairs need 10 hd operations each, 4.03 GFLOP, 4.08 us at the
// tensor-core rate, and q, k, v, o and do read plus dq, dk and dv written
// move 14.7 MB, 4.39 us at 3.35 TB/s: the bytes bound it. This kernel is
// far from both: it runs 14 hd operations a pair (dq recomputes P and
// dP) on the CUDA cores, whose float32 rate is 67 TFLOP/s, and moves the
// float32 partials of 3 and 4 besides. A tensor-core redesign (mma.sync
// or wgmma tiles, P and dS in registers, the forward's layout) is later
// work; this one is the simple kernel that is right.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

struct Strides {  // in elements
  long long b, s, h;
};

constexpr int kThreads = 128;  // a block of kernels 2 and 3
constexpr int kSlice = 32;     // head dims a thread holds
constexpr int kTile = 32;      // rows of a shared-memory tile

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T narrow(float x);
template <>
__device__ __forceinline__ float narrow<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ bf16 narrow<bf16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's cast
}

// this thread's 32 of a row's MAXD dims, zero past hd
template <typename T, int TPR>
__device__ __forceinline__ void load_slice(float (&r)[kSlice], const T* row,
                                           bool live, int hd, int sl) {
#pragma unroll
  for (int c = 0; c < kSlice / 4; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = (c * TPR + sl) * 4 + e;
      r[4 * c + e] = (live && d < hd) ? widen(row[d]) : 0.0f;
    }
  }
}

// the thread's share of a . s_row, s_row a shared-memory row of MAXD
template <int TPR>
__device__ __forceinline__ float slice_dot(const float (&a)[kSlice],
                                           const float* s_row, int sl) {
  float acc = 0.0f;
#pragma unroll
  for (int c = 0; c < kSlice / 4; ++c) {
    const float4 x =
        *reinterpret_cast<const float4*>(s_row + (c * TPR + sl) * 4);
    acc = fmaf(a[4 * c], x.x, acc);
    acc = fmaf(a[4 * c + 1], x.y, acc);
    acc = fmaf(a[4 * c + 2], x.z, acc);
    acc = fmaf(a[4 * c + 3], x.w, acc);
  }
  return acc;
}

// acc += w * s_row over the thread's dims
template <int TPR>
__device__ __forceinline__ void slice_axpy(float (&acc)[kSlice], float w,
                                           const float* s_row, int sl) {
#pragma unroll
  for (int c = 0; c < kSlice / 4; ++c) {
    const float4 x =
        *reinterpret_cast<const float4*>(s_row + (c * TPR + sl) * 4);
    acc[4 * c] = fmaf(w, x.x, acc[4 * c]);
    acc[4 * c + 1] = fmaf(w, x.y, acc[4 * c + 1]);
    acc[4 * c + 2] = fmaf(w, x.z, acc[4 * c + 2]);
    acc[4 * c + 3] = fmaf(w, x.w, acc[4 * c + 3]);
  }
}

// the sum over the TPR threads of a row; every one of them gets the same
// bits (each xor step adds the same two values in either order)
template <int TPR>
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = TPR / 2; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// rows [0, n) x dims [0, hd) of a kTile-row tile into shared memory as
// float32, the rest zero
template <typename T, int MAXD>
__device__ __forceinline__ void stage_tile(float* s, const T* g,
                                           long long row_stride, int n,
                                           int hd, int tid) {
  for (int e = tid; e < kTile * MAXD; e += kThreads) {
    const int r = e / MAXD;
    const int d = e % MAXD;
    s[e] = (r < n && d < hd) ? widen(g[r * row_stride + d]) : 0.0f;
  }
}

__device__ __forceinline__ bool allowed(int i, int j, int causal,
                                        int window) {
  return (!causal || j <= i) && (!window || i - j < window);
}

// 1. D[b,h,i] = do[b,i,h] . o[b,i,h], one warp a row
template <typename T>
__global__ void __launch_bounds__(256)
flash_bwd_dot_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                     float* __restrict__ dsum, Strides os, Strides dos,
                     int B, int Sq, int Hq, int hd) {
  const long long row = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  if (row >= (long long)B * Hq * Sq) return;
  const int lane = threadIdx.x & 31;
  const int i = (int)(row % Sq);
  const int h = (int)((row / Sq) % Hq);
  const int b = (int)(row / ((long long)Sq * Hq));
  const T* op = o + b * os.b + (long long)i * os.s + h * os.h;
  const T* dp = dout + b * dos.b + (long long)i * dos.s + h * dos.h;
  float acc = 0.0f;
  for (int d = lane; d < hd; d += 32)
    acc = fmaf(widen(op[d]), widen(dp[d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) dsum[row] = acc;
}

// 2. dq: block (q tile, q head, batch row); key tiles through shared
// memory, K then V, kTile rows each
template <typename T, int MAXD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ dsum, T* __restrict__ dq,
                    Strides qs, Strides ks, Strides vs, Strides dos,
                    Strides dqs, int Sq, int Skv, int hd, int group,
                    int causal, int window, float scale_log2, float scale) {
  constexpr int TPR = MAXD / kSlice;   // threads a q row
  constexpr int RB = kThreads / TPR;   // q rows a block
  extern __shared__ __align__(16) float smem[];
  float* k_s = smem;                   // kTile x MAXD
  float* v_s = smem + kTile * MAXD;    // kTile x MAXD

  const int q0 = (gridDim.x - 1 - blockIdx.x) * RB;  // longest rows first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / group;
  const int tid = threadIdx.x;
  const int sl = tid % TPR;
  const int qi = q0 + tid / TPR;
  const bool live = qi < Sq;
  const int qrow = live ? qi : 0;

  float qr[kSlice], dor[kSlice], acc[kSlice];
  load_slice<T, TPR>(qr, q + b * qs.b + (long long)qrow * qs.s + h * qs.h,
                     live, hd, sl);
  load_slice<T, TPR>(dor,
                     dout + b * dos.b + (long long)qrow * dos.s + h * dos.h,
                     live, hd, sl);
#pragma unroll
  for (int i = 0; i < kSlice; ++i) acc[i] = 0.0f;
  const long long row = ((long long)b * gridDim.y + h) * Sq + qrow;
  const float L = live ? lse[row] : 0.0f;
  const float D = live ? dsum[row] : 0.0f;

  // the keys some row of this tile may attend to
  const int q_last = min(q0 + RB, Sq) - 1;
  const int kv_end = causal ? min(Skv, q_last + 1) : Skv;
  const int kv_begin = window ? max(0, q0 - window + 1) : 0;
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;
  for (int k0 = kv_begin / kTile * kTile; k0 < kv_end; k0 += kTile) {
    const int n = min(kTile, Skv - k0);
    __syncthreads();  // the previous tile is consumed
    stage_tile<T, MAXD>(k_s, kb + (long long)k0 * ks.s, ks.s, n, hd, tid);
    stage_tile<T, MAXD>(v_s, vb + (long long)k0 * vs.s, vs.s, n, hd, tid);
    __syncthreads();
    for (int jj = 0; jj < n; ++jj) {
      const float s = row_sum<TPR>(slice_dot<TPR>(qr, k_s + jj * MAXD, sl));
      const float dp = row_sum<TPR>(slice_dot<TPR>(dor, v_s + jj * MAXD, sl));
      const bool ok = live && allowed(qi, k0 + jj, causal, window);
      const float p = ok ? exp2f(s * scale_log2 - L) : 0.0f;
      slice_axpy<TPR>(acc, p * (dp - D), k_s + jj * MAXD, sl);
    }
  }

  if (live) {
    T* dqp = dq + b * dqs.b + (long long)qi * dqs.s + h * dqs.h;
#pragma unroll
    for (int c = 0; c < kSlice / 4; ++c) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = (c * TPR + sl) * 4 + e;
        if (d < hd) dqp[d] = narrow<T>(acc[4 * c + e] * scale);
      }
    }
  }
}

// 3. dk, dv of one q head: block (key tile, q head, batch row); q, do,
// L and D tiles through shared memory; float32 partials (B,Skv,Hq,hd)
template <typename T, int MAXD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ dsum, float* __restrict__ dkp,
                     float* __restrict__ dvp, Strides qs, Strides ks,
                     Strides vs, Strides dos, int Sq, int Skv, int hd,
                     int group, int causal, int window, float scale_log2,
                     float scale) {
  constexpr int TPR = MAXD / kSlice;   // threads a key
  constexpr int KB = kThreads / TPR;   // keys a block
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                   // kTile x MAXD
  float* do_s = smem + kTile * MAXD;   // kTile x MAXD
  float* l_s = do_s + kTile * MAXD;    // kTile
  float* d_s = l_s + kTile;            // kTile

  const int k0 = blockIdx.x * KB;      // the longest columns come first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int Hq = gridDim.y;
  const int hk = h / group;
  const int tid = threadIdx.x;
  const int sl = tid % TPR;
  const int kj = k0 + tid / TPR;
  const bool live = kj < Skv;
  const int krow = live ? kj : 0;

  float kr[kSlice], vr[kSlice], dk[kSlice], dv[kSlice];
  load_slice<T, TPR>(kr, k + b * ks.b + (long long)krow * ks.s + hk * ks.h,
                     live, hd, sl);
  load_slice<T, TPR>(vr, v + b * vs.b + (long long)krow * vs.s + hk * vs.h,
                     live, hd, sl);
#pragma unroll
  for (int i = 0; i < kSlice; ++i) dk[i] = dv[i] = 0.0f;

  // the q rows that attend to some key of this tile
  const int k_last = min(k0 + KB, Skv) - 1;
  const int q_begin = causal ? k0 : 0;
  const int q_end = window ? min(Sq, k_last + window) : Sq;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* db = dout + b * dos.b + h * dos.h;
  const long long row0 = ((long long)b * Hq + h) * Sq;
  for (int q0 = q_begin / kTile * kTile; q0 < q_end; q0 += kTile) {
    const int n = min(kTile, Sq - q0);
    __syncthreads();  // the previous tile is consumed
    stage_tile<T, MAXD>(q_s, qb + (long long)q0 * qs.s, qs.s, n, hd, tid);
    stage_tile<T, MAXD>(do_s, db + (long long)q0 * dos.s, dos.s, n, hd, tid);
    if (tid < kTile) {
      l_s[tid] = tid < n ? lse[row0 + q0 + tid] : 0.0f;
      d_s[tid] = tid < n ? dsum[row0 + q0 + tid] : 0.0f;
    }
    __syncthreads();
    for (int ii = 0; ii < n; ++ii) {
      const float s = row_sum<TPR>(slice_dot<TPR>(kr, q_s + ii * MAXD, sl));
      const float dp = row_sum<TPR>(slice_dot<TPR>(vr, do_s + ii * MAXD, sl));
      const bool ok = live && allowed(q0 + ii, kj, causal, window);
      const float p = ok ? exp2f(s * scale_log2 - l_s[ii]) : 0.0f;
      slice_axpy<TPR>(dv, p, do_s + ii * MAXD, sl);
      slice_axpy<TPR>(dk, p * (dp - d_s[ii]), q_s + ii * MAXD, sl);
    }
  }

  if (live) {
    const long long base = (((long long)b * Skv + kj) * Hq + h) * hd;
#pragma unroll
    for (int c = 0; c < kSlice / 4; ++c) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = (c * TPR + sl) * 4 + e;
        if (d < hd) {
          dkp[base + d] = dk[4 * c + e] * scale;
          dvp[base + d] = dv[4 * c + e];
        }
      }
    }
  }
}

// 4. dk, dv = the group's partials summed in the order g = 0..G-1
template <typename T>
__global__ void __launch_bounds__(256)
flash_bwd_reduce_kernel(const float* __restrict__ dkp,
                        const float* __restrict__ dvp, T* __restrict__ dk,
                        T* __restrict__ dv, Strides dks, Strides dvs, int B,
                        int Skv, int Hkv, int hd, int group) {
  const long long e = (long long)blockIdx.x * 256 + threadIdx.x;
  if (e >= (long long)B * Skv * Hkv * hd) return;
  const int d = (int)(e % hd);
  const int hk = (int)((e / hd) % Hkv);
  const long long bj = e / ((long long)hd * Hkv);  // b * Skv + j
  const int j = (int)(bj % Skv);
  const int b = (int)(bj / Skv);
  const long long base = (bj * Hkv * group + (long long)hk * group) * hd + d;
  float sk = 0.0f, sv = 0.0f;
  for (int g = 0; g < group; ++g) {
    sk += dkp[base + (long long)g * hd];
    sv += dvp[base + (long long)g * hd];
  }
  dk[b * dks.b + (long long)j * dks.s + hk * dks.h + d] = narrow<T>(sk);
  dv[b * dvs.b + (long long)j * dvs.s + hk * dvs.h + d] = narrow<T>(sv);
}

template <typename T, int MAXD>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* dsum, float* dkp,
           float* dvp, void* dq, void* dk, void* dv, const Strides* st,
           int B, int Sq, int Skv, int Hq, int Hkv, int hd, int causal,
           int window, cudaStream_t stream) {
  constexpr int TPR = MAXD / kSlice;
  const Strides &qs = st[0], &ks = st[1], &vs = st[2], &os = st[3],
                &dos = st[4], &dqs = st[5], &dks = st[6], &dvs = st[7];
  const int group = Hq / Hkv;
  const float scale = 1.0f / sqrtf((float)hd);
  const float scale_log2 = 1.4426950408889634f * scale;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dt = static_cast<const T*>(dout);

  const long long rows = (long long)B * Hq * Sq;
  flash_bwd_dot_kernel<T><<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(
      static_cast<const T*>(o), dt, dsum, os, dos, B, Sq, Hq, hd);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const size_t smem_dq = 2 * (size_t)kTile * MAXD * sizeof(float);
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, MAXD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_dq);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rb = kThreads / TPR;
  flash_bwd_dq_kernel<T, MAXD>
      <<<dim3((Sq + rb - 1) / rb, Hq, B), kThreads, smem_dq, stream>>>(
          qt, kt, vt, dt, lse, dsum, static_cast<T*>(dq), qs, ks, vs, dos,
          dqs, Sq, Skv, hd, group, causal, window, scale_log2, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const size_t smem_dkv = (2 * (size_t)kTile * MAXD + 2 * kTile) * sizeof(float);
  err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<T, MAXD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_dkv);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dkv_kernel<T, MAXD>
      <<<dim3((Skv + rb - 1) / rb, Hq, B), kThreads, smem_dkv, stream>>>(
          qt, kt, vt, dt, lse, dsum, dkp, dvp, qs, ks, vs, dos, Sq, Skv, hd,
          group, causal, window, scale_log2, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const long long n = (long long)B * Skv * Hkv * hd;
  flash_bwd_reduce_kernel<T><<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      dkp, dvp, static_cast<T*>(dk), static_cast<T*>(dv), dks, dvs, B, Skv,
      Hkv, hd, group);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* o,
             const void* dout, const float* lse, float* dsum, float* dkp,
             float* dvp, void* dq, void* dk, void* dv, const Strides* st,
             int B, int Sq, int Skv, int Hq, int Hkv, int hd, int causal,
             int window, cudaStream_t stream) {
  if (hd <= 64)
    return launch<T, 64>(q, k, v, o, dout, lse, dsum, dkp, dvp, dq, dk, dv,
                         st, B, Sq, Skv, Hq, Hkv, hd, causal, window, stream);
  if (hd <= 128)
    return launch<T, 128>(q, k, v, o, dout, lse, dsum, dkp, dvp, dq, dk, dv,
                          st, B, Sq, Skv, Hq, Hkv, hd, causal, window, stream);
  return launch<T, 256>(q, k, v, o, dout, lse, dsum, dkp, dvp, dq, dk, dv,
                        st, B, Sq, Skv, Hq, Hkv, hd, causal, window, stream);
}

}  // namespace

extern "C" {

// Launches the four kernels on `stream`; returns a cudaError_t (0 = ok).
// q, o, do, dq (B,Sq,Hq,hd) and k, v, dk, dv (B,Skv,Hkv,hd) are device
// pointers with a contiguous head dim; `strides` holds 24 element strides,
// batch, sequence and head for q, k, v, o, do, dq, dk, dv in that order.
// lse is the forward's (B,Hq,Sq) float32 output. The wrapper allocates the
// scratch: dsum float32 (B,Hq,Sq), dkp and dvp float32 (B,Skv,Hq,hd), all
// contiguous. dtype: 0 = float32, 1 = bfloat16. hd must be a multiple of
// 8 up to 256, and Hq a multiple of Hkv.
int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                               const void* o, const void* dout,
                               const void* lse, void* dsum, void* dkp,
                               void* dvp, void* dq, void* dk, void* dv,
                               const long long* strides, int B, int Sq,
                               int Skv, int Hq, int Hkv, int hd, int causal,
                               int window, int dtype, void* stream) {
  if (hd <= 0 || hd > 256 || hd % 8 || Hkv <= 0 || Hq % Hkv || B > 65535 ||
      Hq > 65535 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0 || Sq <= 0 || Skv <= 0 || Hq <= 0) return 0;
  Strides st[8];
  for (int t = 0; t < 8; ++t)
    st[t] = Strides{strides[3 * t], strides[3 * t + 1], strides[3 * t + 2]};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* ds = static_cast<float*>(dsum);
  float* kp = static_cast<float*>(dkp);
  float* vp = static_cast<float*>(dvp);
  if (dtype == 0)
    return dispatch<float>(q, k, v, o, dout, l, ds, kp, vp, dq, dk, dv, st,
                           B, Sq, Skv, Hq, Hkv, hd, causal, window, s);
  return dispatch<bf16>(q, k, v, o, dout, l, ds, kp, vp, dq, dk, dv, st, B,
                        Sq, Skv, Hq, Hkv, hd, causal, window, s);
}

const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
