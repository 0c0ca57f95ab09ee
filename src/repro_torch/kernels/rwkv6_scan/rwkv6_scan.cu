// RWKV6 wkv recurrence for Hopper (sm_90a), bfloat16 or float32 inputs.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/rwkv6_scan/kernel.py::rwkv6_scan_kernel.
// For r, k, v, logw (B,S,H,hd) of one dtype, u (H,hd) and a float32 state
// s0 (B,H,hd,hd) it runs, per (b, h), from S = s0:
//     o_t = r_t . S + (r_t . (u * k_t)) v_t,
//     S  <- diag(exp(logw_t)) S + k_t v_t^T,
// and writes every o_t (in the inputs' dtype) and the final S (float32).
//
// What bounds it on an H100: operations. Per token and head the update
// and the read-out take about 5 hd^2 float32 operations (a multiply and
// two fused multiply-adds per state element), which must run on the
// float32 CUDA cores: the exact recurrence is a chain of rank-1 updates,
// and the chunked matrix form that would reach the tensor cores
// overflows (the reference's kernel docstring). At B 2, S 512, H 16,
// hd 160 that is 2.1 GFLOP, 31 us at 67 TFLOP/s, against 59 MB of bytes
// (18 us at 3.35 TB/s). A decode step (S = 1) only reads and writes the
// state: 3.3 MB each way at B 2, about 2 us.
//
// Design. The TPU grid is (batch, head, chunk) with the whole (hd, hd)
// state in VMEM (100 KB at hd 160) across the sequential chunk axis.
// Each column j of the state evolves on its own (S[:,j] <- w * S[:,j] +
// k v_j; o_j = r . S[:,j] + (r . u k) v_j), so here a block owns one
// (b, h, tile of 32 columns) and keeps that tile in registers for the
// whole sequence: lane = column, and warp w of 8 holds KPT = ceil(hd/8)
// consecutive rows, so the state never leaves the SM between tokens and
// the grid has B H ceil(hd/32) blocks (160 at B 2, H 16, hd 160). Steps
// are staged through shared memory in chunks of 8: r, k and exp(logw)
// rows (read by every lane of a warp at one address, as float4
// broadcasts), the tile's v columns, and r . (u k) per step, one warp
// reduction each. Each warp walks the chunk without synchronising and
// leaves its partial r . S per (step, column) in shared memory; one pass
// then sums the 8 partials and writes o coalesced. The next chunk's
// inputs are loaded into registers while a chunk is walked. Rows past hd
// and steps past S are zero-padded in shared memory only, so any hd up
// to 256 and any S run without padding in device memory. A block reads
// its state tile before any write and writes only that tile at the end,
// so the final state may overwrite s0 (in place).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 32;    // state columns per block: one per lane
constexpr int kChunk = 8;    // steps staged in shared memory at a time

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

template <int KPT>
constexpr size_t smem_floats() {
  return 3 * (size_t)kChunk * kWarps * KPT     // r, k, exp(logw)
         + (size_t)kChunk * kCols              // v of the tile
         + (size_t)kChunk * kWarps * kCols     // partial r . S
         + kChunk                              // r . (u k)
         + kWarps * KPT;                       // u
}

template <typename T, int KPT>
__global__ void __launch_bounds__(kThreads)
rwkv6_scan_kernel(const T* __restrict__ r, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ lw,
                  const float* __restrict__ u, const float* s0,
                  T* __restrict__ o, float* s_out, Strides rs, Strides ks,
                  Strides vs, Strides ws, int S, int H, int hd) {
  static_assert(KPT % 4 == 0, "rows per warp are read as float4");
  constexpr int kRows = kWarps * KPT;                 // hd, padded
  constexpr int kLoadRows = (kChunk * kRows + kThreads - 1) / kThreads;
  constexpr int kLoadCols = (kChunk * kCols + kThreads - 1) / kThreads;
  extern __shared__ __align__(16) float smem[];
  float* r_s = smem;                          // kChunk x kRows
  float* k_s = r_s + kChunk * kRows;          // kChunk x kRows
  float* w_s = k_s + kChunk * kRows;          // kChunk x kRows
  float* v_s = w_s + kChunk * kRows;          // kChunk x kCols
  float* part = v_s + kChunk * kCols;         // kChunk x kWarps x kCols
  float* ruk = part + kChunk * kWarps * kCols;  // kChunk
  float* u_s = ruk + kChunk;                  // kRows

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int j0 = blockIdx.x * kCols, j = j0 + lane;
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const int row0 = warp * KPT;

  for (int i = threadIdx.x; i < kRows; i += kThreads)
    u_s[i] = i < hd ? u[(long long)h * hd + i] : 0.f;

  // this block's tile of the state, in registers for the whole sequence
  const long long sbase = (b * H + h) * (long long)hd * hd;
  float st[KPT];
#pragma unroll
  for (int i = 0; i < KPT; ++i) {
    const int row = row0 + i;
    st[i] = (j < hd && row < hd) ? s0[sbase + (long long)row * hd + j] : 0.f;
  }

  // a chunk's inputs, fetched into registers ahead of their use
  float pr[kLoadRows], pk[kLoadRows], pw[kLoadRows], pv[kLoadCols];
  auto fetch = [&](int t0) {
#pragma unroll
    for (int q = 0; q < kLoadRows; ++q) {
      const int idx = threadIdx.x + q * kThreads;
      const int tt = idx / kRows, row = idx % kRows;
      pr[q] = pk[q] = pw[q] = 0.f;
      if (tt < kChunk && t0 + tt < S && row < hd) {
        const long long t = t0 + tt;
        pr[q] = to_f32(r[b * rs.b + t * rs.s + h * rs.h + row]);
        pk[q] = to_f32(k[b * ks.b + t * ks.s + h * ks.h + row]);
        pw[q] = to_f32(lw[b * ws.b + t * ws.s + h * ws.h + row]);
      }
    }
#pragma unroll
    for (int q = 0; q < kLoadCols; ++q) {
      const int idx = threadIdx.x + q * kThreads;
      const int tt = idx / kCols, c = idx % kCols;
      pv[q] = 0.f;
      if (tt < kChunk && t0 + tt < S && j0 + c < hd)
        pv[q] = to_f32(v[b * vs.b + (long long)(t0 + tt) * vs.s + h * vs.h
                         + j0 + c]);
    }
  };
  auto stash = [&]() {
#pragma unroll
    for (int q = 0; q < kLoadRows; ++q) {
      const int idx = threadIdx.x + q * kThreads;
      if (idx < kChunk * kRows) {
        r_s[idx] = pr[q];
        k_s[idx] = pk[q];
        w_s[idx] = expf(pw[q]);
      }
    }
#pragma unroll
    for (int q = 0; q < kLoadCols; ++q) {
      const int idx = threadIdx.x + q * kThreads;
      if (idx < kChunk * kCols) v_s[idx] = pv[q];
    }
  };

  fetch(0);
  for (int t0 = 0; t0 < S; t0 += kChunk) {
    const int n = min(kChunk, S - t0);
    stash();
    __syncthreads();
    if (t0 + kChunk < S) fetch(t0 + kChunk);

    // r . (u k) per step: one warp per step
    for (int tt = warp; tt < n; tt += kWarps) {
      float acc = 0.f;
      for (int row = lane; row < kRows; row += 32)
        acc += r_s[tt * kRows + row] * u_s[row] * k_s[tt * kRows + row];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (lane == 0) ruk[tt] = acc;
    }

    // walk the chunk: this warp's rows of r . S, then the state update
    for (int tt = 0; tt < n; ++tt) {
      const float vj = v_s[tt * kCols + lane];
      const float4* r4 = reinterpret_cast<const float4*>(r_s + tt * kRows + row0);
      const float4* k4 = reinterpret_cast<const float4*>(k_s + tt * kRows + row0);
      const float4* w4 = reinterpret_cast<const float4*>(w_s + tt * kRows + row0);
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int q = 0; q < KPT / 4; ++q) {
        const float4 rr = r4[q], kk = k4[q], ww = w4[q];
        const float rq[4] = {rr.x, rr.y, rr.z, rr.w};
        const float kq[4] = {kk.x, kk.y, kk.z, kk.w};
        const float wq[4] = {ww.x, ww.y, ww.z, ww.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float& s = st[4 * q + e];
          acc[e] = fmaf(rq[e], s, acc[e]);
          s = fmaf(wq[e], s, kq[e] * vj);
        }
      }
      part[(tt * kWarps + warp) * kCols + lane] =
          (acc[0] + acc[1]) + (acc[2] + acc[3]);
    }
    __syncthreads();

    // o_t = sum of the warps' partials + (r . u k) v, written coalesced
    for (int idx = threadIdx.x; idx < n * kCols; idx += kThreads) {
      const int tt = idx / kCols, c = idx % kCols;
      if (j0 + c >= hd) continue;
      float acc = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w)
        acc += part[(tt * kWarps + w) * kCols + c];
      acc = fmaf(ruk[tt], v_s[tt * kCols + c], acc);
      o[((b * S + t0 + tt) * H + h) * (long long)hd + j0 + c] =
          from_f32<T>(acc);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < KPT; ++i) {
    const int row = row0 + i;
    if (j < hd && row < hd) s_out[sbase + (long long)row * hd + j] = st[i];
  }
}

template <typename T, int KPT>
int launch_kpt(const void* r, const void* k, const void* v, const void* lw,
               const float* u, const float* s0, void* o, float* s_out,
               const Strides* st, int B, int S, int H, int hd,
               cudaStream_t stream) {
  const size_t smem = smem_floats<KPT>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      rwkv6_scan_kernel<T, KPT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((hd + kCols - 1) / kCols, H, B);
  rwkv6_scan_kernel<T, KPT><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(lw), u, s0,
      static_cast<T*>(o), s_out, st[0], st[1], st[2], st[3], S, H, hd);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_typed(const void* r, const void* k, const void* v, const void* lw,
                 const float* u, const float* s0, void* o, float* s_out,
                 const Strides* st, int B, int S, int H, int hd,
                 cudaStream_t stream) {
  // the smallest instance whose 8 warps x KPT rows cover hd
  if (hd <= 8 * 4)
    return launch_kpt<T, 4>(r, k, v, lw, u, s0, o, s_out, st, B, S, H, hd,
                            stream);
  if (hd <= 8 * 8)
    return launch_kpt<T, 8>(r, k, v, lw, u, s0, o, s_out, st, B, S, H, hd,
                            stream);
  if (hd <= 8 * 20)
    return launch_kpt<T, 20>(r, k, v, lw, u, s0, o, s_out, st, B, S, H, hd,
                             stream);
  return launch_kpt<T, 32>(r, k, v, lw, u, s0, o, s_out, st, B, S, H, hd,
                           stream);
}

}  // namespace

extern "C" {

// Launches on `stream`; returns a cudaError_t (0 = ok). r, k, v, logw
// (B,S,H,hd) are device pointers with the given element strides (batch,
// step, head) and a contiguous head dim; u (H,hd), s0 and s_out
// (B,H,hd,hd) are contiguous float32, and s_out may be s0; o (B,S,H,hd)
// is contiguous. dtype: 0 = float32, 1 = bfloat16. 0 < hd <= 256.
int rwkv6_scan_launch(const void* r, const void* k, const void* v,
                      const void* lw, const float* u, const float* s0,
                      void* o, float* s_out, long long rsb, long long rss,
                      long long rsh, long long ksb, long long kss,
                      long long ksh, long long vsb, long long vss,
                      long long vsh, long long wsb, long long wss,
                      long long wsh, int B, int S, int H, int hd, int dtype,
                      void* stream) {
  if (hd <= 0 || hd > 256 || B > 65535 || H > 65535 || S < 0 ||
      (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0 || H <= 0) return 0;
  const Strides st[4] = {{rsb, rss, rsh}, {ksb, kss, ksh}, {vsb, vss, vsh},
                         {wsb, wss, wsh}};
  const cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_typed<float>(r, k, v, lw, u, s0, o, s_out, st, B, S, H, hd,
                               cs);
  return launch_typed<__nv_bfloat16>(r, k, v, lw, u, s0, o, s_out, st, B, S,
                                     H, hd, cs);
}

const char* rwkv6_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
