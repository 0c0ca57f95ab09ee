// Backward of the RWKV6 wkv recurrence for Hopper (sm_90a), float32: the
// per-row gradients dr, dk, dlogw and du.
//
// Replaces no TPU kernel: the reference differentiates its jnp scan
// (src/repro/models/rwkv6.py::_wkv_scan) with XLA. It is the backward of
// rwkv6_scan.cu's forward, whose library also runs the backward's dv and
// ds0 (rwkv6_bwd_dv_kernel: the forward's body in reverse time). Per
// (b, h), with S_{t-1} the state before step t and G the cotangent of the
// state after it (ds_last after the last step), from the last step to the
// first:
//     dr_t    = S_{t-1} do_t + u k_t (v_t . do_t)
//     dk_t    = G v_t + u r_t (v_t . do_t)
//     dlogw_t = w_t * rowsum(G * S_{t-1})
//     G      <- diag(w_t) G + r_t do_t^T
// and du = sum over b and t of r_t k_t (v_t . do_t).
//
// What bounds it on an H100: operations. Per state element and step the
// backward as a whole takes about 14 float32 operations (the state's
// recompute 3, G's update 3, and 2 each for dr, dk, dv and dlogw), 88 us
// at (B 2, S 512, H 16, hd 160) at 67 TFLOP/s, against 60 MB of inputs
// and outputs.
//
// Design. Every quantity here is a row's: row i of S and of G evolves on
// its own (the decay scales rows), and dr, dk, dlogw sum along a row. So a
// block owns 16 rows of one (b, h), and 8 lanes share a row, lane l
// holding columns l C .. l C + C - 1 (C = 4, 8, 20 or 32 by hd): C values
// of G and of S in registers, no sum across blocks. A row's sums are each
// lane's chain over its columns in order, then an xor butterfly over the
// 8 lanes (every lane ends with the same bits). S_{t-1} cannot be had by
// running the update backwards (exp(logw) underflows to 0), so the
// forward saves the state before every kCk-th step (rwkv6_scan.cu; kCk is
// ref.CKPT_STEPS, 8, which kernel.py passes to nvcc as RWKV6_CKPT_STEPS
// for both sources) and the backward walks the spans from the last: it stages a span's v and do
// rows and its r, k, exp(logw) in shared memory, takes v . do per step
// (a warp a step), and for each step of the span, last first, re-walks
// S from the span's saved state with the forward's own fmaf (so S_{t-1}
// is the forward's bit for bit), then takes the step's sums and G's
// update. The re-walk costs 3.5 updates a step on average: a simple
// kernel, to be redesigned. Outputs of a span go through shared memory
// and out coalesced. du: each row's chain over t, last step first, per
// (b, h) into a partial; a second kernel adds the batch rows in order.
// No atomics: a call repeats bit for bit.
#include <cuda_runtime.h>
#include <math.h>

#ifndef RWKV6_CKPT_STEPS
#error "RWKV6_CKPT_STEPS (ref.CKPT_STEPS) must be defined"
#endif

namespace {

constexpr int kLanes = 8;                      // lanes that share a row
constexpr int kTileRows = 16;                  // rows a block
constexpr int kRowThreads = kLanes * kTileRows;  // 128
constexpr int kCk = RWKV6_CKPT_STEPS;          // steps between checkpoints
constexpr int kWarps = kRowThreads / 32;
// blocks an SM: at most 168 registers a thread, which every instance
// holds without spilling (C = 32 takes the most)
constexpr int kMinBlocks = 3;

template <int C>
__global__ void __launch_bounds__(kRowThreads, kMinBlocks)
rwkv6_bwd_rows_kernel(const float* __restrict__ r, const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ lw,
                      const float* __restrict__ u,
                      const float* __restrict__ ckpt,
                      const float* __restrict__ dout,
                      const float* __restrict__ ds_last,
                      float* __restrict__ dr, float* __restrict__ dk,
                      float* __restrict__ dlw, float* __restrict__ du_part,
                      int S, int H, int hd) {
  constexpr int kW = kLanes * C;               // columns, padded
  __shared__ __align__(16) float v_s[kCk][kW];
  __shared__ __align__(16) float do_s[kCk][kW];
  __shared__ float r_s[kCk][kTileRows], k_s[kCk][kTileRows],
      w_s[kCk][kTileRows];
  __shared__ float vdo_s[kCk];
  __shared__ float out_s[3][kCk][kTileRows];
  const int lane = threadIdx.x % kLanes, row_l = threadIdx.x / kLanes;
  const int warp = threadIdx.x / 32, wl = threadIdx.x % 32;
  const int row_base = blockIdx.x * kTileRows;
  const int i = row_base + row_l;              // this thread's row
  const bool live = i < hd;
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const int j0 = lane * C;                     // its first column
  const long long hd2 = (long long)hd * hd;
  const int n_ck = (S + kCk - 1) / kCk;
  const float ui = live ? u[(long long)h * hd + i] : 0.f;

  float G[C];                                  // this thread's G
#pragma unroll
  for (int m = 0; m < C; ++m) G[m] = 0.f;
  if (ds_last != nullptr && live) {
    const float* g_in = ds_last + (b * H + h) * hd2 + (long long)i * hd;
#pragma unroll
    for (int m = 0; m < C; ++m)
      if (j0 + m < hd) G[m] = g_in[j0 + m];
  }
  float du_acc = 0.f;

  for (int c = n_ck - 1; c >= 0; --c) {
    const int t0 = c * kCk, n = min(kCk, S - t0);
    __syncthreads();                           // the span after is read
    for (int idx = threadIdx.x; idx < n * kW; idx += kRowThreads) {
      const int tt = idx / kW, jj = idx % kW;
      const long long at = ((b * S + t0 + tt) * H + h) * hd + jj;
      v_s[tt][jj] = jj < hd ? v[at] : 0.f;
      do_s[tt][jj] = jj < hd ? dout[at] : 0.f;
    }
    for (int idx = threadIdx.x; idx < n * kTileRows; idx += kRowThreads) {
      const int tt = idx / kTileRows, rr = idx % kTileRows;
      const int row = row_base + rr;
      const long long at = ((b * S + t0 + tt) * H + h) * hd + row;
      const bool in = row < hd;
      r_s[tt][rr] = in ? r[at] : 0.f;
      k_s[tt][rr] = in ? k[at] : 0.f;
      w_s[tt][rr] = in ? expf(lw[at]) : 0.f;
    }
    __syncthreads();
    // v . do per step: a warp a step, lane sums columns wl, wl + 32, ...,
    // then the butterfly
    for (int tt = warp; tt < n; tt += kWarps) {
      float acc = 0.f;
#pragma unroll
      for (int jj = wl; jj < kW; jj += 32)
        acc = fmaf(v_s[tt][jj], do_s[tt][jj], acc);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (wl == 0) vdo_s[tt] = acc;
    }
    // the state before step t0, as the forward saved it
    float s_ck[C];
    {
      const float* s_in = ckpt + ((b * n_ck + c) * H + h) * hd2 +
                          (long long)i * hd;
#pragma unroll
      for (int m = 0; m < C; ++m)
        s_ck[m] = live && j0 + m < hd ? s_in[j0 + m] : 0.f;
    }
    __syncthreads();
#pragma unroll 1
    for (int tt = n - 1; tt >= 0; --tt) {
      float s[C];                              // S before step t0 + tt
#pragma unroll
      for (int m = 0; m < C; ++m) s[m] = s_ck[m];
#pragma unroll 1
      for (int q = 0; q < tt; ++q) {
        const float ww = w_s[q][row_l], kk = k_s[q][row_l];
#pragma unroll
        for (int m = 0; m < C; ++m)
          s[m] = fmaf(ww, s[m], kk * v_s[q][j0 + m]);
      }
      const float ww = w_s[tt][row_l], kk = k_s[tt][row_l],
                  rr = r_s[tt][row_l];
      float a_dr = 0.f, a_dk = 0.f, a_dw = 0.f;
#pragma unroll
      for (int m = 0; m < C; ++m) {
        const float dm = do_s[tt][j0 + m], vm = v_s[tt][j0 + m];
        a_dr = fmaf(s[m], dm, a_dr);
        a_dk = fmaf(G[m], vm, a_dk);
        a_dw = fmaf(G[m], s[m], a_dw);
        G[m] = fmaf(ww, G[m], rr * dm);
      }
#pragma unroll
      for (int off = kLanes / 2; off > 0; off >>= 1) {
        a_dr += __shfl_xor_sync(0xffffffffu, a_dr, off);
        a_dk += __shfl_xor_sync(0xffffffffu, a_dk, off);
        a_dw += __shfl_xor_sync(0xffffffffu, a_dw, off);
      }
      if (lane == 0) {
        const float vdo = vdo_s[tt];
        out_s[0][tt][row_l] = fmaf(ui * kk, vdo, a_dr);
        out_s[1][tt][row_l] = fmaf(ui * rr, vdo, a_dk);
        out_s[2][tt][row_l] = ww * a_dw;
        du_acc = fmaf(rr * kk, vdo, du_acc);
      }
    }
    __syncthreads();
    // the span's rows of dr, dk and dlogw, coalesced
    for (int idx = threadIdx.x; idx < 3 * n * kTileRows;
         idx += kRowThreads) {
      const int which = idx / (n * kTileRows), rem = idx % (n * kTileRows);
      const int tt = rem / kTileRows, rr = rem % kTileRows;
      const int row = row_base + rr;
      if (row >= hd) continue;
      float* dst = which == 0 ? dr : which == 1 ? dk : dlw;
      dst[((b * S + t0 + tt) * H + h) * hd + row] = out_s[which][tt][rr];
    }
  }
  if (live && lane == 0) du_part[(b * H + h) * hd + i] = du_acc;
}

// du = the batch rows' partials added in order, one thread an element
__global__ void rwkv6_bwd_du_kernel(const float* __restrict__ du_part,
                                    float* __restrict__ du, int B, int n) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  float acc = 0.f;
  for (int b = 0; b < B; ++b) acc += du_part[(long long)b * n + idx];
  du[idx] = acc;
}

struct Call {
  const float *r, *k, *v, *lw, *u, *ckpt, *dout, *ds_last;
  float *dr, *dk, *dlw, *du_part, *du;
  int B, S, H, hd;
  cudaStream_t stream;
};

template <int C>
int launch(const Call& x) {
  const dim3 grid((x.hd + kTileRows - 1) / kTileRows, x.H, x.B);
  rwkv6_bwd_rows_kernel<C><<<grid, kRowThreads, 0, x.stream>>>(
      x.r, x.k, x.v, x.lw, x.u, x.ckpt, x.dout, x.ds_last, x.dr, x.dk,
      x.dlw, x.du_part, x.S, x.H, x.hd);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n = x.H * x.hd;
  rwkv6_bwd_du_kernel<<<(n + 255) / 256, 256, 0, x.stream>>>(x.du_part, x.du,
                                                             x.B, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The backward's per-row gradients on `stream`; returns a cudaError_t
// (0 = ok). r, k, v, logw, dout, dr, dk, dlogw (B,S,H,hd), u and du
// (H,hd), ds_last (B,H,hd,hd; null: zero), du_part (B,H,hd) and ckpt
// (B, ceil(S / kCk), H, hd, hd: the forward's states before every
// kCk-th step) are contiguous float32. 0 < hd <= 256.
int rwkv6_scan_bwd_rows_launch(const float* r, const float* k,
                               const float* v, const float* lw,
                               const float* u, const float* ckpt,
                               const float* dout, const float* ds_last,
                               float* dr, float* dk, float* dlw,
                               float* du_part, float* du, int B, int S, int H,
                               int hd, void* stream) {
  if (hd <= 0 || hd > 256 || B > 65535 || H > 65535 || S < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0 || H <= 0) return 0;
  const Call x{r, k, v, lw, u, ckpt, dout, ds_last, dr, dk, dlw, du_part,
               du, B, S, H, hd, static_cast<cudaStream_t>(stream)};
  if (hd <= kLanes * 4) return launch<4>(x);
  if (hd <= kLanes * 8) return launch<8>(x);
  if (hd <= kLanes * 20) return launch<20>(x);
  return launch<32>(x);
}

const char* rwkv6_scan_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
