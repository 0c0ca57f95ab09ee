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
// What bounds it on an H100. The backward as a whole takes about 14
// float32 operations per state element and step: 88 us at (B 2, S 512,
// H 16, hd 160) at 67 TFLOP/s, against 104 MB of inputs and outputs (31
// us). This kernel's share is 7 float32 instructions an element and step
// (the state's recompute 2, G's update 2, dr, dk, dlogw 1 each), also
// about 88 us of the card's float32 issue at that shape. S_{t-1} cannot be had by
// running the update backwards (exp(logw) underflows to 0): the forward
// saves the state before every kCk-th step (rwkv6_scan.cu; kCk is
// ref.CKPT_STEPS, 8, which kernel.py passes to nvcc as RWKV6_CKPT_STEPS
// for both sources) and the others are recomputed from those. What binds
// first is issue and latency: the sums are chains of fused multiply-adds
// across a row's columns and lanes, the states and v, do, r, k, w come
// through shared memory (a warp's 128-bit shared access costs 4 cycles
// of the SM's shared-memory pipe whether or not its rows read one
// address), and registers (the states) and shared memory (the staging)
// leave room for few warps.
//
// Design.
//  - Rows and lanes. Every quantity here is a row's: row i of S and of G
//    evolves on its own (the decay scales rows), and dr, dk, dlogw sum
//    along a row. A block owns R rows of one (b, h); kLanes = 16 lanes
//    share a row (ref.LANES mirrors it), lane l holding columns
//    l C .. l C + C - 1 (C = W / kLanes for the instance's padded width
//    W = 32, 64, 160 or 256: 10 at hd 160) of kRt = 2 consecutive rows:
//    v and do are loaded once for both rows. (8 lanes of one row each
//    measured 449 us against 16 lanes' 438 at RWKV6-3B's training shape,
//    and their C = 20 instance spilled.) A row's sums
//    are each lane's chain over its columns in order, then the lanes'
//    xor butterfly, then the bonus. The six sums of a thread's two rows
//    go over the lanes by a reduce-scatter (row_sums) that takes each
//    sum's butterfly additions in its order: the same bits in 7 shuffles
//    instead of 24.
//  - One walk a span. Spans run from the last. A span's walk starts from
//    its saved state and takes its steps once with the forward's own
//    fmaf(w, s, k * v), so each state is the forward's bit for bit, and
//    keeps the state before each of its steps on chip: the first in the
//    saved state's slot, the last reg_states(C) (2 at hd 160) in
//    registers, those between in a stash in shared memory. The span's
//    steps then run from the last, each with its state from there: one
//    state update a step besides G's fmaf(w, G, r * do) (the dv kernel's
//    G bit for bit). Both loops are unrolled over the span, with no
//    branch in a whole span's steps, so one step's shuffles overlap the
//    next one's multiply-adds.
//  - Warp specialization. A block is R / kRt kLanes compute threads (160:
//    20 rows at hd 160) and one copy warp. While the compute warps run
//    span c, the copy warp fills the other half of a double-buffered
//    stage with span c - 1: v and do a row a step and the saved state's
//    rows in bulk by the copy engine (cp.async.bulk, counted on an
//    mbarrier; one copy for the block's rows of the state), r, k and
//    logw of the block's rows by cp.async, 16 bytes a lane; then it takes
//    exp(logw) in place and v . do per step (a lane sums columns wl,
//    wl + 32, ..., then a warp butterfly). One __syncthreads a span hands
//    the buffers over, and one before the first span orders every
//    thread's zero fill of the padding before the copy warp's reads. Where hd % 4 != 0 or a pointer is not 16-byte
//    aligned, every copy is cp.async of 4 bytes. Rows and columns past hd
//    are zeros in shared memory, never copied.
//  - Occupancy. R is the most rows, in whole warps and up to 160 compute
//    threads (RWKV6_BWD_MAX_THREADS, 160), that leave room for two
//    blocks an SM (RWKV6_SMEM_LIMIT, 113 KB each: 111 KB at hd 160), with
//    as many states in registers as RWKV6_BWD_REG_FLOATS (40) floats a
//    thread hold: RWKV6-3B's training microbatch (5,120 rows) is 256
//    blocks, one wave of two blocks on 128 SMs, 12 warps an SM. The three
//    constants come from kernel.py (nvcc -D), which ops.py reads too.
//  - Outputs. The lane that holds a row's dr, dk or dlogw of a step
//    stores it to device memory itself.
//  - No atomics: du is each row's chain over t, last step first, into a
//    per (b, h) partial; a second kernel adds the batch rows in order. A
//    call repeats bit for bit.
// ops.bwd_plan mirrors the instance, rows, threads, grid and shared
// memory below from shapes alone; the CPU tests check it.
#include <cuda_runtime.h>
#include <math.h>

#ifndef RWKV6_CKPT_STEPS
#error "RWKV6_CKPT_STEPS (ref.CKPT_STEPS) must be defined"
#endif
#if !defined(RWKV6_SMEM_LIMIT) || !defined(RWKV6_BWD_MAX_THREADS) || \
    !defined(RWKV6_BWD_REG_FLOATS)
#error "RWKV6_SMEM_LIMIT, RWKV6_BWD_MAX_THREADS and RWKV6_BWD_REG_FLOATS (kernel.py) must be defined"
#endif

namespace {

constexpr int kLanes = 16;                     // lanes that share a row
constexpr int kRt = 2;                         // rows a thread
constexpr int kCk = RWKV6_CKPT_STEPS;          // steps between checkpoints
constexpr int kMaxThreads = RWKV6_BWD_MAX_THREADS;  // compute threads a block
constexpr int kSmemLimit = RWKV6_SMEM_LIMIT;   // bytes: two blocks an SM
constexpr int kRegFloats = RWKV6_BWD_REG_FLOATS;    // for a span's states
static_assert(kCk >= 2, "a span holds at least two steps");

// states of a span a thread keeps in registers (the last ones; those
// between the first and these go to the shared stash): as many as 40
// registers hold, at C kRt floats a state
__host__ __device__ constexpr int reg_states(int C) {
  return kRegFloats / (C * kRt) < kCk - 1 ? kRegFloats / (C * kRt)
                                          : kCk - 1;
}

// floats of shared memory of a block of R rows whose lanes hold C columns:
// v and do (two buffers), the saved state (two buffers), the stash, r, k
// and exp(logw) (two buffers), v . do (two buffers), the bulk copies'
// mbarrier
__host__ __device__ constexpr int smem_floats(int C, int R) {
  return 4 * kCk * kLanes * C + (2 + kCk - 1 - reg_states(C)) * R * kLanes * C
         + 6 * kCk * R + 2 * kCk + 4;
}

// rows a block: the most, in whole warps and up to kMaxThreads compute
// threads, that leave room for two blocks an SM
__host__ __device__ constexpr int rows_per_block(int C) {
  constexpr int kStep = 32 * kRt / kLanes;     // rows of a warp
  int R = kMaxThreads / kLanes * kRt;
  while (R > kStep && 4 * smem_floats(C, R) > kSmemLimit) R -= kStep;
  return R;
}

// a lane's C contiguous columns, as float4 or float2
template <int C>
__device__ __forceinline__ void load_cols(float (&x)[C], const float* p) {
  static_assert(C % 2 == 0, "a lane holds an even number of columns");
  if constexpr (C % 4 == 0) {
#pragma unroll
    for (int m = 0; m < C; m += 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + m);
      x[m] = t.x, x[m + 1] = t.y, x[m + 2] = t.z, x[m + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int m = 0; m < C; m += 2) {
      const float2 t = *reinterpret_cast<const float2*>(p + m);
      x[m] = t.x, x[m + 1] = t.y;
    }
  }
}

template <int C>
__device__ __forceinline__ void store_cols(float* p, const float (&x)[C]) {
  if constexpr (C % 4 == 0) {
#pragma unroll
    for (int m = 0; m < C; m += 4)
      *reinterpret_cast<float4*>(p + m) =
          make_float4(x[m], x[m + 1], x[m + 2], x[m + 3]);
  } else {
#pragma unroll
    for (int m = 0; m < C; m += 2)
      *reinterpret_cast<float2*>(p + m) = make_float2(x[m], x[m + 1]);
  }
}

// a thread's two consecutive rows' values of one step
__device__ __forceinline__ void load_rows(float (&x)[kRt], const float* p) {
  const float2 t = *reinterpret_cast<const float2*>(p);
  x[0] = t.x, x[1] = t.y;
}

// cp.async copies; the "memory" clobber keeps earlier shared reads of
// the destination before them
__device__ __forceinline__ unsigned shared_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   shared_addr(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   shared_addr(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Bulk copies: the copy engine moves whole rows, and counts the bytes
// that have come in on an mbarrier
__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   shared_addr(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect(unsigned long long* bar,
                                            unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(shared_addr(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(shared_addr(bar)), "r"(parity) : "memory");
}
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(shared_addr(dst)), "l"(src),
      "r"(bytes), "r"(shared_addr(bar)) : "memory");
}
// the generic proxy's shared accesses before the async proxy's after
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A lane's share of a span's items (step, packet), packet < P, in the
// order step * P + packet: items t, t + T, t + 2T, ... for lane t of T.
// The division happens once, where the walker is made; a walk over the
// items (steps below n) only adds.
struct Items {
  int t0, p0, dt, dp, P;
  __device__ Items(int t, int T, int P_) : P(P_) {
    t0 = t / P, p0 = t % P, dt = T / P, dp = T % P;
  }
  template <typename F>
  __device__ __forceinline__ void each(int n, F&& f) const {
    for (int tt = t0, p = p0; tt < n;) {
      f(tt, p);
      tt += dt, p += dp;
      if (p >= P) p -= P, ++tt;
    }
  }
};

// A step's three lane partials of each of the thread's rows (dr, dk,
// dlogw) summed over the row's lanes by a reduce-scatter: every sum takes
// the additions of an xor butterfly over the row's kLanes lanes in its
// order, so the same bits, in 7 shuffles for the two rows where six
// butterflies take 24. The first exchange parts the rows (row 1's sums to
// the lanes kLanes / 2 up); then over a row's 2 kH lanes the ones below
// kH keep dr and dk, those from kH on dlogw; then lanes below kH / 2
// keep dr, the next kH / 2 dk. Returns this lane's sum: which (0 dr, 1
// dk, 2 dlogw) and of which row is `sum_of`'s.
constexpr int kH = kLanes / 4;

__device__ __forceinline__ float row_sums(const float (&a)[kRt][3],
                                          int lane) {
  float x3[3];
  const bool up = lane & (kLanes / 2);
#pragma unroll
  for (int j = 0; j < 3; ++j)
    x3[j] = (up ? a[1][j] : a[0][j]) +
            __shfl_xor_sync(0xffffffffu, up ? a[0][j] : a[1][j], kLanes / 2);
  const bool hi = lane & kH, mid = lane & (kH / 2);
  const float x = __shfl_xor_sync(0xffffffffu, hi ? x3[0] : x3[2], kH);
  const float y = __shfl_xor_sync(0xffffffffu, x3[1], kH);
  const float s_dr = x3[0] + x, s_dk = x3[1] + y, s_dw = x3[2] + x;
  float part = hi ? s_dw : mid ? s_dk : s_dr;
  part += __shfl_xor_sync(0xffffffffu, hi ? s_dw : mid ? s_dr : s_dk,
                          kH / 2);
#pragma unroll
  for (int off = kH / 4; off > 0; off >>= 1)
    part += __shfl_xor_sync(0xffffffffu, part, off);
  return part;
}

// which of a thread's rows and which sum `row_sums` leaves in a lane, or
// -1 where the lane is not the one that writes it
__device__ __forceinline__ int sum_of(int lane, int& row) {
  row = lane & (kLanes / 2) ? 1 : 0;
  const int g = lane & (2 * kH - 1);
  return g == 0 ? 0 : g == kH / 2 ? 1 : g == kH ? 2 : -1;
}

template <bool B> struct Flag { static constexpr bool value = B; };

// vec: every row comes in by bulk copies or 16 bytes a copy (hd % 4 ==
// 0, every input 16-byte aligned; the block's rows are then a multiple
// of 4), else 4 bytes a copy
template <int C>
__global__ void __launch_bounds__(kLanes * rows_per_block(C) / kRt + 32, 2)
rwkv6_bwd_rows_kernel(const float* __restrict__ r, const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ lw,
                      const float* __restrict__ u,
                      const float* __restrict__ ckpt,
                      const float* __restrict__ dout,
                      const float* __restrict__ ds_last,
                      float* __restrict__ dr, float* __restrict__ dk,
                      float* __restrict__ dlw, float* __restrict__ du_part,
                      int S, int H, int hd, int vec) {
  constexpr int R = rows_per_block(C);
  constexpr int W = kLanes * C;                // columns, padded
  constexpr int kCompute = R / kRt * kLanes;   // compute threads
  constexpr int kThreads = kCompute + 32;      // and the copy warp
  constexpr int kReg = reg_states(C);          // states in registers
  constexpr int kFirstReg = kCk - kReg;        // the first of them
  extern __shared__ __align__(16) float smem[];
  float* vd = smem;                            // [2][v, do][kCk][W]
  float* ck_s = vd + 4 * kCk * W;              // [2][R][W] saved states
  float* stash = ck_s + 2 * R * W;             // [kFirstReg - 1][R][W]
  float* rkw = stash + (kFirstReg - 1) * R * W;  // [2][r, k, w][kCk][R]
  float* vdo_s = rkw + 6 * kCk * R;            // [2][kCk]
  auto* bar = reinterpret_cast<unsigned long long*>(vdo_s + 2 * kCk);

  const int lane = threadIdx.x % kLanes;
  const int row_l = threadIdx.x / kLanes * kRt;  // its first row
  const bool copier = threadIdx.x >= kCompute;  // the last warp
  const int wl = threadIdx.x % 32;
  const int row_base = blockIdx.x * R;
  const int rows = min(R, hd - row_base);      // rows of the block in hd
  const int i0 = row_base + row_l;             // this thread's first row
  bool live[kRt];
#pragma unroll
  for (int q = 0; q < kRt; ++q) live[q] = !copier && i0 + q < hd;
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const int j0 = lane * C;                     // its first column
  const long long hd2 = (long long)hd * hd;
  const long long step = (long long)H * hd;    // elements a step
  const int n_ck = (S + kCk - 1) / kCk;
  int my_row;
  const int my_sum = sum_of(lane, my_row);     // the sum this lane writes
  const bool writer = !copier && my_sum >= 0 && i0 + my_row < hd;
  const float ui = writer ? u[(long long)h * hd + i0 + my_row] : 0.f;

  // zeros where no copy writes: v and do past hd, r and k past the
  // block's rows, the saved states' columns past hd or rows past hd
  if (W > hd)
    for (int idx = threadIdx.x; idx < 4 * kCk * (W - hd); idx += kThreads)
      vd[(idx / (W - hd)) * W + hd + idx % (W - hd)] = 0.f;
  for (int idx = threadIdx.x; idx < 6 * kCk * R; idx += kThreads)
    if (idx % R >= rows) rkw[idx] = 0.f;
  for (int idx = threadIdx.x; idx < 2 * R * W; idx += kThreads)
    if ((idx / W) % R >= rows || idx % W >= hd) ck_s[idx] = 0.f;
  __syncthreads();         // the copy warp's first v . do reads the zeros

  // The copy warp's copies. With vec, the copy engine brings a step's v
  // and do rows and the saved state's rows (one copy where the block's
  // rows are contiguous in shared memory: W = hd) in bulk, and the lanes
  // copy r, k and logw of the block's rows a step, 16 bytes a packet;
  // else the lanes copy all of it 4 bytes a packet. Neighbouring lanes
  // copy neighbouring packets.
  const int e = vec ? 4 : 1;
  const int pv = hd / e, pr = rows / e;
  const Items vd_items(wl, 32, 2 * pv);
  const Items row_items(wl, 32, 3 * pr);    // r, k, logw rows a step
  const Items ck_items(wl, 32, pv);
  unsigned phase = 0;                          // of the bulk copies' mbarrier
  if (copier && vec && wl == 0) mbar_init(bar);

  // The copy warp's work for span c, into buffer `buf`: issue() starts
  // the copies of its v, do, r, k and logw rows and of the state saved
  // before it; prepare() waits for them, takes exp(logw) in place and
  // v . do per step (a lane sums columns wl, wl + 32, ..., then the
  // butterfly; the steps side by side).
  auto issue = [&](int c, int buf) {
    const int t0 = c * kCk, n = min(kCk, S - t0);
    const long long at0 = ((b * S + t0) * H + h) * hd;
    float* V = vd + 2 * buf * kCk * W;
    float* DO = V + kCk * W;
    const float* ck_at = ckpt + ((b * n_ck + c) * H + h) * hd2 +
                         (long long)row_base * hd;
    if (vec) {
      const int ck_ops = W == hd ? 1 : rows;
      if (wl == 0) mbar_expect(bar, 4u * (2 * n + rows) * hd);
      __syncwarp();
      fence_async_shared();
      for (int op = wl; op < 2 * n + ck_ops; op += 32) {
        if (op < 2 * n) {
          const bool is_do = op >= n;
          const int tt = op - (is_do ? n : 0);
          bulk_load((is_do ? DO : V) + tt * W,
                    (is_do ? dout : v) + at0 + tt * step, 4u * hd, bar);
        } else {
          const int q = op - 2 * n;
          bulk_load(ck_s + (buf * R + q) * W, ck_at + (long long)q * hd,
                    4u * hd * (W == hd ? rows : 1), bar);
        }
      }
    } else {
      vd_items.each(n, [&](int tt, int p) {
        const bool is_do = p >= pv;
        const int col = is_do ? p - pv : p;
        cp_async4((is_do ? DO : V) + tt * W + col,
                  (is_do ? dout : v) + at0 + tt * step + col);
      });
      ck_items.each(rows, [&](int q, int p) {
        cp_async4(ck_s + (buf * R + q) * W + p, ck_at + (long long)q * hd + p);
      });
    }
    row_items.each(n, [&](int tt, int p) {
      const int which = p < pr ? 0 : p < 2 * pr ? 1 : 2;
      const int rr = e * (p - which * pr);
      float* dst = rkw + ((3 * buf + which) * kCk + tt) * R + rr;
      const float* src = (which == 0 ? r : which == 1 ? k : lw) + at0 +
                         tt * step + row_base + rr;
      if (vec) cp_async16(dst, src);
      else cp_async4(dst, src);
    });
    cp_async_commit();
  };
  auto prepare = [&](int c, int buf) {
    const int n = min(kCk, S - c * kCk);
    float* V = vd + 2 * buf * kCk * W;
    float* DO = V + kCk * W;
    cp_async_wait_all();
    if (vec) {
      mbar_wait(bar, phase);
      phase ^= 1;
    }
    __syncwarp();                              // every lane's copies
    // exp(logw) in place, four at a time (rows past the block's are 0)
    float4* Ws = reinterpret_cast<float4*>(rkw + (3 * buf + 2) * kCk * R);
    for (int idx = wl; idx < n * R / 4; idx += 32) {
      const float4 x = Ws[idx];
      const int row = 4 * idx % R;
      Ws[idx] = make_float4(row < rows ? expf(x.x) : 0.f,
                            row + 1 < rows ? expf(x.y) : 0.f,
                            row + 2 < rows ? expf(x.z) : 0.f,
                            row + 3 < rows ? expf(x.w) : 0.f);
    }
    // every step's sum, also past n (never stored): no guard in the chain
    float acc[kCk];
#pragma unroll
    for (int tt = 0; tt < kCk; ++tt) acc[tt] = 0.f;
#pragma unroll
    for (int jj = wl; jj < W; jj += 32)
#pragma unroll
      for (int tt = 0; tt < kCk; ++tt)
        acc[tt] = fmaf(V[tt * W + jj], DO[tt * W + jj], acc[tt]);
#pragma unroll
    for (int tt = 0; tt < kCk; ++tt) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc[tt] += __shfl_xor_sync(0xffffffffu, acc[tt], off);
      if (wl == 0 && tt < n) vdo_s[buf * kCk + tt] = acc[tt];
    }
  };

  float G[kRt][C];                             // this thread's G
#pragma unroll
  for (int q = 0; q < kRt; ++q)
#pragma unroll
    for (int m = 0; m < C; ++m) G[q][m] = 0.f;
  if (ds_last != nullptr && !copier) {
#pragma unroll
    for (int q = 0; q < kRt; ++q) {
      if (!live[q]) continue;
      const float* g_in = ds_last + (b * H + h) * hd2 + (long long)(i0 + q) * hd;
#pragma unroll
      for (int m = 0; m < C; ++m)
        if (j0 + m < hd) G[q][m] = g_in[j0 + m];
    }
  }
  float du_acc = 0.f;

  // One span: the walk keeps the state before each of its steps (the
  // first in the saved state's slot, the last kReg in registers, those
  // between in the stash), then its steps run from the last. kFull: a
  // whole span of kCk steps, every guard known.
  auto span = [&](auto full, int c, int n, int buf) {
    // where this lane's sum of step 0 goes (dr, dk or dlogw of its row)
    float* const out = (my_sum == 0 ? dr : my_sum == 1 ? dk : dlw) +
                       ((b * S + c * kCk) * H + h) * hd + i0 + my_row;
    constexpr bool kFull = decltype(full)::value;
    const float* V = vd + buf * 2 * kCk * W;
    const float* DO = V + kCk * W;
    const float* Rs = rkw + buf * 3 * kCk * R;
    const float* Ks = Rs + kCk * R;
    const float* Ws = Ks + kCk * R;
    const float* first = ck_s + (buf * R + row_l) * W + j0;
    float keep[kReg][kRt][C];
    float s[kRt][C];
#pragma unroll
    for (int q = 0; q < kRt; ++q) load_cols<C>(s[q], first + q * W);
#pragma unroll
    for (int t = 1; t < kCk; ++t) {            // the state before step t
      if (kFull || t < n) {
        float ww[kRt], kk[kRt], vv[C];
        load_rows(ww, Ws + (t - 1) * R + row_l);
        load_rows(kk, Ks + (t - 1) * R + row_l);
        load_cols<C>(vv, V + (t - 1) * W + j0);
#pragma unroll
        for (int q = 0; q < kRt; ++q)
#pragma unroll
          for (int m = 0; m < C; ++m)
            s[q][m] = fmaf(ww[q], s[q][m], kk[q] * vv[m]);
        if (t >= kFirstReg) {
#pragma unroll
          for (int q = 0; q < kRt; ++q)
#pragma unroll
            for (int m = 0; m < C; ++m) keep[t - kFirstReg][q][m] = s[q][m];
        } else {
#pragma unroll
          for (int q = 0; q < kRt; ++q)
            store_cols<C>(stash + ((t - 1) * R + row_l + q) * W + j0, s[q]);
        }
      }
    }
#pragma unroll
    for (int t = kCk - 1; t >= 0; --t) {
      if (kFull || t < n) {
        float p[kRt][C];                       // the state before step t
#pragma unroll
        for (int q = 0; q < kRt; ++q) {
          if (t >= kFirstReg) {
#pragma unroll
            for (int m = 0; m < C; ++m) p[q][m] = keep[t - kFirstReg][q][m];
          } else if (t > 0) {
            load_cols<C>(p[q], stash + ((t - 1) * R + row_l + q) * W + j0);
          } else {
            load_cols<C>(p[q], first + q * W);
          }
        }
        float ww[kRt], kk[kRt], rr[kRt], dd[C], vv[C];
        load_rows(ww, Ws + t * R + row_l);
        load_rows(kk, Ks + t * R + row_l);
        load_rows(rr, Rs + t * R + row_l);
        load_cols<C>(dd, DO + t * W + j0);
        load_cols<C>(vv, V + t * W + j0);
        // the rows' six chains side by side, a column at a time
        float a[kRt][3];
#pragma unroll
        for (int q = 0; q < kRt; ++q) a[q][0] = a[q][1] = a[q][2] = 0.f;
#pragma unroll
        for (int m = 0; m < C; ++m) {
#pragma unroll
          for (int q = 0; q < kRt; ++q) {
            a[q][0] = fmaf(p[q][m], dd[m], a[q][0]);
            a[q][1] = fmaf(G[q][m], vv[m], a[q][1]);
            a[q][2] = fmaf(G[q][m], p[q][m], a[q][2]);
            G[q][m] = fmaf(ww[q], G[q][m], rr[q] * dd[m]);
          }
        }
        const float part = row_sums(a, lane);
        // branch-free, so that the next step's work may fill this one's
        // shuffle latency: selects, a predicated store
        const float vdo = vdo_s[buf * kCk + t];
        const float w_ = my_row ? ww[kRt - 1] : ww[0],
                    k_ = my_row ? kk[kRt - 1] : kk[0],
                    r_ = my_row ? rr[kRt - 1] : rr[0];
        const float o_dr = fmaf(ui * k_, vdo, part),
                    o_dk = fmaf(ui * r_, vdo, part), o_dw = w_ * part;
        const float val = my_sum == 0 ? o_dr : my_sum == 1 ? o_dk : o_dw;
        if (writer) out[t * step] = val;
        if (writer && my_sum == 0) du_acc = fmaf(r_ * k_, vdo, du_acc);
      }
    }
  };

  // Warp-specialized: while the compute warps run span c, the copy warp
  // copies span c - 1 into the other buffers and prepares it.
  if (copier && n_ck > 0) {
    issue(n_ck - 1, 0);
    prepare(n_ck - 1, 0);
  }
  for (int it = 0; it < n_ck; ++it) {
    const int c = n_ck - 1 - it, buf = it & 1;
    const int n = min(kCk, S - c * kCk);
    __syncthreads();       // span c is prepared; the other buffers are read
    if (copier) {
      if (c > 0) {
        issue(c - 1, buf ^ 1);
        prepare(c - 1, buf ^ 1);
      }
    } else if (n == kCk) {
      span(Flag<true>{}, c, n, buf);
    } else {
      span(Flag<false>{}, c, n, buf);
    }
  }
  if (writer && my_sum == 0) du_part[(b * H + h) * hd + i0 + my_row] = du_acc;
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

enum Op { kLaunch, kSmem, kThreadCount, kBlocksPerSm };

bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15) == 0;
}

// one instance: launch it, or report its shared memory, threads or
// occupancy
template <int C>
int act(Op op, const Call& x) {
  constexpr int R = rows_per_block(C);
  constexpr int smem = 4 * smem_floats(C, R);
  constexpr int threads = R / kRt * kLanes + 32;
  if (op == kSmem) return smem;
  if (op == kThreadCount) return threads;
  const auto kern = rwkv6_bwd_rows_kernel<C>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return -static_cast<int>(err);
  if (op == kBlocksPerSm) {
    int n = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kern, threads,
                                                        smem);
    return err == cudaSuccess ? n : -static_cast<int>(err);
  }
  const int vec = x.hd % 4 == 0 && aligned16(x.r) && aligned16(x.k) &&
                  aligned16(x.v) && aligned16(x.lw) && aligned16(x.ckpt) &&
                  aligned16(x.dout);
  const dim3 grid((x.hd + R - 1) / R, x.H, x.B);
  kern<<<grid, threads, smem, x.stream>>>(
      x.r, x.k, x.v, x.lw, x.u, x.ckpt, x.dout, x.ds_last, x.dr, x.dk,
      x.dlw, x.du_part, x.S, x.H, x.hd, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return -static_cast<int>(err);
  const int n = x.H * x.hd;
  rwkv6_bwd_du_kernel<<<(n + 255) / 256, 256, 0, x.stream>>>(x.du_part, x.du,
                                                             x.B, n);
  return -static_cast<int>(cudaGetLastError());
}

// the instance whose padded width W = kLanes C (32, 64, 160 or 256) is the
// smallest that covers hd
int dispatch(Op op, const Call& x) {
  if (x.hd <= 0 || x.hd > 256) return -static_cast<int>(cudaErrorInvalidValue);
  if (x.hd <= 32) return act<32 / kLanes>(op, x);
  if (x.hd <= 64) return act<64 / kLanes>(op, x);
  if (x.hd <= 160) return act<160 / kLanes>(op, x);
  return act<256 / kLanes>(op, x);
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
  return -dispatch(kLaunch, x);
}

// Shared memory bytes and threads of a block of the instance that takes
// hd (-1 outside 0 < hd <= 256).
int rwkv6_scan_bwd_smem_bytes(int hd) {
  Call x{};
  x.hd = hd;
  const int n = dispatch(kSmem, x);
  return n < 0 ? -1 : n;
}

int rwkv6_scan_bwd_threads(int hd) {
  Call x{};
  x.hd = hd;
  const int n = dispatch(kThreadCount, x);
  return n < 0 ? -1 : n;
}

// Blocks of the row kernel's instance that takes hd that one SM of the
// current device holds at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor);
// a negative cudaError_t on failure.
int rwkv6_scan_bwd_blocks_per_sm(int hd) {
  Call x{};
  x.hd = hd;
  return dispatch(kBlocksPerSm, x);
}

// Lanes that share a row, as built (ref.LANES mirrors it).
int rwkv6_scan_bwd_lanes() { return kLanes; }

const char* rwkv6_scan_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
