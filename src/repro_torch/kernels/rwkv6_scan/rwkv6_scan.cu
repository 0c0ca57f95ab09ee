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
// What bounds it on an H100. The bound the port reports is operations:
// per token and head the update and the read-out take about 5 hd^2
// float32 operations (a multiply and two fused multiply-adds per state
// element), which must run on the float32 CUDA cores: the exact
// recurrence is a chain of rank-1 updates, the chunked matrix form that
// would reach the tensor cores overflows (the reference's kernel
// docstring), and TF32 would not hold float32's tolerance. At B 2, S 512,
// H 16, hd 160 that is 2.1 GFLOP, 31 us at 67 TFLOP/s, against 59 MB of
// bytes (18 us at 3.35 TB/s). A decode step (S = 1) only reads and writes
// the state: 3.3 MB each way at B 2, about 2 us. Two things bind before
// that peak. Shared memory delivers 128 bytes a clock to an SM whether or
// not the lanes of a warp read one address, so a thread that holds one
// column of its rows (the first port of this kernel) gets one element's
// update for every 12 bytes of r, k and exp(logw) it loads, and is bound
// by those loads. And a thread's three instructions an element issue at
// about half the SM's peak: the multiply feeding each update and the
// three-operand multiply-adds leave the SM short of issue, so the work
// must be spread evenly over the SMs and their schedulers.
//
// Design. The TPU grid is (batch, head, chunk) with the whole (hd, hd)
// state in VMEM (100 KB at hd 160) across the sequential chunk axis.
// Each column j of the state evolves on its own (S[:,j] <- w * S[:,j] +
// k v_j; o_j = r . S[:,j] + (r . u k) v_j), so a block owns one (b, h,
// tile of 20 columns) and keeps that tile in registers for the whole
// sequence.
//  - Rows, threads and the order of the sums. The rows form 8 groups of
//    G = 4 L rows (G 4, 8, 20, 32 for hd up to 32, 64, 160, 256); row
//    4q + e of a group feeds chain e (e = 0..3) of it. Thread (chain,
//    quad) holds one chain's L rows (5 at hd 160) for 4 columns of the
//    tile: 4 L state values in registers, and a step loads 3 L row values
//    and 4 of v for 4 L elements, over 3 times fewer bytes an element
//    than one column a thread. Each chain is summed in q order; each group's
//    chains are added (c0 + c1) + (c2 + c3), the groups in order, then
//    (r . u k) v: the order of the first port of this kernel (8 warps of
//    4 chains of a column each), so the results are the same bit for
//    bit. No float32 order gives the exact sum of 160 products; this one
//    agrees with the plain version's cuBLAS read-out within float32's
//    tolerance at the shapes the port is checked at, which other orders
//    tried did not.
//  - Occupancy and waves. A block is 160 threads (32 chains x 5 quads of
//    columns). At hd 160 the grid is 8 x H x B blocks, 256 at B 2, H 16;
//    a block takes about 105 KB of shared memory and about 100 registers
//    a thread, so two fit an SM: one wave, 40 columns on each of 124 SMs
//    and 20 on the other 8, where 32-column tiles (160 blocks) put 64 on
//    28 SMs and 32 on the rest.
//  - Staging. Steps come in chunks (16, or 8 where 16 would not fit two
//    blocks an SM: hd > 160), copied with cp.async into a double-buffered
//    ring in shared memory: the r, k and logw rows of the head (16-byte
//    packets) and the tile's 20 v columns (4-byte packets). A thread
//    copies the same packet at every step, so its addresses advance by a
//    stride. Chunk c + 1 is in flight while chunk c is walked. After the
//    wait, all threads take exp(logw) of the chunk in place (float32) or
//    widen r, k and exp(logw) into a float32 work area (bfloat16; v is
//    read from the ring). A row that is not 16-byte aligned, and the
//    ragged edge of hd, are loaded by plain loads instead; rows past hd
//    are zeros in shared memory and steps past S are never read, so
//    nothing is padded in device memory. The state moves as float4 where
//    its rows allow.
//  - Reduction. Each thread walks the chunk without synchronising and
//    leaves its chain's partial r . S of its 4 columns per step in shared
//    memory (one float4). One pass per chunk sums the 32 partials of each
//    (step, column) in the order above, adds (r . u k) v (one warp
//    reduction per step, once per chunk) and writes o coalesced. Every
//    order is fixed, so a call repeats bit for bit.
//  - In place. A block reads its tile of the state before any write and
//    writes only that tile at the end, so the final state may overwrite
//    s0.
//  - Checkpoints. When autograd records, a float32 forward runs the
//    instance that also writes the state before every kCk-th step into
//    `ckpt` (B, ceil(S / kCk), H, hd, hd): extra stores at the top of the
//    walk, the arithmetic untouched, so o and the final state are the same
//    bit for bit with or without them. The serving instance compiles
//    without them. kCk is ref.CKPT_STEPS, which kernel.py passes to nvcc
//    as RWKV6_CKPT_STEPS, as it does for the backward. The backward
//    walks each span once from its state (rwkv6_scan_bwd.cu): S_{t-1}
//    cannot be had by running the update backwards, since exp(logw)
//    underflows to 0.
// ops.scan_plan mirrors the instance, tiles, chunk and shared memory
// below from shapes alone (the limit a block, kernel.SMEM_LIMIT, comes
// in as RWKV6_SMEM_LIMIT); the CPU tests check it.
//
// The backward's dv and ds0 (rwkv6_bwd_dv_kernel, float32). With G the
// cotangent of the state after step t (ds_last after the last step),
//     dv_t = k_t . G + (r_t . (u k_t)) do_t,   G <- diag(w_t) G + r_t do_t^T,
// and ds0 is the last G. That is this scan in reverse time with r and k
// swapped and do for v: read-out k_t, update r_t do_t^T, decay w_t, the
// same bonus, from ds_last. So the same body runs it, walking the inputs
// from the last step with negative step strides and writing dv from the
// last step back; its G is the row kernel's bit for bit (the same fmaf
// of the same values).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#ifndef RWKV6_CKPT_STEPS
#error "RWKV6_CKPT_STEPS (ref.CKPT_STEPS) must be defined"
#endif
#ifndef RWKV6_SMEM_LIMIT
#error "RWKV6_SMEM_LIMIT (kernel.SMEM_LIMIT) must be defined"
#endif

namespace {

constexpr int kCk = RWKV6_CKPT_STEPS;    // steps between saved states
constexpr int kCols = 20;                // state columns per block
constexpr int kQuads = kCols / 4;        // column quads
constexpr int kChains = 32;              // 8 groups of 4 chains
constexpr int kThreads = kChains * kQuads;   // 160: a chain x a quad each
// floats of chain sums a step: 32 chains, and one row more so that the
// reduction's reads of neighbouring steps fall in other banks
constexpr int kPartStep = 33 * kCols;
constexpr size_t kSmemLimit = RWKV6_SMEM_LIMIT;   // two blocks an SM

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

// four consecutive values, widened to float32
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

struct Strides {  // in elements
  long long b, s, h;
};

template <typename T>
__host__ __device__ constexpr bool is_f32() {
  return sizeof(T) == 4;
}

// shared memory of one block, in bytes, at a given chunk; L rows a chain
template <typename T, int L>
__host__ __device__ constexpr size_t smem_bytes_at(int chunk) {
  const size_t rows = 8 * 4 * (size_t)L;
  return 2 * (size_t)chunk * (3 * rows + kCols) * sizeof(T)   // ring
         + (is_f32<T>() ? 0 : 3 * (size_t)chunk * rows * 4)   // bf16 work
         + (size_t)chunk * kPartStep * 4                      // chain sums
         + (size_t)chunk * 4                                  // r . (u k)
         + rows * 4;                                          // u
}

// steps a chunk: 16, or 8 where 16 would not leave room for two blocks
template <typename T, int L>
__host__ __device__ constexpr int chunk_steps() {
  return smem_bytes_at<T, L>(16) <= kSmemLimit ? 16 : 8;
}

template <typename T, int L>
__host__ __device__ constexpr size_t smem_bytes() {
  return smem_bytes_at<T, L>(chunk_steps<T, L>());
}

// this thread's L x 4 of a state written at `at` (one (b, h) state)
template <int L>
__device__ __forceinline__ void store_tile(float* at0,
                                           const float (&st)[L][4], int row0,
                                           int col0, int hd, bool quad_io) {
#pragma unroll
  for (int q = 0; q < L; ++q) {
    const int row = row0 + 4 * q;
    float* at = at0 + (long long)row * hd + col0;
    if (quad_io && row < hd) {
      *reinterpret_cast<float4*>(at) =
          make_float4(st[q][0], st[q][1], st[q][2], st[q][3]);
    } else {
#pragma unroll
      for (int m = 0; m < 4; ++m)
        if (row < hd && col0 + m < hd) at[m] = st[q][m];
    }
  }
}

// What an instance of the scan's body does besides the forward.
enum class Walk {
  kServe,     // the forward: o and the final state
  kSave,      // also the state before every kCk-th step, into ckpt
  kReverse,   // the backward's dv: steps walked from the last (the inputs
              // come at the last step with negative strides), o written
              // from the last step back
};

// The scan of one block: the kernels below are this body.
template <typename T, int L, Walk kWalk>
__device__ __forceinline__ void wkv_scan(
    const T* __restrict__ r, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ lw,
    const float* __restrict__ u, const float* s0, T* __restrict__ o,
    float* s_out, float* __restrict__ ckpt, Strides rs, Strides ks,
    Strides vs, Strides ws, int S, int H, int hd, int vec, int svec) {
  constexpr bool kF32 = is_f32<T>();
  constexpr int G = 4 * L;                             // rows a group
  constexpr int kRows = 8 * G;                         // hd, padded
  constexpr int kC = chunk_steps<T, L>();
  constexpr int E = 16 / sizeof(T);                    // a row packet
  constexpr int EV = 4 / sizeof(T);                    // a v packet
  constexpr int kRowPk = 3 * kRows / E;                // r, k, logw
  constexpr int kStepPk = kRowPk + kCols / EV;         // packets a step
  constexpr int kPkPerThread = (kStepPk + kThreads - 1) / kThreads;
  constexpr int kBuf = kC * (3 * kRows + kCols);       // T's a buffer

  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);                // 2 x kBuf
  float* work = reinterpret_cast<float*>(ring + 2 * kBuf);
  float* part = work + (kF32 ? 0 : 3 * kC * kRows);    // kC x kPartStep
  float* ruk = part + kC * kPartStep;                  // kC
  float* u_s = ruk + kC;                               // kRows

  // thread = (chain, quad): chain e of group g, columns 4 cq .. 4 cq + 3
  const int pair = threadIdx.x / 4, e = threadIdx.x % 4;
  const int g = pair / kQuads, cq = pair % kQuads;
  const int chain = 4 * g + e;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int j0 = blockIdx.x * kCols;
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const int row0 = g * G + e;              // rows row0 + 4 q, q < L
  const int col0 = j0 + 4 * cq;            // columns col0 .. col0 + 3

  for (int i = threadIdx.x; i < kRows; i += kThreads)
    u_s[i] = i < hd ? u[(long long)h * hd + i] : 0.f;

  // this thread's L x 4 of the state, in registers for the whole sequence
  // (as one float4 a row where the four columns lie inside hd, aligned)
  const bool quad_io = svec && col0 + 3 < hd;
  float st[L][4];
  {
    const float* s_in = s0 + (b * H + h) * (long long)hd * hd;
#pragma unroll
    for (int q = 0; q < L; ++q) {
      const int row = row0 + 4 * q;
      const float* at = s_in + (long long)row * hd + col0;
      if (quad_io && row < hd) {
        const float4 x = *reinterpret_cast<const float4*>(at);
        st[q][0] = x.x, st[q][1] = x.y, st[q][2] = x.z, st[q][3] = x.w;
      } else {
#pragma unroll
        for (int m = 0; m < 4; ++m)
          st[q][m] = row < hd && col0 + m < hd ? at[m] : 0.f;
      }
    }
  }

  // This thread's packets of every step, fixed for the whole sequence:
  // 16 bytes of a row of r, k or logw, or 4 bytes of the tile's v.
  struct Packet {
    const T* src;          // at step 0
    long long step;        // elements from one step to the next
    int dst, dstep;        // its place in a buffer, at step 0; per step
    int lim, n;            // elements inside hd; elements it carries
  };
  Packet pks[kPkPerThread];
#pragma unroll
  for (int i = 0; i < kPkPerThread; ++i) {
    const int pk = threadIdx.x + i * kThreads;
    Packet& p = pks[i];
    if (pk < kRowPk) {
      const int kind = pk / (kRows / E), e0 = (pk % (kRows / E)) * E;
      const T* base = kind == 0 ? r : kind == 1 ? k : lw;
      const Strides sa = kind == 0 ? rs : kind == 1 ? ks : ws;
      p = Packet{base + b * sa.b + h * sa.h + e0, sa.s,
                 kind * kC * kRows + e0, kRows, hd - e0, E};
    } else {
      const int e0 = (pk - kRowPk) * EV;
      p = Packet{v + b * vs.b + h * vs.h + j0 + e0, vs.s,
                 3 * kC * kRows + e0, kCols, hd - j0 - e0, EV};
      if (pk >= kStepPk) p.n = 0;                // no packet
    }
  }

  // start the copy of chunk c into its buffer
  auto issue = [&](int c) {
    const int t0 = c * kC, len = min(kC, S - t0);
    T* buf = ring + (c & 1) * kBuf;
#pragma unroll
    for (int i = 0; i < kPkPerThread; ++i) {
      const Packet& p = pks[i];
      if (p.n == 0) continue;
      const T* src = p.src + (long long)t0 * p.step;
      T* dst = buf + p.dst;
      if (vec && p.lim >= p.n) {
#pragma unroll 4
        for (int tt = 0; tt < len; ++tt, src += p.step, dst += p.dstep) {
          if (p.n == E) cp_async16(dst, src);
          else cp_async4(dst, src);
        }
      } else {
#pragma unroll 1
        for (int tt = 0; tt < len; ++tt, src += p.step, dst += p.dstep)
          for (int x = 0; x < p.n; ++x)
            dst[x] = x < p.lim ? src[x] : from_f32<T>(0.f);
      }
    }
    cp_async_commit();
  };

  issue(0);
  for (int c = 0; c * kC < S; ++c) {
    const int t0 = c * kC;
    const int n = min(kC, S - t0);
    T* buf = ring + (c & 1) * kBuf;
    const float* R = kF32 ? reinterpret_cast<const float*>(buf) : work;
    const float* K = R + kC * kRows;
    const float* W = K + kC * kRows;
    const T* V = buf + 3 * kC * kRows;

    cp_async_wait_all();
    __syncthreads();
    // buffer (c+1)&1 was last read before the barrier above
    if (t0 + n < S) issue(c + 1);

    // exp(logw) in place (float32), or r, k and exp(logw) widened into
    // the float32 work rows (bf16), four values a thread at a time
#pragma unroll 1
    for (int kind = kF32 ? 2 : 0; kind < 3; ++kind) {
      T* x_in = buf + kind * kC * kRows;
      float* x_out = kF32 ? reinterpret_cast<float*>(x_in)
                          : work + kind * kC * kRows;
#pragma unroll 4
      for (int i = threadIdx.x; i < n * kRows / 4; i += kThreads) {
        float4 x = load4(x_in + 4 * i);
        if (kind == 2)
          x = make_float4(expf(x.x), expf(x.y), expf(x.z), expf(x.w));
        *reinterpret_cast<float4*>(x_out + 4 * i) = x;
      }
    }
    __syncthreads();

    // r . (u k) per step: one warp per step (steps warp, warp + 5, ...,
    // side by side), lane sums rows lane, lane + 32, ..., then a butterfly
    {
      constexpr int kW = kThreads / 32;
      constexpr int kPer = (kC + kW - 1) / kW;
      float acc[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int tt = warp + i * kW;
        acc[i] = 0.f;
        if (tt < n) {
#pragma unroll
          for (int row = lane; row < kRows; row += 32)
            acc[i] += R[tt * kRows + row] * u_s[row] * K[tt * kRows + row];
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
#pragma unroll
        for (int i = 0; i < kPer; ++i)
          acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], off);
#pragma unroll
      for (int i = 0; i < kPer; ++i)
        if (lane == 0 && warp + i * kW < n) ruk[warp + i * kW] = acc[i];
    }

    // walk the chunk: this thread's chain of r . S for its four columns,
    // then the state update; the chain sums go to shared memory
#pragma unroll 1
    for (int tt = 0; tt < n; ++tt) {
      if constexpr (kWalk == Walk::kSave) {
        if ((t0 + tt) % kCk == 0)
          store_tile<L>(ckpt + ((b * ((S + kCk - 1) / kCk) + (t0 + tt) / kCk)
                                    * H + h) * (long long)hd * hd,
                        st, row0, col0, hd, quad_io);
      }
      const float4 v4 = load4(V + tt * kCols + 4 * cq);
      const float vm[4] = {v4.x, v4.y, v4.z, v4.w};
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int q = 0; q < L; ++q) {
        const int at = tt * kRows + row0 + 4 * q;
        const float rr = R[at], kk = K[at], ww = W[at];
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          acc[m] = fmaf(rr, st[q][m], acc[m]);
          st[q][m] = fmaf(ww, st[q][m], kk * vm[m]);
        }
      }
      *reinterpret_cast<float4*>(part + tt * kPartStep + chain * kCols
                                 + 4 * cq) =
          make_float4(acc[0], acc[1], acc[2], acc[3]);
    }
    __syncthreads();

    // o_t: each group's (c0 + c1) + (c2 + c3), the groups in order, then
    // + (r . u k) v, written coalesced; the next write of part and ruk
    // follows the next chunk's barriers
    for (int idx = threadIdx.x; idx < n * kCols; idx += kThreads) {
      const int tt = idx / kCols, cc = idx % kCols;
      if (j0 + cc >= hd) continue;
      const float* pt = part + tt * kPartStep + cc;
      float acc = 0.f;
#pragma unroll
      for (int gg = 0; gg < 8; ++gg) {
        const float* pg = pt + 4 * gg * kCols;
        acc += (pg[0] + pg[kCols]) + (pg[2 * kCols] + pg[3 * kCols]);
      }
      acc = fmaf(ruk[tt], to_f32(V[tt * kCols + cc]), acc);
      const int ts =
          kWalk == Walk::kReverse ? S - 1 - (t0 + tt) : t0 + tt;
      o[((b * S + ts) * H + h) * (long long)hd + j0 + cc] = from_f32<T>(acc);
    }
  }

  store_tile<L>(s_out + (b * H + h) * (long long)hd * hd, st, row0, col0,
                hd, quad_io);
}

#define WKV_PARAMS(T)                                                      \
  const T *__restrict__ r, const T *__restrict__ k,                       \
      const T *__restrict__ v, const T *__restrict__ lw,                  \
      const float *__restrict__ u, const float *s0, T *__restrict__ o,    \
      float *s_out, float *__restrict__ ckpt, Strides rs, Strides ks,     \
      Strides vs, Strides ws, int S, int H, int hd, int vec, int svec
#define WKV_ARGS \
  r, k, v, lw, u, s0, o, s_out, ckpt, rs, ks, vs, ws, S, H, hd, vec, svec

template <typename T, int L>
__global__ void __launch_bounds__(kThreads, 2)
rwkv6_scan_kernel(WKV_PARAMS(T)) {
  wkv_scan<T, L, Walk::kServe>(WKV_ARGS);
}

// the forward that also saves the states the backward re-walks
template <int L>
__global__ void __launch_bounds__(kThreads, 2)
rwkv6_scan_save_kernel(WKV_PARAMS(float)) {
  wkv_scan<float, L, Walk::kSave>(WKV_ARGS);
}

// the backward's dv and ds0: the same body on time-reversed inputs
template <int L>
__global__ void __launch_bounds__(kThreads, 2)
rwkv6_bwd_dv_kernel(WKV_PARAMS(float)) {
  wkv_scan<float, L, Walk::kReverse>(WKV_ARGS);
}

struct Call {  // what the C entry points pass down
  const void *r, *k, *v, *lw;
  const float *u, *s0;
  void* o;
  float* s_out;
  float* ckpt;
  Strides st[4];
  int B, S, H, hd, vec, svec;
  Walk walk;    // kSave and kReverse: float32 only
  cudaStream_t stream;
};

enum Op { kLaunch, kSmem, kBlocksPerSm };

// the kernel of one instance: the forward, the forward that saves the
// states, or the backward's dv
template <typename T, int L>
auto kernel_of(Walk walk) {
  if constexpr (is_f32<T>()) {
    if (walk == Walk::kSave) return rwkv6_scan_save_kernel<L>;
    if (walk == Walk::kReverse) return rwkv6_bwd_dv_kernel<L>;
  }
  return rwkv6_scan_kernel<T, L>;
}

// one instance: launch it, or report its shared memory or occupancy
template <typename T, int L>
int act(Op op, const Call& a) {
  constexpr size_t smem = smem_bytes<T, L>();
  if (op == kSmem) return (int)smem;
  const auto kern = kernel_of<T, L>(a.walk);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return -static_cast<int>(err);
  if (op == kBlocksPerSm) {
    int n = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kern, kThreads,
                                                        smem);
    return err == cudaSuccess ? n : -static_cast<int>(err);
  }
  const dim3 grid((a.hd + kCols - 1) / kCols, a.H, a.B);
  kern<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.r), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.lw), a.u, a.s0,
      static_cast<T*>(a.o), a.s_out, a.ckpt, a.st[0], a.st[1], a.st[2],
      a.st[3], a.S, a.H, a.hd, a.vec, a.svec);
  return -static_cast<int>(cudaGetLastError());
}

// the smallest instance whose 8 groups of 4 L rows cover hd
template <typename T>
int act_typed(Op op, const Call& a) {
  if (a.hd <= 32) return act<T, 1>(op, a);
  if (a.hd <= 64) return act<T, 2>(op, a);
  if (a.hd <= 160) return act<T, 5>(op, a);
  return act<T, 8>(op, a);
}

int dispatch(Op op, int dtype, const Call& a) {
  if (a.hd <= 0 || a.hd > 256 || (dtype != 0 && dtype != 1))
    return -static_cast<int>(cudaErrorInvalidValue);
  return dtype == 0 ? act_typed<float>(op, a)
                    : act_typed<__nv_bfloat16>(op, a);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15) == 0;
}

// every row of r, k, v, logw starts on 16 bytes: cp.async throughout;
// the state's rows start on 16 bytes: its columns move four at a time
void set_alignment(Call& a, long long esize) {
  bool vec = aligned16(a.r) && aligned16(a.k) && aligned16(a.v) &&
             aligned16(a.lw);
  for (const Strides& s : a.st)
    vec = vec && (s.b * esize) % 16 == 0 && (s.s * esize) % 16 == 0 &&
          (s.h * esize) % 16 == 0;
  a.vec = vec;
  a.svec = aligned16(a.s0) && aligned16(a.s_out) &&
           (a.ckpt == nullptr || aligned16(a.ckpt)) && a.hd % 4 == 0;
}

}  // namespace

extern "C" {

// Launches on `stream`; returns a cudaError_t (0 = ok). r, k, v, logw
// (B,S,H,hd) are device pointers with the given element strides (batch,
// step, head) and a contiguous head dim; u (H,hd), s0 and s_out
// (B,H,hd,hd) are contiguous float32, and s_out may be s0; o (B,S,H,hd)
// is contiguous. ckpt, when not null (float32 only), receives the state
// before steps 0, kCk, 2 kCk, ...: (B, ceil(S / kCk), H, hd, hd) float32,
// contiguous. dtype: 0 = float32, 1 = bfloat16. 0 < hd <= 256.
int rwkv6_scan_launch(const void* r, const void* k, const void* v,
                      const void* lw, const float* u, const float* s0,
                      void* o, float* s_out, float* ckpt, long long rsb,
                      long long rss, long long rsh, long long ksb,
                      long long kss, long long ksh, long long vsb,
                      long long vss, long long vsh, long long wsb,
                      long long wss, long long wsh, int B, int S, int H,
                      int hd, int dtype, void* stream) {
  if (hd <= 0 || hd > 256 || B > 65535 || H > 65535 || S < 0 ||
      (dtype != 0 && dtype != 1) || (ckpt != nullptr && dtype != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0 || H <= 0) return 0;
  Call a{r, k, v, lw, u, s0, o, s_out, ckpt,
         {{rsb, rss, rsh}, {ksb, kss, ksh}, {vsb, vss, vsh}, {wsb, wss, wsh}},
         B, S, H, hd, 0, 0, ckpt != nullptr ? Walk::kSave : Walk::kServe,
         static_cast<cudaStream_t>(stream)};
  set_alignment(a, dtype == 0 ? 4 : 2);
  return -dispatch(kLaunch, dtype, a);
}

// The backward's dv (B,S,H,hd) and ds0 (B,H,hd,hd), float32: the scan
// from ds_last (the state's cotangent after the last step) over the
// steps from the last to the first, read-out k, update r do^T. k, r,
// dout and logw (B,S,H,hd) take element strides (batch, step, head) and
// a contiguous head dim; u, ds_last, ds0 and dv are contiguous.
int rwkv6_scan_bwd_dv_launch(const float* k, const float* r,
                             const float* dout, const float* lw,
                             const float* u, const float* ds_last, float* dv,
                             float* ds0, long long ksb, long long kss,
                             long long ksh, long long rsb, long long rss,
                             long long rsh, long long dsb, long long dss,
                             long long dsh, long long wsb, long long wss,
                             long long wsh, int B, int S, int H, int hd,
                             void* stream) {
  if (hd <= 0 || hd > 256 || B > 65535 || H > 65535 || S < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0 || H <= 0) return 0;
  const long long last = S > 0 ? S - 1 : 0;     // walk from the last step
  Call a{k + last * kss, r + last * rss, dout + last * dss, lw + last * wss,
         u, ds_last, dv, ds0, nullptr,
         {{ksb, -kss, ksh}, {rsb, -rss, rsh}, {dsb, -dss, dsh},
          {wsb, -wss, wsh}},
         B, S, H, hd, 0, 0, Walk::kReverse,
         static_cast<cudaStream_t>(stream)};
  set_alignment(a, 4);
  return -dispatch(kLaunch, 0, a);
}

// Shared memory of one block of the instance that takes hd, in bytes
// (-1 outside 0 < hd <= 256 or for another dtype).
int rwkv6_scan_smem_bytes(int hd, int dtype) {
  Call a{};
  a.hd = hd;
  const int n = dispatch(kSmem, dtype, a);
  return n < 0 ? -1 : n;
}

// Blocks of the instance that takes hd that one SM of the current device
// holds at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor); a
// negative cudaError_t on failure.
int rwkv6_scan_blocks_per_sm(int hd, int dtype) {
  Call a{};
  a.hd = hd;
  return dispatch(kBlocksPerSm, dtype, a);
}

const char* rwkv6_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
