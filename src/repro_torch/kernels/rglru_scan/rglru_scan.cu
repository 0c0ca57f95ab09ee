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
// carried in VMEM across the sequential chunk axis. One thread per
// channel walking all of S leaves only B R threads (5,120 at the prefill
// shape), each with a few loads in flight: far fewer bytes than HBM's
// latency needs, so such a kernel is bound by latency, not bandwidth.
// Here S is split into chunks across threads, joined by a carry in the
// block:
//  - A block is 16 neighbouring channels x C <= 16 chunks of L = 8
//    steps: thread (j, c) owns channel j and steps [c L, c L + L) of each
//    piece of C L steps (C = ceil(S / 8), at most 16: pieces of 128
//    steps, one after the other, each from the last h of the one
//    before). A warp's loads are two 64 B rows (float32).
//  - Loads: a thread's L steps of a and b go into registers, all issued
//    before the first is used, and the next piece's are issued before
//    this piece's walks, so they fly during its barriers and walks.
//  - Walk 1 folds the chunk into its map h -> A h + Bc: A = prod a_t and
//    Bc = the chunk's h from 0, in step order. Steps past S are a = 1,
//    b = 0, the identity, as the reference's wrapper pads them.
//  - Carry: one thread per channel folds h0 (or the last piece's h)
//    through the chunks in order, carry_{c+1} = A_c carry_c + Bc_c, into
//    shared memory. A fixed order: no look-back, no atomics, so a call
//    repeats bit for bit.
//  - Walk 2: each thread reruns its chunk from its carry, h = a h + b in
//    the plain version's step order, and writes hs. The thread whose
//    chunk holds step S - 1 writes that h as h_last, so hs[:, -1] is
//    h_last rounded.
//  - One chunk (S <= 8, the decode step at S = 1 with L = 1): a block of
//    64 channels, each thread walks its channel from h0 with no walk 1,
//    no carry and no barrier, and h0's load flies with a's and b's.
// So a and b are read from HBM once and hs written once. At the prefill
// shape the grid is (R / 16, B) = 320 blocks of 256 threads, four pieces
// each; at most 80 registers a thread (__launch_bounds__, no spills) keep
// three blocks an SM, so all are resident in one wave on 132 SMs. Larger
// chunks held in registers spilled. Ragged R is masked in the kernel and
// S needs no padding. h0 is read before the first barrier and h_last
// written after it (with one chunk, by the same thread), so h_last may be
// the h0 buffer (in place).
//
// Backward (rglru_bwd_kernel, float32; the reference has no backward
// kernel: it differentiates its associative scan with XLA). For the
// cotangents dhs (B,S,R) and dh_last (B,R) of (hs, h_last), with g_S =
// dh_last,
//     g_t = a_{t+1} g_{t+1} + dhs_t   (a_S = 1),
// it writes db_t = g_t, da_t = g_t h_{t-1} (h_{-1} = h0) and dh0 =
// a_0 g_0. That is the forward's scan with time reversed and the
// coefficient shifted by one step, so it takes the forward's scheme and
// grid: a thread's L steps of a_{t+1} and dhs in registers (the previous
// piece's issued before this one's walks), walk 1 folds the chunk from
// its last step into g -> A g + Bc, the carry runs from the last chunk
// to the first (entered with dh_last, or the g of the piece after), and
// walk 2 reruns the chunk from its carry, writing db and da (h_{t-1} is
// read from hs, or h0 at t = 0, for walk 2 only). Pieces go from the
// last to the first. Bytes bound it: a, hs and dhs read, da and db
// written, 52.4 MB at (2, 512, 2560), 15.7 us at 3.35 TB/s. Every sum has
// a fixed order and no block writes another's elements: no atomics, and
// a call repeats bit for bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kChannels = 16;           // a block's channels, chunks > 1
constexpr int kOneChunkChannels = 64;   // a block's channels, one chunk
constexpr int kMaxChunks = 16;          // chunks in a piece
constexpr int kChunkSteps = 8;          // steps a chunk (L), S > 1
constexpr int kMaxThreads = kChannels * kMaxChunks;
constexpr int kMinBlocks = 3;           // blocks an SM

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

int chunk_steps(int S) { return S <= 1 ? 1 : kChunkSteps; }

int chunks(int S) {
  const int n = (S + chunk_steps(S) - 1) / chunk_steps(S);
  return n < 1 ? 1 : n > kMaxChunks ? kMaxChunks : n;
}

int block_channels(int S) {
  return chunks(S) == 1 ? kOneChunkChannels : kChannels;
}

// L steps of a chunk into registers, as float: a from ap, b from bp, the
// steps past the n that exist as the identity (a = 1, b = 0)
template <typename T, int L>
__device__ __forceinline__ void load_chunk(const T* ap, long long ass,
                                           const T* bp, long long bss, int n,
                                           float (&av)[L], float (&bv)[L]) {
  if (n == L) {
#pragma unroll
    for (int i = 0; i < L; ++i) {
      av[i] = to_f32(ap[i * ass]);
      bv[i] = to_f32(bp[i * bss]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < L; ++i) {
      av[i] = i < n ? to_f32(ap[i * ass]) : 1.f;
      bv[i] = i < n ? to_f32(bp[i * bss]) : 0.f;
    }
  }
}

// steps of a chunk that starts at t0 and exist (0 in a dead lane)
template <int L>
__device__ __forceinline__ int steps_in(bool live, int t0, int S) {
  return live ? max(0, min(L, S - t0)) : 0;
}

// walk 2 of a chunk: h <- a h + b from the given h, each step's h into
// out (a step apart by `stride`) for the n steps that exist
template <typename T, int L>
__device__ __forceinline__ float walk_chunk(const float (&av)[L],
                                            const float (&bv)[L], float h,
                                            T* out, long long stride, int n) {
  if (n == L) {
#pragma unroll
    for (int i = 0; i < L; ++i) {
      h = fmaf(av[i], h, bv[i]);
      out[i * stride] = from_f32<T>(h);
    }
  } else {
#pragma unroll
    for (int i = 0; i < L; ++i) {
      h = fmaf(av[i], h, bv[i]);
      if (i < n) out[i * stride] = from_f32<T>(h);
    }
  }
  return h;
}

template <typename T, int L>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
rglru_scan_kernel(const T* __restrict__ a, const T* __restrict__ b,
                  const float* h0, T* __restrict__ hs, float* h_last,
                  long long asb, long long ass, long long bsb, long long bss,
                  int S, int R) {
  __shared__ float agg_a[kMaxChunks][kChannels];
  __shared__ float agg_b[kMaxChunks][kChannels];
  __shared__ float carry[kMaxChunks][kChannels];
  __shared__ float piece_h[kChannels];
  const int j = threadIdx.x, c = threadIdx.y, C = blockDim.y;
  const int r = blockIdx.x * blockDim.x + j;
  const bool live = r < R;
  const long long bi = blockIdx.y;
  const T* ap = a + bi * asb + r;
  const T* bp = b + bi * bsb + r;
  T* hp = hs + bi * (long long)S * R + r;
  // h0 first, so that its load flies with the first chunk's
  const float h_first = live && c == 0 ? h0[bi * R + r] : 0.f;
  if (C == 1) {            // S <= L: one chunk from h0, no carry, no barrier
    float av[L], bv[L];
    load_chunk<T, L>(ap, ass, bp, bss, live ? S : 0, av, bv);
    const float h = walk_chunk<T, L>(av, bv, h_first, hp, R, live ? S : 0);
    if (live) h_last[bi * R + r] = S > 0 ? h : h_first;
    return;
  }
  const int piece = C * L;
  const bool writes_last = live && ((S - 1) % piece) / L == c;
  float na[L], nb[L];                     // the next piece's chunk
  load_chunk<T, L>(ap + c * L * ass, ass, bp + c * L * bss, bss,
                   steps_in<L>(live, c * L, S), na, nb);
  float h = h_first;
  for (int p0 = 0; p0 < S; p0 += piece) {
    const int t0 = p0 + c * L;
    float av[L], bv[L];
#pragma unroll
    for (int i = 0; i < L; ++i) {
      av[i] = na[i];
      bv[i] = nb[i];
    }
    if (p0 + piece < S)                   // in flight during this piece
      load_chunk<T, L>(ap + (t0 + piece) * ass, ass, bp + (t0 + piece) * bss,
                       bss, steps_in<L>(live, t0 + piece, S), na, nb);
    float A = 1.f, Bc = 0.f;              // walk 1: the chunk's map
#pragma unroll
    for (int i = 0; i < L; ++i) {
      Bc = fmaf(av[i], Bc, bv[i]);
      A = av[i] * A;
    }
    agg_a[c][j] = A;
    agg_b[c][j] = Bc;
    __syncthreads();
    if (c == 0) {                         // carry, in chunk order
      float x = p0 == 0 ? h : piece_h[j];
#pragma unroll
      for (int k = 0; k < kMaxChunks; ++k) {
        if (k < C) {
          carry[k][j] = x;
          x = fmaf(agg_a[k][j], x, agg_b[k][j]);
        }
      }
    }
    __syncthreads();
    h = walk_chunk<T, L>(av, bv, carry[c][j], hp + (long long)t0 * R, R,
                         steps_in<L>(live, t0, S));
    // the next piece starts from this one's last h; its first barrier
    // orders this write before the carry reads it
    if (c == C - 1 && p0 + piece < S) piece_h[j] = h;
  }
  if (writes_last) h_last[bi * R + r] = h;
}

// n values a stride apart into registers, `fill` past them
template <int L>
__device__ __forceinline__ void load_steps(const float* p, long long stride,
                                           int n, float fill,
                                           float (&out)[L]) {
  if (n == L) {
#pragma unroll
    for (int i = 0; i < L; ++i) out[i] = p[i * stride];
  } else {
#pragma unroll
    for (int i = 0; i < L; ++i) out[i] = i < n ? p[i * stride] : fill;
  }
}

// a thread's chunk of the backward at t0: a_{t+1} (1 from step S - 1
// on) and dhs_t (0 past S)
template <int L>
__device__ __forceinline__ void load_bwd(const float* ap, long long ass,
                                         const float* dp, long long dss,
                                         bool live, int t0, int S,
                                         float (&av)[L], float (&dv)[L]) {
  load_steps<L>(ap + (long long)(t0 + 1) * ass, ass,
                live ? max(0, min(L, S - 1 - t0)) : 0, 1.f, av);
  load_steps<L>(dp + (long long)t0 * dss, dss, steps_in<L>(live, t0, S),
                0.f, dv);
}

// walk 2 of the backward: g <- a_{t+1} g + dhs_t from the last step of
// the chunk to its first, db_t = g and da_t = g h_{t-1} for the n steps
// that exist; returns g at the chunk's first step
template <int L>
__device__ __forceinline__ float walk_bwd(const float (&av)[L],
                                          const float (&dv)[L],
                                          const float (&hv)[L], float g,
                                          float* dap, float* dbp,
                                          long long stride, int n) {
#pragma unroll
  for (int i = L - 1; i >= 0; --i) {
    g = fmaf(av[i], g, dv[i]);
    if (i < n) {
      dbp[i * stride] = g;
      dap[i * stride] = g * hv[i];
    }
  }
  return g;
}

template <int L>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
rglru_bwd_kernel(const float* __restrict__ a, const float* __restrict__ h0,
                 const float* __restrict__ hs, const float* __restrict__ dhs,
                 const float* __restrict__ dh_last, float* __restrict__ da,
                 float* __restrict__ db, float* __restrict__ dh0,
                 long long asb, long long ass, long long dsb, long long dss,
                 int S, int R) {
  __shared__ float agg_a[kMaxChunks][kChannels];
  __shared__ float agg_b[kMaxChunks][kChannels];
  __shared__ float carry[kMaxChunks][kChannels];
  const int j = threadIdx.x, c = threadIdx.y, C = blockDim.y;
  const int r = blockIdx.x * blockDim.x + j;
  const bool live = r < R;
  const long long bi = blockIdx.y;
  const float* ap = a + bi * asb + r;
  const float* dp = dhs + bi * dsb + r;
  const long long off = bi * (long long)S * R + r;
  const float* hp = hs + off;
  // the g that enters after the last step, and h_{-1}
  float g = live && c == 0 && dh_last != nullptr ? dh_last[bi * R + r] : 0.f;
  const float h_first = live && c == 0 ? h0[bi * R + r] : 0.f;
  if (C == 1) {            // S <= L: one chunk from dh_last, no barrier
    float av[L], dv[L], hv[L];
    load_bwd<L>(ap, ass, dp, dss, live, 0, S, av, dv);
    const int n = steps_in<L>(live, 0, S);
#pragma unroll
    for (int i = 0; i < L; ++i)
      hv[i] = i == 0 ? h_first : i < n ? hp[(long long)(i - 1) * R] : 0.f;
    g = walk_bwd<L>(av, dv, hv, g, da + off, db + off, R, n);
    if (live) dh0[bi * R + r] = S > 0 ? ap[0] * g : g;
    return;
  }
  const int piece = C * L;
  const int last = (S - 1) / piece * piece;
  float na[L], nd[L];                     // the piece before's chunk
  load_bwd<L>(ap, ass, dp, dss, live, last + c * L, S, na, nd);
  for (int p0 = last; p0 >= 0; p0 -= piece) {
    const int t0 = p0 + c * L;
    float av[L], dv[L], hv[L];
#pragma unroll
    for (int i = 0; i < L; ++i) {
      av[i] = na[i];
      dv[i] = nd[i];
    }
    if (p0 > 0)                           // in flight during this piece
      load_bwd<L>(ap, ass, dp, dss, live, t0 - piece, S, na, nd);
    const int n = steps_in<L>(live, t0, S);
#pragma unroll
    for (int i = 0; i < L; ++i)           // h_{t-1}, for walk 2
      hv[i] = i >= n ? 0.f : t0 + i == 0 ? h_first
                                         : hp[(long long)(t0 + i - 1) * R];
    float A = 1.f, Bc = 0.f;              // walk 1, from the last step
#pragma unroll
    for (int i = L - 1; i >= 0; --i) {
      Bc = fmaf(av[i], Bc, dv[i]);
      A = av[i] * A;
    }
    agg_a[c][j] = A;
    agg_b[c][j] = Bc;
    __syncthreads();
    if (c == 0) {                         // carry, from the last chunk
      float x = g;
#pragma unroll
      for (int k = kMaxChunks - 1; k >= 0; --k) {
        if (k < C) {
          carry[k][j] = x;
          x = fmaf(agg_a[k][j], x, agg_b[k][j]);
        }
      }
    }
    __syncthreads();
    const float first = walk_bwd<L>(av, dv, hv, carry[c][j],
                                    da + off + (long long)t0 * R,
                                    db + off + (long long)t0 * R, R, n);
    // g at the piece's first step enters the piece before; the carry
    // that reads it is this thread's own
    if (c == 0) g = first;
  }
  if (live && c == 0) dh0[bi * R + r] = ap[0] * g;
}

struct Call {
  const void *a, *b;
  const float* h0;
  void* hs;
  float* h_last;
  long long asb, ass, bsb, bss;
  int B, S, R;
  cudaStream_t stream;
};

enum Op { kLaunch, kSmem, kBlocksPerSm };

// one instance: launch it, or report its shared memory or occupancy
template <typename T, int L>
int act(Op op, const Call& x) {
  const dim3 block(block_channels(x.S), chunks(x.S));
  if (op == kSmem) {
    cudaFuncAttributes attr;
    const cudaError_t err =
        cudaFuncGetAttributes(&attr, rglru_scan_kernel<T, L>);
    return err == cudaSuccess ? static_cast<int>(attr.sharedSizeBytes)
                              : -static_cast<int>(err);
  }
  if (op == kBlocksPerSm) {
    int n = 0;
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, rglru_scan_kernel<T, L>, block.x * block.y, 0);
    return err == cudaSuccess ? n : -static_cast<int>(err);
  }
  const dim3 grid((x.R + block.x - 1) / block.x, x.B);
  rglru_scan_kernel<T, L><<<grid, block, 0, x.stream>>>(
      static_cast<const T*>(x.a), static_cast<const T*>(x.b), x.h0,
      static_cast<T*>(x.hs), x.h_last, x.asb, x.ass, x.bsb, x.bss, x.S,
      x.R);
  return -static_cast<int>(cudaGetLastError());
}

template <typename T>
int act_typed(Op op, const Call& x) {
  return chunk_steps(x.S) == 1 ? act<T, 1>(op, x)
                                : act<T, kChunkSteps>(op, x);
}

struct BwdCall {
  const float *a, *h0, *hs, *dhs, *dh_last;
  float *da, *db, *dh0;
  long long asb, ass, dsb, dss;
  int B, S, R;
  cudaStream_t stream;
};

template <int L>
int launch_bwd(const BwdCall& x) {
  const dim3 block(block_channels(x.S), chunks(x.S));
  const dim3 grid((x.R + block.x - 1) / block.x, x.B);
  rglru_bwd_kernel<L><<<grid, block, 0, x.stream>>>(
      x.a, x.h0, x.hs, x.dhs, x.dh_last, x.da, x.db, x.dh0, x.asb, x.ass,
      x.dsb, x.dss, x.S, x.R);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(Op op, int dtype, const Call& x) {
  return dtype == 0 ? act_typed<float>(op, x)
                    : act_typed<__nv_bfloat16>(op, x);
}

int query(Op op, int S, int dtype) {
  if (S < 0 || (dtype != 0 && dtype != 1))
    return -static_cast<int>(cudaErrorInvalidValue);
  Call x{};
  x.S = S;
  return dispatch(op, dtype, x);
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
  const Call x{a, b, h0, hs, h_last, asb, ass, bsb, bss, B, S, R,
               static_cast<cudaStream_t>(stream)};
  return -dispatch(kLaunch, dtype, x);
}

// The backward, float32, on `stream`; returns a cudaError_t (0 = ok). a
// and dhs (B,S,R) have the given element strides (batch, step) and a
// contiguous channel dim; hs, da and db (B,S,R) and h0, dh_last and dh0
// (B,R) are contiguous; dh_last may be null (zero). Same grid and block
// as the forward at S.
int rglru_scan_bwd_launch(const float* a, const float* h0, const float* hs,
                          const float* dhs, const float* dh_last, float* da,
                          float* db, float* dh0, long long asb, long long ass,
                          long long dsb, long long dss, int B, int S, int R,
                          void* stream) {
  if (B > 65535 || S < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0 || R <= 0) return 0;
  const BwdCall x{a, h0, hs, dhs, dh_last, da, db, dh0, asb, ass, dsb, dss,
                  B, S, R, static_cast<cudaStream_t>(stream)};
  return chunk_steps(S) == 1 ? launch_bwd<1>(x) : launch_bwd<kChunkSteps>(x);
}

// Steps a chunk (L) and chunks a piece (C) for S steps, as launched.
int rglru_scan_chunk_steps(int S) { return chunk_steps(S); }
int rglru_scan_chunks(int S) { return chunks(S); }

// Shared memory of a block of the instance that takes S steps, in bytes,
// and the blocks of it that one SM of the current device holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor); each a negative
// cudaError_t on failure.
int rglru_scan_smem_bytes(int S, int dtype) {
  return query(kSmem, S, dtype);
}
int rglru_scan_blocks_per_sm(int S, int dtype) {
  return query(kBlocksPerSm, S, dtype);
}

const char* rglru_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
