// Causal GQA flash attention for Hopper (sm_90a), bfloat16 or float32.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention/kernel.py::flash_attention_kernel.
// For q (B,Sq,Hq,hd) and k, v (B,Skv,Hkv,hd) it computes, per q head h
// and its kv head h / (Hq / Hkv),
//     o[i] = sum_j softmax_j(q[i] . k[j] / sqrt(hd)) v[j]
// over the keys j that the mask allows (j <= i when causal, i - j <
// window when a window is set; the q row at index i has position i).
// Masked scores are -1e30, as in the reference, keys past Skv are -inf,
// and a row whose running sum is 0 is divided by 1 (the `_emit` guard of
// the TPU kernel).
//
// What bounds it on an H100: 4 hd operations per allowed (q, k) pair,
// against the q, k, v and o bytes read or written once. At the prefill
// shape (B = 2, S = 512, Hq = 12, Hkv = 2, hd = 128, bf16) that is
// 1.6 GFLOP against 7.3 MB: 1.6 us on the tensor cores, 2.2 us of bytes,
// so the bytes bound it, barely; at S = 4096 the 52 GFLOP bind (52 us
// against 8.8 us of bytes). At the main path's S <= 512 there are only
// 160-192 blocks of 64 q rows, so what the kernel really meets is the
// latency of each block's chain of K/V tiles and the occupancy of the
// SMs, long before the tensor-core rate. Two blocks of 4 warps share an
// SM (at hd 128 a block takes 87 KB of shared memory and over 200
// registers a thread), and the warps of a block
// step through each tile together: the mma of S, the softmax, the mma
// of P V. While they run the softmax, the tensor cores have only the
// other block's warps to feed them. A wgmma version (swizzled tiles, one
// tile's P V overlapping the next tile's softmax) was no faster at every
// shape, so the chain of copies per tile binds more than the products:
// TMA with a producer warp and deeper staging is the next step.
//
// bfloat16: FlashAttention-2 on the tensor cores. One block of 4 warps
// per (64-row q tile, q head, batch row); causal tiles are issued longest
// first. Each warp owns 16 q rows. Q is loaded once; at hd <= 128 it
// stays in registers as mma A fragments (ldmatrix), at hd 256 it stays
// in shared memory and is read with ldmatrix at each k step, so that the
// 128 f32 accumulators of a row block do not spill. K and V stream in
// bf16 through a two-stage shared-memory ring filled by 16-byte
// cp.async copies (tile t + 1 loads while tile t is computed); rows are
// padded by 16 bytes, so ldmatrix (K) and ldmatrix.trans (V) read eight
// rows from eight distinct bank groups. S = Q K^T and O += P V run on
// mma.sync.m16n8k16 (bf16 in, f32 accumulate). The online softmax works
// on the accumulator fragments: the scale 1/sqrt(hd), with log2(e)
// folded in, multiplies S in f32 (q is never pre-scaled in bf16), row max
// and row sum take two quad shuffles, p = exp2(s - m). P goes to bf16 A
// fragments in registers (the one rounding the plain version does not
// have: at most 2^-9 relative per weight) and never to shared memory.
// Masks are applied only on tiles that cross the diagonal, the window
// edge or Skv; tiles wholly masked are never loaded. K tiles are 64 rows
// at hd <= 128 and 32 at hd 256. Any hd that is a multiple of 8 runs in
// the 64-, 128- or 256-wide instance, zero-padded on load and never
// written beyond hd. The epilogue divides by l and writes through shared
// memory with 16-byte stores. The 16-byte copies need 16-byte-aligned
// base pointers and batch, sequence and head strides that are multiples
// of 8 elements (the wrapper checks).
//
// float32: the CUDA-core kernel. TF32 would break the float32
// tolerance, so float32 inputs keep a kernel whose products run on the
// f32 CUDA cores: each q row belongs to MAXD / 32 neighbouring threads,
// each holding 32 of its head dims (pre-scaled by 1/sqrt(hd) in f32) and
// of the f32 accumulator; K and V tiles of 64 rows are staged through
// shared memory in f32; a row reduces its dot products with warp
// shuffles and updates its online softmax every 16 keys. The dtype picks
// the kernel; there is no fallback between them.
//
// Ragged Sq and Skv are masked in both kernels: nothing is padded or
// copied. Strides are taken for the batch, sequence and head dims; the
// head dim must be contiguous.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr float kMasked = -1e30f;  // the reference's mask value
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {  // in elements
  long long b, s, h;
};

// ---------------------------------------------------------------------------
// bfloat16: tensor cores
// ---------------------------------------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;

// 64 q rows per block, 4 warps of 16; K/V tiles of 64 keys, 32 at hd
// 256. On the card these beat 2-warp blocks, 128-row blocks with 16 or
// 32 rows a warp, 32-key tiles at hd 128, a three-stage ring, three
// blocks an SM, and blocks that pair a long and a short causal q tile.
template <int D>
struct Cfg {
  static constexpr int kThreads = 128;
  static constexpr int BQ = 64;
  static constexpr int BK = D >= 256 ? 32 : 64;
  static constexpr int LD = D + 8;               // padded smem row
  static constexpr bool kQInRegs = D <= 128;
  // k steps of S = Q K^T unrolled at once: all where Q is in registers,
  // 4 at hd 256, so that the f32 accumulators do not spill
  static constexpr int kKUnroll = kQInRegs ? D / 16 : 4;
  // Q, then two stages of K, then two of V
  static constexpr size_t kSmem = (size_t)(BQ + 4 * BK) * LD * sizeof(bf16);
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-filled when `pred` is false
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a . b on the tensor cores: a 16x16 (row), b 16x8 (col), f32 c
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// rows [0, n_rows) x dims [0, hd) of an R-row tile into shared memory,
// the rest zero; 16 bytes per copy
template <int D, int R>
__device__ __forceinline__ void load_tile(bf16* s, const bf16* g,
                                          long long row_stride, int n_rows,
                                          int hd, int tid) {
  constexpr int kChunks = D / 8;
  constexpr int kThreads = Cfg<D>::kThreads;
#pragma unroll
  for (int e = tid; e < R * kChunks; e += kThreads) {
    const int r = e / kChunks;
    const int c = (e % kChunks) * 8;
    const bool in = r < n_rows && c < hd;
    cp_async16(s + r * Cfg<D>::LD + c, in ? g + r * row_stride + c : g, in);
  }
}

template <int D>
__global__ void __launch_bounds__(Cfg<D>::kThreads)
flash_attention_kernel_tc(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v, bf16* __restrict__ o,
                          float* __restrict__ lse, Strides qs, Strides ks,
                          Strides vs, Strides os, int Sq, int Skv, int hd,
                          int group, int causal, int window,
                          float scale_log2) {
  using C = Cfg<D>;
  constexpr int BQ = C::BQ;
  constexpr int BK = C::BK;
  constexpr int LD = C::LD;
  constexpr int NT = BK / 8;     // n tiles of S per warp
  constexpr int DT = D / 8;      // n tiles of O per warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // BQ x LD
  bf16* k_s = q_s + BQ * LD;                      // 2 x BK x LD
  bf16* v_s = k_s + 2 * BK * LD;                  // 2 x BK x LD

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // longest rows first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / group;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // the kv tiles some row of this q tile may attend to
  const int q_last = min(q0 + BQ, Sq) - 1;
  const int kv_end = causal ? min(Skv, q_last + 1) : Skv;
  const int kv_begin = window ? max(0, q0 - window + 1) : 0;
  const int t_lo = kv_begin / BK;
  const int t_hi = (kv_end + BK - 1) / BK;

  const bf16* kb = k + b * ks.b + hk * ks.h;
  const bf16* vb = v + b * vs.b + hk * vs.h;
  load_tile<D, BQ>(q_s, q + b * qs.b + (long long)q0 * qs.s + h * qs.h,
                   qs.s, Sq - q0, hd, tid);
  if (t_lo < t_hi) {
    const int k0 = t_lo * BK;
    load_tile<D, BK>(k_s, kb + (long long)k0 * ks.s, ks.s, Skv - k0, hd, tid);
    load_tile<D, BK>(v_s, vb + (long long)k0 * vs.s, vs.s, Skv - k0, hd, tid);
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  // this warp's 16 q rows as A fragments: rows lane % 16, dims
  // + 8 * (lane / 16)
  const bf16* q_w = q_s + (warp * 16 + (lane & 15)) * LD + (lane >> 4) * 8;
  uint32_t qf[C::kQInRegs ? D / 16 : 1][4];
  if constexpr (C::kQInRegs) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) ldmatrix_x4(qf[kk], q_w + kk * 16);
  }

  float acc[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.0f;
  float m_r[2] = {kMasked, kMasked};  // rows lane / 4 and lane / 4 + 8
  float l_r[2] = {0.0f, 0.0f};        // this thread's share of the row sums
  const int row0 = q0 + warp * 16 + (lane >> 2);

  for (int t = t_lo; t < t_hi; ++t) {
    const int stage = (t - t_lo) & 1;
    if (t + 1 < t_hi) {  // the next tile loads while this one is computed
      const int k1 = (t + 1) * BK;
      load_tile<D, BK>(k_s + (stage ^ 1) * BK * LD,
                       kb + (long long)k1 * ks.s, ks.s, Skv - k1, hd, tid);
      load_tile<D, BK>(v_s + (stage ^ 1) * BK * LD,
                       vb + (long long)k1 * vs.s, vs.s, Skv - k1, hd, tid);
      cp_async_commit();
    }
    const bf16* k_t = k_s + stage * BK * LD;
    const bf16* v_t = v_s + stage * BK * LD;

    // S = Q K^T; K fragments: keys (lane / 16) * 8 + lane % 8 of a pair
    // of n tiles, dims + 8 * ((lane / 8) % 2)
    float s[NT][4];
#pragma unroll
    for (int i = 0; i < NT; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.0f;
    const bf16* k_w = k_t + ((lane >> 4) * 8 + (lane & 7)) * LD
                      + ((lane >> 3) & 1) * 8;
#pragma unroll(C::kKUnroll)
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      if constexpr (C::kQInRegs) {
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = qf[kk][i];
      } else {
        ldmatrix_x4(a, q_w + kk * 16);
      }
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bk[4];
        ldmatrix_x4(bk, k_w + np * 16 * LD + kk * 16);
        mma_bf16(s[2 * np], a, bk[0], bk[1]);
        mma_bf16(s[2 * np + 1], a, bk[2], bk[3]);
      }
    }

    // scale in f32 (log2 units), then the masks where the tile needs them
    const int k0 = t * BK;
    const bool need_mask = k0 + BK > Skv || (causal && k0 + BK - 1 > q0) ||
                           (window && q_last - k0 >= window);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt][e] * scale_log2;
        if (need_mask) {
          const int j = k0 + nt * 8 + 2 * (lane & 3) + (e & 1);
          const int qi = row0 + (e >> 1) * 8;
          if (j >= Skv) {
            x = -INFINITY;  // past Skv: no such key
          } else {
            bool ok = !causal || j <= qi;
            if (window) ok = ok && (qi - j < window);
            if (!ok) x = kMasked;
          }
        }
        s[nt][e] = x;
      }
    }

    // online softmax on the fragments: a row lives in a quad of lanes
    float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      mx[0] = fmaxf(mx[0], fmaxf(s[nt][0], s[nt][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[nt][2], s[nt][3]));
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float corr = exp2f(m_r[r] - mx[r]);
      m_r[r] = mx[r];
      l_r[r] *= corr;
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        acc[dt][2 * r] *= corr;
        acc[dt][2 * r + 1] *= corr;
      }
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[nt][e] - m_r[e >> 1]);
        l_r[e >> 1] += p;
        s[nt][e] = p;
      }
    }

    // O += P V: P's C fragments are the A fragments of P V; V fragments
    // by ldmatrix.trans: keys lane % 16, dims + 8 * (lane / 16)
    const bf16* v_w = v_t + (lane & 15) * LD + (lane >> 4) * 8;
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      const uint32_t a[4] = {pack_bf16(s[2 * j][0], s[2 * j][1]),
                             pack_bf16(s[2 * j][2], s[2 * j][3]),
                             pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                             pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, v_w + j * 16 * LD + dp * 16);
        mma_bf16(acc[2 * dp], a, bv[0], bv[1]);
        mma_bf16(acc[2 * dp + 1], a, bv[2], bv[3]);
      }
    }

    if (t + 1 < t_hi) cp_async_wait_all();
    __syncthreads();  // tile t + 1 has landed; stage t is free again
  }

  // epilogue: o = acc / l, through this warp's rows of q_s
  float den[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_r[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    den[r] = (l == 0.0f) ? 1.0f : l;
    // the row's log-sum-exp of the log2-scaled scores, for the backward
    const int qi = row0 + r * 8;
    if (lse != nullptr && (lane & 3) == 0 && qi < Sq)
      lse[((long long)b * gridDim.y + h) * Sq + qi] =
          l > 0.0f ? m_r[r] + log2f(l) : m_r[r];
  }
  bf16* o_w = q_s + warp * 16 * LD;
  const int g = lane >> 2;
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    const int c = dt * 8 + 2 * (lane & 3);
    *reinterpret_cast<uint32_t*>(o_w + g * LD + c) =
        pack_bf16(acc[dt][0] / den[0], acc[dt][1] / den[0]);
    *reinterpret_cast<uint32_t*>(o_w + (g + 8) * LD + c) =
        pack_bf16(acc[dt][2] / den[1], acc[dt][3] / den[1]);
  }
  __syncwarp();
#pragma unroll
  for (int e = lane; e < 16 * (D / 8); e += 32) {
    const int r = e / (D / 8);
    const int c = (e % (D / 8)) * 8;
    const int qi = q0 + warp * 16 + r;
    if (qi < Sq && c < hd)
      *reinterpret_cast<uint4*>(o + b * os.b + (long long)qi * os.s
                                + h * os.h + c) =
          *reinterpret_cast<const uint4*>(o_w + r * LD + c);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           Strides qs, Strides ks, Strides vs, Strides os, int B, int Sq,
           int Skv, int Hq, int Hkv, int hd, int causal, int window,
           cudaStream_t stream) {
  using C = Cfg<D>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel_tc<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + C::BQ - 1) / C::BQ, Hq, B);
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)hd);
  flash_attention_kernel_tc<D><<<grid, C::kThreads, C::kSmem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, qs, ks, vs, os,
      Sq, Skv, hd, Hq / Hkv, causal, window, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

namespace f32 {

constexpr int kBQ = 64;           // q rows per block
constexpr int kBK = 64;           // kv rows per shared-memory tile
constexpr int kChunk = 16;        // kv rows per online-softmax update
constexpr int kSlice = 32;        // head dims held by one thread

template <int MAXD>
__global__ void __launch_bounds__(kBQ * (MAXD / kSlice))
flash_attention_kernel_f32(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ o,
                           float* __restrict__ lse, Strides qs, Strides ks,
                           Strides vs, Strides os, int Sq, int Skv, int hd,
                           int group, int causal, int window, float scale) {
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
  const float* qp = q + b * qs.b + (long long)(live ? qi : 0) * qs.s + h * qs.h;
#pragma unroll
  for (int i = 0; i < kSlice; ++i) {
    const int d = i * TPR + sl;
    qr[i] = (live && d < hd) ? qp[d] * scale : 0.0f;
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

  const float* kb = k + b * ks.b + hk * ks.h;
  const float* vb = v + b * vs.b + hk * vs.h;
  for (int t = t_lo; t < t_hi; ++t) {
    const int k0 = t * kBK;
    const int n_here = min(kBK, Skv - k0);
    __syncthreads();                      // the previous tile is consumed
    for (int e = tid; e < kBK * MAXD; e += NT) {
      const int j = e / MAXD;
      const int d = e % MAXD;
      const bool in = j < n_here && d < hd;
      k_s[e] = in ? kb[(long long)(k0 + j) * ks.s + d] : 0.0f;
      v_s[e] = in ? vb[(long long)(k0 + j) * vs.s + d] : 0.0f;
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

  if (live && lse != nullptr && sl == 0)  // in log2 units, as the bf16 kernel
    lse[((long long)b * gridDim.y + h) * Sq + qi] =
        (l > 0.0f ? m + logf(l) : m) * kLog2e;
  if (live) {
    const float den = (l == 0.0f) ? 1.0f : l;
    float* op = o + b * os.b + (long long)qi * os.s + h * os.h;
#pragma unroll
    for (int i = 0; i < kSlice; ++i) {
      const int d = i * TPR + sl;
      if (d < hd) op[d] = acc[i] / den;
    }
  }
}

template <int MAXD>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           Strides qs, Strides ks, Strides vs, Strides os, int B, int Sq,
           int Skv, int Hq, int Hkv, int hd, int causal, int window,
           cudaStream_t stream) {
  constexpr int threads = kBQ * (MAXD / kSlice);
  const size_t smem = 2 * (size_t)kBK * MAXD * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel_f32<MAXD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + kBQ - 1) / kBQ, Hq, B);
  flash_attention_kernel_f32<MAXD><<<grid, threads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, qs, ks, vs,
      os, Sq, Skv, hd, Hq / Hkv, causal, window, 1.0f / sqrtf((float)hd));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace f32

// the 64-, 128- or 256-wide instance of one dtype's kernel
#define FLASH_DISPATCH(NS)                                                   \
  (hd <= 64 ? NS::launch<64>(q, k, v, o, lse, qs, ks, vs, os, B, Sq, Skv,   \
                             Hq, Hkv, hd, causal, window, st)                \
   : hd <= 128 ? NS::launch<128>(q, k, v, o, lse, qs, ks, vs, os, B, Sq,     \
                                 Skv, Hq, Hkv, hd, causal, window, st)       \
               : NS::launch<256>(q, k, v, o, lse, qs, ks, vs, os, B, Sq,     \
                                 Skv, Hq, Hkv, hd, causal, window, st))

}  // namespace

extern "C" {

// Launches on `stream`; returns a cudaError_t (0 = ok). q (B,Sq,Hq,hd),
// k and v (B,Skv,Hkv,hd) and o (B,Sq,Hq,hd) are device pointers with the
// given element strides for the batch, sequence and head dims and a
// contiguous head dim. dtype: 0 = float32, 1 = bfloat16. hd must be a
// multiple of 8 up to 256, and Hq a multiple of Hkv. For bfloat16 every
// base pointer must be 16-byte aligned and every stride a multiple of 8.
// lse, when not null, receives each row's log-sum-exp of the scores times
// log2(e) / sqrt(hd) (base 2), float32 (B,Hq,Sq) contiguous: what the
// backward recomputes P from. Null at inference: nothing more is written.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, float* lse, long long qsb, long long qss,
                           long long qsh, long long ksb, long long kss,
                           long long ksh, long long vsb, long long vss,
                           long long vsh, long long osb, long long oss,
                           long long osh, int B, int Sq, int Skv, int Hq,
                           int Hkv, int hd, int causal, int window,
                           int dtype, void* stream) {
  if (hd <= 0 || hd > 256 || hd % 8 || Hkv <= 0 || Hq % Hkv || B > 65535 ||
      Hq > 65535 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1) {
    const long long strides[] = {qsb, qss, qsh, ksb, kss, ksh,
                                 vsb, vss, vsh, osb, oss, osh};
    for (long long s : strides)
      if (s % 8) return static_cast<int>(cudaErrorMisalignedAddress);
    for (const void* p : {q, k, v, static_cast<const void*>(o)})
      if (reinterpret_cast<uintptr_t>(p) % 16)
        return static_cast<int>(cudaErrorMisalignedAddress);
  }
  if (B <= 0 || Sq <= 0 || Hq <= 0) return 0;
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh},
      os{osb, oss, osh};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return FLASH_DISPATCH(f32);
  return FLASH_DISPATCH(tc);
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
