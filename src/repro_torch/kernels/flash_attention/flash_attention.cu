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
// float32: the same FlashAttention-2 on the tensor cores, in float32
// accuracy ("3xTF32"). One TF32 product keeps 11 significant bits: at
// S 512, hd 128 it puts the output 4.3e-4 of its largest magnitude off
// (ref.py's emulation), 20 times the float32 bar (ATTN_ATOL, 2e-5). So
// each float32 operand x is split in registers into hi = tf32(x) and lo
// = tf32(x - hi) (cvt.rna.tf32.f32: nearest, ties away from zero; x - hi
// - lo is within 2^-22 of |x|), and each product a b is formed on
// mma.sync.m16n8k8 (TF32 in, f32 accumulate) as lo_a hi_b + hi_a lo_b +
// hi_a hi_b, the two small terms into the accumulator first; lo_a lo_b
// is dropped. A TF32 x TF32 product is exact in f32, so the result
// differs from float32 products only by that term and the order of the
// sums: 3e-7 to 6e-7 of the output's largest magnitude in the emulation
// at S 512, hd 128, as plain float32 (3.3e-7); on an H100 the kernel
// stays within 4e-6 of the plain float32 version at phase 8's shapes,
// as does the emulation (chip_smoke.py phase 2). Three products a
// product at TF32's 495 TFLOP/s still beat the f32 CUDA cores' 67.
//   The m16n8k8 TF32 fragments are single 32-bit reads. A: rows g and g
// + 8, dims t and t + 4 of a k step (g = lane / 4, t = lane % 4); K's B
// fragment: key g, dims t and t + 4; S's accumulator (row g, keys 2t and
// 2t + 1) is P V's A fragment with the k columns taken in that order,
// so V's B fragment is keys 2t and 2t + 1, dim g. Rows are padded by 4
// floats: the bank of (row, col) is 4 row + col mod 32, distinct over
// the 8 x 4 (g, t) of either read. Q is split once into registers at hd
// 64; at hd 128 and 256 it is read from shared memory and split at each
// k step (its two parts in registers spill at hd 128). P is split in
// registers and never goes to shared memory; K and V are split at each
// use. Products are issued term by term across the n tiles that share an
// A fragment (every lo hi, then every hi lo, then every hi hi), so that
// independent products lie between the three that feed one accumulator.
//   Blocks of 8 warps: each 16-row group of the 64-row q tile has two
// warps, which take one half of every key tile each with an online
// softmax of their own; at the end the second puts its max, row-sum
// shares and accumulators in shared memory and the first rescales both
// to the larger max and adds. One block an SM (the accumulators take
// 163-230 registers a thread); the longest causal q tiles, which set the
// time at S 512, run with twice the warps a block of 4 would give them.
// Key tiles of 64 at hd <= 128 (169 KB of shared memory at hd 128), 32
// at hd 256. Tried on an H100 80GB HBM3 at 700 W (tools/flash_f32_tiles.py,
// us cold at phase 8's TP rank, B 4 x S 512, 6/1 heads, hd 128):
//   8 warps, 64-key tiles, Q read from shared memory (the source) 95.5
//   Q's split parts in registers (255 registers, 60 bytes spilled)  97.2
//   k steps of S unrolled 2 at a time, not 4                       96.2
//   n tiles of P V issued term by term in 2s or 8s, not 4s   95.7, 96.0
//   8 warps, 32-key tiles                                          113.0
//   4 warps, one a row group, 32-key tiles, 2 blocks an SM         119.6
//   4 warps, 16-key tiles, 3 blocks an SM                          136.6
// (SDPA's float32 call 233.7, the plain version 207.3). At
// Qwen1.5-MoE-A2.7B's rank (B 2 x S 512, 8/8) the source takes 65.1
// against SDPA's 51.9: 128 blocks, one wave, each long q tile's eight
// key tiles in one block.
// The dtype picks the kernel; there is no fallback between them.
//
// Ragged Sq and Skv are masked in both kernels: nothing is padded or
// copied. Strides are taken for the batch, sequence and head dims; the
// head dim must be contiguous. The 16-byte copies of both need
// 16-byte-aligned base pointers and strides in 16-byte steps (8 bf16 or
// 4 float32 elements; the wrapper checks).
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
// float32: tensor cores, 3xTF32
// ---------------------------------------------------------------------------

namespace f32 {

// 64 q rows per block, 16 a warp, as the bf16 kernel, and each key tile
// split between kSplit warps of a row group: kSplit x 4 warps, each with
// its own online softmax over its keys, merged at the end. K/V tiles of
// BK keys; the header lists what was measured.
template <int D>
struct Cfg {
  static constexpr int kSplit = 2;                 // 1 or 2
  static constexpr int kThreads = 128 * kSplit;
  static constexpr int BQ = 64;
  static constexpr int BK = D >= 256 ? 32 : 64;
  static constexpr int LD = D + 4;               // padded smem row, floats
  static constexpr bool kQInRegs = D <= 64;      // Q's hi and lo parts
  // k steps of S = Q K^T unrolled at once where Q is read from shared
  // memory
  static constexpr int kKUnroll = kQInRegs ? D / 8 : 4;
  // n tiles of O whose products P V issues term by term (mma3_tiles)
  static constexpr int kGroup = 4;
  // Q, then two stages of K, then two of V
  static constexpr size_t kSmem = (size_t)(BQ + 4 * BK) * LD * sizeof(float);
};

// x rounded to TF32 (10 mantissa bits), nearest with ties away from
// zero, in the f32 layout the tensor cores read
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo + O(2^-22 |x|), hi and lo both TF32
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// c += a . b on the tensor cores: a 16x8 (row), b 8x8 (col), TF32 in,
// f32 accumulate
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c[n] += a . b[n] for N n tiles that share one A fragment, in float32
// accuracy from the operands' TF32 parts (3xTF32: the two small terms,
// lo hi and hi lo, accumulated before hi hi), issued term by term
// across the tiles: a tile's next product waits on its last, so N
// independent products lie between them
template <int N>
__device__ __forceinline__ void mma3_tiles(float (*c)[4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           const uint32_t (&bh)[N][2],
                                           const uint32_t (&bl)[N][2]) {
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(c[n], al, bh[n][0], bh[n][1]);
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(c[n], ah, bl[n][0], bl[n][1]);
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(c[n], ah, bh[n][0], bh[n][1]);
}

// the A fragment of one k step, split: rows g and g + 8, dims t and t + 4
// of a row-major tile, `p` the lane's address of (row g, dim t)
template <int LD>
__device__ __forceinline__ void load_a(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                       const float* p) {
  split(p[0], hi[0], lo[0]);
  split(p[8 * LD], hi[1], lo[1]);
  split(p[4], hi[2], lo[2]);
  split(p[8 * LD + 4], hi[3], lo[3]);
}

// the A fragment of k step j of a product whose A is the accumulator c
// (16 x 8 NP), split. A column t of the step is c's column 2t and column
// t + 4 its 2t + 1, so the B operand's rows are taken in that order too.
template <int NP>
__device__ __forceinline__ void c_to_a(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                       const float (&c)[NP][4], int j) {
  split(c[j][0], hi[0], lo[0]);
  split(c[j][2], hi[1], lo[1]);
  split(c[j][1], hi[2], lo[2]);
  split(c[j][3], hi[3], lo[3]);
}

// rows [0, n_rows) x dims [0, hd) of an R-row tile into shared memory,
// the rest zero; 16 bytes per copy
template <int D, int R>
__device__ __forceinline__ void load_tile(float* s, const float* g,
                                          long long row_stride, int n_rows,
                                          int hd, int tid) {
  constexpr int kChunks = D / 4;
  constexpr int kThreads = Cfg<D>::kThreads;
#pragma unroll
  for (int e = tid; e < R * kChunks; e += kThreads) {
    const int r = e / kChunks;
    const int c = (e % kChunks) * 4;
    const bool in = r < n_rows && c < hd;
    tc::cp_async16(s + r * Cfg<D>::LD + c, in ? g + r * row_stride + c : g,
                   in);
  }
}

template <int D>
__global__ void __launch_bounds__(Cfg<D>::kThreads, 1)
flash_attention_kernel_f32(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ o,
                           float* __restrict__ lse, Strides qs, Strides ks,
                           Strides vs, Strides os, int Sq, int Skv, int hd,
                           int group, int causal, int window,
                           float scale_log2) {
  using C = Cfg<D>;
  constexpr int BQ = C::BQ;
  constexpr int BK = C::BK;
  constexpr int LD = C::LD;
  constexpr int KW = BK / C::kSplit;  // keys of a tile a warp takes
  constexpr int NT = KW / 8;     // n tiles of S per warp, k steps of P V
  constexpr int DT = D / 8;      // n tiles of O per warp, k steps of Q K^T
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* q_s = reinterpret_cast<float*>(smem_raw);  // BQ x LD
  float* k_s = q_s + BQ * LD;                       // 2 x BK x LD
  float* v_s = k_s + 2 * BK * LD;                   // 2 x BK x LD

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // longest rows first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / group;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = (tid >> 5) & 3;   // the warp's 16 q rows
  const int kh = tid >> 7;           // and its part of each key tile
  const int g = lane >> 2;       // the fragments' row (or key) group
  const int t4 = lane & 3;       // and the thread's place in it

  // the kv tiles some row of this q tile may attend to
  const int q_last = min(q0 + BQ, Sq) - 1;
  const int kv_end = causal ? min(Skv, q_last + 1) : Skv;
  const int kv_begin = window ? max(0, q0 - window + 1) : 0;
  const int t_lo = kv_begin / BK;
  const int t_hi = (kv_end + BK - 1) / BK;

  const float* kb = k + b * ks.b + hk * ks.h;
  const float* vb = v + b * vs.b + hk * vs.h;
  load_tile<D, BQ>(q_s, q + b * qs.b + (long long)q0 * qs.s + h * qs.h,
                   qs.s, Sq - q0, hd, tid);
  if (t_lo < t_hi) {
    const int k0 = t_lo * BK;
    load_tile<D, BK>(k_s, kb + (long long)k0 * ks.s, ks.s, Skv - k0, hd, tid);
    load_tile<D, BK>(v_s, vb + (long long)k0 * vs.s, vs.s, Skv - k0, hd, tid);
  }
  tc::cp_async_commit();
  tc::cp_async_wait_all();
  __syncthreads();

  // this warp's 16 q rows as A fragments, split once where they fit in
  // registers
  const float* q_w = q_s + (warp * 16 + g) * LD + t4;
  uint32_t qh[C::kQInRegs ? DT : 1][4], ql[C::kQInRegs ? DT : 1][4];
  if constexpr (C::kQInRegs) {
#pragma unroll
    for (int kk = 0; kk < DT; ++kk) load_a<LD>(qh[kk], ql[kk], q_w + kk * 8);
  }

  float acc[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.0f;
  float m_r[2] = {kMasked, kMasked};  // rows g and g + 8
  float l_r[2] = {0.0f, 0.0f};        // this thread's share of the row sums
  const int row0 = q0 + warp * 16 + g;

  for (int t = t_lo; t < t_hi; ++t) {
    const int stage = (t - t_lo) & 1;
    if (t + 1 < t_hi) {  // the next tile loads while this one is computed
      const int k1 = (t + 1) * BK;
      load_tile<D, BK>(k_s + (stage ^ 1) * BK * LD,
                       kb + (long long)k1 * ks.s, ks.s, Skv - k1, hd, tid);
      load_tile<D, BK>(v_s + (stage ^ 1) * BK * LD,
                       vb + (long long)k1 * vs.s, vs.s, Skv - k1, hd, tid);
      tc::cp_async_commit();
    }
    // this warp's KW keys of the tile
    const float* k_t = k_s + stage * BK * LD + kh * KW * LD;
    const float* v_t = v_s + stage * BK * LD + kh * KW * LD;

    // S = Q K^T; the B fragment of n tile nt at k step kk is key
    // nt * 8 + g, dims kk * 8 + t and + 4
    float s[NT][4];
#pragma unroll
    for (int i = 0; i < NT; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.0f;
    const float* k_w = k_t + g * LD + t4;
#pragma unroll(C::kKUnroll)
    for (int kk = 0; kk < DT; ++kk) {
      uint32_t ah[4], al[4];
      if constexpr (C::kQInRegs) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          ah[i] = qh[kk][i];
          al[i] = ql[kk][i];
        }
      } else {
        load_a<LD>(ah, al, q_w + kk * 8);
      }
      uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        split(k_w[nt * 8 * LD + kk * 8], bh[nt][0], bl[nt][0]);
        split(k_w[nt * 8 * LD + kk * 8 + 4], bh[nt][1], bl[nt][1]);
      }
      mma3_tiles<NT>(s, ah, al, bh, bl);
    }

    // scale in f32 (log2 units), then the masks where the tile needs them
    const int k0 = t * BK;
    const int kw0 = k0 + kh * KW;
    const bool need_mask = k0 + BK > Skv || (causal && k0 + BK - 1 > q0) ||
                           (window && q_last - k0 >= window);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt][e] * scale_log2;
        if (need_mask) {
          const int j = kw0 + nt * 8 + 2 * t4 + (e & 1);
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

    // O += P V: P split in registers (c_to_a); the B fragment of k step j,
    // n tile dt is keys j * 8 + 2t and + 1, dim dt * 8 + g; n tiles in
    // groups of kGroup issued term by term
    const float* v_w = v_t + 2 * t4 * LD + g;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      uint32_t ah[4], al[4];
      c_to_a<NT>(ah, al, s, j);
#pragma unroll
      for (int d0 = 0; d0 < DT; d0 += C::kGroup) {
        uint32_t bh[C::kGroup][2], bl[C::kGroup][2];
#pragma unroll
        for (int n = 0; n < C::kGroup; ++n) {
          split(v_w[j * 8 * LD + (d0 + n) * 8], bh[n][0], bl[n][0]);
          split(v_w[(j * 8 + 1) * LD + (d0 + n) * 8], bh[n][1], bl[n][1]);
        }
        mma3_tiles<C::kGroup>(acc + d0, ah, al, bh, bl);
      }
    }

    if (t + 1 < t_hi) tc::cp_async_wait_all();
    __syncthreads();  // tile t + 1 has landed; stage t is free again
  }

  // the split's parts merged (kSplit 2): the second warp of each row
  // group puts its max, row-sum shares and accumulators in shared memory
  // (the ring is free), element by element across the lanes; the first
  // rescales both to the larger max and adds
  if constexpr (C::kSplit == 2) {
    float* x_s = k_s + warp * (DT * 4 + 4) * 32 + lane;
    if (kh == 1) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        x_s[(DT * 4 + r) * 32] = m_r[r];
        x_s[(DT * 4 + 2 + r) * 32] = l_r[r];
      }
#pragma unroll
      for (int dt = 0; dt < DT; ++dt)
#pragma unroll
        for (int e = 0; e < 4; ++e) x_s[(dt * 4 + e) * 32] = acc[dt][e];
    }
    __syncthreads();
    if (kh == 1) return;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m1 = x_s[(DT * 4 + r) * 32];
      const float m = fmaxf(m_r[r], m1);
      const float a0 = exp2f(m_r[r] - m), a1 = exp2f(m1 - m);
      m_r[r] = m;
      l_r[r] = l_r[r] * a0 + x_s[(DT * 4 + 2 + r) * 32] * a1;
#pragma unroll
      for (int dt = 0; dt < DT; ++dt)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e)
          acc[dt][e] = acc[dt][e] * a0 + x_s[(dt * 4 + e) * 32] * a1;
    }
  }

  // epilogue: o = acc / l, 8 bytes a store
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_r[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float den = (l == 0.0f) ? 1.0f : l;
    const int qi = row0 + r * 8;
    if (qi >= Sq) continue;
    // the row's log-sum-exp of the log2-scaled scores, for the backward
    if (lse != nullptr && t4 == 0)
      lse[((long long)b * gridDim.y + h) * Sq + qi] =
          l > 0.0f ? m_r[r] + log2f(l) : m_r[r];
    float* op = o + b * os.b + (long long)qi * os.s + h * os.h;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      const int c = dt * 8 + 2 * t4;
      if (c < hd)
        *reinterpret_cast<float2*>(op + c) =
            make_float2(acc[dt][2 * r] / den, acc[dt][2 * r + 1] / den);
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           Strides qs, Strides ks, Strides vs, Strides os, int B, int Sq,
           int Skv, int Hq, int Hkv, int hd, int causal, int window,
           cudaStream_t stream) {
  using C = Cfg<D>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel_f32<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + C::BQ - 1) / C::BQ, Hq, B);
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)hd);
  flash_attention_kernel_f32<D><<<grid, C::kThreads, C::kSmem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, qs, ks, vs,
      os, Sq, Skv, hd, Hq / Hkv, causal, window, scale_log2);
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

// an instance's dynamic shared memory and the blocks of it that fit an
// SM (the CUDA occupancy calculator, from its registers and that memory)
template <typename C, typename K>
int plan(K kernel, int* smem, int* blocks) {
  const void* fn = reinterpret_cast<const void*>(kernel);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::kSmem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, fn, C::kThreads, C::kSmem);
  *smem = (int)C::kSmem;
  return static_cast<int>(err);
}

// ... of the width-D instance in dtype (0 = float32, 1 = bfloat16)
template <int D>
int plan_of(int dtype, int* smem, int* blocks) {
  if (dtype == 0)
    return plan<f32::Cfg<D>>(f32::flash_attention_kernel_f32<D>, smem,
                             blocks);
  return plan<tc::Cfg<D>>(tc::flash_attention_kernel_tc<D>, smem, blocks);
}

}  // namespace

extern "C" {

// Launches on `stream`; returns a cudaError_t (0 = ok). q (B,Sq,Hq,hd),
// k and v (B,Skv,Hkv,hd) and o (B,Sq,Hq,hd) are device pointers with the
// given element strides for the batch, sequence and head dims and a
// contiguous head dim. dtype: 0 = float32, 1 = bfloat16. hd must be a
// multiple of 8 up to 256, and Hq a multiple of Hkv. Every base pointer
// must be 16-byte aligned and every stride a multiple of 16 bytes (8
// bfloat16 or 4 float32 elements).
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
  const long long strides[] = {qsb, qss, qsh, ksb, kss, ksh,
                               vsb, vss, vsh, osb, oss, osh};
  for (long long s : strides)  // the 16-byte copies
    if (s % (dtype == 1 ? 8 : 4))
      return static_cast<int>(cudaErrorMisalignedAddress);
  for (const void* p : {q, k, v, static_cast<const void*>(o)})
    if (reinterpret_cast<uintptr_t>(p) % 16)
      return static_cast<int>(cudaErrorMisalignedAddress);
  if (B <= 0 || Sq <= 0 || Hq <= 0) return 0;
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh},
      os{osb, oss, osh};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return FLASH_DISPATCH(f32);
  return FLASH_DISPATCH(tc);
}

// The launch plan of the instance that runs head dim hd in dtype (0 =
// float32, 1 = bfloat16): its dynamic shared memory in bytes and the
// blocks that fit an SM with its registers and that memory (the CUDA
// occupancy calculator). Returns a cudaError_t.
int flash_attention_occupancy(int hd, int dtype, int* smem, int* blocks) {
  if (hd <= 0 || hd > 256 || hd % 8 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  return hd <= 64    ? plan_of<64>(dtype, smem, blocks)
         : hd <= 128 ? plan_of<128>(dtype, smem, blocks)
                     : plan_of<256>(dtype, smem, blocks);
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
