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
// Each output element is summed by one block in a fixed order (no two
// blocks add into one address), so a call gives the same bits every time
// (a resumed training run equals an uninterrupted one). The kernels run
// on one stream, in this order:
//   1. D = rowsum(do * o) in float32 (8 threads a row, 16-byte loads);
//   2. dq: one block per (q tile, q head, batch row) walks the key tiles
//      the mask allows;
//   3. dk, dv per q head: one block per (key tile, q head, batch row)
//      walks the q tiles that attend to its keys and writes its head's
//      float32 partial into scratch (B,Skv,Hq,hd);
//   4. the partials of a kv head's group summed in the order g = 0..G-1
//      and cast to the output's dtype.
// 2 and 3 run as one launch (three CUDA kernels a call). Splitting the
// group's heads over blocks (3) and
// summing them in a fixed order (4) keeps Hq blocks a key tile in flight
// where a block per kv head would have only Hkv: at Qwen2-1.5B's training
// shape (B 2 x S 512, Hq 12, Hkv 2) 192 dk/dv blocks instead of 32 on 132
// SMs, for 12.6 MB of float32 partials written and read again, most of it
// from the L2.
//
// bfloat16: FlashAttention-2's backward on the tensor cores
// (mma.sync.m16n8k16, bf16 in, f32 accumulate), built from the forward's
// pieces (flash_attention.cu): 16-byte cp.async copies into rows padded
// by 16 bytes, a two-stage ring, ldmatrix and ldmatrix.trans, and
// accumulator fragments repacked in registers as the A fragments of the
// next product. Blocks of 4 warps, 16 rows a warp.
//   dk/dv (3) works key-major, so that P^T and dS^T are born in the
//   layout of an A operand. A block owns 64 keys. K and V stay in shared
//   memory and are read with ldmatrix at every step: the 16 x hd f32
//   accumulators of dK and dV take 128 registers a thread at hd 128, so
//   K and V cannot also sit in registers. Q, dO and the rows' L and D
//   stream through the ring in tiles of BQ rows. Per q tile: S^T = K Q^T,
//   P^T = exp2(S^T scale log2(e) - L), dP^T = V dO^T, dS^T = P^T (dP^T -
//   D), dV += P^T dO and dK += dS^T Q, Q and dO read by ldmatrix for the
//   first two products and by ldmatrix.trans for the last two. At hd 256
//   one warp's dK and dV would need 256 accumulators a thread, so a key
//   tile has two blocks: a dV block (S^T, P^T, dV) and a dK block (S^T,
//   dP^T, dK), 128 accumulators each.
//   dq (2) owns 64 q rows. Q and dO load once (A fragments in registers
//   up to hd 128, read from shared memory at hd 256), K and V stream
//   through the ring in tiles of BK keys, and tiles wholly masked are
//   never loaded. Per key tile: S = Q K^T, dP = dO V^T, dS, and dQ += dS
//   K with K read by ldmatrix.trans. Recomputing S and dP there costs 14
//   hd operations a pair in all (16 at hd 256) against the function's 10:
//   the price of that fixed order: dk/dv blocks cannot also add into dq.
//   P and dS are rounded to bf16 before their products (P^T for dV, dS for
//   dq and dk): the roundings the plain version does not have. Every sum
//   is f32. Masks are applied only on tiles that cross the diagonal, the
//   window edge, Sq or Skv. The scale 1/sqrt(hd) multiplies dq and dk
//   once, in f32, at the end. Any hd that is a multiple of 8 runs in the
//   64-, 128- or 256-wide instance, zero-padded on load. The 16-byte
//   copies need 16-byte-aligned base pointers and batch, sequence and
//   head strides that are multiples of 8 elements (the wrapper checks,
//   and the launch refuses what is not).
//
// float32: the same design on the tensor cores in float32 accuracy
// (3xTF32), as the forward's float32 kernel (flash_attention.cu): each
// operand split in registers into hi = tf32(x) and lo = tf32(x - hi),
// each product formed on mma.sync.m16n8k8 as lo_a hi_b + hi_a lo_b +
// hi_a hi_b, the two small terms first, every sum f32. One TF32 product
// alone puts the gradients 3e-4 to 9e-4 of their largest magnitudes off
// (ref.py's emulation), over the float32 bar of 1e-5; the split gives
// 4e-7 to 1.1e-6, as plain float32 does. The m16n8k8 TF32 fragments are
// single 32-bit reads from rows padded by 4 floats (bank 4 row + col,
// distinct over a fragment's 8 x 4): the A operands (K and V in dk/dv,
// Q and dO in dq) at rows g and g + 8, dims t and t + 4; the B operands
// of S^T and dP^T (Q, dO) and of S and dP (K, V) at row g, dims t and t +
// 4; the accumulators P^T, dS^T and dS serve as A fragments with their k
// columns taken in the order 2t, 2t + 1, so the B operands of dV += P^T
// dO, dK += dS^T Q and dQ += dS K are read at rows 2t and 2t + 1, dim g.
// S^T and dP^T (S and dP) are computed in one pass over hd, and every
// product is issued term by term across the n tiles that share an A
// fragment, so that independent products lie between the three that
// feed one accumulator. Blocks of 8 warps up to hd 128: each 16-row
// group has two warps, which take one half of each step's q rows (dk/dv)
// or keys (dq) with partial sums of their own, added at the end in a
// fixed order (the second's through shared memory into the first's), so
// a call still gives the same bits every time. Steps of 32 q rows or
// keys (16 a warp) up to hd 128, one block an SM (255 registers a
// thread, no spill); at hd 256 blocks of 4 warps and steps of 16, with
// a dV and a dK block a key tile as in bf16. Tried on an H100 80GB HBM3
// at 700 W (tools/flash_f32_tiles.py, us cold at Qwen2-1.5B's training
// shape in float32, B 2 x S 512, 12/2 heads, hd 128):
//   8 warps, steps of 32 split in two, k steps unrolled 2 (source) 224.0
//   k steps unrolled 4                                             226.0
//   n tiles issued term by term in 2s or 8s, not 4s         225.4, 226.2
//   4 warps, steps of 16, 2 blocks an SM                           236.4
// (SDPA's float32 backward 276.0, the plain backward 687.8). At
// Qwen1.5-MoE-A2.7B's rank (B 2 x S 512, 8/8) the split takes 161.0
// against 225.0 with 4 warps; at RecurrentGemma-2B's local layer (hd
// 256, 10/1, B 2 x S 512) 518.4 against SDPA's 404.2.
// The dtype picks the kernels; there is no fallback between them.
//
// What bounds it on an H100 (80GB HBM3, 700 W): at Qwen2-1.5B's training
// shape (B 2 x S 512, Hq 12, Hkv 2, hd 128, causal, bf16) the 3,151,872
// allowed (q, k) pairs need 10 hd operations each, 4.03 GFLOP, 4.08 us
// at the tensor-core rate, and q, k, v, o and do read plus dq, dk and dv
// written move 14.7 MB, 4.39 us at 3.35 TB/s: the bytes bound it. The
// kernels take 55 us cold, 1.2 times PyTorch's SDPA backward. Neither
// bound holds them back: 384 blocks of 2 to 16 steps, two an SM (246
// registers a thread), each step a chain of ldmatrix reads, tensor-core
// products, exp2 and a barrier, in which each ldmatrix of a B fragment
// feeds only two mma of a 16-row warp. The latency of those chains sets
// the time. At RecurrentGemma-2B's local layer (hd 256, window 2048, S
// 4096, 10 q heads and 1 kv head) the 161 GFLOP of the function bind
// (163 us); the kernels run 258 GFLOP of mma in 1.56 ms, 17 % of the
// tensor-core rate, for the same reason.
// Tried on an H100 and lost: dq and dk/dv as two launches (84 us at the
// training shape: each kind alone leaves SMs idle at S 512); tiles of 32
// at hd 256 (1.84 ms: one block an SM); q steps of 64 in dk/dv at hd 64
// (spills). A wgmma version with TMA and a producer warp is the next
// step, as for the forward.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>

namespace {

using bf16 = __nv_bfloat16;

struct Strides {  // in elements
  long long b, s, h;
};

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

// ---------------------------------------------------------------------------
// bfloat16: tensor cores
// ---------------------------------------------------------------------------

namespace tc {

// Blocks of 4 warps, 16 rows (keys in 3, q rows in 2) a warp. BQ and BK
// are the tiles streamed through the two-stage ring: small enough that
// the S and dP fragments (BQ / 2 or BK / 2 f32 registers a thread each)
// fit beside the accumulators without spilling, and 16 at hd 256, so
// that two blocks share an SM's shared memory. On an H100 16 at hd 256
// beat 32 (1.56 against 1.84 ms at RecurrentGemma-2B's local layer).
template <int D>
struct Cfg {
  static constexpr int kThreads = 128;
  static constexpr int LD = D + 8;        // padded smem row, in bf16
  // dk/dv: 64 keys a block; q tiles of BQ rows
  static constexpr int BKV = 64;
  static constexpr int BQ = D > 128 ? 16 : 32;
  static constexpr bool kSplit = D > 128;  // a dV and a dK block a tile
  // dq: 64 q rows a block; key tiles of BK keys
  static constexpr int BQD = 64;
  static constexpr int BK = D <= 64 ? 64 : D > 128 ? 16 : 32;
  static constexpr bool kQInRegs = D <= 128;  // Q, dO as A fragments
  // k steps of a product over hd unrolled at once where A is read from
  // shared memory: all up to hd 128, 4 at hd 256 (as the forward), so
  // that hoisted fragments do not crowd out the accumulators
  static constexpr int kKUnroll = D >= 256 ? 4 : D / 16;
  // K, V, then two stages of Q and of dO, then two of L and of D
  static constexpr size_t kSmemKV =
      (size_t)(2 * BKV + 4 * BQ) * LD * sizeof(bf16) + 4 * BQ * sizeof(float);
  // Q, dO, then two stages of K and of V
  static constexpr size_t kSmemQ =
      (size_t)(2 * BQD + 4 * BK) * LD * sizeof(bf16);
  static constexpr size_t kSmem = kSmemKV > kSmemQ ? kSmemKV : kSmemQ;
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
// 4 bytes global -> shared; zero-filled when `pred` is false
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(pred ? 4 : 0));
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

// The A fragment of k step j of a product whose A is the 16 x 16j..16j+15
// block of an accumulator (S^T, P^T, dS^T or dS), rounded to bf16
template <int N>
__device__ __forceinline__ void a_frag(uint32_t (&a)[4],
                                       const float (&c)[N][4], int j) {
  a[0] = pack_bf16(c[2 * j][0], c[2 * j][1]);
  a[1] = pack_bf16(c[2 * j][2], c[2 * j][3]);
  a[2] = pack_bf16(c[2 * j + 1][0], c[2 * j + 1][1]);
  a[3] = pack_bf16(c[2 * j + 1][2], c[2 * j + 1][3]);
}

// c[0..NT) += A . B^T over D dims: A 16 x D (this warp's rows) read by
// ldmatrix from `a_w` (a_lane) at each k step, B's NT * 8 rows read by
// ldmatrix from `b_w` (b_lane); k steps unrolled KU at a time
template <int D, int NT, int LD, int KU>
__device__ __forceinline__ void gemm_abt(float (&c)[NT][4], const bf16* a_w,
                                         const bf16* b_w) {
#pragma unroll(KU)
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    ldmatrix_x4(a, a_w + kk * 16);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t b[4];
      ldmatrix_x4(b, b_w + np * 16 * LD + kk * 16);
      mma_bf16(c[2 * np], a, b[0], b[1]);
      mma_bf16(c[2 * np + 1], a, b[2], b[3]);
    }
  }
}
// ... A's k-step fragments held in registers
template <int D, int NT, int LD>
__device__ __forceinline__ void gemm_abt(float (&c)[NT][4],
                                         const uint32_t (&a)[D / 16][4],
                                         const bf16* b_w) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t b[4];
      ldmatrix_x4(b, b_w + np * 16 * LD + kk * 16);
      mma_bf16(c[2 * np], a[kk], b[0], b[1]);
      mma_bf16(c[2 * np + 1], a[kk], b[2], b[3]);
    }
  }
}

// acc[0..D/8) += A . B, A the bf16 rounding of accumulator `p` (16 x
// 8 NP), B the NP * 8 rows of a row-major tile read by ldmatrix.trans
// from `b_w` (the lane's address of rows 0..15, dims 0)
template <int D, int NP, int LD>
__device__ __forceinline__ void gemm_pb(float (&acc)[D / 8][4],
                                        const float (&p)[NP][4],
                                        const bf16* b_w) {
#pragma unroll
  for (int j = 0; j < NP / 2; ++j) {
    uint32_t a[4];
    a_frag<NP>(a, p, j);
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, b_w + j * 16 * LD + dp * 16);
      mma_bf16(acc[2 * dp], a, b[0], b[1]);
      mma_bf16(acc[2 * dp + 1], a, b[2], b[3]);
    }
  }
}

// a lane's address for B fragments read by ldmatrix (non-trans) from a
// row-major tile: rows (lane / 16) * 8 + lane % 8 of a pair of n tiles,
// dims + 8 * ((lane / 8) % 2)
template <int LD>
__device__ __forceinline__ const bf16* b_lane(const bf16* tile, int lane) {
  return tile + ((lane >> 4) * 8 + (lane & 7)) * LD + ((lane >> 3) & 1) * 8;
}
// ... for A fragments by ldmatrix, or B fragments by ldmatrix.trans:
// rows lane % 16, dims + 8 * (lane / 16)
template <int LD>
__device__ __forceinline__ const bf16* a_lane(const bf16* tile, int lane) {
  return tile + (lane & 15) * LD + (lane >> 4) * 8;
}

__device__ __forceinline__ bool pair_ok(int i, int j, int Sq, int Skv,
                                        int causal, int window) {
  return i < Sq && j < Skv && (!causal || j <= i) &&
         (!window || i - j < window);
}

// 1. D[b,h,i] = do[b,i,h] . o[b,i,h], 8 threads a row, 16 bytes a load
// (the float32 path's one warp a row with 2-byte loads took 5 us at the
// training shape, for 3.1 MB)
__global__ void __launch_bounds__(256)
flash_bwd_dot_kernel_tc(const bf16* __restrict__ o,
                        const bf16* __restrict__ dout,
                        float* __restrict__ dsum, Strides os, Strides dos,
                        int B, int Sq, int Hq, int hd) {
  // the warp's four rows shuffle together: a row past the end idles
  const long long row = (long long)blockIdx.x * 32 + threadIdx.x / 8;
  const bool live = row < (long long)B * Hq * Sq;
  const long long r = live ? row : 0;
  const int sl = threadIdx.x & 7;
  const int i = (int)(r % Sq);
  const int h = (int)((r / Sq) % Hq);
  const int b = (int)(r / ((long long)Sq * Hq));
  const bf16* op = o + b * os.b + (long long)i * os.s + h * os.h;
  const bf16* dp = dout + b * dos.b + (long long)i * dos.s + h * dos.h;
  float acc = 0.0f;
  for (int c = sl * 8; live && c < hd; c += 64) {
    const uint4 x = *reinterpret_cast<const uint4*>(op + c);
    const uint4 y = *reinterpret_cast<const uint4*>(dp + c);
    const __nv_bfloat162* x2 = reinterpret_cast<const __nv_bfloat162*>(&x);
    const __nv_bfloat162* y2 = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 a = __bfloat1622float2(x2[e]);
      const float2 d = __bfloat1622float2(y2[e]);
      acc = fmaf(a.x, d.x, acc);
      acc = fmaf(a.y, d.y, acc);
    }
  }
#pragma unroll
  for (int off = 4; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (live && sl == 0) dsum[row] = acc;
}

// what the dq and dk/dv blocks read and write
struct Args {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* dout;
  const float* lse;   // (B,Hq,Sq), base 2
  const float* dsum;  // D, (B,Hq,Sq)
  bf16* dq;
  float* dkp;         // (B,Skv,Hq,hd) float32 partials
  float* dvp;
  Strides qs, ks, vs, dos, dqs;
  int Sq, Skv, Hq, hd, group, causal, window;
  float scale_log2, scale;
  int n_dq, n_dkv;    // blocks of each kind along the grid's z
};

// 3. dk and/or dv of one q head and 64 keys (DO_V, DO_K pick which)
template <int D, bool DO_V, bool DO_K>
__device__ __forceinline__ void dkv_block(unsigned char* smem_raw,
                                          const Args& A, int h, int b,
                                          int kt) {
  using C = Cfg<D>;
  constexpr int BKV = C::BKV;
  constexpr int BQ = C::BQ;
  constexpr int LD = C::LD;
  constexpr int NT = BQ / 8;    // n tiles of S^T a warp
  constexpr int DT = D / 8;     // n tiles of dK, dV a warp
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);     // BKV x LD
  bf16* v_s = k_s + BKV * LD;                        // BKV x LD
  bf16* q_s = v_s + BKV * LD;                        // 2 x BQ x LD
  bf16* do_s = q_s + 2 * BQ * LD;                    // 2 x BQ x LD
  float* l_s = reinterpret_cast<float*>(do_s + 2 * BQ * LD);  // 2 x BQ
  float* d_s = l_s + 2 * BQ;                         // 2 x BQ

  const int Sq = A.Sq, Skv = A.Skv, hd = A.hd;
  const int causal = A.causal, window = A.window;
  const int hk = h / A.group;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int k0 = kt * BKV;

  // the q tiles some row of which attends to a key of this tile
  const int k_last = min(k0 + BKV, Skv) - 1;
  const int q_begin = causal ? k0 : 0;
  const int q_end = window ? min(Sq, k_last + window) : Sq;
  const int t_lo = q_begin / BQ;
  const int t_hi = (q_end + BQ - 1) / BQ;

  const bf16* qb = A.q + b * A.qs.b + h * A.qs.h;
  const bf16* db = A.dout + b * A.dos.b + h * A.dos.h;
  const long long row0 = ((long long)b * A.Hq + h) * Sq;  // L, D of q row 0
  auto load_q = [&](int stage, int t) {
    const int q0 = t * BQ;
    load_tile<D, BQ>(q_s + stage * BQ * LD, qb + (long long)q0 * A.qs.s,
                     A.qs.s, Sq - q0, hd, tid);
    load_tile<D, BQ>(do_s + stage * BQ * LD, db + (long long)q0 * A.dos.s,
                     A.dos.s, Sq - q0, hd, tid);
    for (int e = tid; e < 2 * BQ; e += C::kThreads) {
      const int r = e % BQ;
      const bool in = q0 + r < Sq;
      const float* src = (e < BQ ? A.lse : A.dsum) + row0 + (in ? q0 + r : 0);
      cp_async4((e < BQ ? l_s : d_s) + stage * BQ + r, src, in);
    }
  };

  load_tile<D, BKV>(k_s, A.k + b * A.ks.b + (long long)k0 * A.ks.s +
                             hk * A.ks.h,
                    A.ks.s, Skv - k0, hd, tid);
  if (DO_K)
    load_tile<D, BKV>(v_s, A.v + b * A.vs.b + (long long)k0 * A.vs.s +
                               hk * A.vs.h,
                      A.vs.s, Skv - k0, hd, tid);
  if (t_lo < t_hi) load_q(0, t_lo);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  float dk[DO_K ? DT : 1][4], dv[DO_V ? DT : 1][4];
#pragma unroll
  for (int i = 0; i < (DO_K ? DT : 1); ++i)
    dk[i][0] = dk[i][1] = dk[i][2] = dk[i][3] = 0.0f;
#pragma unroll
  for (int i = 0; i < (DO_V ? DT : 1); ++i)
    dv[i][0] = dv[i][1] = dv[i][2] = dv[i][3] = 0.0f;
  const bf16* k_w = a_lane<LD>(k_s + warp * 16 * LD, lane);
  const bf16* v_w = a_lane<LD>(v_s + warp * 16 * LD, lane);
  const int kj = k0 + warp * 16 + (lane >> 2);   // keys kj and kj + 8

  for (int t = t_lo; t < t_hi; ++t) {
    const int stage = (t - t_lo) & 1;
    if (t + 1 < t_hi) {  // the next tile loads while this one is computed
      load_q(stage ^ 1, t + 1);
      cp_async_commit();
    }
    const bf16* q_t = q_s + stage * BQ * LD;
    const bf16* do_t = do_s + stage * BQ * LD;
    const float* l_t = l_s + stage * BQ;
    const float* d_t = d_s + stage * BQ;
    const int q0 = t * BQ;

    // S^T = K Q^T, then P^T in place
    float s[NT][4];
#pragma unroll
    for (int i = 0; i < NT; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.0f;
    gemm_abt<D, NT, LD, C::kKUnroll>(s, k_w, b_lane<LD>(q_t, lane));
    const bool need_mask = k0 + BKV > Skv || q0 + BQ > Sq ||
                           (causal && k0 + BKV - 1 > q0) ||
                           (window && q0 + BQ - 1 - k0 >= window);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int c = nt * 8 + 2 * (lane & 3);
      const float2 L = *reinterpret_cast<const float2*>(l_t + c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(s[nt][e] * A.scale_log2 - ((e & 1) ? L.y : L.x));
        if (need_mask &&
            !pair_ok(q0 + c + (e & 1), kj + (e >> 1) * 8, Sq, Skv, causal,
                     window))
          p = 0.0f;
        s[nt][e] = p;
      }
    }

    // dV += P^T dO
    if constexpr (DO_V) gemm_pb<D, NT, LD>(dv, s, a_lane<LD>(do_t, lane));

    if constexpr (DO_K) {
      // dP^T = V dO^T, then dS^T = P^T (dP^T - D) in place
      float dp[NT][4];
#pragma unroll
      for (int i = 0; i < NT; ++i)
        dp[i][0] = dp[i][1] = dp[i][2] = dp[i][3] = 0.0f;
      gemm_abt<D, NT, LD, C::kKUnroll>(dp, v_w, b_lane<LD>(do_t, lane));
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float2 Dq =
            *reinterpret_cast<const float2*>(d_t + nt * 8 + 2 * (lane & 3));
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[nt][e] = s[nt][e] * (dp[nt][e] - ((e & 1) ? Dq.y : Dq.x));
      }
      // dK += dS^T Q
      gemm_pb<D, NT, LD>(dk, dp, a_lane<LD>(q_t, lane));
    }

    if (t + 1 < t_hi) cp_async_wait_all();
    __syncthreads();  // tile t + 1 has landed; stage t is free again
  }

  // the head's float32 partials (B,Skv,Hq,hd); dk scaled by 1/sqrt(hd)
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    const int c = dt * 8 + 2 * (lane & 3);
    if (c >= hd) continue;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int j = kj + r * 8;
      if (j >= Skv) continue;
      const long long at = (((long long)b * Skv + j) * A.Hq + h) * hd + c;
      if constexpr (DO_K)
        *reinterpret_cast<float2*>(A.dkp + at) =
            make_float2(dk[dt][2 * r] * A.scale, dk[dt][2 * r + 1] * A.scale);
      if constexpr (DO_V)
        *reinterpret_cast<float2*>(A.dvp + at) =
            make_float2(dv[dt][2 * r], dv[dt][2 * r + 1]);
    }
  }
}

// the i-th dk/dv block of a (q head, batch row): key tile i, or at hd 256
// key tile i / 2's dV (i even) or dK (i odd) block
template <int D>
__device__ __forceinline__ void dkv_role(unsigned char* smem_raw,
                                         const Args& A, int h, int b,
                                         int i) {
  if constexpr (Cfg<D>::kSplit) {
    if (i & 1)
      dkv_block<D, false, true>(smem_raw, A, h, b, i >> 1);
    else
      dkv_block<D, true, false>(smem_raw, A, h, b, i >> 1);
  } else {
    dkv_block<D, true, true>(smem_raw, A, h, b, i);
  }
}

// 2. dq of 64 q rows (tile qt) of one q head
template <int D>
__device__ __forceinline__ void dq_block(unsigned char* smem_raw,
                                         const Args& A, int h, int b,
                                         int qt) {
  using C = Cfg<D>;
  constexpr int BQ = C::BQD;
  constexpr int BK = C::BK;
  constexpr int LD = C::LD;
  constexpr int NT = BK / 8;    // n tiles of S a warp
  constexpr int DT = D / 8;     // n tiles of dQ a warp
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // BQ x LD
  bf16* do_s = q_s + BQ * LD;                     // BQ x LD
  bf16* k_s = do_s + BQ * LD;                     // 2 x BK x LD
  bf16* v_s = k_s + 2 * BK * LD;                  // 2 x BK x LD

  const int Sq = A.Sq, Skv = A.Skv, hd = A.hd;
  const int causal = A.causal, window = A.window;
  const int q0 = qt * BQ;
  const int hk = h / A.group;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // the key tiles some row of this q tile may attend to
  const int q_last = min(q0 + BQ, Sq) - 1;
  const int kv_end = causal ? min(Skv, q_last + 1) : Skv;
  const int kv_begin = window ? max(0, q0 - window + 1) : 0;
  const int t_lo = kv_begin / BK;
  const int t_hi = (kv_end + BK - 1) / BK;

  const bf16* kb = A.k + b * A.ks.b + hk * A.ks.h;
  const bf16* vb = A.v + b * A.vs.b + hk * A.vs.h;
  auto load_kv = [&](int stage, int t) {
    const int k0 = t * BK;
    load_tile<D, BK>(k_s + stage * BK * LD, kb + (long long)k0 * A.ks.s,
                     A.ks.s, Skv - k0, hd, tid);
    load_tile<D, BK>(v_s + stage * BK * LD, vb + (long long)k0 * A.vs.s,
                     A.vs.s, Skv - k0, hd, tid);
  };
  load_tile<D, BQ>(q_s, A.q + b * A.qs.b + (long long)q0 * A.qs.s +
                            h * A.qs.h,
                   A.qs.s, Sq - q0, hd, tid);
  load_tile<D, BQ>(do_s, A.dout + b * A.dos.b + (long long)q0 * A.dos.s +
                             h * A.dos.h,
                   A.dos.s, Sq - q0, hd, tid);
  if (t_lo < t_hi) load_kv(0, t_lo);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  // this warp's 16 rows of Q and dO as A fragments
  const bf16* q_w = a_lane<LD>(q_s + warp * 16 * LD, lane);
  const bf16* do_w = a_lane<LD>(do_s + warp * 16 * LD, lane);
  uint32_t qf[C::kQInRegs ? D / 16 : 1][4];
  uint32_t df[C::kQInRegs ? D / 16 : 1][4];
  if constexpr (C::kQInRegs) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      ldmatrix_x4(qf[kk], q_w + kk * 16);
      ldmatrix_x4(df[kk], do_w + kk * 16);
    }
  }
  const int row = q0 + warp * 16 + (lane >> 2);  // rows row and row + 8
  const long long lrow = ((long long)b * A.Hq + h) * Sq;
  float L[2], Dr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool in = row + r * 8 < Sq;
    L[r] = in ? A.lse[lrow + row + r * 8] : 0.0f;
    Dr[r] = in ? A.dsum[lrow + row + r * 8] : 0.0f;
  }

  float acc[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.0f;

  for (int t = t_lo; t < t_hi; ++t) {
    const int stage = (t - t_lo) & 1;
    if (t + 1 < t_hi) {  // the next tile loads while this one is computed
      load_kv(stage ^ 1, t + 1);
      cp_async_commit();
    }
    const bf16* k_t = k_s + stage * BK * LD;
    const bf16* v_t = v_s + stage * BK * LD;
    const int k0 = t * BK;

    // S = Q K^T, dP = dO V^T
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.0f;
      dp[i][0] = dp[i][1] = dp[i][2] = dp[i][3] = 0.0f;
    }
    if constexpr (C::kQInRegs) {
      gemm_abt<D, NT, LD>(s, qf, b_lane<LD>(k_t, lane));
      gemm_abt<D, NT, LD>(dp, df, b_lane<LD>(v_t, lane));
    } else {
      gemm_abt<D, NT, LD, C::kKUnroll>(s, q_w, b_lane<LD>(k_t, lane));
      gemm_abt<D, NT, LD, C::kKUnroll>(dp, do_w, b_lane<LD>(v_t, lane));
    }

    // dS = P (dP - D), P = exp2(S scale log2(e) - L), 0 where masked
    const bool need_mask = k0 + BK > Skv || q0 + BQ > Sq ||
                           (causal && k0 + BK - 1 > q0) ||
                           (window && q0 + BQ - 1 - k0 >= window);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(s[nt][e] * A.scale_log2 - L[e >> 1]);
        const int j = k0 + nt * 8 + 2 * (lane & 3) + (e & 1);
        if (need_mask &&
            !pair_ok(row + (e >> 1) * 8, j, Sq, Skv, causal, window))
          p = 0.0f;
        s[nt][e] = p * (dp[nt][e] - Dr[e >> 1]);
      }
    }

    // dQ += dS K
    gemm_pb<D, NT, LD>(acc, s, a_lane<LD>(k_t, lane));

    if (t + 1 < t_hi) cp_async_wait_all();
    __syncthreads();  // tile t + 1 has landed; stage t is free again
  }

  // epilogue: dq = acc / sqrt(hd), through this warp's rows of q_s
  bf16* o_w = q_s + warp * 16 * LD;
  const int g = lane >> 2;
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    const int c = dt * 8 + 2 * (lane & 3);
    *reinterpret_cast<uint32_t*>(o_w + g * LD + c) =
        pack_bf16(acc[dt][0] * A.scale, acc[dt][1] * A.scale);
    *reinterpret_cast<uint32_t*>(o_w + (g + 8) * LD + c) =
        pack_bf16(acc[dt][2] * A.scale, acc[dt][3] * A.scale);
  }
  __syncwarp();
#pragma unroll
  for (int e = lane; e < 16 * (D / 8); e += 32) {
    const int r = e / (D / 8);
    const int c = (e % (D / 8)) * 8;
    const int qi = q0 + warp * 16 + r;
    if (qi < Sq && c < hd)
      *reinterpret_cast<uint4*>(A.dq + b * A.dqs.b + (long long)qi * A.dqs.s +
                                h * A.dqs.h + c) =
          *reinterpret_cast<const uint4*>(o_w + r * LD + c);
  }
}

// 2 and 3 as one launch, block (q head, batch row, z). The hardware
// starts blocks in that order, so z takes each head's blocks longest
// first (the last q tile of dq, the first key tile of dk/dv under a
// causal mask), alternating a dk/dv and a dq block: one launch keeps both
// kinds in flight and fills the SMs that a kind alone leaves idle at S
// 512 (57 against 84 us at Qwen2-1.5B's training shape on an H100).
template <int D>
__global__ void __launch_bounds__(Cfg<D>::kThreads)
flash_bwd_dqkv_kernel_tc(const Args A) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int z = blockIdx.z;
  const int m = min(A.n_dq, A.n_dkv);
  int i, is_dq;
  if (z < 2 * m) {
    i = z >> 1;
    is_dq = z & 1;
  } else {
    i = z - m;
    is_dq = A.n_dq > A.n_dkv;
  }
  if (is_dq)
    dq_block<D>(smem_raw, A, blockIdx.x, blockIdx.y, A.n_dq - 1 - i);
  else
    dkv_role<D>(smem_raw, A, blockIdx.x, blockIdx.y, i);
}

template <int D>
int launch(const bf16* q, const bf16* k, const bf16* v, const bf16* o,
           const bf16* dout, const float* lse, float* dsum, float* dkp,
           float* dvp, bf16* dq, bf16* dk, bf16* dv, const Strides* st,
           int B, int Sq, int Skv, int Hq, int Hkv, int hd, int causal,
           int window, cudaStream_t stream) {
  using C = Cfg<D>;
  const Strides &os = st[3], &dks = st[6], &dvs = st[7];
  const int group = Hq / Hkv;
  const float scale = 1.0f / sqrtf((float)hd);
  Args A{q, k, v, dout, lse, dsum, dq, dkp, dvp,
         st[0], st[1], st[2], st[4], st[5],
         Sq, Skv, Hq, hd, group, causal, window,
         1.4426950408889634f * scale, scale,
         (Sq + C::BQD - 1) / C::BQD,
         (Skv + C::BKV - 1) / C::BKV * (C::kSplit ? 2 : 1)};

  const long long rows = (long long)B * Hq * Sq;
  flash_bwd_dot_kernel_tc<<<(unsigned)((rows + 31) / 32), 256, 0, stream>>>(
      o, dout, dsum, os, st[4], B, Sq, Hq, hd);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  err = cudaFuncSetAttribute(flash_bwd_dqkv_kernel_tc<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)C::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dqkv_kernel_tc<D><<<dim3(Hq, B, A.n_dq + A.n_dkv), C::kThreads,
                                C::kSmem, stream>>>(A);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const long long n = (long long)B * Skv * Hkv * hd;
  flash_bwd_reduce_kernel<bf16><<<(unsigned)((n + 255) / 256), 256, 0,
                                  stream>>>(dkp, dvp, dk, dv, dks, dvs, B,
                                            Skv, Hkv, hd, group);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

// ---------------------------------------------------------------------------
// float32: tensor cores, 3xTF32
// ---------------------------------------------------------------------------

namespace f32 {

// Blocks of kParts x 4 warps, 16 rows (keys in 3, q rows in 2) a warp
// group, as the bf16 kernels' 4 warps; each step's q rows (3) or keys (2)
// split between the kParts warps of a group, each with its own partial
// sums, added in a fixed order at the end. BQ and BK are the steps
// streamed through the two-stage ring; f32 rows take twice the bf16
// bytes: the header lists what was measured.
template <int D>
struct Cfg {
  static constexpr int kParts = D >= 256 ? 1 : 2;  // 1 or 2
  static constexpr int kThreads = 128 * kParts;
  static constexpr int LD = D + 4;        // padded smem row, in floats
  // dk/dv: 64 keys a block; q tiles of BQ rows
  static constexpr int BKV = 64;
  static constexpr int BQ = D >= 256 ? 16 : 32;
  static constexpr bool kSplit = D > 128;  // a dV and a dK block a tile
  // dq: 64 q rows a block; key tiles of BK keys
  static constexpr int BQD = 64;
  static constexpr int BK = D >= 256 ? 16 : 32;
  // k steps of a product over hd unrolled at once (A read from shared
  // memory and split at each step)
  static constexpr int kKUnroll = 2;
  // n tiles of dQ, dK, dV whose products issue term by term
  static constexpr int kGroup = 4;
  // K, V, then two stages of Q and of dO, then two of L and of D
  static constexpr size_t kSmemKV = (size_t)(2 * BKV + 4 * BQ) * LD *
                                        sizeof(float) +
                                    4 * BQ * sizeof(float);
  // Q, dO, then two stages of K and of V
  static constexpr size_t kSmemQ =
      (size_t)(2 * BQD + 4 * BK) * LD * sizeof(float);
  static constexpr size_t kSmem = kSmemKV > kSmemQ ? kSmemKV : kSmemQ;
  // the second part's dK and dV (or dQ) pass through it at the end
  static_assert(kParts == 1 || kSmem >= 4 * 32 * D * sizeof(float));
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
// accuracy (3xTF32: the two small terms, lo hi and hi lo, accumulated
// before hi hi), issued term by term across the tiles: a tile's next
// product waits on its last, so N independent products lie between them
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

// The A fragment of k step kk, split: rows g and g + 8, dims kk * 8 + t
// and + 4 of a row-major tile, `a_w` the lane's address of (row g, dim t)
template <int LD>
__device__ __forceinline__ void a_step(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                       const float* a_w, int kk) {
  const float* a = a_w + kk * 8;
  split(a[0], hi[0], lo[0]);
  split(a[8 * LD], hi[1], lo[1]);
  split(a[4], hi[2], lo[2]);
  split(a[8 * LD + 4], hi[3], lo[3]);
}

// ... and the NT B fragments of k step kk, split: rows n * 8 + g, dims
// kk * 8 + t and + 4, `b_w` the lane's address of (row g, dim t)
template <int NT, int LD>
__device__ __forceinline__ void b_step(uint32_t (&hi)[NT][2],
                                       uint32_t (&lo)[NT][2],
                                       const float* b_w, int kk) {
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    split(b_w[n * 8 * LD + kk * 8], hi[n][0], lo[n][0]);
    split(b_w[n * 8 * LD + kk * 8 + 4], hi[n][1], lo[n][1]);
  }
}

// c[0..NT) += A . B^T over D dims: A 16 x D (this warp's rows, from
// `a_w`), B's NT * 8 rows (from `b_w`), both row-major in shared memory,
// split at each k step; k steps unrolled KU at a time. The products are
// issued term by term across the n tiles (lo hi, then hi lo, then hi hi
// of each): a tile's next product waits on its last, so NT independent
// ones lie between them.
template <int D, int NT, int LD, int KU>
__device__ __forceinline__ void gemm_abt(float (&c)[NT][4], const float* a_w,
                                         const float* b_w) {
#pragma unroll(KU)
  for (int kk = 0; kk < D / 8; ++kk) {
    uint32_t ah[4], al[4], bh[NT][2], bl[NT][2];
    a_step<LD>(ah, al, a_w, kk);
    b_step<NT, LD>(bh, bl, b_w, kk);
    mma3_tiles<NT>(c, ah, al, bh, bl);
  }
}

// two such products over the same k steps in one loop (S and dP): 2 NT
// independent products between a tile's two
template <int D, int NT, int LD, int KU>
__device__ __forceinline__ void gemm_abt2(float (&c)[NT][4], const float* a_w,
                                          const float* b_w,
                                          float (&e)[NT][4], const float* x_w,
                                          const float* y_w) {
#pragma unroll(KU)
  for (int kk = 0; kk < D / 8; ++kk) {
    uint32_t ah[4], al[4], bh[NT][2], bl[NT][2];
    uint32_t xh[4], xl[4], yh[NT][2], yl[NT][2];
    a_step<LD>(ah, al, a_w, kk);
    b_step<NT, LD>(bh, bl, b_w, kk);
    a_step<LD>(xh, xl, x_w, kk);
    b_step<NT, LD>(yh, yl, y_w, kk);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      mma_tf32(c[n], al, bh[n][0], bh[n][1]);
      mma_tf32(e[n], xl, yh[n][0], yh[n][1]);
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      mma_tf32(c[n], ah, bl[n][0], bl[n][1]);
      mma_tf32(e[n], xh, yl[n][0], yl[n][1]);
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      mma_tf32(c[n], ah, bh[n][0], bh[n][1]);
      mma_tf32(e[n], xh, yh[n][0], yh[n][1]);
    }
  }
}

// acc[0..D/8) += A . B, A the accumulator `p` (16 x 8 NP) split in
// registers, B the NP * 8 rows of a row-major tile from `b_w` (the
// lane's row 2t, dim g). A column t of k step j is p's column 2t and
// column t + 4 its 2t + 1 (the layout of p's fragments), so B's rows
// are read in that order: keys (or q rows) j * 8 + 2t and + 1. The n
// tiles go in groups of G, issued term by term.
template <int D, int NP, int LD, int G>
__device__ __forceinline__ void gemm_pb(float (&acc)[D / 8][4],
                                        const float (&p)[NP][4],
                                        const float* b_w) {
#pragma unroll
  for (int j = 0; j < NP; ++j) {
    uint32_t ah[4], al[4];
    split(p[j][0], ah[0], al[0]);
    split(p[j][2], ah[1], al[1]);
    split(p[j][1], ah[2], al[2]);
    split(p[j][3], ah[3], al[3]);
#pragma unroll
    for (int d0 = 0; d0 < D / 8; d0 += G) {
      uint32_t bh[G][2], bl[G][2];
#pragma unroll
      for (int n = 0; n < G; ++n) {
        split(b_w[j * 8 * LD + (d0 + n) * 8], bh[n][0], bl[n][0]);
        split(b_w[(j * 8 + 1) * LD + (d0 + n) * 8], bh[n][1], bl[n][1]);
      }
      mma3_tiles<G>(acc + d0, ah, al, bh, bl);
    }
  }
}

// 1. D[b,h,i] = do[b,i,h] . o[b,i,h], 8 threads a row, 16 bytes a load
__global__ void __launch_bounds__(256)
flash_bwd_dot_kernel_f32(const float* __restrict__ o,
                         const float* __restrict__ dout,
                         float* __restrict__ dsum, Strides os, Strides dos,
                         int B, int Sq, int Hq, int hd) {
  // the warp's four rows shuffle together: a row past the end idles
  const long long row = (long long)blockIdx.x * 32 + threadIdx.x / 8;
  const bool live = row < (long long)B * Hq * Sq;
  const long long r = live ? row : 0;
  const int sl = threadIdx.x & 7;
  const int i = (int)(r % Sq);
  const int h = (int)((r / Sq) % Hq);
  const int b = (int)(r / ((long long)Sq * Hq));
  const float* op = o + b * os.b + (long long)i * os.s + h * os.h;
  const float* dp = dout + b * dos.b + (long long)i * dos.s + h * dos.h;
  float acc = 0.0f;
  for (int c = sl * 4; live && c < hd; c += 32) {
    const float4 x = *reinterpret_cast<const float4*>(op + c);
    const float4 y = *reinterpret_cast<const float4*>(dp + c);
    acc = fmaf(x.x, y.x, acc);
    acc = fmaf(x.y, y.y, acc);
    acc = fmaf(x.z, y.z, acc);
    acc = fmaf(x.w, y.w, acc);
  }
#pragma unroll
  for (int off = 4; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (live && sl == 0) dsum[row] = acc;
}

// what the dq and dk/dv blocks read and write
struct Args {
  const float* q;
  const float* k;
  const float* v;
  const float* dout;
  const float* lse;   // (B,Hq,Sq), base 2
  const float* dsum;  // D, (B,Hq,Sq)
  float* dq;
  float* dkp;         // (B,Skv,Hq,hd) float32 partials
  float* dvp;
  Strides qs, ks, vs, dos, dqs;
  int Sq, Skv, Hq, hd, group, causal, window;
  float scale_log2, scale;
  int n_dq, n_dkv;    // blocks of each kind along the grid's z
};

// 3. dk and/or dv of one q head and 64 keys (DO_V, DO_K pick which)
template <int D, bool DO_V, bool DO_K>
__device__ __forceinline__ void dkv_block(unsigned char* smem_raw,
                                          const Args& A, int h, int b,
                                          int kt) {
  using C = Cfg<D>;
  constexpr int BKV = C::BKV;
  constexpr int BQ = C::BQ;
  constexpr int LD = C::LD;
  constexpr int KU = C::kKUnroll;
  constexpr int QW = BQ / C::kParts;  // q rows of a step a warp takes
  constexpr int NT = QW / 8;    // n tiles of S^T a warp
  constexpr int DT = D / 8;     // n tiles of dK, dV a warp
  float* k_s = reinterpret_cast<float*>(smem_raw);   // BKV x LD
  float* v_s = k_s + BKV * LD;                       // BKV x LD
  float* q_s = v_s + BKV * LD;                       // 2 x BQ x LD
  float* do_s = q_s + 2 * BQ * LD;                   // 2 x BQ x LD
  float* l_s = do_s + 2 * BQ * LD;                   // 2 x BQ
  float* d_s = l_s + 2 * BQ;                         // 2 x BQ

  const int Sq = A.Sq, Skv = A.Skv, hd = A.hd;
  const int causal = A.causal, window = A.window;
  const int hk = h / A.group;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = (tid >> 5) & 3;   // the warp's 16 keys
  const int part = tid >> 7;         // and its part of each q step
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int k0 = kt * BKV;

  // the q tiles some row of which attends to a key of this tile
  const int k_last = min(k0 + BKV, Skv) - 1;
  const int q_begin = causal ? k0 : 0;
  const int q_end = window ? min(Sq, k_last + window) : Sq;
  const int t_lo = q_begin / BQ;
  const int t_hi = (q_end + BQ - 1) / BQ;

  const float* qb = A.q + b * A.qs.b + h * A.qs.h;
  const float* db = A.dout + b * A.dos.b + h * A.dos.h;
  const long long row0 = ((long long)b * A.Hq + h) * Sq;  // L, D of q row 0
  auto load_q = [&](int stage, int t) {
    const int q0 = t * BQ;
    load_tile<D, BQ>(q_s + stage * BQ * LD, qb + (long long)q0 * A.qs.s,
                     A.qs.s, Sq - q0, hd, tid);
    load_tile<D, BQ>(do_s + stage * BQ * LD, db + (long long)q0 * A.dos.s,
                     A.dos.s, Sq - q0, hd, tid);
    for (int e = tid; e < 2 * BQ; e += C::kThreads) {
      const int r = e % BQ;
      const bool in = q0 + r < Sq;
      const float* src = (e < BQ ? A.lse : A.dsum) + row0 + (in ? q0 + r : 0);
      tc::cp_async4((e < BQ ? l_s : d_s) + stage * BQ + r, src, in);
    }
  };

  load_tile<D, BKV>(k_s, A.k + b * A.ks.b + (long long)k0 * A.ks.s +
                             hk * A.ks.h,
                    A.ks.s, Skv - k0, hd, tid);
  if (DO_K)
    load_tile<D, BKV>(v_s, A.v + b * A.vs.b + (long long)k0 * A.vs.s +
                               hk * A.vs.h,
                      A.vs.s, Skv - k0, hd, tid);
  if (t_lo < t_hi) load_q(0, t_lo);
  tc::cp_async_commit();
  tc::cp_async_wait_all();
  __syncthreads();

  float dk[DO_K ? DT : 1][4], dv[DO_V ? DT : 1][4];
#pragma unroll
  for (int i = 0; i < (DO_K ? DT : 1); ++i)
    dk[i][0] = dk[i][1] = dk[i][2] = dk[i][3] = 0.0f;
#pragma unroll
  for (int i = 0; i < (DO_V ? DT : 1); ++i)
    dv[i][0] = dv[i][1] = dv[i][2] = dv[i][3] = 0.0f;
  // this warp's 16 keys of K and V as A operands: the lane's row g, dim t
  const float* k_w = k_s + (warp * 16 + g) * LD + t4;
  const float* v_w = v_s + (warp * 16 + g) * LD + t4;
  const int kj = k0 + warp * 16 + g;   // keys kj and kj + 8

  for (int t = t_lo; t < t_hi; ++t) {
    const int stage = (t - t_lo) & 1;
    if (t + 1 < t_hi) {  // the next tile loads while this one is computed
      load_q(stage ^ 1, t + 1);
      tc::cp_async_commit();
    }
    // this warp's QW rows of the step
    const float* q_t = q_s + (stage * BQ + part * QW) * LD;
    const float* do_t = do_s + (stage * BQ + part * QW) * LD;
    const float* l_t = l_s + stage * BQ + part * QW;
    const float* d_t = d_s + stage * BQ + part * QW;
    const int q0 = t * BQ;
    const int qw0 = q0 + part * QW;

    // S^T = K Q^T (and dP^T = V dO^T beside it), then P^T in place
    float s[NT][4], dp[DO_K ? NT : 1][4];
#pragma unroll
    for (int i = 0; i < NT; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.0f;
    if constexpr (DO_K) {
#pragma unroll
      for (int i = 0; i < NT; ++i)
        dp[i][0] = dp[i][1] = dp[i][2] = dp[i][3] = 0.0f;
      gemm_abt2<D, NT, LD, KU>(s, k_w, q_t + g * LD + t4, dp, v_w,
                               do_t + g * LD + t4);
    } else {
      gemm_abt<D, NT, LD, KU>(s, k_w, q_t + g * LD + t4);
    }
    const bool need_mask = k0 + BKV > Skv || q0 + BQ > Sq ||
                           (causal && k0 + BKV - 1 > q0) ||
                           (window && q0 + BQ - 1 - k0 >= window);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int c = nt * 8 + 2 * t4;
      const float2 L = *reinterpret_cast<const float2*>(l_t + c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(s[nt][e] * A.scale_log2 - ((e & 1) ? L.y : L.x));
        if (need_mask &&
            !tc::pair_ok(qw0 + c + (e & 1), kj + (e >> 1) * 8, Sq, Skv,
                         causal, window))
          p = 0.0f;
        s[nt][e] = p;
      }
    }

    // dV += P^T dO
    if constexpr (DO_V)
      gemm_pb<D, NT, LD, C::kGroup>(dv, s, do_t + 2 * t4 * LD + g);

    if constexpr (DO_K) {
      // dS^T = P^T (dP^T - D) in place
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float2 Dq =
            *reinterpret_cast<const float2*>(d_t + nt * 8 + 2 * t4);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[nt][e] = s[nt][e] * (dp[nt][e] - ((e & 1) ? Dq.y : Dq.x));
      }
      // dK += dS^T Q
      gemm_pb<D, NT, LD, C::kGroup>(dk, dp, q_t + 2 * t4 * LD + g);
    }

    if (t + 1 < t_hi) tc::cp_async_wait_all();
    __syncthreads();  // tile t + 1 has landed; stage t is free again
  }

  // the parts' sums added, the first's then the second's: the second
  // puts its dK and dV in shared memory (free now), element by element
  // across the lanes
  if constexpr (C::kParts == 2) {
    float* x_s = reinterpret_cast<float*>(smem_raw) + warp * D * 32 + lane;
    if (part == 1) {
#pragma unroll
      for (int dt = 0; dt < DT; ++dt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if constexpr (DO_K) x_s[(dt * 4 + e) * 32] = dk[dt][e];
          if constexpr (DO_V) x_s[((DT + dt) * 4 + e) * 32] = dv[dt][e];
        }
    }
    __syncthreads();
    if (part == 1) return;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if constexpr (DO_K) dk[dt][e] += x_s[(dt * 4 + e) * 32];
        if constexpr (DO_V) dv[dt][e] += x_s[((DT + dt) * 4 + e) * 32];
      }
  }

  // the head's float32 partials (B,Skv,Hq,hd); dk scaled by 1/sqrt(hd)
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    const int c = dt * 8 + 2 * t4;
    if (c >= hd) continue;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int j = kj + r * 8;
      if (j >= Skv) continue;
      const long long at = (((long long)b * Skv + j) * A.Hq + h) * hd + c;
      if constexpr (DO_K)
        *reinterpret_cast<float2*>(A.dkp + at) =
            make_float2(dk[dt][2 * r] * A.scale, dk[dt][2 * r + 1] * A.scale);
      if constexpr (DO_V)
        *reinterpret_cast<float2*>(A.dvp + at) =
            make_float2(dv[dt][2 * r], dv[dt][2 * r + 1]);
    }
  }
}

// the i-th dk/dv block of a (q head, batch row): key tile i, or at hd 256
// key tile i / 2's dV (i even) or dK (i odd) block
template <int D>
__device__ __forceinline__ void dkv_role(unsigned char* smem_raw,
                                         const Args& A, int h, int b,
                                         int i) {
  if constexpr (Cfg<D>::kSplit) {
    if (i & 1)
      dkv_block<D, false, true>(smem_raw, A, h, b, i >> 1);
    else
      dkv_block<D, true, false>(smem_raw, A, h, b, i >> 1);
  } else {
    dkv_block<D, true, true>(smem_raw, A, h, b, i);
  }
}

// 2. dq of 64 q rows (tile qt) of one q head
template <int D>
__device__ __forceinline__ void dq_block(unsigned char* smem_raw,
                                         const Args& A, int h, int b,
                                         int qt) {
  using C = Cfg<D>;
  constexpr int BQ = C::BQD;
  constexpr int BK = C::BK;
  constexpr int LD = C::LD;
  constexpr int KU = C::kKUnroll;
  constexpr int KW = BK / C::kParts;  // keys of a step a warp takes
  constexpr int NT = KW / 8;    // n tiles of S a warp
  constexpr int DT = D / 8;     // n tiles of dQ a warp
  float* q_s = reinterpret_cast<float*>(smem_raw);  // BQ x LD
  float* do_s = q_s + BQ * LD;                      // BQ x LD
  float* k_s = do_s + BQ * LD;                      // 2 x BK x LD
  float* v_s = k_s + 2 * BK * LD;                   // 2 x BK x LD

  const int Sq = A.Sq, Skv = A.Skv, hd = A.hd;
  const int causal = A.causal, window = A.window;
  const int q0 = qt * BQ;
  const int hk = h / A.group;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = (tid >> 5) & 3;   // the warp's 16 q rows
  const int part = tid >> 7;         // and its part of each key step
  const int g = lane >> 2;
  const int t4 = lane & 3;

  // the key tiles some row of this q tile may attend to
  const int q_last = min(q0 + BQ, Sq) - 1;
  const int kv_end = causal ? min(Skv, q_last + 1) : Skv;
  const int kv_begin = window ? max(0, q0 - window + 1) : 0;
  const int t_lo = kv_begin / BK;
  const int t_hi = (kv_end + BK - 1) / BK;

  const float* kb = A.k + b * A.ks.b + hk * A.ks.h;
  const float* vb = A.v + b * A.vs.b + hk * A.vs.h;
  auto load_kv = [&](int stage, int t) {
    const int k0 = t * BK;
    load_tile<D, BK>(k_s + stage * BK * LD, kb + (long long)k0 * A.ks.s,
                     A.ks.s, Skv - k0, hd, tid);
    load_tile<D, BK>(v_s + stage * BK * LD, vb + (long long)k0 * A.vs.s,
                     A.vs.s, Skv - k0, hd, tid);
  };
  load_tile<D, BQ>(q_s, A.q + b * A.qs.b + (long long)q0 * A.qs.s +
                            h * A.qs.h,
                   A.qs.s, Sq - q0, hd, tid);
  load_tile<D, BQ>(do_s, A.dout + b * A.dos.b + (long long)q0 * A.dos.s +
                             h * A.dos.h,
                   A.dos.s, Sq - q0, hd, tid);
  if (t_lo < t_hi) load_kv(0, t_lo);
  tc::cp_async_commit();
  tc::cp_async_wait_all();
  __syncthreads();

  // this warp's 16 rows of Q and dO as A operands: the lane's row g, dim t
  const float* q_w = q_s + (warp * 16 + g) * LD + t4;
  const float* do_w = do_s + (warp * 16 + g) * LD + t4;
  const int row = q0 + warp * 16 + g;  // rows row and row + 8
  const long long lrow = ((long long)b * A.Hq + h) * Sq;
  float L[2], Dr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool in = row + r * 8 < Sq;
    L[r] = in ? A.lse[lrow + row + r * 8] : 0.0f;
    Dr[r] = in ? A.dsum[lrow + row + r * 8] : 0.0f;
  }

  float acc[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.0f;

  for (int t = t_lo; t < t_hi; ++t) {
    const int stage = (t - t_lo) & 1;
    if (t + 1 < t_hi) {  // the next tile loads while this one is computed
      load_kv(stage ^ 1, t + 1);
      tc::cp_async_commit();
    }
    // this warp's KW keys of the step
    const float* k_t = k_s + (stage * BK + part * KW) * LD;
    const float* v_t = v_s + (stage * BK + part * KW) * LD;
    const int k0 = t * BK;
    const int kw0 = k0 + part * KW;

    // S = Q K^T, dP = dO V^T
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.0f;
      dp[i][0] = dp[i][1] = dp[i][2] = dp[i][3] = 0.0f;
    }
    gemm_abt2<D, NT, LD, KU>(s, q_w, k_t + g * LD + t4, dp, do_w,
                             v_t + g * LD + t4);

    // dS = P (dP - D), P = exp2(S scale log2(e) - L), 0 where masked
    const bool need_mask = k0 + BK > Skv || q0 + BQ > Sq ||
                           (causal && k0 + BK - 1 > q0) ||
                           (window && q0 + BQ - 1 - k0 >= window);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(s[nt][e] * A.scale_log2 - L[e >> 1]);
        const int j = kw0 + nt * 8 + 2 * t4 + (e & 1);
        if (need_mask &&
            !tc::pair_ok(row + (e >> 1) * 8, j, Sq, Skv, causal, window))
          p = 0.0f;
        s[nt][e] = p * (dp[nt][e] - Dr[e >> 1]);
      }
    }

    // dQ += dS K
    gemm_pb<D, NT, LD, C::kGroup>(acc, s, k_t + 2 * t4 * LD + g);

    if (t + 1 < t_hi) tc::cp_async_wait_all();
    __syncthreads();  // tile t + 1 has landed; stage t is free again
  }

  // the parts' sums added, the first's then the second's, through
  // shared memory (free now), element by element across the lanes
  if constexpr (C::kParts == 2) {
    float* x_s = reinterpret_cast<float*>(smem_raw) + warp * D * 32 + lane;
    if (part == 1) {
#pragma unroll
      for (int dt = 0; dt < DT; ++dt)
#pragma unroll
        for (int e = 0; e < 4; ++e) x_s[(dt * 4 + e) * 32] = acc[dt][e];
    }
    __syncthreads();
    if (part == 1) return;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[dt][e] += x_s[(dt * 4 + e) * 32];
  }

  // epilogue: dq = acc / sqrt(hd), 8 bytes a store
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row + r * 8;
    if (qi >= Sq) continue;
    float* dqp = A.dq + b * A.dqs.b + (long long)qi * A.dqs.s + h * A.dqs.h;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      const int c = dt * 8 + 2 * t4;
      if (c < hd)
        *reinterpret_cast<float2*>(dqp + c) =
            make_float2(acc[dt][2 * r] * A.scale, acc[dt][2 * r + 1] * A.scale);
    }
  }
}

// 2 and 3 as one launch, block (q head, batch row, z), in the bf16
// kernel's order: each head's blocks longest first, a dk/dv and a dq
// block in turn
template <int D>
__global__ void __launch_bounds__(Cfg<D>::kThreads, 1)
flash_bwd_dqkv_kernel_f32(const Args A) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int z = blockIdx.z;
  const int m = min(A.n_dq, A.n_dkv);
  int i, is_dq;
  if (z < 2 * m) {
    i = z >> 1;
    is_dq = z & 1;
  } else {
    i = z - m;
    is_dq = A.n_dq > A.n_dkv;
  }
  if (is_dq)
    dq_block<D>(smem_raw, A, blockIdx.x, blockIdx.y, A.n_dq - 1 - i);
  else
    dkv_role<D>(smem_raw, A, blockIdx.x, blockIdx.y, i);
}

template <int D>
int launch(const float* q, const float* k, const float* v, const float* o,
           const float* dout, const float* lse, float* dsum, float* dkp,
           float* dvp, float* dq, float* dk, float* dv, const Strides* st,
           int B, int Sq, int Skv, int Hq, int Hkv, int hd, int causal,
           int window, cudaStream_t stream) {
  using C = Cfg<D>;
  const Strides &os = st[3], &dks = st[6], &dvs = st[7];
  const int group = Hq / Hkv;
  const float scale = 1.0f / sqrtf((float)hd);
  Args A{q, k, v, dout, lse, dsum, dq, dkp, dvp,
         st[0], st[1], st[2], st[4], st[5],
         Sq, Skv, Hq, hd, group, causal, window,
         1.4426950408889634f * scale, scale,
         (Sq + C::BQD - 1) / C::BQD,
         (Skv + C::BKV - 1) / C::BKV * (C::kSplit ? 2 : 1)};

  const long long rows = (long long)B * Hq * Sq;
  flash_bwd_dot_kernel_f32<<<(unsigned)((rows + 31) / 32), 256, 0,
                             stream>>>(o, dout, dsum, os, st[4], B, Sq, Hq,
                                       hd);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  err = cudaFuncSetAttribute(flash_bwd_dqkv_kernel_f32<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)C::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dqkv_kernel_f32<D><<<dim3(Hq, B, A.n_dq + A.n_dkv), C::kThreads,
                                 C::kSmem, stream>>>(A);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const long long n = (long long)B * Skv * Hkv * hd;
  flash_bwd_reduce_kernel<float><<<(unsigned)((n + 255) / 256), 256, 0,
                                   stream>>>(dkp, dvp, dk, dv, dks, dvs, B,
                                             Skv, Hkv, hd, group);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace f32

// the 64-, 128- or 256-wide instance of the float32 kernels
int dispatch(const void* q, const void* k, const void* v, const void* o,
             const void* dout, const float* lse, float* dsum, float* dkp,
             float* dvp, void* dq, void* dk, void* dv, const Strides* st,
             int B, int Sq, int Skv, int Hq, int Hkv, int hd, int causal,
             int window, cudaStream_t stream) {
  const float *qt = static_cast<const float*>(q),
              *kt = static_cast<const float*>(k),
              *vt = static_cast<const float*>(v),
              *ot = static_cast<const float*>(o),
              *dt = static_cast<const float*>(dout);
  float *dqt = static_cast<float*>(dq), *dkt = static_cast<float*>(dk),
        *dvt = static_cast<float*>(dv);
  if (hd <= 64)
    return f32::launch<64>(qt, kt, vt, ot, dt, lse, dsum, dkp, dvp, dqt, dkt,
                           dvt, st, B, Sq, Skv, Hq, Hkv, hd, causal, window,
                           stream);
  if (hd <= 128)
    return f32::launch<128>(qt, kt, vt, ot, dt, lse, dsum, dkp, dvp, dqt,
                            dkt, dvt, st, B, Sq, Skv, Hq, Hkv, hd, causal,
                            window, stream);
  return f32::launch<256>(qt, kt, vt, ot, dt, lse, dsum, dkp, dvp, dqt, dkt,
                          dvt, st, B, Sq, Skv, Hq, Hkv, hd, causal, window,
                          stream);
}

// the 64-, 128- or 256-wide instance of the tensor-core kernels
int dispatch_tc(const void* q, const void* k, const void* v, const void* o,
                const void* dout, const float* lse, float* dsum, float* dkp,
                float* dvp, void* dq, void* dk, void* dv, const Strides* st,
                int B, int Sq, int Skv, int Hq, int Hkv, int hd, int causal,
                int window, cudaStream_t stream) {
  const bf16 *qt = static_cast<const bf16*>(q),
             *kt = static_cast<const bf16*>(k),
             *vt = static_cast<const bf16*>(v),
             *ot = static_cast<const bf16*>(o),
             *dt = static_cast<const bf16*>(dout);
  bf16 *dqt = static_cast<bf16*>(dq), *dkt = static_cast<bf16*>(dk),
       *dvt = static_cast<bf16*>(dv);
  if (hd <= 64)
    return tc::launch<64>(qt, kt, vt, ot, dt, lse, dsum, dkp, dvp, dqt, dkt,
                          dvt, st, B, Sq, Skv, Hq, Hkv, hd, causal, window,
                          stream);
  if (hd <= 128)
    return tc::launch<128>(qt, kt, vt, ot, dt, lse, dsum, dkp, dvp, dqt, dkt,
                           dvt, st, B, Sq, Skv, Hq, Hkv, hd, causal, window,
                           stream);
  return tc::launch<256>(qt, kt, vt, ot, dt, lse, dsum, dkp, dvp, dqt, dkt,
                         dvt, st, B, Sq, Skv, Hq, Hkv, hd, causal, window,
                         stream);
}

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
    return plan<f32::Cfg<D>>(f32::flash_bwd_dqkv_kernel_f32<D>, smem,
                             blocks);
  return plan<tc::Cfg<D>>(tc::flash_bwd_dqkv_kernel_tc<D>, smem, blocks);
}

}  // namespace

extern "C" {

// Launches the three kernels on `stream`; returns a cudaError_t (0 = ok).
// q, o, do, dq (B,Sq,Hq,hd) and k, v, dk, dv (B,Skv,Hkv,hd) are device
// pointers with a contiguous head dim; `strides` holds 24 element strides,
// batch, sequence and head for q, k, v, o, do, dq, dk, dv in that order.
// lse is the forward's (B,Hq,Sq) float32 output. The wrapper allocates the
// scratch: dsum float32 (B,Hq,Sq), dkp and dvp float32 (B,Skv,Hq,hd), all
// contiguous. dtype: 0 = float32, 1 = bfloat16. hd must be a multiple of
// 8 up to 256, and Hq a multiple of Hkv. Every base pointer must be
// 16-byte aligned and every stride a multiple of 16 bytes (8 bfloat16 or
// 4 float32 elements).
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
  for (int t = 0; t < 24; ++t)  // the 16-byte copies
    if (strides[t] % (dtype == 1 ? 8 : 4))
      return static_cast<int>(cudaErrorMisalignedAddress);
  for (const void* p : {q, k, v, o, dout, static_cast<const void*>(dq),
                        static_cast<const void*>(dk),
                        static_cast<const void*>(dv)})
    if (reinterpret_cast<uintptr_t>(p) % 16)
      return static_cast<int>(cudaErrorMisalignedAddress);
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
    return dispatch(q, k, v, o, dout, l, ds, kp, vp, dq, dk, dv, st, B, Sq,
                    Skv, Hq, Hkv, hd, causal, window, s);
  return dispatch_tc(q, k, v, o, dout, l, ds, kp, vp, dq, dk, dv, st, B, Sq,
                     Skv, Hq, Hkv, hd, causal, window, s);
}

// The launch plan of the dq + dk/dv kernel that runs head dim hd in
// dtype (0 = float32, 1 = bfloat16): its dynamic shared memory in bytes
// and the blocks that fit an SM with its registers and that memory (the
// CUDA occupancy calculator). Returns a cudaError_t.
int flash_attention_bwd_occupancy(int hd, int dtype, int* smem,
                                  int* blocks) {
  if (hd <= 0 || hd > 256 || hd % 8 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  return hd <= 64    ? plan_of<64>(dtype, smem, blocks)
         : hd <= 128 ? plan_of<128>(dtype, smem, blocks)
                     : plan_of<256>(dtype, smem, blocks);
}

const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
