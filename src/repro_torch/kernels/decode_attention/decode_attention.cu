// Decode attention for Hopper (sm_90a): one query token against a
// ring-buffer KV cache, bfloat16 or float32.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/decode_attention/kernel.py::decode_attention_kernel.
// For q (B,Hq,hd), a cache k, v (B,T,Hkv,hd) with slot positions
// kv_pos (B,T) (INT32_MAX marks an empty slot) and the query positions
// q_pos (B,), it computes per q head h, with kv head h / (Hq / Hkv),
//     o = sum_t softmax_t(q . k[t] / sqrt(hd)) v[t]
// where slot t counts when kv_pos[t] <= q_pos (and q_pos - kv_pos[t] <
// window when a window is set). Masked scores are -1e30, as in the
// reference, so the result equals its dense softmax; a row with no
// allowed slot gets the mean of v over all T slots, as there.
//
// What bounds it on an H100: the cache. Each K and V slot that the mask
// allows is needed once per (b, kv head) and used for 2 hd operations per
// q head, far below the ~295 operations per byte where the tensor cores
// would start to bind: at B = 2, Hkv = 2, hd = 128 in bf16 with 544
// slots allowed, about 1.1 MB, or 0.34 us at 3.35 TB/s. So the kernel has
// to spread those bytes over the SMs and skip the slots the mask drops;
// at so few bytes the latency of a block's chain of loads sets its time.
//
// Design: split-T flash-decoding. The grid is (T split, kv head, batch
// row): the split count comes from the shapes alone (`decode_splits` in
// ops.py: about one wave over the 132 SMs, at least 32 slots a split), so
// the result never depends on the data. Each block computes all G =
// Hq / Hkv q heads of its group over its slots, so each K/V slot is read
// from device memory once. A block first reads its slice of kv_pos; a
// 32-slot sub-tile with no allowed slot is skipped, and within a live
// sub-tile only allowed slots are copied: K and V move in the input type
// by 16-byte cp.async into shared memory (never as f32; zero-filled where
// skipped). Scores take LPS lanes per slot (a warp at hd 256 in bf16,
// half a warp at 128), each lane one 16-byte vector of k against q held
// in registers for 4 q heads at a time, reduced by xor shuffles; mma.sync
// would need G padded to 16 rows and a second, bf16-only path for a few
// hundred operations per slot, so the CUDA cores do it. One warp per head
// updates that head's online softmax (a lane per slot), and each thread
// accumulates 4 heads x one 16-byte vector of v for the allowed slots,
// in slot order, in f32 in shared memory. Each split writes its f32
// partials (m, l, acc[G, hd]) to scratch that the wrapper allocates.
// A second small kernel merges them, one block per (q head, b, kv head)
// spread over the SMs: it reads every split's m and l, weighs each split
// by exp(m - max m) (0 for a split that saw no slot), and sums the
// partial acc of the splits that saw a slot in split order, all their
// loads in flight at once. When asked, it also writes each row's
// natural log-sum-exp of the scaled scores, max m + log(sum w l), in
// float32: what a caller needs to merge attention over slices of a
// cache held on different ranks (o = sum_r e^(lse_r - max) o_r /
// sum_r e^(lse_r - max)). No float atomics, so a run repeats bit for
// bit. Both kernels run from one wrapper call; the wrapper counts one
// launch.
//
// A row with no allowed slot anywhere: every split then takes all its
// slots, each scored -1e30, so each weighs 1 and the merge gives the
// uniform mean over T, as the plain version does. A block finds this
// case only when its own slice has no allowed slot (it then reads the
// row's other positions); elsewhere masked slots weigh exp(-1e30 - m) = 0
// and skipping them changes nothing.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSub = 32;          // slots per sub-tile: one per lane
constexpr int kHB = 4;            // q heads per register batch
constexpr float kMasked = -1e30f; // the reference's mask value
constexpr size_t kMaxSmem = 232448;
constexpr int kMaxSplits = 256;   // splits the merge takes
constexpr int kMergeThreads = 64; // 4 dims each: hd up to 256
constexpr int kMergeBatch = 16;   // partial loads in flight per thread

struct Strides {  // in elements
  long long b, s, h;
};

template <typename T>
struct Vec {  // one 16-byte load of T, as f32
  static constexpr int N = 16 / sizeof(T);
};
__device__ __forceinline__ void to_f32(const uint4& u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void to_f32(const uint4& u, float (&f)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);            // low bf16
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);  // high bf16
  }
}
__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// 16 bytes global -> shared; zero-filled when `pred` is false
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(pred ? 16 : 0));
}

// MAXD: the instance's head-dim width (64, 128 or 256)
template <typename T, int MAXD>
struct Layout {
  static constexpr int VEC = Vec<T>::N;            // elements per vector
  static constexpr int NVEC = MAXD / VEC;          // vectors per row
  static constexpr int LPS = NVEC < 32 ? NVEC : 32;  // lanes per slot
  static constexpr int NV = NVEC / LPS;            // vectors per lane
  static constexpr int GROUPS = kThreads / LPS;    // slots in flight
};

size_t smem_bytes(int maxd, int G, int esize) {
  return (size_t)2 * kSub * maxd * esize
         + sizeof(float) * (2 * (size_t)G * maxd + (size_t)G * kSub
                            + 3 * (size_t)G);
}

template <typename T, int MAXD>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const int* __restrict__ kv_pos,
                        const int* __restrict__ q_pos,
                        float* __restrict__ part_acc,
                        float* __restrict__ part_ml, Strides qs, Strides ks,
                        Strides vs, int T_, int hd, int G, int window,
                        int chunk, float scale) {
  using L = Layout<T, MAXD>;
  constexpr int VEC = L::VEC;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* k_s = reinterpret_cast<T*>(smem_raw);          // kSub x MAXD
  T* v_s = k_s + kSub * MAXD;                       // kSub x MAXD
  float* q_s = reinterpret_cast<float*>(v_s + kSub * MAXD);  // G x MAXD
  float* acc_s = q_s + G * MAXD;                    // G x MAXD
  float* p_s = acc_s + G * MAXD;                    // G x kSub
  float* m_s = p_s + G * kSub;                      // G
  float* l_s = m_s + G;                             // G
  float* c_s = l_s + G;                             // G: rescale factor

  const int split = blockIdx.x;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long qp = q_pos[b];
  const int* pb = kv_pos + (long long)b * T_;
  const int t_begin = split * chunk;
  const int t_end = min(T_, t_begin + chunk);
  auto allowed = [&](int pos) {
    const long long kp = pos;
    return kp <= qp && (!window || qp - kp < window);
  };

  for (int e = tid; e < G * MAXD; e += kThreads) acc_s[e] = 0.0f;
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = -INFINITY;  // no slot seen yet
    l_s[g] = 0.0f;
  }

  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;
  const int grp = tid / L::LPS;       // this thread's slot group
  const int lis = tid % L::LPS;       // its lane within the group
  bool seen = false;                  // the same in every thread
  bool q_ready = false;
  // pass 0 skips sub-tiles with no allowed slot; pass 1 runs only when
  // the whole row has none, and takes every slot, scored -1e30
  for (int pass = 0; pass < 2; ++pass) {
    for (int t0 = t_begin; t0 < t_end; t0 += kSub) {
      const int n = min(kSub, t_end - t0);
      const bool ok = lane < n && allowed(pb[t0 + lane]);
      const unsigned live = __ballot_sync(0xffffffffu, ok);
      if (!live && pass == 0) continue;  // the same in every warp
      // slots whose v enters the sum: the allowed ones, or all of them
      const unsigned use =
          pass ? (n == 32 ? 0xffffffffu : (1u << n) - 1u) : live;
      __syncthreads();                  // the previous sub-tile is consumed
      for (int e = tid; e < kSub * L::NVEC; e += kThreads) {
        const int j = e / L::NVEC;
        const int c = (e % L::NVEC) * VEC;
        const bool in_d = c < hd;
        const bool kin = in_d && ((live >> j) & 1u);
        const bool vin = in_d && ((use >> j) & 1u);
        const long long t = t0 + j;
        cp_async16(k_s + j * MAXD + c, kin ? kb + t * ks.s + c : kb, kin);
        cp_async16(v_s + j * MAXD + c, vin ? vb + t * vs.s + c : vb, vin);
      }
      asm volatile("cp.async.commit_group;\n" ::);
      if (!q_ready) {                   // q loads while K and V copy
        for (int e = tid; e < G * MAXD; e += kThreads) {
          const int g = e / MAXD;
          const int d = e % MAXD;
          q_s[e] = d < hd ? load_f32(q + b * qs.b
                                     + (long long)(hk * G + g) * qs.h + d)
                                * scale
                          : 0.0f;
        }
        q_ready = true;
      }
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      __syncthreads();
      seen = true;

      // scores: LPS lanes per slot, kHB heads at a time
      for (int g0 = 0; g0 < G; g0 += kHB) {
        float qr[kHB][L::NV * VEC];
#pragma unroll
        for (int hb = 0; hb < kHB; ++hb) {
          const float* qrow = q_s + min(g0 + hb, G - 1) * MAXD;
#pragma unroll
          for (int iv = 0; iv < L::NV; ++iv)
#pragma unroll
            for (int i = 0; i < VEC; ++i)
              qr[hb][iv * VEC + i] = qrow[(lis + iv * L::LPS) * VEC + i];
        }
#pragma unroll
        for (int j = grp; j < kSub; j += L::GROUPS) {
          float dot[kHB] = {};
#pragma unroll
          for (int iv = 0; iv < L::NV; ++iv) {
            float kf[VEC];
            to_f32(*reinterpret_cast<const uint4*>(
                       k_s + j * MAXD + (lis + iv * L::LPS) * VEC),
                   kf);
#pragma unroll
            for (int hb = 0; hb < kHB; ++hb)
#pragma unroll
              for (int i = 0; i < VEC; ++i)
                dot[hb] = fmaf(qr[hb][iv * VEC + i], kf[i], dot[hb]);
          }
#pragma unroll
          for (int off = L::LPS / 2; off > 0; off >>= 1)
#pragma unroll
            for (int hb = 0; hb < kHB; ++hb)
              dot[hb] += __shfl_xor_sync(0xffffffffu, dot[hb], off);
          if (lis == 0) {
#pragma unroll
            for (int hb = 0; hb < kHB; ++hb) {
              if (g0 + hb >= G) break;
              float s = -INFINITY;        // not a slot of this split
              if (j < n) s = ((live >> j) & 1u) ? dot[hb] : kMasked;
              p_s[(g0 + hb) * kSub + j] = s;
            }
          }
        }
      }
      __syncthreads();

      // online softmax, one warp per head, one lane per slot
      for (int g = warp; g < G; g += kWarps) {
        const float s = p_s[g * kSub + lane];
        float mx = s;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_old = m_s[g];
        const float m_new = fmaxf(m_old, mx);
        const float p = expf(s - m_new);
        float sum = p;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, off);
        p_s[g * kSub + lane] = p;
        if (lane == 0) {
          const float corr = expf(m_old - m_new);
          c_s[g] = corr;
          l_s[g] = l_s[g] * corr + sum;
          m_s[g] = m_new;
        }
      }
      __syncthreads();

      // rescale and accumulate: kHB heads x one vector of v per thread
      const int n_items = (G + kHB - 1) / kHB * L::NVEC;
      for (int it = tid; it < n_items; it += kThreads) {
        const int c = (it % L::NVEC) * VEC;
        const int g0 = (it / L::NVEC) * kHB;
        if (c >= hd) continue;
        float a[kHB][VEC];
#pragma unroll
        for (int hb = 0; hb < kHB; ++hb) {
          const int g = min(g0 + hb, G - 1);
          const float corr = c_s[g];
#pragma unroll
          for (int i = 0; i < VEC; ++i)
            a[hb][i] = acc_s[g * MAXD + c + i] * corr;
        }
        for (unsigned bits = use; bits; bits &= bits - 1) {
          const int j = __ffs(bits) - 1;
          float vf[VEC];
          to_f32(*reinterpret_cast<const uint4*>(v_s + j * MAXD + c), vf);
#pragma unroll
          for (int hb = 0; hb < kHB; ++hb) {
            const float p = p_s[min(g0 + hb, G - 1) * kSub + j];
#pragma unroll
            for (int i = 0; i < VEC; ++i) a[hb][i] = fmaf(p, vf[i], a[hb][i]);
          }
        }
#pragma unroll
        for (int hb = 0; hb < kHB; ++hb) {
          if (g0 + hb >= G) break;
#pragma unroll
          for (int i = 0; i < VEC; ++i)
            acc_s[(g0 + hb) * MAXD + c + i] = a[hb][i];
        }
      }
    }
    if (seen || pass) break;
    // this split saw no allowed slot: has the row one elsewhere?
    int row_live = 0;
    for (int t = tid; t < T_; t += kThreads) row_live |= allowed(pb[t]);
    if (__syncthreads_or(row_live)) break;
  }
  __syncthreads();

  // this split's partials: m and l always, acc where it saw a slot
  const long long cell = ((long long)b * gridDim.y + hk) * gridDim.x + split;
  if (seen) {
    float* pa = part_acc + cell * G * hd;
    for (int e = tid; e < G * hd; e += kThreads)
      pa[e] = acc_s[(e / hd) * MAXD + e % hd];
  }
  float* pml = part_ml + cell * 2 * G;
  for (int g = tid; g < G; g += kThreads) {
    pml[2 * g] = m_s[g];
    pml[2 * g + 1] = l_s[g];
  }
}

// Merges the splits of one (q head, b, kv head): weights exp(m - max m)
// (0 for a split that saw no slot), o = sum w acc / sum w l, summed in
// split order. blockIdx.x = q head within the group, blockIdx.y =
// b * Hkv + kv head; 64 threads, each one 4-dim vector of o.
template <typename T>
__global__ void __launch_bounds__(kMergeThreads)
decode_attention_kernel_merge(const float* __restrict__ part_acc,
                              const float* __restrict__ part_ml,
                              T* __restrict__ o, float* __restrict__ lse,
                              int n_split, int G, int hd) {
  __shared__ float w_s[kMaxSplits];
  __shared__ float l_s[kMaxSplits];
  __shared__ int live_s[kMaxSplits];
  __shared__ int n_live_s;
  __shared__ float den_s;
  const int g = blockIdx.x;
  const long long row = blockIdx.y;
  const int tid = threadIdx.x;
  const float* ml = part_ml + row * n_split * 2 * G;
  const float* pa = part_acc + row * n_split * G * hd;

  if (tid < 32) {
    float M = -INFINITY;
    for (int s = tid; s < n_split; s += 32) {
      const float m = __ldcg(ml + ((long long)s * G + g) * 2);
      w_s[s] = m;
      l_s[s] = __ldcg(ml + ((long long)s * G + g) * 2 + 1);
      M = fmaxf(M, m);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, off));
    float den = 0.0f;
    int n_live = 0;
    for (int s0 = 0; s0 < n_split; s0 += 32) {  // 32 splits at a time
      const int s = s0 + tid;
      const bool seen = s < n_split && w_s[s] != -INFINITY;
      const float w = seen ? expf(w_s[s] - M) : 0.0f;
      float wl = seen ? w * l_s[s] : 0.0f;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        wl += __shfl_xor_sync(0xffffffffu, wl, off);
      den += wl;
      const unsigned ball = __ballot_sync(0xffffffffu, seen);
      if (seen) live_s[n_live + __popc(ball & ((1u << tid) - 1u))] = s;
      if (s < n_split) w_s[s] = w;
      n_live += __popc(ball);
    }
    if (tid == 0) {
      n_live_s = n_live;
      den_s = (den == 0.0f) ? 1.0f : den;
      if (lse != nullptr) lse[row * G + g] = M + logf(den_s);
    }
  }
  __syncthreads();
  const int n_live = n_live_s;
  const float den = den_s;
  for (int c = tid * 4; c < hd; c += kMergeThreads * 4) {
    float out[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int i0 = 0; i0 < n_live; i0 += kMergeBatch) {
      float4 a[kMergeBatch];
      float w[kMergeBatch];
#pragma unroll
      for (int u = 0; u < kMergeBatch; ++u) {  // every load in flight
        if (i0 + u < n_live) {
          const int s = live_s[i0 + u];
          a[u] = __ldcg(reinterpret_cast<const float4*>(
              pa + ((long long)s * G + g) * hd + c));
          w[u] = w_s[s];
        }
      }
#pragma unroll
      for (int u = 0; u < kMergeBatch; ++u) {  // then summed in order
        if (i0 + u < n_live) {
          out[0] = fmaf(w[u], a[u].x, out[0]);
          out[1] = fmaf(w[u], a[u].y, out[1]);
          out[2] = fmaf(w[u], a[u].z, out[2]);
          out[3] = fmaf(w[u], a[u].w, out[3]);
        }
      }
    }
    T* op = o + (row * G + g) * hd + c;  // o is (B, Hq, hd), contiguous
#pragma unroll
    for (int i = 0; i < 4; ++i) op[i] = from_f32<T>(out[i] / den);
  }
}

template <typename T, int MAXD>
int launch_typed(const void* q, const void* k, const void* v,
                 const int* kv_pos, const int* q_pos, void* o, float* lse,
                 float* part_acc, float* part_ml, Strides qs, Strides ks,
                 Strides vs, int B, int T_, int Hq, int Hkv, int hd,
                 int window, int n_split, int chunk, cudaStream_t stream) {
  const int G = Hq / Hkv;
  const size_t smem = smem_bytes(MAXD, G, sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(
      decode_attention_kernel<T, MAXD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_attention_kernel<T, MAXD>
      <<<dim3(n_split, Hkv, B), kThreads, smem, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), kv_pos, q_pos, part_acc, part_ml, qs, ks,
          vs, T_, hd, G, window, chunk, 1.0f / sqrtf((float)hd));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_attention_kernel_merge<T><<<dim3(G, Hkv * B), kMergeThreads, 0,
                                     stream>>>(part_acc, part_ml,
                                               static_cast<T*>(o), lse,
                                               n_split, G, hd);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dispatch(const void* q, const void* k, const void* v,
                    const int* kv_pos, const int* q_pos, void* o,
                    float* lse, float* part_acc, float* part_ml, Strides qs,
                    Strides ks, Strides vs, int B, int T_, int Hq, int Hkv,
                    int hd, int window, int n_split, int chunk,
                    cudaStream_t stream) {
#define DECODE_LAUNCH(MAXD)                                                 \
  launch_typed<T, MAXD>(q, k, v, kv_pos, q_pos, o, lse, part_acc, part_ml,  \
                        qs, ks, vs, B, T_, Hq, Hkv, hd, window, n_split,    \
                        chunk, stream)
  if (hd <= 64) return DECODE_LAUNCH(64);
  if (hd <= 128) return DECODE_LAUNCH(128);
  return DECODE_LAUNCH(256);
#undef DECODE_LAUNCH
}

int maxd_of(int hd) { return hd <= 64 ? 64 : hd <= 128 ? 128 : 256; }

}  // namespace

extern "C" {

// Launches on `stream`; returns a cudaError_t (0 = ok). q (B,Hq,hd) and
// k, v (B,T,Hkv,hd) are device pointers with the given element strides
// (for q the sequence stride is unused) and a contiguous head dim; k and
// v must be 16-byte aligned with strides that are multiples of 16 bytes.
// kv_pos (B,T) and q_pos (B,) are contiguous int32; o (B,Hq,hd) is
// contiguous; lse, when not null, is a contiguous (B,Hq) float32 output
// of each row's natural log-sum-exp of the scaled scores. part_acc holds B * Hkv * n_split * Hq / Hkv * hd floats and
// part_ml B * Hkv * n_split * 2 * Hq / Hkv floats of scratch. The cache
// is cut into n_split <= 256 splits of `chunk` slots (a multiple of 32;
// the last may be short; none empty). dtype: 0 = float32, 1 = bfloat16.
// hd must be a multiple of 8 up to 256, Hq a multiple of Hkv, and the
// block's shared memory (2 * 32 * MAXD elements of K and V, 2 * G * MAXD
// + 32 * G + 3 * G floats; MAXD = 64, 128 or 256 >= hd, G = Hq / Hkv) at
// most 227 KB. Two kernels run: the splits, then their merge.
int decode_attention_launch(const void* q, const void* k, const void* v,
                            const int* kv_pos, const int* q_pos, void* o,
                            void* lse, void* part_acc, void* part_ml,
                            long long qsb,
                            long long qsh, long long ksb, long long kss,
                            long long ksh, long long vsb, long long vss,
                            long long vsh, int B, int T_, int Hq, int Hkv,
                            int hd, int window, int n_split, int chunk,
                            int dtype, void* stream) {
  const int esize = dtype == 0 ? 4 : 2;
  if (hd <= 0 || hd > 256 || hd % 8 || Hkv <= 0 || Hq % Hkv || T_ <= 0 ||
      B > 65535 || (long long)B * Hkv > 65535 || Hq / Hkv > 65535 ||
      (dtype != 0 && dtype != 1) || n_split <= 0 || n_split > kMaxSplits ||
      chunk <= 0 || chunk % kSub ||
      (long long)(n_split - 1) * chunk >= T_ ||
      (long long)n_split * chunk < T_ ||
      smem_bytes(maxd_of(hd), Hq / Hkv, esize) > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  const int vec = 16 / esize;
  for (long long s : {ksb, kss, ksh, vsb, vss, vsh})
    if (s % vec) return static_cast<int>(cudaErrorMisalignedAddress);
  if (reinterpret_cast<uintptr_t>(k) % 16 ||
      reinterpret_cast<uintptr_t>(v) % 16 ||
      reinterpret_cast<uintptr_t>(part_acc) % 16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (B <= 0 || Hq <= 0) return 0;
  const Strides qs{qsb, 0, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pa = static_cast<float*>(part_acc);
  float* pm = static_cast<float*>(part_ml);
  float* ls = static_cast<float*>(lse);
  if (dtype == 0)
    return launch_dispatch<float>(q, k, v, kv_pos, q_pos, o, ls, pa, pm, qs,
                                  ks, vs, B, T_, Hq, Hkv, hd, window,
                                  n_split, chunk, st);
  return launch_dispatch<__nv_bfloat16>(q, k, v, kv_pos, q_pos, o, ls, pa,
                                        pm, qs, ks, vs, B, T_, Hq, Hkv, hd,
                                        window, n_split, chunk, st);
}

const char* decode_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
