// Causal, GQA-aware flash attention (forward) for Hopper (sm_90a).
//
//   out[b, h, i] = sum_j softmax_j(scale * q[b, h, i] . k[b, h / g, j]) v[b, h / g, j]
//
// q (B, Hq, T, D), k and v (B, Hkv, S, D), all contiguous, float32 or
// bfloat16 (one type for all four); g = Hq / Hkv. Query row i sits at the
// absolute key position (S - T) + i (suffix alignment: chunked prefill
// against a cache). With `causal`, key j is visible to row i when
// j <= (S - T) + i. Scores and the softmax state are float32; in bfloat16
// the probabilities are rounded to bfloat16 before the product with v, as
// the reference rounds them (`p.astype(v.dtype)`). A row that sees no key
// gives 0 (the reference kernel's `l == 0 -> norm 0`), not NaN.
//
// Replaces: src/repro/kernels/flash_attention/flash_attention.py ·
// flash_attention_pallas (grid (B, Hq, q blocks, kv blocks) with the kv
// axis sequential and the online-softmax state carried in VMEM, MXU
// products, causal kv blocks skipped with pl.when).
//
// Bound: operations at prefill shapes. Causal work is
// 4 B Hq D (T S - T (T - 1) / 2) flops (two products) against
// 2 B (Hq T + 2 Hkv S) D elements moved (each input read once, out written
// once): at T = S = 512, D = 128 about 64 flops a byte.
//
// Design (simple first; no tensor cores yet):
// * One CTA per (q tile of kBQ = 64 rows, q head, batch), 256 threads as a
//   16 x 16 grid: thread (ty, tx) owns score rows ty + 16 i (i < 4) and key
//   columns tx + 16 j (j < 2) of a tile, and output columns tx + 16 j of
//   the same rows. A row's 16 threads are one half-warp, so its max and sum
//   are width-16 shuffles.
// * The q tile stays in shared memory; key tiles of kBK = 32 rows of K and
//   V are staged there in float32 from the GQA head h / g (no replication
//   in device memory). Q and K rows are padded to D + 1 floats so that the
//   16 key columns of a half-warp fall in 16 banks.
// * Online softmax per tile: m_new = max(m, tile max), alpha = exp(m -
//   m_new), p = exp(s - m_new) (0 where masked), l = l alpha + sum p, acc =
//   acc alpha + p v, with m starting at -1e30 as in the reference kernel.
//   Causal key tiles past the q tile's last row are never visited; the
//   diagonal tile and the key padding are masked on absolute indices.
// * Products are float32 FMAs on the CUDA cores (bf16 products are exact in
//   float32). wgmma / mma.sync, TMA and warp specialisation are the next
//   step for speed.
// * D = 64 and D = 128 are compiled with the head dim fixed; any other D up
//   to 256 runs a generic instance. Larger D is refused.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;           // query rows of a CTA
constexpr int kBK = 32;           // keys of a tile
constexpr int kThreads = 256;     // 16 x 16
constexpr int kRowsPer = kBQ / 16;
constexpr int kColsPer = kBK / 16;
constexpr int kMaxD = 256;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// p as it enters the product with v: rounded to v's type, back in float32.
template <typename T> __device__ __forceinline__ float as_v_type(float p) {
  return from_f32<float>(to_f32(from_f32<T>(p)));
}

__host__ __device__ constexpr int smem_floats(int d) {
  return kBQ * (d + 1) + kBK * (d + 1) + kBK * d + kBQ * (kBK + 1);
}

// kD > 0: the head dim is kD; kD == 0: the head dim is d_rt <= kMaxD.
template <typename T, int kD>
__global__ void __launch_bounds__(kThreads)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          T* __restrict__ out, int hq, int hkv, int t, int s, int d_rt, int causal,
          float scale) {
  constexpr int kDCap = kD > 0 ? kD : kMaxD;
  constexpr int kOutPer = kDCap / 16;   // output columns a thread owns
  const int d = kD > 0 ? kD : d_rt;
  const int ld = d + 1;
  extern __shared__ float smem[];
  float* qs = smem;                     // kBQ x ld
  float* ks = qs + kBQ * ld;            // kBK x ld
  float* vs = ks + kBK * ld;            // kBK x d
  float* ps = vs + kBK * d;             // kBQ x (kBK + 1)

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const long long q_off = static_cast<long long>(s) - t;
  const T* qg = q + (static_cast<long long>(b) * hq + h) * t * d;
  const T* kg = k + (static_cast<long long>(b) * hkv + hk) * s * d;
  const T* vg = v + (static_cast<long long>(b) * hkv + hk) * s * d;
  T* og = out + (static_cast<long long>(b) * hq + h) * t * d;

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  for (int e = tid; e < kBQ * d; e += kThreads) {
    const int r = e / d;
    const int c = e - r * d;
    qs[r * ld + c] = q0 + r < t ? to_f32(qg[static_cast<long long>(q0 + r) * d + c]) : 0.f;
  }

  float m[kRowsPer], l[kRowsPer], acc[kRowsPer][kOutPer];
#pragma unroll
  for (int i = 0; i < kRowsPer; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kOutPer; ++j) acc[i][j] = 0.f;
  }

  long long n_tiles = (s + kBK - 1) / kBK;
  if (causal) {
    const long long last = q_off + q0 + kBQ - 1;   // the tile's last absolute row
    n_tiles = last < 0 ? 0 : min(n_tiles, last / kBK + 1);
  }

  for (long long kt = 0; kt < n_tiles; ++kt) {
    const long long k0 = kt * kBK;
    __syncthreads();   // the q tile is in; the last tile's ks / vs / ps are read
    for (int e = tid; e < kBK * d; e += kThreads) {
      const int r = e / d;
      const int c = e - r * d;
      const bool in = k0 + r < s;
      const long long at = (k0 + r) * d + c;
      ks[r * ld + c] = in ? to_f32(kg[at]) : 0.f;
      vs[r * d + c] = in ? to_f32(vg[at]) : 0.f;
    }
    __syncthreads();

    float sc[kRowsPer][kColsPer];
#pragma unroll
    for (int i = 0; i < kRowsPer; ++i) {
#pragma unroll
      for (int j = 0; j < kColsPer; ++j) sc[i][j] = 0.f;
    }
#pragma unroll 4
    for (int c = 0; c < d; ++c) {
      float qv[kRowsPer], kv[kColsPer];
#pragma unroll
      for (int i = 0; i < kRowsPer; ++i) qv[i] = qs[(ty + 16 * i) * ld + c];
#pragma unroll
      for (int j = 0; j < kColsPer; ++j) kv[j] = ks[(tx + 16 * j) * ld + c];
#pragma unroll
      for (int i = 0; i < kRowsPer; ++i) {
#pragma unroll
        for (int j = 0; j < kColsPer; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
      }
    }

#pragma unroll
    for (int i = 0; i < kRowsPer; ++i) {
      const int r = ty + 16 * i;
      const long long qpos = q_off + q0 + r;
      bool ok[kColsPer];
      float rmax = kNegInf;
#pragma unroll
      for (int j = 0; j < kColsPer; ++j) {
        const long long kidx = k0 + tx + 16 * j;
        ok[j] = kidx < s && (!causal || kidx <= qpos);
        sc[i][j] = ok[j] ? sc[i][j] * scale : kNegInf;
        rmax = fmaxf(rmax, sc[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off, 16));
      }
      const float m_new = fmaxf(m[i], rmax);
      const float alpha = expf(m[i] - m_new);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < kColsPer; ++j) {
        const float p = ok[j] ? expf(sc[i][j] - m_new) : 0.f;
        rsum += p;
        ps[r * (kBK + 1) + tx + 16 * j] = as_v_type<T>(p);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        rsum += __shfl_xor_sync(0xffffffffu, rsum, off, 16);
      }
      l[i] = l[i] * alpha + rsum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kOutPer; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();   // every row's p is in ps

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float pv[kRowsPer];
#pragma unroll
      for (int i = 0; i < kRowsPer; ++i) pv[i] = ps[(ty + 16 * i) * (kBK + 1) + kk];
#pragma unroll
      for (int j = 0; j < kOutPer; ++j) {
        const int col = tx + 16 * j;
        if (kD > 0 || col < d) {
          const float vv = vs[kk * d + col];
#pragma unroll
          for (int i = 0; i < kRowsPer; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPer; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= t) continue;
    const float norm = l[i] > 0.f ? 1.f / l[i] : 0.f;
#pragma unroll
    for (int j = 0; j < kOutPer; ++j) {
      const int col = tx + 16 * j;
      if (kD > 0 || col < d) {
        og[static_cast<long long>(r) * d + col] = from_f32<T>(acc[i][j] * norm);
      }
    }
  }
}

template <typename T, int kD>
int launch(const void* q, const void* k, const void* v, void* out, int b, int hq, int hkv,
           int t, int s, int d, int causal, float scale, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(smem_floats(d)) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd<T, kD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((t + kBQ - 1) / kBQ, hq, b);
  flash_fwd<T, kD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), hq, hkv, t, s, d, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, void* out, int b, int hq,
               int hkv, int t, int s, int d, int causal, float scale, cudaStream_t stream) {
  if (d == 64) return launch<T, 64>(q, k, v, out, b, hq, hkv, t, s, d, causal, scale, stream);
  if (d == 128) return launch<T, 128>(q, k, v, out, b, hq, hkv, t, s, d, causal, scale, stream);
  return launch<T, 0>(q, k, v, out, b, hq, hkv, t, s, d, causal, scale, stream);
}

}  // namespace

// Launches the forward pass on `stream`. dtype: 0 = float32, 1 = bfloat16.
// Returns the cudaError_t of the launch (0 on success); refuses shapes the
// kernel does not take with cudaErrorInvalidValue. The caller checks types,
// devices and contiguity.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                   int dtype, int b, int hq, int hkv, int t, int s, int d,
                                   int causal, float scale, void* stream) {
  if (b <= 0 || hq <= 0 || hkv <= 0 || t <= 0 || s <= 0 || d <= 0 || d > kMaxD ||
      hq % hkv != 0 || b > 65535 || hq > 65535) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_d<float>(q, k, v, out, b, hq, hkv, t, s, d, causal, scale, st);
  if (dtype == 1) {
    return dispatch_d<__nv_bfloat16>(q, k, v, out, b, hq, hkv, t, s, d, causal, scale, st);
  }
  return cudaErrorInvalidValue;
}
