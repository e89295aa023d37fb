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
// Two instances; the caller picks one by dtype and head dim
// (kernels/flash_attention/ops.py · design):
// * wgmma: bfloat16 at D = 64, 80, 128 and 192: the head dims of the
//   full-width configs with standard attention, zamba2's shared block (80)
//   and MLA (192; the caller pads v to it, as the reference does). Tensor
//   cores, TMA, a producer warpgroup. C entry flash_attention_fwd_wgmma.
// * simt: float32 (on the tensor cores it would be TF32) and any other D up
//   to 256. float32 FMAs on the CUDA cores. C entry flash_attention_fwd.
//
// Bound at the serve path's prefill (B 8, Hq 32, Hkv 8, T = S = 504, D 128,
// bf16, causal): bytes, narrowly. q, k, v read once and out written once
// are 82.6 MB, 0.0246 ms at 3.35 TB/s; the causal work, 4 B Hq D (T S -
// T (T - 1) / 2) = 1.67e10 flops, is 0.0169 ms at the 989 TFLOP/s bf16
// tensor rate. So the products must run on the tensor cores, and the loads
// must stream under them rather than between them. MLA's prefill (B 8, Hq =
// Hkv = 128, T = S = 512, D 192) is bytes by 2.3x (805 MB, 0.240 ms).
//
// wgmma design:
// * Persistent CTAs, one an SM: a CTA works through items of 128 query rows
//   of one (batch, q head); a head's q tiles are neighbours, the
//   causal-heaviest first, handed out in a snake so that the CTAs' sums
//   stay close and the CTAs that share a head's K and V run at once. Each
//   CTA has two consumer warpgroups of 64 rows and a producer warpgroup, of
//   which one thread issues the loads; setmaxnreg moves registers from the
//   producer (40) to the consumers (232): 384 threads enter with 168 each,
//   and 128 x 40 + 256 x 232 is the same pool (with 288 threads, one
//   producer warp, the entry count stays 168 and the consumers' request
//   could never be met). One CTA's next item loads while it finishes the
//   last, so no SM waits on a CTA's start or tail.
// * Bytes: the producer loads each item's q tile into the free one of two
//   q buffers and streams key tiles of K and V through a 2-stage ring in
//   shared memory by TMA, with full and empty mbarriers for K and for V, so
//   loads run ahead of the products, across items too. The tensor maps are
//   3-D, (D, T or S, B * H), 128-byte swizzled in panels of 64 columns: K
//   and V are read from kv head h / g with no copy per q head (the g q heads
//   of a group share them in L2), and keys past S read as zero rather than
//   as the next head's keys. A buffer is freed by one arrival from each
//   consumer warp after its own wait, so no warp can fall a phase behind.
// * Shapes by D (Smem<kD>; 192 KB of shared memory at 80, 128 and 192):
//   D = 64 and 128: 1 and 2 panels, 128-key tiles. D = 80: 2 panels, the
//   second holding columns 64-79 and the TMA's zero fill past the maps'
//   inner dim of 80 (rows of 160 bytes), so S needs 5 k-steps and P V runs
//   at N = 80 (an MN-major operand takes N = 80 across the panel boundary;
//   N = 128 over the zero columns was slower). D = 192: 3 panels and
//   64-key tiles, since two q buffers and a ring of 128-key tiles would
//   take 288 KB of the 227 a block may use; S is m64n64k16 over 12 k-steps
//   and P V m64n192k16 (O 96 + S 32 + P 16 registers a consumer thread).
// * Flops: S = Q K^T on wgmma m64n{keys}k16 with both operands in shared
//   memory (K-major); O += P V on wgmma m64n{D}k16 with P from registers
//   (the score accumulator's layout is the A operand's) and V as an
//   MN-major operand. Accumulators are float32. A warpgroup's step issues S
//   of tile kt and P V of tile kt - 1, so the tensor cores run while the
//   softmax of tile kt does; S, P and O stay in registers without spills. A
//   causal tile past all of a warpgroup's rows is only waited for and
//   released, not multiplied. (Named barriers that alternate the two
//   warpgroups' steps made ptxas spill and cost time on the card; they are
//   not used.)
// * Stores: O goes over the warp's own 16 rows of its q buffer (the 128-byte
//   swizzle of the q map) and out by one TMA store a panel, issued by the
//   warp's lane 0, which leaves out rows past T; the q buffer is freed once
//   the stores have read it. Stored from registers, 4 bytes a thread, O
//   cost MLA's prefill 17% and the serve prefill 12% more time on the H100;
//   at D = 80, whose 160-byte rows cross 128-byte lines, the TMA stores
//   took 6% more, so D = 80 stores from registers.
// * Online softmax runs in the accumulator's registers: a row lives in one
//   quad, so its max and sum are two shuffles. The numerics are the simt
//   instance's: scores in f32, scaled; m from -1e30; masks on absolute
//   indices, applied only on the diagonal tile and the key padding; causal
//   key tiles past the CTA's last row skipped; p rounded to bf16 for the
//   product while l sums the unrounded p; out = l > 0 ? acc / l : 0, stored
//   in bf16 with the T edge masked. m is kept in units of log2 (the max of
//   s scale log2 e), so that p = 2^(s scale log2 e - m) is one FFMA and the
//   hardware's ex2.approx (a relative error near 2^-22, far under p's bf16
//   rounding), where scaling s, subtracting m and __expf took two more.
//
// simt design (written to be right first):
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
//   float32). D = 64 and D = 128 are compiled with the head dim fixed; any
//   other D up to 256 runs a generic instance. Larger D is refused.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

#include "hopper.cuh"

namespace simt {


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

}  // namespace simt


namespace wgmma {

constexpr int kBQ = 128;                    // query rows of a CTA: two warpgroups of 64
constexpr int kConsumers = 2;               // consumer warpgroups
constexpr int kConsumerWarps = 4 * kConsumers;   // arrivals that free a buffer
constexpr int kThreads = 128 * (kConsumers + 1);   // + the producer warpgroup
// setmaxnreg: the CTA's 384 x 168 registers are split 128 x 40 (producer)
// + 256 x 232 (consumers).
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kPanelCols = 64;              // bf16 columns of one 128-byte swizzled row
constexpr int kRowBytes = 128;
constexpr int kStages = 2;                  // K/V ring depth
constexpr int kStoreRows = 16;              // rows of a warp's TMA store of O
constexpr int kSmemLimit = 232448;          // bytes of shared memory a block may use
constexpr float kNegInf = -1e30f;

// Tile shapes at head dim kD, and byte offsets in shared memory (from a
// 1024-byte aligned base: the 128-byte swizzle repeats every 8 rows of 128
// bytes). A tile of r rows is kPanels panels of r rows x 128 bytes, each
// holding 64 columns; at D = 80 the second panel's columns 80-127 are the
// TMA's zero fill. A key tile is 128 keys, 64 at D = 192, where two q
// buffers and a 2-stage ring of 128-key tiles would take 288 KB.
template <int kD>
struct Smem {
  static constexpr int kPanels = (kD + kPanelCols - 1) / kPanelCols;
  static constexpr int kBK = kD > 128 ? 64 : 128;   // keys of a tile: S is m64n{kBK}
  static constexpr int kQPanelBytes = kBQ * kRowBytes;
  static constexpr int kKVPanelBytes = kBK * kRowBytes;
  static constexpr int kQBytes = kPanels * kQPanelBytes;
  static constexpr int kTileBytes = kPanels * kKVPanelBytes;   // a K or V tile
  // O leaves by TMA stores from the q buffer, but at D = 80 from registers
  // (rows of 160 bytes; see the header).
  static constexpr bool kTmaStore = kD % kPanelCols == 0;
  static constexpr int kQ = 0;                          // two q buffers
  static constexpr int kK = kQ + 2 * kQBytes;
  static constexpr int kV = kK + kStages * kTileBytes;
  static constexpr int kBars = kV + kStages * kTileBytes;
  // q full, q empty a q buffer; k full, v full, k empty, v empty a stage.
  static constexpr int kNumBars = 4 + 4 * kStages;
  static constexpr int kAlloc = kBars + 8 * kNumBars + 1024;   // + slack to align the base
  static_assert(kD % 16 == 0 && kD <= 256, "K steps of 16 columns; wgmma's N is at most 256");
  static_assert(kAlloc <= kSmemLimit, "two q buffers and the K/V ring fit a block");
};

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// Waits until at most N committed groups of products are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}


// Keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous products.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (all in 16-byte units).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d (64 x N, f32) = a . b (+ d when `accumulate`): a (64 x 16) and b
// (16 x N) in shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                          int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                          int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d (64 x N, f32) += a . b: a (64 x 16) in registers, b (16 x N) in
// shared memory, MN-major (the transpose bit).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                          uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n80(float (&d)[40], const uint32_t (&a)[4],
                                          uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39"
      "}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                          uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n192(float (&d)[96], const uint32_t (&a)[4],
                                          uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, "
      "{%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <int kN>
__device__ __forceinline__ void s_product(float (&d)[kN / 2], uint64_t desc_a, uint64_t desc_b,
                                          int accumulate) {
  if constexpr (kN == 128) {
    wgmma_ss_n128(d, desc_a, desc_b, accumulate);
  } else {
    static_assert(kN == 64, "key tiles of 64 or 128");
    wgmma_ss_n64(d, desc_a, desc_b, accumulate);
  }
}

template <int kN>
__device__ __forceinline__ void pv_product(float (&o)[kN / 2], const uint32_t (&a)[4],
                                           uint64_t desc_b) {
  if constexpr (kN == 64) {
    wgmma_rs_n64(o, a, desc_b);
  } else if constexpr (kN == 80) {
    wgmma_rs_n80(o, a, desc_b);
  } else if constexpr (kN == 128) {
    wgmma_rs_n128(o, a, desc_b);
  } else {
    static_assert(kN == 192, "O += P V at N = 64, 80, 128 or 192");
    wgmma_rs_n192(o, a, desc_b);
  }
}

// S = Q K^T of one tile (64 x kBK per warpgroup) over D in steps of 16
// (32 bytes inside a 128-byte panel row); one commit group.
template <int kD>
__device__ __forceinline__ void issue_s(float (&sc)[Smem<kD>::kBK / 2], uint32_t q_base,
                                        uint32_t k_base) {
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    const uint32_t at = (kk % 4) * 32;
    const uint64_t a = smem_desc(q_base + (kk / 4) * Smem<kD>::kQPanelBytes + at, 16,
                                 8 * kRowBytes);
    const uint64_t b = smem_desc(k_base + (kk / 4) * Smem<kD>::kKVPanelBytes + at, 16,
                                 8 * kRowBytes);
    s_product<Smem<kD>::kBK>(sc, a, b, kk > 0);
  }
  wgmma_commit();
}

// O += P V of one tile over its keys in steps of 16 (16 rows of 128 bytes);
// one commit group.
template <int kD>
__device__ __forceinline__ void issue_pv(float (&o)[kD / 2],
                                         const uint32_t (&pa)[Smem<kD>::kBK / 16][4],
                                         uint32_t v_base) {
#pragma unroll
  for (int kk = 0; kk < Smem<kD>::kBK / 16; ++kk) {
    pv_product<kD>(o, pa[kk], smem_desc(v_base + kk * 16 * kRowBytes, Smem<kD>::kKVPanelBytes,
                                        8 * kRowBytes));
  }
  wgmma_commit();
}

// 2^x by the hardware's approximation (ex2.approx: relative error near
// 2^-22; 0 at -inf).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Online softmax of one tile's scores in place (sc becomes p), updating the
// row state m and l and returning the factor alpha that rescales O. m is
// the running max of the scaled scores in units of log2 (scale log2 e s),
// so that p = 2^(s scale log2 e - m) is one FFMA and one ex2. Keys past
// `lim[half]` are masked: past S, or (causal) past the row's absolute
// position; only tiles that reach past some row's limit (`edge`: the
// diagonal and the key padding) test.
template <int kBK>
__device__ __forceinline__ void softmax_tile(float (&sc)[kBK / 2], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], bool edge, const int (&lim)[2],
                                             int c0, float scale_log2) {
  float rmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < kBK / 2; ++i) {
    const int hf = (i >> 1) & 1;
    if (edge && 8 * (i >> 2) + c0 + (i & 1) > lim[hf]) sc[i] = -INFINITY;
    rmax[hf] = fmaxf(rmax[hf], sc[i]);
  }
  float rsum[2] = {0.f, 0.f};
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    rmax[hf] = fmaxf(rmax[hf], __shfl_xor_sync(0xffffffffu, rmax[hf], 1));
    rmax[hf] = fmaxf(rmax[hf], __shfl_xor_sync(0xffffffffu, rmax[hf], 2));
    const float m_new = fmaxf(m[hf], rmax[hf] * scale_log2);
    alpha[hf] = ex2(m[hf] - m_new);
    m[hf] = m_new;
  }
#pragma unroll
  for (int i = 0; i < kBK / 2; ++i) {
    const int hf = (i >> 1) & 1;
    const float p = ex2(fmaf(sc[i], scale_log2, -m[hf]));   // 0 where masked (-inf)
    rsum[hf] += p;
    sc[i] = p;
  }
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    rsum[hf] += __shfl_xor_sync(0xffffffffu, rsum[hf], 1);
    rsum[hf] += __shfl_xor_sync(0xffffffffu, rsum[hf], 2);
    l[hf] = l[hf] * alpha[hf] + rsum[hf];
  }
}

// O (through the previous tile) to the new max, and p to bf16 in the A
// operand's layout.
template <int kD>
__device__ __forceinline__ void rescale_and_pack(float (&o)[kD / 2],
                                                 const float (&alpha)[2],
                                                 const float (&sc)[Smem<kD>::kBK / 2],
                                                 uint32_t (&pa)[Smem<kD>::kBK / 16][4]) {
#pragma unroll
  for (int i = 0; i < kD / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
#pragma unroll
  for (int kk = 0; kk < Smem<kD>::kBK / 16; ++kk) {
#pragma unroll
    for (int j = 0; j < 4; ++j) pa[kk][j] = pack_bf16(sc[8 * kk + 2 * j], sc[8 * kk + 2 * j + 1]);
  }
}

// Work item w (of q_tiles * bh_count) is q tile q_tiles - 1 - w % q_tiles
// of head bh = w / q_tiles (= batch * Hq + q head): a head's q tiles are
// neighbours, the causal-heaviest first, so that the CTAs that share a
// head's K and V run side by side and read them once from device memory
// (L2 serves the rest; ordered q tile major instead, MLA's prefill, whose
// 128 q heads each have their own K and V, took 1.6 times as long on the
// H100). A persistent CTA c takes item r G + c in
// even rounds r and r G + G - 1 - c in odd ones (G CTAs): a snake that
// pairs a heavy tile with a light one, so that the CTAs' sums stay close.
struct Item {
  int bh, q0, n_tiles;
};

__device__ __forceinline__ int item_index(int round) {
  const int g = static_cast<int>(gridDim.x);
  const int c = static_cast<int>(blockIdx.x);
  return round * g + ((round & 1) ? g - 1 - c : c);
}

template <int kBK>
__device__ __forceinline__ Item item_of(int w, int q_tiles, int t, int s, int causal) {
  Item it;
  it.bh = w / q_tiles;
  it.q0 = (q_tiles - 1 - w % q_tiles) * kBQ;
  it.n_tiles = (s + kBK - 1) / kBK;
  if (causal) {
    const int last = (s - t) + min(it.q0 + kBQ, t) - 1;   // the tile's last absolute row
    it.n_tiles = last < 0 ? 0 : min(it.n_tiles, last / kBK + 1);
  }
  return it;
}

template <int kD>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap q_map,
                const __grid_constant__ CUtensorMap k_map,
                const __grid_constant__ CUtensorMap v_map,
                const __grid_constant__ CUtensorMap o_map, __nv_bfloat16* __restrict__ out,
                int hq, int hkv, int bh_count, int q_tiles, int t, int s, int causal,
                float scale_log2) {   // the softmax scale times log2 e
  using L = Smem<kD>;
  constexpr int kBK = L::kBK;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (hopper::smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* q_full = bars;
  uint64_t* q_empty = bars + 2;
  uint64_t* k_full = bars + 4;
  uint64_t* v_full = bars + 4 + kStages;
  uint64_t* k_empty = bars + 4 + 2 * kStages;
  uint64_t* v_empty = bars + 4 + 3 * kStages;
  const int items = q_tiles * bh_count;
  const int q_off = s - t;   // absolute key position of query row 0

  if (threadIdx.x == 0) {
    for (int qb = 0; qb < 2; ++qb) {
      hopper::mbar_init(&q_full[qb], 1);
      hopper::mbar_init(&q_empty[qb], kConsumerWarps);
    }
    for (int st = 0; st < kStages; ++st) {
      hopper::mbar_init(&k_full[st], 1);
      hopper::mbar_init(&v_full[st], 1);
      hopper::mbar_init(&k_empty[st], kConsumerWarps);
      hopper::mbar_init(&v_empty[st], kConsumerWarps);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  if (warp >= 4 * kConsumers) {
    // ---- Producer warpgroup: one thread loads each item's q tile into the
    // free one of two q buffers, and its K and V tiles through the ring,
    // which runs on from one item to the next.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (threadIdx.x == 128 * kConsumers) {
      int g = 0;   // K/V tiles loaded so far
      int j = 0;   // items so far
      for (int r = 0; r * static_cast<int>(gridDim.x) < items; ++r) {
        const int w = item_index(r);
        if (w >= items) continue;
        const Item it = item_of<kBK>(w, q_tiles, t, s, causal);
        const int b = it.bh / hq;
        const int kv_bh = b * hkv + (it.bh - b * hq) / (hq / hkv);
        const int qb = j & 1;
        hopper::mbar_wait(&q_empty[qb], ((j >> 1) & 1) ^ 1);   // the first round passes
        hopper::mbar_arrive_expect_tx(&q_full[qb], L::kQBytes);
#pragma unroll
        for (int p = 0; p < L::kPanels; ++p) {
          hopper::tma_load_3d(smem + L::kQ + qb * L::kQBytes + p * L::kQPanelBytes, &q_map,
                              &q_full[qb], p * kPanelCols, it.q0, it.bh);
        }
        for (int kt = 0; kt < it.n_tiles; ++kt, ++g) {
          const int st = g % kStages;
          const uint32_t parity = ((g / kStages) & 1) ^ 1;
          hopper::mbar_wait(&k_empty[st], parity);
          hopper::mbar_arrive_expect_tx(&k_full[st], L::kTileBytes);
#pragma unroll
          for (int p = 0; p < L::kPanels; ++p) {
            hopper::tma_load_3d(smem + L::kK + st * L::kTileBytes + p * L::kKVPanelBytes,
                                &k_map, &k_full[st], p * kPanelCols, kt * kBK, kv_bh);
          }
          hopper::mbar_wait(&v_empty[st], parity);
          hopper::mbar_arrive_expect_tx(&v_full[st], L::kTileBytes);
#pragma unroll
          for (int p = 0; p < L::kPanels; ++p) {
            hopper::tma_load_3d(smem + L::kV + st * L::kTileBytes + p * L::kKVPanelBytes,
                                &v_map, &v_full[st], p * kPanelCols, kt * kBK, kv_bh);
          }
        }
        ++j;
      }
    }
  } else {
    // ---- Consumer warpgroup wg: query rows q0 + 64 wg + [0, 64) of each item.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
    const int wg = warp / 4;
    const int tid = threadIdx.x % 128;
    const int lane = tid % 32;
    // Accumulator layout (m64nN): register i of a thread holds row
    // r0 + 8 ((i >> 1) & 1) and column 8 (i >> 2) + c0 + (i & 1).
    const int r0 = 16 * (tid / 32) + lane / 4;
    const int c0 = 2 * (lane % 4);

    auto k_base = [&](int g) {
      return hopper::smem_addr(smem + L::kK + (g % kStages) * L::kTileBytes);
    };
    auto v_base = [&](int g) {
      return hopper::smem_addr(smem + L::kV + (g % kStages) * L::kTileBytes);
    };
    auto parity = [](int g) { return static_cast<uint32_t>((g / kStages) & 1); };

    float o[kD / 2];
    float sc[kBK / 2];          // scores of tile kt, then its p
    uint32_t pa[kBK / 16][4];   // p of tile kt - 1 in bf16: the A operand of O += P V
    float m[2], l[2], alpha[2];
    int lim[2];
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) sc[i] = 0.f;

    int g = 0;   // K/V tiles consumed so far
    int j = 0;   // items so far
    for (int r = 0; r * static_cast<int>(gridDim.x) < items; ++r) {
      const int w = item_index(r);
      if (w >= items) continue;
      const Item it = item_of<kBK>(w, q_tiles, t, s, causal);
      const int n = it.n_tiles;
      const int row0 = it.q0 + 64 * wg + r0;   // the thread's first row in the q head
      // Tiles this warpgroup's rows see: causal tiles past its last row are
      // only waited for and released.
      int n_own = n;
      if (causal) {
        const int last = q_off + it.q0 + 64 * wg + 63;
        n_own = last < 0 ? 0 : min(n, last / kBK + 1);
      }
      // Key limits of the thread's two rows in tile kt; true when some row
      // of the warpgroup needs a mask there (the diagonal, the key padding).
      auto limits = [&](int kt) {
        const int k0 = kt * kBK;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          lim[hf] = (causal ? min(s - 1, q_off + row0 + 8 * hf) : s - 1) - k0;
        }
        return k0 + kBK > s || (causal && k0 + kBK - 1 > q_off + it.q0 + 64 * wg);
      };
#pragma unroll
      for (int i = 0; i < kD / 2; ++i) o[i] = 0.f;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        m[hf] = kNegInf;
        l[hf] = 0.f;
      }
      const int qb = j & 1;
      const uint32_t q_base =
          hopper::smem_addr(smem + L::kQ + qb * L::kQBytes) + 64 * wg * kRowBytes;
      hopper::mbar_wait(&q_full[qb], (j >> 1) & 1);

      // Step 0 issues S of tile 0; step kt (1 <= kt < n_own) issues S of
      // tile kt and O += P V of tile kt - 1, whose product runs while the
      // softmax of tile kt does; the last step issues P V of tile n_own - 1.
      if (n_own > 0) {
        hopper::mbar_wait(&k_full[g % kStages], parity(g));
        fence_regs(sc);
        wgmma_fence();
        issue_s<kD>(sc, q_base, k_base(g));
        wgmma_wait<0>();
        fence_regs(sc);
        if (lane == 0) hopper::mbar_arrive(&k_empty[g % kStages]);
        bool edge = limits(0);
        softmax_tile<kBK>(sc, m, l, alpha, edge, lim, c0, scale_log2);
        rescale_and_pack<kD>(o, alpha, sc, pa);

        for (int kt = 1; kt < n_own; ++kt) {
          const int gk = g + kt;
          hopper::mbar_wait(&k_full[gk % kStages], parity(gk));
          hopper::mbar_wait(&v_full[(gk - 1) % kStages], parity(gk - 1));
          fence_regs(sc);
          fence_regs(o);
          wgmma_fence();
          issue_s<kD>(sc, q_base, k_base(gk));
          issue_pv<kD>(o, pa, v_base(gk - 1));
          wgmma_wait<1>();
          fence_regs(sc);
          if (lane == 0) hopper::mbar_arrive(&k_empty[gk % kStages]);
          edge = limits(kt);
          softmax_tile<kBK>(sc, m, l, alpha, edge, lim, c0, scale_log2);
          wgmma_wait<0>();
          fence_regs(o);
          if (lane == 0) hopper::mbar_arrive(&v_empty[(gk - 1) % kStages]);
          rescale_and_pack<kD>(o, alpha, sc, pa);
        }

        const int last = g + n_own - 1;
        hopper::mbar_wait(&v_full[last % kStages], parity(last));
        fence_regs(o);
        wgmma_fence();
        issue_pv<kD>(o, pa, v_base(last));
        wgmma_wait<0>();
        fence_regs(o);
        if (lane == 0) hopper::mbar_arrive(&v_empty[last % kStages]);
      }
      for (int kt = n_own; kt < n; ++kt) {   // tiles past this warpgroup's rows
        const int gk = g + kt;
        hopper::mbar_wait(&k_full[gk % kStages], parity(gk));
        if (lane == 0) hopper::mbar_arrive(&k_empty[gk % kStages]);
        hopper::mbar_wait(&v_full[gk % kStages], parity(gk));
        if (lane == 0) hopper::mbar_arrive(&v_empty[gk % kStages]);
      }
      g += n;
      ++j;

      if constexpr (L::kTmaStore) {
        // Epilogue: out = l > 0 ? acc / l : 0 in bf16, written over the
        // warp's own 16 q rows (their products are done; the 128-byte swizzle
        // of the q map), then stored by the warp's lane 0 with one TMA store a
        // panel, which leaves out rows past T. The q buffer is freed once the
        // stores have read it.
        const int store_row = 64 * wg + kStoreRows * (warp % 4);   // of the item's 128
        uint8_t* const o_rows = smem + L::kQ + qb * L::kQBytes + store_row * kRowBytes;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const float norm = l[hf] > 0.f ? 1.f / l[hf] : 0.f;
          uint8_t* const row = o_rows + (lane / 4 + 8 * hf) * kRowBytes + 4 * (lane % 4);
#pragma unroll
          for (int c = 0; c < kD / 8; ++c) {   // 8 columns: a 16-byte chunk of a panel row
            const int i = 4 * c + 2 * hf;
            *reinterpret_cast<uint32_t*>(row + (c / 8) * L::kQPanelBytes +
                                         (((c % 8) ^ (lane / 4)) * 16)) =
                pack_bf16(o[i] * norm, o[i + 1] * norm);
          }
        }
        hopper::fence_proxy_async_smem();
        __syncwarp();
        if (lane == 0) {
#pragma unroll
          for (int p = 0; p < L::kPanels; ++p) {
            hopper::tma_store_3d(&o_map, o_rows + p * L::kQPanelBytes, p * kPanelCols,
                                 it.q0 + store_row, it.bh);
          }
          hopper::bulk_commit();
          hopper::bulk_wait_read<0>();
          hopper::mbar_arrive(&q_empty[qb]);
        }
      } else {
        // Epilogue at D = 80: out = l > 0 ? acc / l : 0 in bf16 from the
        // registers, 4 bytes a thread, rows past T not stored.
        if (lane == 0) hopper::mbar_arrive(&q_empty[qb]);
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int row = row0 + 8 * hf;
          if (row >= t) continue;
          const float norm = l[hf] > 0.f ? 1.f / l[hf] : 0.f;
          __nv_bfloat16* orow = out + (static_cast<long long>(it.bh) * t + row) * kD;
#pragma unroll
          for (int c = 0; c < kD / 8; ++c) {
            const int i = 4 * c + 2 * hf;
            *reinterpret_cast<__nv_bfloat162*>(orow + 8 * c + c0) =
                __floats2bfloat162_rn(o[i] * norm, o[i + 1] * norm);
          }
        }
      }
    }
  }
}

template <int kD>
int launch(const void* q, const void* k, const void* v, void* out, int b, int hq, int hkv,
           int t, int s, int causal, float scale, cudaStream_t stream) {
  constexpr int kBK = Smem<kD>::kBK;
  CUtensorMap q_map, k_map, v_map, o_map;
  const uint64_t bhq = static_cast<uint64_t>(b) * hq;
  const uint64_t bhkv = static_cast<uint64_t>(b) * hkv;
  if (!hopper::bf16_map_3d(&q_map, q, kD, t, bhq, kPanelCols, kBQ) ||
      !hopper::bf16_map_3d(&k_map, k, kD, s, bhkv, kPanelCols, kBK) ||
      !hopper::bf16_map_3d(&v_map, v, kD, s, bhkv, kPanelCols, kBK) ||
      !hopper::bf16_map_3d(&o_map, out, kD, t, bhq, kPanelCols, kStoreRows)) {
    return cudaErrorInvalidValue;
  }
  const long long q_tiles = (t + kBQ - 1) / kBQ;
  const long long items = q_tiles * static_cast<long long>(bhq);
  if (items > INT_MAX) return cudaErrorInvalidValue;
  int device = 0;
  int sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int blocks = static_cast<int>(items < sms ? items : (sms > 0 ? sms : 1));
  const int smem = Smem<kD>::kAlloc;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_wgmma<kD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_fwd_wgmma<kD><<<blocks, kThreads, smem, stream>>>(
      q_map, k_map, v_map, o_map, static_cast<__nv_bfloat16*>(out), hq, hkv,
      static_cast<int>(bhq),
      static_cast<int>(q_tiles), t, s, causal, scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wgmma

// Launches the simt instance on `stream`. dtype: 0 = float32, 1 = bfloat16.
// Returns the cudaError_t of the launch (0 on success); refuses shapes the
// kernel does not take with cudaErrorInvalidValue. The caller checks types,
// devices and contiguity.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                   int dtype, int b, int hq, int hkv, int t, int s, int d,
                                   int causal, float scale, void* stream) {
  if (b <= 0 || hq <= 0 || hkv <= 0 || t <= 0 || s <= 0 || d <= 0 || d > simt::kMaxD ||
      hq % hkv != 0 || b > 65535 || hq > 65535) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return simt::dispatch_d<float>(q, k, v, out, b, hq, hkv, t, s, d, causal, scale, st);
  if (dtype == 1) {
    return simt::dispatch_d<__nv_bfloat16>(q, k, v, out, b, hq, hkv, t, s, d, causal, scale, st);
  }
  return cudaErrorInvalidValue;
}

// Launches the wgmma instance on `stream`: bfloat16 q, k, v and out at
// D = 64, 80, 128 or 192, each 16-byte aligned. Returns the cudaError_t of the launch
// (0 on success); refuses what the instance does not take with
// cudaErrorInvalidValue, as it does when the driver refuses a tensor map.
// The caller checks types, devices and contiguity.
extern "C" int flash_attention_fwd_wgmma(const void* q, const void* k, const void* v,
                                         void* out, int b, int hq, int hkv, int t, int s,
                                         int d, int causal, float scale, void* stream) {
  if (b <= 0 || hq <= 0 || hkv <= 0 || t <= 0 || s <= 0 ||
      (d != 64 && d != 80 && d != 128 && d != 192) || hq % hkv != 0 || b > 65535 ||
      hq > 65535) {
    return cudaErrorInvalidValue;
  }
  const uintptr_t addrs = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out);
  if (addrs & 15) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64: return wgmma::launch<64>(q, k, v, out, b, hq, hkv, t, s, causal, scale, st);
    case 80: return wgmma::launch<80>(q, k, v, out, b, hq, hkv, t, s, causal, scale, st);
    case 128: return wgmma::launch<128>(q, k, v, out, b, hq, hkv, t, s, causal, scale, st);
    default: return wgmma::launch<192>(q, k, v, out, b, hq, hkv, t, s, causal, scale, st);
  }
}
