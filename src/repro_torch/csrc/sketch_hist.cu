// Count-min sketch grid of every slot for Hopper (sm_90a): phase A's
// statistics under stats="sketch".
//
//   out[i, r, b] = sum_t w[i, t] * (h_r(ids[i, t]) == b)
//   h_r(x) = (a_r * x mod 2^32) >> (32 - log2 width)
//
// ids (m, K) int32 (read as their uint32 bit patterns) and w (m, K)
// float32, both row-major; out (m, depth, width) float32, zeroed by the
// caller. The depth multipliers a_r are host constants passed by value.
//
// Replaces: src/repro/kernels/sketch_hist/sketch_hist.py · sketch_hist_pallas
// (per hash row, a one-hot compare + reduction over VMEM tiles, one shard
// per call under vmap). Here all m slots and all depth rows go in one
// launch, and each pair is read once for all rows.
//
// Bound: bytes. Each pair is read once (4 B id + 4 B weight); the output
// (m * depth * width floats) is small. At (32, 2^21) pairs that is about
// 0.54 GB: about 0.16 ms at 3.35 TB/s. The operations (depth multiplies,
// shifts and adds a pair) are far below the card's integer and float
// rates.
//
// Design: the histogram kernel's, with the hash in registers. Each CTA
// owns one slot, one token range and one window of at most kMaxWindow
// cells of the flattened (row, bin) grid, kept privately in dynamic
// shared memory: at the default 4 x 1024 the whole grid is one 16 KB
// window. Threads read ids and weights coalesced, hash each id once per
// row whose bins meet the window ((uint32_t)id * a_r wraps mod 2^32 for
// free), and add the weight into the cell with a shared atomicAdd. At the
// end the CTA adds each non-zero cell into global memory with one
// atomicAdd. Grids wider than one window take more windows (blockIdx.y),
// each reading the slot's pairs again. The grid holds about eight CTAs per
// SM, so each CTA reads a long token range and its merge stays small.
//
// Cost of the simple design: the hottest cell of every row holds at least
// the hottest cluster's share of the pairs (about 7% under Zipf 0.97), and
// shared atomics on one address serialise within a warp.
//
// Exactness: float atomics make the order of the additions vary from run
// to run. The engine's weights are 0 or 1 (the validity mask) and every
// cell stays below 2^24 (K = 2^21 pairs a slot), so the sums are integers
// that float32 holds exactly in any order, and the kernel equals its
// plain version bit for bit. Real-valued weights lose that property: the
// result is then allclose to the plain version, not bitwise.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kMaxWindow = 32768;  // cells per CTA: 128 KB of shared memory
constexpr int kCtasPerSm = 8;
constexpr int kMaxDepth = 16;

struct Multipliers {
  unsigned int a[kMaxDepth];
};

__global__ void __launch_bounds__(kThreads)
sketch_hist_kernel(const int* __restrict__ ids, const float* __restrict__ w,
                   float* __restrict__ out, long long k, Multipliers mult,
                   int depth, int width, int shift, int window,
                   long long tokens_per_block) {
  extern __shared__ float cells[];
  __shared__ unsigned int a[kMaxDepth];  // indexed by row: kept out of local memory
  const int slot = blockIdx.z;
  const int total = depth * width;
  const int c0 = blockIdx.y * window;
  const int nc = min(window, total - c0);
  for (int i = threadIdx.x; i < nc; i += kThreads) cells[i] = 0.f;
  if (threadIdx.x == 0) {
    for (int r = 0; r < depth; ++r) a[r] = mult.a[r];
  }
  __syncthreads();

  // Hash rows whose bins meet this window: [r_lo, r_hi).
  const int r_lo = c0 / width;
  const int r_hi = min(depth, (c0 + nc - 1) / width + 1);
  const long long t0 = static_cast<long long>(blockIdx.x) * tokens_per_block;
  const long long t1 = min(k, t0 + tokens_per_block);
  const int* ids_s = ids + static_cast<long long>(slot) * k;
  const float* w_s = w + static_cast<long long>(slot) * k;
  for (long long t = t0 + threadIdx.x; t < t1; t += kThreads) {
    const float wt = w_s[t];
    if (wt == 0.f) continue;  // adds nothing (an invalid pair)
    const unsigned int x = static_cast<unsigned int>(ids_s[t]);
    for (int r = r_lo; r < r_hi; ++r) {
      const int c = r * width + static_cast<int>((x * a[r]) >> shift) - c0;
      if (c >= 0 && c < nc) atomicAdd(&cells[c], wt);
    }
  }
  __syncthreads();

  float* out_s = out + static_cast<long long>(slot) * total + c0;
  for (int i = threadIdx.x; i < nc; i += kThreads) {
    const float v = cells[i];
    if (v != 0.f) atomicAdd(&out_s[i], v);
  }
}

}  // namespace

// Launches the sketch of m slots of k pairs on `stream`. `multipliers`
// points at `depth` host uint32 values. Returns the cudaError_t of the
// launch (0 on success). The caller checks shapes, types and contiguity,
// that width is a power of two >= 2, and zeroes `out`.
extern "C" int sketch_hist_f32(const void* ids, const void* w, void* out, int m,
                               long long k, const unsigned int* multipliers,
                               int depth, int width, void* stream) {
  if (m <= 0 || k <= 0 || depth <= 0 || depth > kMaxDepth || width < 2 ||
      (width & (width - 1)) != 0 ||
      static_cast<long long>(depth) * width > (1LL << 30)) {
    return cudaErrorInvalidValue;
  }
  Multipliers mult = {};
  for (int r = 0; r < depth; ++r) mult.a[r] = multipliers[r];
  int log2w = 0;
  while ((1 << log2w) < width) ++log2w;
  const int shift = 32 - log2w;

  int device = 0;
  int sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (sms <= 0) sms = 1;

  const int total = depth * width;
  const int window = total < kMaxWindow ? total : kMaxWindow;
  const int windows = (total + window - 1) / window;
  const long long target = static_cast<long long>(kCtasPerSm) * sms;
  long long per_slot = (target + static_cast<long long>(m) * windows - 1) /
                       (static_cast<long long>(m) * windows);
  if (per_slot < 1) per_slot = 1;
  long long tokens = (k + per_slot - 1) / per_slot;
  tokens = (tokens + kThreads - 1) / kThreads * kThreads;
  per_slot = (k + tokens - 1) / tokens;

  const size_t smem = static_cast<size_t>(window) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(sketch_hist_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  }
  const dim3 grid(static_cast<unsigned>(per_slot), windows, m);
  sketch_hist_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ids), static_cast<const float*>(w),
      static_cast<float*>(out), k, mult, depth, width, shift, window, tokens);
  return static_cast<int>(cudaGetLastError());
}
