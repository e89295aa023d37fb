// Per-slot weighted histogram for Hopper (sm_90a): phase A's K^(i).
//
//   out[i, b] = sum_t w[i, t] * (ids[i, t] == b),   b in [0, num_bins)
//
// ids (m, K) int32 and w (m, K) float32, both row-major; out (m, num_bins)
// float32, zeroed by the caller. Ids outside [0, num_bins) are dropped.
//
// Replaces: src/repro/kernels/histogram/histogram.py · histogram_pallas
// (a one-hot compare + reduction over VMEM tiles, one shard per call under
// vmap). Here all m slots go in one launch.
//
// Bound: bytes. Each pair is read once (4 B id + 4 B weight) and does one
// add, so at (32, 2^21) pairs the kernel must move about 0.54 GB: about
// 0.16 ms at 3.35 TB/s. The operations (one f32 add a pair) are far below
// the card's rate.
//
// Design: the TPU kernel's one-hot matrix has no use on a GPU, which has
// fast shared-memory atomics. Each CTA owns one slot, one token range and
// one window of at most kMaxWindow bins, kept privately in dynamic shared
// memory (128 KB at the largest, above the 48 KB default, so the launcher
// raises the limit). Threads read ids and weights coalesced, add into the
// shared window with atomicAdd, and at the end the CTA adds each non-zero
// bin into global memory with one atomicAdd. The grid holds about eight
// CTAs per SM, so each CTA reads a long token range and its merge (at most
// one global atomic per bin) stays small against its reads. Any num_bins
// works: bins beyond one window take more windows (blockIdx.y), each
// reading the slot's tokens again.
//
// Float atomics make the order of the additions vary from run to run.
// The engine passes only weights that are 0 or 1 (the validity mask), and
// integer-valued float32 sums below 2^24 are exact in any order, so its
// histograms are bit-exact. For general weights the result is allclose to
// the plain version, not bitwise.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kMaxWindow = 32768;  // bins per CTA: 128 KB of shared memory
constexpr int kCtasPerSm = 8;

__global__ void __launch_bounds__(kThreads)
histogram_kernel(const int* __restrict__ ids, const float* __restrict__ w,
                 float* __restrict__ out, long long k, int num_bins,
                 int window, long long tokens_per_block) {
  extern __shared__ float bins[];
  const int slot = blockIdx.z;
  const int b0 = blockIdx.y * window;
  const int nb = min(window, num_bins - b0);
  for (int i = threadIdx.x; i < nb; i += kThreads) bins[i] = 0.f;
  __syncthreads();

  const long long t0 = static_cast<long long>(blockIdx.x) * tokens_per_block;
  const long long t1 = min(k, t0 + tokens_per_block);
  const int* ids_s = ids + static_cast<long long>(slot) * k;
  const float* w_s = w + static_cast<long long>(slot) * k;
  for (long long t = t0 + threadIdx.x; t < t1; t += kThreads) {
    const int id = ids_s[t];
    if (id >= b0 && id < b0 + nb) atomicAdd(&bins[id - b0], w_s[t]);
  }
  __syncthreads();

  float* out_s = out + static_cast<long long>(slot) * num_bins + b0;
  for (int i = threadIdx.x; i < nb; i += kThreads) {
    const float v = bins[i];
    if (v != 0.f) atomicAdd(&out_s[i], v);
  }
}

}  // namespace

// Launches the histogram of m slots of k pairs on `stream`. Returns the
// cudaError_t of the launch (0 on success). The caller checks shapes,
// types and contiguity and zeroes `out`.
extern "C" int histogram_f32(const void* ids, const void* w, void* out, int m,
                             long long k, int num_bins, void* stream) {
  if (m <= 0 || k <= 0 || num_bins <= 0) return cudaErrorInvalidValue;
  int device = 0;
  int sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (sms <= 0) sms = 1;

  const int window = num_bins < kMaxWindow ? num_bins : kMaxWindow;
  const int windows = (num_bins + window - 1) / window;
  const long long target = static_cast<long long>(kCtasPerSm) * sms;
  long long per_slot = (target + static_cast<long long>(m) * windows - 1) /
                       (static_cast<long long>(m) * windows);
  if (per_slot < 1) per_slot = 1;
  long long tokens = (k + per_slot - 1) / per_slot;
  tokens = (tokens + kThreads - 1) / kThreads * kThreads;
  per_slot = (k + tokens - 1) / tokens;

  const size_t smem = static_cast<size_t>(window) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(histogram_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  }
  const dim3 grid(static_cast<unsigned>(per_slot), windows, m);
  histogram_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ids), static_cast<const float*>(w),
      static_cast<float*>(out), k, num_bins, window, tokens);
  return static_cast<int>(cudaGetLastError());
}
