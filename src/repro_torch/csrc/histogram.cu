// Per-slot histogram for Hopper (sm_90a): phase A's K^(i).
//
//   out[i, b] = sum_t w[i, t] * (ids[i, t] == b),   b in [0, num_bins)
//
// ids (m, K) int32 and w (m, K), both row-major; out (m, num_bins) float32,
// zeroed by the caller. Ids outside [0, num_bins) are dropped. Two
// instances (pair_count.cuh): `mask` (w a torch.bool 0/1 mask, uint32
// counters, 5 B a pair; the engine's, equal to the plain version bit for bit
// while every bin holds at most 2^24) and `float` (w float32, float counters,
// 8 B a pair, allclose to the plain version).
//
// Replaces: src/repro/kernels/histogram/histogram.py · histogram_pallas
// (a one-hot compare + reduction over VMEM tiles, one shard per call under
// vmap). Here all m slots go in one launch.
//
// Bound: bytes. Each pair is read once and does one add: at (32, 2^21) pairs
// the mask instance must move 0.34 GB (0.100 ms at 3.35 TB/s), the float
// instance 0.54 GB (0.160 ms). One integer add a pair is far below the
// card's rate.
//
// Design (pair_count.cuh): 16-byte loads, four in flight a thread; private
// copies of the bins within 48 KB a CTA (one per warp at the engine's 352
// bins, 22.6 KB), so the Zipf-hot bins of 16 warps do not meet at one
// address; a grid of one wave sized from the occupancy at that shared
// memory; past 32,768 bins a cluster of up to 8 CTAs splits the bins, each
// reading the same pairs (from L2 after the first). The TPU kernel's
// one-hot matrix has no use here.

#include "pair_count.cuh"

namespace {

// int4s of ids a thread has in flight: four ran faster than two on the
// H100, most of all at 2^17 bins.
constexpr int kUnroll = 4;

struct Bins {
  template <class Add>
  __device__ __forceinline__ void operator()(unsigned x, Add&& add) const {
    add(x);  // the id is the bin; the window's check drops the rest
  }
};

template <class W, class C>
__global__ void __launch_bounds__(pair_count::kThreads, pair_count::kMinBlocks)
histogram_kernel(const int* __restrict__ ids, const W* __restrict__ w, float* __restrict__ out,
                 pair_count::Params p) {
  pair_count::run<kUnroll, W, C>(ids, w, out, p, Bins{});
}

template <class W, class C>
int launch(const void* ids, const void* w, void* out, int m, long long k, int num_bins,
           int phase, void* stream) {
  return pair_count::launch<C, kUnroll>(histogram_kernel<W, C>, static_cast<const int*>(ids),
                               static_cast<const W*>(w), static_cast<float*>(out), m, k,
                               num_bins, phase, static_cast<cudaStream_t>(stream));
}

}  // namespace

// Launch the histogram of m slots of k pairs on `stream`; `phase` is
// pair_split.split_phase of the two pointers. Return the cudaError_t of the
// launch (0 on success). The caller checks shapes, types and contiguity and
// zeroes `out`.
extern "C" int histogram_mask(const void* ids, const void* mask, void* out, int m, long long k,
                              int num_bins, int phase, void* stream) {
  return launch<uint8_t, unsigned>(ids, mask, out, m, k, num_bins, phase, stream);
}

extern "C" int histogram_f32(const void* ids, const void* w, void* out, int m, long long k,
                             int num_bins, int phase, void* stream) {
  return launch<float, float>(ids, w, out, m, k, num_bins, phase, stream);
}
