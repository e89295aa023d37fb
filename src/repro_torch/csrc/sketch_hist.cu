// Count-min sketch grid of every slot for Hopper (sm_90a): phase A's
// statistics under stats="sketch".
//
//   out[i, r, b] = sum_t w[i, t] * (h_r(ids[i, t]) == b)
//   h_r(x) = (a_r * x mod 2^32) >> (32 - log2 width)
//
// ids (m, K) int32 (read as their uint32 bit patterns) and w (m, K), both
// row-major; out (m, depth, width) float32, zeroed by the caller. The depth
// multipliers a_r are host constants passed by value. Two instances
// (pair_count.cuh): `mask` (w a torch.bool 0/1 mask, uint32 counters, 5 B a
// pair; the engine's, equal to the plain version bit for bit while every
// cell holds at most 2^24) and `float` (w float32, 8 B a pair, allclose).
//
// Replaces: src/repro/kernels/sketch_hist/sketch_hist.py · sketch_hist_pallas
// (per hash row, a one-hot compare + reduction over VMEM tiles, one shard
// per call under vmap). Here all m slots and all depth rows go in one
// launch, and each pair is read once for all rows.
//
// Bound: bytes. Each pair is read once; the output (m * depth * width
// floats) is small. At (32, 2^21) pairs the mask instance must move 0.34 GB
// (0.100 ms at 3.35 TB/s), the float instance 0.54 GB (0.160 ms). The hash
// (depth multiplies and shifts a pair) and the depth adds are far below
// the card's integer rate.
//
// Design: the histogram's (pair_count.cuh), with the hash in registers and
// the multipliers read as constant-bank operands (the row loop is unrolled;
// a dynamic index into the parameter struct would go through local memory,
// and a shared copy cost a shared load a row a pair). Each pair adds to one
// cell of every row whose cells meet the CTA's window. At the default
// 4 x 1024 the whole grid is 16 KB a copy, and the CTA keeps as many private
// copies as fit in 48 KB (2), so the rows' Zipf-hot cells are spread over
// warps. Grids above 32,768 cells go to a cluster that splits the cells.

#include "pair_count.cuh"

namespace {

constexpr int kMaxDepth = 16;
// int4s of ids a thread has in flight: two leave the hash more registers
// and ran faster than four at 4 x 1024 on the H100.
constexpr int kUnroll = 2;

struct Multipliers {
  unsigned int a[kMaxDepth];
};

// The cells of one pair: a cell in each hash row of [r_lo, r_hi). The loop
// is unrolled over kMaxDepth so that every multiplier is a constant-bank
// operand of its multiply, not a load (the rows past r_hi are cut by a
// uniform branch).
struct Rows {
  Multipliers mult;
  int r_lo, r_hi, width, shift;
  template <class Add>
  __device__ __forceinline__ void operator()(unsigned x, Add&& add) const {
#pragma unroll
    for (int r = 0; r < kMaxDepth; ++r) {
      if (r >= r_hi) break;
      if (r >= r_lo) add(r * width + ((x * mult.a[r]) >> shift));
    }
  }
};

template <class W, class C>
__global__ void __launch_bounds__(pair_count::kThreads, pair_count::kMinBlocks)
sketch_hist_kernel(const int* __restrict__ ids, const W* __restrict__ w, float* __restrict__ out,
                   pair_count::Params p, Multipliers mult, int depth, int width, int shift) {
  // Hash rows whose cells meet this CTA's window: [r_lo, r_hi).
  int first, owned;
  pair_count::window_of(p, first, owned);
  const Rows rows{mult, first / width, min(depth, (first + owned - 1) / width + 1), width, shift};
  pair_count::run<kUnroll, W, C>(ids, w, out, p, rows);
}

template <class W, class C>
int launch(const void* ids, const void* w, void* out, int m, long long k,
           const unsigned int* multipliers, int depth, int width, int phase, void* stream) {
  if (depth <= 0 || depth > kMaxDepth || width < 2 || (width & (width - 1)) != 0 ||
      static_cast<long long>(depth) * width > (1LL << 30)) {
    return cudaErrorInvalidValue;
  }
  Multipliers mult = {};
  for (int r = 0; r < depth; ++r) mult.a[r] = multipliers[r];
  int log2w = 0;
  while ((1 << log2w) < width) ++log2w;
  return pair_count::launch<C, kUnroll>(sketch_hist_kernel<W, C>, static_cast<const int*>(ids),
                               static_cast<const W*>(w), static_cast<float*>(out), m, k,
                               depth * width, phase, static_cast<cudaStream_t>(stream), mult,
                               depth, width, 32 - log2w);
}

}  // namespace

// Launch the sketch of m slots of k pairs on `stream`. `multipliers` points
// at `depth` host uint32 values; `phase` is pair_split.split_phase of the
// two pointers. Return the cudaError_t of the launch (0 on success). The
// caller checks shapes, types and contiguity, that width is a power of two
// >= 2, and zeroes `out`.
extern "C" int sketch_hist_mask(const void* ids, const void* mask, void* out, int m, long long k,
                                const unsigned int* multipliers, int depth, int width, int phase,
                                void* stream) {
  return launch<uint8_t, unsigned>(ids, mask, out, m, k, multipliers, depth, width, phase, stream);
}

extern "C" int sketch_hist_f32(const void* ids, const void* w, void* out, int m, long long k,
                               const unsigned int* multipliers, int depth, int width, int phase,
                               void* stream) {
  return launch<float, float>(ids, w, out, m, k, multipliers, depth, width, phase, stream);
}
