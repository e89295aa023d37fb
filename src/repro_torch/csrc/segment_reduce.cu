// Sorted segment-sum of every slot for Hopper (sm_90a): the Reduce "run"
// over pairs already ordered by segment.
//
//   out[i, s, :] = sum_{t : seg[i, t] == s} values[i, t, :]
//
// values (m, N, V) float32, seg (m, N) int32, non-decreasing along each
// row; ids outside [0, num_segments) are dropped (negative ids sort first,
// padding ids >= num_segments last). out (m, num_segments, V) float32;
// the kernels write every entry.
//
// Replaces: src/repro/kernels/segment_reduce/segment_reduce.py ·
// segment_reduce_sorted_pallas (a diagonal band of one-hot MXU products
// over token blocks, one shard per call under vmap). No engine path
// launches it, in the reference either: both of the reference engine's
// _segment_reduce call sites pass use_kernel=False. It is its own entry
// point here, kernels/segment_reduce/ops.segment_reduce_sorted.
//
// Bound: bytes. A row in range reads its id (4 B) and its value row
// (4 V B) once, and the output is written once: rows * (4 + 4 V) +
// m * num_segments * V * 4 bytes, one add per value.
//
// What stands in the way: skew. Under Zipf keys one segment holds several
// percent of a slot's rows; one CTA a segment leaves the other SMs idle
// while it runs.
//
// Design: kernel 2's segment-anchored tiles (segment_tiles.cuh), without
// the gather. Tiles of tile_rows rows anchored at each segment's first row
// are spread over the warps of a persistent grid; lane j adds rows
// lo + kT + j, + 32, ... in order; a fixed shuffle tree and an ordered
// combine of the partials follow. Kernel 2 adds the same rows in the same
// order, so on the same rows (gathered there, in rank order here) the two
// give the same bits. The loader, ContiguousRows: lane j loads its own
// row's V words, kRowUnroll rows in flight. A warp's 32 rows are one
// contiguous span, so each of its loads touches the span's lines, which
// the first load brings into L1. A loader that copied each span into a
// per-warp shared-memory stage with 16-byte cp.async copies first, with 2,
// 4 or 8 stages in flight, was slower in exploratory probes on the H100 at
// chunk 0's shape (with 4 and more, ptxas spilled or the registers cut
// occupancy).

#include <cuda_runtime.h>

#include "segment_tiles.cuh"

namespace {

using segment_tiles::Args;
using segment_tiles::kCols;

constexpr int kRowUnroll = 4;    // rows a lane loads before it adds them

// Kernel 3's loader: stream row r is value row r of its slot.
struct ContiguousRows {
  static constexpr bool kCounts = false;

  __device__ __forceinline__ void sum(const Args& a, long long slot, long long start,
                                      long long end, int c0, int nc, int lane,
                                      float (&acc)[kCols]) const {
    const float* table = a.values + slot * a.n * a.v + c0;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[c] = 0.f;
    for (long long r0 = start + lane; r0 < end; r0 += 32 * kRowUnroll) {
      float x[kRowUnroll][kCols];
#pragma unroll
      for (int u = 0; u < kRowUnroll; ++u) {
        const long long r = r0 + 32 * u;
        const float* row = table + r * a.v;
#pragma unroll
        for (int c = 0; c < kCols; ++c) x[u][c] = (r < end && c < nc) ? row[c] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kRowUnroll; ++u) {
        if (r0 + 32 * u >= end) continue;
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[c] += x[u][c];
      }
    }
  }
};

}  // namespace

// Launches the sorted segment-sum of m slots on `stream`: segment_starts,
// then reduce_tiles. starts ((m, S + 1) int64), arrivals ((m, S) int32) and
// partials ((m, ceil(n / tile_rows), 2, V) float32) are scratch the caller
// allocates; tile_rows is a positive multiple of 32. Returns the
// cudaError_t of the launches (0 on success). The caller checks shapes,
// types and contiguity.
extern "C" int segment_reduce_sorted_f32(const void* values, const void* seg, void* out,
                                         void* starts, void* arrivals, void* partials, int m,
                                         long long n, int v, int num_segments, int tile_rows,
                                         void* stream) {
  if (m <= 0 || n <= 0 || v <= 0 || num_segments <= 0 || tile_rows <= 0 ||
      tile_rows % 32 != 0) {
    return cudaErrorInvalidValue;
  }
  const Args a{static_cast<const float*>(values), nullptr, static_cast<const int*>(seg),
               static_cast<const long long*>(starts), static_cast<int*>(arrivals),
               static_cast<float*>(partials), static_cast<float*>(out), nullptr, n,
               (n + tile_rows - 1) / tile_rows, m, v, num_segments, tile_rows};
  return segment_tiles::launch<ContiguousRows>(a, static_cast<long long*>(starts),
                                               static_cast<int*>(arrivals),
                                               static_cast<cudaStream_t>(stream));
}
