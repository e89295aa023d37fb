// Fused gather + sorted segment-sum for Hopper (sm_90a): phase B's
// "sort" + "run" of one pipeline chunk, for all m slots in two launches.
//
//   out[i, s, :]  = sum_{t : seg[i, t] == s} values[i, gather_idx[i, t], :]
//   counts[i, s]  = #{t : seg[i, t] == s}
//
// values (m, N, V) float32, gather_idx (m, N) int32 in [0, N), seg (m, N)
// int32, non-decreasing along each row; ids outside [0, num_segments) are
// padding. out (m, num_segments, V) and counts (m, num_segments) float32;
// the kernels write every entry.
//
// Replaces: src/repro/kernels/fused_shuffle_reduce/fused_shuffle_reduce.py ·
// fused_gather_segment_reduce_pallas (a diagonal band of one-hot MXU
// products over fixed 512-token blocks, the value table whole in VMEM),
// and the engine's count of pairs per cluster beside it, which the
// segments' row ranges give for free.
//
// Bound: bytes. A valid stream row reads its index (4 B) and its gathered
// value row (4 V B) once; each segment writes V sums and a count. At V = 11
// that is 48 B a valid row, one add per value.
//
// What stands in the way: skew. Under Zipf keys one cluster holds several
// percent of a chunk's rows, so a segment cannot be one CTA's work (that
// SM would run long while the others idle), and the order in which its
// rows are added must not depend on how the work was split.
//
// Design: segment-anchored tiles (segment_tiles.cuh: segment starts,
// tiles of tile_rows rows anchored at each segment's first row, warps
// taking position blocks round robin, lane order, shuffle tree and ordered
// combine), with this kernel's row loader, GatherRows: lane j loads the
// gathered rows of its stream rows start + j, + 32, ..., kRowUnroll rows'
// loads in flight before their adds. Its counts are the segments' row
// ranges, written where reduce_tiles zeroes the empty segments' rows.
// * Rows are gathered: Hopper's TMA has no gather, and a 44-byte row is not
//   a multiple of 16 B, so a lane loads its row's words itself. The stable
//   rank sort keeps a segment's gather indices ascending, so a warp's 32
//   rows lie close together in the value table and share cache lines.

#include <cuda_runtime.h>

#include "segment_tiles.cuh"

namespace {

using segment_tiles::Args;
using segment_tiles::kCols;

constexpr int kRowUnroll = 4;    // rows a lane loads before it adds them

// Kernel 2's loader: stream row r is value row gather_idx[r] of its slot.
struct GatherRows {
  static constexpr bool kCounts = true;

  __device__ __forceinline__ void sum(const Args& a, long long slot, long long start,
                                      long long end, int c0, int nc, int lane,
                                      float (&acc)[kCols]) const {
    const int* idx = a.gather_idx + slot * a.n;
    const float* table = a.values + slot * a.n * a.v + c0;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[c] = 0.f;
    for (long long r0 = start + lane; r0 < end; r0 += 32 * kRowUnroll) {
      int g[kRowUnroll];
#pragma unroll
      for (int u = 0; u < kRowUnroll; ++u) {
        const long long r = r0 + 32 * u;
        g[u] = r < end ? idx[r] : -1;
        if (g[u] >= a.n) g[u] = -1;    // malformed index: never read outside
      }
      float x[kRowUnroll][kCols];
#pragma unroll
      for (int u = 0; u < kRowUnroll; ++u) {
        const float* row = table + static_cast<long long>(g[u]) * a.v;
#pragma unroll
        for (int c = 0; c < kCols; ++c) x[u][c] = (g[u] >= 0 && c < nc) ? row[c] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kRowUnroll; ++u) {
        if (g[u] < 0) continue;
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[c] += x[u][c];
      }
    }
  }
};

}  // namespace

// Launches the fused reduce of m slots on `stream`: segment_starts, then
// reduce_tiles. starts ((m, S + 1) int64), arrivals ((m, S) int32) and
// partials ((m, ceil(n / tile_rows), 2, V) float32) are scratch the caller
// allocates; tile_rows is a positive multiple of 32. Returns the
// cudaError_t of the launches (0 on success). The caller checks shapes,
// types and contiguity.
extern "C" int fused_gather_segment_sum_f32(const void* values, const void* gather_idx,
                                            const void* seg, void* out, void* counts,
                                            void* starts, void* arrivals, void* partials,
                                            int m, long long n, int v, int num_segments,
                                            int tile_rows, void* stream) {
  if (m <= 0 || n <= 0 || v < 0 || num_segments <= 0 || tile_rows <= 0 ||
      tile_rows % 32 != 0) {
    return cudaErrorInvalidValue;
  }
  const Args a{static_cast<const float*>(values), static_cast<const int*>(gather_idx),
               static_cast<const int*>(seg), static_cast<const long long*>(starts),
               static_cast<int*>(arrivals), static_cast<float*>(partials),
               static_cast<float*>(out), static_cast<float*>(counts), n,
               (n + tile_rows - 1) / tile_rows, m, v, num_segments, tile_rows};
  return segment_tiles::launch<GatherRows>(a, static_cast<long long*>(starts),
                                           static_cast<int*>(arrivals),
                                           static_cast<cudaStream_t>(stream));
}
