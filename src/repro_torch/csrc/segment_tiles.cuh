// Segment-anchored tiles for Hopper (sm_90a): the work split of a segment
// sum over rows whose segment ids are sorted, shared by kernel 2
// (fused_shuffle_reduce.cu: rows gathered through an index) and kernel 3
// (segment_reduce.cu: rows already in order). A kernel supplies the row
// loader (a `Rows` type, below); this header finds the segments, cuts them
// into tiles, spreads the tiles over all SMs and adds the tiles' partials.
//
//   out[i, s, :] = sum_{t : seg[i, t] == s} rows_i(t)
//
// seg (m, N) int32, non-decreasing along each row; ids outside [0, S) are
// padding. out (m, S, V) float32; the kernels write every entry.
//
// * segment_starts binary-searches each slot's sorted seg row for every
//   segment's first row, starts[i, s] = lower_bound(s) for s in [0, S], so
//   segment s holds rows [starts[s], starts[s + 1]). It also zeroes the
//   segments' arrival counters.
// * reduce_tiles, persistent: first the zero rows of empty segments (and,
//   where the loader asks for them, the counts starts[s + 1] - starts[s]).
//   Then the work: each segment's rows are cut into tiles of tile_rows (T)
//   rows anchored at its first row, [lo + kT, lo + (k + 1)T). Tile (s, k)
//   belongs to the position block [bT, (b + 1)T) of its slot that holds its
//   first row; a block holds at most one tile start of each segment, and
//   its tiles span fewer than 2T rows. Warps take the m * ceil(N / T) blocks
//   round robin, so the work list needs no scan and the host never waits: a
//   hot segment is spread over as many warps as it has tiles, and blocks of
//   padding cost two loads.
// * A tile is summed by one warp: lane j adds rows lo + kT + j, + 32, + 64,
//   ... in that order, up to kCols value columns a pass in registers; then a
//   fixed shuffle tree (offsets 16, 8, 4, 2, 1) leaves the tile's sum in
//   lane 0. A segment of one tile writes its sum to out. Otherwise each tile
//   writes a partial of V floats into a workspace at (slot, b, which), where
//   which is 0 for the segment that holds row bT and 1 for the one other
//   segment whose multi-tile run may start inside the block; it then bumps
//   the segment's arrival counter (__threadfence before, atomicAdd), and the
//   warp that arrives last adds the partials in tile order, k = 0, 1, ...,
//   and writes out. No float atomics.
// * Invariant: a segment's float32 sum depends only on its own rows in
//   stream order, on T and on the warp's 32 lanes. It does not depend on
//   the padded length N, on where the segment starts, on other segments, or
//   on how the loader brings the rows in: tiles are anchored at the
//   segment, not at the slab, and every loader adds a lane's rows in the
//   same order. So kernel 2 on gathered rows and kernel 3 on the same rows
//   in rank order give the same bits, and so do the pipelined and the
//   sequential engine, and the stacked and the sharded backend.
//
// A `Rows` type has `static constexpr bool kCounts` (write counts) and
//   void sum(const Args&, slot, start, end, c0, nc, lane, float (&acc)[kCols])
// which leaves in acc[c] (c < nc) the sum of value column c0 + c over rows
// start + lane, + 32, ... below end, added in that order from zero.

#pragma once

#include <cuda_runtime.h>

namespace segment_tiles {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 12;        // value columns a pass, kept in registers

// A warp's 32 staged partials during the combine (kCols + 1: no bank
// conflicts when lane l writes row l).
__shared__ float combine_stage[kWarps][32][kCols + 1];

__device__ __forceinline__ long long lower_bound(const int* seg, long long n, int key) {
  long long lo = 0;
  long long hi = n;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (seg[mid] < key) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
segment_starts(const int* __restrict__ seg, long long* __restrict__ starts,
               int* __restrict__ arrivals, int m, long long n, int num_segments) {
  const long long per_slot = static_cast<long long>(num_segments) + 1;
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= m * per_slot) return;
  const long long slot = i / per_slot;
  const int s = static_cast<int>(i - slot * per_slot);
  // Searching for num_segments itself gives the end of the last segment.
  starts[i] = lower_bound(seg + slot * n, n, s);
  if (s < num_segments) arrivals[slot * num_segments + s] = 0;
}

struct Args {
  const float* values;
  const int* gather_idx;   // kernel 2's gather order; null for kernel 3
  const int* seg;
  const long long* starts;
  int* arrivals;
  float* partials;     // (m, blocks, 2, V)
  float* out;
  float* counts;       // kernel 2's counts; null for kernel 3
  long long n;
  long long blocks;    // position blocks a slot: ceil(n / tile_rows)
  int m;
  int v;
  int num_segments;
  int tile_rows;
};

// Sums rows [start, end) of one slot's stream for columns [c0, c0 + nc)
// with the loader's lane order and the fixed tree; lane 0 returns the sums
// in acc.
template <class Rows>
__device__ __forceinline__ void tile_sum(const Args& a, const Rows& rows, long long slot,
                                         long long start, long long end, int c0, int nc,
                                         int lane, float (&acc)[kCols]) {
  rows.sum(a, slot, start, end, c0, nc, lane, acc);
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[c] += __shfl_down_sync(0xffffffffu, acc[c], offset);
  }
}

// Lane c of the warp gets lane 0's acc[c] (c < kCols).
__device__ __forceinline__ float column_of_lane(const float (&acc)[kCols], int lane) {
  float mine = 0.f;
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    const float x = __shfl_sync(0xffffffffu, acc[c], 0);
    if (lane == c) mine = x;
  }
  return mine;
}

// Partials of tiles k0 + lane (< tiles) of the segment starting at lo,
// columns [c0, c0 + nc), into p. Tile k starts in block (lo + kT) / T; it
// is that block's segment at row bT ("which" 0) unless k = 0 and the
// segment starts past the block's first row.
__device__ __forceinline__ void load_partials(const Args& a, long long slot, long long lo,
                                              long long tiles, long long k0, int c0, int nc,
                                              int lane, float (&p)[kCols]) {
  const long long k = k0 + lane;
  const long long t0 = lo + k * a.tile_rows;
  const long long b = t0 / a.tile_rows;
  const int which = (k == 0 && t0 % a.tile_rows != 0) ? 1 : 0;
  const float* src = a.partials + ((slot * a.blocks + b) * 2 + which) * a.v + c0;
#pragma unroll
  for (int c = 0; c < kCols; ++c) p[c] = (k < tiles && c < nc) ? __ldcg(src + c) : 0.f;
}

// Tile (slot, s, start) of the segment [lo, hi): its sum, or its partial
// and, for the last of the segment's tiles to finish, the ordered combine.
template <class Rows>
__device__ void run_tile(const Args& a, const Rows& rows, long long slot, int s, long long lo,
                         long long hi, long long start, long long block, int which,
                         int lane) {
  const long long tiles = (hi - lo + a.tile_rows - 1) / a.tile_rows;
  const long long end = start + a.tile_rows < hi ? start + a.tile_rows : hi;
  float* out_row = a.out + (slot * a.num_segments + s) * a.v;
  float* mine = a.partials + ((slot * a.blocks + block) * 2 + which) * a.v;
  for (int c0 = 0; c0 < a.v; c0 += kCols) {
    const int nc = min(kCols, a.v - c0);
    float acc[kCols];
    tile_sum(a, rows, slot, start, end, c0, nc, lane, acc);
    const float x = column_of_lane(acc, lane);
    if (lane < nc) (tiles == 1 ? out_row : mine)[c0 + lane] = x;
  }
  if (tiles == 1) return;
  __threadfence();
  __syncwarp();
  int arrived = 0;
  if (lane == 0) arrived = atomicAdd(a.arrivals + slot * a.num_segments + s, 1);
  arrived = __shfl_sync(0xffffffffu, arrived, 0);
  if (arrived != tiles - 1) return;
  __threadfence();
  // Last to arrive: add the partials in tile order, k = 0, 1, ..., 32 tiles
  // a round. Lane l loads tile k0 + l's partial (the next round's loads in
  // flight during this round's adds) and stages it in shared memory; lane c
  // then runs column c's chain of adds.
  float (*stage)[kCols + 1] = combine_stage[threadIdx.x / 32];
  for (int c0 = 0; c0 < a.v; c0 += kCols) {
    const int nc = min(kCols, a.v - c0);
    float next[kCols];
    load_partials(a, slot, lo, tiles, 0, c0, nc, lane, next);
    float sum = 0.f;
    for (long long k0 = 0; k0 < tiles; k0 += 32) {
      __syncwarp();
#pragma unroll
      for (int c = 0; c < kCols; ++c) stage[lane][c] = next[c];
      __syncwarp();
      if (k0 + 32 < tiles) load_partials(a, slot, lo, tiles, k0 + 32, c0, nc, lane, next);
      const int count = static_cast<int>(tiles - k0 < 32 ? tiles - k0 : 32);
      if (lane < nc) {
        for (int l = 0; l < count; ++l) sum = k0 + l == 0 ? stage[l][lane] : sum + stage[l][lane];
      }
    }
    if (lane < nc) out_row[c0 + lane] = sum;
  }
}

template <class Rows>
__global__ void __launch_bounds__(kThreads) reduce_tiles(Args a) {
  const Rows rows{};
  const int lane = threadIdx.x & 31;
  const long long per_slot = static_cast<long long>(a.num_segments) + 1;
  // Counts, and zeros for the empty segments' rows.
  const long long segments = static_cast<long long>(a.m) * a.num_segments;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
       i < segments; i += static_cast<long long>(gridDim.x) * kThreads) {
    const long long slot = i / a.num_segments;
    const long long at = slot * per_slot + (i - slot * a.num_segments);
    const long long len = a.starts[at + 1] - a.starts[at];
    if (Rows::kCounts) a.counts[i] = static_cast<float>(len);
    if (len == 0) {
      for (int c = 0; c < a.v; ++c) a.out[i * a.v + c] = 0.f;
    }
  }
  // Position blocks, round robin over the warps of the grid.
  const long long warps = static_cast<long long>(gridDim.x) * kWarps;
  const long long units = static_cast<long long>(a.m) * a.blocks;
  for (long long u = static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32;
       u < units; u += warps) {
    const long long slot = u / a.blocks;
    const long long b = u - slot * a.blocks;
    const long long row0 = b * a.tile_rows;
    const long long row_end = row0 + a.tile_rows < a.n ? row0 + a.tile_rows : a.n;
    const int* seg = a.seg + slot * a.n;
    const int first = seg[row0];
    if (first >= a.num_segments || seg[row_end - 1] < 0) continue;   // padding only
    const long long* starts = a.starts + slot * per_slot;
    int s = first;
    if (s < 0) {   // leading padding: the block's first valid row starts a segment
      s = seg[row0 + lower_bound(seg + row0, row_end - row0, 0)];
      if (s >= a.num_segments) continue;
    }
    // The segments with rows in this block, each found at the row where the
    // one before it ends, so that ids of empty segments cost nothing.
    while (true) {
      const long long lo = starts[s];
      const long long hi = starts[s + 1];
      if (lo <= row0) {
        // The segment holding row0: its one tile that starts in this block.
        const long long k = (row0 - lo + a.tile_rows - 1) / a.tile_rows;
        const long long start = lo + k * a.tile_rows;
        if (start < hi) run_tile(a, rows, slot, s, lo, hi, start, b, 0, lane);
      } else {
        run_tile(a, rows, slot, s, lo, hi, lo, b, 1, lane);   // starts inside this block
      }
      if (hi >= row_end) break;
      s = seg[hi];
      if (s >= a.num_segments) break;
    }
  }
}

// Launches segment_starts, then reduce_tiles<Rows> on a persistent grid (the
// resident CTAs, at most one warp a position block). starts ((m, S + 1)
// int64), arrivals ((m, S) int32) and partials ((m, blocks, 2, V) float32)
// are scratch the caller allocates. Returns the cudaError_t of the launches
// (0 on success).
template <class Rows>
inline int launch(const Args& a, long long* starts, int* arrivals, cudaStream_t st) {
  const long long entries = static_cast<long long>(a.m) * (a.num_segments + 1LL);
  segment_starts<<<static_cast<unsigned>((entries + kThreads - 1) / kThreads), kThreads, 0,
                   st>>>(a.seg, starts, arrivals, a.m, a.n, a.num_segments);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  int device = 0;
  int sms = 0;
  int per_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, reduce_tiles<Rows>, kThreads, 0);
  const long long units = static_cast<long long>(a.m) * a.blocks;
  long long grid = static_cast<long long>(sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
  const long long needed = (units + kWarps - 1) / kWarps;
  if (grid > needed) grid = needed;
  reduce_tiles<Rows><<<static_cast<unsigned>(grid), kThreads, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace segment_tiles
