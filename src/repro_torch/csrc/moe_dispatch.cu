// Stable counting-sort ranks and per-destination counts for Hopper (sm_90a):
// the address computation of a fixed-capacity bucket scatter (MoE token
// dispatch, the shuffle's "copy").
//
//   rank[t]   = #{t' < t : dest[t'] == dest[t]}   (-1 when dest[t] is not in [0, E))
//   counts[e] = #{t : dest[t] == e}
//
// dest (T,) int32; rank (T,) int32; counts (E,) int32. Exact integers
// throughout (the TPU kernel carries its counts in float32, exact only
// below 2^24 tokens).
//
// Replaces: src/repro/kernels/moe_dispatch/moe_dispatch.py ·
// dispatch_ranks_pallas (one sequential grid walk over token blocks, a
// one-hot cumsum per block and the running per-destination offsets in a
// VMEM carry). Its entry point here is kernels/moe_dispatch/ops.py; no
// engine or model path reaches it, in the reference either.
//
// Bound: bytes. dest is read once and rank written once (8 B a token),
// counts written once.
//
// Design: a multi-destination exclusive scan in three launches, stable by
// construction.
// 1. count_tiles: the tokens are cut into tiles of kTile = 256 in order;
//    each warp counts one tile per destination in shared memory (integer
//    atomics: a count does not depend on their order) and writes the
//    column tile_counts[e][tile].
// 2. scan_tiles: one CTA a destination turns its row of tile counts into
//    exclusive prefixes (the tile's base offset) and writes counts[e].
// 3. rank_tiles: each warp walks its tile again, 32 tokens at a time, in
//    order. __match_any_sync finds the lanes with the same destination;
//    a token's rank is its tile base, plus the running count of its warp,
//    plus the peers in lower lanes. The lowest peer then adds the group's
//    size to the running count. Earlier tokens always get lower ranks, as
//    dispatch_to_buckets' drop-newest overflow needs.
// E is at most kMaxDests (one running count a warp and destination in
// shared memory); more is refused.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 256;          // tokens a warp owns
constexpr int kMaxDests = 1024;
constexpr int kScanThreads = 1024;

__global__ void __launch_bounds__(kThreads)
count_tiles(const int* __restrict__ dest, int* __restrict__ tile_counts, long long n,
            int num_dests, long long ntiles) {
  __shared__ int cnt[kWarps][kMaxDests];
  const int w = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long tile = static_cast<long long>(blockIdx.x) * kWarps + w;
  if (tile >= ntiles) return;   // warp-uniform; only warp barriers follow
  for (int e = lane; e < num_dests; e += 32) cnt[w][e] = 0;
  __syncwarp();
  const long long t0 = tile * kTile;
  for (int i = lane; i < kTile; i += 32) {
    const long long t = t0 + i;
    if (t < n) {
      const int d = dest[t];
      if (d >= 0 && d < num_dests) atomicAdd(&cnt[w][d], 1);
    }
  }
  __syncwarp();
  for (int e = lane; e < num_dests; e += 32) {
    tile_counts[static_cast<long long>(e) * ntiles + tile] = cnt[w][e];
  }
}

// Inclusive scan of one value per thread across the CTA.
__device__ int block_inclusive_scan(int x, int* warp_sums) {
  const int lane = threadIdx.x % 32;
  const int w = threadIdx.x / 32;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) warp_sums[w] = x;
  __syncthreads();
  if (w == 0) {
    int s = lane < kScanThreads / 32 ? warp_sums[lane] : 0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, s, off);
      if (lane >= off) s += y;
    }
    warp_sums[lane] = s;   // inclusive prefix of the warp sums
  }
  __syncthreads();
  const int out = x + (w > 0 ? warp_sums[w - 1] : 0);
  __syncthreads();         // warp_sums is reused by the next call
  return out;
}

__global__ void __launch_bounds__(kScanThreads)
scan_tiles(int* __restrict__ tile_counts, int* __restrict__ counts, long long ntiles) {
  __shared__ int warp_sums[32];
  __shared__ int total;
  int* row = tile_counts + static_cast<long long>(blockIdx.x) * ntiles;
  int running = 0;
  for (long long base = 0; base < ntiles; base += kScanThreads) {
    const long long i = base + threadIdx.x;
    const int x = i < ntiles ? row[i] : 0;
    const int incl = block_inclusive_scan(x, warp_sums);
    if (i < ntiles) row[i] = running + incl - x;
    // The chunk's total is the last thread's inclusive sum.
    if (threadIdx.x == kScanThreads - 1) total = incl;
    __syncthreads();
    running += total;
    __syncthreads();
  }
  if (threadIdx.x == 0) counts[blockIdx.x] = running;
}

__global__ void __launch_bounds__(kThreads)
rank_tiles(const int* __restrict__ dest, const int* __restrict__ tile_base,
           int* __restrict__ rank, long long n, int num_dests, long long ntiles) {
  __shared__ int run[kWarps][kMaxDests];
  const int w = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long tile = static_cast<long long>(blockIdx.x) * kWarps + w;
  if (tile >= ntiles) return;   // warp-uniform; only warp barriers follow
  for (int e = lane; e < num_dests; e += 32) {
    run[w][e] = tile_base[static_cast<long long>(e) * ntiles + tile];
  }
  __syncwarp();
  const unsigned lower = (1u << lane) - 1u;
  const long long t0 = tile * kTile;
  for (int i0 = 0; i0 < kTile; i0 += 32) {
    const long long t = t0 + i0 + lane;
    const int d = t < n ? dest[t] : -1;
    const bool valid = t < n && d >= 0 && d < num_dests;
    const unsigned peers = __match_any_sync(0xffffffffu, valid ? d : -1);
    const unsigned before = peers & lower;
    const int r = valid ? run[w][d] + __popc(before) : -1;
    __syncwarp();
    if (valid && before == 0u) run[w][d] += __popc(peers);
    __syncwarp();
    if (t < n) rank[t] = r;
  }
}

}  // namespace

// Tile-count scratch (int32 words) that dispatch_ranks_i32 needs for n
// tokens and num_dests destinations.
extern "C" long long dispatch_ranks_scratch_words(long long n, int num_dests) {
  return static_cast<long long>(num_dests) * ((n + kTile - 1) / kTile);
}

// Launches the three passes on `stream`. Returns the first cudaError_t
// (0 on success); refuses n < 1, n >= 2^31 and num_dests outside
// [1, kMaxDests] with cudaErrorInvalidValue. The caller checks types,
// devices and contiguity, and passes `scratch` of
// dispatch_ranks_scratch_words(n, num_dests) int32 words.
extern "C" int dispatch_ranks_i32(const void* dest, void* rank, void* counts, void* scratch,
                                  long long n, int num_dests, void* stream) {
  if (n < 1 || n >= (1LL << 31) || num_dests < 1 || num_dests > kMaxDests) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long ntiles = (n + kTile - 1) / kTile;
  const long long blocks = (ntiles + kWarps - 1) / kWarps;
  const int* d = static_cast<const int*>(dest);
  int* tiles = static_cast<int*>(scratch);
  count_tiles<<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(d, tiles, n, num_dests,
                                                                   ntiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  scan_tiles<<<num_dests, kScanThreads, 0, st>>>(tiles, static_cast<int*>(counts), ntiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  rank_tiles<<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
      d, tiles, static_cast<int*>(rank), n, num_dests, ntiles);
  return static_cast<int>(cudaGetLastError());
}
