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
// counts written once. At T = 2^20 that is 8.4 MB: 2.5 us at 3.35 TB/s,
// about the time of one kernel launch, so the design is one launch that
// reads dest once.
//
// Design: a single-pass multi-destination exclusive scan with decoupled
// look-back (Merrill & Garland, "Single-pass Parallel Prefix Scan with
// Decoupled Look-back", 2016), stable by construction.
// * One CTA (kWarps warps) a tile of kTile tokens, in token order. Thread 0
//   takes the tile's index from a ticket counter, so every tile before it
//   belongs to a CTA that is already running: the look-back waits only on
//   those, and the grid needs no co-residency. The CTA that takes the last
//   ticket resets the counter for the next call.
// * The tile is loaded once into shared memory: a scalar head up to the
//   first 16-byte boundary, 16-byte loads, a scalar tail
//   (kernels/span_split.py mirrors the split and where token 0 lands).
// * Warp w owns tokens [w kTile / kWarps, (w + 1) kTile / kWarps). First
//   an order-free count of each destination a warp (shared integer
//   atomics into an [E][kWarps + 1] array: conflict-free both ways), whose
//   scan across warps gives each warp's offset and the tile's aggregate,
//   published at once. So the look-back below starts before any tile has
//   ranked a token.
// * Descriptors: (tile, e) -> one 64-bit word, (epoch << 32) | (P << 31) |
//   value, written with a relaxed store: value is the tile's aggregate
//   (P = 0), then its inclusive prefix (P = 1). Tile 0 writes its prefix at
//   once. A word is valid only with this call's epoch, which the host bumps
//   per call, so words left by earlier calls are never read as this call's
//   and nothing is zeroed per call.
// * Look-back: the CTA reads a window of predecessor tiles x destinations
//   at once (kLookLoads words a thread, all in flight; window rows =
//   lookback_rows(E), all predecessors at E <= 64 and T = 2^20). Per
//   destination, the nearest valid prefix ends the walk: that prefix plus
//   the aggregates of the tiles after it. Words nearer than it that were
//   not valid yet are read again in rounds, all in flight, until none is
//   left (a bounded number of rounds, then a trap, not a hang). Otherwise
//   the window adds all its aggregates and the next window starts below it;
//   tile 0 always has a prefix, so the walk ends. Sums are integer
//   shared-memory atomics, exact in any order.
// * Ranks: each warp walks its tokens 32 at a time in order. One ballot a
//   bit of the destination id (ceil(log2 E) of them) finds the lanes with
//   the same destination; the lowest of them adds the group to the warp's
//   running count (which starts at the warp's offset), and a token's rank
//   is the tile's prefix plus that count plus its peers in lower lanes,
//   stored at once. The last tile writes counts.
// Where the time goes (NVIDIA H100 80GB HBM3, 700 W, T = 2^20, E = 64;
// tools/dispatch_phases.py stamps each CTA's phases): the tile load ends
// about 1.0 us in, the counts 0.6 later, the offsets 0.35, the look-back
// 3.9 (an L2 load takes ~2,000 cycles while every tile reads its window,
// ~290 alone), the ranks and their stores 4.5, of which the ballots are
// ~2.3 (unrolling them at a known bit count gains nothing: they are
// throughput-bound). Tried in exploratory probes and slower:
// __match_any_sync instead of the ballots, a division a word in the
// look-back (the window's row and destination), ranking before counting
// (the look-back then waits for the slowest tile's ranks), the look-back's
// loads kept in flight during the ranking, and 4,096-token tiles of 256
// or 512 threads.
// Scratch: 1 + ceil(T / kTile) * E 64-bit words (the ticket, then the
// descriptors), zeroed once when allocated; two calls in flight at once
// need two scratch buffers.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 32;
constexpr int kThreads = kWarps * 32;
constexpr int kMinBlocks = 1;                 // one CTA an SM: at most 64 registers a thread
constexpr int kTile = 8192;                   // tokens a CTA
constexpr int kPerWarp = kTile / kWarps;      // tokens a warp
constexpr int kPerLane = kPerWarp / 32;       // tokens a lane
constexpr int kMaxDests = 1024;
constexpr int kLookLoads = 8;                 // descriptor words a thread a look-back window
constexpr unsigned long long kPrefix = 1ull << 31;
// Poll rounds after which a look-back gives up and traps: a predecessor
// always publishes (it holds an earlier ticket, so it runs), so only a
// fault gets here, and the launch fails instead of hanging.
constexpr unsigned kMaxPolls = 1u << 24;

// Predecessor tiles a look-back window reads (mirrored by
// moe_dispatch.lookback_rows).
__host__ __device__ constexpr int lookback_rows(int num_dests) {
  return kThreads * kLookLoads / num_dests > 0 ? kThreads * kLookLoads / num_dests : 1;
}

// Words between two destinations' rows of per-warp counts: kWarps + 1, so
// that both a warp's lanes (one destination each) and a destination's 32
// warps (one lane each) fall in distinct banks.
constexpr int kCountStride = kWarps + 1;

// Dynamic shared memory (ints): the tile's tokens (+ up to 3 words of
// shift, rounded to 16 B), the per-warp counts, then five rows of E.
__host__ __device__ constexpr int stage_ints() { return kTile + 4; }
constexpr size_t smem_bytes(int num_dests) {
  return sizeof(int) * (static_cast<size_t>(stage_ints()) + (kCountStride + 5) * num_dests);
}

__device__ __forceinline__ unsigned long long load_relaxed(const unsigned long long* p) {
  unsigned long long x;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(x) : "l"(p) : "memory");
  return x;
}

__device__ __forceinline__ void store_relaxed(unsigned long long* p, unsigned long long x) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(x) : "memory");
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
dispatch_tiles(const int* __restrict__ dest, int* __restrict__ rank, int* __restrict__ counts,
               unsigned long long* scratch, long long n, int num_dests, long long ntiles,
               unsigned int epoch) {
  extern __shared__ __align__(16) int smem[];
  int* stage = smem;                                   // stage_ints()
  int* warp_count = stage + stage_ints();              // [E][kCountStride]
  int* prefix = warp_count + kCountStride * num_dests; // [E] exclusive prefix of the tile
  int* aggregate = prefix + num_dests;                 // [E]
  int* stop = aggregate + num_dests;                   // [E] nearest P row, -1 none yet
  int* found = stop + num_dests;                       // [E] look-back sums
  int* closed = found + num_dests;                     // [E] walk ended in an earlier window
  __shared__ long long tile_of_cta;

  const int tid = threadIdx.x;
  const int w = tid / 32;
  const int lane = tid % 32;
  unsigned long long* ticket = scratch;
  unsigned long long* desc = scratch + 1;
  if (tid == 0) {
    const unsigned long long t = atomicAdd(ticket, 1ull);
    if (t == static_cast<unsigned long long>(ntiles - 1)) atomicExch(ticket, 0ull);
    tile_of_cta = static_cast<long long>(t);
  }
  for (int i = tid; i < kCountStride * num_dests; i += kThreads) warp_count[i] = 0;
  __syncthreads();
  const long long tile = tile_of_cta;
  const long long t0 = tile * kTile;
  const int tokens = static_cast<int>(n - t0 < kTile ? n - t0 : kTile);

  // Load the tile: head, 16-byte body, tail (span_split.py).
  const int shift = static_cast<int>((reinterpret_cast<uintptr_t>(dest + t0) >> 2) & 3);
  {
    const int* src = dest + t0;
    const int head = min(tokens, (4 - shift) & 3);
    const int units = (tokens - head) >> 2;
    const int tail = tokens - head - 4 * units;
    int* dst = stage + shift;
    if (tid < head) dst[tid] = __ldg(src + tid);
    const int4* body = reinterpret_cast<const int4*>(src + head);
    int4* sbody = reinterpret_cast<int4*>(dst + head);
#pragma unroll 2
    for (int u = tid; u < units; u += kThreads) sbody[u] = __ldg(body + u);
    if (tid < tail) dst[head + 4 * units + tid] = __ldg(src + head + 4 * units + tid);
  }
  __syncthreads();

  // Each warp's count of each destination (order-free integer atomics).
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const int k = w * kPerWarp + 32 * i + lane;
    const int d = k < tokens ? stage[shift + k] : -1;
    if (d >= 0 && d < num_dests) atomicAdd(&warp_count[d * kCountStride + w], 1);
  }
  __syncthreads();

  // Warp offsets and the tile's aggregate; publish it (tile 0: its prefix).
  // Thread e scans destination e's row of kWarps counts (stride kWarps + 1:
  // neighbouring threads read neighbouring banks).
  for (int e = tid; e < num_dests; e += kThreads) {
    int* row = warp_count + e * kCountStride;
    int sum = 0;
#pragma unroll 8
    for (int v = 0; v < kWarps; ++v) {
      const int c = row[v];
      row[v] = sum;
      sum += c;
    }
    aggregate[e] = sum;
    prefix[e] = 0;
    stop[e] = -1;
    found[e] = 0;
    closed[e] = 0;
    store_relaxed(desc + tile * num_dests + e,
                  (static_cast<unsigned long long>(epoch) << 32) |
                      (tile == 0 ? kPrefix : 0ull) | static_cast<unsigned int>(sum));
  }
  __syncthreads();

  // Decoupled look-back, a window of predecessor rows at a time. Thread
  // tid reads words tid + j kThreads of a window, word f at row offset
  // f / E and destination f % E, kept as (row offset << 10) | destination
  // (computed once: no division in the loop). Where E divides kThreads all
  // of a thread's words have one destination, and the thread folds them
  // before one shared atomic.
  if (tile > 0) {
    const int rows = lookback_rows(num_dests);
    const bool one_dest = kThreads % num_dests == 0;
    int slot[kLookLoads];
    {
      int e = tid % num_dests;
      int r = tid / num_dests;
      const int de = kThreads % num_dests;
      const int dr = kThreads / num_dests;
#pragma unroll
      for (int j = 0; j < kLookLoads; ++j) {
        slot[j] = (r << 10) | e;
        e += de;
        r += dr;
        if (e >= num_dests) {
          e -= num_dests;
          ++r;
        }
      }
    }
    for (long long top = tile - 1;; top -= rows) {
      const int in_window = static_cast<int>(top + 1 < rows ? top + 1 : rows);
      // The window's words, all loads in flight at once.
      unsigned long long word[kLookLoads];
      unsigned need = 0;
#pragma unroll
      for (int j = 0; j < kLookLoads; ++j) {
        const int e = slot[j] & 1023;
        const int r = slot[j] >> 10;
        if (r < in_window && !closed[e]) need |= 1u << j;
        word[j] = (need >> j) & 1 ? load_relaxed(desc + (top - r) * num_dests + e) : 0ull;
      }
      // Rounds: the nearest valid prefix of each destination ends its walk;
      // the words nearer than it that were not valid yet are read again,
      // all in flight, until none is left.
      for (unsigned round = 0;; ++round) {
        int nearest = -1;   // one_dest: this thread's nearest valid prefix
#pragma unroll
        for (int j = 0; j < kLookLoads; ++j) {
          if ((need >> j) & 1 && static_cast<unsigned int>(word[j] >> 32) == epoch &&
              word[j] & kPrefix) {
            const int row = static_cast<int>(top - (slot[j] >> 10));
            if (one_dest) {
              nearest = max(nearest, row);
            } else {
              atomicMax(&stop[slot[j] & 1023], row);
            }
          }
        }
        if (one_dest && nearest >= 0) atomicMax(&stop[slot[0] & 1023], nearest);
        __syncthreads();
        unsigned pending = 0;
#pragma unroll
        for (int j = 0; j < kLookLoads; ++j) {
          if ((need >> j) & 1 && static_cast<unsigned int>(word[j] >> 32) != epoch &&
              top - (slot[j] >> 10) > stop[slot[j] & 1023]) {
            pending |= 1u << j;
          }
        }
        if (!__syncthreads_or(pending != 0)) break;
        if (round == kMaxPolls) __trap();
#pragma unroll
        for (int j = 0; j < kLookLoads; ++j) {
          if ((pending >> j) & 1) {
            word[j] = load_relaxed(desc + (top - (slot[j] >> 10)) * num_dests + (slot[j] & 1023));
          }
        }
      }
      // Add the prefix at the stop and the aggregates nearer than it.
      int sum = 0;
#pragma unroll
      for (int j = 0; j < kLookLoads; ++j) {
        const int e = slot[j] & 1023;
        if ((need >> j) & 1 && top - (slot[j] >> 10) >= stop[e]) {
          const int value = static_cast<int>(word[j] & 0x7fffffffull);
          if (one_dest) {
            sum += value;
          } else {
            atomicAdd(&found[e], value);
          }
        }
      }
      if (one_dest && sum != 0) atomicAdd(&found[slot[0] & 1023], sum);
      // A destination whose walk ended in this window is closed for the
      // next ones (read there after the barrier, never during this one).
      int open = 0;
      for (int e = tid; e < num_dests; e += kThreads) {
        closed[e] = stop[e] >= 0;
        open |= !closed[e];
      }
      if (!__syncthreads_or(open)) break;
    }
    for (int e = tid; e < num_dests; e += kThreads) {
      prefix[e] = found[e];
      store_relaxed(desc + tile * num_dests + e,
                    (static_cast<unsigned long long>(epoch) << 32) | kPrefix |
                        static_cast<unsigned int>(found[e] + aggregate[e]));
    }
    __syncthreads();
  }
  if (tile == ntiles - 1) {
    for (int e = tid; e < num_dests; e += kThreads) counts[e] = prefix[e] + aggregate[e];
  }

  // Ranks, 32 tokens of a warp at a time in order: the tile's prefix, plus
  // the warp's running count (from its offset), plus the peers in lower
  // lanes. One ballot a bit of the destination id (ceil(log2 E) of them)
  // finds the peers, for all of the warp's groups first; then the lowest
  // peer of each group adds it to the running count, __syncwarp ordering
  // that add before the next group's.
  const unsigned lower = (1u << lane) - 1u;
  const int bits = 32 - __clz(num_dests - 1);
  int dest_of[kPerLane];
  unsigned peers[kPerLane];
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const int k = w * kPerWarp + 32 * i + lane;
    dest_of[i] = k < tokens ? stage[shift + k] : -1;
  }
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const int d = dest_of[i];
    unsigned mask = __ballot_sync(0xffffffffu, d >= 0 && d < num_dests);
    for (int b = 0; b < bits; ++b) {
      const bool one = (d >> b) & 1;
      const unsigned set = __ballot_sync(0xffffffffu, one);
      mask &= one ? set : ~set;
    }
    peers[i] = mask;
  }
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const int k = w * kPerWarp + 32 * i + lane;
    const int d = dest_of[i];
    const bool valid = d >= 0 && d < num_dests;
    const unsigned before = peers[i] & lower;
    int base = 0;
    if (valid && before == 0u) {
      base = atomicAdd(&warp_count[d * kCountStride + w], __popc(peers[i]));
    }
    base = __shfl_sync(0xffffffffu, base, valid ? __ffs(peers[i]) - 1 : lane);
    if (k < tokens) rank[t0 + k] = valid ? prefix[d] + base + __popc(before) : -1;
    __syncwarp();
  }
}

}  // namespace

// Scratch (64-bit words) that dispatch_ranks_i32 needs for n tokens and
// num_dests destinations: the ticket and one descriptor a tile and
// destination.
extern "C" long long dispatch_ranks_scratch_words(long long n, int num_dests) {
  return 1 + static_cast<long long>(num_dests) * ((n + kTile - 1) / kTile);
}

// Launches the single pass on `stream`. Returns the cudaError_t (0 on
// success); refuses n < 1, n >= 2^31, num_dests outside [1, kMaxDests] and
// epoch 0 with cudaErrorInvalidValue. `scratch` holds at least
// dispatch_ranks_scratch_words(n, num_dests) 64-bit words, was zeroed when it
// was allocated, is used by one call at a time, and every call on it passes
// an epoch it has not passed before (1, 2, ...; zero the words again before
// the count wraps). The caller checks types, devices and contiguity.
extern "C" int dispatch_ranks_i32(const void* dest, void* rank, void* counts, void* scratch,
                                  long long n, int num_dests, unsigned int epoch,
                                  void* stream) {
  if (n < 1 || n >= (1LL << 31) || num_dests < 1 || num_dests > kMaxDests || epoch == 0) {
    return cudaErrorInvalidValue;
  }
  const size_t smem = smem_bytes(num_dests);
  if (smem > 48 * 1024) {   // the opt-in is per device: set on every such launch
    const cudaError_t err = cudaFuncSetAttribute(
        dispatch_tiles, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long ntiles = (n + kTile - 1) / kTile;
  dispatch_tiles<<<static_cast<unsigned>(ntiles), kThreads, smem,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(dest), static_cast<int*>(rank), static_cast<int*>(counts),
      static_cast<unsigned long long*>(scratch), n, num_dests, ntiles, epoch);
  return static_cast<int>(cudaGetLastError());
}
