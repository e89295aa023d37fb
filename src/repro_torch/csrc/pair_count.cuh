// Counting (id, weight) pairs into per-slot cells on Hopper (sm_90a): the
// skeleton shared by the histogram (kernel 1) and the count-min sketch
// (kernel 4). A kernel supplies the cells a pair adds to; this header reads
// the pairs, keeps the counters in shared memory and merges them into `out`.
//
// Inputs: ids (m, k) int32 and weights (m, k), both row-major; out (m, total)
// float32, zeroed by the caller. Two instances, by the weights' type:
//   mask   uint8 0/1 weights (a torch.bool tensor): a pair with weight 1 adds
//          1 to its cells. Counters are uint32, added with native integer
//          shared atomics (ATOMS.POPC.INC), turned into float32 once, at the
//          merge. 5 bytes a pair.
//   float  float32 weights: a pair adds its weight. Counters are float32;
//          sm_90a has no native shared float add, so each add is a
//          compare-and-swap loop (ATOMS.CAST.SPIN). 8 bytes a pair.
//
// Reads. Each row is split into a scalar head, a body read as 16-byte int4
// loads of ids with the matching uchar4 (mask) or float4 (float) of weights,
// kUnroll of each in flight a thread (each kernel picks it), and a scalar
// tail. The body starts at the row's first pair whose id and weight are both
// aligned for those loads; where the two pointers disagree mod 4 pairs there
// is none and the row is read one pair at a time. kernels/pair_split.py
// mirrors the split (tested).
//
// Counters. A CTA owns a window of a row's cells. Where the row has at most
// kWindow cells the window is all of them, and the CTA keeps `copies`
// private copies (warp w adds into copy w mod copies, `stride` words apart:
// odd, so one cell of two copies falls in two banks) within kCopyBudget.
// Wider rows are cut into kWindow-cell windows, one copy each, and the CTAs
// that own a row's windows (up to kMaxCluster) form a thread-block cluster
// that reads one range of pairs: each CTA reads every pair of the range and
// adds those of its own window. The cluster is scheduled at once, so its
// CTAs read each line of the range at about the same time and all but the
// first read come from L2. (Adding each pair once, into its owner CTA through
// distributed shared memory, compiles to generic ATOM instructions, which
// ran slower than these L2 reads for both instances on the H100.) Past
// kMaxCluster windows, more clusters (blockIdx.y) read the range again.
//
// Grid. x: the pieces of a row (contiguous ranges of the body's int4s; piece
// 0 also takes the head and the tail) times the cluster's CTAs; y: the
// cluster windows; z: the slots. Narrow rows: one wave at the occupancy the
// kernel's real shared memory allows, which fills the card at m = 1 too.
// Wide rows: kWideWaves waves of resident clusters, so that a window that
// holds a Zipf-hot id is split over more CTAs.
//
// Merge. Each CTA adds the sum of its copies of every non-zero cell into
// `out` with one float atomicAdd. Integer-valued float32 sums at or below
// 2^24 are exact in any order, so the mask instance equals its plain version
// bit for bit wherever a cell stays at or below 2^24; above that the plain
// version's float sums themselves stop counting.

#pragma once

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace pair_count {

constexpr int kThreads = 512;
constexpr int kMinBlocks = 2;  // launch bounds: up to 64 registers, and ptxas spills nothing
constexpr int kWarps = kThreads / 32;
constexpr int kWindow = 1 << 15;        // cells of a wide row's window: 128 KB
constexpr int kMaxCluster = 8;          // the portable cluster size
constexpr int kCopyBudget = 48 * 1024;  // bytes of private counter copies a CTA
constexpr int kWideWaves = 4;

struct Params {
  long long k;  // pairs a row
  int total;    // cells a row of `out`
  int phase;    // element phase of the ids and weights pointers mod 4; -1: none
  int copies;   // private counter copies a CTA (1 for a wide row)
  int stride;   // words between two copies
  int window;   // cells a CTA owns
  int cluster;  // CTAs that read one range of pairs
};

// Row `row`'s split: pairs [0, head) and [head + 4 units, k) one at a time,
// [head, head + 4 units) as int4s. Mirrors pair_split.row_split.
__device__ __forceinline__ void row_split(long long k, int phase, int row, long long& head,
                                          long long& units) {
  if (phase < 0) {
    head = 0;
    units = 0;
    return;
  }
  const long long start = (static_cast<long long>(phase) + static_cast<long long>(row) * k) & 3;
  head = min(k, (4 - start) & 3);
  units = (k - head) >> 2;
}

// The cells [first, first + owned) of a row that this CTA owns.
__device__ __forceinline__ void window_of(const Params& p, int& first, int& owned) {
  first = (blockIdx.y * p.cluster + blockIdx.x % p.cluster) * p.window;
  owned = min(p.window, p.total - first);
}

template <class W>
struct Vec;
template <>
struct Vec<uint8_t> {
  using type = uchar4;
};
template <>
struct Vec<float> {
  using type = float4;
};

template <class V>
__device__ __forceinline__ auto lane_of(const V& v, int j) -> decltype(v.x) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// One pair's add into a shared counter.
__device__ __forceinline__ void add(unsigned* counter, uint8_t) { atomicAdd(counter, 1u); }
__device__ __forceinline__ void add(float* counter, float w) { atomicAdd(counter, w); }

// The kernel body. `cells(x, add_cell)` calls add_cell(c) for every cell c
// in [0, total) that the pair with id bits x adds to.
template <int kUnroll, class W, class C, class Cells>
__device__ __forceinline__ void run(const int* __restrict__ ids, const W* __restrict__ w,
                                    float* __restrict__ out, const Params& p, Cells cells) {
  using V = typename Vec<W>::type;
  int first, owned;
  window_of(p, first, owned);
  if (owned <= 0) return;  // a cluster's spare CTA past the row's last window
  extern __shared__ __align__(16) unsigned char smem[];
  C* cnt = reinterpret_cast<C*>(smem);
  for (int i = threadIdx.x; i < p.copies * p.stride; i += kThreads) cnt[i] = C(0);
  __syncthreads();
  C* mine = cnt + ((threadIdx.x >> 5) % p.copies) * p.stride;

  auto add_pair = [&](unsigned x, W wt) {
    if (wt == W(0)) return;
    cells(x, [&](unsigned c) {
      const unsigned rel = c - static_cast<unsigned>(first);
      if (rel < static_cast<unsigned>(owned)) add(mine + rel, wt);
    });
  };

  const int slot = blockIdx.z;
  const int* ids_row = ids + static_cast<long long>(slot) * p.k;
  const W* w_row = w + static_cast<long long>(slot) * p.k;
  const long long piece = blockIdx.x / p.cluster;
  const long long pieces = gridDim.x / p.cluster;
  long long head, units;
  row_split(p.k, p.phase, slot, head, units);
  if (p.phase >= 0) {
    const int4* idv = reinterpret_cast<const int4*>(ids_row + head);
    const V* wv = reinterpret_cast<const V*>(w_row + head);
    const long long u1 = units * (piece + 1) / pieces;
    long long u = units * piece / pieces + threadIdx.x;
    for (; u + (kUnroll - 1) * kThreads < u1; u += kUnroll * kThreads) {
      int4 a[kUnroll];
      V b[kUnroll];
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        a[j] = __ldg(idv + u + j * kThreads);
        b[j] = __ldg(wv + u + j * kThreads);
      }
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          add_pair(static_cast<unsigned>(lane_of(a[j], q)), lane_of(b[j], q));
        }
      }
    }
    for (; u < u1; u += kThreads) {
      const int4 a = __ldg(idv + u);
      const V b = __ldg(wv + u);
#pragma unroll
      for (int q = 0; q < 4; ++q) add_pair(static_cast<unsigned>(lane_of(a, q)), lane_of(b, q));
    }
    if (piece == 0 && threadIdx.x < 8) {  // the head (< 4 pairs) and the tail (< 4)
      const long long t = threadIdx.x < 4 ? threadIdx.x : head + 4 * units + threadIdx.x - 4;
      if (threadIdx.x < 4 ? t < head : t < p.k) {
        add_pair(static_cast<unsigned>(ids_row[t]), w_row[t]);
      }
    }
  } else {
    const long long t1 = p.k * (piece + 1) / pieces;
    for (long long t = p.k * piece / pieces + threadIdx.x; t < t1; t += kThreads) {
      add_pair(static_cast<unsigned>(ids_row[t]), w_row[t]);
    }
  }
  __syncthreads();

  float* dst = out + static_cast<long long>(slot) * p.total + first;
  for (int b = threadIdx.x; b < owned; b += kThreads) {
    C s = cnt[b];
    for (int c = 1; c < p.copies; ++c) s += cnt[c * p.stride + b];
    if (s != C(0)) atomicAdd(dst + b, static_cast<float>(s));
  }
}

// Launches `kernel` (a __global__ taking (ids, w, out, Params, extra...))
// over m rows of k pairs into `total` cells a row, on `stream`. Returns a
// cudaError_t (0 on success).
template <class C, int kUnroll, class Kernel, class W, class... Extra>
int launch(Kernel kernel, const int* ids, const W* w, float* out, int m, long long k, int total,
           int phase, cudaStream_t stream, Extra... extra) {
  if (m <= 0 || m > 65535 || k <= 0 || total <= 0) return cudaErrorInvalidValue;
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (sms <= 0) sms = 1;
  // Pieces past `useful` would find no int4 a thread; below `least` a CTA
  // would count more than 2^31 pairs into one uint32 counter.
  const long long useful = (k + 4LL * kUnroll * kThreads - 1) / (4LL * kUnroll * kThreads);
  const long long least = (k >> 31) + 1;

  Params p{k, total, phase, 1, total, total, 1};
  int groups = 1;
  if (total > kWindow) {
    const int windows = (total + kWindow - 1) / kWindow;
    groups = (windows + kMaxCluster - 1) / kMaxCluster;
    p.cluster = (windows + groups - 1) / groups;
    p.window = p.stride = kWindow;
  } else {
    p.stride = total | 1;
    const long long per_copy = static_cast<long long>(p.stride) * sizeof(C);
    p.copies = static_cast<int>(std::max(1LL, std::min<long long>(kWarps, kCopyBudget / per_copy)));
  }
  const size_t smem = static_cast<size_t>(p.copies) * p.stride * sizeof(C);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;

  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.cluster, groups, m);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = p.cluster > 1 ? 1 : 0;
  long long per_row;
  if (p.cluster > 1) {
    int resident = 0;
    err = cudaOccupancyMaxActiveClusters(&resident, kernel, &cfg);
    if (err != cudaSuccess) return err;
    if (resident <= 0) return cudaErrorLaunchOutOfResources;  // the cluster cannot be resident
    per_row = static_cast<long long>(resident) * kWideWaves / (static_cast<long long>(m) * groups);
  } else {
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
    if (err != cudaSuccess) return err;
    if (per_sm <= 0) return cudaErrorLaunchOutOfResources;
    per_row = static_cast<long long>(per_sm) * sms / m;
  }
  per_row = std::max(least, std::min(useful, std::max(1LL, per_row)));
  cfg.gridDim.x = static_cast<unsigned>(per_row * p.cluster);
  err = cudaLaunchKernelEx(&cfg, kernel, ids, w, out, p, extra...);
  if (err != cudaSuccess) return err;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace pair_count
