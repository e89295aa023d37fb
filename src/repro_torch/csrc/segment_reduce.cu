// Sorted segment-sum of every slot for Hopper (sm_90a): the Reduce "run"
// over pairs already ordered by segment.
//
//   out[i, s, :] = sum_{t : seg[i, t] == s} values[i, t, :]
//
// values (m, N, V) float32, seg (m, N) int32, non-decreasing along each
// row; ids outside [0, num_segments) are dropped (negative ids sort first,
// padding ids >= num_segments last). out (m, num_segments, V) float32;
// the kernel writes every entry.
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
// Design: the fused shuffle-reduce kernel's, without the gather. One CTA
// per (slot, segment). Two threads binary-search the sorted seg row for
// the segment's rows [lo, hi), so dropped rows are never touched and no
// CTA depends on another. Thread j sums the rows lo + j, lo + j + kThreads,
// ... in that order, for up to kCols value columns at a time in registers;
// a fixed-shape tree in shared memory then adds the kThreads partial sums.
// No float atomics: a segment's sum depends only on its own rows in
// stream order, never on the padded length N or on where the segment
// starts. That takes the place of the TPU kernel's fixed-block rule (its
// token block shrinks to N when N < 512, so its order could depend on N).
//
// Cost of the simple design: a segment's rows go through one CTA, so a
// hot segment holding a large share of the rows runs on one SM while the
// others idle.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kCols = 16;  // value columns per pass, kept in registers

__device__ long long lower_bound(const int* seg, long long n, int key) {
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
sorted_segment_sum(const float* __restrict__ values, const int* __restrict__ seg,
                   float* __restrict__ out, long long n, int v,
                   int num_segments) {
  __shared__ float red[kCols][kThreads];
  __shared__ long long range[2];
  const int s = blockIdx.x;
  const int slot = blockIdx.y;
  const long long row0 = static_cast<long long>(slot) * n;
  if (threadIdx.x < 2) {
    range[threadIdx.x] = lower_bound(seg + row0, n, s + threadIdx.x);
  }
  __syncthreads();
  const long long lo = range[0];
  const long long len = range[1] - lo;
  float* out_row = out + (static_cast<long long>(slot) * num_segments + s) * v;
  if (len == 0) {
    for (int c = threadIdx.x; c < v; c += kThreads) out_row[c] = 0.f;
    return;
  }
  const float* rows = values + (row0 + lo) * v;

  for (int c0 = 0; c0 < v; c0 += kCols) {
    const int nc = min(kCols, v - c0);
    float acc[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[c] = 0.f;
    for (long long t = threadIdx.x; t < len; t += kThreads) {
      const float* row = rows + t * v + c0;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        if (c < nc) acc[c] += row[c];
      }
    }
#pragma unroll
    for (int c = 0; c < kCols; ++c) red[c][threadIdx.x] = acc[c];
    __syncthreads();
    for (int stride = kThreads / 2; stride > 0; stride >>= 1) {
      if (threadIdx.x < stride) {
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          red[c][threadIdx.x] += red[c][threadIdx.x + stride];
        }
      }
      __syncthreads();
    }
    if (threadIdx.x < nc) out_row[c0 + threadIdx.x] = red[threadIdx.x][0];
    __syncthreads();
  }
}

}  // namespace

// Launches the sorted segment-sum of m slots on `stream`. Returns the
// cudaError_t of the launch (0 on success). The caller checks shapes,
// types and contiguity.
extern "C" int segment_reduce_sorted_f32(const void* values, const void* seg,
                                         void* out, int m, long long n, int v,
                                         int num_segments, void* stream) {
  if (m <= 0 || n <= 0 || v <= 0 || num_segments <= 0) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid(num_segments, m);
  sorted_segment_sum<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(values), static_cast<const int*>(seg),
      static_cast<float*>(out), n, v, num_segments);
  return static_cast<int>(cudaGetLastError());
}
