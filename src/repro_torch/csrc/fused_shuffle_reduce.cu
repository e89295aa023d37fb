// Fused gather + sorted segment-sum for Hopper (sm_90a): phase B's
// "sort" + "run" of one pipeline chunk, for all m slots in one launch.
//
//   out[i, s, :] = sum_{t : seg[i, t] == s} values[i, gather_idx[i, t], :]
//
// values (m, N, V) float32, gather_idx (m, N) int32 in [0, N), seg (m, N)
// int32, non-decreasing along each row; ids outside [0, num_segments) are
// padding. out (m, num_segments, V) float32; the kernel writes every entry.
//
// Replaces: src/repro/kernels/fused_shuffle_reduce/fused_shuffle_reduce.py ·
// fused_gather_segment_reduce_pallas (a diagonal band of one-hot MXU
// products over fixed 512-token blocks, the value table whole in VMEM).
//
// Bound: bytes. A valid stream row reads its index (4 B) and its gathered
// value row (4 V B) once; the segment ids are read only by a binary search
// per CTA. At V = 11 that is 48 B a valid row, one add per value.
//
// Design: one CTA per (slot, segment). Two threads binary-search the
// sorted seg row for the segment's rows [lo, hi), so padding rows are
// never touched and no CTA depends on another. Thread j sums the rows
// lo + j, lo + j + kThreads, ... in that order, for up to kCols value
// columns at a time in registers; a fixed-shape tree in shared memory
// then adds the kThreads partial sums. No float atomics: a segment's sum
// depends only on its own rows in stream order, never on the padded slab
// length N or on where the segment starts. So the pipelined and the
// sequential engine, which feed each cluster the same rows in the same
// order inside slabs of different lengths, agree bit for bit — the
// invariant the TPU kernel holds with its fixed 512-token blocks.
//
// Cost of the simple design: a segment's rows go through one CTA, so a
// hot cluster holding a large share of a chunk runs on one SM while the
// others idle. Splitting hot segments across CTAs in a fixed order is
// left to a later change.

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
fused_gather_segment_sum(const float* __restrict__ values,
                         const int* __restrict__ gather_idx,
                         const int* __restrict__ seg, float* __restrict__ out,
                         long long n, int v, int num_segments) {
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
  const int* idx = gather_idx + row0 + lo;
  const float* table = values + row0 * v;

  for (int c0 = 0; c0 < v; c0 += kCols) {
    const int nc = min(kCols, v - c0);
    float acc[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[c] = 0.f;
    for (long long t = threadIdx.x; t < len; t += kThreads) {
      const int g = idx[t];
      if (g < 0 || g >= n) continue;  // malformed index: never read outside
      const float* row = table + static_cast<long long>(g) * v + c0;
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

// Launches the fused reduce of m slots on `stream`. Returns the
// cudaError_t of the launch (0 on success). The caller checks shapes,
// types and contiguity.
extern "C" int fused_gather_segment_sum_f32(const void* values,
                                            const void* gather_idx,
                                            const void* seg, void* out, int m,
                                            long long n, int v,
                                            int num_segments, void* stream) {
  if (m <= 0 || n <= 0 || v <= 0 || num_segments <= 0) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid(num_segments, m);
  fused_gather_segment_sum<<<grid, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(values), static_cast<const int*>(gather_idx),
      static_cast<const int*>(seg), static_cast<float*>(out), n, v,
      num_segments);
  return static_cast<int>(cudaGetLastError());
}
