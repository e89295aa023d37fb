// Device clock stamps for Hopper (sm_90a): the measured executor's wave
// timer. Two functions, each launched on the caller's stream (the slot's):
//
//   read_ticks:    ticks = split(%globaltimer), after the anchors
//   stamp_through: dst = src (raw bytes, any dtype), ticks = split(%globaltimer),
//                  by one of two kernels (the ring or the byte path, below)
//
// ticks is a (2,) uint32 (lo, hi) word pair, the format of
// src/repro_torch/kernels/wave_timer/ref.py:split_ticks.
//
// Replaces: src/repro/kernels/wave_timer/wave_timer.py · read_ticks_pallas
// and stamp_through_pallas. On the TPU the stamp is ordered by buffer
// dependencies inside one XLA program: it consumes its anchors and
// produces the buffer the next wave's reduce reads. Here the stream gives
// the same order: a kernel starts after every earlier launch on its
// stream has finished, and every later launch waits for it. The kernels
// still read one byte of each anchor (the reference's data edge) and
// stamp_through still copies, because the next wave's reduce reads the
// copy, as in the reference.
//
// Clock: %globaltimer, a 64-bit device-wide nanosecond timer, read with
// inline PTX. Not %clock64: that counts SM cycles per SM and is not
// synchronised across SMs, so a wave's start and end stamps, taken by
// kernels that may run on different SMs, would not subtract. The timer's
// update granularity (the smallest non-zero step between back-to-back
// reads) depends on the part and is measured by chip_smoke.py.
//
// Bound: launch latency (measured as the device time a launch of
// empty_kernel, back to back), plus for stamp_through its copy: bytes, each byte
// read once and written once. At chunk 0 of the measured path a slot's
// received cluster ids are m * cap = 32 * 163840 int32 (21.0 MB), so the
// copy moves 41.9 MB, 12.5 us at 3.35 TB/s. To stream at that rate the
// card needs a few MB in flight at once (rate x latency), spread over all
// SMs; a grid of threads that each hold one 16-byte load in flight keeps
// far less than that.
//
// Design: read_ticks is one thread. stamp_through has two kernels, chosen
// on the host by the head/body split of wave_timer.py · copy_split:
// * The ring (src and dst agree mod 16, and the body holds at least 16
//   bytes): one persistent CTA a SM (at most), each owning a contiguous
//   share of the 16-byte aligned body. One thread a CTA moves its share in
//   32 KB chunks through a ring of 6 shared-memory stages: a TMA bulk load
//   (cp.async.bulk, completing on the stage's mbarrier), then a bulk store
//   of the stage once it is full; a stage is refilled once its store has
//   read it (cp.async.bulk.wait_group.read). Five loads, 160 KB, stay in
//   flight a SM. The head (bytes before the first 16-byte boundary) and
//   the tail (after the last) are copied by the threads of CTA 0.
// * The byte path (src and dst disagree mod 16, or a body under 16 bytes):
//   a grid-stride loop, one byte a thread an iteration.
// In both, thread 0 of block 0 reads one byte of each anchor and stamps on
// entry, before it copies. Consecutive waves share their boundary stamp,
// so the copy's few microseconds fall into the wave after the boundary. An
// empty primary launches one block of the byte path, which only stamps.

#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr int kMaxAnchors = 8;
constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 4;
constexpr int kChunk = 32 * 1024;    // bytes of one ring stage
constexpr int kRingStages = 6;
constexpr int kRingThreads = 32;
constexpr int kRingSmem = kRingStages * kChunk + kRingStages * 8;

struct Anchors {
  const unsigned char* ptr[kMaxAnchors];
  int count;
};

// One byte of each anchor, through a volatile load the compiler keeps.
__device__ __forceinline__ void read_anchors(const Anchors& anchors) {
  unsigned int acc = 0;
  for (int i = 0; i < anchors.count; ++i) {
    acc += *reinterpret_cast<const volatile unsigned char*>(anchors.ptr[i]);
  }
  asm volatile("" ::"r"(acc));
}

__device__ __forceinline__ void write_stamp(unsigned int* ticks) {
  const uint64_t t = hopper::global_ns();
  ticks[0] = static_cast<unsigned int>(t & 0xFFFFFFFFull);
  ticks[1] = static_cast<unsigned int>(t >> 32);
}

__global__ void read_ticks_kernel(Anchors anchors, unsigned int* ticks) {
  read_anchors(anchors);
  write_stamp(ticks);
}

// Does nothing: its device time a launch, back to back, is the launch
// floor that bounds read_ticks.
__global__ void empty_kernel() {}

__global__ void __launch_bounds__(kThreads)
stamp_through_kernel(const unsigned char* __restrict__ src,
                     unsigned char* __restrict__ dst, long long nbytes, Anchors anchors,
                     unsigned int* ticks) {
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    read_anchors(anchors);
    write_stamp(ticks);
  }
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long tid = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  for (long long i = tid; i < nbytes; i += stride) dst[i] = src[i];
}

// Bytes [head, head + body) (16-byte aligned at both pointers, body a
// multiple of 16) through the ring; [0, head) and [head + body, nbytes) by
// the threads of CTA 0.
__global__ void __launch_bounds__(kRingThreads)
stamp_through_ring_kernel(const unsigned char* __restrict__ src,
                          unsigned char* __restrict__ dst, long long nbytes, long long head,
                          long long body, Anchors anchors, unsigned int* ticks) {
  extern __shared__ __align__(128) unsigned char ring[];
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kRingStages * kChunk);
  const int lane = threadIdx.x;
  if (blockIdx.x == 0) {
    if (lane == 0) {
      read_anchors(anchors);
      write_stamp(ticks);
    }
    __syncwarp();
    const long long tail_at = head + body;
    if (lane < head) dst[lane] = src[lane];
    if (lane < nbytes - tail_at) dst[tail_at + lane] = src[tail_at + lane];
  }
  if (lane != 0) return;

  // This CTA's chunks of the body: [c_begin, c_begin + n).
  const long long chunks = (body + kChunk - 1) / kChunk;
  const long long c_begin = chunks * blockIdx.x / gridDim.x;
  const int n = static_cast<int>(chunks * (blockIdx.x + 1) / gridDim.x - c_begin);
  const unsigned char* s = src + head;
  unsigned char* d = dst + head;
  for (int st = 0; st < kRingStages; ++st) hopper::mbar_init(&full[st], 1);
  hopper::fence_barrier_init();

  auto at = [&](int j) { return (c_begin + j) * kChunk; };
  auto size = [&](int j) {
    const long long left = body - at(j);
    return static_cast<uint32_t>(left < kChunk ? left : kChunk);
  };
  auto load = [&](int j) {
    uint64_t* bar = &full[j % kRingStages];
    hopper::mbar_arrive_expect_tx(bar, size(j));
    hopper::bulk_load(ring + (j % kRingStages) * kChunk, s + at(j), size(j), bar);
  };
  for (int j = 0; j < n && j < kRingStages; ++j) load(j);
  for (int j = 0; j < n; ++j) {
    hopper::mbar_wait(&full[j % kRingStages], (j / kRingStages) & 1);
    hopper::bulk_store(d + at(j), ring + (j % kRingStages) * kChunk, size(j));
    hopper::bulk_commit();
    if (j >= 1 && j - 1 + kRingStages < n) {
      hopper::bulk_wait_read<1>();   // chunk j - 1's store has read its stage
      load(j - 1 + kRingStages);
    }
  }
  hopper::bulk_wait<0>();
}

int pack_anchors(const void* const* ptrs, int count, Anchors* out) {
  if (count < 0 || count > kMaxAnchors || (count > 0 && ptrs == nullptr)) return 1;
  out->count = count;
  for (int i = 0; i < kMaxAnchors; ++i) {
    out->ptr[i] = i < count ? static_cast<const unsigned char*>(ptrs[i]) : nullptr;
    if (i < count && out->ptr[i] == nullptr) return 1;
  }
  return 0;
}

}  // namespace

// One launch of an empty kernel (one thread) on `stream`: the launch
// floor, read_ticks' bound. Returns the cudaError_t of the launch.
extern "C" int wave_timer_launch_floor(void* stream) {
  empty_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

// One stamp into `ticks` ((2,) uint32) after reading one byte of each of
// the `n_anchors` (at most 8) anchors, on `stream`. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int wave_timer_read_ticks(const void* const* anchors, int n_anchors,
                                     void* ticks, void* stream) {
  Anchors a;
  if (pack_anchors(anchors, n_anchors, &a) != 0 || ticks == nullptr) {
    return cudaErrorInvalidValue;
  }
  read_ticks_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      a, static_cast<unsigned int*>(ticks));
  return static_cast<int>(cudaGetLastError());
}

// dst = src over `nbytes` bytes and one stamp into `ticks`, in one kernel
// on `stream`, by the byte path. The caller checks devices and contiguity
// and allocates dst and ticks. Returns the cudaError_t of the launch (0 on
// success).
extern "C" int wave_timer_stamp_through(const void* src, void* dst, long long nbytes,
                                        const void* const* anchors, int n_anchors,
                                        void* ticks, void* stream) {
  Anchors a;
  if (pack_anchors(anchors, n_anchors, &a) != 0 || ticks == nullptr || nbytes < 0 ||
      (nbytes > 0 && (src == nullptr || dst == nullptr))) {
    return cudaErrorInvalidValue;
  }
  int device = 0;
  int sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (sms <= 0) sms = 1;
  long long blocks = (nbytes + kThreads - 1) / kThreads;
  const long long most = static_cast<long long>(kBlocksPerSm) * sms;
  if (blocks > most) blocks = most;
  if (blocks < 1) blocks = 1;
  stamp_through_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(src), static_cast<unsigned char*>(dst), nbytes, a,
      static_cast<unsigned int*>(ticks));
  return static_cast<int>(cudaGetLastError());
}

// dst = src over `nbytes` bytes and one stamp into `ticks`, in one kernel
// on `stream`, through the ring: bytes [head, head + body) by bulk copies
// (both pointers 16-byte aligned there, body > 0 a multiple of 16), the
// rest (under 16 bytes each side) by threads. The split is the caller's
// (wave_timer.py · copy_split). Returns the cudaError_t of the launch (0
// on success).
extern "C" int wave_timer_stamp_through_ring(const void* src, void* dst, long long nbytes,
                                             long long head, long long body,
                                             const void* const* anchors, int n_anchors,
                                             void* ticks, void* stream) {
  Anchors a;
  const uintptr_t ps = reinterpret_cast<uintptr_t>(src) + head;
  const uintptr_t pd = reinterpret_cast<uintptr_t>(dst) + head;
  if (pack_anchors(anchors, n_anchors, &a) != 0 || ticks == nullptr || src == nullptr ||
      dst == nullptr || head < 0 || head >= 16 || body <= 0 || body % 16 != 0 ||
      nbytes - head - body < 0 || nbytes - head - body >= 16 || ((ps | pd) & 15)) {
    return cudaErrorInvalidValue;
  }
  int device = 0;
  int sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (sms <= 0) sms = 1;
  const long long chunks = (body + kChunk - 1) / kChunk;
  const int blocks = static_cast<int>(chunks < sms ? chunks : sms);
  cudaError_t err = cudaFuncSetAttribute(stamp_through_ring_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kRingSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  stamp_through_ring_kernel<<<blocks, kRingThreads, kRingSmem,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(src), static_cast<unsigned char*>(dst), nbytes, head,
      body, a, static_cast<unsigned int*>(ticks));
  return static_cast<int>(cudaGetLastError());
}
