// Device clock stamps for Hopper (sm_90a): the measured executor's wave
// timer. Two kernels, both launched on the caller's stream (the slot's):
//
//   read_ticks:    ticks = split(%globaltimer), after the anchors
//   stamp_through: dst = src (raw bytes, any dtype), ticks = split(%globaltimer)
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
// Bound: launch latency, plus for stamp_through its copy: bytes, each byte
// read once and written once. At chunk 0 of the measured path a slot's
// received cluster ids are m * cap = 32 * 163840 int32 (21.0 MB), so the
// copy moves 41.9 MB, about 12.5 us at 3.35 TB/s.
//
// Design: read_ticks is one thread. stamp_through's thread 0 of block 0
// stamps on entry, then every thread copies in a grid-stride loop of
// 16-byte int4 loads and stores while both pointers are 16-byte aligned,
// and the bytes after the last whole int4 (or all of them, unaligned) one
// byte at a time. Consecutive waves share their boundary stamp, so the
// copy's few microseconds fall into the wave after the boundary. An empty
// primary still launches one block, which only stamps.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxAnchors = 8;
constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 4;

struct Anchors {
  const unsigned char* ptr[kMaxAnchors];
  int count;
};

__device__ __forceinline__ unsigned long long global_timer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// One byte of each anchor, through a volatile load the compiler keeps.
__device__ __forceinline__ void read_anchors(const Anchors& anchors) {
  unsigned int acc = 0;
  for (int i = 0; i < anchors.count; ++i) {
    acc += *reinterpret_cast<const volatile unsigned char*>(anchors.ptr[i]);
  }
  asm volatile("" ::"r"(acc));
}

__device__ __forceinline__ void write_stamp(unsigned int* ticks) {
  const unsigned long long t = global_timer();
  ticks[0] = static_cast<unsigned int>(t & 0xFFFFFFFFull);
  ticks[1] = static_cast<unsigned int>(t >> 32);
}

__global__ void read_ticks_kernel(Anchors anchors, unsigned int* ticks) {
  read_anchors(anchors);
  write_stamp(ticks);
}

__global__ void __launch_bounds__(kThreads)
stamp_through_kernel(const unsigned char* __restrict__ src,
                     unsigned char* __restrict__ dst, long long n_vec,
                     long long nbytes, Anchors anchors, unsigned int* ticks) {
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    read_anchors(anchors);
    write_stamp(ticks);
  }
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long tid = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const int4* s4 = reinterpret_cast<const int4*>(src);
  int4* d4 = reinterpret_cast<int4*>(dst);
  for (long long i = tid; i < n_vec; i += stride) d4[i] = s4[i];
  for (long long i = 16 * n_vec + tid; i < nbytes; i += stride) dst[i] = src[i];
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
// on `stream`. The caller checks devices and contiguity and allocates dst
// and ticks. Returns the cudaError_t of the launch (0 on success).
extern "C" int wave_timer_stamp_through(const void* src, void* dst, long long nbytes,
                                        const void* const* anchors, int n_anchors,
                                        void* ticks, void* stream) {
  Anchors a;
  if (pack_anchors(anchors, n_anchors, &a) != 0 || ticks == nullptr || nbytes < 0 ||
      (nbytes > 0 && (src == nullptr || dst == nullptr))) {
    return cudaErrorInvalidValue;
  }
  const uintptr_t ps = reinterpret_cast<uintptr_t>(src);
  const uintptr_t pd = reinterpret_cast<uintptr_t>(dst);
  const long long n_vec = ((ps | pd) & 15) ? 0 : nbytes / 16;

  int device = 0;
  int sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (sms <= 0) sms = 1;
  const long long tail = nbytes - 16 * n_vec;
  const long long items = n_vec > tail ? n_vec : tail;
  long long blocks = (items + kThreads - 1) / kThreads;
  const long long most = static_cast<long long>(kBlocksPerSm) * sms;
  if (blocks > most) blocks = most;
  if (blocks < 1) blocks = 1;
  stamp_through_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(src), static_cast<unsigned char*>(dst), n_vec,
      nbytes, a, static_cast<unsigned int*>(ticks));
  return static_cast<int>(cudaGetLastError());
}
