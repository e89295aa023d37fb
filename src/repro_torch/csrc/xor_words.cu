// XOR of two word slabs for Hopper (sm_90a): the coded shuffle's packet
// encode and decode.
//
//   out[i] = a[i] ^ b[i],   i in [0, n)
//
// a, b and out are contiguous arrays of n 32-bit words: the (N, W) int32 or
// uint32 slabs of the coded shuffle, seen flat (n = N * W). Signed and
// unsigned words have the same bits under XOR, so one entry serves both.
//
// Replaces: src/repro/kernels/coded_shuffle/coded_shuffle.py ·
// xor_words_pallas (a grid over row blocks, each program XORing one
// (block_rows, W) tile in VMEM). Its row-block grid is not carried over:
// rows of W = 13 (f32 payload) or 5 (int8) words are not 16-byte
// multiples, so the slabs are walked as flat words instead.
//
// Bound: bytes. Each word is read twice and written once, 12 B a word and
// one integer operation, far below the card's operation rate: at chunk
// 0's encode of the coded path (67.1 M rows of 13 words) the kernel must
// move 10.5 GB, about 3.1 ms at 3.35 TB/s.
//
// Design: a grid-stride loop of 16-byte int4 loads and stores, which is
// what a streaming pass needs to reach the memory rate, while all three
// pointers are 16-byte aligned (the allocator's slabs are). Each thread
// issues kUnroll pairs of loads before its stores, so that enough bytes
// are in flight to cover the memory latency; loads and stores are marked
// streaming (__ldcs / __stcs), since no word is touched twice. The words
// after the last whole int4 (the tail) are done one word at a time by the
// same threads. A view that starts inside a 16-byte unit (one word into a
// slab) takes the one-word loop throughout. Offsets are 64-bit: a launch
// covers every stacked slot at once, and n reaches 0.87 G words here and
// passes 2^31 at larger batches.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;   // 2048 threads: a full SM
constexpr int kUnroll = 4;        // int4 pairs in flight a thread

__global__ void __launch_bounds__(kThreads)
xor_words_kernel(const int* __restrict__ a, const int* __restrict__ b,
                 int* __restrict__ out, long long n_vec, long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long tid = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const int4* a4 = reinterpret_cast<const int4*>(a);
  const int4* b4 = reinterpret_cast<const int4*>(b);
  int4* o4 = reinterpret_cast<int4*>(out);
  for (long long base = tid; base < n_vec; base += stride * kUnroll) {
    int4 x[kUnroll];
    int4 y[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + u * stride;
      if (i < n_vec) {
        x[u] = __ldcs(a4 + i);
        y[u] = __ldcs(b4 + i);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + u * stride;
      if (i < n_vec) {
        __stcs(o4 + i, make_int4(x[u].x ^ y[u].x, x[u].y ^ y[u].y, x[u].z ^ y[u].z,
                                 x[u].w ^ y[u].w));
      }
    }
  }
  for (long long i = 4 * n_vec + tid; i < n; i += stride) out[i] = a[i] ^ b[i];
}

}  // namespace

// Launches out = a ^ b over n words on `stream`. Returns the cudaError_t
// of the launch (0 on success). The caller checks device, type, shape and
// contiguity and allocates `out`.
extern "C" int xor_words_i32(const void* a, const void* b, void* out,
                             long long n, void* stream) {
  if (n <= 0) return cudaErrorInvalidValue;
  const uintptr_t pa = reinterpret_cast<uintptr_t>(a);
  const uintptr_t pb = reinterpret_cast<uintptr_t>(b);
  const uintptr_t po = reinterpret_cast<uintptr_t>(out);
  if ((pa | pb | po) & 3) return cudaErrorMisalignedAddress;
  const long long n_vec = ((pa | pb | po) & 15) ? 0 : n / 4;

  int device = 0;
  int sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (sms <= 0) sms = 1;
  const long long items = n_vec > n - 4 * n_vec ? n_vec : n - 4 * n_vec;
  long long blocks = (items + kThreads - 1) / kThreads;
  const long long most = static_cast<long long>(kBlocksPerSm) * sms;
  if (blocks > most) blocks = most;
  xor_words_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(a), static_cast<const int*>(b),
      static_cast<int*>(out), n_vec, n);
  return static_cast<int>(cudaGetLastError());
}
