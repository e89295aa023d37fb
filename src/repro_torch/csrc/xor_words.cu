// XOR of 32-bit word slabs for Hopper (sm_90a): the coded shuffle's packet
// encode and decode. Two instances:
//
//   encode: x[r, d, q, :] = pair_ok(s, d, q) ? slab[r, d, q, :] ^ slab[r, q, d, :] : 0
//           s = first + r, pair_ok(s, d, q) = d != q and d != s and q != s
//   flat:   out[i] = a[i] ^ b[i],   i in [0, n)
//
// The encode's slab is the (R, m, m, cap2, W) spill of one chunk of R
// senders first .. first + R - 1: all m of them stacked (R = m, first = 0),
// or one slot's own share (R = 1, first = the slot). Block (r, d, q) holds
// the cap2 * W words that sender first + r's records with partner d send
// to destination q. Its packet for the unordered pair {d, q}
// is the XOR of its two blocks (s, d, q) and (s, q, d), written to both;
// blocks with no packet (d == q, or a pair that includes s) are zeros. The
// flat instance is the decode (packet ^ rebuilt slab) and takes any two
// contiguous word arrays. Signed and unsigned words have the same bits under
// XOR, so one entry serves int32 and uint32.
//
// Replaces: src/repro/kernels/coded_shuffle/coded_shuffle.py ·
// xor_words_pallas (a grid over row blocks, each program XORing one
// (block_rows, W) tile in VMEM), and with it the reference's encode around
// it (src/repro/core/mapreduce.py: swapaxes(slab, 0, 1), the XOR, then
// jnp.where(pair_ok, x, 0)). Rows of W = 13 (f32 payload) or 5 (int8) words
// are not 16-byte multiples, so the words are walked flat, not by rows.
//
// Bound: bytes, one integer operation a word. The flat instance reads two
// words and writes one: 12 B a word (3.1 ms at the coded path's chunk 0,
// 0.87 G words, at 3.35 TB/s). Done as a swapped copy, a flat XOR and a
// mask pass, the encode moves about 28 B a word; folded into one kernel it
// reads each packet word once and writes it once (8 B), and writes a zero
// word without reading it (4 B): about 5.8 GB at chunk 0, 1.7 ms.
//
// Design: both instances are one-shot grids in which each thread loads one
// 16-byte int4 of each operand and stores their XOR; neighbouring threads
// and CTAs stream neighbouring addresses, and the card keeps enough CTAs
// resident to hold the memory rate's bytes in flight. The encode's grid is
// (tile of a block, item): an item is one sender s and one unordered pair
// d <= q, so a CTA reads the same tile of the two blocks (s, d, q) and
// (s, q, d) once and stores their XOR into both, or stores zeros into both
// without a read. Tried on the H100 and not faster on the flat instance:
// 2, 4 or 8 int4s in flight a thread, 128 or 512 threads a CTA, streaming
// (__ldcs / __stcs) or read-only loads, the L2::256B prefetch hint, a
// persistent grid-stride loop, and a persistent ring of TMA bulk copies
// (8-32 KB stages, as the stamp copy uses).
// Alignment: the vector path needs every base (and, for the encode, every
// block) at a 16-byte boundary; a chunk's spill starts at a row offset of
// a larger slab, so a view may start 4, 8 or 12 bytes in. Such calls run
// the same kernels on single words (coalesced 4-byte loads). The flat
// instance's last n % 4 words are done by CTA 0. Offsets are 64-bit: a
// launch covers every stacked slot at once.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int4 operator^(const int4& x, const int4& y) {
  return make_int4(x.x ^ y.x, x.y ^ y.y, x.z ^ y.z, x.w ^ y.w);
}

template <typename Word>
__device__ __forceinline__ Word zero_word();
template <>
__device__ __forceinline__ int4 zero_word<int4>() { return make_int4(0, 0, 0, 0); }
template <>
__device__ __forceinline__ int zero_word<int>() { return 0; }

// out[i] = a[i] ^ b[i] over [0, n_words) Words, one a thread; CTA 0 also
// does the `tail` ints after the last whole Word.
template <typename Word>
__global__ void __launch_bounds__(kThreads)
xor_flat_kernel(const Word* __restrict__ a, const Word* __restrict__ b,
                Word* __restrict__ out, long long n_words, const int* __restrict__ a_tail,
                const int* __restrict__ b_tail, int* __restrict__ out_tail, int tail) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i < n_words) out[i] = a[i] ^ b[i];
  if (blockIdx.x == 0 && threadIdx.x < tail) {
    out_tail[threadIdx.x] = a_tail[threadIdx.x] ^ b_tail[threadIdx.x];
  }
}

// One item of the encode: slab row r = blockIdx.y / (m (m + 1) / 2), whose
// sender is first + r, the unordered pair d <= q of the rest of blockIdx.y;
// this CTA's tile of the block_words Words of blocks (r, d, q) and (r, q, d).
template <typename Word>
__global__ void __launch_bounds__(kThreads)
xor_encode_kernel(const Word* __restrict__ slab, Word* __restrict__ x, int m, int first,
                  long long block_words) {
  const int pairs = m * (m + 1) / 2;
  const int r = blockIdx.y / pairs;
  const int s = first + r;
  int t = blockIdx.y - r * pairs;
  int d = 0;
  while (t >= m - d) {          // row d of the upper triangle holds q = d .. m-1
    t -= m - d;
    ++d;
  }
  const int q = d + t;
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= block_words) return;
  const long long dq = ((static_cast<long long>(r) * m + d) * m + q) * block_words + i;
  const long long qd = ((static_cast<long long>(r) * m + q) * m + d) * block_words + i;
  if (d == q || d == s || q == s) {
    x[dq] = zero_word<Word>();
    if (d != q) x[qd] = zero_word<Word>();
    return;
  }
  const Word p = slab[dq] ^ slab[qd];
  x[dq] = p;
  x[qd] = p;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// Launches out = a ^ b over n words on `stream`. Returns the cudaError_t
// of the launch (0 on success). The caller checks device, type, shape and
// contiguity and allocates `out`.
extern "C" int xor_words_i32(const void* a, const void* b, void* out, long long n,
                             void* stream) {
  if (n <= 0) return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
       reinterpret_cast<uintptr_t>(out)) & 3) {
    return cudaErrorMisalignedAddress;
  }
  const int* ai = static_cast<const int*>(a);
  const int* bi = static_cast<const int*>(b);
  int* oi = static_cast<int*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (aligned16(a) && aligned16(b) && aligned16(out)) {
    const long long n_vec = n / 4;
    const int tail = static_cast<int>(n - 4 * n_vec);
    const long long blocks = n_vec > 0 ? (n_vec + kThreads - 1) / kThreads : 1;
    xor_flat_kernel<int4><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
        static_cast<const int4*>(a), static_cast<const int4*>(b), static_cast<int4*>(out),
        n_vec, ai + 4 * n_vec, bi + 4 * n_vec, oi + 4 * n_vec, tail);
  } else {
    const long long blocks = (n + kThreads - 1) / kThreads;
    xor_flat_kernel<int><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
        ai, bi, oi, n, nullptr, nullptr, nullptr, 0);
  }
  return static_cast<int>(cudaGetLastError());
}

// Launches the packet encode of one chunk on `stream`: slab and x are
// (senders, m, m, block_words) int32 words of senders first .. first +
// senders - 1, x allocated by the caller; every word of x is written.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int xor_encode_packets_i32(const void* slab, void* x, int senders, int m, int first,
                                      long long block_words, void* stream) {
  if (m <= 0 || senders <= 0 || first < 0 || first + senders > m || block_words <= 0) {
    return cudaErrorInvalidValue;
  }
  const long long items = static_cast<long long>(senders) * m * (m + 1) / 2;
  if (items > 65535) return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(slab) | reinterpret_cast<uintptr_t>(x)) & 3) {
    return cudaErrorMisalignedAddress;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (aligned16(slab) && aligned16(x) && block_words % 4 == 0) {
    const long long words = block_words / 4;
    const dim3 grid(static_cast<unsigned>((words + kThreads - 1) / kThreads),
                    static_cast<unsigned>(items));
    xor_encode_kernel<int4><<<grid, kThreads, 0, st>>>(static_cast<const int4*>(slab),
                                                       static_cast<int4*>(x), m, first, words);
  } else {
    const dim3 grid(static_cast<unsigned>((block_words + kThreads - 1) / kThreads),
                    static_cast<unsigned>(items));
    xor_encode_kernel<int><<<grid, kThreads, 0, st>>>(static_cast<const int*>(slab),
                                                      static_cast<int*>(x), m, first, block_words);
  }
  return static_cast<int>(cudaGetLastError());
}
