// Page gather: the engine's paged KV pool -> a per-slot logical view.
//
// Replaces: src/repro/kernels/paged_attention.py:page_gather_pallas.
// Computes: out[b, j * page + t, ...] = pool[phys(b, j), t, ...] with
//   phys(b, j) = alive[b] ? table[b, j] : 0, for a pool [P+1, page, ...] of
//   any element type (page 0 is the trash page every dead slot reads).  The
//   wrapper passes a page as `page_bytes` opaque bytes, so one kernel serves
//   every dtype and feature shape.  Physical ids outside [0, P] are clamped, so
//   no table entry can read outside the pool.  `alive` is read as the bytes
//   (bool, uint8) or 32-bit words (int32) the caller holds.
// Bound on H100: bytes.  It reads each referenced page once per reference and
//   writes B * npg pages; there is no arithmetic.
// Design: the copy is spread over the card in chunks of kThreads * kUnroll
//   words of a logical page (8 KB with 16-byte words), one block per (chunk,
//   logical page, slot): a prefill slot's 9 pages of 64 KB make 72 blocks,
//   where one block per page made 9.  Each thread issues its kUnroll loads
//   before its stores, so a whole chunk is in flight at once; the slot's
//   alive flag and table entry are read together, not one after the other.
//   Consecutive threads copy consecutive 16-byte words (4- or 1-byte words
//   when the page size or a base address is not a multiple of 16).  It only
//   copies, so the output equals ref.gather_pages_ref bit for bit.
#include "unpack.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kUnroll = 4;
constexpr int kChunkWords = kThreads * kUnroll;

template <typename Word, typename Alive>
__global__ void __launch_bounds__(kThreads)
page_gather_kernel(const Word* __restrict__ pool,
                   const int32_t* __restrict__ table,
                   const Alive* __restrict__ alive, Word* __restrict__ out,
                   int npg, int n_phys, int64_t words_per_page, int chunks) {
  const int j = blockIdx.x / chunks;
  const int64_t lo = static_cast<int64_t>(blockIdx.x - j * chunks) *
                     kChunkWords;
  const int b = blockIdx.y;
  const int entry = table[static_cast<int64_t>(b) * npg + j];
  int phys = alive[b] != 0 ? entry : 0;
  phys = phys < 0 ? 0 : (phys >= n_phys ? n_phys - 1 : phys);
  const Word* src = pool + static_cast<int64_t>(phys) * words_per_page + lo;
  Word* dst = out + (static_cast<int64_t>(b) * npg + j) * words_per_page + lo;
  const int64_t n = words_per_page - lo;     // words left in the page
  Word w[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int64_t i = threadIdx.x + u * kThreads;
    if (i < n) w[u] = src[i];
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int64_t i = threadIdx.x + u * kThreads;
    if (i < n) dst[i] = w[u];
  }
}

template <typename Word, typename Alive>
int launch(const void* pool, const void* table, const void* alive, void* out,
           int B, int npg, int n_phys, int64_t page_bytes,
           cudaStream_t stream) {
  const int64_t words = page_bytes / static_cast<int64_t>(sizeof(Word));
  const int64_t chunks = (words + kChunkWords - 1) / kChunkWords;
  if (chunks * npg > 0x7fffffff || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(chunks * npg), B);
  page_gather_kernel<Word, Alive><<<grid, kThreads, 0, stream>>>(
      static_cast<const Word*>(pool), static_cast<const int32_t*>(table),
      static_cast<const Alive*>(alive), static_cast<Word*>(out), npg, n_phys,
      words, static_cast<int>(chunks));
  return static_cast<int>(cudaGetLastError());
}

template <typename Alive>
int gather(const void* pool, const void* table, const void* alive, void* out,
           int B, int npg, int n_phys, long long page_bytes, int word_bytes,
           void* stream) {
  if (B == 0 || npg == 0 || page_bytes == 0) return 0;
  if (n_phys <= 0 || page_bytes < 0 || page_bytes % word_bytes != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (word_bytes) {
    case 16: return launch<uint4, Alive>(pool, table, alive, out, B, npg,
                                         n_phys, page_bytes, s);
    case 4: return launch<uint32_t, Alive>(pool, table, alive, out, B, npg,
                                           n_phys, page_bytes, s);
    case 1: return launch<uint8_t, Alive>(pool, table, alive, out, B, npg,
                                          n_phys, page_bytes, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

REPRO_EXPORT_ERROR_STRING

// pool [n_phys, page_bytes] bytes; table [B, npg] int32; alive [B] int32;
// out [B, npg, page_bytes] bytes.  word_bytes (16, 4 or 1) divides page_bytes
// and both base addresses.
extern "C" int repro_page_gather(const void* pool, const void* table,
                                 const void* alive, void* out, int B, int npg,
                                 int n_phys, long long page_bytes,
                                 int word_bytes, void* stream) {
  return gather<int32_t>(pool, table, alive, out, B, npg, n_phys, page_bytes,
                         word_bytes, stream);
}

// The same with alive [B] as one byte a slot (bool or uint8).
extern "C" int repro_page_gather_alive8(const void* pool, const void* table,
                                        const void* alive, void* out, int B,
                                        int npg, int n_phys,
                                        long long page_bytes, int word_bytes,
                                        void* stream) {
  return gather<uint8_t>(pool, table, alive, out, B, npg, n_phys, page_bytes,
                         word_bytes, stream);
}
