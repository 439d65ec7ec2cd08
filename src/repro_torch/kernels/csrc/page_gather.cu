// Page gather: the engine's paged KV pool -> a per-slot logical view.
//
// Replaces: src/repro/kernels/paged_attention.py:page_gather_pallas.
// Computes: out[b, j * page + t, ...] = pool[phys(b, j), t, ...] with
//   phys(b, j) = alive[b] ? table[b, j] : 0, for a pool [P+1, page, ...] of
//   any element type (page 0 is the trash page every dead slot reads).  The
//   wrapper passes a page as `page_bytes` opaque bytes, so one kernel serves
//   every dtype and feature shape.  Physical ids outside [0, P] are clamped, so
//   no table entry can read outside the pool.
// Bound on H100: bytes.  It reads each referenced page once per reference and
//   writes B * npg pages; there is no arithmetic.
// Design: one block per (logical page, slot), grid (npg, B).  The block picks
//   its physical page from the table and copies it with consecutive threads on
//   consecutive 16-byte words (4- or 1-byte words when the page size or the
//   base address is not a multiple of 16).  It only copies, so the output
//   equals ref.gather_pages_ref bit for bit.
#include "unpack.cuh"

namespace {

constexpr int kThreads = 128;

template <typename Word>
__global__ void __launch_bounds__(kThreads)
page_gather_kernel(const Word* __restrict__ pool,
                   const int32_t* __restrict__ table,
                   const int32_t* __restrict__ alive, Word* __restrict__ out,
                   int npg, int n_phys, int64_t words_per_page) {
  const int j = blockIdx.x;
  const int b = blockIdx.y;
  int phys = alive[b] != 0 ? table[static_cast<int64_t>(b) * npg + j] : 0;
  phys = phys < 0 ? 0 : (phys >= n_phys ? n_phys - 1 : phys);
  const Word* src = pool + static_cast<int64_t>(phys) * words_per_page;
  Word* dst = out + (static_cast<int64_t>(b) * npg + j) * words_per_page;
  for (int64_t i = threadIdx.x; i < words_per_page; i += kThreads)
    dst[i] = src[i];
}

template <typename Word>
int launch(const void* pool, const void* table, const void* alive, void* out,
           int B, int npg, int n_phys, int64_t page_bytes,
           cudaStream_t stream) {
  const dim3 grid(npg, B);
  page_gather_kernel<Word><<<grid, kThreads, 0, stream>>>(
      static_cast<const Word*>(pool), static_cast<const int32_t*>(table),
      static_cast<const int32_t*>(alive), static_cast<Word*>(out), npg,
      n_phys, page_bytes / static_cast<int64_t>(sizeof(Word)));
  return static_cast<int>(cudaGetLastError());
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
  if (B == 0 || npg == 0 || page_bytes == 0) return 0;
  if (n_phys <= 0 || page_bytes < 0 || page_bytes % word_bytes != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (word_bytes) {
    case 16: return launch<uint4>(pool, table, alive, out, B, npg, n_phys,
                                  page_bytes, s);
    case 4: return launch<uint32_t>(pool, table, alive, out, B, npg, n_phys,
                                    page_bytes, s);
    case 1: return launch<uint8_t>(pool, table, alive, out, B, npg, n_phys,
                                   page_bytes, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
