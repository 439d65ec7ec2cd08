// Absorbed-MLA paged decode attention over codebook-quantized latent pages.
//
// Replaces: src/repro/kernels/paged_attention.py:
//   mla_paged_attention_quant_pallas.
// Computes: what mla_paged_attention.cu computes, over pages that store
//   packed codebook indices: c_words [P+1, page, Wc] and r_words [P+1, page,
//   Wr] (the pack_rows layout over the feature axis: lane l of word w holds
//   index w * lanes + l at bit offset l * BITS; Wc = ceil(L / lanes), Wr =
//   ceil(R / lanes)) and one codebook per page and tensor, c_cb / r_cb
//   [P+1, 1, 2^BITS] f32.  Feature d of latent row t on page p is
//   c_cb[p, 0, unpack(c_words[p, t, d / lanes], d % lanes)] (r alike).  Rows
//   past pos[b] are not visible; a dead slot reads nothing and gets 0.
//   Output out [B, H, L] f32.
// Bound on H100: bytes.  A slot reads its (pos + 1) visible rows' words,
//   (pos + 1) * (Wc + Wr) * 4 bytes (BITS / 32 of the dense pages'), plus two
//   codebooks per page.
// Design: mla_paged_attention.cu's body (mla_attention.cuh) with another
//   staging step.  One block per slot walks the slot's pages; per page it
//   stages the page's two codebooks as 2^BITS-entry LUTs, then per tile of
//   up to 16 visible rows it unpacks the rows' c and r words with shift+mask
//   and LUT reads into dense [c | r] rows in shared memory (no row past pos
//   is staged), and attends them for all H heads at once.  Physical ids
//   outside [0, P] are clamped.
#include "mla_attention.cuh"
#include "unpack.cuh"

namespace {

namespace mla = repro::mla;

constexpr int kMaxEntries = 256;

template <int BITS>
__global__ void __launch_bounds__(mla::kThreads)
mla_paged_attention_quant_kernel(const float* __restrict__ q_eff,
                                 const float* __restrict__ q_rope,
                                 const uint32_t* __restrict__ c_words,
                                 const uint32_t* __restrict__ r_words,
                                 const float* __restrict__ c_cb,
                                 const float* __restrict__ r_cb,
                                 const int32_t* __restrict__ table,
                                 const int32_t* __restrict__ pos,
                                 const int32_t* __restrict__ alive,
                                 float* __restrict__ out, int H, int L,
                                 int R, int Wc, int Wr, int page, int npg,
                                 int n_phys, float scale) {
  using Pk = repro::Packing<BITS>;
  extern __shared__ float smem[];
  const mla::Geometry g = mla::geometry(H, L, R, 2 * kMaxEntries);
  const int D = L + R, W = Wc + Wr;
  float* Qs = smem + g.q;
  float* KVs = smem + g.kv;
  float* P = smem + g.p;
  float* Ms = smem + g.m;
  float* Ls = smem + g.l;
  float* Corr = smem + g.corr;
  float* LutC = smem + g.extra;
  float* LutR = LutC + kMaxEntries;
  const int b = blockIdx.x;
  mla::stage_queries(q_eff, q_rope, Qs, Ms, Ls, b, H, L, R);
  float acc[mla::kMaxHeads][mla::kMaxCols] = {};

  const int p_b = pos[b];
  int n_pages = 0;
  if (alive[b] != 0 && p_b >= 0) n_pages = min(npg, p_b / page + 1);

  for (int j = 0; j < n_pages; ++j) {
    int phys = table[static_cast<int64_t>(b) * npg + j];
    phys = phys < 0 ? 0 : (phys >= n_phys ? n_phys - 1 : phys);
    const int n_valid = min(page, p_b - j * page + 1);   // >= 1
    __syncthreads();   // the previous page's LUTs fully consumed
    repro::stage_codebook<BITS>(
        LutC, c_cb + static_cast<int64_t>(phys) * Pk::kEntries,
        Pk::kEntries);
    repro::stage_codebook<BITS>(
        LutR, r_cb + static_cast<int64_t>(phys) * Pk::kEntries,
        Pk::kEntries);
    for (int t0 = 0; t0 < n_valid; t0 += mla::kTile) {
      const int T = min(mla::kTile, n_valid - t0);
      const int64_t row0 = static_cast<int64_t>(phys) * page + t0;
      __syncthreads();   // previous tile consumed, LUTs staged
      for (int idx = threadIdx.x; idx < T * W; idx += mla::kThreads) {
        const int t = idx / W, w = idx % W;
        const bool is_c = w < Wc;
        const uint32_t word = is_c ? c_words[(row0 + t) * Wc + w]
                                   : r_words[(row0 + t) * Wr + (w - Wc)];
        const float* lut = is_c ? LutC : LutR;
        const int width = is_c ? L : R;
        const int d0 = (is_c ? w : w - Wc) * Pk::kLanes;
        float* dst = KVs + t * D + (is_c ? 0 : L);
#pragma unroll
        for (int l = 0; l < Pk::kLanes; ++l)
          if (d0 + l < width)
            dst[d0 + l] = lut[repro::unpack_lane<BITS>(word, l)];
      }
      __syncthreads();
      mla::attend_tile(Qs, KVs, P, Ms, Ls, Corr, acc, H, T, L, D, scale);
    }
  }
  __syncthreads();
  mla::store(out, acc, Ls, b, H, L);
}

template <int BITS>
int launch(const void* q_eff, const void* q_rope, const void* c_words,
           const void* r_words, const void* c_cb, const void* r_cb,
           const void* table, const void* pos, const void* alive, void* out,
           int B, int H, int L, int R, int Wc, int Wr, int page, int npg,
           int n_phys, float scale, cudaStream_t stream) {
  size_t bytes = 0;
  const int err = mla::prepare(mla_paged_attention_quant_kernel<BITS>, H, L,
                               R, 2 * kMaxEntries, &bytes);
  if (err != 0) return err;
  mla_paged_attention_quant_kernel<BITS><<<B, mla::kThreads, bytes,
                                           stream>>>(
      static_cast<const float*>(q_eff), static_cast<const float*>(q_rope),
      static_cast<const uint32_t*>(c_words),
      static_cast<const uint32_t*>(r_words), static_cast<const float*>(c_cb),
      static_cast<const float*>(r_cb), static_cast<const int32_t*>(table),
      static_cast<const int32_t*>(pos), static_cast<const int32_t*>(alive),
      static_cast<float*>(out), H, L, R, Wc, Wr, page, npg, n_phys, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

REPRO_EXPORT_ERROR_STRING

// q_eff [B, H, L], q_rope [B, H, R] f32; c_words [n_phys, page, Wc], r_words
// [n_phys, page, Wr] 32-bit words; c_cb, r_cb [n_phys, 1, 2^bits] f32;
// table [B, npg], pos [B], alive [B] int32; out [B, H, L] f32.  H <= 16 and
// L <= 512.
extern "C" int repro_mla_paged_attention_quant(
    const void* q_eff, const void* q_rope, const void* c_words,
    const void* r_words, const void* c_cb, const void* r_cb,
    const void* table, const void* pos, const void* alive, void* out, int B,
    int H, int L, int R, int Wc, int Wr, int page, int npg, int n_phys,
    int bits, float scale, void* stream) {
  if (B == 0 || H == 0 || L == 0) return 0;
  if (R < 0 || page <= 0 || npg <= 0 || n_phys <= 0 || bits <= 0 ||
      bits > 8 || Wc != (L + 32 / bits - 1) / (32 / bits) ||
      Wr != (R + 32 / bits - 1) / (32 / bits))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  REPRO_DISPATCH_BITS(bits, return launch<BITS>(
      q_eff, q_rope, c_words, r_words, c_cb, r_cb, table, pos, alive, out, B,
      H, L, R, Wc, Wr, page, npg, n_phys, scale, s));
  return 0;
}
