// Paged GQA decode attention over codebook-quantized KV pages.
//
// Replaces: src/repro/kernels/paged_attention.py:paged_attention_quant_pallas.
// Computes: what paged_attention.cu computes, over pages that store packed
//   codebook indices: k_words / v_words [P+1, page, KV, Wd] (the pack_rows
//   layout over the head dim: lane l of word w holds index w * lanes + l at
//   bit offset l * BITS, Wd = ceil(hd / lanes)) and one codebook per page
//   and group, k_cb / v_cb [P+1, Gcb, 2^BITS] f32, Gcb = 1 ("page" mode: one
//   codebook for every kv head) or KV ("head" mode: one per kv head).  The
//   value of row t, feature d of kv head h on page p is
//   cb[p, Gcb == 1 ? 0 : h, unpack(words[p, t, h, d / lanes], d % lanes)].
//   Rows past pos[b] are not visible; a dead slot reads nothing and gets 0.
//   Output out [B, H, hd] f32.
// Bound on H100: bytes.  A slot reads (pos + 1) rows of K and of V words for
//   each kv head, 2 * (pos + 1) * KV * Wd * 4 bytes (BITS / 32 of the dense
//   pages'), plus one codebook per page and group.
// Design: one block per (kv head, slot), as paged_attention.cu: it keeps its
//   rep query rows and their running max, normaliser and accumulator in
//   shared memory and loops over the slot's pages, stopping at the page that
//   holds pos[b].  Per page it stages the page's two codebooks (this kv
//   head's group) as 2^BITS-entry LUTs, then unpacks the visible rows' words
//   with shift+mask and LUT reads into dense f32 rows in shared memory (no
//   row past pos is staged, scored or summed), and runs the online-softmax
//   step shared with the other attention kernels (online_softmax.cuh).
//   Physical ids outside [0, P] are clamped.
#include "online_softmax.cuh"
#include "unpack.cuh"

namespace {

using repro::kEps;
using repro::kNegInf;

constexpr int kThreads = 128;
constexpr int kMaxEntries = 256;

struct Geometry {
  // float offsets of each shared-memory region
  int q, k, v, p, acc, m, l, corr, lut_k, lut_v, total;
};

__host__ __device__ inline Geometry geometry(int rep, int hd, int page) {
  Geometry g;
  g.q = 0;
  g.k = g.q + rep * (hd + 1);
  g.v = g.k + page * (hd + 1);
  g.p = g.v + page * hd;
  g.acc = g.p + rep * page;
  g.m = g.acc + rep * hd;
  g.l = g.m + rep;
  g.corr = g.l + rep;
  g.lut_k = g.corr + rep;
  g.lut_v = g.lut_k + kMaxEntries;
  g.total = g.lut_v + kMaxEntries;
  return g;
}

template <int BITS>
__global__ void __launch_bounds__(kThreads)
paged_attention_quant_kernel(const float* __restrict__ q,
                             const uint32_t* __restrict__ k_words,
                             const uint32_t* __restrict__ v_words,
                             const float* __restrict__ k_cb,
                             const float* __restrict__ v_cb,
                             const int32_t* __restrict__ table,
                             const int32_t* __restrict__ pos,
                             const int32_t* __restrict__ alive,
                             float* __restrict__ out, int H, int KV, int hd,
                             int Wd, int Gcb, int page, int npg, int n_phys,
                             float scale, float softcap) {
  using Pk = repro::Packing<BITS>;
  extern __shared__ float smem[];
  const int rep = H / KV;
  const Geometry g = geometry(rep, hd, page);
  float* Qs = smem + g.q;
  float* Ks = smem + g.k;
  float* Vs = smem + g.v;
  float* P = smem + g.p;
  float* Acc = smem + g.acc;
  float* Ms = smem + g.m;
  float* Ls = smem + g.l;
  float* Corr = smem + g.corr;
  float* LutK = smem + g.lut_k;
  float* LutV = smem + g.lut_v;

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int grp = Gcb == 1 ? 0 : kvh;

  // Row r holds head kvh * rep + r.
  for (int idx = threadIdx.x; idx < rep * hd; idx += kThreads) {
    const int r = idx / hd, d = idx % hd;
    Qs[r * (hd + 1) + d] =
        q[(static_cast<int64_t>(b) * H + kvh * rep + r) * hd + d];
    Acc[idx] = 0.0f;
  }
  for (int r = threadIdx.x; r < rep; r += kThreads) {
    Ms[r] = kNegInf;
    Ls[r] = 0.0f;
  }

  const int p_b = pos[b];
  int n_pages = 0;
  if (alive[b] != 0 && p_b >= 0) n_pages = min(npg, p_b / page + 1);

  for (int j = 0; j < n_pages; ++j) {
    __syncthreads();   // previous page fully consumed (and setup visible)
    int phys = table[static_cast<int64_t>(b) * npg + j];
    phys = phys < 0 ? 0 : (phys >= n_phys ? n_phys - 1 : phys);
    const int n_valid = min(page, p_b - j * page + 1);   // >= 1
    const int64_t cb_off =
        (static_cast<int64_t>(phys) * Gcb + grp) * Pk::kEntries;
    repro::stage_codebook<BITS>(LutK, k_cb + cb_off, Pk::kEntries);
    repro::stage_codebook<BITS>(LutV, v_cb + cb_off, Pk::kEntries);
    __syncthreads();
    const int64_t base = static_cast<int64_t>(phys) * page;
    for (int idx = threadIdx.x; idx < n_valid * Wd; idx += kThreads) {
      const int t = idx / Wd, w = idx % Wd;
      const int64_t src = ((base + t) * KV + kvh) * Wd + w;
      const uint32_t kw = k_words[src], vw = v_words[src];
      const int d0 = w * Pk::kLanes;
#pragma unroll
      for (int l = 0; l < Pk::kLanes; ++l) {
        if (d0 + l < hd) {
          Ks[t * (hd + 1) + d0 + l] = LutK[repro::unpack_lane<BITS>(kw, l)];
          Vs[t * hd + d0 + l] = LutV[repro::unpack_lane<BITS>(vw, l)];
        }
      }
    }
    __syncthreads();

    // only rows t <= pos were staged: all of them are visible
    const repro::AllVisible all;
    repro::score_tile<kThreads>(Qs, hd + 1, Ks, hd + 1, P, page, rep,
                                n_valid, hd, scale, softcap, all);
    __syncthreads();
    repro::softmax_stats<kThreads>(P, page, rep, n_valid, Ms, Ls, Corr, all);
    __syncthreads();
    repro::accumulate_tile<kThreads>(P, page, Vs, hd, Acc, Corr, rep,
                                     n_valid, hd, all);
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < rep * hd; idx += kThreads) {
    const int r = idx / hd, e = idx % hd;
    out[(static_cast<int64_t>(b) * H + kvh * rep + r) * hd + e] =
        Acc[idx] / fmaxf(Ls[r], kEps);
  }
}

template <int BITS>
int launch(const void* q, const void* k_words, const void* v_words,
           const void* k_cb, const void* v_cb, const void* table,
           const void* pos, const void* alive, void* out, int B, int H,
           int KV, int hd, int Wd, int Gcb, int page, int npg, int n_phys,
           float scale, float softcap, cudaStream_t stream) {
  const Geometry g = geometry(H / KV, hd, page);
  const size_t bytes = sizeof(float) * static_cast<size_t>(g.total);
  if (bytes > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_attention_quant_kernel<BITS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(KV, B);
  paged_attention_quant_kernel<BITS><<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const uint32_t*>(k_words),
      static_cast<const uint32_t*>(v_words), static_cast<const float*>(k_cb),
      static_cast<const float*>(v_cb), static_cast<const int32_t*>(table),
      static_cast<const int32_t*>(pos), static_cast<const int32_t*>(alive),
      static_cast<float*>(out), H, KV, hd, Wd, Gcb, page, npg, n_phys, scale,
      softcap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

REPRO_EXPORT_ERROR_STRING

// q [B, H, hd] f32; k_words, v_words [n_phys, page, KV, Wd] 32-bit words;
// k_cb, v_cb [n_phys, Gcb, 2^bits] f32 (Gcb = 1 or KV); table [B, npg],
// pos [B], alive [B] int32; out [B, H, hd] f32.  softcap <= 0 means none.
extern "C" int repro_paged_attention_quant(
    const void* q, const void* k_words, const void* v_words,
    const void* k_cb, const void* v_cb, const void* table, const void* pos,
    const void* alive, void* out, int B, int H, int KV, int hd, int Wd,
    int Gcb, int page, int npg, int n_phys, int bits, float scale,
    float softcap, void* stream) {
  if (B == 0 || H == 0 || hd == 0) return 0;
  if (KV <= 0 || H % KV != 0 || page <= 0 || npg <= 0 || n_phys <= 0 ||
      bits <= 0 || bits > 8 || Wd != (hd + 32 / bits - 1) / (32 / bits) ||
      (Gcb != 1 && Gcb != KV))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  REPRO_DISPATCH_BITS(bits, return launch<BITS>(
      q, k_words, v_words, k_cb, v_cb, table, pos, alive, out, B, H, KV, hd,
      Wd, Gcb, page, npg, n_phys, scale, softcap, s));
  return 0;
}
