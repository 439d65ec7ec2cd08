// Blockwise (chunked-prompt) prefill attention over a codebook-quantized
// K/V page view.
//
// Replaces: src/repro/kernels/blockwise_prefill.py:
//   blockwise_prefill_quant_pallas.
// Computes: what blockwise_prefill.cu computes (q [B, C, H, hd] against a
//   view of S rows, GQA grouping, k_pos <= q_pos visibility with an optional
//   window, optional softcap, online softmax over token_tile rows, output
//   [B, C, H, hd] f32), over a view of packed codebook indices:
//   k_words / v_words [B, S, KV, Wd] (the pack_rows layout over the head dim,
//   Wd = ceil(hd / lanes), S = npg * page rows in logical order) with one
//   codebook per page and group, k_cb / v_cb [B, npg, Gcb, 2^BITS] f32,
//   Gcb = 1 ("page" mode) or KV ("head" mode).  The token tile divides the
//   page, so each tile reads one page's codebooks.
// Bound on H100: operations at the serving shape (2 * (hd + hd) FLOPs per
//   visible (query, key) pair against BITS / 32 of the dense view's K/V
//   bytes).
// Design: one block per (query chunk of QB positions, kv head, batch row), as
//   blockwise_prefill.cu.  The block's R = rep * QB query rows and their
//   running max, normaliser and accumulator stay in shared memory while it
//   loops over the view one tile at a time.  Per tile it first stages the
//   tile's positions and skips the tile when no row is visible to any of its
//   queries (such a tile is a no-op of the recurrence, so skipping it changes
//   no bit); otherwise it stages the page's two codebooks (this kv head's
//   group) as 2^BITS-entry LUTs, unpacks the tile's words with shift+mask
//   and LUT reads into dense f32 rows in shared memory, and runs the
//   online-softmax step shared with the other attention kernels
//   (online_softmax.cuh), where rows that are not visible are selected out
//   of the products, never multiplied by 0.
#include "online_softmax.cuh"
#include "unpack.cuh"

namespace {

using repro::kEps;
using repro::kNegInf;

constexpr int kThreads = 128;
constexpr int kMaxEntries = 256;

struct Geometry {
  int R;
  // float offsets of each shared-memory region
  int q, k, v, p, acc, m, l, corr, kpos, qpos, lut_k, lut_v, total;
};

__host__ __device__ inline Geometry geometry(int rep, int QB, int hd, int T) {
  Geometry g;
  g.R = rep * QB;
  g.q = 0;
  g.k = g.q + g.R * (hd + 1);
  g.v = g.k + T * (hd + 1);
  g.p = g.v + T * hd;
  g.acc = g.p + g.R * (T + 1);
  g.m = g.acc + g.R * hd;
  g.l = g.m + g.R;
  g.corr = g.l + g.R;
  g.kpos = g.corr + g.R;      // ints stored in float-sized slots
  g.qpos = g.kpos + T;
  g.lut_k = g.qpos + QB;
  g.lut_v = g.lut_k + kMaxEntries;
  g.total = g.lut_v + kMaxEntries;
  return g;
}

template <int BITS>
__global__ void __launch_bounds__(kThreads)
blockwise_prefill_quant_kernel(const float* __restrict__ q,
                               const uint32_t* __restrict__ k_words,
                               const uint32_t* __restrict__ v_words,
                               const float* __restrict__ k_cb,
                               const float* __restrict__ v_cb,
                               const int32_t* __restrict__ q_pos,
                               const int32_t* __restrict__ k_pos,
                               float* __restrict__ out, int C, int H, int KV,
                               int S, int QB, int hd, int Wd, int Gcb,
                               int page, int T, float scale, float softcap,
                               int window) {
  using Pk = repro::Packing<BITS>;
  extern __shared__ float smem[];
  const int rep = H / KV;
  const Geometry g = geometry(rep, QB, hd, T);
  const int R = g.R;
  float* Qs = smem + g.q;
  float* Ks = smem + g.k;
  float* Vs = smem + g.v;
  float* P = smem + g.p;
  float* Acc = smem + g.acc;
  float* Ms = smem + g.m;
  float* Ls = smem + g.l;
  float* Corr = smem + g.corr;
  int* Kpos = reinterpret_cast<int*>(smem + g.kpos);
  int* Qpos = reinterpret_cast<int*>(smem + g.qpos);
  float* LutK = smem + g.lut_k;
  float* LutV = smem + g.lut_v;

  const int c0 = blockIdx.x * QB;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int n_q = min(QB, C - c0);     // real query positions of the chunk
  const int npg = S / page;
  const int grp = Gcb == 1 ? 0 : kvh;

  // Row i holds query position c0 + i % QB of head kvh * rep + i / QB.
  for (int idx = threadIdx.x; idx < R * hd; idx += kThreads) {
    const int i = idx / hd, d = idx % hd;
    const int c = c0 + i % QB, h = kvh * rep + i / QB;
    Qs[i * (hd + 1) + d] =
        c < C ? q[((static_cast<int64_t>(b) * C + c) * H + h) * hd + d] : 0.0f;
    Acc[idx] = 0.0f;
  }
  for (int i = threadIdx.x; i < R; i += kThreads) {
    Ms[i] = kNegInf;
    Ls[i] = 0.0f;
  }
  for (int i = threadIdx.x; i < QB; i += kThreads)
    Qpos[i] = c0 + i < C ? q_pos[c0 + i] : 0;
  __syncthreads();

  const repro::CausalVisible visible{Qpos, Kpos, QB, window};
  for (int s0 = 0; s0 < S; s0 += T) {
    // positions first: a tile that no query of the chunk sees is skipped
    int seen = 0;
    for (int t = threadIdx.x; t < T; t += kThreads) {
      const int kp = k_pos[s0 + t];
      Kpos[t] = kp;
      for (int i = 0; i < n_q; ++i) seen |= visible(i, t) ? 1 : 0;
    }
    if (!__syncthreads_or(seen)) continue;

    const int64_t cb_off =
        ((static_cast<int64_t>(b) * npg + s0 / page) * Gcb + grp) *
        Pk::kEntries;
    repro::stage_codebook<BITS>(LutK, k_cb + cb_off, Pk::kEntries);
    repro::stage_codebook<BITS>(LutV, v_cb + cb_off, Pk::kEntries);
    __syncthreads();
    for (int idx = threadIdx.x; idx < T * Wd; idx += kThreads) {
      const int t = idx / Wd, w = idx % Wd;
      const int64_t src =
          ((static_cast<int64_t>(b) * S + s0 + t) * KV + kvh) * Wd + w;
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

    repro::score_tile<kThreads>(Qs, hd + 1, Ks, hd + 1, P, T + 1, R, T, hd,
                                scale, softcap, visible);
    __syncthreads();
    repro::softmax_stats<kThreads>(P, T + 1, R, T, Ms, Ls, Corr, visible);
    __syncthreads();
    repro::accumulate_tile<kThreads>(P, T + 1, Vs, hd, Acc, Corr, R, T, hd,
                                     visible);
    __syncthreads();   // tile fully consumed before the next one is staged
  }

  for (int idx = threadIdx.x; idx < R * hd; idx += kThreads) {
    const int i = idx / hd, e = idx % hd;
    const int c = c0 + i % QB, h = kvh * rep + i / QB;
    if (c < C)
      out[((static_cast<int64_t>(b) * C + c) * H + h) * hd + e] =
          Acc[idx] / fmaxf(Ls[i], kEps);
  }
}

template <int BITS>
int launch(const void* q, const void* k_words, const void* v_words,
           const void* k_cb, const void* v_cb, const void* q_pos,
           const void* k_pos, void* out, int B, int C, int H, int KV, int S,
           int hd, int Wd, int Gcb, int page, int T, float scale,
           float softcap, int window, cudaStream_t stream) {
  const int rep = H / KV;
  const int QB = rep >= 16 ? 1 : 16 / rep;   // about 16 query rows per block
  const Geometry g = geometry(rep, QB, hd, T);
  const size_t bytes = sizeof(float) * static_cast<size_t>(g.total);
  if (bytes > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        blockwise_prefill_quant_kernel<BITS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((C + QB - 1) / QB, KV, B);
  blockwise_prefill_quant_kernel<BITS><<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const uint32_t*>(k_words),
      static_cast<const uint32_t*>(v_words), static_cast<const float*>(k_cb),
      static_cast<const float*>(v_cb), static_cast<const int32_t*>(q_pos),
      static_cast<const int32_t*>(k_pos), static_cast<float*>(out), C, H, KV,
      S, QB, hd, Wd, Gcb, page, T, scale, softcap, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

REPRO_EXPORT_ERROR_STRING

// q [B, C, H, hd] f32; k_words, v_words [B, S, KV, Wd] 32-bit words;
// k_cb, v_cb [B, S / page, Gcb, 2^bits] f32 (Gcb = 1 or KV); q_pos [C],
// k_pos [S] int32; out [B, C, H, hd] f32.  token_tile divides page, page
// divides S.  softcap <= 0 means none; window <= 0 means none.
extern "C" int repro_blockwise_prefill_quant(
    const void* q, const void* k_words, const void* v_words,
    const void* k_cb, const void* v_cb, const void* q_pos, const void* k_pos,
    void* out, int B, int C, int H, int KV, int S, int hd, int Wd, int Gcb,
    int page, int token_tile, int bits, float scale, float softcap,
    int window, void* stream) {
  if (B == 0 || C == 0) return 0;
  if (KV <= 0 || H % KV != 0 || page <= 0 || token_tile <= 0 ||
      page % token_tile != 0 || S % page != 0 || bits <= 0 || bits > 8 ||
      Wd != (hd + 32 / bits - 1) / (32 / bits) || (Gcb != 1 && Gcb != KV))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  REPRO_DISPATCH_BITS(bits, return launch<BITS>(
      q, k_words, v_words, k_cb, v_cb, q_pos, k_pos, out, B, C, H, KV, S, hd,
      Wd, Gcb, page, token_tile, scale, softcap, window, s));
  return 0;
}
