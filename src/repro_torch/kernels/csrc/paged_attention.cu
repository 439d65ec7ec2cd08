// Paged GQA decode attention over dense KV pages.
//
// Replaces: src/repro/kernels/paged_attention.py:paged_attention_pallas.
// Computes: for each slot b and head h, one query q[b, 0, h, :] against the
//   slot's logical K/V stream, read through its page table from the pools
//   k_pool / v_pool [P+1, page, KV, hd] (row t of logical page j lives at
//   pool[table[b, j], t]).  Head h reads kv head h / (H / KV).  Logical row s
//   is visible iff s <= pos[b] and alive[b]; logits are (q . k) * scale,
//   optionally softcapped (cap * tanh(x / cap)); softmax is online (running
//   max m, normaliser l, f32 accumulator acc); the output is
//   acc / max(l, 1e-30), so a dead slot (nothing visible) gets 0, as the
//   Pallas kernel gives.  Output out [B, H, hd] f32.
// Bound on H100: bytes.  A slot reads (pos + 1) rows of K and of V for each kv
//   head, 2 * (pos + 1) * KV * hd * 4 bytes, and does about 4 FLOPs per byte.
//   At the serving shapes the work is a few MB, so the time is latency: how
//   many blocks stream their rows at once, and how short each one's chain is.
// Design: the TPU kernel walks a sequential grid of token tiles that carries
//   m / l / acc in scratch.  Here the slot's pages are split over the blocks
//   of a thread-block cluster (split_decode.cuh): a block per (split, group
//   of up to 4 query rows of one kv head, slot), the split count chosen on
//   the host from npg, B and KV (kernels/paged_attention.py: plan; 5 splits
//   of 2 pages, 320 blocks, at the qwen serving shape).  The splits merge in
//   rank order through distributed shared memory: one launch, no workspace,
//   no atomics, the same bits on every call (a second pass over a workspace
//   would cost a launch and a round trip through memory for a merge of a few
//   KB).
//   - Inside a block, tiles of up to 32 logical rows (fewer above hd 128)
//     are double-buffered in shared memory with cp.async, 16-byte copies
//     where hd is a multiple of 4 (else 4-byte copies; the row is
//     zero-padded to a whole 16-byte word): the next tile loads while this
//     one is scored, one __syncthreads a tile.  The split's physical page ids
//     are read once, beside pos.  Only rows s <= pos are staged, scored and
//     summed: rows past pos (a recycled page may hold any bits) are never
//     read.
//   - A lane holds 4 16-byte words of a row (hd 64: 4 lanes a row), so a
//     warp scores 8 rows at once and 4 warps a 32-row tile in one step: one
//     dependent chain of shuffles and exponentials a tile, not one a row.
//     Dot products stay in registers and reduce with shuffles.  Every warp
//     keeps its own running m / l / acc in registers (the query rows in
//     registers too, compiled for 1, 2 or 4 of them), so the scoring loop has
//     no block barrier; the warps' states merge in warp order, then the
//     splits in rank order.
//   Physical ids outside [0, P] are clamped.
#include "split_decode.cuh"
#include "unpack.cuh"

namespace {

using repro::kFullMask;
using repro::kNegInf;
namespace split = repro::split;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxRep = 4;        // query rows of a block
constexpr int kWords = 4;         // 16-byte words of a row a lane holds
constexpr int kMaxHeadDim = 4 * kWords * 32;

struct Geometry {
  int hd4;    // 16-byte words of a staged row
  int lanes;  // lanes that share a row (kWords words each)
  int rows;   // logical rows of a staged tile
  // float offsets of each shared-memory region
  int ring, wacc, bacc, wm, wl, bm, bl, ids, total;
};

// `pages`: logical pages of a split (their physical ids are staged).
__host__ __device__ inline Geometry geometry(int hd, int pages) {
  Geometry g;
  g.hd4 = (hd + 3) / 4;
  g.lanes = 1;
  while (g.lanes * kWords < g.hd4 && g.lanes < 32) g.lanes *= 2;
  g.rows = min(32, 1024 / g.hd4);          // the ring stays within 64 KB
  const int w = 4 * g.hd4;
  g.ring = 0;                               // [2 stages][K, V][rows][w]
  g.wacc = g.ring + 2 * 2 * g.rows * w;     // [kWarps][kMaxRep][w]
  g.bacc = g.wacc + kWarps * kMaxRep * w;   // [kMaxRep][w]
  g.wm = g.bacc + kMaxRep * w;              // [kWarps][kMaxRep]
  g.wl = g.wm + kWarps * kMaxRep;
  g.bm = g.wl + kWarps * kMaxRep;           // [kMaxRep]
  g.bl = g.bm + kMaxRep;
  g.ids = g.bl + kMaxRep;                   // [pages] int
  g.total = g.ids + pages;
  return g;
}

// Stage logical rows [s0, s0 + T) of kv head kvh into Ks / Vs (rows of
// 4 * hd4 floats).
template <bool VEC16>
__device__ __forceinline__ void stage_tile(float* Ks, float* Vs,
                                           const float* __restrict__ k_pool,
                                           const float* __restrict__ v_pool,
                                           const int* ids,
                                           const split::Rows& rows, int s0,
                                           int T, int page, int KV, int kvh,
                                           int hd, int hd4) {
  for (int idx = threadIdx.x; idx < T * hd4; idx += kThreads) {
    const int t = idx / hd4, c = idx % hd4;
    const int64_t src =
        (split::pool_row(ids, rows, s0 + t, page) * KV + kvh) * hd + 4 * c;
    float* kd = Ks + t * 4 * hd4 + 4 * c;
    float* vd = Vs + t * 4 * hd4 + 4 * c;
    if (VEC16) {
      split::cp_async16(kd, k_pool + src, 16);
      split::cp_async16(vd, v_pool + src, 16);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool in = 4 * c + i < hd;
        split::cp_async4(kd + i, in ? k_pool + src + i : k_pool, in ? 4 : 0);
        split::cp_async4(vd + i, in ? v_pool + src + i : v_pool, in ? 4 : 0);
      }
    }
  }
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 shfl_xor4(float4 v, int off) {
  v.x += __shfl_xor_sync(kFullMask, v.x, off);
  v.y += __shfl_xor_sync(kFullMask, v.y, off);
  v.z += __shfl_xor_sync(kFullMask, v.z, off);
  v.w += __shfl_xor_sync(kFullMask, v.w, off);
  return v;
}

// REP: query rows a block holds in registers (1, 2 or 4; the kv head's
// rep query heads go to ceil(rep / REP) blocks).
template <bool VEC16, int REP>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ k_pool,
                       const float* __restrict__ v_pool,
                       const int32_t* __restrict__ table,
                       const int32_t* __restrict__ pos,
                       const int32_t* __restrict__ alive,
                       float* __restrict__ out, int H, int KV, int hd,
                       int page, int npg, int n_phys, int pages, float scale,
                       float softcap) {
  extern __shared__ __align__(16) float smem[];
  const Geometry g = geometry(hd, pages);
  const int w = 4 * g.hd4;
  const int rep = H / KV;
  const int kvh = blockIdx.y % KV, r0 = (blockIdx.y / KV) * REP;
  const int b = blockIdx.z;
  const int nrep = min(REP, rep - r0);
  const int h0 = kvh * rep + r0;           // the block's first head
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int LPR = g.lanes, NS = 32 / LPR;  // lanes a row, rows a warp step
  const int sub = lane / LPR, li = lane % LPR;

  int* ids = reinterpret_cast<int*>(smem + g.ids);
  split::stage_page_ids(ids, table + static_cast<int64_t>(b) * npg,
                        blockIdx.x * pages, pages, npg, n_phys);
  const split::Rows rows =
      split::split_rows(pos[b], alive[b], npg, page, pages, blockIdx.x);

  // this lane's words c = li + k * LPR of each query row, zero past hd
  float4 qv[REP][kWords], acc[REP][kWords];
  float m[REP], l[REP];
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    m[r] = kNegInf;
    l[r] = 0.0f;
#pragma unroll
    for (int k = 0; k < kWords; ++k) {
      const int c = li + k * LPR;
      float v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int d = 4 * c + i;
        v[i] = r < nrep && d < hd
                   ? q[(static_cast<int64_t>(b) * H + h0 + r) * hd + d]
                   : 0.0f;
      }
      qv[r][k] = make_float4(v[0], v[1], v[2], v[3]);
      acc[r][k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  }
  __syncthreads();   // the page ids are in place

  float* ring = smem + g.ring;
  const int n_tiles = (rows.hi - rows.lo + g.rows - 1) / g.rows;
  if (n_tiles > 0) {
    stage_tile<VEC16>(ring, ring + g.rows * w, k_pool, v_pool, ids, rows,
                      rows.lo, min(g.rows, rows.hi - rows.lo), page, KV, kvh,
                      hd, g.hd4);
    split::cp_async_commit();
  }
  for (int i = 0; i < n_tiles; ++i) {
    split::cp_async_wait_all();
    __syncthreads();   // tile i landed; every warp is done with tile i - 1
    if (i + 1 < n_tiles) {
      float* nk = ring + ((i + 1) & 1) * 2 * g.rows * w;
      const int s0 = rows.lo + (i + 1) * g.rows;
      stage_tile<VEC16>(nk, nk + g.rows * w, k_pool, v_pool, ids, rows, s0,
                        min(g.rows, rows.hi - s0), page, KV, kvh, hd, g.hd4);
      split::cp_async_commit();
    }
    const float* Ks = ring + (i & 1) * 2 * g.rows * w;
    const float* Vs = Ks + g.rows * w;
    const int T = min(g.rows, rows.hi - rows.lo - i * g.rows);
    for (int t0 = warp * NS; t0 < T; t0 += kWarps * NS) {   // warp-uniform
      const int t = t0 + sub;
      const bool valid = t < T;
      float4 kr[kWords], vr[kWords];
#pragma unroll
      for (int k = 0; k < kWords; ++k) {
        const int c = li + k * LPR;
        const bool in = valid && c < g.hd4;
        kr[k] = in ? load4(Ks + t * w + 4 * c) : make_float4(0, 0, 0, 0);
        vr[k] = in ? load4(Vs + t * w + 4 * c) : make_float4(0, 0, 0, 0);
      }
#pragma unroll
      for (int r = 0; r < REP; ++r) {
        if (r >= nrep) break;                               // block-uniform
        float d0 = 0.0f, d1 = 0.0f;
#pragma unroll
        for (int k = 0; k < kWords; ++k) {
          d0 = fmaf(qv[r][k].x, kr[k].x, d0);
          d1 = fmaf(qv[r][k].y, kr[k].y, d1);
          d0 = fmaf(qv[r][k].z, kr[k].z, d0);
          d1 = fmaf(qv[r][k].w, kr[k].w, d1);
        }
        float dot = d0 + d1;
        for (int off = LPR / 2; off > 0; off >>= 1)
          dot += __shfl_xor_sync(kFullMask, dot, off);
        float logit = dot * scale;
        if (softcap > 0.0f) logit = softcap * tanhf(logit / softcap);
        const float s = valid ? logit : kNegInf;
        float mx = s;
        for (int off = LPR; off < 32; off <<= 1)
          mx = fmaxf(mx, __shfl_xor_sync(kFullMask, mx, off));
        const float m_new = fmaxf(m[r], mx);
        const float corr = expf(m[r] - m_new);
        const float p = valid ? expf(s - m_new) : 0.0f;
        float ps = p;
        for (int off = LPR; off < 32; off <<= 1)
          ps += __shfl_xor_sync(kFullMask, ps, off);
        m[r] = m_new;
        l[r] = l[r] * corr + ps;
#pragma unroll
        for (int k = 0; k < kWords; ++k) {
          acc[r][k].x = fmaf(p, vr[k].x, acc[r][k].x * corr);
          acc[r][k].y = fmaf(p, vr[k].y, acc[r][k].y * corr);
          acc[r][k].z = fmaf(p, vr[k].z, acc[r][k].z * corr);
          acc[r][k].w = fmaf(p, vr[k].w, acc[r][k].w * corr);
        }
      }
    }
  }

  // the warp's state: the rows of its lane groups summed, in shared memory
  float* WAcc = smem + g.wacc + warp * kMaxRep * w;
  float* WM = smem + g.wm;
  float* WL = smem + g.wl;
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    if (r >= nrep) break;
#pragma unroll
    for (int k = 0; k < kWords; ++k) {
      for (int off = LPR; off < 32; off <<= 1)
        acc[r][k] = shfl_xor4(acc[r][k], off);
      const int c = li + k * LPR;
      if (sub == 0 && c < g.hd4)
        *reinterpret_cast<float4*>(WAcc + r * w + 4 * c) = acc[r][k];
    }
    if (lane == 0) {
      WM[warp * kMaxRep + r] = m[r];
      WL[warp * kMaxRep + r] = l[r];
    }
  }
  __syncthreads();

  // the block's state: its warps merged in warp order
  const float* WA = smem + g.wacc;
  float* BAcc = smem + g.bacc;
  float* BM = smem + g.bm;
  float* BL = smem + g.bl;
  for (int e = threadIdx.x; e < nrep * w; e += kThreads) {
    const int r = e / w, c = e % w;
    const split::State st = split::merge_in_order<kWarps>(kWarps, [&](int i) {
      return split::State{WM[i * kMaxRep + r], WL[i * kMaxRep + r],
                          WA[(i * kMaxRep + r) * w + c]};
    });
    BAcc[r * w + c] = st.a;
    if (c == 0) {
      BM[r] = st.m;
      BL[r] = st.l;
    }
  }

  // the splits merged in rank order
  split::cluster_merge_store(
      BM, BL, BAcc, nrep, hd, w, [&](int r, int c, float v) {
        out[(static_cast<int64_t>(b) * H + h0 + r) * hd + c] = v;
      });
}

// The kernel that holds `rep_block` query rows a block.
template <bool VEC16>
auto kernel_for(int rep_block) -> decltype(&paged_attention_kernel<VEC16, 1>) {
  return rep_block == 1   ? paged_attention_kernel<VEC16, 1>
         : rep_block == 2 ? paged_attention_kernel<VEC16, 2>
                          : paged_attention_kernel<VEC16, 4>;
}

}  // namespace

REPRO_EXPORT_ERROR_STRING

// q [B, H, hd] f32; k_pool, v_pool [n_phys, page, KV, hd] f32; table [B, npg],
// pos [B], alive [B] int32; out [B, H, hd] f32.  softcap <= 0 means none.
// splits (<= 8) blocks of one cluster each take `pages` logical pages of a
// slot (splits * pages >= npg); hd <= 512.
extern "C" int repro_paged_attention(const void* q, const void* k_pool,
                                     const void* v_pool, const void* table,
                                     const void* pos, const void* alive,
                                     void* out, int B, int H, int KV, int hd,
                                     int page, int npg, int n_phys,
                                     int splits, int pages, float scale,
                                     float softcap, void* stream) {
  if (B == 0 || H == 0 || hd == 0) return 0;
  if (KV <= 0 || H % KV != 0 || page <= 0 || npg <= 0 || n_phys <= 0 ||
      hd > kMaxHeadDim || splits < 1 || splits > split::kMaxSplits ||
      pages < 1 || static_cast<int64_t>(splits) * pages < npg)
    return static_cast<int>(cudaErrorInvalidValue);
  const Geometry g = geometry(hd, pages);
  const size_t bytes = sizeof(float) * static_cast<size_t>(g.total);
  const int rep = H / KV;
  const int rep_block = rep == 1 ? 1 : (rep == 2 ? 2 : kMaxRep);
  const dim3 grid(splits, KV * ((rep + rep_block - 1) / rep_block), B);
  const bool vec16 = hd % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(k_pool) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(v_pool) % 16 == 0;
  const cudaError_t err = split::launch(
      vec16 ? kernel_for<true>(rep_block) : kernel_for<false>(rep_block),
      grid, kThreads, bytes, static_cast<cudaStream_t>(stream),
      static_cast<const float*>(q), static_cast<const float*>(k_pool),
      static_cast<const float*>(v_pool), static_cast<const int32_t*>(table),
      static_cast<const int32_t*>(pos), static_cast<const int32_t*>(alive),
      static_cast<float*>(out), H, KV, hd, page, npg, n_phys, pages, scale,
      softcap);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
