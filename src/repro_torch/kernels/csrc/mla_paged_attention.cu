// Absorbed-MLA paged decode attention over dense latent pages.
//
// Replaces: src/repro/kernels/paged_attention.py:mla_paged_attention_pallas.
// Computes: for engine slot b and head h, over the slot's latent rows t <=
//   pos[b] (row t on physical page table[b, t / page], offset t % page):
//     s_t = (q_eff[b,h] . c_t + q_rope[b,h] . r_t) * scale,
//     out[b,h] = sum_t softmax(s)_t * c_t,
//   with q_eff [B, H, L], q_rope [B, H, R] f32, c_pool [P+1, page, L] and
//   r_pool [P+1, page, R] f32, table [B, npg], pos [B], alive [B] int32, out
//   [B, H, L] f32.  The latent row c_t is both key and value.  A dead slot
//   reads nothing and gets 0 (the Pallas kernel's rule).
// Bound on H100: bytes.  A slot reads its (pos + 1) visible latent rows once,
//   (pos + 1) * (L + R) * 4 bytes; the operations, 2 * H * (pos + 1) *
//   (2L + R) f32 FMAs, sit below the byte time at 16 heads.  At the serving
//   shapes both are well under a microsecond: the time is latency, and the
//   per-SM FMA rate once a block holds many rows and heads.
// Design: the slot's pages are split over the blocks of a thread-block
//   cluster and its heads over groups (split_decode.cuh): a block per (split,
//   head group, slot), the plan chosen on the host from B, npg and H
//   (kernels/mla_paged_attention.py: plan; 5 splits of 2 pages x 4 groups of
//   4 heads, 80 blocks, at the deepseek serving shape, where one block per
//   slot left 128 of 132 SMs idle).  The head groups of a split read the same
//   latent rows: from HBM once, from L2 again.  The splits merge in rank
//   order through distributed shared memory: one launch, no workspace, no
//   atomics, the same bits on every call.
//   - Inside a block, tiles of up to 16 logical rows are double-buffered in
//     shared memory with cp.async as [c | r] rows of L + R floats (16-byte
//     copies where L and R are multiples of 4 and the pools 16-byte aligned,
//     else 4-byte copies): the next tile loads while this one is attended.
//     The split's physical page ids are read once, before the first tile.
//     Rows past pos are never staged.
//   - The kernel is compiled per head count (NH = 1, 2, 4, 8 or 16 rows, the
//     group's heads rounded up): every loop over heads is exact, where a
//     runtime count up to 16 left each block issuing the work of 16 heads.
//   - Scores: each warp takes two rows of the tile; its lanes split the
//     L + R columns and keep NH x 2 partial dot products in registers,
//     reduced with shuffles.  The softmax statistics are online_softmax.cuh's
//     (softmax_stats); the context accumulates in registers across tiles, a
//     thread per latent column.  The block's (m, l, acc) then merge with the
//     other splits'.
//   Physical ids outside [0, P] are clamped.
#include "mla_attention.cuh"
#include "split_decode.cuh"
#include "unpack.cuh"

namespace {

namespace mla = repro::mla;
namespace split = repro::split;
using repro::kFullMask;

struct Geometry {
  // float offsets of each shared-memory region
  int ring, q, p, m, l, corr, ids, total;
};

// NH head rows a block (the heads of its group, rows past them zero); the
// ring of two tiles of [c | r] rows comes first (16-byte aligned) and after
// the last tile holds the block's context [NH][L]; `pages` physical ids.
__host__ __device__ inline Geometry geometry(int NH, int L, int R,
                                             int pages) {
  const int D = L + R;
  Geometry g;
  g.ring = 0;
  g.q = g.ring + 2 * mla::kTile * D;
  g.p = g.q + NH * D;
  g.m = g.p + NH * mla::kTile;
  g.l = g.m + NH;
  g.corr = g.l + NH;
  g.ids = g.corr + NH;
  g.total = g.ids + pages;
  return g;
}

// Stage logical rows [s0, s0 + T) of the slot as [c | r] rows of D floats:
// a warp per row, its lanes over the row's words.
template <bool VEC4>
__device__ __forceinline__ void stage_tile(float* KVs,
                                           const float* __restrict__ c_pool,
                                           const float* __restrict__ r_pool,
                                           const int* ids,
                                           const split::Rows& rows, int s0,
                                           int T, int page, int L, int R) {
  const int D = L + R;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int t = warp; t < T; t += mla::kWarps) {
    const int64_t row = split::pool_row(ids, rows, s0 + t, page);
    const float* crow = c_pool + row * L;
    const float* rrow = r_pool + row * R;
    float* dst = KVs + t * D;
    if (VEC4) {
      for (int d = 4 * lane; d < D; d += 4 * 32)
        split::cp_async16(dst + d, d < L ? crow + d : rrow + d - L, 16);
    } else {
      for (int d = lane; d < D; d += 32)
        split::cp_async4(dst + d, d < L ? crow + d : rrow + d - L, 4);
    }
  }
}

// P[h, t] = (Qs[h] . KVs[t]) * scale for h < nh and t < T: warp w scores
// rows w and w + kWarps (rows past T are not read), its lanes split the D
// columns, NH x 2 partial dot products in registers.
template <int NH>
__device__ __forceinline__ void scores(const float* Qs, const float* KVs,
                                       float* P, int nh, int T, int D,
                                       float scale) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ta = warp, tb = warp + mla::kWarps;
  if (ta >= T) return;                       // warp-uniform
  const bool two = tb < T;
  float sa[NH], sb[NH];
#pragma unroll
  for (int h = 0; h < NH; ++h) sa[h] = sb[h] = 0.0f;
#pragma unroll 2
  for (int d = lane; d < D; d += 32) {
    const float ka = KVs[ta * D + d];
    const float kb = two ? KVs[tb * D + d] : 0.0f;
#pragma unroll
    for (int h = 0; h < NH; ++h) {
      const float qd = Qs[h * D + d];
      sa[h] = fmaf(qd, ka, sa[h]);
      sb[h] = fmaf(qd, kb, sb[h]);
    }
  }
#pragma unroll
  for (int h = 0; h < NH; ++h) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      sa[h] += __shfl_xor_sync(kFullMask, sa[h], off);
      sb[h] += __shfl_xor_sync(kFullMask, sb[h], off);
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int h = 0; h < NH; ++h) {
      if (h < nh) {
        P[h * mla::kTile + ta] = sa[h] * scale;
        if (two) P[h * mla::kTile + tb] = sb[h] * scale;
      }
    }
  }
}

// acc[h][j] (column e = tid + kThreads j) = acc * corr[h] + sum_t P[h, t] *
// KVs[t, e] over the NH head rows (rows past nh have corr 0 and P 0).
template <int NH>
__device__ __forceinline__ void accumulate(const float* P, const float* KVs,
                                           const float* Corr,
                                           float (&acc)[NH][mla::kMaxCols],
                                           int T, int L, int D) {
#pragma unroll
  for (int h = 0; h < NH; ++h) {
    const float c = Corr[h];
#pragma unroll
    for (int j = 0; j < mla::kMaxCols; ++j) acc[h][j] *= c;
  }
  for (int t = 0; t < T; ++t) {
    float v[mla::kMaxCols];
#pragma unroll
    for (int j = 0; j < mla::kMaxCols; ++j) {
      const int e = threadIdx.x + j * mla::kThreads;
      v[j] = e < L ? KVs[t * D + e] : 0.0f;
    }
#pragma unroll
    for (int h = 0; h < NH; ++h) {
      const float p = P[h * mla::kTile + t];
#pragma unroll
      for (int j = 0; j < mla::kMaxCols; ++j)
        acc[h][j] = fmaf(p, v[j], acc[h][j]);
    }
  }
}

// NH: the block's head rows, a power of two >= the group's heads.
template <bool VEC4, int NH>
__global__ void __launch_bounds__(mla::kThreads)
mla_paged_attention_kernel(const float* __restrict__ q_eff,
                           const float* __restrict__ q_rope,
                           const float* __restrict__ c_pool,
                           const float* __restrict__ r_pool,
                           const int32_t* __restrict__ table,
                           const int32_t* __restrict__ pos,
                           const int32_t* __restrict__ alive,
                           float* __restrict__ out, int H, int L, int R,
                           int page, int npg, int n_phys, int pages,
                           int heads, float scale) {
  extern __shared__ __align__(16) float smem[];
  const Geometry g = geometry(NH, L, R, pages);
  const int h0 = blockIdx.y * heads;
  const int nh = min(heads, H - h0);
  const int D = L + R;
  const int b = blockIdx.z;
  float* ring = smem + g.ring;
  float* Qs = smem + g.q;
  float* P = smem + g.p;
  float* Ms = smem + g.m;
  float* Ls = smem + g.l;
  float* Corr = smem + g.corr;
  int* ids = reinterpret_cast<int*>(smem + g.ids);

  // Qs[h] = [q_eff[b, h0 + h] | q_rope[b, h0 + h]], rows past nh zero; P
  // and Corr zero (their rows past nh stay so)
  const int64_t qrow = static_cast<int64_t>(b) * H + h0;
  if (VEC4) {
    const int L4 = L / 4, D4 = D / 4;
    const float4* qe = reinterpret_cast<const float4*>(q_eff + qrow * L);
    const float4* qr = reinterpret_cast<const float4*>(q_rope + qrow * R);
    float4* q4 = reinterpret_cast<float4*>(Qs);
#pragma unroll 4
    for (int idx = threadIdx.x; idx < NH * D4; idx += mla::kThreads) {
      const int h = idx / D4, d = idx % D4;
      q4[idx] = h >= nh ? make_float4(0.0f, 0.0f, 0.0f, 0.0f)
                : d < L4 ? qe[h * L4 + d] : qr[h * (D4 - L4) + d - L4];
    }
  } else {
    for (int idx = threadIdx.x; idx < NH * D; idx += mla::kThreads) {
      const int h = idx / D, d = idx % D;
      Qs[idx] = h >= nh ? 0.0f
                : d < L ? q_eff[(qrow + h) * L + d]
                        : q_rope[(qrow + h) * R + d - L];
    }
  }
  for (int i = threadIdx.x; i < NH * mla::kTile; i += mla::kThreads)
    P[i] = 0.0f;
  for (int h = threadIdx.x; h < NH; h += mla::kThreads) {
    Ms[h] = repro::kNegInf;
    Ls[h] = 0.0f;
    Corr[h] = 0.0f;
  }
  float acc[NH][mla::kMaxCols] = {};

  split::stage_page_ids(ids, table + static_cast<int64_t>(b) * npg,
                        blockIdx.x * pages, pages, npg, n_phys);
  const split::Rows rows =
      split::split_rows(pos[b], alive[b], npg, page, pages, blockIdx.x);
  __syncthreads();
  const int n_tiles = (rows.hi - rows.lo + mla::kTile - 1) / mla::kTile;
  if (n_tiles > 0) {
    stage_tile<VEC4>(ring, c_pool, r_pool, ids, rows, rows.lo,
                     min(mla::kTile, rows.hi - rows.lo), page, L, R);
    split::cp_async_commit();
  }
  for (int i = 0; i < n_tiles; ++i) {
    split::cp_async_wait_all();
    __syncthreads();   // tile i landed; tile i - 1 fully consumed
    if (i + 1 < n_tiles) {
      const int s0 = rows.lo + (i + 1) * mla::kTile;
      stage_tile<VEC4>(ring + ((i + 1) & 1) * mla::kTile * D, c_pool,
                       r_pool, ids, rows, s0, min(mla::kTile, rows.hi - s0),
                       page, L, R);
      split::cp_async_commit();
    }
    const float* KVs = ring + (i & 1) * mla::kTile * D;
    const int T = min(mla::kTile, rows.hi - rows.lo - i * mla::kTile);
    scores<NH>(Qs, KVs, P, nh, T, D, scale);
    __syncthreads();
    repro::softmax_stats<mla::kThreads>(P, mla::kTile, nh, T, Ms, Ls, Corr,
                                        repro::AllVisible());
    __syncthreads();
    accumulate<NH>(P, KVs, Corr, acc, T, L, D);
  }
  __syncthreads();   // every thread is done with the ring

  // the block's context [nh][L] over the ring, then the splits merged in
  // rank order
  float* Part = ring;
#pragma unroll
  for (int h = 0; h < NH; ++h) {
    if (h < nh) {
#pragma unroll
      for (int j = 0; j < mla::kMaxCols; ++j) {
        const int e = threadIdx.x + j * mla::kThreads;
        if (e < L) Part[h * L + e] = acc[h][j];
      }
    }
  }
  split::cluster_merge_store(
      Ms, Ls, Part, nh, L, L, [&](int h, int e, float v) {
        out[(qrow + h) * L + e] = v;
      });
}

// The kernel for `heads` heads a block: NH the next power of two.
template <bool VEC4>
auto kernel_for(int heads) -> decltype(&mla_paged_attention_kernel<VEC4, 1>) {
  return heads <= 1   ? mla_paged_attention_kernel<VEC4, 1>
         : heads <= 2 ? mla_paged_attention_kernel<VEC4, 2>
         : heads <= 4 ? mla_paged_attention_kernel<VEC4, 4>
         : heads <= 8 ? mla_paged_attention_kernel<VEC4, 8>
                      : mla_paged_attention_kernel<VEC4, 16>;
}

}  // namespace

REPRO_EXPORT_ERROR_STRING

// q_eff [B, H, L], q_rope [B, H, R] f32; c_pool [n_phys, page, L], r_pool
// [n_phys, page, R] f32; table [B, npg], pos [B], alive [B] int32; out
// [B, H, L] f32.  H <= 16 and L <= 512.  splits (<= 8) blocks of one
// cluster each take `pages` logical pages of a slot (splits * pages >= npg);
// the heads go in groups of `heads`.
extern "C" int repro_mla_paged_attention(
    const void* q_eff, const void* q_rope, const void* c_pool,
    const void* r_pool, const void* table, const void* pos,
    const void* alive, void* out, int B, int H, int L, int R, int page,
    int npg, int n_phys, int splits, int pages, int heads, float scale,
    void* stream) {
  if (B == 0 || H == 0 || L == 0) return 0;
  if (page <= 0 || npg <= 0 || n_phys <= 0 || H > mla::kMaxHeads ||
      L > mla::kMaxLatent || R < 0 || heads < 1 || heads > H ||
      splits < 1 || splits > split::kMaxSplits || pages < 1 ||
      static_cast<int64_t>(splits) * pages < npg)
    return static_cast<int>(cudaErrorInvalidValue);
  int nh_pow2 = 1;
  while (nh_pow2 < heads) nh_pow2 *= 2;
  const Geometry g = geometry(nh_pow2, L, R, pages);
  const size_t bytes = sizeof(float) * static_cast<size_t>(g.total);
  const dim3 grid(splits, (H + heads - 1) / heads, B);
  const bool vec4 = L % 4 == 0 && R % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(c_pool) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(r_pool) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(q_eff) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(q_rope) % 16 == 0;
  const cudaError_t err = split::launch(
      vec4 ? kernel_for<true>(heads) : kernel_for<false>(heads), grid,
      mla::kThreads, bytes, static_cast<cudaStream_t>(stream),
      static_cast<const float*>(q_eff), static_cast<const float*>(q_rope),
      static_cast<const float*>(c_pool), static_cast<const float*>(r_pool),
      static_cast<const int32_t*>(table), static_cast<const int32_t*>(pos),
      static_cast<const int32_t*>(alive), static_cast<float*>(out), H, L, R,
      page, npg, n_phys, pages, heads, scale);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
