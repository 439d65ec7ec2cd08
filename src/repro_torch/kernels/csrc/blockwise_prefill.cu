// Blockwise (chunked-prompt) prefill attention over a dense K/V view.
//
// Replaces: src/repro/kernels/blockwise_prefill.py:blockwise_prefill_pallas.
// Computes: C prompt queries q [B, C, H, hd] against a stored view
//   k [B, S, KV, hd], v [B, S, KV, vd] (S a multiple of the token tile; pad
//   rows carry POS_SENTINEL) with GQA grouping (head h reads kv head
//   h / (H / KV)).  View row s is visible to query c iff k_pos[s] <= q_pos[c]
//   (and q_pos[c] - k_pos[s] < window when a window is set).  Logits are
//   (q . k) * scale, optionally softcapped; the softmax is online over
//   token_tile rows: m/l/acc updated tile by tile exactly as
//   ref.blockwise_prefill_ref, with masked rows given probability exactly 0
//   and the final divide floored at 1e-30 (here a multiply by 1 / l).
//   Output [B, C, H, vd] f32.
// Bound on H100: operations at the serving shapes (2 * B * C * H * S *
//   (hd + vd) FLOPs against B * S * KV * (hd + vd) * 4 bytes of K/V); both are
//   small next to the projections around it, so a call is latency-bound.
// Design: one block of kWarps = 8 warps per (group of R query rows, kv head,
//   batch row); a row is one (query, head of the kv group) pair and each
//   warp owns RW of the block's R = 8 * RW rows.  plan() takes the largest
//   RW (fewest blocks, so the fewest copies of each K/V tile) that still
//   puts four warps on every SM: a one-slot engine prefill (B = 1, C = 64,
//   16 kv heads) runs 128 blocks of 1 row a warp, the one-shot batch of 4
//   128 blocks of 4 rows a warp.  (256 blocks of 4 warps, one row each,
//   read every K/V tile twice as often and measured slower.)
//   - Tiles nobody sees are skipped.  The block first marks, per warp, the
//     token tiles that hold a row its queries might see (from the warp's
//     smallest and largest query position and the window); a tile no warp
//     marks is neither loaded nor folded, and a warp folds only the tiles it
//     marked.  That is exact: for a query that sees no row of a tile the
//     online-softmax step is m' = max(m, -1e30) = m, c = exp(0) = 1, and l and
//     acc each gain an exact 0 (the mask value is finite).  The visible tiles
//     are folded one after another in view order over the same token_tile
//     partition as the plain version.
//   - K/V tiles are double-buffered in shared memory with cp.async: the next
//     visible tile loads while the current one is folded, one __syncthreads
//     per tile.  K rows are padded to an odd number of 16-byte words so the
//     score loop's 16-byte loads are free of bank conflicts.
//   - Register-blocked full-f32 FMA products.  Scores: each lane holds an
//     RW x 2 micro-tile (its rows against keys lane and lane + 32), reading a
//     16-byte word of each key and a broadcast 16-byte word of each query row
//     per step, with four partial sums a dot.  P.V: each lane holds an RW x 4
//     micro-tile (its rows against 4 value columns) from a 16-byte word of V
//     and a broadcast word of P per key; lanes split the keys when vd / 4 <
//     32 and add with shuffles.
//   - Each warp keeps its rows' running max and normaliser in registers and
//     its accumulator in shared memory; the softmax statistics take warp
//     shuffles only.  A key that is not visible scores kNegInf whatever its
//     K row holds and gets probability exactly 0, which the P.V products
//     multiply as the plain version does (no select in the inner loop).
#include <climits>

#include "online_softmax.cuh"
#include "unpack.cuh"

namespace {

using repro::kEps;
using repro::kFullMask;
using repro::kNegInf;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxDevices = 64;

struct Geometry {
  int rw, R, T, nt, stages;
  int hd4, vd4;            // head dims in 16-byte words (zero-padded)
  int ldq, ldk, ldv;       // shared-memory row strides in floats
  // float offsets of each shared-memory region
  int q, k, v, p, acc, kpos, flags, range, total;
};

__host__ __device__ inline Geometry geometry(int rw, int hd, int vd, int T,
                                             int S, int stages) {
  Geometry g;
  g.rw = rw; g.R = kWarps * rw; g.T = T; g.nt = S / T; g.stages = stages;
  g.hd4 = (hd + 3) / 4;
  g.vd4 = (vd + 3) / 4;
  g.ldq = 4 * g.hd4;
  g.ldk = 4 * (g.hd4 % 2 == 0 ? g.hd4 + 1 : g.hd4 + 2);
  g.ldv = 4 * g.vd4;
  g.q = 0;
  g.k = g.q + g.R * g.ldq;
  g.v = g.k + stages * T * g.ldk;
  g.p = g.v + stages * T * g.ldv;       // per warp [T][rw] probabilities
  g.acc = g.p + kWarps * T * rw;
  g.kpos = g.acc + g.R * g.ldv;         // ints in float-sized slots
  g.flags = g.kpos + stages * T;        // [tile][warp] bytes
  g.range = g.flags + g.nt * kWarps / 4;  // per warp: lowest, highest q_pos
  g.total = g.range + 2 * kWarps;
  return g;
}

// --- cp.async ---------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Floats [d, d + 4) of a row of `len` floats into shared memory; those past
// `len` read 0 (len = 0 zero-fills the word).  VEC16: len % 4 == 0 and the
// row is 16-byte aligned (in the kernel: hd and vd multiples of 4, every
// base address 16-byte aligned).
template <bool VEC16>
__device__ __forceinline__ void stage_word(float* dst, const float* row,
                                           int d, int len) {
  if (VEC16) {
    cp_async16(dst, row + d, d < len ? 16 : 0);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool ok = d + e < len;
      cp_async4(dst + e, row + (ok ? d + e : 0), ok ? 4 : 0);
    }
  }
}

// The calling warp's share of n rows of `len` floats (w4 16-byte words),
// `stride` floats apart in global memory, into shared rows `ld` floats apart:
// the lanes cover a row's words, a warp taking 32 / w4 rows at once.
template <bool VEC16>
__device__ __forceinline__ void stage_rows(float* dst, int ld,
                                           const float* src, int64_t stride,
                                           int n, int len, int w4, int warp,
                                           int lane) {
  const int lpr = w4 < 32 ? w4 : 32;
  const int rpw = 32 / lpr;
  const int lr = lane / lpr, l4 = lane - lr * lpr;
  if (lr >= rpw) return;
  for (int t = warp * rpw + lr; t < n; t += kWarps * rpw) {
    const float* from = src + t * stride;
    float* to = dst + t * ld;
    for (int d4 = l4; d4 < w4; d4 += lpr)
      stage_word<VEC16>(to + 4 * d4, from, 4 * d4, len);
  }
}

// --- small vectors of RW floats (one per row of a warp) ----------------------

template <int N>
__device__ __forceinline__ void ld_rows(const float* p, float (&x)[N]);
template <>
__device__ __forceinline__ void ld_rows<4>(const float* p, float (&x)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
}
template <>
__device__ __forceinline__ void ld_rows<2>(const float* p, float (&x)[2]) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  x[0] = v.x; x[1] = v.y;
}
template <>
__device__ __forceinline__ void ld_rows<1>(const float* p, float (&x)[1]) {
  x[0] = *p;
}

template <int N>
__device__ __forceinline__ void st_rows(float* p, const float (&x)[N]);
template <>
__device__ __forceinline__ void st_rows<4>(float* p, const float (&x)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}
template <>
__device__ __forceinline__ void st_rows<2>(float* p, const float (&x)[2]) {
  *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
}
template <>
__device__ __forceinline__ void st_rows<1>(float* p, const float (&x)[1]) {
  *p = x[0];
}

__device__ __forceinline__ float warp_max(float x) {
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(kFullMask, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(kFullMask, x, off);
  return x;
}

__device__ __forceinline__ bool visible(int qp, int kp, int window) {
  bool ok = kp <= qp;
  if (window > 0) ok = ok && (qp - kp) < window;
  return ok;
}

// Might a query at a position in [lo, hi] see a row at kp?  (Never false
// when one does.)
__device__ __forceinline__ bool may_see(int kp, int lo, int hi, int window) {
  return kp <= hi &&
         (window <= 0 || static_cast<long long>(lo) - kp < window);
}

__device__ __forceinline__ void fma4(float p, const float4& v, float4& a) {
  a.x = fmaf(p, v.x, a.x);
  a.y = fmaf(p, v.y, a.y);
  a.z = fmaf(p, v.z, a.z);
  a.w = fmaf(p, v.w, a.w);
}

// Lane-wise a += x * y.
__device__ __forceinline__ void fma4(const float4& x, const float4& y,
                                     float4& a) {
  a.x = fmaf(x.x, y.x, a.x);
  a.y = fmaf(x.y, y.y, a.y);
  a.z = fmaf(x.z, y.z, a.z);
  a.w = fmaf(x.w, y.w, a.w);
}

// Scores of one key for the warp's rows: logits (masked to kNegInf) into
// P[t], the running tile max into mx.
template <int RW>
__device__ __forceinline__ void put_scores(const float (&dot)[RW], int t,
                                           const int* Kp, float* Pw,
                                           const int (&qp)[RW], float scale,
                                           float softcap, int window,
                                           float (&mx)[RW]) {
  const int kp = Kp[t];
  float x[RW];
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    float logit = dot[r] * scale;
    if (softcap > 0.0f) logit = softcap * tanhf(logit / softcap);
    x[r] = visible(qp[r], kp, window) ? logit : kNegInf;
    mx[r] = fmaxf(mx[r], x[r]);
  }
  st_rows<RW>(Pw + t * RW, x);
}

// One online-softmax step of a warp's RW rows over one staged tile.
template <int RW>
__device__ __forceinline__ void fold_tile(
    const float* Qw, int ldq, const float* Kb, int ldk, const float* Vb,
    int ldv, const int* Kp, float* Pw, float* Accw, int T, int hd4, int vd4,
    float scale, float softcap, int window, const int (&qp)[RW],
    float (&m)[RW], float (&l)[RW], int lane) {
  // Scores: lane holds keys kb + lane and kb + lane + 32 for every row.
  float mx[RW];
#pragma unroll
  for (int r = 0; r < RW; ++r) mx[r] = kNegInf;
  for (int kb = 0; kb < T; kb += 64) {
    const int t0 = kb + lane, t1 = t0 + 32;
    const float4* k0 = reinterpret_cast<const float4*>(
        Kb + (t0 < T ? t0 : 0) * ldk);
    const float4* k1 = reinterpret_cast<const float4*>(
        Kb + (t1 < T ? t1 : 0) * ldk);
    // four partial sums a dot (one per word lane) keep the FMA chains short
    float4 s0[RW], s1[RW];
#pragma unroll
    for (int r = 0; r < RW; ++r)
      s0[r] = s1[r] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int d4 = 0; d4 < hd4; ++d4) {
      const float4 a = k0[d4], c = k1[d4];
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        const float4 x = reinterpret_cast<const float4*>(Qw + r * ldq)[d4];
        fma4(x, a, s0[r]);
        fma4(x, c, s1[r]);
      }
    }
    float d0[RW], d1[RW];
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      d0[r] = (s0[r].x + s0[r].y) + (s0[r].z + s0[r].w);
      d1[r] = (s1[r].x + s1[r].y) + (s1[r].z + s1[r].w);
    }
    if (t0 < T) put_scores<RW>(d0, t0, Kp, Pw, qp, scale, softcap, window, mx);
    if (t1 < T) put_scores<RW>(d1, t1, Kp, Pw, qp, scale, softcap, window, mx);
  }

  // Statistics: each lane rereads the keys it scored.
  float mn[RW], sum[RW], corr[RW];
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    mn[r] = fmaxf(m[r], warp_max(mx[r]));
    sum[r] = 0.0f;
  }
  for (int t = lane; t < T; t += 32) {
    const int kp = Kp[t];
    float x[RW];
    ld_rows<RW>(Pw + t * RW, x);
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      x[r] = visible(qp[r], kp, window) ? expf(x[r] - mn[r]) : 0.0f;
      sum[r] += x[r];
    }
    st_rows<RW>(Pw + t * RW, x);
  }
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    corr[r] = expf(m[r] - mn[r]);
    l[r] = l[r] * corr[r] + warp_sum(sum[r]);
    m[r] = mn[r];
  }
  __syncwarp();

  // P.V: lane (group g, column c) sums keys g, g + split, ... of 16-byte
  // column c; the groups' partial sums meet by shuffles.
  int span = 1;
  while (span < vd4 && span < 32) span <<= 1;
  const int split = 32 / span, grp = lane / span, col = lane % span;
  for (int c0 = 0; c0 < vd4; c0 += span) {
    const int c = c0 + col;
    const bool act = c < vd4;
    float4 a[RW];
#pragma unroll
    for (int r = 0; r < RW; ++r) a[r] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int t = grp; t < T; t += split) {
      float p[RW];
      ld_rows<RW>(Pw + t * RW, p);
      const float4 v = act ? reinterpret_cast<const float4*>(Vb + t * ldv)[c]
                           : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int r = 0; r < RW; ++r) fma4(p[r], v, a[r]);
    }
    for (int off = span; off < 32; off <<= 1) {
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        a[r].x += __shfl_xor_sync(kFullMask, a[r].x, off);
        a[r].y += __shfl_xor_sync(kFullMask, a[r].y, off);
        a[r].z += __shfl_xor_sync(kFullMask, a[r].z, off);
        a[r].w += __shfl_xor_sync(kFullMask, a[r].w, off);
      }
    }
    if (grp == 0 && act) {
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        float4* o = reinterpret_cast<float4*>(Accw + r * ldv) + c;
        float4 acc = *o;
        acc.x = acc.x * corr[r] + a[r].x;
        acc.y = acc.y * corr[r] + a[r].y;
        acc.z = acc.z * corr[r] + a[r].z;
        acc.w = acc.w * corr[r] + a[r].w;
        *o = acc;
      }
    }
  }
  __syncwarp();
}

template <int RW, bool VEC16>
__global__ void __launch_bounds__(kThreads)
blockwise_prefill_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const int32_t* __restrict__ q_pos,
                         const int32_t* __restrict__ k_pos,
                         float* __restrict__ out, int C, int H, int KV, int S,
                         int hd, int vd, int T, int stages, float scale,
                         float softcap, int window) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const Geometry g = geometry(RW, hd, vd, T, S, stages);
  float* Qs = smem + g.q;
  float* Ks = smem + g.k;
  float* Vs = smem + g.v;
  float* Acc = smem + g.acc;
  int* Kpos = reinterpret_cast<int*>(smem + g.kpos);
  uint8_t* Flags = reinterpret_cast<uint8_t*>(smem + g.flags);
  int* Range = reinterpret_cast<int*>(smem + g.range);

  const int tid = threadIdx.x, w = tid / 32, lane = tid % 32;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int rep = H / KV, rows = C * rep;
  const int row0 = blockIdx.x * g.R;     // rows: (query c, head g), g fastest

  // Query rows -> shared memory (rows past C * rep read 0).
  for (int idx = tid; idx < g.R * g.hd4; idx += kThreads) {
    const int i = idx / g.hd4, d4 = idx - i * g.hd4;
    const int id = row0 + i;
    const bool ok = id < rows;
    const int c = ok ? id / rep : 0, h = kvh * rep + (ok ? id % rep : 0);
    stage_word<VEC16>(Qs + i * g.ldq + 4 * d4,
                      q + ((static_cast<int64_t>(b) * C + c) * H + h) * hd,
                      4 * d4, ok ? hd : 0);
  }
  cp_async_commit();

  // The warp's query positions and their range; the first view positions.
  int qp[RW];
  bool valid[RW];
  int lo = INT_MAX, hi = INT_MIN;
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    const int id = row0 + w * RW + r;
    valid[r] = id < rows;
    qp[r] = valid[r] ? q_pos[id / rep] : 0;
    if (valid[r]) {
      lo = min(lo, qp[r]);
      hi = max(hi, qp[r]);
    }
  }
  constexpr int kPre = 2;
  int kp_pre[kPre];
#pragma unroll
  for (int i = 0; i < kPre; ++i) {
    const int s = tid + i * kThreads;
    kp_pre[i] = s < S ? k_pos[s] : 0;
  }
  if (lane == 0) {
    Range[2 * w] = lo;
    Range[2 * w + 1] = hi;
  }
  for (int i = tid; i < g.nt * kWarps; i += kThreads) Flags[i] = 0;
  for (int i = tid; i < g.R * g.ldv; i += kThreads) Acc[i] = 0.0f;
  __syncthreads();

  // Mark, per warp, the tiles holding a row its queries might see.
  int wlo[kWarps], whi[kWarps];
#pragma unroll
  for (int u = 0; u < kWarps; ++u) {
    wlo[u] = Range[2 * u];
    whi[u] = Range[2 * u + 1];
  }
  auto mark = [&](int s, int kp) {
    const int tile = s / T;
#pragma unroll
    for (int u = 0; u < kWarps; ++u)
      if (may_see(kp, wlo[u], whi[u], window)) Flags[tile * kWarps + u] = 1;
  };
#pragma unroll
  for (int i = 0; i < kPre; ++i)
    if (tid + i * kThreads < S) mark(tid + i * kThreads, kp_pre[i]);
  for (int s = tid + kPre * kThreads; s < S; s += kThreads) mark(s, k_pos[s]);
  __syncthreads();

  auto next_tile = [&](int t) {
    for (; t < g.nt; ++t)
      for (int u = 0; u < kWarps; ++u)
        if (Flags[t * kWarps + u]) return t;
    return t;
  };
  // K, V and k_pos of token tile `tile` into buffer `buf`.
  auto stage_tile = [&](int tile, int buf) {
    const int s0 = tile * T;
    const int64_t row = (static_cast<int64_t>(b) * S + s0) * KV + kvh;
    stage_rows<VEC16>(Ks + buf * T * g.ldk, g.ldk, k + row * hd,
                      static_cast<int64_t>(KV) * hd, T, hd, g.hd4, w, lane);
    stage_rows<VEC16>(Vs + buf * T * g.ldv, g.ldv, v + row * vd,
                      static_cast<int64_t>(KV) * vd, T, vd, g.vd4, w, lane);
    for (int t = tid; t < T; t += kThreads)
      cp_async4(Kpos + buf * T + t, k_pos + s0 + t, 4);
    cp_async_commit();
  };

  float m[RW], l[RW];
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    m[r] = kNegInf;
    l[r] = 0.0f;
  }
  float* Qw = Qs + w * RW * g.ldq;
  float* Pw = smem + g.p + w * T * RW;
  float* Accw = Acc + w * RW * g.ldv;

  int cur = next_tile(0), buf = 0;
  if (stages == 2 && cur < g.nt) stage_tile(cur, 0);
  while (cur < g.nt) {
    const int nxt = next_tile(cur + 1);
    if (stages == 1) {
      __syncthreads();           // every warp is done with the buffer
      stage_tile(cur, 0);
    }
    cp_async_wait_all();
    __syncthreads();             // the tile is in; the other buffer is free
    if (stages == 2 && nxt < g.nt) stage_tile(nxt, buf ^ 1);
    if (Flags[cur * kWarps + w])
      fold_tile<RW>(Qw, g.ldq, Ks + buf * T * g.ldk, g.ldk,
                    Vs + buf * T * g.ldv, g.ldv, Kpos + buf * T, Pw, Accw, T,
                    g.hd4, g.vd4, scale, softcap, window, qp, m, l, lane);
    cur = nxt;
    if (stages == 2) buf ^= 1;
  }
  cp_async_wait_all();           // the query rows, when no tile was visible
  __syncwarp();

#pragma unroll
  for (int r = 0; r < RW; ++r) {
    if (!valid[r]) continue;
    const int id = row0 + w * RW + r;
    const int c = id / rep, h = kvh * rep + id % rep;
    float* o = out + ((static_cast<int64_t>(b) * C + c) * H + h) * vd;
    const float* a = Accw + r * g.ldv;
    const float inv = 1.0f / fmaxf(l[r], kEps);
    if (VEC16) {
      for (int c4 = lane; c4 < g.vd4; c4 += 32) {
        float4 x = reinterpret_cast<const float4*>(a)[c4];
        x.x *= inv; x.y *= inv; x.z *= inv; x.w *= inv;
        reinterpret_cast<float4*>(o)[c4] = x;
      }
    } else {
      for (int e = lane; e < vd; e += 32) o[e] = a[e] * inv;
    }
  }
}

int cached_attribute(cudaDeviceAttr attr, int dev, int (&cache)[kMaxDevices]) {
  if (dev < 0 || dev >= kMaxDevices) {
    int value = 0;
    cudaDeviceGetAttribute(&value, attr, dev);
    return value;
  }
  if (cache[dev] == 0) cudaDeviceGetAttribute(&cache[dev], attr, dev);
  return cache[dev];
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// Warps an SM should hold for a launch to count as filling the card (one
// per scheduler).
constexpr int kWarpsPerSm = 4;

int blocks(int rw, int B, int C, int H, int KV) {
  const int R = kWarps * rw;
  return (C * (H / KV) + R - 1) / R * KV * B;
}

struct Launch {
  int rw = 0, stages = 0;
  size_t bytes = 0;
};

// Rows a warp, buffers and shared memory of one call: the largest RW of 4,
// 2, 1 that fits in shared memory and gives blocks * kWarps >= kWarpsPerSm
// * SMs, else the smallest that fits.  K/V tiles are double-buffered when
// two fit, else single.  rw == 0: nothing fits.
Launch plan(int B, int C, int H, int KV, int S, int hd, int vd, int T,
            int dev) {
  static int sms[kMaxDevices] = {}, smem_optin[kMaxDevices] = {};
  const int n_sm = cached_attribute(cudaDevAttrMultiProcessorCount, dev, sms);
  const int smem_max = cached_attribute(
      cudaDevAttrMaxSharedMemoryPerBlockOptin, dev, smem_optin);
  Launch pick;
  for (int rw = 4; rw >= 1; rw /= 2) {
    Launch c;
    for (int stages = 2; stages >= 1 && c.stages == 0; --stages) {
      const size_t bytes =
          sizeof(float) * geometry(rw, hd, vd, T, S, stages).total;
      if (bytes <= static_cast<size_t>(smem_max)) c = {rw, stages, bytes};
    }
    if (c.stages == 0) continue;
    pick = c;
    if (blocks(rw, B, C, H, KV) * kWarps >= kWarpsPerSm * n_sm) break;
  }
  return pick;
}

template <int RW, bool VEC16>
int launch(const void* q, const void* k, const void* v, const void* q_pos,
           const void* k_pos, void* out, int B, int C, int H, int KV, int S,
           int hd, int vd, int T, float scale, float softcap, int window,
           const Launch& how, int dev, cudaStream_t stream) {
  static int opted_in[kMaxDevices] = {}, smem_optin[kMaxDevices] = {};
  auto* kernel = blockwise_prefill_kernel<RW, VEC16>;
  if (how.bytes > 48 * 1024 &&
      (dev < 0 || dev >= kMaxDevices || !opted_in[dev])) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        cached_attribute(cudaDevAttrMaxSharedMemoryPerBlockOptin, dev,
                         smem_optin));
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev >= 0 && dev < kMaxDevices) opted_in[dev] = 1;
  }
  const int R = kWarps * RW;
  const dim3 grid((C * (H / KV) + R - 1) / R, KV, B);   // blocks(RW, ...)
  kernel<<<grid, kThreads, how.bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const int32_t*>(q_pos),
      static_cast<const int32_t*>(k_pos), static_cast<float*>(out), C, H, KV,
      S, hd, vd, T, how.stages, scale, softcap, window);
  return static_cast<int>(cudaGetLastError());
}

template <bool VEC16>
int launch_rows(const Launch& how, const void* q, const void* k,
                const void* v, const void* q_pos, const void* k_pos,
                void* out, int B, int C, int H, int KV, int S, int hd, int vd,
                int T, float scale, float softcap, int window, int dev,
                cudaStream_t stream) {
  switch (how.rw) {
    case 4: return launch<4, VEC16>(q, k, v, q_pos, k_pos, out, B, C, H, KV,
                                    S, hd, vd, T, scale, softcap, window, how,
                                    dev, stream);
    case 2: return launch<2, VEC16>(q, k, v, q_pos, k_pos, out, B, C, H, KV,
                                    S, hd, vd, T, scale, softcap, window, how,
                                    dev, stream);
    case 1: return launch<1, VEC16>(q, k, v, q_pos, k_pos, out, B, C, H, KV,
                                    S, hd, vd, T, scale, softcap, window, how,
                                    dev, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

REPRO_EXPORT_ERROR_STRING

// q [B, C, H, hd]; k [B, S, KV, hd]; v [B, S, KV, vd] f32; q_pos [C],
// k_pos [S] int32; out [B, C, H, vd] f32.  S % token_tile == 0.
// softcap <= 0 means none; window <= 0 means none.
extern "C" int repro_blockwise_prefill(const void* q, const void* k,
                                       const void* v, const void* q_pos,
                                       const void* k_pos, void* out, int B,
                                       int C, int H, int KV, int S, int hd,
                                       int vd, int token_tile, float scale,
                                       float softcap, int window,
                                       void* stream) {
  if (B == 0 || C == 0) return 0;
  if (KV <= 0 || H % KV != 0 || token_tile <= 0 || S % token_tile != 0 ||
      hd <= 0 || vd <= 0 || KV > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Launch how = plan(B, C, H, KV, S, hd, vd, token_tile, dev);
  if (how.rw == 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec16 = hd % 4 == 0 && vd % 4 == 0 && aligned16(q) &&
                     aligned16(k) && aligned16(v) && aligned16(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return vec16 ? launch_rows<true>(how, q, k, v, q_pos, k_pos, out, B, C, H,
                                   KV, S, hd, vd, token_tile, scale, softcap,
                                   window, dev, s)
               : launch_rows<false>(how, q, k, v, q_pos, k_pos, out, B, C, H,
                                    KV, S, hd, vd, token_tile, scale, softcap,
                                    window, dev, s);
}

// The plan of the launch above, for tests that must reach a given one:
// its blocks, warps a block, query rows a warp and K/V buffers (all 0 when
// nothing fits).
extern "C" int repro_blockwise_prefill_grid(int B, int C, int H, int KV,
                                            int S, int hd, int vd,
                                            int token_tile, int* blocks_out,
                                            int* warps, int* rows_per_warp,
                                            int* stages) {
  *blocks_out = *warps = *rows_per_warp = *stages = 0;
  if (B <= 0 || C <= 0 || KV <= 0 || H % KV != 0 || token_tile <= 0 ||
      S % token_tile != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Launch how = plan(B, C, H, KV, S, hd, vd, token_tile, dev);
  if (how.rw == 0) return 0;
  *blocks_out = blocks(how.rw, B, C, H, KV);
  *warps = kWarps;
  *rows_per_warp = how.rw;
  *stages = how.stages;
  return 0;
}
