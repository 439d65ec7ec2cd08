// Shared device code of the attention kernels: the online-softmax step over
// one staged tile of keys and values.
//
// Counterpart of the recurrence the Pallas kernels share
// (src/repro/kernels/paged_attention.py:_gqa_body and
// blockwise_prefill.py:_prefill_body) and of kernels/ref.py's plain
// versions: per query row a running max m, normaliser l and f32 accumulator
// acc, updated tile by tile as
//   m' = max(m, max_t logit),  p_t = exp(logit_t - m'),  c = exp(m - m'),
//   l' = l * c + sum_t p_t,    acc' = acc * c + sum_t p_t * v_t,
// with rows that are not visible given probability exactly 0.  A masked row
// is selected out of the products, never multiplied by 0, so a non-finite
// value in a row that is not visible cannot reach the result.  A tile with
// no visible row leaves m, l and acc as they were.
//
// The paged and blockwise kernels, dense and codebook-quantized, differ only
// in how a tile reaches shared memory; they call these three steps in order,
// with a __syncthreads() between them, and pass a visibility predicate.
#pragma once

#include <cmath>

namespace repro {

constexpr float kNegInf = -1e30f;
constexpr float kEps = 1e-30f;
constexpr unsigned kFullMask = 0xffffffffu;

// Every staged row is visible (the caller staged only visible rows).
struct AllVisible {
  __device__ __forceinline__ bool operator()(int, int) const { return true; }
};

// Row t of the tile is visible to query row i iff its position is at most
// the query's (and inside the window when window > 0).  Query row i holds
// position qpos[i % qb].
struct CausalVisible {
  const int* qpos;
  const int* kpos;
  int qb;
  int window;
  __device__ __forceinline__ bool operator()(int i, int t) const {
    const int qp = qpos[i % qb], kp = kpos[t];
    bool ok = kp <= qp;
    if (window > 0) ok = ok && (qp - kp) < window;
    return ok;
  }
};

// P[i, t] = softcap(q_i . k_t * scale), or kNegInf where not visible.
// Qs rows have stride ldq, Ks rows ldk, P rows ldp (all in floats).
template <int THREADS, class Visible>
__device__ __forceinline__ void score_tile(const float* Qs, int ldq,
                                           const float* Ks, int ldk,
                                           float* P, int ldp, int R, int T,
                                           int hd, float scale, float softcap,
                                           const Visible& visible) {
  for (int idx = threadIdx.x; idx < R * T; idx += THREADS) {
    const int i = idx / T, t = idx % T;
    const float* qr = Qs + i * ldq;
    const float* kr = Ks + t * ldk;
    float dot = 0.0f;
    for (int d = 0; d < hd; ++d) dot = fmaf(qr[d], kr[d], dot);
    float logit = dot * scale;
    if (softcap > 0.0f) logit = softcap * tanhf(logit / softcap);
    P[i * ldp + t] = visible(i, t) ? logit : kNegInf;
  }
}

// One warp per query row: the tile's max, P[i, t] <- p_t, and the row's
// m, l and correction factor c.
template <int THREADS, class Visible>
__device__ __forceinline__ void softmax_stats(float* P, int ldp, int R,
                                              int T, float* Ms, float* Ls,
                                              float* Corr,
                                              const Visible& visible) {
  constexpr int kWarps = THREADS / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int i = warp; i < R; i += kWarps) {
    float* pr = P + i * ldp;
    float mx = kNegInf;
    for (int t = lane; t < T; t += 32) mx = fmaxf(mx, pr[t]);
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(kFullMask, mx, off));
    const float m_old = Ms[i];
    const float m_new = fmaxf(m_old, mx);
    float sum = 0.0f;
    for (int t = lane; t < T; t += 32) {
      const float p = visible(i, t) ? expf(pr[t] - m_new) : 0.0f;
      pr[t] = p;
      sum += p;
    }
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(kFullMask, sum, off);
    if (lane == 0) {
      const float corr = expf(m_old - m_new);
      Corr[i] = corr;
      Ms[i] = m_new;
      Ls[i] = Ls[i] * corr + sum;
    }
  }
}

// Acc[i, e] = Acc[i, e] * c_i + sum over visible t of p_t * V[t, e].
template <int THREADS, class Visible>
__device__ __forceinline__ void accumulate_tile(const float* P, int ldp,
                                                const float* Vs, int ldv,
                                                float* Acc, const float* Corr,
                                                int R, int T, int vd,
                                                const Visible& visible) {
  for (int idx = threadIdx.x; idx < R * vd; idx += THREADS) {
    const int i = idx / vd, e = idx % vd;
    const float* pr = P + i * ldp;
    float pv = 0.0f;
    for (int t = 0; t < T; ++t)
      if (visible(i, t)) pv = fmaf(pr[t], Vs[t * ldv + e], pv);
    Acc[idx] = Acc[idx] * Corr[i] + pv;
  }
}

}  // namespace repro
