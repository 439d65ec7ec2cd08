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
//   and the final divide floored at 1e-30.  Output [B, C, H, vd] f32.
// Bound on H100: operations at the serving shapes (2 * B * C * H * S *
//   (hd + vd) FLOPs against B * S * KV * (hd + vd) * 4 bytes of K/V); both are
//   small next to the projections around it.
// Design: one block per (query chunk of QB positions, kv head, batch row).
//   The block's R = rep * QB query rows stay in shared memory with their
//   running max, normaliser and f32 accumulator; the block loops over the view
//   one token tile at a time (the TPU kernel's sequential tile grid axis):
//   stage the tile's K and V rows (coalesced), score R x T logits, update the
//   row statistics one warp per row with shuffle reductions, then fold the
//   tile's probabilities into the accumulator.  Shared-memory rows of Q and K
//   are padded by one float so that the score loop is free of bank conflicts.
#include <cmath>

#include "unpack.cuh"

namespace {

constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;
constexpr float kEps = 1e-30f;
constexpr unsigned kFull = 0xffffffffu;

struct Geometry {
  int R, QB, hd, vd, T;
  // float offsets of each shared-memory region
  int q, k, v, p, acc, m, l, corr, kpos, qpos, total;
};

__host__ __device__ inline Geometry geometry(int rep, int QB, int hd, int vd,
                                             int T) {
  Geometry g;
  g.R = rep * QB; g.QB = QB; g.hd = hd; g.vd = vd; g.T = T;
  g.q = 0;
  g.k = g.q + g.R * (hd + 1);
  g.v = g.k + T * (hd + 1);
  g.p = g.v + T * vd;
  g.acc = g.p + g.R * (T + 1);
  g.m = g.acc + g.R * vd;
  g.l = g.m + g.R;
  g.corr = g.l + g.R;
  g.kpos = g.corr + g.R;      // ints stored in float-sized slots
  g.qpos = g.kpos + T;
  g.total = g.qpos + QB;
  return g;
}

__global__ void __launch_bounds__(kThreads)
blockwise_prefill_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const int32_t* __restrict__ q_pos,
                         const int32_t* __restrict__ k_pos,
                         float* __restrict__ out, int C, int H, int KV, int S,
                         int QB, int hd, int vd, int T, float scale,
                         float softcap, int window) {
  extern __shared__ float smem[];
  const int rep = H / KV;
  const Geometry g = geometry(rep, QB, hd, vd, T);
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

  const int c0 = blockIdx.x * QB;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  constexpr int kWarps = kThreads / 32;

  // Row i holds query position c0 + i % QB of head kvh * rep + i / QB.
  for (int idx = threadIdx.x; idx < R * hd; idx += kThreads) {
    const int i = idx / hd, d = idx % hd;
    const int c = c0 + i % QB, h = kvh * rep + i / QB;
    Qs[i * (hd + 1) + d] =
        c < C ? q[((static_cast<int64_t>(b) * C + c) * H + h) * hd + d] : 0.0f;
  }
  for (int idx = threadIdx.x; idx < R * vd; idx += kThreads) Acc[idx] = 0.0f;
  for (int i = threadIdx.x; i < R; i += kThreads) {
    Ms[i] = kNegInf;
    Ls[i] = 0.0f;
  }
  for (int i = threadIdx.x; i < QB; i += kThreads)
    Qpos[i] = c0 + i < C ? q_pos[c0 + i] : 0;

  for (int s0 = 0; s0 < S; s0 += T) {
    __syncthreads();   // previous tile fully consumed (and setup visible)
    for (int idx = threadIdx.x; idx < T * hd; idx += kThreads) {
      const int t = idx / hd, d = idx % hd;
      Ks[t * (hd + 1) + d] =
          k[((static_cast<int64_t>(b) * S + s0 + t) * KV + kvh) * hd + d];
    }
    for (int idx = threadIdx.x; idx < T * vd; idx += kThreads) {
      const int t = idx / vd, e = idx % vd;
      Vs[idx] = v[((static_cast<int64_t>(b) * S + s0 + t) * KV + kvh) * vd + e];
    }
    for (int t = threadIdx.x; t < T; t += kThreads) Kpos[t] = k_pos[s0 + t];
    __syncthreads();

    // masked, scaled (and softcapped) logits
    for (int idx = threadIdx.x; idx < R * T; idx += kThreads) {
      const int i = idx / T, t = idx % T;
      const float* qr = Qs + i * (hd + 1);
      const float* kr = Ks + t * (hd + 1);
      float dot = 0.0f;
      for (int d = 0; d < hd; ++d) dot = fmaf(qr[d], kr[d], dot);
      float logit = dot * scale;
      if (softcap > 0.0f) logit = softcap * tanhf(logit / softcap);
      const int qp = Qpos[i % QB], kp = Kpos[t];
      bool ok = kp <= qp;
      if (window > 0) ok = ok && (qp - kp) < window;
      P[i * (T + 1) + t] = ok ? logit : kNegInf;
    }
    __syncthreads();

    // online-softmax statistics, one warp per row
    for (int i = warp; i < R; i += kWarps) {
      float* pr = P + i * (T + 1);
      float mx = kNegInf;
      for (int t = lane; t < T; t += 32) mx = fmaxf(mx, pr[t]);
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
      const float m_old = Ms[i];
      const float m_new = fmaxf(m_old, mx);
      const int qp = Qpos[i % QB];
      float sum = 0.0f;
      for (int t = lane; t < T; t += 32) {
        const int kp = Kpos[t];
        bool ok = kp <= qp;
        if (window > 0) ok = ok && (qp - kp) < window;
        const float p = ok ? expf(pr[t] - m_new) : 0.0f;
        pr[t] = p;
        sum += p;
      }
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(kFull, sum, off);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        Corr[i] = corr;
        Ms[i] = m_new;
        Ls[i] = Ls[i] * corr + sum;
      }
    }
    __syncthreads();

    // acc = acc * corr + P . V
    for (int idx = threadIdx.x; idx < R * vd; idx += kThreads) {
      const int i = idx / vd, e = idx % vd;
      const float* pr = P + i * (T + 1);
      float pv = 0.0f;
      for (int t = 0; t < T; ++t) pv = fmaf(pr[t], Vs[t * vd + e], pv);
      Acc[idx] = Acc[idx] * Corr[i] + pv;
    }
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < R * vd; idx += kThreads) {
    const int i = idx / vd, e = idx % vd;
    const int c = c0 + i % QB, h = kvh * rep + i / QB;
    if (c < C)
      out[((static_cast<int64_t>(b) * C + c) * H + h) * vd + e] =
          Acc[idx] / fmaxf(Ls[i], kEps);
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
  if (KV <= 0 || H % KV != 0 || token_tile <= 0 || S % token_tile != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int rep = H / KV;
  const int QB = rep >= 16 ? 1 : 16 / rep;   // about 16 query rows per block
  const Geometry g = geometry(rep, QB, hd, vd, token_tile);
  const size_t bytes = sizeof(float) * static_cast<size_t>(g.total);
  if (bytes > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        blockwise_prefill_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((C + QB - 1) / QB, KV, B);
  blockwise_prefill_kernel<<<grid, kThreads, bytes,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const int32_t*>(q_pos),
      static_cast<const int32_t*>(k_pos), static_cast<float*>(out), C, H, KV, S,
      QB, hd, vd, token_tile, scale, softcap, window);
  return static_cast<int>(cudaGetLastError());
}
