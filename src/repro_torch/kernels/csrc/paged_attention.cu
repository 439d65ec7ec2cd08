// Paged GQA decode attention over dense KV pages.
//
// Replaces: src/repro/kernels/paged_attention.py:paged_attention_pallas.
// Computes: for each slot b and head h, one query q[b, 0, h, :] against the
//   slot's logical K/V stream, read through its page table from the pools
//   k_pool / v_pool [P+1, page, KV, hd] (row t of logical page j lives at
//   pool[table[b, j], t]).  Head h reads kv head h / (H / KV).  Logical row s
//   is visible iff s <= pos[b] and alive[b]; logits are (q . k) * scale,
//   optionally softcapped (cap * tanh(x / cap)); softmax is online over pages
//   (running max m, normaliser l, f32 accumulator acc); the output is
//   acc / max(l, 1e-30), so a dead slot (nothing visible) gets 0, as the
//   Pallas kernel gives.  Output out [B, H, hd] f32.
// Bound on H100: bytes.  A slot reads (pos + 1) rows of K and of V for each kv
//   head, 2 * (pos + 1) * KV * hd * 4 bytes, and does about 4 FLOPs per byte.
// Design: the TPU kernel walks a sequential grid of token tiles that carries
//   m / l / acc in scratch; here one block per (kv head, slot) holds its rep
//   query rows and their m / l / acc in shared memory and loops over the
//   slot's pages inside the block.  The loop stops at the page that holds
//   pos[b]: a fully masked page leaves m, l and acc exactly as they were, so
//   stopping changes no bit.  Inside the last page only the rows t <= pos are
//   staged, scored and summed: rows past pos (a recycled page may hold any
//   bits) are masked by select and never enter an arithmetic operation.
//   Shared-memory rows of Q and K are padded by one float so the score loop is
//   free of bank conflicts.  Physical ids outside [0, P] are clamped.
#include <cmath>

#include "unpack.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;
constexpr float kEps = 1e-30f;
constexpr unsigned kFull = 0xffffffffu;

struct Geometry {
  // float offsets of each shared-memory region
  int q, k, v, p, acc, m, l, corr, total;
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
  g.total = g.corr + rep;
  return g;
}

__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ k_pool,
                       const float* __restrict__ v_pool,
                       const int32_t* __restrict__ table,
                       const int32_t* __restrict__ pos,
                       const int32_t* __restrict__ alive,
                       float* __restrict__ out, int H, int KV, int hd,
                       int page, int npg, int n_phys, float scale,
                       float softcap) {
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

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

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
    const int64_t base = static_cast<int64_t>(phys) * page;
    for (int idx = threadIdx.x; idx < n_valid * hd; idx += kThreads) {
      const int t = idx / hd, d = idx % hd;
      const int64_t src = ((base + t) * KV + kvh) * hd + d;
      Ks[t * (hd + 1) + d] = k_pool[src];
      Vs[t * hd + d] = v_pool[src];
    }
    __syncthreads();

    // scaled (and softcapped) logits of the visible rows
    for (int idx = threadIdx.x; idx < rep * n_valid; idx += kThreads) {
      const int r = idx / n_valid, t = idx % n_valid;
      const float* qr = Qs + r * (hd + 1);
      const float* kr = Ks + t * (hd + 1);
      float dot = 0.0f;
      for (int d = 0; d < hd; ++d) dot = fmaf(qr[d], kr[d], dot);
      float logit = dot * scale;
      if (softcap > 0.0f) logit = softcap * tanhf(logit / softcap);
      P[r * page + t] = logit;
    }
    __syncthreads();

    // online-softmax statistics, one warp per row
    for (int r = warp; r < rep; r += kWarps) {
      float* pr = P + r * page;
      float mx = kNegInf;
      for (int t = lane; t < n_valid; t += 32) mx = fmaxf(mx, pr[t]);
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
      const float m_old = Ms[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.0f;
      for (int t = lane; t < n_valid; t += 32) {
        const float p = expf(pr[t] - m_new);
        pr[t] = p;
        sum += p;
      }
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(kFull, sum, off);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        Corr[r] = corr;
        Ms[r] = m_new;
        Ls[r] = Ls[r] * corr + sum;
      }
    }
    __syncthreads();

    // acc = acc * corr + P . V over the visible rows
    for (int idx = threadIdx.x; idx < rep * hd; idx += kThreads) {
      const int r = idx / hd, e = idx % hd;
      const float* pr = P + r * page;
      float pv = 0.0f;
      for (int t = 0; t < n_valid; ++t) pv = fmaf(pr[t], Vs[t * hd + e], pv);
      Acc[idx] = Acc[idx] * Corr[r] + pv;
    }
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < rep * hd; idx += kThreads) {
    const int r = idx / hd, e = idx % hd;
    out[(static_cast<int64_t>(b) * H + kvh * rep + r) * hd + e] =
        Acc[idx] / fmaxf(Ls[r], kEps);
  }
}

}  // namespace

REPRO_EXPORT_ERROR_STRING

// q [B, H, hd] f32; k_pool, v_pool [n_phys, page, KV, hd] f32; table [B, npg],
// pos [B], alive [B] int32; out [B, H, hd] f32.  softcap <= 0 means none.
extern "C" int repro_paged_attention(const void* q, const void* k_pool,
                                     const void* v_pool, const void* table,
                                     const void* pos, const void* alive,
                                     void* out, int B, int H, int KV, int hd,
                                     int page, int npg, int n_phys,
                                     float scale, float softcap,
                                     void* stream) {
  if (B == 0 || H == 0 || hd == 0) return 0;
  if (KV <= 0 || H % KV != 0 || page <= 0 || npg <= 0 || n_phys <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Geometry g = geometry(H / KV, hd, page);
  const size_t bytes = sizeof(float) * static_cast<size_t>(g.total);
  if (bytes > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(KV, B);
  paged_attention_kernel<<<grid, kThreads, bytes,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k_pool),
      static_cast<const float*>(v_pool), static_cast<const int32_t*>(table),
      static_cast<const int32_t*>(pos), static_cast<const int32_t*>(alive),
      static_cast<float*>(out), H, KV, hd, page, npg, n_phys, scale, softcap);
  return static_cast<int>(cudaGetLastError());
}
