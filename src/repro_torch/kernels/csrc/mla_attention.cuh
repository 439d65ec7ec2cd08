// Shared device code of the two absorbed-MLA paged decode kernels
// (mla_paged_attention.cu over dense latent pages, mla_paged_attention_quant.cu
// over codebook-quantized ones): everything but the staging of a tile.
//
// One block per engine slot serves all H heads (H <= 16): the heads share
// the slot's latent rows, so each tile of up to kTile visible rows is staged
// once, as [c | r] rows of D = L + R floats, and read by every head.  Per
// tile:
//   scores   each warp takes two heads; its lanes split the D columns, keep
//            2 x kTile partial dot products in registers and reduce them with
//            shuffles: P[h, t] = (q_eff[h] . c_t + q_rope[h] . r_t) * scale;
//   softmax  the online-softmax statistics of online_softmax.cuh
//            (softmax_stats): running max, normaliser, correction factor;
//   context  each thread owns latent columns e = tid + 256 j (L <= 512) for
//            every head, accumulated in registers across tiles:
//            acc[h, e] = acc[h, e] * corr[h] + sum_t P[h, t] * c_t[e].
// The registers hold the work that the shared-memory loops of
// online_softmax.cuh would serialise: at D = 576 a thread per dot product
// runs a 576-long dependent chain, which leaves the four busy SMs of a
// 4-slot batch waiting on shared-memory latency.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "online_softmax.cuh"

namespace repro {
namespace mla {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 16;                    // latent rows staged per step
constexpr int kMaxHeads = 2 * kWarps;        // two heads per warp
constexpr int kMaxCols = 2;                  // latent columns per thread
constexpr int kMaxLatent = kMaxCols * kThreads;

struct Geometry {
  // float offsets of each shared-memory region
  int q, kv, p, m, l, corr, extra, total;
};

// `extra` floats at the end are the caller's (codebook LUTs).
__host__ __device__ inline Geometry geometry(int H, int L, int R, int extra) {
  const int D = L + R;
  Geometry g;
  g.q = 0;
  g.kv = g.q + H * D;
  g.p = g.kv + kTile * D;
  g.m = g.p + H * kTile;
  g.l = g.m + H;
  g.corr = g.l + H;
  g.extra = g.corr + H;
  g.total = g.extra + extra;
  return g;
}

// Qs[h] = [q_eff[b, h] | q_rope[b, h]]; running max -inf, normaliser 0.
__device__ __forceinline__ void stage_queries(const float* __restrict__ q_eff,
                                              const float* __restrict__ q_rope,
                                              float* Qs, float* Ms, float* Ls,
                                              int b, int H, int L, int R) {
  const int D = L + R;
  for (int idx = threadIdx.x; idx < H * D; idx += kThreads) {
    const int h = idx / D, d = idx % D;
    const int64_t row = static_cast<int64_t>(b) * H + h;
    Qs[idx] = d < L ? q_eff[row * L + d] : q_rope[row * R + d - L];
  }
  for (int h = threadIdx.x; h < H; h += kThreads) {
    Ms[h] = kNegInf;
    Ls[h] = 0.0f;
  }
}

// P[h, t] = (Qs[h] . KVs[t]) * scale for t < T (rows past T are not read).
__device__ __forceinline__ void scores(const float* Qs, const float* KVs,
                                       float* P, int H, int T, int D,
                                       float scale) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int h0 = warp, h1 = warp + kWarps;
  if (h0 >= H) return;                       // warp-uniform
  const bool two = h1 < H;
  float s0[kTile], s1[kTile];
#pragma unroll
  for (int t = 0; t < kTile; ++t) s0[t] = s1[t] = 0.0f;
  for (int d = lane; d < D; d += 32) {
    const float q0 = Qs[h0 * D + d];
    const float q1 = two ? Qs[h1 * D + d] : 0.0f;
#pragma unroll
    for (int t = 0; t < kTile; ++t) {
      const float k = t < T ? KVs[t * D + d] : 0.0f;
      s0[t] = fmaf(q0, k, s0[t]);
      s1[t] = fmaf(q1, k, s1[t]);
    }
  }
#pragma unroll
  for (int t = 0; t < kTile; ++t) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s0[t] += __shfl_xor_sync(kFullMask, s0[t], off);
      s1[t] += __shfl_xor_sync(kFullMask, s1[t], off);
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int t = 0; t < kTile; ++t) {
      if (t < T) {
        P[h0 * kTile + t] = s0[t] * scale;
        if (two) P[h1 * kTile + t] = s1[t] * scale;
      }
    }
  }
}

// acc[h][j] (column e = tid + kThreads j) = acc * corr[h] + sum_t P[h, t] *
// KVs[t, e]: the latent rows are the values.
__device__ __forceinline__ void accumulate(const float* P, const float* KVs,
                                           const float* Corr,
                                           float (&acc)[kMaxHeads][kMaxCols],
                                           int H, int T, int L, int D) {
#pragma unroll
  for (int h = 0; h < kMaxHeads; ++h) {
    if (h < H) {
      const float c = Corr[h];
#pragma unroll
      for (int j = 0; j < kMaxCols; ++j) acc[h][j] *= c;
    }
  }
  for (int t = 0; t < T; ++t) {
    float v[kMaxCols];
#pragma unroll
    for (int j = 0; j < kMaxCols; ++j) {
      const int e = threadIdx.x + j * kThreads;
      v[j] = e < L ? KVs[t * D + e] : 0.0f;
    }
#pragma unroll
    for (int h = 0; h < kMaxHeads; ++h) {
      if (h < H) {
        const float p = P[h * kTile + t];
#pragma unroll
        for (int j = 0; j < kMaxCols; ++j) acc[h][j] = fmaf(p, v[j], acc[h][j]);
      }
    }
  }
}

// One staged tile of T visible rows: scores, softmax statistics, context.
// Called by every thread after the tile is staged and synchronised.
__device__ __forceinline__ void attend_tile(const float* Qs, const float* KVs,
                                            float* P, float* Ms, float* Ls,
                                            float* Corr,
                                            float (&acc)[kMaxHeads][kMaxCols],
                                            int H, int T, int L, int D,
                                            float scale) {
  scores(Qs, KVs, P, H, T, D, scale);
  __syncthreads();
  softmax_stats<kThreads>(P, kTile, H, T, Ms, Ls, Corr, AllVisible());
  __syncthreads();
  accumulate(P, KVs, Corr, acc, H, T, L, D);
}

// out[b, h, e] = acc[h][e] / l[h]; a slot that attended nothing writes 0.
__device__ __forceinline__ void store(float* __restrict__ out,
                                      const float (&acc)[kMaxHeads][kMaxCols],
                                      const float* Ls, int b, int H, int L) {
#pragma unroll
  for (int h = 0; h < kMaxHeads; ++h) {
    if (h < H) {
      const float l = fmaxf(Ls[h], kEps);
#pragma unroll
      for (int j = 0; j < kMaxCols; ++j) {
        const int e = threadIdx.x + j * kThreads;
        if (e < L)
          out[(static_cast<int64_t>(b) * H + h) * L + e] = acc[h][j] / l;
      }
    }
  }
}

// The launch's shared memory: checks the geometry the body supports and
// opts in above 48 KB.  Returns a cudaError_t as int.
template <class Kernel>
inline int prepare(Kernel kernel, int H, int L, int R, int extra,
                   size_t* bytes) {
  if (H > kMaxHeads || L > kMaxLatent || R < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Geometry g = geometry(H, L, R, extra);
  *bytes = sizeof(float) * static_cast<size_t>(g.total);
  if (*bytes > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  if (*bytes > 48 * 1024)
    return static_cast<int>(cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(*bytes)));
  return 0;
}

}  // namespace mla
}  // namespace repro
