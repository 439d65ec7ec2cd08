// Codebook matmul over uint8 indices: y = x · cb[idx].
//
// Replaces: src/repro/kernels/codebook_matmul.py:codebook_matmul_pallas.
// Computes: y[M, N] = x[M, Kd] · W, W[k, n] = cb[idx[k, n]], with idx uint8
//   [Kd, N] (the uint8 serving layout, one byte per weight) and cb f32
//   [K <= 256].  f32 accumulation.
// Bound on H100: at decode (M = batch, a few rows) bytes — the index bytes,
//   Kd * N, dominate; at prefill (M = batch * 64) operations, 2 * M * Kd * N
//   f32 FMAs against 67 TFLOP/s.
// Design: codebook_matmul_packed.cu's, with a byte operand.  Each block owns
//   a BM x 64 output tile and loops over Kd in steps of 64 rows.  It stages
//   the codebook once as a 256-entry LUT in shared memory (entries past K
//   read 0); per step it reads the [64, 64] index tile, four bytes per thread
//   when N is a multiple of 4 (one 32-bit load of four neighbouring columns,
//   neighbouring threads on neighbouring words) and one byte otherwise,
//   dequantizes it through the LUT into shared memory, stages the [BM, 64]
//   activation tile beside it, and every thread accumulates a TM x 4
//   register tile in f32.  Rows past M or Kd and columns past N are masked
//   to 0 at staging, so nothing is padded in memory.  When the output tiles
//   alone cannot fill the card (decode), the K loop is split over gridDim.z:
//   each split writes its partial tile to a workspace and a second pass sums
//   the partials in split order, so results do not depend on scheduling.
#include "unpack.cuh"

namespace {

constexpr int kBN = 64;        // output columns per block
constexpr int kBK = 64;        // reduction rows per K step
constexpr int kThreads = 256;  // 16 column threads x 16 row threads
constexpr int kLut = 256;

template <int TM, bool VEC4>
__global__ void __launch_bounds__(kThreads)
codebook_matmul_kernel(const float* __restrict__ x,
                       const uint8_t* __restrict__ idx,
                       const float* __restrict__ cb, float* __restrict__ out,
                       int M, int Kd, int N, int k_entries,
                       int steps_per_split) {
  constexpr int BM = 16 * TM;
  __shared__ float lut[kLut];
  __shared__ float xs[kBK][BM + 1];   // transposed activation tile
  __shared__ float ws[kBK][kBN];      // dequantized weight tile

  repro::stage_codebook<8>(lut, cb, k_entries);
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * BM;
  const int nsteps = (Kd + kBK - 1) / kBK;
  const int s_begin = blockIdx.z * steps_per_split;
  const int s_end = min(nsteps, s_begin + steps_per_split);

  float acc[TM][4];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  __syncthreads();

  for (int s = s_begin; s < s_end; ++s) {
    const int k0 = s * kBK;
    if (VEC4) {
      // N % 4 == 0: four neighbouring columns per 32-bit load
      for (int i = threadIdx.x; i < kBK * (kBN / 4); i += kThreads) {
        const int r = i / (kBN / 4), c4 = (i % (kBN / 4)) * 4;
        const int k = k0 + r, n = n0 + c4;
        const bool in = k < Kd && n < N;
        const uint32_t word =
            in ? *reinterpret_cast<const uint32_t*>(
                     idx + static_cast<int64_t>(k) * N + n)
               : 0u;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          ws[r][c4 + j] = in ? lut[(word >> (8 * j)) & 0xffu] : 0.0f;
      }
    } else {
      for (int i = threadIdx.x; i < kBK * kBN; i += kThreads) {
        const int r = i / kBN, c = i % kBN;
        const int k = k0 + r, n = n0 + c;
        ws[r][c] = (k < Kd && n < N)
                       ? lut[idx[static_cast<int64_t>(k) * N + n]]
                       : 0.0f;
      }
    }
    for (int i = threadIdx.x; i < BM * kBK; i += kThreads) {
      const int r = i / kBK, kk = i % kBK;
      const int m = m0 + r, k = k0 + kk;
      xs[kk][r] = (m < M && k < Kd) ? x[static_cast<int64_t>(m) * Kd + k] : 0.0f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float a[TM], b[4];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[kk][ty * TM + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ws[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* dst = out + static_cast<int64_t>(blockIdx.z) * M * N;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < N) dst[static_cast<int64_t>(m) * N + n] = acc[i][j];
    }
  }
}

// out[i] = sum over z (in order) of part[z][i].
__global__ void splitk_reduce_kernel(const float* __restrict__ part,
                                     float* __restrict__ out, int64_t mn,
                                     int splits) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float s = part[i];
  for (int z = 1; z < splits; ++z) s += part[z * mn + i];
  out[i] = s;
}

template <int TM>
void launch_tiles(const dim3& grid, bool vec4, const float* x,
                  const uint8_t* idx, const float* cb, float* dst, int M,
                  int Kd, int N, int k_entries, int per, cudaStream_t s) {
  if (vec4)
    codebook_matmul_kernel<TM, true><<<grid, kThreads, 0, s>>>(
        x, idx, cb, dst, M, Kd, N, k_entries, per);
  else
    codebook_matmul_kernel<TM, false><<<grid, kThreads, 0, s>>>(
        x, idx, cb, dst, M, Kd, N, k_entries, per);
}

}  // namespace

REPRO_EXPORT_ERROR_STRING

// x [M, Kd] f32; idx [Kd, N] uint8; cb [K <= 256] f32; out [M, N] f32;
// partial: workspace of splits * M * N f32 (unused when splits == 1).
// The four-byte loads need N % 4 == 0 and a 4-byte aligned idx.
extern "C" int repro_codebook_matmul(const void* x, const void* idx,
                                     const void* cb, void* out,
                                     void* partial, int M, int Kd, int N,
                                     int k_entries, int splits,
                                     void* stream) {
  if (M == 0 || N == 0) return 0;
  if (Kd < 0 || k_entries <= 0 || k_entries > kLut)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nsteps = max(1, (Kd + kBK - 1) / kBK);
  splits = max(1, min(splits, nsteps));
  const int per = max(1, (nsteps + splits - 1) / splits);
  splits = max(1, (nsteps + per - 1) / per);
  float* dst = splits > 1 ? static_cast<float*>(partial)
                          : static_cast<float*>(out);
  const bool vec4 =
      N % 4 == 0 && reinterpret_cast<uintptr_t>(idx) % 4 == 0;
  const int tm = M > 16 ? 4 : 1;
  const dim3 grid((N + kBN - 1) / kBN, (M + 16 * tm - 1) / (16 * tm), splits);
  const float* xf = static_cast<const float*>(x);
  const uint8_t* ib = static_cast<const uint8_t*>(idx);
  const float* cf = static_cast<const float*>(cb);
  if (tm == 4)
    launch_tiles<4>(grid, vec4, xf, ib, cf, dst, M, Kd, N, k_entries, per, s);
  else
    launch_tiles<1>(grid, vec4, xf, ib, cf, dst, M, Kd, N, k_entries, per, s);
  if (splits > 1) {
    const int64_t mn = static_cast<int64_t>(M) * N;
    splitk_reduce_kernel<<<static_cast<unsigned>((mn + 255) / 256), 256, 0, s>>>(
        static_cast<const float*>(partial), static_cast<float*>(out), mn,
        splits);
  }
  return static_cast<int>(cudaGetLastError());
}
