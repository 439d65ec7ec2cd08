// Codebook matmul over bit-packed indices: y = x · cb[unpack(pidx)].
//
// Replaces: src/repro/kernels/codebook_matmul_packed.py:
//   codebook_matmul_packed_pallas.
// Computes: y[M, N] = x[M, Kd] · W, W[k, n] = cb[idx[k, n]], with the indices
//   stored as pack_indices_2d words pidx [Wk = ceil(Kd / lanes), N]: word
//   (w, n) holds rows w * lanes + l of column n.  f32 accumulation.
// Bound on H100: at decode (M = batch, a few rows) bytes — the packed words,
//   Kd * N * bits / 8, dominate and one block per column tile would leave most
//   SMs idle; at prefill (M = batch * 64) operations, 2 * M * Kd * N f32 FMAs
//   against 67 TFLOP/s.
// Design: each block owns a BM x 64 output tile and loops over Kd in steps of
//   whole word rows (<= 64 reduction rows, so a word never straddles a step).
//   Per step it dequantizes the [BK, 64] weight tile into shared memory
//   (consecutive threads read consecutive columns' words: coalesced), stages
//   the [BM, BK] activation tile beside it, and every thread accumulates a
//   TM x 4 register tile in f32.  Rows past M, columns past N and padding
//   lanes past Kd in the last word row are masked to 0 at staging, so they
//   contribute exactly 0; nothing is padded in memory.  When the output tiles
//   alone cannot fill the card (decode), the K loop is split over gridDim.z:
//   each split writes its partial tile to a workspace and a second pass sums
//   the partials in split order, so results do not depend on scheduling.
//   The TPU kernel's sequential k grid axis becomes the in-block K loop.
#include "unpack.cuh"

namespace {

constexpr int kBN = 64;        // output columns per block
constexpr int kThreads = 256;  // 16 column threads x 16 row threads
constexpr int kMaxStepRows = 64;

template <int BITS>
struct Step {
  static constexpr int kLanes = repro::Packing<BITS>::kLanes;
  // word rows per K step and the reduction rows they hold (<= 64)
  static constexpr int kWords = kLanes >= kMaxStepRows ? 1 : kMaxStepRows / kLanes;
  static constexpr int kRows = kWords * kLanes;
};

template <int BITS, int TM>
__global__ void __launch_bounds__(kThreads)
packed_matmul_kernel(const float* __restrict__ x,
                     const uint32_t* __restrict__ pidx,
                     const float* __restrict__ cb, float* __restrict__ out,
                     int M, int Kd, int N, int Wk, int k_entries,
                     int steps_per_split) {
  constexpr int LANES = Step<BITS>::kLanes;
  constexpr int SW = Step<BITS>::kWords;
  constexpr int BK = Step<BITS>::kRows;
  constexpr int BM = 16 * TM;
  __shared__ float lut[repro::Packing<BITS>::kEntries];
  __shared__ float xs[BK][BM + 1];   // transposed activation tile
  __shared__ float ws[BK][kBN];      // dequantized weight tile

  repro::stage_codebook<BITS>(lut, cb, k_entries);
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * BM;
  const int nsteps = (Wk + SW - 1) / SW;
  const int s_begin = blockIdx.z * steps_per_split;
  const int s_end = min(nsteps, s_begin + steps_per_split);

  float acc[TM][4];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  __syncthreads();

  for (int s = s_begin; s < s_end; ++s) {
    const int w0 = s * SW;
    const int k0 = w0 * LANES;
    for (int i = threadIdx.x; i < SW * kBN; i += kThreads) {
      const int wr = i / kBN, c = i % kBN;
      const int gw = w0 + wr, n = n0 + c;
      const bool in = gw < Wk && n < N;
      const uint32_t word = in ? pidx[static_cast<int64_t>(gw) * N + n] : 0u;
#pragma unroll
      for (int l = 0; l < LANES; ++l) {
        const int k = gw * LANES + l;
        ws[wr * LANES + l][c] =
            (in && k < Kd) ? lut[repro::unpack_lane<BITS>(word, l)] : 0.0f;
      }
    }
    for (int i = threadIdx.x; i < BM * BK; i += kThreads) {
      const int r = i / BK, kk = i % BK;
      const int m = m0 + r, k = k0 + kk;
      xs[kk][r] = (m < M && k < Kd) ? x[static_cast<int64_t>(m) * Kd + k] : 0.0f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
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

template <int BITS>
int launch(const float* x, const uint32_t* pidx, const float* cb, float* out,
           float* partial, int M, int Kd, int N, int Wk, int k_entries,
           int splits, cudaStream_t s) {
  const int nsteps = (Wk + Step<BITS>::kWords - 1) / Step<BITS>::kWords;
  splits = max(1, min(splits, nsteps));
  const int per = max(1, (nsteps + splits - 1) / splits);
  splits = max(1, (nsteps + per - 1) / per);
  float* dst = splits > 1 ? partial : out;
  const int tm = M > 16 ? 4 : 1;
  const dim3 grid((N + kBN - 1) / kBN, (M + 16 * tm - 1) / (16 * tm), splits);
  if (tm == 4)
    packed_matmul_kernel<BITS, 4><<<grid, kThreads, 0, s>>>(
        x, pidx, cb, dst, M, Kd, N, Wk, k_entries, per);
  else
    packed_matmul_kernel<BITS, 1><<<grid, kThreads, 0, s>>>(
        x, pidx, cb, dst, M, Kd, N, Wk, k_entries, per);
  if (splits > 1) {
    const int64_t mn = static_cast<int64_t>(M) * N;
    splitk_reduce_kernel<<<static_cast<unsigned>((mn + 255) / 256), 256, 0, s>>>(
        partial, out, mn, splits);
  }
  return 0;
}

}  // namespace

REPRO_EXPORT_ERROR_STRING

// x [M, Kd] f32; pidx [Wk, N] uint32; cb [K] f32; out [M, N] f32;
// partial: workspace of splits * M * N f32 (unused when splits == 1).
extern "C" int repro_codebook_matmul_packed(const void* x, const void* pidx,
                                            const void* cb, void* out,
                                            void* partial, int M, int Kd,
                                            int N, int Wk, int k_entries,
                                            int bits, int splits,
                                            void* stream) {
  if (M == 0 || N == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  REPRO_DISPATCH_BITS(bits,
      launch<BITS>(static_cast<const float*>(x),
                   static_cast<const uint32_t*>(pidx),
                   static_cast<const float*>(cb), static_cast<float*>(out),
                   static_cast<float*>(partial), M, Kd, N, Wk, k_entries,
                   splits, s));
  return static_cast<int>(cudaGetLastError());
}
