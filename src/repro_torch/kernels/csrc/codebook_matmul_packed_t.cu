// Transposed codebook matmul over a bit-packed [V, D] table: y = x · W^T.
//
// Replaces: src/repro/kernels/codebook_matmul_packed_t.py:
//   codebook_matmul_packed_t_pallas (the fused tied-embedding LM head).
// Computes: y[M, V] = x[M, D] · W^T with W[v, d] = cb[idx[v, d]], the indices
//   stored either as pack_rows words pidx [V, Wd = ceil(D / lanes)]
//   (order "row": each vocab row is one contiguous packed run along the
//   contraction axis D — the embedding serving layout) or as pack_indices_2d
//   words pidx [ceil(V / lanes), D] (order "kd").
// Bound on H100: bytes at decode.  The row-order words are the largest single
//   read of a decode step (V * D * bits / 8: 78 MB for qwen1.5-0.5b at 4 bits);
//   x and y are a few rows.  The FMAs (M * V * D) come close to the f32 rate
//   at M = 4, so the kernel must not add shared-memory traffic per FMA.
// Design (row order): x is staged once per block in shared memory, transposed
//   to [M, lanes, Wd] so that lane l of word w sits at xs[m][l][w]: a warp's 32
//   threads, on 32 consecutive words of a row, then read 32 consecutive floats
//   (no bank conflicts).  A fixed grid of blocks (a few per SM) walks the vocab;
//   each warp takes 4 rows at a time, its threads read those rows' words
//   coalesced, dequantize through a shared-memory LUT, and reuse each x value
//   for 4 rows; a warp shuffle reduction finishes each dot product.  Padding
//   lanes past D in a row's last word meet x = 0 and add exactly 0.  Rows of x
//   beyond MT are handled by re-staging x, chunk by chunk.
// Design (kd order, not on the serving path): one warp per output column v;
//   its threads walk D with consecutive threads on consecutive words of word
//   row v / lanes, extract lane v % lanes, and reduce with shuffles.
// The TPU kernel's sequential d grid axis becomes the in-warp loop over words.
#include "unpack.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 4;
constexpr unsigned kFull = 0xffffffffu;

template <int BITS, int MT>
__global__ void __launch_bounds__(kWarps * 32)
packed_matmul_t_row_kernel(const float* __restrict__ x,
                           const uint32_t* __restrict__ pidx,
                           const float* __restrict__ cb, float* __restrict__ out,
                           int M, int D, int V, int Wd, int k_entries) {
  constexpr int LANES = repro::Packing<BITS>::kLanes;
  constexpr int RPW = kRowsPerWarp;
  extern __shared__ float smem[];
  float* lut = smem;
  float* xs = smem + repro::Packing<BITS>::kEntries;   // [MT][LANES][Wd]
  repro::stage_codebook<BITS>(lut, cb, k_entries);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t first = (static_cast<int64_t>(blockIdx.x) * kWarps + warp) * RPW;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kWarps * RPW;
  const int dp = Wd * LANES;

  for (int m0 = 0; m0 < M; m0 += MT) {
    __syncthreads();
    for (int i = threadIdx.x; i < MT * dp; i += blockDim.x) {
      const int m = i / dp, k = i % dp;
      xs[(m * LANES + k % LANES) * Wd + k / LANES] =
          (m0 + m < M && k < D) ? x[static_cast<int64_t>(m0 + m) * D + k] : 0.0f;
    }
    __syncthreads();

    for (int64_t v0 = first; v0 < V; v0 += stride) {
      float acc[RPW][MT];
#pragma unroll
      for (int r = 0; r < RPW; ++r)
#pragma unroll
        for (int m = 0; m < MT; ++m) acc[r][m] = 0.0f;

      for (int w = lane; w < Wd; w += 32) {
        uint32_t wd[RPW];
#pragma unroll
        for (int r = 0; r < RPW; ++r)
          wd[r] = v0 + r < V ? pidx[(v0 + r) * Wd + w] : 0u;
#pragma unroll
        for (int l = 0; l < LANES; ++l) {
          float wv[RPW];
#pragma unroll
          for (int r = 0; r < RPW; ++r)
            wv[r] = lut[repro::unpack_lane<BITS>(wd[r], l)];
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            const float xv = xs[(m * LANES + l) * Wd + w];
#pragma unroll
            for (int r = 0; r < RPW; ++r) acc[r][m] = fmaf(xv, wv[r], acc[r][m]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < RPW; ++r)
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          float a = acc[r][m];
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) a += __shfl_xor_sync(kFull, a, off);
          if (lane == r * MT + m && v0 + r < V && m0 + m < M)
            out[static_cast<int64_t>(m0 + m) * V + v0 + r] = a;
        }
    }
  }
}

template <int BITS, int MT>
__global__ void __launch_bounds__(kWarps * 32)
packed_matmul_t_kd_kernel(const float* __restrict__ x,
                          const uint32_t* __restrict__ pidx,
                          const float* __restrict__ cb, float* __restrict__ out,
                          int M, int D, int V, int k_entries) {
  constexpr int LANES = repro::Packing<BITS>::kLanes;
  extern __shared__ float smem[];
  float* lut = smem;
  float* xs = smem + repro::Packing<BITS>::kEntries;   // [MT][D]
  repro::stage_codebook<BITS>(lut, cb, k_entries);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kWarps;

  for (int m0 = 0; m0 < M; m0 += MT) {
    __syncthreads();
    for (int i = threadIdx.x; i < MT * D; i += blockDim.x) {
      const int m = i / D, d = i % D;
      xs[i] = m0 + m < M ? x[static_cast<int64_t>(m0 + m) * D + d] : 0.0f;
    }
    __syncthreads();

    for (int64_t v = first; v < V; v += stride) {
      const uint32_t* row = pidx + (v / LANES) * D;
      const int l = static_cast<int>(v % LANES);
      float acc[MT];
#pragma unroll
      for (int m = 0; m < MT; ++m) acc[m] = 0.0f;
      for (int d = lane; d < D; d += 32) {
        const float wv = lut[(row[d] >> (l * BITS)) & repro::Packing<BITS>::kMask];
#pragma unroll
        for (int m = 0; m < MT; ++m) acc[m] = fmaf(xs[m * D + d], wv, acc[m]);
      }
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        float a = acc[m];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) a += __shfl_xor_sync(kFull, a, off);
        if (lane == m && m0 + m < M) out[static_cast<int64_t>(m0 + m) * V + v] = a;
      }
    }
  }
}

template <typename Kernel>
cudaError_t reserve_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <int BITS, int MT>
int launch(const float* x, const uint32_t* pidx, const float* cb, float* out,
           int M, int D, int V, int k_entries, bool row_order, int blocks,
           cudaStream_t s) {
  constexpr int LANES = repro::Packing<BITS>::kLanes;
  const int Wd = (D + LANES - 1) / LANES;
  const size_t bytes = sizeof(float) *
      (repro::Packing<BITS>::kEntries +
       static_cast<size_t>(MT) * (row_order ? Wd * LANES : D));
  if (bytes > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (row_order) {
    err = reserve_smem(packed_matmul_t_row_kernel<BITS, MT>, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    packed_matmul_t_row_kernel<BITS, MT><<<blocks, kWarps * 32, bytes, s>>>(
        x, pidx, cb, out, M, D, V, Wd, k_entries);
  } else {
    err = reserve_smem(packed_matmul_t_kd_kernel<BITS, MT>, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    packed_matmul_t_kd_kernel<BITS, MT><<<blocks, kWarps * 32, bytes, s>>>(
        x, pidx, cb, out, M, D, V, k_entries);
  }
  return 0;
}

}  // namespace

REPRO_EXPORT_ERROR_STRING

// x [M, D] f32; cb [K] f32; out [M, V] f32; pidx [V, ceil(D/lanes)] uint32
// when row_order, else [ceil(V/lanes), D].  `blocks`: grid size (the blocks
// walk the vocab in a grid-stride loop).
extern "C" int repro_codebook_matmul_packed_t(const void* x, const void* pidx,
                                              const void* cb, void* out, int M,
                                              int D, int V, int k_entries,
                                              int bits, int row_order,
                                              int blocks, void* stream) {
  if (M == 0 || V == 0) return 0;
  if (blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const uint32_t* pw = static_cast<const uint32_t*>(pidx);
  const float* cf = static_cast<const float*>(cb);
  float* of = static_cast<float*>(out);
  int rc = 0;
  if (M <= 4) {
    REPRO_DISPATCH_BITS(bits, rc = launch<BITS, 4>(xf, pw, cf, of, M, D, V,
                                                   k_entries, row_order != 0,
                                                   blocks, s));
  } else {
    REPRO_DISPATCH_BITS(bits, rc = launch<BITS, 8>(xf, pw, cf, of, M, D, V,
                                                   k_entries, row_order != 0,
                                                   blocks, s));
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
