// Embedding dequant-on-gather over a row-packed table.
//
// Replaces: src/repro/kernels/quantized_gather.py:quantized_gather_pallas.
// Computes: out[t, d] = cb[unpack(pidx[tokens[t]])[d]] where the [V, D]
//   table is stored as pack_rows words pidx [V, Wd = ceil(D / lanes)].
// Bound on H100: bytes.  It reads T * Wd * 4 bytes of words and writes
//   T * D * 4 bytes of f32; there is no arithmetic beyond a shift, a mask and
//   a shared-memory load per element.
// Design: one block per token.  The codebook is staged once per block as a
//   2^bits-entry shared-memory LUT; the block's threads walk the token's word
//   row with consecutive threads on consecutive words (coalesced), unpack each
//   word's lanes and write them as consecutive floats.  Nothing is summed, so
//   the result equals the plain gather bit for bit.  Token ids outside
//   [0, V) are clamped, as XLA's gather clamps them in the reference.
#include "unpack.cuh"

namespace {

template <int BITS>
__global__ void quantized_gather_kernel(const int32_t* __restrict__ tokens,
                                        const uint32_t* __restrict__ pidx,
                                        const float* __restrict__ cb,
                                        float* __restrict__ out, int V, int D,
                                        int Wd, int k_entries) {
  constexpr int LANES = repro::Packing<BITS>::kLanes;
  __shared__ float lut[repro::Packing<BITS>::kEntries];
  repro::stage_codebook<BITS>(lut, cb, k_entries);
  __syncthreads();

  const int t = blockIdx.x;
  int row = tokens[t];
  row = row < 0 ? 0 : (row >= V ? V - 1 : row);
  const uint32_t* src = pidx + static_cast<int64_t>(row) * Wd;
  float* dst = out + static_cast<int64_t>(t) * D;
  for (int w = threadIdx.x; w < Wd; w += blockDim.x) {
    const uint32_t word = src[w];
#pragma unroll
    for (int l = 0; l < LANES; ++l) {
      const int d = w * LANES + l;
      if (d < D) dst[d] = lut[repro::unpack_lane<BITS>(word, l)];
    }
  }
}

}  // namespace

REPRO_EXPORT_ERROR_STRING

// tokens [T] int32; pidx [V, Wd] uint32; cb [K] f32; out [T, D] f32.
extern "C" int repro_quantized_gather(const void* tokens, const void* pidx,
                                      const void* cb, void* out, int T, int V,
                                      int D, int Wd, int k_entries, int bits,
                                      void* stream) {
  if (T == 0) return 0;
  const dim3 grid(T), block(128);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  REPRO_DISPATCH_BITS(bits,
      quantized_gather_kernel<BITS><<<grid, block, 0, s>>>(
          static_cast<const int32_t*>(tokens),
          static_cast<const uint32_t*>(pidx), static_cast<const float*>(cb),
          static_cast<float*>(out), V, D, Wd, k_entries));
  return static_cast<int>(cudaGetLastError());
}
