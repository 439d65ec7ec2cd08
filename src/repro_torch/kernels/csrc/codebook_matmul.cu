// Codebook matmul over uint8 indices: y = x · cb[idx].
//
// Replaces: src/repro/kernels/codebook_matmul.py:codebook_matmul_pallas.
// Computes: y[M, N] = x[M, Kd] · W, W[k, n] = cb[idx[k, n]], with idx uint8
//   [Kd, N] (the uint8 serving layout, one byte per weight) and cb f32
//   [K <= 256].  f32 in and out.
// Bound on H100, by launch plan (codebook_mma.cuh has both kernels, shared
//   with codebook_matmul_packed.cu):
//   decode (M <= 16): bytes, the Kd * N index bytes read once.  Each load is
//   4 bytes, the indices of 4 neighbouring columns in one row, when N % 4 ==
//   0 (one byte a load otherwise), 8 in flight per thread; the codebook is a
//   256-entry LUT in shared memory; f32 FMAs on the CUDA cores; K split over
//   the blocks of a cluster and summed in rank order in one launch.
//   prefill (M > 16): operations, 2 * M * Kd * N; 3xTF32 wgmma with the
//   codebook as 256 (hi, lo) TF32 pairs.  A K step stages 32 index rows by
//   4-byte cp.async where N % 4 == 0 (byte loads otherwise), in a 3-step
//   ring: the 2 KB LUT and the byte tiles leave no room for a fourth step
//   at three blocks an SM.
#include "codebook_mma.cuh"
#include "unpack.cuh"

namespace {

struct ByteOperand {
  static constexpr int kEntries = 256;
  static constexpr int kRowsPerLoad = 1;   // decode: one index row
  static constexpr int kUnroll = 8;        // decode loads in flight
  static constexpr int kStepRows = 32;
  // tensor-core cp.async ring: 3 steps keep three blocks an SM (its
  // 256-entry codebook and byte tiles outgrow four)
  static constexpr int kStages = 3;
  using Load = uint32_t;

  // [kStepRows][BN + 4] bytes: the four rows of a fragment's k in distinct
  // banks
  template <int BN>
  struct Tile {
    static constexpr int kStride = BN + 4;
    static constexpr int kBytes = kStepRows * kStride;
  };

  const uint8_t* p;   // [Kd, N]
  int Kd, N;
  int vec;            // N % 4 == 0 and p 4-byte aligned

  __device__ int load_rows() const { return Kd; }

  // Indices of columns n .. n + 3 in row k, byte j at bits 8j (past N: 0).
  __device__ uint32_t load(int k, int n) const {
    const uint8_t* row = p + static_cast<int64_t>(k) * N;
    if (vec)
      return n < N ? __ldg(reinterpret_cast<const unsigned int*>(row + n))
                   : 0u;
    uint32_t q = 0u;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (n + j < N) q |= static_cast<uint32_t>(__ldg(row + n + j)) << (8 * j);
    return q;
  }

  __device__ static uint32_t index(uint32_t q, int j, int) {
    return (q >> (8 * j)) & 0xffu;
  }

  // Rows [step * kStepRows, +kStepRows) x columns [n0, n0 + BN), zero past
  // Kd and N.
  template <int BN, int THREADS>
  __device__ void stage(unsigned char* tile, int step, int n0) const {
    const int k0 = step * kStepRows;
    if (vec) {
      for (int i = threadIdx.x; i < kStepRows * (BN / 4); i += THREADS) {
        const int r = i / (BN / 4), c = (i % (BN / 4)) * 4;
        const int k = k0 + r, n = n0 + c;
        const bool ok = k < Kd && n < N;
        repro::cbmm::cp_async4(tile + r * Tile<BN>::kStride + c,
                               ok ? p + static_cast<int64_t>(k) * N + n : p,
                               ok ? 4 : 0);
      }
    } else {
      // one byte a load: plain loads and stores, visible after the barrier
      // that precedes the step's use
      for (int i = threadIdx.x; i < kStepRows * BN; i += THREADS) {
        const int r = i / BN, c = i % BN;
        const int k = k0 + r, n = n0 + c;
        tile[r * Tile<BN>::kStride + c] =
            k < Kd && n < N ? __ldg(p + static_cast<int64_t>(k) * N + n)
                            : static_cast<uint8_t>(0);
      }
    }
  }

  // Indices of rows 4 * k4 .. 4 * k4 + 3 of tile column n.
  template <int BN>
  __device__ void tile_indices(const unsigned char* tile, int k4, int n,
                               uint32_t (&idx)[4]) const {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      idx[j] = tile[(4 * k4 + j) * Tile<BN>::kStride + n];
  }
};

}  // namespace

REPRO_EXPORT_ERROR_STRING

// x [M, Kd] f32; idx [Kd, N] uint8; cb [K <= 256] f32; out [M, N] f32.
// tile 0: the decode plan (M <= 16); 64 / 32: the tensor-core plan with that
// tile; splits: K splits (1..8), the blocks of one cluster.
extern "C" int repro_codebook_matmul(const void* x, const void* idx,
                                     const void* cb, void* out, int M, int Kd,
                                     int N, int k_entries, int tile,
                                     int splits, void* stream) {
  const ByteOperand op{
      static_cast<const uint8_t*>(idx), Kd, N,
      N % 4 == 0 && reinterpret_cast<uintptr_t>(idx) % 4 == 0 ? 1 : 0};
  return repro::cbmm::launch(op, static_cast<const float*>(x),
                             static_cast<const float*>(cb),
                             static_cast<float*>(out), M, Kd, N, k_entries,
                             tile, splits, static_cast<cudaStream_t>(stream));
}

// Reduction rows of a tensor-core K step (the wrapper's STEP_ROWS).
extern "C" int repro_codebook_matmul_step_rows() {
  return ByteOperand::kStepRows;
}

// Dynamic shared memory of a tensor-core block with `cols` output columns
// (the wrapper's tc_smem_bytes), for the host to check its plan.
extern "C" int repro_codebook_matmul_tc_smem(int cols) {
  return cols == 64 ? repro::cbmm::TcSmem<ByteOperand, 64>::kBytes
                    : repro::cbmm::TcSmem<ByteOperand, 32>::kBytes;
}
