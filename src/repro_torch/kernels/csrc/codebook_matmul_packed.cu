// Codebook matmul over bit-packed indices: y = x · cb[unpack(pidx)].
//
// Replaces: src/repro/kernels/codebook_matmul_packed.py:
//   codebook_matmul_packed_pallas.
// Computes: y[M, N] = x[M, Kd] · W, W[k, n] = cb[idx[k, n]], with the indices
//   stored as pack_indices_2d words pidx [Wk = ceil(Kd / lanes), N]: word
//   (w, n) holds rows w * lanes + l of column n, BITS = 1..8 bits an index
//   (lanes = 32 / BITS; 3, 5, 6 and 7 bits leave pad bits in a word).  f32 in
//   and out.
// Bound on H100, by launch plan (codebook_mma.cuh has both kernels):
//   decode (M <= 16): bytes.  The words, Kd * N * BITS / 8, are read once;
//   the FMAs are 2 * M * Kd * N, a few per byte.  The kernel streams the
//   words with 16-byte loads (4 neighbouring columns' words of one word row,
//   LANES reduction rows), several in flight per thread, dequantizes them
//   through the codebook in shared memory and sums in f32 on the CUDA cores;
//   K is split over the blocks of a cluster until the blocks fill the card,
//   and summed in rank order in one launch.
//   prefill (M > 16): operations.  2 * M * Kd * N f32 FMAs bound the CUDA
//   cores at 67 TFLOP/s; 3xTF32 on the tensor cores (three TF32 passes at
//   495 TFLOP/s) lowers that bound 2.5x.  wgmma takes x from registers,
//   split to (hi, lo) as it is read, and the weights from shared memory: a
//   K step stages whole word rows (step_words: a multiple of 8 reduction
//   rows, at least 32; widths whose word rows do not fill a k8 step take
//   several), and each word is unpacked once per block into (hi, lo) pairs
//   from the LUT, four rows of a column at a time (at 1, 2, 4, 7 and 8 bits
//   from one word, at 3, 5 and 6 bits from up to two).
// The TPU kernel's sequential k grid axis becomes the in-block K loop (and,
//   split, the blocks of one cluster).
#include "codebook_mma.cuh"
#include "unpack.cuh"

namespace {

template <int BITS>
struct PackedOperand {
  static constexpr int kLanes = repro::Packing<BITS>::kLanes;
  static constexpr int kEntries = repro::Packing<BITS>::kEntries;
  static constexpr int kRowsPerLoad = kLanes;   // decode: one word row
  static constexpr int kUnroll = 4;             // decode loads in flight
  static constexpr int kStepWords = repro::cbmm::step_words(kLanes);
  static constexpr int kStepRows = kStepWords * kLanes;
  static constexpr int kStages = 4;             // tensor-core cp.async ring
  using Load = uint4;

  // [kStepWords][BN + 8] words: rows 8 banks apart for the straddling widths
  template <int BN>
  struct Tile {
    static constexpr int kStride = BN + 8;
    static constexpr int kBytes = kStepWords * kStride * 4;
  };

  const uint32_t* p;   // [Wk, N]
  int Wk, N;
  int vec;             // N % 4 == 0 and p 16-byte aligned

  __device__ int load_rows() const { return Wk; }

  // Words of columns n .. n + 3 in word row w (past N: 0).
  __device__ uint4 load(int w, int n) const {
    const uint32_t* row = p + static_cast<int64_t>(w) * N;
    if (vec)
      return n < N ? __ldg(reinterpret_cast<const uint4*>(row + n))
                   : make_uint4(0u, 0u, 0u, 0u);
    uint4 q;
    q.x = n < N ? __ldg(row + n) : 0u;
    q.y = n + 1 < N ? __ldg(row + n + 1) : 0u;
    q.z = n + 2 < N ? __ldg(row + n + 2) : 0u;
    q.w = n + 3 < N ? __ldg(row + n + 3) : 0u;
    return q;
  }

  __device__ static uint32_t index(const uint4& q, int j, int l) {
    const uint32_t word = j == 0 ? q.x : j == 1 ? q.y : j == 2 ? q.z : q.w;
    return repro::unpack_lane<BITS>(word, l);
  }

  // Word rows [step * kStepWords, +kStepWords) x columns [n0, n0 + BN),
  // zero-filled past Wk and N.
  template <int BN, int THREADS>
  __device__ void stage(unsigned char* tile, int step, int n0) const {
    uint32_t* t = reinterpret_cast<uint32_t*>(tile);
    const int w0 = step * kStepWords;
    if (vec) {
      for (int i = threadIdx.x; i < kStepWords * (BN / 4); i += THREADS) {
        const int r = i / (BN / 4), c = (i % (BN / 4)) * 4;
        const int w = w0 + r, n = n0 + c;
        const bool ok = w < Wk && n < N;
        repro::cbmm::cp_async16(t + r * Tile<BN>::kStride + c,
                                ok ? p + static_cast<int64_t>(w) * N + n : p,
                                ok ? 16 : 0);
      }
    } else {
      for (int i = threadIdx.x; i < kStepWords * BN; i += THREADS) {
        const int r = i / BN, c = i % BN;
        const int w = w0 + r, n = n0 + c;
        const bool ok = w < Wk && n < N;
        repro::cbmm::cp_async4(t + r * Tile<BN>::kStride + c,
                               ok ? p + static_cast<int64_t>(w) * N + n : p,
                               ok ? 4 : 0);
      }
    }
  }

  // Indices of reduction rows 4 * k4 .. 4 * k4 + 3 (< kStepRows) of tile
  // column n: one word when the lanes come in fours (1, 2, 4, 7, 8 bits),
  // else row by row (a group of four may straddle two words).
  template <int BN>
  __device__ void tile_indices(const unsigned char* tile, int k4, int n,
                               uint32_t (&idx)[4]) const {
    const uint32_t* t = reinterpret_cast<const uint32_t*>(tile);
    if constexpr (kLanes % 4 == 0) {
      const int k = 4 * k4;
      const uint32_t word = t[(k / kLanes) * Tile<BN>::kStride + n];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        idx[j] = repro::unpack_lane<BITS>(word, k % kLanes + j);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = 4 * k4 + j;
        idx[j] = repro::unpack_lane<BITS>(
            t[(k / kLanes) * Tile<BN>::kStride + n], k % kLanes);
      }
    }
  }
};

}  // namespace

REPRO_EXPORT_ERROR_STRING

// x [M, Kd] f32; pidx [Wk, N] uint32; cb [K] f32; out [M, N] f32.  tile 0:
// the decode plan (M <= 16); 64 / 32: the tensor-core plan with that tile;
// splits: K splits (1..8), the blocks of one cluster.
extern "C" int repro_codebook_matmul_packed(const void* x, const void* pidx,
                                            const void* cb, void* out, int M,
                                            int Kd, int N, int Wk,
                                            int k_entries, int bits, int tile,
                                            int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  REPRO_DISPATCH_BITS(bits, {
    constexpr int kLanes = repro::Packing<BITS>::kLanes;
    if (Wk != (Kd + kLanes - 1) / kLanes)
      return static_cast<int>(cudaErrorInvalidValue);
    const PackedOperand<BITS> op{
        static_cast<const uint32_t*>(pidx), Wk, N,
        N % 4 == 0 && reinterpret_cast<uintptr_t>(pidx) % 16 == 0 ? 1 : 0};
    return repro::cbmm::launch(op, static_cast<const float*>(x),
                               static_cast<const float*>(cb),
                               static_cast<float*>(out), M, Kd, N, k_entries,
                               tile, splits, s);
  });
  return 0;
}

// Reduction rows of a tensor-core K step at `bits` (the wrapper's
// step_rows), for the host to check its plan against.
extern "C" int repro_codebook_matmul_packed_step_rows(int bits) {
  REPRO_DISPATCH_BITS(bits, return PackedOperand<BITS>::kStepRows);
  return 0;
}

// Dynamic shared memory of a tensor-core block at `bits` with `cols` output
// columns (the wrapper's tc_smem_bytes), for the host to check its plan.
extern "C" int repro_codebook_matmul_packed_tc_smem(int bits, int cols) {
  REPRO_DISPATCH_BITS(
      bits, return cols == 64
                ? repro::cbmm::TcSmem<PackedOperand<BITS>, 64>::kBytes
                : repro::cbmm::TcSmem<PackedOperand<BITS>, 32>::kBytes);
  return 0;
}
