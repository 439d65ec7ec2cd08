// Shared device code of the packed-serving kernels: the shift+mask unpack of
// bit-packed uint32 index words and the K-entry LUT dequant.
//
// Counterpart of src/repro/kernels/unpack.py (unpack_words_axis0/_axis1,
// dequant_tile).  Bit layout (identical to the host packers
// core/compression.py pack_indices_2d / pack_rows): each word holds
// LANES = 32 / BITS indices, lane l at bit offset l * BITS, little-endian, no
// index straddles two words.  Both word orientations unpack with the same
// per-lane shift+mask; they differ only in which tensor axis a word's lanes
// run along, which each kernel handles in its own indexing.
//
// The reference's one-hot dequant (REPRO_DEQUANT=onehot) works around a
// Mosaic lowering limit and has no counterpart here: the LUT gives the same
// value exactly.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace repro {

template <int BITS>
struct Packing {
  static_assert(BITS >= 1 && BITS <= 8, "1..8 bits per index");
  static constexpr int kLanes = 32 / BITS;
  static constexpr int kEntries = 1 << BITS;
  static constexpr uint32_t kMask = (1u << BITS) - 1u;
};

// Index held at lane `lane` of `word`.
template <int BITS>
__device__ __forceinline__ uint32_t unpack_lane(uint32_t word, int lane) {
  return (word >> (lane * BITS)) & Packing<BITS>::kMask;
}

// Stage the codebook into shared memory as a full 2^BITS-entry LUT: entries
// past the codebook's K read 0, so no stored index can read outside it.
// Every thread of the block takes part; the caller synchronises.
template <int BITS>
__device__ __forceinline__ void stage_codebook(float* lut, const float* cb,
                                               int k_entries) {
  for (int i = threadIdx.x; i < Packing<BITS>::kEntries; i += blockDim.x)
    lut[i] = i < k_entries ? cb[i] : 0.0f;
}

}  // namespace repro

// Calls BODY with `constexpr int BITS` bound to the runtime value `bits`
// (1..8); any other value returns cudaErrorInvalidValue from the caller.
#define REPRO_DISPATCH_BITS(bits, ...)                         \
  switch (bits) {                                              \
    case 1: { constexpr int BITS = 1; __VA_ARGS__; } break;    \
    case 2: { constexpr int BITS = 2; __VA_ARGS__; } break;    \
    case 3: { constexpr int BITS = 3; __VA_ARGS__; } break;    \
    case 4: { constexpr int BITS = 4; __VA_ARGS__; } break;    \
    case 5: { constexpr int BITS = 5; __VA_ARGS__; } break;    \
    case 6: { constexpr int BITS = 6; __VA_ARGS__; } break;    \
    case 7: { constexpr int BITS = 7; __VA_ARGS__; } break;    \
    case 8: { constexpr int BITS = 8; __VA_ARGS__; } break;    \
    default: return (int)cudaErrorInvalidValue;               \
  }

// C interface helper every kernel library exports: the text of an error
// code returned by one of its entry points.
#define REPRO_EXPORT_ERROR_STRING                                  \
  extern "C" const char* repro_error_string(int err) {             \
    return cudaGetErrorString(static_cast<cudaError_t>(err));      \
  }
