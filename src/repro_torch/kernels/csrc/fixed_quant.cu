// Fixed-codebook quantizers, elementwise: binary, ternary, powers of two.
//
// Replaces: src/repro/kernels/fixed_quant.py:fixed_quant_pallas.
// Computes out = scale * Q(w / scale) for w of any shape in f32 or bf16 (out
//   in w's type, f32 arithmetic inside), with Q:
//     binary   sgn(t), sgn(0) = +1;
//     ternary  sgn(t) * 1[|t| >= 1/2];
//     pow2     Theorem A.1 with C = pow2_c, as fixed_quant.py:31-41 writes it:
//              f = -log2|t|, mid = floor(f + log2 1.5) with the reference's f32
//              constant, alpha = 0 if f > C+1, 1 if f <= 0, 2^-C if f > C,
//              else 2^-mid; q = sgn(t) * alpha.
//   It divides by scale (no reciprocal), so scale = 1 is exact.  A subnormal
//   t counts as 0, as under the reference's flush-to-zero arithmetic
//   (core/quant_ops.py flush_subnormal).  log2f is CUDA's (max 1 ulp); it
//   may differ from another library's log2 by an ulp, which moves the
//   exponent only where f + log2 1.5 is that close to an integer.
// Bound on H100: bytes (one read and one write per element; a few f32
//   operations each).
// Design: the TPU kernel tiles the flat array into (8, 1024) VMEM blocks;
//   here a grid-stride loop gives each thread consecutive elements of a
//   coalesced sweep.  The mode is a template parameter, so the loop carries
//   no branch on it.
#include <cfloat>
#include <cuda_bf16.h>

#include "unpack.cuh"

namespace {

constexpr int kThreads = 256;
constexpr float kLog2OnePointFive = 0.5849624872207642f;   // 0x3F15C01A

enum Mode { kBinary = 0, kTernary = 1, kPow2 = 2 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <int MODE>
__device__ __forceinline__ float quantize(float w, float scale, int C) {
  float t = __fdiv_rn(w, scale);
  if (fabsf(t) < FLT_MIN) t = 0.0f;
  const float s = t >= 0.0f ? 1.0f : -1.0f;
  if (MODE == kBinary) return __fmul_rn(s, scale);
  const float at = fabsf(t);
  float q;
  if (MODE == kTernary) {
    q = __fmul_rn(s, at >= 0.5f ? 1.0f : 0.0f);
  } else {
    const float f = at > 0.0f ? -log2f(at) : INFINITY;
    const float mid = floorf(__fadd_rn(f, kLog2OnePointFive));
    float alpha;
    if (f > static_cast<float>(C + 1)) alpha = 0.0f;
    else if (f <= 0.0f) alpha = 1.0f;
    else if (f > static_cast<float>(C)) alpha = ldexpf(1.0f, -C);
    else alpha = ldexpf(1.0f, -static_cast<int>(mid));
    q = __fmul_rn(alpha, s);
  }
  return __fmul_rn(q, scale);
}

template <typename T, int MODE>
__global__ void __launch_bounds__(kThreads)
fixed_quant_kernel(const T* __restrict__ w, T* __restrict__ out, long long n,
                   float scale, int C) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < n; i += stride)
    out[i] = from_f32<T>(quantize<MODE>(to_f32(w[i]), scale, C));
}

template <typename T>
int launch(const void* w, void* out, long long n, int mode, int C,
           float scale, cudaStream_t stream) {
  const long long want = (n + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < 132 * 16 ? want : 132 * 16);
  const T* src = static_cast<const T*>(w);
  T* dst = static_cast<T*>(out);
  switch (mode) {
    case kBinary:
      fixed_quant_kernel<T, kBinary><<<blocks, kThreads, 0, stream>>>(
          src, dst, n, scale, C);
      break;
    case kTernary:
      fixed_quant_kernel<T, kTernary><<<blocks, kThreads, 0, stream>>>(
          src, dst, n, scale, C);
      break;
    case kPow2:
      fixed_quant_kernel<T, kPow2><<<blocks, kThreads, 0, stream>>>(
          src, dst, n, scale, C);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

REPRO_EXPORT_ERROR_STRING

// w, out: n elements of dtype 0 (f32) or 1 (bf16); mode 0 binary, 1 ternary,
// 2 pow2 with C = pow2_c >= 0; scale > 0.
extern "C" int repro_fixed_quant(const void* w, void* out, long long n,
                                 int dtype, int mode, int pow2_c, float scale,
                                 void* stream) {
  if (n == 0) return 0;
  if (n < 0 || pow2_c < 0 || pow2_c > 126 || !(scale > 0.0f))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(w, out, n, mode, pow2_c, scale, s);
    case 1: return launch<__nv_bfloat16>(w, out, n, mode, pow2_c, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
