// Shared device code of the two codebook matmul kernels: kernel row 1
// (codebook_matmul_packed.cu, bit-packed index words) and kernel row 11
// (codebook_matmul.cu, uint8 indices).  Each .cu supplies an operand policy
// (how its index operand is loaded, staged and unpacked); the kernels, the
// (hi, lo) TF32 codebook, the 3xTF32 wgmma step and the fixed-order
// reductions are here.
//
// y[M, N] = x[M, Kd] . W, W[k, n] = cb[idx[k, n]], f32 in and out.  The host
// wrapper picks one of two launch plans per call
// (kernels/codebook_matmul_packed.py: plan); either is one launch.
//
// Decode (M <= 16): bound by the index bytes (a few rows of x reuse each
//   weight a few times).  decode_kernel: 256 threads own 32 output columns;
//   a lane owns 4 neighbouring columns and reads one "load row" of them per
//   load (packed: one 16-byte load of 4 words, LANES reduction rows; uint8:
//   one 4-byte load, one row), 8 lanes span the 32 columns, and the block's
//   32 lane groups take consecutive load rows with kUnroll loads in flight
//   per thread.  Weights come from the codebook in shared memory, f32 FMAs
//   on the CUDA cores into MR x 4 registers (MR = 4 or 16 rows of x).  The
//   lane groups' partials are summed in a fixed order: a shuffle butterfly
//   inside the warp, then the 8 warps in order through shared memory.
//
// Prefill (M > 16): bound by operations.  tc_kernel: one warpgroup (4
//   warps) owns a 64 x 64 or 64 x 32 output tile and runs 3xTF32 products on
//   the tensor cores with wgmma (m64nNk8, f32 accumulation).  A cp.async
//   ring of Op::kStages steps (4, or 3 where 4 would not fit three blocks an
//   SM) stages, per K step of whole index rows (Op::kStepRows, a multiple of
//   8), the x tile (rows past M and columns past Kd zero-filled) and the raw
//   index tile (past N or the last row zero-filled).  Each step's
//   weights are dequantized once per block through the codebook LUT, held as
//   (hi, lo) TF32 pairs, into two K-major shared-memory B operands (wgmma's
//   core-matrix layout, no swizzle), double-buffered: the next step's are
//   written while the tensor cores run.  x fragments are split to (hi, lo) in
//   registers as they are read (wgmma's A from registers).  Per k8 slice
//   three wgmma: a_lo.b_hi + a_hi.b_lo + a_hi.b_hi.  One TF32 pass keeps 10
//   mantissa bits (~5e-4 relative per product), which over Kd ~ 10^3 terms
//   breaks the 1e-4 x max |y| gate against the plain version; the three
//   passes leave ~1e-6.  Rows past Kd read (0, 0) weights on the last step.
//
// Split K across a cluster: both kernels may split the reduction over the
//   gridDim.z blocks of one (1, 1, S) thread-block cluster (S <= 8).  Each
//   block leaves its partial tile in its shared memory; after a cluster
//   barrier, block r sums the S tiles for its 1/S share of the outputs,
//   reading its peers' shared memory (distributed shared memory) in rank
//   order.  No workspace, no second launch, no atomics: the same inputs give
//   the same bits on every call.
#pragma once

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>
#include <type_traits>

namespace repro {
namespace cbmm {

namespace cg = cooperative_groups;

constexpr int kMaxSplits = 8;              // the portable cluster size
constexpr int kDecodeMaxM = 16;
constexpr int kDecodeThreads = 256;
constexpr int kDecodeWarps = kDecodeThreads / 32;
constexpr int kDecodeCols = 32;            // output columns of a block
constexpr int kLaneCols = 4;               // a lane's columns (one load)
constexpr int kDecodeGroups = kDecodeThreads / (kDecodeCols / kLaneCols);
constexpr int kTcThreads = 128;            // one warpgroup
constexpr int kTcRows = 64;                // output rows of a tensor-core tile
constexpr int kTcResident = 3;             // blocks an SM holds (register cap)

// Word rows of a tensor-core K step for LANES indices a word: whole word
// rows, a multiple of 8 reduction rows (the mma's k) and at least 32.
__host__ __device__ constexpr int step_words(int lanes) {
  int w = 1;
  while ((w * lanes) % 8 != 0 || w * lanes < 32) ++w;
  return w;
}

// --- cp.async ---------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// body(e) for this thread's share e = threadIdx.x + c * THREADS < TOTAL of
// a block-wide loop, unrolled: every thread's loads are in flight together.
template <int TOTAL, int THREADS, class F>
__device__ __forceinline__ void for_each_of_thread(F&& body) {
#pragma unroll
  for (int c = 0; c < (TOTAL + THREADS - 1) / THREADS; ++c) {
    const int e = static_cast<int>(threadIdx.x) + c * THREADS;
    if (TOTAL % THREADS == 0 || e < TOTAL) body(e);
  }
}

// --- 3xTF32 -----------------------------------------------------------------

// f32 -> TF32 (kept in f32 bits): round to nearest at 10 mantissa bits,
// ties away from zero, as cvt.rna.tf32.f32 rounds a finite value; two
// integer instructions, which timed faster than the conversion on the H100.
__device__ __forceinline__ uint32_t to_tf32(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

// v = hi + lo to ~2^-22 relative: hi keeps TF32's 10 mantissa bits (round
// to nearest), lo the rounded remainder (v - hi is exact in f32).
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(v);
  lo = to_tf32(v - __uint_as_float(hi));
}

// The codebook as a `size`-entry LUT of (hi, lo) TF32 pairs in shared memory;
// entries past K read (0, 0).  The caller synchronises.
__device__ __forceinline__ void stage_lut_pairs(float2* lut, const float* cb,
                                                int k_entries, int size) {
  for (int i = threadIdx.x; i < size; i += blockDim.x) {
    uint32_t hi, lo;
    split_tf32(i < k_entries ? cb[i] : 0.0f, hi, lo);
    lut[i] = make_float2(__uint_as_float(hi), __uint_as_float(lo));
  }
}

// --- the cluster's fixed-order reduction -----------------------------------

// Sum the gridDim.z partial tiles part[r * stride + c] (r < rows, c < cols)
// that the blocks of this block's (1, 1, gridDim.z) cluster hold in shared
// memory, in rank order, and store this block's 1/gridDim.z share of the sums
// to out[(m0 + r) * N + n0 + c] inside M x N.  Every thread of every block of
// the cluster calls it once its own partial tile is written.
__device__ __forceinline__ void cluster_sum_store(float* part, int rows,
                                                  int cols, int stride,
                                                  float* __restrict__ out,
                                                  int m0, int n0, int M,
                                                  int N) {
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();                      // every partial tile is in place
  const int splits = static_cast<int>(gridDim.z);
  const int rank = static_cast<int>(cluster.block_rank());
  const int total = rows * cols;
  const int share = (total + splits - 1) / splits;
  const int end = min(total, (rank + 1) * share);
  for (int e = rank * share + static_cast<int>(threadIdx.x); e < end;
       e += static_cast<int>(blockDim.x)) {
    const int r = e / cols, c = e % cols;
    const int m = m0 + r, n = n0 + c;
    if (m >= M || n >= N) continue;
    float* own = part + r * stride + c;
    float s = *cluster.map_shared_rank(own, 0u);
    for (int j = 1; j < splits; ++j)
      s += *cluster.map_shared_rank(own, static_cast<unsigned>(j));
    out[static_cast<int64_t>(m) * N + n] = s;
  }
  cluster.sync();                      // no block leaves while peers read it
}

// --- decode plan: CUDA cores, bound by the index bytes ---------------------

// acc[m][j] += x[m, k] * W[k, column j] over the reduction rows of one load.
template <int MR, class Op>
__device__ __forceinline__ void accumulate(float (&acc)[MR][kLaneCols],
                                           const typename Op::Load& q,
                                           int row, const float* __restrict__ x,
                                           const float* lut, int M, int Kd) {
  const int k0 = row * Op::kRowsPerLoad;
  const int kn = min(Op::kRowsPerLoad, Kd - k0);
#pragma unroll 8
  for (int l = 0; l < Op::kRowsPerLoad; ++l) {
    if (l >= kn) break;
    float w[kLaneCols];
#pragma unroll
    for (int j = 0; j < kLaneCols; ++j) w[j] = lut[Op::index(q, j, l)];
    const float* xk = x + k0 + l;
#pragma unroll
    for (int m = 0; m < MR; ++m) {
      const float xv = m < M ? __ldg(xk + static_cast<int64_t>(m) * Kd) : 0.0f;
#pragma unroll
      for (int j = 0; j < kLaneCols; ++j) acc[m][j] = fmaf(xv, w[j], acc[m][j]);
    }
  }
}

template <class Op, int MR>
__global__ void __launch_bounds__(kDecodeThreads)
decode_kernel(const float* __restrict__ x, Op op, const float* __restrict__ cb,
              float* __restrict__ out, int M, int Kd, int N, int k_entries) {
  __shared__ float lut[Op::kEntries];
  __shared__ float warp_part[kDecodeWarps][MR][kDecodeCols];
  __shared__ float part[MR][kDecodeCols];
  for (int i = threadIdx.x; i < Op::kEntries; i += kDecodeThreads)
    lut[i] = i < k_entries ? cb[i] : 0.0f;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col = (lane & 7) * kLaneCols;     // the lane's first column
  const int group = warp * 4 + (lane >> 3);   // its lane group, 0..31
  const int n0 = blockIdx.x * kDecodeCols;
  const int rows = op.load_rows();
  const int per = (rows + static_cast<int>(gridDim.z) - 1) /
                  static_cast<int>(gridDim.z);
  const int r0 = blockIdx.z * per, r1 = min(rows, r0 + per);
  float acc[MR][kLaneCols];
#pragma unroll
  for (int m = 0; m < MR; ++m)
#pragma unroll
    for (int j = 0; j < kLaneCols; ++j) acc[m][j] = 0.0f;

  // rounds of kUnroll loads a thread; the next round is in flight while one
  // is folded, and the first while the codebook is staged
  using Load = typename Op::Load;
  constexpr int kRound = Op::kUnroll * kDecodeGroups;
  auto load_round = [&](Load (&q)[Op::kUnroll], int r) {
#pragma unroll
    for (int u = 0; u < Op::kUnroll; ++u) {
      const int ru = r + u * kDecodeGroups;
      q[u] = ru < r1 ? op.load(ru, n0 + col) : Load{};
    }
  };
  Load q[Op::kUnroll], ahead[Op::kUnroll];
  load_round(q, r0 + group);
  __syncthreads();                     // the codebook is staged
  for (int r = r0 + group; r < r1; r += kRound) {
    if (r + kRound < r1) load_round(ahead, r + kRound);
#pragma unroll
    for (int u = 0; u < Op::kUnroll; ++u) {
      const int ru = r + u * kDecodeGroups;
      if (ru < r1) accumulate<MR, Op>(acc, q[u], ru, x, lut, M, Kd);
    }
#pragma unroll
    for (int u = 0; u < Op::kUnroll; ++u) q[u] = ahead[u];
  }

  // lane groups of a warp (lanes c, c + 8, c + 16, c + 24), then the warps
  // in order: a fixed tree
#pragma unroll
  for (int m = 0; m < MR; ++m) {
    if (m >= M) break;
#pragma unroll
    for (int j = 0; j < kLaneCols; ++j) {
      float v = acc[m][j];
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      if (lane < 8) warp_part[warp][m][col + j] = v;
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < M * kDecodeCols; e += kDecodeThreads) {
    const int m = e / kDecodeCols, c = e % kDecodeCols;
    float s = warp_part[0][m][c];
#pragma unroll
    for (int w = 1; w < kDecodeWarps; ++w) s += warp_part[w][m][c];
    part[m][c] = s;
  }
  cluster_sum_store(&part[0][0], M, kDecodeCols, kDecodeCols, out, 0, n0, M,
                    N);
}

// --- prefill plan: 3xTF32 on the tensor cores (wgmma), bound by operations

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// The compiler must not move accumulator registers across a wait: wgmma
// writes them asynchronously.
template <int R>
__device__ __forceinline__ void fence_operand(float (&d)[R]) {
#pragma unroll
  for (int e = 0; e < R; ++e) asm volatile("" : "+f"(d[e])::"memory");
}

// Generic-proxy writes to shared memory become visible to wgmma's reads.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Shared-memory matrix descriptor, no swizzle: start address, the byte
// offset between core matrices adjacent in K (leading) and in N (stride).
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return static_cast<uint64_t>((a & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFFu) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFFu) >> 4) << 32);
}

// d += a . B on a 64 x 64 x 8 step: A (TF32) from registers, B (TF32,
// K-major, no swizzle) from shared memory through its descriptor.
__device__ __forceinline__ void wgmma_n64(float (&d)[32],
                                          const uint32_t (&a)[4],
                                          uint64_t b) {
  // scale-d = 1 (accumulate), as a predicate; imm-scale-a/b = 1
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d += a . B on a 64 x 32 x 8 step: A (TF32) from registers, B (TF32,
// K-major, no swizzle) from shared memory through its descriptor.
__device__ __forceinline__ void wgmma_n32(float (&d)[16],
                                          const uint32_t (&a)[4],
                                          uint64_t b) {
  // scale-d = 1 (accumulate), as a predicate; imm-scale-a/b = 1
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma_step(float (&d)[BN / 2],
                                           const uint32_t (&a)[4], uint64_t b) {
  if constexpr (BN == 64)
    wgmma_n64(d, a, b);
  else
    wgmma_n32(d, a, b);
}

// Dynamic shared memory of tc_kernel: the cp.async ring of Op::kStages x
// tiles and raw index tiles, two buffers of the step's dequantized B as TF32
// (hi, lo) halves in wgmma's core-matrix layout, and the (hi, lo) LUT; after
// the K loop the x ring holds the partial output tile.
template <class Op, int BN>
struct TcSmem {
  static constexpr int BM = kTcRows;
  static constexpr int kXStride = Op::kStepRows + 4;   // conflict-free A reads
  static constexpr int kXBytes = BM * kXStride * 4;
  static constexpr int kTileBytes = Op::template Tile<BN>::kBytes;
  static constexpr int kTileOffset = Op::kStages * kXBytes;
  static constexpr int kBBytes = Op::kStepRows * BN * 4;   // one half
  static constexpr int kBOffset = kTileOffset + Op::kStages * kTileBytes;
  static constexpr int kLutOffset = kBOffset + 4 * kBBytes;  // 2 x (hi, lo)
  static constexpr int kBytes = kLutOffset + Op::kEntries * 8;
  static constexpr int kRedStride = BN + 4;
  static_assert(kXBytes % 16 == 0 && kTileBytes % 16 == 0 &&
                    kBOffset % 128 == 0,
                "aligned stages");
  static_assert(BM * kRedStride * 4 <= Op::kStages * kXBytes,
                "the partial tile fits the x ring");
};

// Byte offset of B element (k, n) of a K step in the core-matrix layout: per
// k8 slice, per 8-column group, two 8 x 16-byte core matrices (k 0-3, 4-7).
template <int BN>
__device__ __forceinline__ int b_offset(int k, int n) {
  return (((k >> 3) * (BN / 8) + (n >> 3)) * 2 + ((k >> 2) & 1)) * 128 +
         (n & 7) * 16 + (k & 3) * 4;
}

// One warpgroup owns a 64 x BN output tile: warp w holds rows 16w .. 16w+15
// of the A fragments (split to (hi, lo) in registers as they are read) and of
// the accumulators.
template <class Op, int BN>
__global__ void __launch_bounds__(kTcThreads, kTcResident)
tc_kernel(const float* __restrict__ x, Op op, const float* __restrict__ cb,
          float* __restrict__ out, int M, int Kd, int N, int k_entries,
          int xvec) {
  constexpr int BM = kTcRows;
  constexpr int KR = Op::kStepRows;
  constexpr int KS = KR / 8;                     // k8 slices a K step
  using L = TcSmem<Op, BN>;
  constexpr int XS = L::kXStride;
  extern __shared__ __align__(128) unsigned char smem[];
  float2* lut = reinterpret_cast<float2*>(smem + L::kLutOffset);
  unsigned char* bhi = smem + L::kBOffset;   // buffer b: hi, then lo
  stage_lut_pairs(lut, cb, k_entries, Op::kEntries);

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int nsteps = (Kd + KR - 1) / KR;
  const int per = (nsteps + static_cast<int>(gridDim.z) - 1) /
                  static_cast<int>(gridDim.z);
  const int s0 = blockIdx.z * per;
  const int count = max(0, min(nsteps, s0 + per) - s0);

  // stage K step s0 + i into ring slot i % Op::kStages
  auto stage_step = [&](int i) {
    const int b = i % Op::kStages, k0 = (s0 + i) * KR;
    float* xd = reinterpret_cast<float*>(smem + b * L::kXBytes);
    if (xvec) {
      for_each_of_thread<BM * (KR / 4), kTcThreads>([&](int e) {
        const int r = e / (KR / 4), c = (e % (KR / 4)) * 4;
        const int m = m0 + r, k = k0 + c;
        const bool ok = m < M && k < Kd;
        cp_async16(xd + r * XS + c,
                   ok ? x + static_cast<int64_t>(m) * Kd + k : x, ok ? 16 : 0);
      });
    } else {
      for_each_of_thread<BM * KR, kTcThreads>([&](int e) {
        const int r = e / KR, c = e % KR;
        const int m = m0 + r, k = k0 + c;
        const bool ok = m < M && k < Kd;
        cp_async4(xd + r * XS + c,
                  ok ? x + static_cast<int64_t>(m) * Kd + k : x, ok ? 4 : 0);
      });
    }
    op.template stage<BN, kTcThreads>(
        smem + L::kTileOffset + b * L::kTileBytes, s0 + i, n0);
  };
#pragma unroll
  for (int i = 0; i < Op::kStages - 1; ++i) {
    if (i < count) stage_step(i);
    cp_async_commit();
  }

  // the step's weights, once, as (hi, lo) TF32 halves into B buffer
  // i % 2; rows past Kd read 0 (the last step only).  A thread takes 4 rows
  // of one column: one 16-byte store per half, and 8 lanes fill a core
  // matrix's 128 bytes.
  auto dequant = [&](int i) {
    const unsigned char* tb =
        smem + L::kTileOffset + (i % Op::kStages) * L::kTileBytes;
    unsigned char* hi = bhi + (i % 2) * 2 * L::kBBytes;
    unsigned char* lo = hi + L::kBBytes;
    const int kmax = Kd - (s0 + i) * KR;
    auto chunks = [&](auto masked) {
      for_each_of_thread<(KR / 4) * BN, kTcThreads>([&](int e) {
        const int n = e % BN, k4 = e / BN;
        uint32_t idx[4];
        op.template tile_indices<BN>(tb, k4, n, idx);
        float h[4], l[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float2 v = lut[idx[j]];
          if constexpr (decltype(masked)::value) {
            if (4 * k4 + j >= kmax) v = make_float2(0.0f, 0.0f);
          }
          h[j] = v.x;
          l[j] = v.y;
        }
        const int o = b_offset<BN>(4 * k4, n);
        *reinterpret_cast<float4*>(hi + o) =
            make_float4(h[0], h[1], h[2], h[3]);
        *reinterpret_cast<float4*>(lo + o) =
            make_float4(l[0], l[1], l[2], l[3]);
      });
    };
    if (kmax >= KR)
      chunks(std::false_type{});
    else
      chunks(std::true_type{});
    fence_proxy_async();               // visible to wgmma after the barrier
  };

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  float d[BN / 2];
#pragma unroll
  for (int e = 0; e < BN / 2; ++e) d[e] = 0.0f;

  if (count > 0) {
    cp_async_wait<Op::kStages - 2>();  // step 0 landed
    __syncthreads();                   // (and the codebook is staged)
    dequant(0);
    __syncthreads();
  }
  for (int i = 0; i < count; ++i) {
    const float* xb = reinterpret_cast<const float*>(
        smem + (i % Op::kStages) * L::kXBytes);
    const unsigned char* hi = bhi + (i % 2) * 2 * L::kBBytes;
    const unsigned char* lo = hi + L::kBBytes;
    uint32_t ahi[KS][4], alo[KS][4];
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const float* a = xb + (16 * warp + g) * XS + 8 * ks + q;
      split_tf32(a[0], ahi[ks][0], alo[ks][0]);
      split_tf32(a[8 * XS], ahi[ks][1], alo[ks][1]);
      split_tf32(a[4], ahi[ks][2], alo[ks][2]);
      split_tf32(a[8 * XS + 4], ahi[ks][3], alo[ks][3]);
    }
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const int off = ks * (BN / 8) * 256;
      const uint64_t dh = smem_desc(hi + off, 128, 256);
      const uint64_t dl = smem_desc(lo + off, 128, 256);
      // 3xTF32, small terms first
      wgmma_step<BN>(d, alo[ks], dh);
      wgmma_step<BN>(d, ahi[ks], dl);
      wgmma_step<BN>(d, ahi[ks], dh);
    }
    wgmma_commit();
    // while the tensor cores run: stage step i + 3, dequantize step
    // i + 1 into the other B buffer (its last reader, step i - 1, is done)
    if (i + 1 < count) {
      cp_async_wait<Op::kStages - 3>();  // step i + 1 landed
      __syncthreads();                 // every warp has read step i's x
      if (i + Op::kStages - 1 < count) stage_step(i + Op::kStages - 1);
      cp_async_commit();
      dequant(i + 1);
    }
    // waited here, not at the next step's top: the loop's back edge then
    // never sits inside a pipeline stage, which ptxas would serialize
    wgmma_wait<0>();
    fence_operand(d);
    __syncthreads();                   // B buffer (i + 1) % 2 is complete
  }
  cp_async_wait<0>();
  __syncthreads();                     // the ring is free for the partial tile

  float* red = reinterpret_cast<float*>(smem);
  constexpr int RS = L::kRedStride;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int r = 16 * warp + g, c = 8 * j + 2 * q;
    red[r * RS + c] = d[4 * j];
    red[r * RS + c + 1] = d[4 * j + 1];
    red[(r + 8) * RS + c] = d[4 * j + 2];
    red[(r + 8) * RS + c + 1] = d[4 * j + 3];
  }
  cluster_sum_store(red, BM, BN, RS, out, m0, n0, M, N);
}

// --- host side --------------------------------------------------------------

// Launch `kernel` on `grid` as (1, 1, grid.z) clusters.
template <typename... Params, typename... Args>
cudaError_t launch_clusters(void (*kernel)(Params...), dim3 grid, int threads,
                            int smem_bytes, cudaStream_t stream,
                            Args... args) {
  if (smem_bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem_bytes);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = grid.z;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// The plan the host wrapper chose: tile 0 is the decode plan (M <= 16), tile
// 64 or 32 the tensor-core plan with that square tile; `splits` (1..8) K
// splits, one cluster per output tile.  Returns a cudaError_t.
template <class Op>
int launch(const Op& op, const float* x, const float* cb, float* out, int M,
           int Kd, int N, int k_entries, int tile, int splits,
           cudaStream_t stream) {
  if (M < 0 || N < 0 || Kd < 0 || splits < 1 || splits > kMaxSplits ||
      k_entries <= 0 || k_entries > Op::kEntries)
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0 || N == 0) return 0;
  cudaError_t err;
  if (tile == 0) {
    if (M > kDecodeMaxM) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid((N + kDecodeCols - 1) / kDecodeCols, 1, splits);
    err = M <= 4 ? launch_clusters(decode_kernel<Op, 4>, grid, kDecodeThreads,
                                   0, stream, x, op, cb, out, M, Kd, N,
                                   k_entries)
                 : launch_clusters(decode_kernel<Op, 16>, grid,
                                   kDecodeThreads, 0, stream, x, op, cb, out,
                                   M, Kd, N, k_entries);
  } else if (tile == 64 || tile == 32) {
    const int xvec =
        Kd % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 ? 1 : 0;
    const dim3 grid((N + tile - 1) / tile, (M + kTcRows - 1) / kTcRows,
                    splits);
    err = tile == 64
              ? launch_clusters(tc_kernel<Op, 64>, grid, kTcThreads,
                                TcSmem<Op, 64>::kBytes, stream, x, op, cb,
                                out, M, Kd, N, k_entries, xvec)
              : launch_clusters(tc_kernel<Op, 32>, grid, kTcThreads,
                                TcSmem<Op, 32>::kBytes, stream, x, op, cb,
                                out, M, Kd, N, k_entries, xvec);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace cbmm
}  // namespace repro
