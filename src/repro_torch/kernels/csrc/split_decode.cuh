// Shared device code of the split paged decode kernels (row 6,
// paged_attention.cu, and row 8, mla_paged_attention.cu): each slot's visible
// pages are split over the blocks of one thread-block cluster, and the
// blocks' partial softmax states are merged in a fixed order.
//
// Split.  The host picks `splits` (<= 8, the portable cluster size) and
// `pages` with splits * pages >= npg; block x of a (splits, 1, 1) cluster
// takes the slot's logical pages [x * pages, (x + 1) * pages), cut at the
// slot's visible rows (s <= pos, nothing when the slot is dead).  The block
// reads the physical ids of those pages once, into shared memory, so no
// tile's copies wait on a page-table load.  A split left with no visible
// row does no work: its state stays (m, l, acc) = (kNegInf, 0, 0).
//
// Merge.  Partial states (m_i, l_i, a_i) of one output element combine as
//   M = max_i m_i,  L = sum_i l_i e^(m_i - M),  A = sum_i a_i e^(m_i - M),
//   out = A / max(L, 1e-30),
// summed from +0 in index order (warps in warp order, then splits in rank
// order).  No atomics: two calls give the same bits.  An empty split is an
// exact no-op of the merge: kNegInf is finite, so its factor is
// e^(-1e30 - M) = 0 and it adds l_i * 0 = +0 and a_i * 0 = +0 to sums that
// started at +0 (and so are never -0).  When every split is empty (a dead
// slot) M = kNegInf, every factor is 1, L = A = 0 and the output is 0, never
// NaN.
//
// The blocks of a cluster merge through distributed shared memory (one
// launch, no workspace): each block leaves its partial in its own shared
// memory, a cluster barrier, then block rank r reads every block's partial
// for its 1/splits share of the outputs, in rank order.  The same pattern as
// codebook_mma.cuh's cluster_sum_store, with the softmax rescaling.
#pragma once

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "online_softmax.cuh"

namespace repro {
namespace split {

namespace cg = cooperative_groups;

constexpr int kMaxSplits = 8;                // the portable cluster size

// --- cp.async ---------------------------------------------------------------

// 16 bytes global -> shared; bytes past src_bytes read 0.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}

// 4 bytes global -> shared; src_bytes 0 writes 0 and reads nothing.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// --- the split ------------------------------------------------------------

// Logical rows [lo, hi) of the slot that split `split` attends: its pages
// [page0, page0 + pages) cut at the slot's visible rows.
struct Rows {
  int lo, hi, page0;
};

__device__ __forceinline__ Rows split_rows(int pos, int alive, int npg,
                                           int page, int pages, int split) {
  int n = 0;
  if (alive != 0 && pos >= 0) n = min(npg * page, pos + 1);
  return {min(n, split * pages * page), min(n, (split + 1) * pages * page),
          split * pages};
}

// ids[i] = the physical id of logical page page0 + i, clamped to
// [0, n_phys), for the split's pages that the table holds: one round of
// loads for the block, issued beside the load of pos (an id past pos is
// read and never used).  The caller synchronises.
__device__ __forceinline__ void stage_page_ids(
    int* ids, const int32_t* __restrict__ trow, int page0, int pages,
    int npg, int n_phys) {
  for (int i = threadIdx.x; i < min(pages, npg - page0); i += blockDim.x) {
    const int phys = trow[page0 + i];
    ids[i] = phys < 0 ? 0 : (phys >= n_phys ? n_phys - 1 : phys);
  }
}

// Pool row of logical row s, through the staged ids of the split's pages.
__device__ __forceinline__ int64_t pool_row(const int* ids, const Rows& rows,
                                            int s, int page) {
  return static_cast<int64_t>(ids[s / page - rows.page0]) * page + s % page;
}

// --- the merge ------------------------------------------------------------

struct State {
  float m, l, a;
};

// The ordered merge of n <= MAX partial states part(0), ..., part(n - 1) of
// one output element: (M, L, A) as in the header.
template <int MAX, class Part>
__device__ __forceinline__ State merge_in_order(int n, const Part& part) {
  float M = kNegInf;
#pragma unroll
  for (int i = 0; i < MAX; ++i)
    if (i < n) M = fmaxf(M, part(i).m);
  float L = 0.0f, A = 0.0f;
#pragma unroll
  for (int i = 0; i < MAX; ++i) {
    if (i < n) {
      const State p = part(i);
      const float f = expf(p.m - M);
      L = fmaf(p.l, f, L);
      A = fmaf(p.a, f, A);
    }
  }
  return {M, L, A};
}

// Merge the partials that the gridDim.x blocks of this block's (gridDim.x,
// 1, 1) cluster hold at the same shared-memory offsets (m[rows], l[rows],
// acc[r * ld + c] for c < cols), in rank order, and store this block's
// 1/gridDim.x share of the outputs as store(r, c, A / max(L, 1e-30)).  Every
// thread of every block of the cluster calls it once its partial is written.
// The peers' values are all loaded before the merge, so their latencies
// overlap.
template <class Store>
__device__ __forceinline__ void cluster_merge_store(const float* m,
                                                    const float* l,
                                                    const float* acc,
                                                    int rows, int cols,
                                                    int ld,
                                                    const Store& store) {
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();                      // every partial is in place
  const int splits = static_cast<int>(gridDim.x);
  const int rank = static_cast<int>(cluster.block_rank());
  const int total = rows * cols;
  const int share = (total + splits - 1) / splits;
  const int end = min(total, (rank + 1) * share);
  for (int e = rank * share + static_cast<int>(threadIdx.x); e < end;
       e += static_cast<int>(blockDim.x)) {
    const int r = e / cols, c = e % cols;
    State part[kMaxSplits];
#pragma unroll
    for (int i = 0; i < kMaxSplits; ++i) {
      if (i < splits) {
        const unsigned u = static_cast<unsigned>(i);
        part[i] = State{*cluster.map_shared_rank(m + r, u),
                        *cluster.map_shared_rank(l + r, u),
                        *cluster.map_shared_rank(acc + r * ld + c, u)};
      }
    }
    const State st = merge_in_order<kMaxSplits>(
        splits, [&](int i) { return part[i]; });
    store(r, c, st.a / fmaxf(st.l, kEps));
  }
  cluster.sync();                      // no block leaves while peers read it
}

// --- host side ------------------------------------------------------------

// Launch `kernel` on `grid` as (grid.x, 1, 1) clusters, opting in to
// `smem_bytes` of dynamic shared memory above 48 KB.
template <typename... Params, typename... Args>
cudaError_t launch(void (*kernel)(Params...), dim3 grid, int threads,
                   size_t smem_bytes, cudaStream_t stream, Args... args) {
  if (grid.x < 1 || grid.x > kMaxSplits || smem_bytes > 227 * 1024)
    return cudaErrorInvalidValue;
  if (smem_bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_bytes));
    if (e != cudaSuccess) return e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = grid.x;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

}  // namespace split
}  // namespace repro
