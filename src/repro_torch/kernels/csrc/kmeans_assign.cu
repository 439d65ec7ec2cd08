// k-means assignment: one pass of 1-D k-means over the rows of a weight
// matrix, each row against its own codebook.
//
// Replaces: src/repro/kernels/kmeans_assign.py:kmeans_assign_pallas.
// Computes, for w [G, P] f32 and codebook [G, K] f32 (K <= 256, need not be
//   sorted): assign[g, i] = argmin_k (w[g, i] - c[g, k])^2, the squares taken
//   in f32 and compared with a strict < in ascending k, so a tie goes to the
//   lower index (the spec ref.kmeans_assign_ref); sums[g, k] = the sum of the
//   row's points assigned to k; counts[g, k] = their number.
// Bound on H100: bytes for small K (4 B read and 4 B written per point); the
//   K-wide argmin costs 3 K f32 operations per point, so from K of about 60
//   the f32 rate bounds it instead.
// Design: the TPU kernel walks its tiles in order and adds each tile's
//   one-hot sums into one output block; blocks on Hopper run in no order, so
//   here each block writes its own partial sums and counts and a second pass
//   adds the blocks in a fixed order.  Nothing uses float atomics, so the
//   result is the same on every run.
//   Pass 1, grid (blocks of T * kItems points, G): the block stages its row's
//   codebook in shared memory, and each thread takes kItems points strided by
//   T (coalesced).  A thread adds each point into its own accumulator
//   acc[k][thread] in shared memory (no conflicts: lane t of a warp always
//   reaches bank t), and a warp counts its points with one integer atomic per
//   distinct index (__match_any_sync).  The block then adds acc in f64 in a
//   fixed order (runs of 16 threads, then the runs) into its partial sum,
//   stored [G, K, blocks] so that pass 2 reads each centroid's run coalesced.
//   Pass 2, one block per (centroid, row): its 256 threads add the partials
//   in f64 (thread t takes blocks t, t + 256, ...) and the counts as 64-bit
//   integers, then a fixed tree adds the threads; each is converted to f32
//   once at the end: a count is exact up to 2^24 and correctly rounded
//   above.  The TPU kernel pads P to its tile and takes the padded lanes'
//   count off the centroid nearest 0; here the last block masks its tail, so
//   no count needs mending.
#include <cfloat>

#include "unpack.cuh"

namespace {

constexpr int kItems = 32;      // points per thread in pass 1
constexpr int kRun = 16;        // accumulator columns per f64 run
constexpr int kMaxK = 256;
constexpr int kFinishThreads = 256;

__device__ __forceinline__ float sq_dist(float x, float c) {
  const float d = __fsub_rn(x, c);
  return __fmul_rn(d, d);
}

__global__ void assign_kernel(const float* __restrict__ w,
                              const float* __restrict__ cb,
                              int32_t* __restrict__ assign,
                              double* __restrict__ part_sums,
                              int32_t* __restrict__ part_counts, long long P,
                              int K, int nblk) {
  extern __shared__ double smem[];
  const int T = blockDim.x;
  const int runs = T / kRun;
  double* red = smem;                                        // [K][runs]
  float* c = reinterpret_cast<float*>(red + K * runs);       // [K]
  int* cnt = reinterpret_cast<int*>(c + K);                  // [K]
  float* acc = reinterpret_cast<float*>(cnt + K);            // [K][T]
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const long long g = blockIdx.y;
  const long long b = blockIdx.x;

  for (int k = tid; k < K; k += T) {
    c[k] = cb[g * K + k];
    cnt[k] = 0;
  }
  for (int i = tid; i < K * T; i += T) acc[i] = 0.0f;
  __syncthreads();

  const float* row = w + g * P;
  int32_t* arow = assign + g * P;
  const long long base = b * T * kItems;
  for (int it = 0; it < kItems; ++it) {
    const long long i = base + static_cast<long long>(it) * T + tid;
    int best = -1;
    if (i < P) {
      const float x = row[i];
      float best_d = sq_dist(x, c[0]);
      best = 0;
      for (int k = 1; k < K; ++k) {
        const float d = sq_dist(x, c[k]);
        if (d < best_d) {
          best_d = d;
          best = k;
        }
      }
      arow[i] = best;
      acc[best * T + tid] += x;
    }
    // every lane runs the same trip count, so the whole warp is here
    const unsigned peers = __match_any_sync(0xffffffffu, best);
    if (best >= 0 && lane == __ffs(peers) - 1)
      atomicAdd(&cnt[best], __popc(peers));
  }
  __syncthreads();

  for (int j = tid; j < K * runs; j += T) {
    const float* a = acc + (j / runs) * T + (j % runs) * kRun;
    double s = 0.0;
    for (int t = 0; t < kRun; ++t) s += a[t];
    red[j] = s;
  }
  __syncthreads();
  for (int k = tid; k < K; k += T) {
    double s = 0.0;
    for (int r = 0; r < runs; ++r) s += red[k * runs + r];
    const long long o = (g * K + k) * nblk + b;
    part_sums[o] = s;
    part_counts[o] = cnt[k];
  }
}

__global__ void __launch_bounds__(kFinishThreads)
finish_kernel(const double* __restrict__ part_sums,
              const int32_t* __restrict__ part_counts,
              float* __restrict__ sums, float* __restrict__ counts,
              int nblk) {
  __shared__ double lane_sums[kFinishThreads];
  __shared__ long long lane_counts[kFinishThreads];
  const int tid = threadIdx.x;
  const long long row = static_cast<long long>(blockIdx.y) * gridDim.x +
                        blockIdx.x;                  // g * K + k
  const double* ps = part_sums + row * nblk;
  const int32_t* pc = part_counts + row * nblk;
  double s = 0.0;
  long long n = 0;
  for (int b = tid; b < nblk; b += kFinishThreads) {
    s += ps[b];
    n += pc[b];
  }
  lane_sums[tid] = s;
  lane_counts[tid] = n;
  __syncthreads();
  for (int half = kFinishThreads / 2; half > 0; half /= 2) {
    if (tid < half) {
      lane_sums[tid] += lane_sums[tid + half];
      lane_counts[tid] += lane_counts[tid + half];
    }
    __syncthreads();
  }
  if (tid == 0) {
    sums[row] = __double2float_rn(lane_sums[0]);
    counts[row] = __ll2float_rn(lane_counts[0]);
  }
}

}  // namespace

REPRO_EXPORT_ERROR_STRING

// Shared memory of pass 1 for K centroids and T threads.
static size_t assign_smem_bytes(int K, int T) {
  return static_cast<size_t>(K) * (T / kRun) * sizeof(double) +
         static_cast<size_t>(K) * (2 + T) * sizeof(float);
}

// w [G, P] f32; codebook [G, K] f32; assign [G, P] int32; part_sums
// [G, K, nblk] f64 and part_counts [G, K, nblk] int32 (scratch); sums and
// counts [G, K] f32.  threads is the wrapper's pick for K (32..256, a power of
// two) and nblk = ceil(P / (threads * 32)).
extern "C" int repro_kmeans_assign(const void* w, const void* codebook,
                                   void* assign, void* part_sums,
                                   void* part_counts, void* sums,
                                   void* counts, int G, long long P, int K,
                                   int threads, int nblk, void* stream) {
  if (G == 0) return 0;
  const long long chunk = static_cast<long long>(threads) * kItems;
  if (G < 0 || G > 65535 || P <= 0 || K < 1 || K > kMaxK ||
      (threads != 32 && threads != 64 && threads != 128 && threads != 256) ||
      nblk != (P + chunk - 1) / chunk)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = assign_smem_bytes(K, threads);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  assign_kernel<<<dim3(nblk, G), threads, smem, s>>>(
      static_cast<const float*>(w), static_cast<const float*>(codebook),
      static_cast<int32_t*>(assign), static_cast<double*>(part_sums),
      static_cast<int32_t*>(part_counts), P, K, nblk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  finish_kernel<<<dim3(K, G), kFinishThreads, 0, s>>>(
      static_cast<const double*>(part_sums),
      static_cast<const int32_t*>(part_counts), static_cast<float*>(sums),
      static_cast<float*>(counts), nblk);
  return static_cast<int>(cudaGetLastError());
}
