// Absorbed-MLA paged decode attention over dense latent pages.
//
// Replaces: src/repro/kernels/paged_attention.py:mla_paged_attention_pallas.
// Computes: for engine slot b and head h, over the slot's latent rows t <=
//   pos[b] (row t on physical page table[b, t / page], offset t % page):
//     s_t = (q_eff[b,h] . c_t + q_rope[b,h] . r_t) * scale,
//     out[b,h] = sum_t softmax(s)_t * c_t,
//   with q_eff [B, H, L], q_rope [B, H, R] f32, c_pool [P+1, page, L] and
//   r_pool [P+1, page, R] f32, table [B, npg], pos [B], alive [B] int32, out
//   [B, H, L] f32.  The latent row c_t is both key and value.  A dead slot
//   reads nothing and gets 0 (the Pallas kernel's rule).
// Bound on H100: bytes.  A slot reads its (pos + 1) visible latent rows once,
//   (pos + 1) * (L + R) * 4 bytes; the operations, 2 * H * (pos + 1) *
//   (2L + R) f32 FMAs, sit below the byte time at 16 heads.
// Design: every head shares the slot's latent rows, so one block per slot
//   walks the slot's pages through the page table and stages each tile of up
//   to 16 visible rows once for all heads, as [c | r] rows of L + R floats
//   (16-byte loads where the widths allow).  The queries are staged the same
//   way, [q_eff | q_rope], so one dot product of width L + R gives a score,
//   and the context accumulates from the same staged c columns, in registers
//   across tiles (mla_attention.cuh; the softmax statistics are
//   online_softmax.cuh's).  Rows past pos are never staged.  Shared memory
//   passes 48 KB at L = 512 (about 74 KB at H = 16): the launch opts in.  At
//   4 slots only 4 of the card's 132 SMs work; a split over pages with an
//   ordered merge is later work.  Physical ids outside [0, P] are clamped.
#include "mla_attention.cuh"
#include "unpack.cuh"

namespace {

namespace mla = repro::mla;

__global__ void __launch_bounds__(mla::kThreads)
mla_paged_attention_kernel(const float* __restrict__ q_eff,
                           const float* __restrict__ q_rope,
                           const float* __restrict__ c_pool,
                           const float* __restrict__ r_pool,
                           const int32_t* __restrict__ table,
                           const int32_t* __restrict__ pos,
                           const int32_t* __restrict__ alive,
                           float* __restrict__ out, int H, int L, int R,
                           int page, int npg, int n_phys, float scale,
                           bool vec4) {
  extern __shared__ float smem[];
  const mla::Geometry g = mla::geometry(H, L, R, 0);
  const int D = L + R;
  float* Qs = smem + g.q;
  float* KVs = smem + g.kv;
  float* P = smem + g.p;
  float* Ms = smem + g.m;
  float* Ls = smem + g.l;
  float* Corr = smem + g.corr;
  const int b = blockIdx.x;
  mla::stage_queries(q_eff, q_rope, Qs, Ms, Ls, b, H, L, R);
  float acc[mla::kMaxHeads][mla::kMaxCols] = {};

  const int p_b = pos[b];
  int n_pages = 0;
  if (alive[b] != 0 && p_b >= 0) n_pages = min(npg, p_b / page + 1);

  for (int j = 0; j < n_pages; ++j) {
    int phys = table[static_cast<int64_t>(b) * npg + j];
    phys = phys < 0 ? 0 : (phys >= n_phys ? n_phys - 1 : phys);
    const int n_valid = min(page, p_b - j * page + 1);   // >= 1
    for (int t0 = 0; t0 < n_valid; t0 += mla::kTile) {
      const int T = min(mla::kTile, n_valid - t0);
      const int64_t row0 = static_cast<int64_t>(phys) * page + t0;
      __syncthreads();   // previous tile consumed (and setup visible)
      if (vec4) {        // L, R multiples of 4, 16-byte aligned pools
        const int L4 = L / 4, D4 = D / 4;
        const float4* c4 = reinterpret_cast<const float4*>(c_pool + row0 * L);
        const float4* r4 = reinterpret_cast<const float4*>(r_pool + row0 * R);
        float4* kv4 = reinterpret_cast<float4*>(KVs);
#pragma unroll 4
        for (int idx = threadIdx.x; idx < T * D4; idx += mla::kThreads) {
          const int t = idx / D4, d = idx % D4;
          kv4[idx] = d < L4 ? c4[t * L4 + d] : r4[t * (D4 - L4) + d - L4];
        }
      } else {
        for (int idx = threadIdx.x; idx < T * D; idx += mla::kThreads) {
          const int t = idx / D, d = idx % D;
          KVs[idx] = d < L ? c_pool[(row0 + t) * L + d]
                           : r_pool[(row0 + t) * R + d - L];
        }
      }
      __syncthreads();
      mla::attend_tile(Qs, KVs, P, Ms, Ls, Corr, acc, H, T, L, D, scale);
    }
  }
  __syncthreads();
  mla::store(out, acc, Ls, b, H, L);
}

}  // namespace

REPRO_EXPORT_ERROR_STRING

// q_eff [B, H, L], q_rope [B, H, R] f32; c_pool [n_phys, page, L], r_pool
// [n_phys, page, R] f32; table [B, npg], pos [B], alive [B] int32; out
// [B, H, L] f32.  H <= 16 and L <= 512.
extern "C" int repro_mla_paged_attention(
    const void* q_eff, const void* q_rope, const void* c_pool,
    const void* r_pool, const void* table, const void* pos,
    const void* alive, void* out, int B, int H, int L, int R, int page,
    int npg, int n_phys, float scale, void* stream) {
  if (B == 0 || H == 0 || L == 0) return 0;
  if (page <= 0 || npg <= 0 || n_phys <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  size_t bytes = 0;
  const int err = mla::prepare(mla_paged_attention_kernel, H, L, R, 0,
                               &bytes);
  if (err != 0) return err;
  const bool vec4 = L % 4 == 0 && R % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(c_pool) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(r_pool) % 16 == 0;
  mla_paged_attention_kernel<<<B, mla::kThreads, bytes,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q_eff), static_cast<const float*>(q_rope),
      static_cast<const float*>(c_pool), static_cast<const float*>(r_pool),
      static_cast<const int32_t*>(table), static_cast<const int32_t*>(pos),
      static_cast<const int32_t*>(alive), static_cast<float*>(out), H, L, R,
      page, npg, n_phys, scale, vec4);
  return static_cast<int>(cudaGetLastError());
}
