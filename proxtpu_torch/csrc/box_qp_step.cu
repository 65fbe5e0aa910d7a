// Hopper (sm_90a) kernel for the batched box-QP projected-gradient step.
//
// Replaces the Pallas TPU kernels of proxtpu/kernels/box_qp.py:
//   pg_step    <- _pg_step_kernel (box_qp.py:31, via fused_pg_box_step):
//                 pg_k_steps at K = 1
//   pg_k_steps <- _pg_k_steps_kernel (box_qp.py:174, via fused_pg_box_k_steps)
//
// Per lane i, with Q_i (n, n) symmetric row-major f32:
//   g = Q x + q;  y = x - gamma g (two roundings, as the plain version);
//   z = clip(y, lo, hi) (keeping a NaN);  res = max |x - z|;  x <- z in place.
// K such steps per launch with x in shared memory, written back once; res is
// the last step's.  A frozen lane (done given and done != 0) returns before
// reading Q, keeps x and reports res = 0.
//
// The TPU reduced Q * x_col over sublanes, which for symmetric Q yields the
// gradient in the row orientation its update needed; its K-step kernel
// carried x as a row and as a column and did the matvec twice to avoid a
// relayout.  Here a warp reads row m of Q and sums Q[m, :] x = (Q x)[m]: one
// orientation, one matvec per step.
//
// What bounds it: reading Q from device memory, n^2 * 4 bytes per lane per
// step (1 MB at n = 512).  The TPU's blocked kernel kept Q in VMEM for its K
// steps; a CTA's 227 KB of shared memory cannot hold 1 MB, and at B = 64
// (64 MB) Q exceeds the 50 MB L2, so the kernel streams Q once per inner
// step.  The design is fista_k_steps' (lasso_step.cu) with pass 1 alone:
//   - a lane is served by a thread-block cluster of C CTAs where the batch
//     leaves SMs idle, CTA c owning the rows [c n / C, (c + 1) n / C);
//   - a CTA walks its slab of rows in tiles of R full rows through a ring of
//     S stages in shared memory (common.cuh, TileRing::sweep_rows), filled by
//     bulk copies that report to mbarriers and kept full across the K steps;
//     where a lane does not start on 16 bytes or n * 4 is no multiple of 16,
//     all threads fill the stages with ordinary loads; where not even three
//     one-row stages fit, one CTA per lane reads the tiles in place;
//   - each CTA computes z on its own rows into one of two x buffers (by step
//     parity), one cluster barrier, then copies the other CTAs' rows of z
//     from their shared memory (distributed shared memory) into its own
//     buffer: one cluster barrier a step.  res is the block's max, then rank
//     0's max over the cluster, on the last step only.
// g[m] is one warp's dot of row m (a lane striding the row by 32 in one fmaf
// chain, then the warp's xor tree) whatever C, R and S, so every bit of x and
// res is that of one CTA per lane reading Q row by row.
// C, R and S are chosen on the host (kernels/box_qp.py: pg_plan).  On an
// NVIDIA H100 80GB HBM3 at 700 W, (64, 512), K = 8, C = 2, three stages of
// 32 rows: about 184 us a launch, 1.15x Q streamed once per step at 3.35
// TB/s, where one CTA per lane reading Q by ordinary loads took 212.
//
// Plain C interface for ctypes.  The entry launches on the given stream,
// does not synchronise, and returns cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

using proxtpu::block_reduce;
using proxtpu::kFillBulk;
using proxtpu::kFillLoads;
using proxtpu::kFillNone;
using proxtpu::nanclip;
using proxtpu::nanmax;
using proxtpu::prepare;
using proxtpu::round_up;
using proxtpu::TileRing;

constexpr int kThreads = 1024;

// Dynamic shared memory of pg_k_steps, in bytes from its start.  With a ring
// (S > 0): two buffers of x of Np = N rounded up to 4 floats, g for the
// longest slab of M / C rows (rounded up to 4), then on 128 bytes S stages
// of R rows (each rounded up to 128 bytes) and S mbarriers.  With the tiles
// read in place (S = 0, one CTA per lane): x and g, N + M floats, the shared
// memory of a kernel that keeps no tile.  kernels/box_qp.py
// (pg_shared_bytes) computes the same total.
struct PgLayout {
  int Np;
  size_t g, stage0, stage_bytes, bars, total;
  __host__ __device__ PgLayout(int M, int N, int C, int R, int S) {
    Np = S ? (int)round_up(N, 4) : N;
    g = (S ? 2 : 1) * (size_t)Np * sizeof(float);
    const size_t fixed =
        g + (S ? round_up((size_t)(M + C - 1) / C, 4) : M) * sizeof(float);
    stage0 = round_up(fixed, 128);
    stage_bytes = round_up((size_t)R * N * sizeof(float), 128);
    bars = stage0 + S * stage_bytes;
    total = S ? bars + S * sizeof(uint64_t) : fixed;
  }
};

template <int FILL>
__global__ void __launch_bounds__(kThreads, 1)
pg_k_steps_kernel(const float* __restrict__ Q, const float* __restrict__ q,
                  float* __restrict__ x, const float* __restrict__ gamma,
                  const float* __restrict__ lo, const float* __restrict__ hi,
                  const float* __restrict__ done, float* __restrict__ res,
                  int n, int K, int R, int S) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ float scratch[2 * (kThreads / 32)];
  __shared__ float block_max;  // the last step's, for rank 0

  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int i = blockIdx.x / C;
  // frozen lane: x untouched, res 0.  The test is the same in every CTA of
  // the lane's cluster, so all return before any barrier.
  if (done != nullptr && done[i] != 0.f) {
    if (rank == 0 && threadIdx.x == 0) res[i] = 0.f;
    return;
  }

  const PgLayout lay(n, n, C, R, S);
  float* xb = reinterpret_cast<float*>(smem_raw);  // x, by step parity
  float* g = reinterpret_cast<float*>(smem_raw + lay.g);
  float* xi = x + (size_t)i * n;
  // this CTA's slab of rows
  const int m_lo = (int)((long long)rank * n / C);
  const int rows = (int)((long long)(rank + 1) * n / C) - m_lo;
  const float gi = gamma[i], loi = lo[i], hii = hi[i];

  for (int j = threadIdx.x; j < n; j += kThreads) xb[j] = xi[j];
  // the slab's tiles go K times through the ring (common.cuh)
  TileRing<kThreads, FILL> ring(
      reinterpret_cast<float*>(smem_raw + lay.stage0),
      lay.stage_bytes / sizeof(float),
      reinterpret_cast<uint64_t*>(smem_raw + lay.bars),
      Q + ((size_t)i * n + m_lo) * n, rows, n, R, S, K);
  ring.init_barriers();
  __syncthreads();
  ring.prime();

  const float* qslab = q + (size_t)i * n + m_lo;
  float mx = 0.f;
  for (int step = 0; step < K; ++step) {
    const bool last = step == K - 1;
    // x of this step, and the buffer z goes to (the same without a ring,
    // where C == 1 and every read of x is done when z is written)
    float* xc = S ? xb + (step & 1) * lay.Np : xb;
    float* xn = S ? xb + ((step + 1) & 1) * lay.Np : xb;
    ring.sweep_rows(qslab, xc, g);  // g = Q x + q on the slab
    mx = 0.f;
    for (int m = threadIdx.x; m < rows; m += kThreads) {
      const float xv = xc[m_lo + m];
      const float z = nanclip(__fsub_rn(xv, __fmul_rn(gi, g[m])), loi, hii);
      mx = nanmax(mx, fabsf(xv - z));
      xn[m_lo + m] = z;
    }
    if (last) {
      float unused = 0.f;
      block_reduce<kThreads>(mx, unused, scratch);
      if (threadIdx.x == 0) block_max = mx;
    }
    if (C == 1) {
      __syncthreads();  // z complete before the next sweep reads it
      continue;
    }
    // every CTA's rows of z complete, and visible to the cluster
    cluster.sync();
    if (last) break;
    // the other CTAs' rows of z, into this CTA's buffer
    for (int c = 0; c < C; ++c) {
      if (c == rank) continue;
      const int lo_c = (int)((long long)c * n / C);
      const int hi_c = (int)((long long)(c + 1) * n / C);
      const float* other = cluster.map_shared_rank(xn, c);
      for (int j = lo_c + threadIdx.x; j < hi_c; j += kThreads)
        xn[j] = other[j];
    }
    __syncthreads();  // x complete before the next sweep reads it
  }

  // this CTA's rows of x, and rank 0 the lane's res
  const float* xf = S ? xb + (K & 1) * lay.Np : xb;
  for (int m = threadIdx.x; m < rows; m += kThreads)
    xi[m_lo + m] = xf[m_lo + m];
  if (rank == 0 && threadIdx.x == 0) {
    float r = block_max;
    for (int c = 1; c < C; ++c)
      r = nanmax(r, *cluster.map_shared_rank(&block_max, c));
    res[i] = r;
  }
  // no CTA leaves while rank 0 may still read its max
  if (C > 1) cluster.sync();
}

}  // namespace

extern "C" {

// K steps for B lanes of n at C CTAs per lane as one cluster (1, 2, 4 or 8),
// tiles of R rows through S stages (S = 0: tiles read in place, C = 1),
// `smem_bytes` of dynamic shared memory: the plan of kernels/box_qp.py,
// checked here against the kernel's own layout (a bulk copy moves less than
// 1 MB, its barrier's limit).  done may be NULL (no lane frozen).  Returns
// cudaErrorInvalidValue for a plan the kernel does not take and
// cudaErrorLaunchOutOfResources where the device cannot hold one cluster of
// C such CTAs; never launches another plan than the one it was given.
int proxtpu_pg_k_steps(const float* Q, const float* q, float* x,
                       const float* gamma, const float* lo, const float* hi,
                       const float* done, float* res, int B, int n, int K,
                       int C, int R, int S, int smem_bytes, void* stream) {
  const bool sizes_ok = (C == 1 || C == 2 || C == 4 || C == 8) && n >= C &&
                        K >= 1 && R >= 1 && (S >= 3 || (S == 0 && C == 1)) &&
                        (size_t)R * n * sizeof(float) < (1u << 20);
  if (!sizes_ok) return (int)cudaErrorInvalidValue;
  const PgLayout lay(n, n, C, R, S);
  if (lay.total != (size_t)smem_bytes) return (int)cudaErrorInvalidValue;
  const bool aligned =
      n % 4 == 0 && reinterpret_cast<uintptr_t>(Q) % 16 == 0;
  const int fill = S == 0 ? kFillNone : aligned ? kFillBulk : kFillLoads;
  using Kernel = void (*)(const float*, const float*, float*, const float*,
                          const float*, const float*, const float*, float*,
                          int, int, int, int);
  static const Kernel kernels[3] = {pg_k_steps_kernel<kFillBulk>,
                                    pg_k_steps_kernel<kFillLoads>,
                                    pg_k_steps_kernel<kFillNone>};
  Kernel kernel = kernels[fill];
  cudaError_t err = prepare(kernel, lay.total);
  if (err != cudaSuccess) return (int)err;

  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((unsigned int)B * C);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = lay.total;
  config.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  if (C > 1) {
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &config);
    if (err != cudaSuccess) return (int)err;
    if (clusters < 1) return (int)cudaErrorLaunchOutOfResources;
  }
  err = cudaLaunchKernelEx(&config, kernel, Q, q, x, gamma, lo, hi, done, res,
                           n, K, R, S);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
