// Hopper (sm_90a) kernels for the batched lasso forward-backward / FISTA step.
//
// Replaces the Pallas TPU kernels of proxtpu/kernels/lasso.py:
//   fista_step  <- _fista_full_step_kernel (lasso.py:156, via fused_fista_full_step)
//                  and _fista_packed_step_kernel (lasso.py:1238, via
//                  fused_fista_packed_step): the packed kernel computes the
//                  same per-problem math in a layout that only strips the
//                  TPU's 128-lane padding; a 400-float row has none here.
//   fb_step     <- _fb_step_kernel (lasso.py:37, via fused_fb_prox_grad)
//   fista_k_steps <- _fb_k_steps_kernel (lasso.py:768, via fused_fista_k_steps)
//
// Per lane i (one CTA each), with A_i (M, N) row-major f32:
//   r = A x - b;  g = A^T r;  y = x - gamma g;  z = sign(y) max(|y| - thr, 0)
//   [z = z / shrink]   (divide, not multiply by the reciprocal: bit-faithful
//                       to ElasticNet.prox)
//   res = max |x - z|,  rs = sum (x - z)(z - z_prev)
//   fista_step only: beta = 0 if RESTART and rs > 0;  x <- z + beta (z - z_prev);
//   z_prev <- z, both in place.  A frozen lane (done != 0) keeps x and z_prev
//   untouched (a select, not the TPU kernel's blend: equal for finite values,
//   and a frozen lane stays finite when x+ is not) and reports res = rs = 0.
//
// Bound: reading A from device memory.  fb_step and fista_step read A twice
// (pass 1 row-wise, pass 2 column-wise); one lane's A at the flagship shape
// (256, 200, 400) is 312.5 KiB, more than a block's 227 KB of shared memory,
// so it cannot be staged whole, and the second read is meant to hit the
// 50 MB L2 while the lane's slab is still resident.  Frozen lanes return
// before touching A, so a batch whose lanes converge reads less.  The tile
// pass of common.cuh, which fista_k_steps uses, would give both the single
// read.
//
// fista_k_steps runs K full iterations per lane in one launch: the FB step,
// with RESTART t <- 1 where rs > 0 (before the coefficient is drawn, as
// AdaptiveRestartSequence does), t' = (1 + sqrt(1 + 4 t^2)) / 2, beta =
// (t - 1) / t', x <- z + beta (z - z_prev), z_prev <- z; x, z_prev and t
// live in shared memory and registers across the K steps and go back to
// device memory (in place) once; res is the last step's.
//
// What bounds it: a lane of the blocked route holds at least 1 MB of A
// (2 MB at 512 x 1024), which fits neither a CTA's 227 KB of shared memory
// nor, for a batch of 64 (128 MB), the 50 MB L2; the card's whole shared
// memory is 132 x 227 KB = 30 MB.  So A cannot stay on chip across the K
// steps and the kernel is bound by streaming it from device memory once per
// inner step, not once per launch.  What the design does about it:
//   - a CTA owns a slab of rows of its lane and walks it in tiles of R full
//     rows through a ring of S stages in shared memory (common.cuh, the tile
//     pass).  One thread keeps the ring full with bulk copies that report to
//     mbarriers; every tile is used twice from shared memory, for
//     r = A x - b (a warp per row) and for g += A^T r (a thread per column),
//     so each inner step reads A from device memory once.  One block
//     barrier per tile orders the two passes and frees the previous tile's
//     stage for the next copy.  Where a lane does not start on 16 bytes or
//     N * 4 is no multiple of 16, all threads fill the stages with ordinary
//     loads; where not even three one-row stages fit (N above about 8000),
//     one block per lane reads the tiles in place, twice, and keeps z_prev
//     in device memory: the shared memory the kernel needed when it always
//     read A twice, so it takes rows as wide as it did then;
//   - where the batch leaves SMs idle, a lane is served by a thread-block
//     cluster of C CTAs, CTA c taking rows [c M / C, (c + 1) M / C).  Every
//     CTA keeps its own x, z_prev and t and does the N-wide prox, reductions
//     and extrapolation itself; only the partial g crosses between SMs:
//     each CTA leaves its partial in its own shared memory, one
//     cluster.sync(), and each adds all C partials through distributed
//     shared memory in the order c = 0 .. C - 1.  All CTAs hold the same
//     bits of g, so of every decision; rank 0 writes the results.  Two
//     buffers for the partials make it one cluster barrier per inner step.
//     No atomics: two calls give the same bits, and C = 1 sums in the order
//     of a plain loop over the lane's rows.
// C, R and S are chosen on the host (kernels/lasso.py: k_steps_plan): few
// tall tiles, since every tile costs a block barrier and the latency of one
// row's dot product.  On an NVIDIA H100 80GB HBM3 at 700 W, (64, 512, 1024),
// K = 8, C = 2, three stages of 16 rows: about 375 us a launch, 2.9 TB/s of
// A, where one CTA per lane reading A twice took about 860 us.
//
// Plain C interface for ctypes.  Every entry launches on the given stream,
// does not synchronise, and returns cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

using proxtpu::block_reduce;
using proxtpu::nanmax;
using proxtpu::prepare;
using proxtpu::rows_dot;

constexpr int kThreads = 256;
constexpr int kUnroll = 8;  // loads of A each thread keeps in flight
// fista_k_steps: 32 warps for pass 1, a column a thread at N = 1024
constexpr int kKThreads = 1024;

// The prox at one point: z from x_n and g_n = (A^T r)_n.
template <bool SHRINK>
__device__ __forceinline__ float prox_point(float xv, float g, float gamma,
                                            float thr, float shrink) {
  // explicit roundings: y = x - gamma * g as two ops, like the reference
  const float y = __fsub_rn(xv, __fmul_rn(gamma, g));
  const float a = fabsf(y) - thr;
  // max(a, 0) that keeps a NaN (fmaxf would drop it)
  const float mag = (a > 0.f || a != a) ? a : 0.f;
  float z = copysignf(mag, y);
  if (SHRINK) z = z / shrink;
  return z;
}

// Pass 2 and the prox for column n: g = (A^T r)_n, then z.  Threads take
// neighbouring columns, so each step of the m loop is a coalesced row read.
template <bool SHRINK>
__device__ __forceinline__ float prox_column(const float* __restrict__ Ai,
                                             const float* r, float xv, int n,
                                             int M, int N, float gamma,
                                             float thr, float shrink) {
  // kUnroll loads in flight, as in pass 1; the sum runs over m in order
  const float* col = Ai + n;
  float g = 0.f;
  int m = 0;
  for (; m + kUnroll <= M; m += kUnroll) {
    float a[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) a[j] = __ldg(col + (size_t)(m + j) * N);
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) g = fmaf(a[j], r[m + j], g);
  }
  for (; m < M; ++m) g = fmaf(__ldg(col + (size_t)m * N), r[m], g);
  return prox_point<SHRINK>(xv, g, gamma, thr, shrink);
}

template <bool RESTART, bool SHRINK>
__global__ void __launch_bounds__(kThreads)
fista_step_kernel(const float* __restrict__ A, const float* __restrict__ b,
                  float* __restrict__ x, float* __restrict__ zp,
                  const float* __restrict__ beta,
                  const float* __restrict__ gamma,
                  const float* __restrict__ thr,
                  const float* __restrict__ done,
                  const float* __restrict__ shrink, float* __restrict__ res,
                  float* __restrict__ rs, int M, int N) {
  extern __shared__ float smem[];
  float* xs = smem;      // N: x, then z (each column by its owning thread)
  float* r = smem + N;   // M
  __shared__ float scratch[2 * (kThreads / 32)];

  const int i = blockIdx.x;
  if (done[i] != 0.f) {  // frozen lane: carries untouched, read-outs 0
    if (threadIdx.x == 0) {
      res[i] = 0.f;
      rs[i] = 0.f;
    }
    return;
  }
  const float* Ai = A + (size_t)i * M * N;
  float* xi = x + (size_t)i * N;
  float* zpi = zp + (size_t)i * N;
  const float gi = gamma[i], ti = thr[i];
  const float si = SHRINK ? shrink[i] : 1.f;

  for (int n = threadIdx.x; n < N; n += kThreads) xs[n] = xi[n];
  __syncthreads();
  rows_dot<kThreads, true>(Ai, b + (size_t)i * M, xs, r, M, N);
  __syncthreads();

  float mx = 0.f, dot = 0.f;
  for (int n = threadIdx.x; n < N; n += kThreads) {
    const float xv = xs[n];
    const float z = prox_column<SHRINK>(Ai, r, xv, n, M, N, gi, ti, si);
    const float d = xv - z;
    mx = nanmax(mx, fabsf(d));
    dot = fmaf(d, z - zpi[n], dot);
    xs[n] = z;  // x[n] is no longer needed: only this thread reads column n
  }
  block_reduce<kThreads>(mx, dot, scratch);

  const float bi = (RESTART && dot > 0.f) ? 0.f : beta[i];
  for (int n = threadIdx.x; n < N; n += kThreads) {
    const float z = xs[n];
    xi[n] = __fadd_rn(z, __fmul_rn(bi, z - zpi[n]));
    zpi[n] = z;
  }
  if (threadIdx.x == 0) {
    res[i] = mx;
    rs[i] = dot;
  }
}

template <bool SHRINK>
__global__ void __launch_bounds__(kThreads)
fb_step_kernel(const float* __restrict__ A, const float* __restrict__ b,
               const float* __restrict__ x, const float* __restrict__ gamma,
               const float* __restrict__ thr,
               const float* __restrict__ shrink, float* __restrict__ z_out,
               float* __restrict__ res, int M, int N) {
  extern __shared__ float smem[];
  float* xs = smem;
  float* r = smem + N;
  __shared__ float scratch[2 * (kThreads / 32)];

  const int i = blockIdx.x;
  const float* Ai = A + (size_t)i * M * N;
  const float* xi = x + (size_t)i * N;
  float* zi = z_out + (size_t)i * N;
  const float gi = gamma[i], ti = thr[i];
  const float si = SHRINK ? shrink[i] : 1.f;

  for (int n = threadIdx.x; n < N; n += kThreads) xs[n] = xi[n];
  __syncthreads();
  rows_dot<kThreads, true>(Ai, b + (size_t)i * M, xs, r, M, N);
  __syncthreads();

  float mx = 0.f, unused = 0.f;
  for (int n = threadIdx.x; n < N; n += kThreads) {
    const float xv = xs[n];
    const float z = prox_column<SHRINK>(Ai, r, xv, n, M, N, gi, ti, si);
    mx = nanmax(mx, fabsf(xv - z));
    zi[n] = z;
  }
  block_reduce<kThreads>(mx, unused, scratch);
  if (threadIdx.x == 0) res[i] = mx;
}

// How the tiles of fista_k_steps reach the two passes.
enum Fill { kFillBulk = 0, kFillLoads = 1, kFillNone = 2 };

__host__ __device__ inline size_t round_up(size_t v, size_t to) {
  return (v + to - 1) / to * to;
}

// Dynamic shared memory of fista_k_steps, in bytes from its start.  With a
// ring (S > 0): x, z_prev and two partial g of Np = N rounded up to 4 floats
// each, r for the longest slab (rounded up to 4), then on 128 bytes S stages
// of R rows (each rounded up to 128 bytes) and S mbarriers.  With the tiles
// read in place (S = 0, one block per lane): x, one g and r, and z_prev
// stays in device memory: 2 N + M floats, so the widest row that fits is
// the widest of a kernel that keeps no tile at all.  kernels/lasso.py
// (k_steps_shared_bytes) computes the same total.
struct KStepsLayout {
  int Np;
  size_t r, stage0, stage_bytes, bars, total;
  __host__ __device__ KStepsLayout(int M, int N, int C, int R, int S) {
    Np = (int)round_up(N, 4);
    const size_t rp = round_up((size_t)(M + C - 1) / C, 4);
    r = (S ? 4 : 2) * (size_t)Np * sizeof(float);
    const size_t fixed = r + rp * sizeof(float);
    stage0 = round_up(fixed, 128);
    stage_bytes = round_up((size_t)R * N * sizeof(float), 128);
    bars = stage0 + S * stage_bytes;
    total = S ? bars + S * sizeof(uint64_t) : fixed;
  }
};

template <bool RESTART, int FILL>
__global__ void __launch_bounds__(kKThreads, 1)
fista_k_steps_kernel(const float* __restrict__ A, const float* __restrict__ b,
                     float* __restrict__ x, float* __restrict__ zp,
                     float* __restrict__ t, const float* __restrict__ gamma,
                     const float* __restrict__ thr,
                     const float* __restrict__ done, float* __restrict__ res,
                     int M, int N, int K, int R, int S) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ float scratch[2 * (kKThreads / 32)];

  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int i = blockIdx.x / C;
  // frozen lane: x, z_prev, t untouched, res 0.  The test is the same in
  // every CTA of the lane's cluster, so all return before any barrier.
  if (done[i] != 0.f) {
    if (rank == 0 && threadIdx.x == 0) res[i] = 0.f;
    return;
  }

  const KStepsLayout lay(M, N, C, R, S);
  const int Np = lay.Np;
  float* xi = x + (size_t)i * N;
  float* zpi = zp + (size_t)i * N;
  float* xs = reinterpret_cast<float*>(smem_raw);  // x, then z within a step
  // z_prev; this CTA's partial g, one buffer per step parity; the slab's r
  float* zs = FILL == kFillNone ? zpi : xs + Np;
  float* gp = FILL == kFillNone ? xs + Np : xs + 2 * Np;
  float* r = reinterpret_cast<float*>(smem_raw + lay.r);
  float* stages = reinterpret_cast<float*>(smem_raw + lay.stage0);
  const size_t stage_floats = lay.stage_bytes / sizeof(float);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem_raw + lay.bars);

  // this CTA's slab of rows and its tiles of R rows (the last may be short)
  const int m_lo = (int)((long long)rank * M / C);
  const int rows = (int)((long long)(rank + 1) * M / C) - m_lo;
  const int ntiles = (rows + R - 1) / R;
  const int total = K * ntiles;  // tiles this CTA consumes, in order
  const float* Aslab = A + ((size_t)i * M + m_lo) * N;
  const float* bslab = b + (size_t)i * M + m_lo;
  const float gi = gamma[i], thri = thr[i];
  float ti = t[i];

  for (int n = threadIdx.x; n < N; n += kKThreads) {
    xs[n] = xi[n];
    if (FILL != kFillNone) zs[n] = zpi[n];
  }
  if (FILL == kFillBulk && threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) proxtpu::mbarrier_init(&bars[s], 1);
    proxtpu::mbarrier_init_fence();
  }
  __syncthreads();

  // The ring.  Tile number q of `total` is tile q % ntiles of the slab and
  // goes through stage q % S; its barrier completes phase q / S.  A stage is
  // refilled once every thread has finished both passes on the tile in it,
  // which a block barrier after the tile's pass 2 shows: `refill(released)`
  // is called right after such a barrier with the number of tiles released
  // so far, and starts every fill the ring has room for.
  int fq = 0, fj = 0, fs = 0;  // next tile to fill: number, tile, stage
  auto refill = [&](int released) {
    while (fq < total && fq < released + S) {
      const float* src = Aslab + (size_t)fj * R * N;
      const int count = min(R, rows - fj * R) * N;
      float* stage = stages + fs * stage_floats;
      if (FILL == kFillBulk) {
        // by the last warp, which has no row of a short tile in pass 1
        if (threadIdx.x == kKThreads - 32)
          proxtpu::fill_stage_bulk(stage, src,
                                   (uint32_t)count * sizeof(float),
                                   &bars[fs]);
      } else {
        proxtpu::fill_stage_loads<kKThreads>(stage, src, count);
      }
      ++fq;
      if (++fj == ntiles) fj = 0;
      if (++fs == S) fs = 0;
    }
  };
  if (FILL != kFillNone) {
    refill(0);
    // ordinary stores into the first stages are read after this barrier;
    // later fills are at least one tile's barrier ahead of their use
    // (S >= 3)
    if (FILL == kFillLoads) __syncthreads();
  }

  int q = 0, cs = 0;     // tiles consumed; the stage of tile q
  uint32_t parity = 0;   // the phase tile q's barrier completes, mod 2
  float mx = 0.f;
  for (int step = 0; step < K; ++step) {
    float* g = FILL == kFillNone ? gp : gp + (step & 1) * Np;
    for (int j = 0; j < ntiles; ++j) {
      const int tile_rows = min(R, rows - j * R);
      const float* tile;
      if (FILL == kFillNone) {
        tile = Aslab + (size_t)j * R * N;
      } else {
        tile = stages + cs * stage_floats;
        if (FILL == kFillBulk) proxtpu::mbarrier_wait(&bars[cs], parity);
      }
      proxtpu::tile_rows_dot<kKThreads>(tile, bslab + j * R, xs, r + j * R,
                                        tile_rows, N);
      // r of this tile complete; every thread is past pass 2 of the tile
      // before, whose stage is free
      __syncthreads();
      if (FILL != kFillNone) refill(q);
      proxtpu::tile_cols_fma<kKThreads>(tile, r + j * R, g, tile_rows, N,
                                        j == 0);
      ++q;
      if (++cs == S) {
        cs = 0;
        parity ^= 1;
      }
    }
    // this CTA's partial g complete, and visible to the cluster
    if (C > 1)
      cluster.sync();
    else
      __syncthreads();
    if (FILL != kFillNone) refill(q);

    float dot = 0.f;
    mx = 0.f;
    // a thread owns the same columns in every loop below
    for (int n = threadIdx.x; n < N; n += kKThreads) {
      float gn;
      if (C == 1) {
        gn = g[n];
      } else {
        // the partials in the order c = 0 .. C - 1, in every CTA
        gn = cluster.map_shared_rank(g, 0)[n];
        for (int c = 1; c < C; ++c)
          gn = __fadd_rn(gn, cluster.map_shared_rank(g, c)[n]);
      }
      const float xv = xs[n];
      const float z = prox_point<false>(xv, gn, gi, thri, 1.f);
      const float d = xv - z;
      mx = nanmax(mx, fabsf(d));
      if (RESTART) dot = fmaf(d, z - zs[n], dot);
      xs[n] = z;
    }
    block_reduce<kKThreads>(mx, dot, scratch);

    // the t-recursion, each operation rounded as the plain version rounds
    // it (no contraction into fma)
    const float tk = (RESTART && dot > 0.f) ? 1.f : ti;
    const float t_new = __fdiv_rn(
        __fadd_rn(1.f, __fsqrt_rn(__fadd_rn(
                           1.f, __fmul_rn(__fmul_rn(4.f, tk), tk)))),
        2.f);
    const float beta = __fdiv_rn(__fsub_rn(tk, 1.f), t_new);
    for (int n = threadIdx.x; n < N; n += kKThreads) {
      const float z = xs[n];
      xs[n] = __fadd_rn(z, __fmul_rn(beta, __fsub_rn(z, zs[n])));
      zs[n] = z;
    }
    ti = t_new;
    __syncthreads();  // x complete before the next step reads it
  }

  if (rank == 0) {
    for (int n = threadIdx.x; n < N; n += kKThreads) {
      xi[n] = xs[n];
      if (FILL != kFillNone) zpi[n] = zs[n];
    }
    if (threadIdx.x == 0) {
      t[i] = ti;
      res[i] = mx;
    }
  }
  // no CTA leaves while another may still read its partial g
  if (C > 1) cluster.sync();
}

}  // namespace

extern "C" {

int proxtpu_fista_step(const float* A, const float* b, float* x, float* zp,
                       const float* beta, const float* gamma,
                       const float* thr, const float* done,
                       const float* shrink, float* res, float* rs, int B,
                       int M, int N, int restart, void* stream) {
  const size_t smem = (size_t)(N + M) * sizeof(float);
  auto kernel = restart ? (shrink ? fista_step_kernel<true, true>
                                  : fista_step_kernel<true, false>)
                        : (shrink ? fista_step_kernel<false, true>
                                  : fista_step_kernel<false, false>);
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      A, b, x, zp, beta, gamma, thr, done, shrink, res, rs, M, N);
  return (int)cudaGetLastError();
}

// C CTAs per lane as one cluster, tiles of R rows through S stages (S = 0:
// tiles read in place, C = 1), `smem_bytes` of dynamic shared memory: the
// plan of kernels/lasso.py, checked here against the kernel's own layout
// (a bulk copy moves less than 1 MB, its barrier's limit).  Returns
// cudaErrorInvalidValue for a plan the kernel does not take and
// cudaErrorLaunchOutOfResources where the device cannot hold one cluster of
// C such CTAs; never launches another plan than the one it was given.
int proxtpu_fista_k_steps(const float* A, const float* b, float* x,
                          float* zp, float* t, const float* gamma,
                          const float* thr, const float* done, float* res,
                          int B, int M, int N, int K, int restart, int C,
                          int R, int S, int smem_bytes, void* stream) {
  const bool sizes_ok = (C == 1 || C == 2 || C == 4 || C == 8) && M >= C &&
                        R >= 1 && (S >= 3 || (S == 0 && C == 1)) &&
                        (size_t)R * N * sizeof(float) < (1u << 20);
  if (!sizes_ok) return (int)cudaErrorInvalidValue;
  const KStepsLayout lay(M, N, C, R, S);
  if (lay.total != (size_t)smem_bytes) return (int)cudaErrorInvalidValue;
  const bool aligned =
      N % 4 == 0 && reinterpret_cast<uintptr_t>(A) % 16 == 0;
  const int fill = S == 0 ? kFillNone : aligned ? kFillBulk : kFillLoads;
  using Kernel = void (*)(const float*, const float*, float*, float*, float*,
                          const float*, const float*, const float*, float*,
                          int, int, int, int, int);
  static const Kernel kernels[2][3] = {
      {fista_k_steps_kernel<false, kFillBulk>,
       fista_k_steps_kernel<false, kFillLoads>,
       fista_k_steps_kernel<false, kFillNone>},
      {fista_k_steps_kernel<true, kFillBulk>,
       fista_k_steps_kernel<true, kFillLoads>,
       fista_k_steps_kernel<true, kFillNone>}};
  Kernel kernel = kernels[restart ? 1 : 0][fill];
  cudaError_t err = prepare(kernel, lay.total);
  if (err != cudaSuccess) return (int)err;

  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((unsigned int)B * C);
  config.blockDim = dim3(kKThreads);
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
  err = cudaLaunchKernelEx(&config, kernel, A, b, x, zp, t, gamma, thr, done,
                           res, M, N, K, R, S);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

int proxtpu_fb_step(const float* A, const float* b, const float* x,
                    const float* gamma, const float* thr, const float* shrink,
                    float* z, float* res, int B, int M, int N, void* stream) {
  const size_t smem = (size_t)(N + M) * sizeof(float);
  auto kernel = shrink ? fb_step_kernel<true> : fb_step_kernel<false>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(A, b, x, gamma, thr,
                                                      shrink, z, res, M, N);
  return (int)cudaGetLastError();
}

// Largest dynamic shared memory a block of this device may opt in to.
int proxtpu_max_smem_optin(int device, int* out) {
  return (int)cudaDeviceGetAttribute(
      out, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
}

const char* proxtpu_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
