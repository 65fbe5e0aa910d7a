// Hopper (sm_90a) kernels for the batched lasso forward-backward / FISTA step.
//
// Replaces the Pallas TPU kernels of proxtpu/kernels/lasso.py:
//   fista_step  <- _fista_full_step_kernel (lasso.py:156, via fused_fista_full_step)
//                  (its body, fista_step_lane in lasso_step.cuh, also runs
//                  on the lane-packed layout: fista_packed_step.cu)
//   fb_step     <- _fb_step_kernel (lasso.py:37, via fused_fb_prox_grad)
//   fista_k_steps <- _fb_k_steps_kernel (lasso.py:768, via fused_fista_k_steps)
//
// Per lane i (one CTA each), with A_i (M, N) row-major f32 (fb_step and
// fista_step also take A in bfloat16, below):
//   r = A x - b;  g = A^T r;  y = x - gamma g;  z = sign(y) max(|y| - thr, 0)
//   [z = z / shrink]   (divide, not multiply by the reciprocal: bit-faithful
//                       to ElasticNet.prox)
//   res = max |x - z|,  rs = sum (x - z)(z - z_prev)
//   fista_step only: beta = 0 if RESTART and rs > 0;  x <- z + beta (z - z_prev);
//   z_prev <- z, both in place.  A frozen lane (done != 0) keeps x and z_prev
//   untouched (a select, not the TPU kernel's blend: equal for finite values,
//   and a frozen lane stays finite when x+ is not) and reports res = rs = 0.
//
// Bound: reading A from device memory, once.  All three kernels walk a lane's
// rows through the tile pass of common.cuh (TileRing): a ring of row tiles in
// shared memory, filled by bulk copies that report to mbarriers, each tile
// used for r = A x - b (a warp per row) and, from shared memory again, for
// g += A^T r (a thread per column), so that A crosses the memory system once
// per step.  One lane's A at the flagship shape (256, 200, 400) is 312.5 KiB,
// more than a block's 227 KB of shared memory, so it cannot be staged whole,
// and 256 such lanes (80 MB) do not stay in the 50 MB L2 between two passes:
// a kernel that reads A row-wise and then column-wise reads it from device
// memory twice.  Frozen lanes return before touching A, so a batch whose
// lanes converge reads less.
//
// fb_step and fista_step: one block per lane, one sweep of the ring, then
// the N-wide epilogue.  The launch plan is chosen on the host
// (kernels/lasso.py: step_plan): 512 or 1024 threads from N (a thread per
// column in pass 2, a warp per row in pass 1), three stages whose size lets
// two blocks share an SM where the batch has more lanes than the card has
// SMs (each hides the other's barrier and mbarrier waits); one stage, no
// refill and 256 threads where a lane fits a quarter of an SM's shared
// memory; the lane read in place by 256 threads in (N + M) floats of shared
// memory where no ring fits (N above about 11000).  On an NVIDIA H100 80GB
// HBM3 at 700 W, (256, 200, 400), two blocks of 512 threads per SM, three
// stages of 16 rows: about 38 us a step, where a block of 256 threads
// reading A twice took about 100.
// Every sum keeps the order of a block of 256 threads that reads A twice:
// r by a lane striding the row by 32 in one fmaf chain and the warp's xor
// tree, g by one ascending fmaf chain per column, rs by thread t < 256
// chaining n = t, t + 256, ... and the two xor trees of block_reduce<256>,
// whatever the block's size; so the plan changes no bit of any result.
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
// fb_step and fista_step have a second instance for A stored in bfloat16
// (proxtpu_fb_step_bf16, proxtpu_fista_step_bf16): the Pallas kernels take
// a narrower A and cast it up in VMEM (lasso.py:59, :184), for the bf16
// warm stage of solve_lasso_batch_mixed.  The ring stages R rows of N * 2
// bytes, each entry is cast to float as a pass reads it (exact), and every
// sum keeps its order, so an instance returns the bits of the float32
// kernel run on A16.float().  What bounds it is not the bytes (256 lanes of
// 200 x 400 are 41 MB, 12.5 us at 3.35 TB/s, and mostly stay in the 50 MB
// L2 from one step to the next: the bf16 read floor is about 10 us) but
// each SM's work per entry.  Run on the float32 body, a bf16 entry costs
// what a float32 one does: in pass 1 a 2-byte shared load of A and a
// 4-byte load of x, in pass 2 a 2-byte load, each a warp instruction that
// moves half of what one can, plus a conversion; halving the bytes took
// 35.7 us to 28.8 and no further.  The bf16 instances have a body of their
// own (sweep_bf16 below, the bf16 passes of common.cuh):
//   - pass 1 keeps x in registers, lane l holding x[l + 32 k] (N <= 512,
//     at most 512 threads), so it loads only A;
//   - pass 2 gives a thread two adjacent columns: one 32-bit load a row
//     (a bf16 pair) feeds two chains (N even);
//   - x stays in shared memory through the step, and fista_step's
//     epilogue holds z_prev in registers, loaded before the sweep, so no
//     load of device memory follows the last tile;
//   - the plan (kernels/lasso.py: step_plan at elem = 2) takes the
//     tallest tiles that fit, spread evenly and rounded up to a multiple
//     of 4 (pass 2 reads r four at a time), not whole rounds of warps:
//     five tiles of 40 rows at 200 x 400 where the float32 rule gave seven
//     of 29.  The passes cost less a row, so the count of tiles, each a
//     block barrier and a row's latency, weighs more.
// Where N is odd, pass 2 takes one column a thread; where N > 512, pass 1
// reads x from shared memory; a lane read in place runs the float32 body.
// On an NVIDIA H100 80GB HBM3 at 700 W, (256, 200, 400), at the device's
// pace: fista_step about 20.6 us and fb_step about 21.0, where the float32
// body took 30.7 and 28.8.  The bulk copy needs N * 2 to be a multiple of
// 16 (N % 8 == 0, as at 400); other rows fill the ring by ordinary loads.
//
// Plain C interface for ctypes.  Every entry launches on the given stream,
// does not synchronise, and returns cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "lasso_step.cuh"

namespace cg = cooperative_groups;

namespace {

using proxtpu::block_reduce;
using proxtpu::FbStep;
using proxtpu::fista_step_lane;
using proxtpu::FistaStep;
using proxtpu::kFillBulk;
using proxtpu::kFillLoads;
using proxtpu::kFillNone;
using proxtpu::kOrderThreads;
using proxtpu::launch_step;
using proxtpu::nanmax;
using proxtpu::natural_rows;
using proxtpu::prepare;
using proxtpu::prepare_once;
using proxtpu::prox_point;
using proxtpu::round_up;
using proxtpu::step_blocks;
using proxtpu::step_fill;
using proxtpu::step_prox;
using proxtpu::threads_index;
using proxtpu::TileRing;
using proxtpu::Variant;
using Bf16 = __nv_bfloat16;

// fista_k_steps: 32 warps for pass 1, a column a thread at N = 1024
constexpr int kKThreads = 1024;

template <int THREADS, int FILL, typename T>
__global__ void __launch_bounds__(THREADS, step_blocks(THREADS))
fista_step_kernel(const T* __restrict__ A, const float* __restrict__ b,
                  float* x, float* zp, const float* __restrict__ beta,
                  const float* __restrict__ gamma,
                  const float* __restrict__ thr,
                  const float* __restrict__ done,
                  const float* __restrict__ shrink, float* __restrict__ res,
                  float* __restrict__ rs, int M, int N, int R, int S,
                  int restart) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ float scratch[2 * (kOrderThreads / 32)];

  const size_t i = blockIdx.x;
  fista_step_lane<THREADS, FILL, T>(
      smem_raw, scratch, A + i * M * N, natural_rows(N), b + i * M, 1,
      x + i * N, zp + i * N, beta, gamma, thr, done, shrink, res, rs, M, N,
      R, S, restart);
}

template <int THREADS, int FILL, typename T>
__global__ void __launch_bounds__(THREADS, step_blocks(THREADS))
fb_step_kernel(const T* __restrict__ A, const float* __restrict__ b,
               const float* __restrict__ x, const float* __restrict__ gamma,
               const float* __restrict__ thr,
               const float* __restrict__ shrink, float* __restrict__ z_out,
               float* __restrict__ res, int M, int N, int R, int S) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ float scratch[2 * (THREADS / 32)];

  const int i = blockIdx.x;
  float* zi = z_out + (size_t)i * N;
  float mx = 0.f, unused = 0.f;
  step_prox<THREADS, FILL, T>(smem_raw, A + (size_t)i * M * N,
                              natural_rows(N), b + (size_t)i * M, 1,
                              x + (size_t)i * N, M, N, R, S, gamma[i],
                              thr[i], shrink, i,
                              [&](int n, float xv, float z) {
                                mx = nanmax(mx, fabsf(xv - z));
                                zi[n] = z;
                              });
  block_reduce<THREADS>(mx, unused, scratch);
  if (threadIdx.x == 0) res[i] = mx;
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
  // this CTA's slab of rows and its tiles of R rows (the last may be short)
  const int m_lo = (int)((long long)rank * M / C);
  const int rows = (int)((long long)(rank + 1) * M / C) - m_lo;
  const float* bslab = b + (size_t)i * M + m_lo;
  const float gi = gamma[i], thri = thr[i];
  float ti = t[i];

  for (int n = threadIdx.x; n < N; n += kKThreads) {
    xs[n] = xi[n];
    if (FILL != kFillNone) zs[n] = zpi[n];
  }
  // the slab's tiles go K times through the ring (common.cuh)
  TileRing<kKThreads, FILL> ring(
      reinterpret_cast<float*>(smem_raw + lay.stage0),
      lay.stage_bytes / sizeof(float),
      reinterpret_cast<uint64_t*>(smem_raw + lay.bars),
      A + ((size_t)i * M + m_lo) * N, rows, N, R, S, K);
  ring.init_barriers();
  __syncthreads();
  ring.prime();

  float mx = 0.f;
  for (int step = 0; step < K; ++step) {
    float* g = FILL == kFillNone ? gp : gp + (step & 1) * Np;
    ring.sweep(bslab, xs, r, g);
    // this CTA's partial g complete, and visible to the cluster
    if (C > 1)
      cluster.sync();
    else
      __syncthreads();
    ring.refill(ring.q);

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

// The variants of the one-step kernels: float32 A in blocks of 256, 512
// and 1024 threads with a ring (bulk copy or ordinary loads), 256 threads on
// a lane in place; bf16 A in the same blocks with a ring (fista_step_bf16.cu,
// fb_step_bf16.cu: with x in registers or not, one or two columns a thread
// in pass 2), and 256 threads on a lane in place (the float32 body).
Variant<FistaStep<float>>* fista_step_variant(int threads, int fill) {
  static Variant<FistaStep<float>> table[3][3] = {
      {{fista_step_kernel<256, kFillBulk, float>},
       {fista_step_kernel<256, kFillLoads, float>},
       {fista_step_kernel<256, kFillNone, float>}},
      {{fista_step_kernel<512, kFillBulk, float>},
       {fista_step_kernel<512, kFillLoads, float>},
       {nullptr}},
      {{fista_step_kernel<1024, kFillBulk, float>},
       {fista_step_kernel<1024, kFillLoads, float>},
       {nullptr}}};
  return &table[threads_index(threads)][fill];
}

Variant<FbStep<float>>* fb_step_variant(int threads, int fill) {
  static Variant<FbStep<float>> table[3][3] = {
      {{fb_step_kernel<256, kFillBulk, float>},
       {fb_step_kernel<256, kFillLoads, float>},
       {fb_step_kernel<256, kFillNone, float>}},
      {{fb_step_kernel<512, kFillBulk, float>},
       {fb_step_kernel<512, kFillLoads, float>},
       {nullptr}},
      {{fb_step_kernel<1024, kFillBulk, float>},
       {fb_step_kernel<1024, kFillLoads, float>},
       {nullptr}}};
  return &table[threads_index(threads)][fill];
}

// S == 0: the lane in place by the float32 body; else the ring variant.
Variant<FistaStep<Bf16>>* fista_step_bf16_variant(int threads, int fill,
                                                  int cols, int xregs) {
  static Variant<FistaStep<Bf16>> in_place = {
      fista_step_kernel<256, kFillNone, Bf16>};
  if (fill == kFillNone) return &in_place;
  return proxtpu::fista_step_bf16_ring(threads, fill, cols, xregs);
}

Variant<FbStep<Bf16>>* fb_step_bf16_variant(int threads, int fill, int cols,
                                            int xregs) {
  static Variant<FbStep<Bf16>> in_place = {
      fb_step_kernel<256, kFillNone, Bf16>};
  if (fill == kFillNone) return &in_place;
  return proxtpu::fb_step_bf16_ring(threads, fill, cols, xregs);
}

// The bf16 plan's two fields beside step_fill's: `cols` columns a thread in
// pass 2 (2 only with a ring and N even, so that every row of a stage
// starts on 4 bytes) and `xregs` (1: x in registers in pass 1, only with a
// ring, N <= 32 * kXRegs and at most 512 threads).
bool bf16_fields_ok(int M, int N, int threads, int S, int cols, int xregs) {
  if (cols != 1 && cols != 2) return false;
  if (xregs != 0 && xregs != 1) return false;
  if (S == 0) return cols == 1 && xregs == 0;
  return (cols == 1 || N % 2 == 0) &&
         (xregs == 0 || (N <= 32 * proxtpu::kXRegs && threads <= 512));
}

}  // namespace

extern "C" {

// fista_step and fb_step, A in float32 or in bfloat16, launch the plan they
// are given (see step_fill; the bf16 entries also take bf16_fields_ok's
// cols and xregs) or return cudaErrorInvalidValue; they never launch
// another.
int proxtpu_fista_step(const float* A, const float* b, float* x, float* zp,
                       const float* beta, const float* gamma,
                       const float* thr, const float* done,
                       const float* shrink, float* res, float* rs, int B,
                       int M, int N, int restart, int threads, int R, int S,
                       int smem_bytes, void* stream) {
  const int fill = step_fill(A, M, N, threads, R, S, smem_bytes, 4);
  if (fill < 0) return (int)cudaErrorInvalidValue;
  return launch_step(fista_step_variant(threads, fill), B, threads,
                     smem_bytes, stream, A, b, x, zp, beta, gamma, thr, done,
                     shrink, res, rs, M, N, R, S, restart);
}

int proxtpu_fista_step_bf16(const Bf16* A, const float* b, float* x,
                            float* zp, const float* beta, const float* gamma,
                            const float* thr, const float* done,
                            const float* shrink, float* res, float* rs,
                            int B, int M, int N, int restart, int threads,
                            int R, int S, int smem_bytes, int cols, int xregs,
                            void* stream) {
  const int fill = step_fill(A, M, N, threads, R, S, smem_bytes, 2);
  if (fill < 0 || !bf16_fields_ok(M, N, threads, S, cols, xregs))
    return (int)cudaErrorInvalidValue;
  return launch_step(fista_step_bf16_variant(threads, fill, cols, xregs), B,
                     threads, smem_bytes, stream, A, b, x, zp, beta, gamma,
                     thr, done, shrink, res, rs, M, N, R, S, restart);
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
                    float* z, float* res, int B, int M, int N, int threads,
                    int R, int S, int smem_bytes, void* stream) {
  const int fill = step_fill(A, M, N, threads, R, S, smem_bytes, 4);
  if (fill < 0) return (int)cudaErrorInvalidValue;
  return launch_step(fb_step_variant(threads, fill), B, threads, smem_bytes,
                     stream, A, b, x, gamma, thr, shrink, z, res, M, N, R, S);
}

int proxtpu_fb_step_bf16(const Bf16* A, const float* b, const float* x,
                         const float* gamma, const float* thr,
                         const float* shrink, float* z, float* res, int B,
                         int M, int N, int threads, int R, int S,
                         int smem_bytes, int cols, int xregs, void* stream) {
  const int fill = step_fill(A, M, N, threads, R, S, smem_bytes, 2);
  if (fill < 0 || !bf16_fields_ok(M, N, threads, S, cols, xregs))
    return (int)cudaErrorInvalidValue;
  return launch_step(fb_step_bf16_variant(threads, fill, cols, xregs), B,
                     threads, smem_bytes, stream, A, b, x, gamma, thr, shrink,
                     z, res, M, N, R, S);
}

// Blocks of fista_step (`fista` != 0) or fb_step at this plan, A of
// `elem_bytes` (4: float32, 2: bfloat16; cols 1 and xregs 0 for float32)
// an entry, that one SM holds at a time, for a lane that takes the bulk
// copy.
int proxtpu_step_blocks_per_sm(int fista, int elem_bytes, int M, int N,
                               int threads, int R, int S, int smem_bytes,
                               int cols, int xregs, int* out) {
  if (elem_bytes != 4 && elem_bytes != 2) return (int)cudaErrorInvalidValue;
  const int fill =
      step_fill(nullptr, M, N, threads, R, S, smem_bytes, elem_bytes);
  const bool fields_ok = elem_bytes == 2
                             ? bf16_fields_ok(M, N, threads, S, cols, xregs)
                             : cols == 1 && xregs == 0;
  if (fill < 0 || !fields_ok) return (int)cudaErrorInvalidValue;
  auto held = [&](auto* v) {
    cudaError_t err = prepare_once(v->prepared, v->kernel, smem_bytes);
    if (err != cudaSuccess) return err;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out, v->kernel, threads, smem_bytes);
  };
  if (elem_bytes == 2)
    return (int)(fista ? held(fista_step_bf16_variant(threads, fill, cols,
                                                      xregs))
                       : held(fb_step_bf16_variant(threads, fill, cols,
                                                   xregs)));
  return (int)(fista ? held(fista_step_variant(threads, fill))
                     : held(fb_step_variant(threads, fill)));
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
