// What the sources of the one-step lasso kernels, fb_step and fista_step,
// share: lasso_step.cu (the float32 instances, a bf16 lane read in place,
// fista_k_steps and the C entries) and fista_step_bf16.cu, fb_step_bf16.cu
// (the bfloat16-A instances' ring variants; lasso_step.cu's note says what
// bounds them and what their design does).  Apart, the three compile side
// by side.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"

namespace proxtpu {

// fb_step, fista_step: res and rs are reduced in the order of a block of
// this many threads, the smallest block the plan chooses
constexpr int kOrderThreads = 256;
// fb_step, fista_step: blocks of THREADS threads the compiler leaves room for
// on an SM (64 registers a thread, 32 at 1024 threads)
constexpr int step_blocks(int threads) { return threads >= 512 ? 2 : 4; }

inline int threads_index(int threads) {
  return threads == 256 ? 0 : threads == 512 ? 1 : threads == 1024 ? 2 : -1;
}

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

// Dynamic shared memory of fb_step and fista_step, in bytes from its start.
// With a ring (S > 0): x (then z) and g of Np = N rounded up to 4 floats
// each, r of M rounded up to 4, then on 128 bytes S stages of R rows of A
// (`elem` bytes an entry; each stage rounded up to 128 bytes) and S
// mbarriers.  With the lane read in place (S = 0): x (then z) and r, N + M
// floats, the shared memory of a kernel that keeps no tile at all.
// kernels/lasso.py (step_shared_bytes) computes the same total.
struct StepLayout {
  int Np;
  size_t r, stage0, stage_bytes, bars, total;
  __host__ __device__ StepLayout(int M, int N, int R, int S, size_t elem) {
    Np = S ? (int)round_up(N, 4) : N;
    r = (S ? 2 : 1) * (size_t)Np * sizeof(float);
    const size_t fixed = r + (S ? round_up(M, 4) : M) * sizeof(float);
    stage0 = round_up(fixed, 128);
    stage_bytes = round_up((size_t)R * N * elem, 128);
    bars = stage0 + S * stage_bytes;
    total = S ? bars + S * sizeof(uint64_t) : fixed;
  }
};

// A launchable kernel of fb_step or fista_step (A's entries of type T) with
// its launch attributes, set once.
template <typename T>
using FistaStep = void (*)(const T*, const float*, float*, float*,
                           const float*, const float*, const float*,
                           const float*, const float*, float*, float*, int,
                           int, int, int, int);
template <typename T>
using FbStep = void (*)(const T*, const float*, const float*, const float*,
                        const float*, const float*, float*, float*, int, int,
                        int, int);
template <typename Kernel>
struct Variant {
  Kernel kernel;
  Prepared prepared;
};

// The ring variants (fill kFillBulk or kFillLoads) of the bf16 instances at
// `threads` per block, `cols` columns a thread in pass 2 and x in registers
// or not (`xregs`): fista_step_bf16.cu, fb_step_bf16.cu.
Variant<FistaStep<__nv_bfloat16>>* fista_step_bf16_ring(int threads, int fill,
                                                        int cols, int xregs);
Variant<FbStep<__nv_bfloat16>>* fb_step_bf16_ring(int threads, int fill,
                                                  int cols, int xregs);

// the four ring variants of a bf16 kernel K at TH threads and FILL, indexed
// by 2 xregs + (cols - 1); at 1024 threads (N > 512) none keeps x in
// registers
#define PROXTPU_BF16_RING(K, TH, FILL)                       \
  {{K<TH, FILL, false, false>}, {K<TH, FILL, false, true>},  \
   {K<TH, FILL, true, false>}, {K<TH, FILL, true, true>}}
#define PROXTPU_BF16_WIDE(K, FILL)                                \
  {{K<1024, FILL, false, false>}, {K<1024, FILL, false, true>},   \
   {nullptr}, {nullptr}}

// One sweep of the ring on a lane of bf16 rows with the passes of common.cuh
// chosen by the plan: x in registers for pass 1 (XREG: N <= 32 * kXRegs),
// two columns a thread in pass 2 (PAIR: N even).  x stays in shared memory
// through the step (the epilogues read it there, never from device
// memory).  On return g holds A^T r at every column, readable by every
// thread.
template <int THREADS, int FILL, bool XREG, bool PAIR>
__device__ __forceinline__ void sweep_bf16(unsigned char* smem_raw,
                                           const __nv_bfloat16* __restrict__ Ai,
                                           const float* __restrict__ bi,
                                           const float* xi, int M, int N,
                                           int R, int S) {
  const StepLayout lay(M, N, R, S, sizeof(__nv_bfloat16));
  float* xs = reinterpret_cast<float*>(smem_raw);
  float* g = xs + lay.Np;
  float* r = reinterpret_cast<float*>(smem_raw + lay.r);
  TileRing<THREADS, FILL, __nv_bfloat16> ring(
      reinterpret_cast<__nv_bfloat16*>(smem_raw + lay.stage0),
      lay.stage_bytes / sizeof(__nv_bfloat16),
      reinterpret_cast<uint64_t*>(smem_raw + lay.bars), Ai, M, N, R, S, 1);
  ring.init_barriers();
  __syncthreads();
  ring.prime();
  for (int n = threadIdx.x; n < N; n += THREADS) xs[n] = xi[n];
  __syncthreads();
  float xr[proxtpu::kXRegs];
  if constexpr (XREG) {
    const int lane = threadIdx.x % 32;
#pragma unroll
    for (int k = 0; k < proxtpu::kXRegs; ++k)
      xr[k] = lane + 32 * k < N ? xs[lane + 32 * k] : 0.f;
  }
  ring.sweep_with(
      [&](const __nv_bfloat16* tile, int m0, int rows) {
        if constexpr (XREG)
          proxtpu::tile_rows_dot_xreg<THREADS>(tile, bi + m0, xr, r + m0,
                                               rows, N);
        else
          proxtpu::tile_rows_dot<THREADS, false, __nv_bfloat16>(
              tile, bi + m0, xs, r + m0, rows, N);
      },
      [&](const __nv_bfloat16* tile, int m0, int rows) {
        if constexpr (PAIR) {
          proxtpu::tile_cols_fma_pair<THREADS>(tile, r + m0, g, rows, N,
                                               m0 == 0);
        } else {
          proxtpu::tile_cols_fma<THREADS, __nv_bfloat16>(tile, r + m0, g,
                                                         rows, N, m0 == 0);
        }
      });
  __syncthreads();  // g complete, whichever thread summed a column
}

}  // namespace proxtpu
