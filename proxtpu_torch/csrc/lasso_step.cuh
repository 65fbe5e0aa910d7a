// What the sources of the one-step lasso kernels, fb_step and fista_step,
// share: lasso_step.cu (the float32 instances, a bf16 lane read in place,
// fista_k_steps and the C entries), fista_step_bf16.cu, fb_step_bf16.cu
// (the bfloat16-A instances' ring variants; lasso_step.cu's note says what
// bounds them and what their design does) and fista_packed_step.cu
// (fista_step's body on the lane-packed layout).  Apart, the four compile
// side by side.
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

// One lane's FB step up to the prox: x into shared memory, one sweep of the
// ring over the lane's M rows (or, FILL == kFillNone, both passes on the lane
// in place), then z at every column n by the thread that owns it, handed to
// finish(n, x_n, z).  The fills start before x is asked for.  A's entries
// are of type T (float or bf16).  Row m of the lane's A starts at
// Ai + m map.stride, its entry n, and x's, at offset map(n) (RowMap: the
// natural layout, or the packed one, float32 only); b_m is bi[m bstep].
// The natural layout's pass 1 reads b in place; a packed lane's b is first
// gathered into r, which pass 1 reads before it writes r[m] over it.
template <int THREADS, int FILL, typename T, bool PACKED, typename Finish>
__device__ __forceinline__ void step_prox(unsigned char* smem_raw,
                                          const T* __restrict__ Ai,
                                          RowMap<PACKED> map,
                                          const float* __restrict__ bi,
                                          int bstep, const float* xi, int M,
                                          int N, int R, int S, float gamma,
                                          float thr, const float* shrink,
                                          int i, Finish finish) {
  const StepLayout lay(M, N, R, S, sizeof(T));
  float* xs = reinterpret_cast<float*>(smem_raw);
  float* r = reinterpret_cast<float*>(smem_raw + lay.r);
  const float si = shrink ? shrink[i] : 1.f;
  auto prox = [&](float xv, float g) {
    return shrink ? prox_point<true>(xv, g, gamma, thr, si)
                  : prox_point<false>(xv, g, gamma, thr, 1.f);
  };
  const float* c = PACKED ? r : bi;  // pass 1's b
  auto load = [&] {  // x, and a packed lane's b into r
    for (int n = threadIdx.x; n < N; n += THREADS) xs[n] = xi[map(n)];
    if constexpr (PACKED)
      for (int m = threadIdx.x; m < M; m += THREADS)
        r[m] = bi[(size_t)m * bstep];
  };
  if constexpr (FILL == kFillNone) {
    // both passes of the ring's sweep on the lane in place, through the map
    load();
    __syncthreads();
    tile_rows_dot<THREADS, false, T>(Ai, map, c, xs, r, M, N);
    __syncthreads();
    for (int n = threadIdx.x; n < N; n += THREADS) {
      const float xv = xs[n];
      finish(n, xv, prox(xv, tile_col_fma(Ai + map(n), r, M, map.stride,
                                          0.f)));
    }
  } else {
    float* g = xs + lay.Np;
    TileRing<THREADS, FILL, T, PACKED> ring(
        reinterpret_cast<T*>(smem_raw + lay.stage0),
        lay.stage_bytes / sizeof(T),
        reinterpret_cast<uint64_t*>(smem_raw + lay.bars), Ai, M, N, R, S, 1,
        map);
    ring.init_barriers();
    __syncthreads();
    ring.prime();
    load();
    __syncthreads();
    ring.sweep(c, xs, r, g);
    for (int n = threadIdx.x; n < N; n += THREADS) {
      const float xv = xs[n];
      finish(n, xv, prox(xv, g[n]));
    }
  }
}

// fista_step on one lane, the block's (i = blockIdx.x): lane i's A, b, x
// and z_prev as step_prox takes them (`map`, `bstep`), its scalars at i.
// x and z_prev are updated in place; a frozen lane (done != 0) keeps them
// untouched and reports res = rs = 0.  `scratch` holds 2 kOrderThreads / 32
// floats.
template <int THREADS, int FILL, typename T, bool PACKED>
__device__ __forceinline__ void fista_step_lane(
    unsigned char* smem_raw, float* scratch, const T* __restrict__ Ai,
    RowMap<PACKED> map, const float* __restrict__ bi, int bstep, float* xi,
    float* zpi, const float* __restrict__ beta,
    const float* __restrict__ gamma, const float* __restrict__ thr,
    const float* __restrict__ done, const float* __restrict__ shrink,
    float* __restrict__ res, float* __restrict__ rs, int M, int N, int R,
    int S, int restart) {
  const int i = blockIdx.x;
  if (done[i] != 0.f) {  // frozen lane: carries untouched, read-outs 0
    if (threadIdx.x == 0) {
      res[i] = 0.f;
      rs[i] = 0.f;
    }
    return;
  }
  const float beta_i = beta[i];  // asked for before the sweep, used after
  float* zs = reinterpret_cast<float*>(smem_raw);  // z takes x's place
  step_prox<THREADS, FILL, T>(smem_raw, Ai, map, bi, bstep, xi, M, N, R, S,
                              gamma[i], thr[i], shrink, i,
                              [&](int n, float, float z) { zs[n] = z; });
  __syncthreads();  // z complete

  // res and rs as a block of kOrderThreads threads sums them: thread t
  // chains the columns t, t + kOrderThreads, ..., then block_reduce's trees
  float mx = 0.f, dot = 0.f;
  if (threadIdx.x < kOrderThreads) {
    for (int n = threadIdx.x; n < N; n += kOrderThreads) {
      const float z = zs[n];
      const float d = xi[map(n)] - z;  // x is still in device memory
      mx = nanmax(mx, fabsf(d));
      dot = fmaf(d, z - zpi[map(n)], dot);
    }
  }
  block_reduce<kOrderThreads>(mx, dot, scratch);

  const float beta_used = (restart && dot > 0.f) ? 0.f : beta_i;
  for (int n = threadIdx.x; n < N; n += THREADS) {
    const float z = zs[n];
    const size_t c = map(n);
    xi[c] = __fadd_rn(z, __fmul_rn(beta_used, z - zpi[c]));
    zpi[c] = z;
  }
  if (threadIdx.x == 0) {
    res[i] = mx;
    rs[i] = dot;
  }
}

// The plan of kernels/lasso.py (step_plan), checked against the kernel's own
// layout for A of `elem` bytes an entry: `threads` per block, tiles of R
// rows through S stages (S = 0: the lane in place, 256 threads; S = 1 only
// where the lane is one tile, so that nothing is refilled), `smem_bytes` of
// dynamic shared memory.  A bulk copy moves less than 1 MB, its barrier's
// limit, and needs rows and the lane's start on 16 bytes (in the packed
// layout every run's start and end then lie on 16 bytes too).  Returns the
// way the tiles are filled, or -1 for a plan the kernels do not take.
inline int step_fill(const void* A, int M, int N, int threads, int R, int S,
                     int smem_bytes, size_t elem) {
  const bool ok = threads_index(threads) >= 0 && R >= 1 &&
                  (S >= 3 || (S == 1 && R >= M) ||
                   (S == 0 && threads == kOrderThreads)) &&
                  (S == 0 || (size_t)R * N * elem < (1u << 20));
  if (!ok || StepLayout(M, N, R, S, elem).total != (size_t)smem_bytes)
    return -1;
  const bool aligned =
      (size_t)N * elem % 16 == 0 && reinterpret_cast<uintptr_t>(A) % 16 == 0;
  return S == 0 ? kFillNone : aligned ? kFillBulk : kFillLoads;
}

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

// The one-step kernels launch the plan they are given (see step_fill and
// bf16_fields_ok) or return cudaErrorInvalidValue; they never launch
// another.
template <typename Kernel, typename... Args>
int launch_step(Variant<Kernel>* v, int B, int threads, int smem_bytes,
                void* stream, Args... args) {
  cudaError_t err = prepare_once(v->prepared, v->kernel, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  v->kernel<<<B, threads, smem_bytes, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}

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
