// Hopper (sm_90a) kernel: fista_step with A stored in bfloat16.
//
// The ring variants of the bfloat16-A instance (csrc/lasso_step.cu's note:
// what bounds it and what its design does; the shared pieces in
// lasso_step.cuh).  Its own source, so that the build compiles it beside
// lasso_step.cu.

#include "lasso_step.cuh"

namespace {

using proxtpu::block_reduce;
using proxtpu::kFillBulk;
using proxtpu::kFillLoads;
using proxtpu::kOrderThreads;
using proxtpu::nanmax;
using proxtpu::prox_point;
using proxtpu::step_blocks;
using proxtpu::StepLayout;
using proxtpu::sweep_bf16;

// fista_step's epilogue keeps z_prev of a thread's first kPre columns of
// the reductions (n = t + kOrderThreads j) in registers, loaded before the
// sweep; further columns (N above kPre * kOrderThreads) read it after.
constexpr int kPre = 2;

template <int THREADS, int FILL, bool XREG, bool PAIR>
__global__ void __launch_bounds__(THREADS, step_blocks(THREADS))
fista_step_bf16_kernel(const __nv_bfloat16* __restrict__ A,
                       const float* __restrict__ b, float* x, float* zp,
                       const float* __restrict__ beta,
                       const float* __restrict__ gamma,
                       const float* __restrict__ thr,
                       const float* __restrict__ done,
                       const float* __restrict__ shrink,
                       float* __restrict__ res, float* __restrict__ rs,
                       int M, int N, int R, int S, int restart) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ float scratch[2 * (kOrderThreads / 32)];

  const int i = blockIdx.x, t = threadIdx.x;
  if (done[i] != 0.f) {  // frozen lane: carries untouched, read-outs 0
    if (t == 0) {
      res[i] = 0.f;
      rs[i] = 0.f;
    }
    return;
  }
  float* xi = x + (size_t)i * N;
  float* zpi = zp + (size_t)i * N;
  // asked for before the sweep, used after
  const float beta_i = beta[i], gi = gamma[i], thri = thr[i];
  const float si = shrink ? shrink[i] : 1.f;
  const bool own = t < kOrderThreads;
  float zpr[kPre];
#pragma unroll
  for (int j = 0; j < kPre; ++j) {
    const int n = t + kOrderThreads * j;
    zpr[j] = own && n < N ? zpi[n] : 0.f;
  }
  sweep_bf16<THREADS, FILL, XREG, PAIR>(smem_raw, A + (size_t)i * M * N,
                                        b + (size_t)i * M, xi, M, N, R, S);
  const StepLayout lay(M, N, R, S, sizeof(__nv_bfloat16));
  const float* xs = reinterpret_cast<const float*>(smem_raw);
  float* g = reinterpret_cast<float*>(smem_raw) + lay.Np;  // then z
  auto prox = [&](float xv, float gn) {
    return shrink ? prox_point<true>(xv, gn, gi, thri, si)
                  : prox_point<false>(xv, gn, gi, thri, 1.f);
  };

  // z, res and rs as fista_step_kernel has them: thread t < kOrderThreads
  // chains the columns t, t + kOrderThreads, ..., then block_reduce's trees
  float mx = 0.f, dot = 0.f, zr[kPre];
  if (own) {
#pragma unroll
    for (int j = 0; j < kPre; ++j) {
      const int n = t + kOrderThreads * j;
      if (n < N) {
        const float xv = xs[n];
        const float z = zr[j] = prox(xv, g[n]);
        const float d = xv - z;
        mx = nanmax(mx, fabsf(d));
        dot = fmaf(d, z - zpr[j], dot);
      }
    }
    for (int n = t + kOrderThreads * kPre; n < N; n += kOrderThreads) {
      const float xv = xs[n];
      const float z = g[n] = prox(xv, g[n]);
      const float d = xv - z;
      mx = nanmax(mx, fabsf(d));
      dot = fmaf(d, z - zpi[n], dot);
    }
  }
  block_reduce<kOrderThreads>(mx, dot, scratch);

  const float bi = (restart && dot > 0.f) ? 0.f : beta_i;
  if (own) {
#pragma unroll
    for (int j = 0; j < kPre; ++j) {
      const int n = t + kOrderThreads * j;
      if (n < N) {
        const float z = zr[j];
        xi[n] = __fadd_rn(z, __fmul_rn(bi, z - zpr[j]));
        zpi[n] = z;
      }
    }
    for (int n = t + kOrderThreads * kPre; n < N; n += kOrderThreads) {
      const float z = g[n];
      xi[n] = __fadd_rn(z, __fmul_rn(bi, z - zpi[n]));
      zpi[n] = z;
    }
  }
  if (t == 0) {
    res[i] = mx;
    rs[i] = dot;
  }
}

}  // namespace

namespace proxtpu {

Variant<FistaStep<__nv_bfloat16>>* fista_step_bf16_ring(int threads, int fill,
                                                        int cols, int xregs) {
  static Variant<FistaStep<__nv_bfloat16>> table[3][2][4] = {
      {PROXTPU_BF16_RING(fista_step_bf16_kernel, 256, kFillBulk),
       PROXTPU_BF16_RING(fista_step_bf16_kernel, 256, kFillLoads)},
      {PROXTPU_BF16_RING(fista_step_bf16_kernel, 512, kFillBulk),
       PROXTPU_BF16_RING(fista_step_bf16_kernel, 512, kFillLoads)},
      {PROXTPU_BF16_WIDE(fista_step_bf16_kernel, kFillBulk),
       PROXTPU_BF16_WIDE(fista_step_bf16_kernel, kFillLoads)}};
  return &table[threads_index(threads)][fill][2 * xregs + cols - 1];
}

}  // namespace proxtpu
