// Hopper (sm_90a) kernel: fb_step with A stored in bfloat16.
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

template <int THREADS, int FILL, bool XREG, bool PAIR>
__global__ void __launch_bounds__(THREADS, step_blocks(THREADS))
fb_step_bf16_kernel(const __nv_bfloat16* __restrict__ A,
                    const float* __restrict__ b, const float* __restrict__ x,
                    const float* __restrict__ gamma,
                    const float* __restrict__ thr,
                    const float* __restrict__ shrink,
                    float* __restrict__ z_out, float* __restrict__ res, int M,
                    int N, int R, int S) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ float scratch[2 * (THREADS / 32)];

  const int i = blockIdx.x;
  const float gi = gamma[i], thri = thr[i];
  const float si = shrink ? shrink[i] : 1.f;
  float* zi = z_out + (size_t)i * N;
  sweep_bf16<THREADS, FILL, XREG, PAIR>(smem_raw, A + (size_t)i * M * N,
                                        b + (size_t)i * M, x + (size_t)i * N,
                                        M, N, R, S);
  const StepLayout lay(M, N, R, S, sizeof(__nv_bfloat16));
  const float* xs = reinterpret_cast<const float*>(smem_raw);
  const float* g = xs + lay.Np;
  float mx = 0.f, unused = 0.f;
  for (int n = threadIdx.x; n < N; n += THREADS) {
    const float xv = xs[n];
    const float z = shrink ? prox_point<true>(xv, g[n], gi, thri, si)
                           : prox_point<false>(xv, g[n], gi, thri, 1.f);
    mx = nanmax(mx, fabsf(xv - z));
    zi[n] = z;
  }
  block_reduce<THREADS>(mx, unused, scratch);
  if (threadIdx.x == 0) res[i] = mx;
}

}  // namespace

namespace proxtpu {

Variant<FbStep<__nv_bfloat16>>* fb_step_bf16_ring(int threads, int fill,
                                                  int cols, int xregs) {
  static Variant<FbStep<__nv_bfloat16>> table[3][2][4] = {
      {PROXTPU_BF16_RING(fb_step_bf16_kernel, 256, kFillBulk),
       PROXTPU_BF16_RING(fb_step_bf16_kernel, 256, kFillLoads)},
      {PROXTPU_BF16_RING(fb_step_bf16_kernel, 512, kFillBulk),
       PROXTPU_BF16_RING(fb_step_bf16_kernel, 512, kFillLoads)},
      {PROXTPU_BF16_WIDE(fb_step_bf16_kernel, kFillBulk),
       PROXTPU_BF16_WIDE(fb_step_bf16_kernel, kFillLoads)}};
  return &table[threads_index(threads)][fill][2 * xregs + cols - 1];
}

}  // namespace proxtpu
