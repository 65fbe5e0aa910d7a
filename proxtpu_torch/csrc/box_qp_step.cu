// Hopper (sm_90a) kernels for the batched box-QP projected-gradient step.
//
// Replaces the Pallas TPU kernels of proxtpu/kernels/box_qp.py:
//   pg_step    <- _pg_step_kernel (box_qp.py:31, via fused_pg_box_step)
//   pg_k_steps <- _pg_k_steps_kernel (box_qp.py:174, via fused_pg_box_k_steps)
//
// Per lane i (one CTA each), with Q_i (n, n) symmetric row-major f32:
//   g = Q x + q;  y = x - gamma g (two roundings, as the plain version);
//   z = clip(y, lo, hi) (keeping a NaN);  res = max |x - z|;  x <- z in place.
// A frozen lane (done given and done != 0) returns before reading Q, keeps
// x and reports res = 0.  pg_k_steps runs K such steps with x and g in
// shared memory and writes x back once; res is the last step's.
//
// The TPU reduced Q * x_col over sublanes, which for symmetric Q yields the
// gradient in the row orientation its update needed; its K-step kernel
// carried x as a row and as a column and did the matvec twice to avoid a
// relayout.  Here a warp reads row m of Q with coalesced loads and sums
// Q[m, :] x = (Q x)[m]: one orientation, one matvec per step.
//
// Bound: reading Q from device memory, n^2 * 4 bytes per lane per step
// (1 MB at n = 512).  The TPU's blocked kernel kept Q in VMEM for its K
// steps; a CTA's 227 KB of shared memory cannot hold 1 MB, and at B = 64
// (64 MB) Q exceeds the 50 MB L2, so pg_k_steps still reads Q once per
// step: it saves K - 1 launches and host checks, not bytes.  One CTA per
// lane leaves 68 of 132 SMs idle at B = 64; 1024 threads keep more reads
// in flight on the others.
//
// Plain C interface for ctypes.  Every entry launches on the given stream,
// does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using proxtpu::block_reduce;
using proxtpu::nanclip;
using proxtpu::nanmax;
using proxtpu::prepare;
using proxtpu::rows_dot;

constexpr int kThreads = 1024;

// One projected-gradient step on x in shared memory, g as scratch; writes
// z over x and returns the block's max |x - z| to every thread.
__device__ __forceinline__ float pg_step_smem(const float* __restrict__ Qi,
                                              const float* __restrict__ qi,
                                              float* xs, float* g, int n,
                                              float gamma, float lo,
                                              float hi, float* scratch) {
  rows_dot<kThreads, false>(Qi, qi, xs, g, n, n);
  __syncthreads();  // g complete; every read of x done
  float mx = 0.f, unused = 0.f;
  for (int j = threadIdx.x; j < n; j += kThreads) {
    const float xv = xs[j];
    const float z = nanclip(__fsub_rn(xv, __fmul_rn(gamma, g[j])), lo, hi);
    mx = nanmax(mx, fabsf(xv - z));
    xs[j] = z;
  }
  block_reduce<kThreads>(mx, unused, scratch);  // x complete after this
  return mx;
}

__global__ void __launch_bounds__(kThreads)
pg_k_steps_kernel(const float* __restrict__ Q, const float* __restrict__ q,
                  float* __restrict__ x, const float* __restrict__ gamma,
                  const float* __restrict__ lo, const float* __restrict__ hi,
                  const float* __restrict__ done, float* __restrict__ res,
                  int n, int K) {
  extern __shared__ float smem[];
  float* xs = smem;      // n: x
  float* g = smem + n;   // n: the gradient
  __shared__ float scratch[2 * (kThreads / 32)];

  const int i = blockIdx.x;
  if (done != nullptr && done[i] != 0.f) {  // frozen: x untouched, res 0
    if (threadIdx.x == 0) res[i] = 0.f;
    return;
  }
  const float* Qi = Q + (size_t)i * n * n;
  const float* qi = q + (size_t)i * n;
  float* xi = x + (size_t)i * n;
  const float gi = gamma[i], loi = lo[i], hii = hi[i];

  for (int j = threadIdx.x; j < n; j += kThreads) xs[j] = xi[j];
  __syncthreads();
  float mx = 0.f;
  for (int step = 0; step < K; ++step)
    mx = pg_step_smem(Qi, qi, xs, g, n, gi, loi, hii, scratch);
  for (int j = threadIdx.x; j < n; j += kThreads) xi[j] = xs[j];
  if (threadIdx.x == 0) res[i] = mx;
}

cudaError_t launch(const float* Q, const float* q, float* x,
                   const float* gamma, const float* lo, const float* hi,
                   const float* done, float* res, int B, int n, int K,
                   void* stream) {
  const size_t smem = (size_t)2 * n * sizeof(float);
  cudaError_t err = prepare(pg_k_steps_kernel, smem);
  if (err != cudaSuccess) return err;
  pg_k_steps_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      Q, q, x, gamma, lo, hi, done, res, n, K);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// One step; done may be NULL (no lane frozen).
int proxtpu_pg_step(const float* Q, const float* q, float* x,
                    const float* gamma, const float* lo, const float* hi,
                    const float* done, float* res, int B, int n,
                    void* stream) {
  return (int)launch(Q, q, x, gamma, lo, hi, done, res, B, n, 1, stream);
}

int proxtpu_pg_k_steps(const float* Q, const float* q, float* x,
                       const float* gamma, const float* lo, const float* hi,
                       const float* done, float* res, int B, int n, int K,
                       void* stream) {
  return (int)launch(Q, q, x, gamma, lo, hi, done, res, B, n, K, stream);
}

}  // extern "C"
