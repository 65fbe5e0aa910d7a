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
// Bound: reading A from device memory.  At the flagship shape (256, 200, 400)
// A is 81.9 MB per step, ~24.5 us at the H100 datasheet's 3.35 TB/s if read
// once.  This version reads A twice (pass 1 row-wise, pass 2 column-wise);
// one lane's A is 312.5 KiB, more than a block's 227 KB of shared memory, so
// it cannot be staged whole, and the second read is meant to hit the 50 MB L2
// while the lane's slab is still resident.  Frozen lanes return before
// touching A, so a batch whose lanes converge reads less.  Reading A once
// (a 2-CTA cluster reducing A^T r through DSMEM, or a persistent kernel) is
// later work.
//
// fista_k_steps runs K full iterations per lane in one launch: the FB step,
// with RESTART t <- 1 where rs > 0 (before the coefficient is drawn, as
// AdaptiveRestartSequence does), t' = (1 + sqrt(1 + 4 t^2)) / 2, beta =
// (t - 1) / t', x <- z + beta (z - z_prev), z_prev <- z; x, z_prev and t
// live in shared memory and registers across the K steps and go back to
// device memory (in place) once; res is the last step's.  What bounds it:
// the TPU kernel kept the lane's A in VMEM for all K steps, but a lane of
// the blocked route holds at least 1 MB of A (2 MB at 512 x 1024), far
// beyond the 227 KB of shared memory a CTA can use, and at B = 64 all of A
// (128 MB) exceeds the 50 MB L2.  So each inner step still reads A twice
// from device memory: the gain over K fista_step launches is K times fewer
// launches and host checks, not fewer bytes.  One CTA per lane also leaves
// 68 of the 132 SMs idle at B = 64; 1024 threads per CTA keep more reads in
// flight on the SMs that work.  Splitting a lane's rows over a cluster of
// CTAs that reduce A^T r through distributed shared memory is later work.
//
// Plain C interface for ctypes.  Every entry launches on the given stream,
// does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using proxtpu::block_reduce;
using proxtpu::nanmax;
using proxtpu::prepare;
using proxtpu::rows_dot;

constexpr int kThreads = 256;
constexpr int kUnroll = 8;  // loads of A each thread keeps in flight
constexpr int kKThreads = 1024;  // fista_k_steps: see the note above

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
  // explicit roundings: y = x - gamma * g as two ops, like the reference
  const float y = __fsub_rn(xv, __fmul_rn(gamma, g));
  const float a = fabsf(y) - thr;
  // max(a, 0) that keeps a NaN (fmaxf would drop it)
  const float mag = (a > 0.f || a != a) ? a : 0.f;
  float z = copysignf(mag, y);
  if (SHRINK) z = z / shrink;
  return z;
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

template <bool RESTART>
__global__ void __launch_bounds__(kKThreads)
fista_k_steps_kernel(const float* __restrict__ A, const float* __restrict__ b,
                     float* __restrict__ x, float* __restrict__ zp,
                     float* __restrict__ t, const float* __restrict__ gamma,
                     const float* __restrict__ thr,
                     const float* __restrict__ done, float* __restrict__ res,
                     int M, int N, int K) {
  extern __shared__ float smem[];
  float* xs = smem;       // N: x, then z within a step
  float* zs = smem + N;   // N: z_prev
  float* r = smem + 2 * N;  // M
  __shared__ float scratch[2 * (kKThreads / 32)];

  const int i = blockIdx.x;
  if (done[i] != 0.f) {  // frozen lane: x, z_prev, t untouched, res 0
    if (threadIdx.x == 0) res[i] = 0.f;
    return;
  }
  const float* Ai = A + (size_t)i * M * N;
  const float* bi = b + (size_t)i * M;
  float* xi = x + (size_t)i * N;
  float* zpi = zp + (size_t)i * N;
  const float gi = gamma[i], thri = thr[i];
  float ti = t[i];

  for (int n = threadIdx.x; n < N; n += kKThreads) {
    xs[n] = xi[n];
    zs[n] = zpi[n];
  }
  __syncthreads();

  float mx = 0.f;
  for (int step = 0; step < K; ++step) {
    rows_dot<kKThreads, true>(Ai, bi, xs, r, M, N);
    __syncthreads();  // r complete; every read of x done

    float dot = 0.f;
    mx = 0.f;
    // a thread owns the same columns in every loop below
    for (int n = threadIdx.x; n < N; n += kKThreads) {
      const float xv = xs[n];
      const float z = prox_column<false>(Ai, r, xv, n, M, N, gi, thri, 1.f);
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

  for (int n = threadIdx.x; n < N; n += kKThreads) {
    xi[n] = xs[n];
    zpi[n] = zs[n];
  }
  if (threadIdx.x == 0) {
    t[i] = ti;
    res[i] = mx;
  }
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

int proxtpu_fista_k_steps(const float* A, const float* b, float* x,
                          float* zp, float* t, const float* gamma,
                          const float* thr, const float* done, float* res,
                          int B, int M, int N, int K, int restart,
                          void* stream) {
  const size_t smem = (size_t)(2 * N + M) * sizeof(float);
  auto kernel = restart ? fista_k_steps_kernel<true>
                        : fista_k_steps_kernel<false>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<B, kKThreads, smem, (cudaStream_t)stream>>>(
      A, b, x, zp, t, gamma, thr, done, res, M, N, K);
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
