// Hopper (sm_90a) kernel: fista_step on the lane-packed layout.
//
// Replaces the Pallas TPU kernel _fista_packed_step_kernel of
// proxtpu/kernels/lasso.py (lasso.py:1238, via fused_fista_packed_step):
// one full FISTA iteration for `pack` problems packed side by side in rows
// of W = pack N floats (kernels/lasso.py: pack_lasso_batch).  Problem
// i = q pack + j of packed group q has its row m's first nfull = 128
// floor(N / 128) columns at Ap[q, m, nfull j : nfull (j + 1)) and its other
// rem = N - nfull at Ap[q, m, pack nfull + rem j : pack nfull + rem (j + 1));
// x and z_prev (Bp, W) in the same column order; b (Bp, M, pack); the
// per-problem scalars and res, rs (Bp, pack), problem i at flat index i.
// On the TPU the layout strips the 128-lane padding of a 400-float row.
//
// What bounds it is what bounds fista_step (lasso_step.cu's note): reading
// A from device memory once a step, the same bytes in another order, plus
// b.  The design: one block a problem at fista_step's plan at the unpacked
// shape (step_plan(B = Bp pack, M, N)), and fista_step's body
// (fista_step_lane in lasso_step.cuh) on the packed addresses: the ring's
// fill gathers a tile's rows, two runs each, into the stage where
// fista_step's one run would land (common.cuh, TileRing with a RowMap), by
// bulk copies spread over the last warp's lanes where N % 4 == 0 (every run
// then starts and ends on 16 bytes), else by ordinary loads; b is gathered
// into shared memory; x and z_prev are read and written through the same
// column map; where no ring fits, the passes read the lane in place through
// it (common.cuh: tile_rows_dot, tile_col_fma).
// The passes, the epilogue and the order of every sum are fista_step's, so
// a step returns its bits on the unpacked operands: the packed route's
// counts are the natural route's to the digit.  float32 A only, no shrink:
// the TPU kernel takes neither a bf16 A nor the elastic net.
//
// Plain C interface for ctypes: launches on the given stream, does not
// synchronise, returns cudaGetLastError().

#include "lasso_step.cuh"

namespace {

using proxtpu::fista_step_lane;
using proxtpu::kFillBulk;
using proxtpu::kFillLoads;
using proxtpu::kFillNone;
using proxtpu::kOrderThreads;
using proxtpu::RowMap;
using proxtpu::step_blocks;
using proxtpu::threads_index;
using proxtpu::Variant;

template <int THREADS, int FILL>
__global__ void __launch_bounds__(THREADS, step_blocks(THREADS))
fista_packed_step_kernel(const float* __restrict__ Ap,
                         const float* __restrict__ bp, float* x, float* zp,
                         const float* __restrict__ beta,
                         const float* __restrict__ gamma,
                         const float* __restrict__ thr,
                         const float* __restrict__ done,
                         float* __restrict__ res, float* __restrict__ rs,
                         int M, int N, int pack, int R, int S, int restart) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ float scratch[2 * (kOrderThreads / 32)];

  const int q = blockIdx.x / pack, j = blockIdx.x % pack;
  const int nfull = N / 128 * 128, rem = N - nfull;
  const size_t W = (size_t)pack * N;
  // problem j's first run starts nfull j into a row; its second, at
  // pack nfull + rem j, lies gap entries past where one run would go on
  const size_t first = (size_t)nfull * j;
  const RowMap<true> map{W, nfull,
                         (size_t)nfull * (pack - 1 - j) + (size_t)rem * j};
  fista_step_lane<THREADS, FILL, float>(
      smem_raw, scratch, Ap + (size_t)q * M * W + first, map,
      bp + (size_t)q * M * pack + j, pack, x + q * W + first,
      zp + q * W + first, beta, gamma, thr, done, nullptr, res, rs, M, N, R,
      S, restart);
}

using PackedStep = void (*)(const float*, const float*, float*, float*,
                            const float*, const float*, const float*,
                            const float*, float*, float*, int, int, int, int,
                            int, int);

// 256, 512 and 1024 threads with a ring (bulk copy or ordinary loads), 256
// threads on a lane in place, as fista_step's float32 variants
Variant<PackedStep>* packed_variant(int threads, int fill) {
  static Variant<PackedStep> table[3][3] = {
      {{fista_packed_step_kernel<256, kFillBulk>},
       {fista_packed_step_kernel<256, kFillLoads>},
       {fista_packed_step_kernel<256, kFillNone>}},
      {{fista_packed_step_kernel<512, kFillBulk>},
       {fista_packed_step_kernel<512, kFillLoads>},
       {nullptr}},
      {{fista_packed_step_kernel<1024, kFillBulk>},
       {fista_packed_step_kernel<1024, kFillLoads>},
       {nullptr}}};
  return &table[threads_index(threads)][fill];
}

}  // namespace

extern "C" {

// B = Bp pack problems of (M, N), packed `pack` to a row; the plan is
// step_plan's at (B, M, N), checked as fista_step checks it (step_fill).
// Returns cudaErrorInvalidValue for a plan or a pack the kernel does not
// take; never launches another plan.
int proxtpu_fista_packed_step(const float* Ap, const float* bp, float* x,
                              float* zp, const float* beta,
                              const float* gamma, const float* thr,
                              const float* done, float* res, float* rs,
                              int B, int M, int N, int pack, int restart,
                              int threads, int R, int S, int smem_bytes,
                              void* stream) {
  const int fill =
      proxtpu::step_fill(Ap, M, N, threads, R, S, smem_bytes, sizeof(float));
  if (fill < 0 || pack < 1 || B % pack != 0)
    return (int)cudaErrorInvalidValue;
  return proxtpu::launch_step(packed_variant(threads, fill), B, threads,
                              smem_bytes, stream, Ap, bp, x, zp, beta, gamma,
                              thr, done, res, rs, M, N, pack, R, S, restart);
}

}  // extern "C"
