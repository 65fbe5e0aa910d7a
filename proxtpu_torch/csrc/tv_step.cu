// Hopper (sm_90a) kernel for K Chambolle-Pock iterations of TV denoising.
//
// Replaces the Pallas TPU kernel of proxtpu/kernels/tv.py:
//   cp_k_steps <- _cp_k_steps_kernel (tv.py:76, body _cp_body, via
//                 fused_cp_k_steps)
//
// Per image i, with b, x, yx, yy (H, W) row-major f32 and the image's own
// g1, g2, lam, one iteration is
//   div  = (dxm - dxm[r-1]) + (dym - dym[c-1])   dxm = yx, 0 on the last row
//                                                dym = yy, 0 on the last col
//   xbar = ((x + g1 div) + g1 b) / (1 + g1)
//   mid  = 2 xbar - x
//   gx   = mid[r+1] - mid (0 on the last row);  gy likewise along columns
//   v    = y + g2 (gx, gy);  n = sqrt(vx^2 + vy^2)
//   ybar = v * (n > lam ? lam / max(n, 1e-30) : 1)
// and res = max|xbar - x| + max(max|ybx - yx|, max|yby - yy|) of the last
// of the K iterations.  Boundary values are SELECTED as 0, never multiplied
// by a 0 mask: the cell outside is not read.  Every operation is rounded on
// its own (__fmul_rn, __fadd_rn, IEEE division and square root, no fma
// contraction), in the plain version's order.
//
// The TPU kernel packed 128 / W images side by side to fill its lanes,
// masked the seams, wrote six planes (the last and the previous state) and
// left the residual to XLA.  Here a block works on the natural (H, W)
// layout of one image, keeps the previous step's values in registers for
// the residual, reduces it in the block and writes three planes.
//
// Bound: four planes read and three written per launch, whatever K; the K
// iterations run on five planes (b, x, yx, yy, mid) in shared memory with
// two barriers each.  Shared memory decides the shape of the work:
//   * an image whose five planes fit (64 x 64: 80 KB) is one block's tile;
//   * a larger image (256 x 256: 1.3 MB) is cut into tiles.  One iteration
//     reaches one cell in each direction, so a block loads its tile with a
//     halo of K cells per side, clipped to the image, runs the K steps on
//     all of it and stores the tile alone.  After step s the cells within s
//     of a clipped-off side are wrong (a neighbour outside the region was
//     not loaded and counted as 0); they never reach the tile.  Where the
//     halo ends at the image's edge the 0 is the true boundary.
//     Neighbouring blocks read what others write, so the output buffers
//     must not be the inputs.
// The residual of a tiled image is combined by atomicMax on the bit pattern
// of the non-negative maxima (order-independent, NaN kept as the largest
// pattern) in a zeroed scratch; the block that draws the last ticket of its
// image writes res.
//
// A frozen image (done != 0) is not advanced and reports res 0: with
// done == 1 its state is copied to the outputs, with done >= 2 the caller
// vouches that the outputs hold it already and the block returns at once.
//
// Plain C interface for ctypes.  The entry launches on the given stream,
// does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using proxtpu::nanmax;
using proxtpu::prepare;
using proxtpu::warp_nanmax;

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

// (r, c) of the cell kThreads after (r, c) in a region ew wide, where
// kThreads = dr * ew + dc
__device__ __forceinline__ void next_cell(int& r, int& c, int dr, int dc,
                                          int ew) {
  r += dr;
  c += dc;
  if (c >= ew) {
    c -= ew;
    ++r;
  }
}

__global__ void __launch_bounds__(kThreads)
cp_k_steps_kernel(const float* __restrict__ b, const float* __restrict__ x,
                  const float* __restrict__ yx, const float* __restrict__ yy,
                  const float* __restrict__ g1v,
                  const float* __restrict__ g2v,
                  const float* __restrict__ lamv,
                  const float* __restrict__ done, float* __restrict__ xo,
                  float* __restrict__ yxo, float* __restrict__ yyo,
                  float* __restrict__ res, unsigned int* __restrict__ scratch,
                  int H, int W, int K, int TH, int TW, int tiles_r,
                  int tiles_c, int max_cells) {
  extern __shared__ float smem[];
  __shared__ float red[3 * kWarps];

  const int tiles = tiles_r * tiles_c;
  const int i = blockIdx.x / tiles;
  const int t = blockIdx.x % tiles;
  // the tile, and the region loaded for it: the tile plus K cells per
  // side, clipped to the image
  const int r0 = (t / tiles_c) * TH, c0 = (t % tiles_c) * TW;
  const int r1 = min(H, r0 + TH), c1 = min(W, c0 + TW);
  const int er0 = max(0, r0 - K), ec0 = max(0, c0 - K);
  const int eh = min(H, r1 + K) - er0, ew = min(W, c1 + K) - ec0;
  const int cells = eh * ew;
  const size_t base = (size_t)i * H * W;

  const float frozen = done != nullptr ? done[i] : 0.f;
  if (frozen != 0.f) {
    if (frozen < 2.f) {  // copy the tile; at 2 the outputs hold it already
      const int th = r1 - r0, tw = c1 - c0;
      for (int idx = threadIdx.x; idx < th * tw; idx += kThreads) {
        const size_t g = base + (size_t)(r0 + idx / tw) * W + c0 + idx % tw;
        xo[g] = x[g];
        yxo[g] = yx[g];
        yyo[g] = yy[g];
      }
    }
    if (t == 0 && threadIdx.x == 0) res[i] = 0.f;
    return;
  }

  float* bs = smem;
  float* xs = bs + max_cells;
  float* yxs = xs + max_cells;
  float* yys = yxs + max_cells;
  float* ms = yys + max_cells;

  for (int idx = threadIdx.x; idx < cells; idx += kThreads) {
    const size_t g = base + (size_t)(er0 + idx / ew) * W + ec0 + idx % ew;
    bs[idx] = b[g];
    xs[idx] = x[g];
    yxs[idx] = yx[g];
    yys[idx] = yy[g];
  }
  const float g1 = g1v[i], g2 = g2v[i], lam = lamv[i];
  const float one_g1 = __fadd_rn(1.f, g1);
  // the tile inside the loaded region
  const int ir0 = r0 - er0, ir1 = r1 - er0, ic0 = c0 - ec0, ic1 = c1 - ec0;
  // the image's last row and column in the region's coordinates
  const int img_last_r = H - 1 - er0, img_last_c = W - 1 - ec0;
  float mx = 0.f, myx = 0.f, myy = 0.f;
  // a thread's cells lie kThreads apart: their rows and columns follow from
  // the first by additions, with no division in the loops
  const int tr = threadIdx.x / ew, tc = threadIdx.x % ew;
  const int dr = kThreads / ew, dc = kThreads % ew;
  __syncthreads();

  for (int step = 0; step < K; ++step) {
    const bool last = step == K - 1;
    // primal half: xbar over x, mid beside it; reads y of the cell, the
    // one above and the one to the left
    int r = tr, c = tc;
    for (int idx = threadIdx.x; idx < cells; idx += kThreads) {
      // the dual field's own cell is always loaded, so its mask is the
      // image's last row and column, not the region's: masking at a
      // clipped-off side would put one more wrong row into y than the
      // halo has room for
      const float dxm = r < img_last_r ? yxs[idx] : 0.f;
      const float dym = c < img_last_c ? yys[idx] : 0.f;
      const float up = r > 0 ? yxs[idx - ew] : 0.f;
      const float left = c > 0 ? yys[idx - 1] : 0.f;
      const float div = __fadd_rn(__fsub_rn(dxm, up), __fsub_rn(dym, left));
      const float xv = xs[idx];
      const float tt = __fadd_rn(xv, __fmul_rn(g1, div));
      const float xbar =
          __fdiv_rn(__fadd_rn(tt, __fmul_rn(g1, bs[idx])), one_g1);
      ms[idx] = __fsub_rn(__fmul_rn(2.f, xbar), xv);
      xs[idx] = xbar;
      if (last && r >= ir0 && r < ir1 && c >= ic0 && c < ic1)
        mx = nanmax(mx, fabsf(__fsub_rn(xbar, xv)));
      next_cell(r, c, dr, dc, ew);
    }
    __syncthreads();  // mid complete; every read of the old y done
    // dual half: reads mid of the cell, the one below and the one to the
    // right; writes the cell's own y only
    r = tr;
    c = tc;
    for (int idx = threadIdx.x; idx < cells; idx += kThreads) {
      const float m = ms[idx];
      const float gx = r < eh - 1 ? __fsub_rn(ms[idx + ew], m) : 0.f;
      const float gy = c < ew - 1 ? __fsub_rn(ms[idx + 1], m) : 0.f;
      const float yxv = yxs[idx], yyv = yys[idx];
      const float vx = __fadd_rn(yxv, __fmul_rn(g2, gx));
      const float vy = __fadd_rn(yyv, __fmul_rn(g2, gy));
      const float nrm =
          __fsqrt_rn(__fadd_rn(__fmul_rn(vx, vx), __fmul_rn(vy, vy)));
      const float scale =
          nrm > lam ? __fdiv_rn(lam, fmaxf(nrm, 1e-30f)) : 1.f;
      const float ybx = __fmul_rn(vx, scale), yby = __fmul_rn(vy, scale);
      yxs[idx] = ybx;
      yys[idx] = yby;
      if (last && r >= ir0 && r < ir1 && c >= ic0 && c < ic1) {
        myx = nanmax(myx, fabsf(__fsub_rn(ybx, yxv)));
        myy = nanmax(myy, fabsf(__fsub_rn(yby, yyv)));
      }
      next_cell(r, c, dr, dc, ew);
    }
    __syncthreads();  // y complete; every read of mid done
  }

  const int tw = c1 - c0;
  for (int idx = threadIdx.x; idx < (r1 - r0) * tw; idx += kThreads) {
    const int r = idx / tw, c = idx % tw;
    const size_t g = base + (size_t)(r0 + r) * W + c0 + c;
    const int s = (ir0 + r) * ew + ic0 + c;
    xo[g] = xs[s];
    yxo[g] = yxs[s];
    yyo[g] = yys[s];
  }

  // the tile's three maxima, then the image's
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  mx = warp_nanmax(mx);
  myx = warp_nanmax(myx);
  myy = warp_nanmax(myy);
  if (lane == 0) {
    red[warp] = mx;
    red[kWarps + warp] = myx;
    red[2 * kWarps + warp] = myy;
  }
  __syncthreads();
  if (warp == 0) {
    mx = warp_nanmax(red[lane]);
    myx = warp_nanmax(red[kWarps + lane]);
    myy = warp_nanmax(red[2 * kWarps + lane]);
    if (lane == 0) {
      unsigned int* s = scratch + 4 * (size_t)i;
      atomicMax(s + 0, __float_as_uint(mx));
      atomicMax(s + 1, __float_as_uint(myx));
      atomicMax(s + 2, __float_as_uint(myy));
      __threadfence();
      if (atomicAdd(s + 3, 1u) == (unsigned int)tiles - 1) {
        __threadfence();
        const float ax = __uint_as_float(atomicMax(s + 0, 0u));
        const float ayx = __uint_as_float(atomicMax(s + 1, 0u));
        const float ayy = __uint_as_float(atomicMax(s + 2, 0u));
        res[i] = __fadd_rn(ax, nanmax(ayx, ayy));
      }
    }
  }
}

}  // namespace

extern "C" {

// scratch: (B, 4) unsigned ints, zeroed by the caller.  done may be NULL
// (every image advanced).  (TH, TW): the tile of one block; a tile's loaded
// region, (TH + 2K) x (TW + 2K) clipped to the image, must fit the device's
// shared memory five times over.
int proxtpu_cp_k_steps(const float* b, const float* x, const float* yx,
                       const float* yy, const float* g1, const float* g2,
                       const float* lam, const float* done, float* xo,
                       float* yxo, float* yyo, float* res,
                       unsigned int* scratch, int B, int H, int W, int K,
                       int TH, int TW, void* stream) {
  const int tiles_r = (H + TH - 1) / TH, tiles_c = (W + TW - 1) / TW;
  const int eh = min(H, TH + 2 * K), ew = min(W, TW + 2 * K);
  const int max_cells = eh * ew;
  const size_t smem = (size_t)5 * max_cells * sizeof(float);
  cudaError_t err = prepare(cp_k_steps_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)B * tiles_r * tiles_c;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  cp_k_steps_kernel<<<(unsigned int)blocks, kThreads, smem,
                      (cudaStream_t)stream>>>(
      b, x, yx, yy, g1, g2, lam, done, xo, yxo, yyo, res, scratch, H, W, K,
      TH, TW, tiles_r, tiles_c, max_cells);
  return (int)cudaGetLastError();
}

}  // extern "C"
