"""Batched TV denoising by Chambolle-Pock, with a hand-written Hopper
kernel (counterpart of ``proxtpu/kernels/tv.py``).

Per image the workload solves

    min_x  ||x - b||^2 / 2 + lam * ||grad x||_{2,1}

by Chambolle-Pock = AFBA(theta=2, f=0, l=Ind{0}).  With theta = 2 and
relaxation 1 the update is the textbook iteration

    xbar = prox_g(x - g1 * L^T y)                 g = ||. - b||^2 / 2
    ybar = proj_{|.| <= lam}(y + g2 * L (2 xbar - x))
    x, y <- xbar, ybar

with L the forward-difference 2-D gradient (Neumann boundary,
:class:`proxtpu_torch.ops.linops.Grad2DOperator`) and the dual prox the
pointwise projection onto the radius-lam 2-ball: what the generic driver
computes through ``convex_conjugate(NormL21)``.

The step has a plain PyTorch version (:func:`reference_cp_step`, and
:func:`mxu_cp_step` with the stencils as bidiagonal matrix products) and a
wrapper, :func:`fused_cp_k_steps`, over the CUDA kernel ``cp_k_steps`` in
``proxtpu_torch/csrc/tv_step.cu``, which runs K iterations per launch with
the state in shared memory.  The wrapper runs the plain version for tensors
on the CPU; for CUDA tensors it launches the kernel or raises on operands
the kernel does not take.  It counts its launches in its ``launches``
attribute.

Boundary: the divergence takes 0 above row 0 and left of column 0, the dual
field's last row (of yx) and last column (of yy) count as 0, and the forward
differences are 0 on the last row and column.  Both the kernel and the
plain versions SELECT 0 there (they do not multiply by a 0 mask), so a
non-finite value in a masked position does not spread.

Stopping rule: the AFBA driver's, ``||xbar - x||_inf + ||ybar - y||_inf <=
tol``, sampled every K iterations, so counts are upper bounds.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..utils.host_loop import run_host_loop
from ..utils.precision import require_full_f32_matmul
from . import _build

# planes of one tile in shared memory: b, x, yx, yy and mid = 2 xbar - x
_SMEM_PLANES = 5
# shared memory left to the kernel's static scratch
_SMEM_RESERVE = 1024


def _dual_ball(vx, vy, lamb):
    """Project the field (vx, vy) pointwise onto the radius-lam 2-ball."""
    nrm = torch.sqrt(vx * vx + vy * vy)
    scale = torch.where(nrm > lamb, lamb / torch.clamp(nrm, min=1e-30),
                        torch.ones_like(nrm))
    return vx * scale, vy * scale


def _residual(xbar, x, ybx, yx, yby, yy):
    return torch.amax(torch.abs(xbar - x), dim=(1, 2)) + torch.maximum(
        torch.amax(torch.abs(ybx - yx), dim=(1, 2)),
        torch.amax(torch.abs(yby - yy), dim=(1, 2)))


def reference_cp_step(b, x, yx, yy, g1, g2, lam):
    """Plain version of one Chambolle-Pock iteration for the batch.

    Args: b, x, yx, yy (B, H, W); g1, g2, lam (B,).
    Returns ``(xbar, ybx, yby, res)`` with ``res`` (B,) the step's
    ``||xbar - x||_inf + ||ybar - y||_inf``."""
    H, W = b.shape[1], b.shape[2]
    dev = b.device
    row_mask = (torch.arange(H, device=dev) < H - 1)[None, :, None]
    col_mask = (torch.arange(W, device=dev) < W - 1)[None, None, :]
    g1b = g1[:, None, None]
    g2b = g2[:, None, None]
    lamb = lam[:, None, None]
    zero = torch.zeros((), dtype=b.dtype, device=dev)

    # the roll wraps the last row (column) of dxm (dym), which is 0
    dxm = torch.where(row_mask, yx, zero)
    dym = torch.where(col_mask, yy, zero)
    div = (dxm - torch.roll(dxm, 1, dims=1)) + (dym - torch.roll(dym, 1,
                                                                 dims=2))
    t = x + g1b * div
    xbar = (t + g1b * b) / (1 + g1b)
    mid = 2 * xbar - x
    gx = torch.where(row_mask, torch.roll(mid, -1, dims=1) - mid, zero)
    gy = torch.where(col_mask, torch.roll(mid, -1, dims=2) - mid, zero)
    ybx, yby = _dual_ball(yx + g2b * gx, yy + g2b * gy, lamb)
    return xbar, ybx, yby, _residual(xbar, x, ybx, yx, yby, yy)


def _diff_matrix(n, dtype, device):
    """The (n, n) forward-difference matrix D: D[i, i] = -1, D[i, i+1] = +1
    for i < n - 1, last row zero.  The zero row is the Neumann boundary, so
    ``D @ U`` is the masked forward difference and ``D^T`` its adjoint."""
    d = torch.zeros((n, n), dtype=dtype, device=device)
    i = torch.arange(n - 1, device=device)
    d[i, i] = -1.0
    d[i, i + 1] = 1.0
    return d


def mxu_cp_step(b, x, yx, yy, g1, g2, lam, Dh=None, Dw=None):
    """One Chambolle-Pock iteration for the batch with the stencils as
    matrix products against bidiagonal difference matrices:
    ``grad = (Dh @ U, U @ Dw^T)`` and ``L^T y = Dh^T @ Yx + Yy @ Dw``.  The
    same function as :func:`reference_cp_step`; the products run in full
    float32 (the precision policy raises where TF32 is allowed)."""
    require_full_f32_matmul()
    H, W = b.shape[1], b.shape[2]
    if Dh is None:
        Dh = _diff_matrix(H, b.dtype, b.device)
    if Dw is None:
        Dw = _diff_matrix(W, b.dtype, b.device)
    g1b = g1[:, None, None]
    g2b = g2[:, None, None]
    lamb = lam[:, None, None]

    lty = torch.einsum("kh,bkw->bhw", Dh, yx) + torch.einsum(
        "bhk,kw->bhw", yy, Dw)
    t = x - g1b * lty
    xbar = (t + g1b * b) / (1 + g1b)
    mid = 2 * xbar - x
    gx = torch.einsum("hk,bkw->bhw", Dh, mid)
    gy = torch.einsum("bhk,wk->bhw", mid, Dw)
    ybx, yby = _dual_ball(yx + g2b * gx, yy + g2b * gy, lamb)
    return xbar, ybx, yby, _residual(xbar, x, ybx, yx, yby, yy)


def reference_cp_k_steps(b, x, yx, yy, g1, g2, lam, K=8, done=None,
                         step=reference_cp_step):
    """Plain version of K Chambolle-Pock iterations per image.  Images with
    ``done != 0`` keep their state and report 0.  Returns new tensors
    ``(x, yx, yy, res)``, ``res`` of the last step."""
    x_in, yx_in, yy_in = x, yx, yy
    for _ in range(K):
        x, yx, yy, res = step(b, x, yx, yy, g1, g2, lam)
    if done is not None:
        frozen = done != 0
        keep = frozen[:, None, None]
        x = torch.where(keep, x_in, x)
        yx = torch.where(keep, yx_in, yx)
        yy = torch.where(keep, yy_in, yy)
        res = torch.where(frozen, torch.zeros_like(res), res)
    return x, yx, yy, res


def tile_plan(H, W, K, smem_limit):
    """``(TH, TW)``: the tile of one thread block.  A whole image when its
    five planes fit in ``smem_limit`` bytes of shared memory; else balanced
    tiles whose halo of K cells per side still fits.  Raises if K leaves no
    room for a tile."""
    cells = (smem_limit - _SMEM_RESERVE) // (_SMEM_PLANES * 4)
    if H * W <= cells:
        return H, W
    side = math.isqrt(cells) - 2 * K
    if side < 8:
        raise ValueError(
            f"K = {K} steps per launch leave no room for a tile beside its "
            f"halo in {smem_limit} bytes of shared memory")

    def split(n):
        # an axis no longer than a tile is taken whole and needs no halo
        return n if n <= side else -(-n // -(-n // side))

    return split(H), split(W)


def _check_operands(b, planes, scalars):
    """Raise unless the kernel takes these operands: float32, contiguous,
    on b's CUDA device, b and ``planes`` (B, H, W), ``scalars`` (B,)."""
    if b.dim() != 3:
        raise ValueError(f"b must be (B, H, W), got shape {tuple(b.shape)}")
    B = b.shape[0]
    named = [("b", b, tuple(b.shape))]
    named += [(name, t, tuple(b.shape)) for name, t in planes]
    named += [(name, t, (B,)) for name, t in scalars]
    for name, t, shape in named:
        if not t.is_cuda or t.device != b.device:
            raise ValueError(f"{name} is on {t.device}; the kernel needs "
                             f"every operand on one CUDA device ({b.device})")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} is {t.dtype}; the kernel takes float32")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def fused_cp_k_steps(b, x, yx, yy, g1, g2, lam, K=8, done=None, out=None):
    """K Chambolle-Pock iterations for a batch of images in one launch of
    the ``cp_k_steps`` kernel (see :func:`reference_cp_k_steps`).

    Args:
      b, x, yx, yy: (B, H, W) noisy images, primal iterates and the two
        components of the dual field.  g1, g2, lam: (B,), each image's own
        stepsizes and weight.
      done: optional (B,) float.  0: the image is advanced.  1: it keeps
        its state (copied to the outputs) and reports res 0.  2 or more:
        as 1, and the caller vouches that ``out`` already holds the image's
        state, so nothing is copied.
      out: optional ``(x, yx, yy)`` buffers to write, distinct from the
        inputs (a tile reads the cells its neighbours write); new tensors
        are allocated when absent.

    Returns ``(x, yx, yy, res)``, ``res`` (B,) the last inner step's
    ``||xbar - x||_inf + ||ybar - y||_inf`` per image."""
    if K < 1:
        raise ValueError(f"K must be >= 1, got {K}")
    if b.device.type == "cpu":
        xn, yxn, yyn, res = reference_cp_k_steps(b, x, yx, yy, g1, g2, lam,
                                                 K, done)
        if out is not None:
            for o, n in zip(out, (xn, yxn, yyn)):
                o.copy_(n)
            xn, yxn, yyn = out
        return xn, yxn, yyn, res
    planes = [("x", x), ("yx", yx), ("yy", yy)]
    scalars = [("g1", g1), ("g2", g2), ("lam", lam)]
    if done is not None:
        scalars.append(("done", done))
    if out is None:
        out = tuple(torch.empty_like(b) for _ in range(3))
    planes += list(zip(("out x", "out yx", "out yy"), out))
    _check_operands(b, planes, scalars)
    ins = {t.data_ptr() for t in (b, x, yx, yy)}
    if any(o.data_ptr() in ins for o in out):
        raise ValueError("out must not alias b, x, yx or yy")
    B, H, W = b.shape
    TH, TW = tile_plan(H, W, K, _build.max_shared_bytes(b.device.index))
    res = torch.empty(B, dtype=b.dtype, device=b.device)
    # per image: the bit patterns of three running maxima and a ticket
    scratch = torch.zeros((B, 4), dtype=torch.int32, device=b.device)
    with torch.cuda.device(b.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _build.library().proxtpu_cp_k_steps(
            b.data_ptr(), x.data_ptr(), yx.data_ptr(), yy.data_ptr(),
            g1.data_ptr(), g2.data_ptr(), lam.data_ptr(),
            None if done is None else done.data_ptr(),
            out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
            res.data_ptr(), scratch.data_ptr(), B, H, W, int(K), TH, TW,
            ctypes.c_void_p(stream))
    _build.check(err, "cp_k_steps")
    fused_cp_k_steps.launches += 1
    return out[0], out[1], out[2], res


fused_cp_k_steps.launches = 0


def default_tv_stepsizes():
    """The AFBA theta = 2 default stepsizes for L = Grad2D (||L|| = sqrt 8,
    beta_f = beta_l = 0): g1 = 1 / ||L||, g2 = 0.99 / ||L||."""
    nmL = 8.0 ** 0.5
    return 1.0 / nmL, 0.99 / nmL


def _per_image(v, B, like):
    return torch.as_tensor(v, dtype=like.dtype, device=like.device) \
        .expand(B).contiguous()


def solve_tv_batch(b, lam, tol, maxit=5000, iter_block=8, gamma1=None,
                   gamma2=None, use_kernel=True, return_dual=False,
                   formulation="roll", x0=None, y0=None):
    """Batched TV denoising by iteration-blocked Chambolle-Pock.

    Same contract as ``proxtpu.kernels.tv.solve_tv_batch``: the generic
    AFBA/CP driver's trajectory and stopping rule (``||FPR_x||_inf +
    ||FPR_y||_inf <= tol``), sampled every ``iter_block`` iterations, so
    per-image counts are upper bounds (an image is never reported
    converged before it is), and the count includes the init step,
    iteration 1, as the driver's does.  A converged image is frozen.

    ``lam``, ``gamma1`` and ``gamma2`` are scalars or per-image (B,)
    vectors; the kernel reads all three per image, so per-image weights and
    stepsizes stay on the kernel route.  ``use_kernel=False`` runs the
    plain route, whose step ``formulation`` selects: ``"roll"``
    (:func:`reference_cp_step`) or ``"mxu"`` (:func:`mxu_cp_step`).
    ``x0`` (B, H, W) and ``y0`` (B, 2, H, W) warm-start the solve and are
    not written.

    Returns ``(x, iters, done)``, or ``((x, y), iters, done)`` with the
    (B, 2, H, W) dual field when ``return_dual``: the generic driver's
    solution structure."""
    B, H, W = b.shape
    K = int(iter_block)
    g1d, g2d = default_tv_stepsizes()
    g1 = _per_image(g1d if gamma1 is None else gamma1, B, b)
    g2 = _per_image(g2d if gamma2 is None else gamma2, B, b)
    lam_v = _per_image(lam, B, b)
    b = b.contiguous()

    x = (torch.zeros_like(b) if x0 is None
         else torch.as_tensor(x0, dtype=b.dtype, device=b.device)
         .reshape(B, H, W).contiguous())
    if y0 is None:
        yx = yy = torch.zeros_like(b)
    else:
        y0 = torch.as_tensor(y0, dtype=b.dtype, device=b.device) \
            .reshape(B, 2, H, W)
        yx, yy = y0[:, 0].contiguous(), y0[:, 1].contiguous()

    if use_kernel:
        # two sets of buffers, written in turn; the caller's x0 and y0 are
        # read by the init step only
        spare = [tuple(torch.empty_like(b) for _ in range(3))
                 for _ in range(2)]

        def k_steps(x, yx, yy, n, flags):
            return fused_cp_k_steps(b, x, yx, yy, g1, g2, lam_v, n, flags,
                                    out=spare.pop(0))
    else:
        if formulation == "mxu":
            Dh = _diff_matrix(H, b.dtype, b.device)
            Dw = _diff_matrix(W, b.dtype, b.device)
            step = lambda *a: mxu_cp_step(*a, Dh=Dh, Dw=Dw)  # noqa: E731
        elif formulation == "roll":
            step = reference_cp_step
        else:
            raise ValueError(f"formulation must be 'roll' or 'mxu', got "
                             f"{formulation!r}")

        def k_steps(x, yx, yy, n, flags):
            return reference_cp_k_steps(b, x, yx, yy, g1, g2, lam_v, n,
                                        flags, step=step)

    # init = one driver step (iteration 1)
    x, yx, yy, res = k_steps(x, yx, yy, 1, None)

    def body(k, state):
        x, yx, yy, done, held, iters = state
        # 0: live; 1: frozen, its state is copied to the buffers written
        # now; 2: frozen at the last call too, so those buffers hold it
        flags = done.to(b.dtype) + held.to(b.dtype)
        xn, yxn, yyn, res = k_steps(x, yx, yy, K, flags)
        if use_kernel:
            spare.append((x, yx, yy))
        iters = torch.where(done, iters, k)
        return xn, yxn, yyn, done | (res <= tol), done, iters

    done0 = res <= tol
    iters0 = torch.ones((B,), dtype=torch.int32, device=b.device)
    (x, yx, yy, done, _, iters), k = run_host_loop(
        body, (x, yx, yy, done0, torch.zeros_like(done0), iters0),
        lambda s: s[3], maxit, k_step=K)
    # K-blocked: an unconverged image may overshoot maxit by up to K - 1
    iters = torch.clamp(torch.where(done, iters, k), max=maxit)
    if return_dual:
        return (x, torch.stack([yx, yy], dim=1)), iters, done
    return x, iters, done
