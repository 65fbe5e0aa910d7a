"""Batched box-constrained QP by projected gradient, with hand-written
Hopper kernels (counterpart of ``proxtpu/kernels/box_qp.py``).

Per problem lane i, one step is

    z_i = clip(x_i - gamma_i (Q_i x_i + q_i), lo_i, hi_i)
    res_i = ||x_i - z_i||_inf

the projected-gradient step of the nonconvex box-QP family.  Each step has
a plain PyTorch version (``reference_*``) and a wrapper (``fused_*``) over a
CUDA kernel in ``proxtpu_torch/csrc/box_qp_step.cu``.  A wrapper runs the
plain version for tensors on the CPU; for CUDA tensors it launches its
kernel or raises on operands the kernel does not take.  Each wrapper counts
its launches in its ``launches`` attribute.  The wrappers update x in place
(the TPU kernels alias x to their output).

Both wrappers launch one kernel, ``pg_k_steps`` (``pg_step`` is K = 1), at
the launch plan of :func:`pg_plan`: the blocks of a cluster per lane and the
ring of row tiles of ``fista_k_steps`` (``kernels/lasso.py``), with Q read
once per inner step.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..utils.host_loop import run_host_loop
from ..utils.precision import require_full_f32_matmul
from ..utils.profiling import estimate, kernel_cost
from . import _build
from .lasso import MIN_SLAB_ROWS, _round_up, cluster_plan, ring_plan

# least rows of a lane one block of a cluster takes: the step reads each row
# of Q once (fista_k_steps reads a row of A twice), so what every block
# repeats per step (the cluster barrier, the copy of the other blocks' rows
# of x, the clip of its own) weighs twice as much per row
PG_MIN_SLAB_ROWS = 2 * MIN_SLAB_ROWS


def reference_pg_box_step(Q, q, x, gamma, lo, hi):
    """Plain version of the projected-gradient step.

    Args: Q (B, n, n) symmetric, q and x (B, n); gamma, lo, hi (B,).
    Returns ``(z (B, n), res_inf (B,))``."""
    require_full_f32_matmul()
    grad = torch.bmm(Q, x.unsqueeze(2)).squeeze(2) + q
    y = x - gamma[:, None] * grad
    z = torch.clamp(y, lo[:, None], hi[:, None])
    return z, torch.amax(torch.abs(x - z), dim=1)


def reference_pg_box_k_steps(Q, q, x, gamma, lo, hi, done_mask, K=8):
    """Plain version of K projected-gradient steps per lane; lanes with
    ``done_mask != 0`` keep x and report 0.  Returns new tensors
    ``(x (B, n), res_inf (B,))``, ``res_inf`` of the last step."""
    x_in = x
    for _ in range(K):
        x, res = reference_pg_box_step(Q, q, x, gamma, lo, hi)
    frozen = done_mask != 0
    return (torch.where(frozen[:, None], x_in, x),
            torch.where(frozen, torch.zeros_like(res), res))


def pg_shared_bytes(M, N, C, R, S):
    """Dynamic shared memory of one block of ``pg_k_steps`` for Q of M rows
    of N (M = N = n).  With a ring (S > 0): two buffers of x of N (rounded up
    to 4) floats, the gradient of the longest slab of ``ceil(M / C)`` rows
    (rounded up to 4), then on 128 bytes S stages of R rows (each rounded up
    to 128 bytes) and S 8-byte barriers.  With the tiles read in place
    (S = 0): x and the gradient, N + M floats.  The same sum as ``PgLayout``
    in csrc/box_qp_step.cu, which refuses a launch whose total differs."""
    if S == 0:
        return (N + M) * 4
    fixed = (2 * _round_up(N, 4) + _round_up(-(-M // C), 4)) * 4
    return _round_up(fixed, 128) + S * (_round_up(R * N * 4, 128) + 8)


def pg_plan(B, n, sms, limit):
    """``(C, R, S)``, the launch plan of ``pg_k_steps`` for a batch of B
    lanes of n on a device of ``sms`` SMs and ``limit`` bytes of shared
    memory per block: :func:`~proxtpu_torch.kernels.lasso.cluster_plan`'s
    blocks per lane with at least ``PG_MIN_SLAB_ROWS`` rows each, and
    :func:`~proxtpu_torch.kernels.lasso.ring_plan`'s ring on this kernel's
    layout; where no ring fits (``S == 0``), one block per lane reads tiles
    of a few rows in place, which takes n as large as ``2 n * 4 <= limit``
    allows."""
    C = cluster_plan(B, n, sms, PG_MIN_SLAB_ROWS)
    R, S = ring_plan(n, n, C, limit, pg_shared_bytes)
    return (C, R, S) if S else (1, R, S)


# the plan of a shape, computed once: pg_step runs once per iteration
cached_pg_plan = functools.lru_cache(maxsize=None)(pg_plan)


def _check_operands(Q, q, x, scalars):
    """Raise unless the kernels take these operands: float32, contiguous,
    on Q's CUDA device, Q (B, n, n), q and x (B, n), ``scalars`` (B,)."""
    if Q.dim() != 3 or Q.shape[1] != Q.shape[2]:
        raise ValueError(f"Q must be (B, n, n), got shape {tuple(Q.shape)}")
    B, n, _ = Q.shape
    named = [("Q", Q, (B, n, n)), ("q", q, (B, n)), ("x", x, (B, n))]
    named += [(name, t, (B,)) for name, t in scalars]
    for name, t, shape in named:
        if not t.is_cuda or t.device != Q.device:
            raise ValueError(f"{name} is on {t.device}; the kernel needs "
                             f"every operand on one CUDA device ({Q.device})")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} is {t.dtype}; the kernel takes float32")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _launch(name, Q, q, x, gamma, lo, hi, done_mask, K):
    """Launch ``pg_k_steps`` for K steps at Q's cached plan on the current
    stream of Q's device; x is updated in place.  Returns res (B,)."""
    B, n, _ = Q.shape
    index = Q.get_device()
    C, R, S = cached_pg_plan(B, n, _build.sm_count(index),
                             _build.max_shared_bytes(index))
    smem = pg_shared_bytes(n, n, C, R, S)
    _build.check_shared_bytes(smem, Q.device)
    res = torch.empty(B, dtype=x.dtype, device=x.device)
    with torch.cuda.device(Q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _build.library().proxtpu_pg_k_steps(
            Q.data_ptr(), q.data_ptr(), x.data_ptr(), gamma.data_ptr(),
            lo.data_ptr(), hi.data_ptr(),
            None if done_mask is None else done_mask.data_ptr(),
            res.data_ptr(), B, n, int(K), C, R, S, smem,
            ctypes.c_void_p(stream))
    _build.check(err, name)
    return res


def _freeze_in_place(x, z, res, done_mask):
    frozen = done_mask != 0
    x.copy_(torch.where(frozen[:, None], x, z))
    return torch.where(frozen, torch.zeros_like(res), res)


# The JAX package's pl.CostEstimate of each kernel (box_qp.py:98, :255),
# what the wrappers report to utils.profiling.compiled_stats.
def _pg_step_cost(Q, q, x, *args, **kwargs):
    B, n = x.shape
    return estimate(4 * B * n * n, B * n * n * Q.element_size())


def _pg_k_steps_cost(Q, q, x, gamma, lo, hi, done_mask, K=8):
    B, n = x.shape
    return estimate(8 * K * B * n * n, B * n * n * Q.element_size())


@kernel_cost("pg_step", _pg_step_cost)
def fused_pg_box_step(Q, q, x, gamma, lo, hi, done_mask=None):
    """One projected-gradient step for the batch through the ``pg_k_steps``
    kernel at K = 1 (see :func:`reference_pg_box_step`).  ``x`` is updated IN PLACE
    to z and returned.  ``done_mask`` (B,) float, optional: lanes with a
    nonzero entry keep x and report res 0.  Returns ``(x, res_inf)``."""
    if Q.device.type == "cpu":
        z, res = reference_pg_box_step(Q, q, x, gamma, lo, hi)
        if done_mask is None:
            done_mask = torch.zeros_like(res)
        return x, _freeze_in_place(x, z, res, done_mask)
    scalars = [("gamma", gamma), ("lo", lo), ("hi", hi)]
    if done_mask is not None:
        scalars.append(("done_mask", done_mask))
    _check_operands(Q, q, x, scalars)
    res = _launch("pg_step", Q, q, x, gamma, lo, hi, done_mask, 1)
    fused_pg_box_step.launches += 1
    return x, res


fused_pg_box_step.launches = 0


@kernel_cost("pg_k_steps", _pg_k_steps_cost)
def fused_pg_box_k_steps(Q, q, x, gamma, lo, hi, done_mask, K=8):
    """K projected-gradient steps for the batch in one launch of the
    ``pg_k_steps`` kernel (see :func:`reference_pg_box_k_steps`).  ``x`` is
    updated IN PLACE and returned.  Returns ``(x, res_inf)``, ``res_inf``
    of the last step."""
    if K < 1:
        raise ValueError(f"K must be >= 1, got {K}")
    if Q.device.type == "cpu":
        xn, res = reference_pg_box_k_steps(Q, q, x, gamma, lo, hi,
                                           done_mask, K)
        x.copy_(xn)
        return x, res
    _check_operands(Q, q, x, [("gamma", gamma), ("lo", lo), ("hi", hi),
                              ("done_mask", done_mask)])
    res = _launch("pg_k_steps", Q, q, x, gamma, lo, hi, done_mask, K)
    fused_pg_box_k_steps.launches += 1
    return x, res


fused_pg_box_k_steps.launches = 0


def _setup(Q, lo, hi, Lip, x0):
    """Per-lane gamma = 0.95 / Lip, lo, hi, and a fresh x0 buffer."""
    B, n, _ = Q.shape
    per_lane = lambda v: torch.as_tensor(v, dtype=Q.dtype, device=Q.device) \
        .expand(B).contiguous()
    gamma = 0.95 / per_lane(Lip)
    x0 = (torch.zeros((B, n), dtype=Q.dtype, device=Q.device) if x0 is None
          else torch.as_tensor(x0, dtype=Q.dtype, device=Q.device)
          .reshape(B, n).clone())
    return gamma, per_lane(lo), per_lane(hi), x0


def solve_box_qp_batch(Q, q, lo, hi, Lip, tol, maxit=10_000, use_kernel=True,
                       x0=None):
    """Batched projected gradient for box QPs.

    Same contract as ``proxtpu.kernels.box_qp.solve_box_qp_batch``:
    ``gamma = 0.95 / Lip`` per lane, stopping rule ``||x - z||_inf / gamma
    <= tol`` with per-lane freezing.  ``lo``, ``hi`` and ``Lip`` are scalars
    or (B,).  ``use_kernel=False`` runs the plain route.  Returns
    ``(xs (B, n), iters (B,) int32, done (B,) bool)``."""
    B = Q.shape[0]
    gamma, lo_v, hi_v, x = _setup(Q, lo, hi, Lip, x0)
    if use_kernel:
        x, res0 = fused_pg_box_step(Q, q, x, gamma, lo_v, hi_v)
    else:
        x, res0 = reference_pg_box_step(Q, q, x, gamma, lo_v, hi_v)

    def body(k, state):
        x, done, iters = state
        if use_kernel:
            x, res = fused_pg_box_step(Q, q, x, gamma, lo_v, hi_v,
                                       done.to(Q.dtype))
        else:
            z, res = reference_pg_box_step(Q, q, x, gamma, lo_v, hi_v)
            x = torch.where(done[:, None], x, z)
        iters = torch.where(done, iters, k)
        return x, done | (res / gamma <= tol), iters

    iters0 = torch.ones((B,), dtype=torch.int32, device=Q.device)
    (x, done, iters), k = run_host_loop(
        body, (x, res0 / gamma <= tol, iters0), lambda s: s[1], maxit)
    return x, torch.where(done, iters, k), done


def solve_box_qp_batch_blocked(Q, q, lo, hi, Lip, tol, maxit=10_000,
                               iter_block=8, x0=None, use_kernel=True):
    """Iteration-blocked batched projected gradient: one ``pg_step``, then
    :func:`fused_pg_box_k_steps` runs K = ``iter_block`` steps per launch.
    The stopping rule is sampled every K steps, so counts are upper bounds
    (clamped to ``maxit``) and solutions at least as converged as
    :func:`solve_box_qp_batch`'s.  ``use_kernel=False`` runs the plain
    route."""
    B = Q.shape[0]
    K = int(iter_block)
    gamma, lo_v, hi_v, x = _setup(Q, lo, hi, Lip, x0)
    if use_kernel:
        x, res0 = fused_pg_box_step(Q, q, x, gamma, lo_v, hi_v)
    else:
        x, res0 = reference_pg_box_step(Q, q, x, gamma, lo_v, hi_v)

    def body(k, state):
        x, done, iters = state
        dm = done.to(Q.dtype)
        if use_kernel:
            x, res = fused_pg_box_k_steps(Q, q, x, gamma, lo_v, hi_v, dm, K)
        else:
            x, res = reference_pg_box_k_steps(Q, q, x, gamma, lo_v, hi_v,
                                              dm, K)
        iters = torch.where(done, iters, k)
        return x, done | (res / gamma <= tol), iters

    iters0 = torch.ones((B,), dtype=torch.int32, device=Q.device)
    (x, done, iters), k = run_host_loop(
        body, (x, res0 / gamma <= tol, iters0), lambda s: s[1], maxit,
        k_step=K)
    # K-blocked: an unconverged lane may overshoot maxit by up to K - 1
    return x, torch.clamp(torch.where(done, iters, k), max=maxit), done
