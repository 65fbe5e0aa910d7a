"""Kernel-route dispatch for batched solves (counterpart of
``match_kernel_solver`` in ``proxtpu/kernels/dispatch.py``).

The generic driver runs any algorithm on any problem; the batched lasso
FISTA and box-QP projected-gradient problems have kernel solvers.
:func:`match_kernel_solver` recognises those problems structurally (factory,
function classes, options at their defaults) and returns a runner, or
``None`` when the problem does not match exactly: the caller then takes the
generic driver.  Dispatch changes how a solve runs, never what it returns:
the same fixed points and stopping rule; per-lane counts within +-1 (the
f32 last-bit boundary), and up to ``iter_block - 1`` more on the blocked
routes, whose counts are upper bounds.

Routing reads shapes and dtypes only, never the device: the device decides
only whether each kernel wrapper launches its kernel (CUDA) or runs its
plain version (CPU).  The reference's rules are kept, with two changes:

* float32 below the 1 MB-per-lane blocked threshold always takes a kernel
  route.  The reference sent small problems to XLA because XLA's batched
  matmul beat its kernel on a v5e (``dispatch.py:668-676``, ``:767-771``),
  a measurement of that chip, not a semantic rule.
* The shared-A leg (one A, many right-hand sides: ``solve_lasso_multirhs``)
  is not ported; such a problem returns ``None`` and the generic driver
  solves it.
"""

from __future__ import annotations

import math

import torch

# the blocked routes' threshold: bytes of A (or Q) per lane
BLOCKED_LANE_BYTES = 1 << 20
# packed route: at most this many bytes of A per group of `pack` lanes
PACKED_GROUP_BYTES = 4 << 20


def _scalar_or_vec(v, B, dtype, device):
    """A scalar or (B,) parameter as a (B,) tensor, or None."""
    t = torch.as_tensor(v, device=device)
    if t.dim() == 0:
        return torch.full((B,), float(t), dtype=dtype, device=device)
    if tuple(t.shape) == (B,):
        return t.to(dtype)
    return None


def _pack_count(N, B):
    """Problems per packed row of the reference's packed layout: p =
    128/gcd(N, 128), or 1 when N is lane-aligned, N < 128 or p does not
    divide B (``proxtpu/kernels/lasso.py:1176``).  The port runs the natural
    layout, but the count still decides, as in the reference, which
    problems take the packed solver."""
    p = 128 // math.gcd(N, 128)
    if p == 1 or B % p != 0 or N < 128:
        return 1
    return p


def _restart_of(seq):
    """True for ``AdaptiveRestartSequence`` around the default t-recursion,
    False for no sequence, None for any other sequence."""
    if seq is None:
        return False
    from ..accel.nesterov import (
        AdaptiveNesterovSequence,
        AdaptiveRestartSequence,
        FixedNesterovSequence,
    )

    inner = getattr(seq, "sequence", None)
    if isinstance(seq, AdaptiveRestartSequence) and (
            isinstance(inner, FixedNesterovSequence)
            or (isinstance(inner, AdaptiveNesterovSequence)
                and float(inner.m) == 0.0)):
        return True
    return None


def match_kernel_solver(factory, kwargs, *, tol, maxit, stop=None,
                        solution=None, iter_block=8):
    """``run() -> (xs, iters, done)`` for a kernel-route problem, or
    ``None``.

    Recognised:

    * ``make_fast_forward_backward_iteration`` + ``LeastSquaresLoss`` or
      ``LeastSquares`` (stacked A (B, M, N), b (B, M), lam = 1) +
      ``NormL1`` or ``ElasticNet`` + a fixed step (``Lf`` or ``gamma``) +
      x0 + the default sequence or adaptive restart around it, optionally
      a scalar ``mf > 0``  ->  the lasso solvers;
    * ``make_forward_backward_iteration`` + ``Quadratic`` (stacked Q, q) +
      ``IndBox`` (finite scalar bounds) + a fixed step  ->  the box-QP
      solvers.
    """
    if stop is not None or solution is not None:
        return None
    if kwargs.get("adaptive"):
        return None
    seq = kwargs.get("extrapolation_sequence")
    restart = _restart_of(seq)
    if restart is None:
        return None
    # mf > 0 (a scalar) rides the lasso kernels as a constant coefficient;
    # an array-valued mf takes the generic driver
    mf_raw = kwargs.get("mf", 0.0)
    if mf_raw is not None and torch.as_tensor(mf_raw).dim() != 0:
        return None
    mf = 0.0 if mf_raw is None else float(mf_raw)
    mf = mf if mf > 0.0 else None
    if mf is not None and seq is not None:
        return None
    x0 = kwargs.get("x0")
    if x0 is None:
        return None
    x0 = torch.as_tensor(x0)
    x0_pass = x0 if bool(x0.any()) else None

    from ..utils.shared import Shared

    f, g = kwargs.get("f"), kwargs.get("g")
    name = getattr(factory, "__name__", "")

    if name == "make_fast_forward_backward_iteration":
        from ..prox.functions import (
            ElasticNet,
            LeastSquares,
            LeastSquaresLoss,
            NormL1,
        )

        if isinstance(f, Shared):
            f = f.value
        if isinstance(g, Shared):
            g = g.value
        if not isinstance(f, (LeastSquares, LeastSquaresLoss)):
            return None
        if isinstance(g, ElasticNet):
            g_l1, g_lam2 = g.mu, g.lam
        elif isinstance(g, NormL1):
            g_l1, g_lam2 = g.lam, None
        else:
            return None
        if g_lam2 is not None and mf is not None:
            return None
        A, b = torch.as_tensor(f.A), torch.as_tensor(f.b)
        # a 2-D A shared by every lane is the multi-right-hand-side leg,
        # not ported: the generic driver solves it
        if A.dim() != 3 or b.dim() != 2 or A.shape[0] != b.shape[0]:
            return None
        B = A.shape[0]
        if not bool((torch.as_tensor(getattr(f, "lam", 1.0)) == 1.0).all()):
            return None
        lam = _scalar_or_vec(g_l1, B, A.dtype, A.device)
        if lam is None:
            return None
        lam2 = (None if g_lam2 is None
                else _scalar_or_vec(g_lam2, B, A.dtype, A.device))
        if g_lam2 is not None and lam2 is None:
            return None
        Lf, gamma = kwargs.get("Lf"), kwargs.get("gamma")
        if gamma is not None:
            Lfv = _scalar_or_vec(gamma, B, A.dtype, A.device)
            Lfv = None if Lfv is None else 1.0 / Lfv
        elif Lf is not None:
            Lfv = _scalar_or_vec(Lf, B, A.dtype, A.device)
        else:
            return None  # a fixed-step solve needs an explicit stepsize
        if Lfv is None:
            return None
        if tuple(x0.shape) != (A.shape[0], A.shape[2]):
            return None

        from . import lasso

        lane_bytes = A.shape[1] * A.shape[2] * A.element_size()
        pack = _pack_count(A.shape[2], B)
        packable = pack > 1 and pack * lane_bytes <= PACKED_GROUP_BYTES
        # the kernels take float32; float64 takes the plain route
        f32 = A.dtype == torch.float32

        def run():
            if (f32 and lane_bytes >= BLOCKED_LANE_BYTES and mf is None
                    and lam2 is None):
                return lasso.solve_lasso_batch_blocked(
                    A, b, lam, Lfv, tol, maxit=maxit, iter_block=iter_block,
                    restart=restart, x0=x0_pass)
            if f32 and packable and lam2 is None:
                return lasso.solve_lasso_batch_packed(
                    A, b, lam, Lfv, tol, maxit=maxit, restart=restart,
                    x0=x0_pass, mf=mf)
            return lasso.solve_lasso_batch(
                A, b, lam, Lfv, tol, maxit=maxit, use_kernel=f32,
                restart=restart, x0=x0_pass, mf=mf, lam2=lam2)

        return run

    if name == "make_forward_backward_iteration":
        from ..prox.functions import IndBox, Quadratic

        if seq is not None or mf is not None:
            return None  # plain FB has no momentum to restart or tune
        if not isinstance(f, Quadratic) or not isinstance(g, IndBox):
            return None
        Q, q = torch.as_tensor(f.Q), torch.as_tensor(f.q)
        if Q.dim() != 3 or q.dim() != 2 or Q.shape[1] != Q.shape[2]:
            return None
        B = Q.shape[0]
        lo, hi = torch.as_tensor(g.low), torch.as_tensor(g.high)
        if lo.dim() != 0 or hi.dim() != 0 or not (
                bool(torch.isfinite(lo)) and bool(torch.isfinite(hi))):
            return None
        lo, hi = float(lo), float(hi)
        gamma, Lf = kwargs.get("gamma"), kwargs.get("Lf")
        if gamma is not None:
            gv = _scalar_or_vec(gamma, B, Q.dtype, Q.device)
        elif Lf is not None:
            Lfv = _scalar_or_vec(Lf, B, Q.dtype, Q.device)
            gv = None if Lfv is None else 1.0 / Lfv
        else:
            return None
        if gv is None:
            return None
        Lip = 0.95 / gv  # the solvers set gamma = 0.95 / Lip per lane
        if tuple(x0.shape) != tuple(q.shape):
            return None

        from . import box_qp

        blocked = Q.shape[1] ** 2 * Q.element_size() >= BLOCKED_LANE_BYTES
        f32 = Q.dtype == torch.float32

        def run():
            if f32 and blocked:
                return box_qp.solve_box_qp_batch_blocked(
                    Q, q, lo, hi, Lip, tol, maxit=maxit,
                    iter_block=iter_block, x0=x0_pass)
            return box_qp.solve_box_qp_batch(
                Q, q, lo, hi, Lip, tol, maxit=maxit, use_kernel=f32,
                x0=x0_pass)

        return run

    return None
