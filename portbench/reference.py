"""The benchmark's plain references, in PyTorch alone.

Nothing here imports the program (``proxtpu_torch``), JAX or the JAX
package: these functions take the inputs the benchmark made and work out
everything from them.  They judge the program's answers and, at a lower
precision, stand in for the program as the control of the check.

* :func:`recheck` — the certificate of a lasso answer: the forward-backward
  residual ``||x - prox(x - grad f(x) / Lf)||_inf * Lf`` of every lane, in
  float64 (the arithmetic of ``chip_smoke.py::recheck`` and of
  ``bench.py``'s gate, carried out in float64 on the device);
* :func:`fista` — batched FISTA with per-lane freezing, optional adaptive
  restart and a convergence test sampled every ``K`` iterations, the
  semantics of the program's one-step and blocked lasso solvers;
* :func:`packed_tail` — the two-phase schedule of the main path on top of
  :func:`fista`;
* :func:`lipschitz_upper` — ``||A||_2^2`` from above, in float64;
* :func:`round_tf32` — float32 rounded to TF32's 10 mantissa bits, the
  precision of the control.
"""

from __future__ import annotations

import math

import torch

# t after a restart: the t-sequence one step from t = 1
PHI = (1 + math.sqrt(5.0)) / 2

PRECISIONS = ("exact", "tf32")

# the most bytes a float64 copy of one chunk of A may take: the float64
# work of set-up (lam, Lf) and of the check runs over the lanes in chunks
CHUNK_BYTES = 1 << 30


def chunks(A):
    """Slices of A's lanes, each so many that a float64 copy of them
    takes at most :data:`CHUNK_BYTES` (at least one lane a chunk)."""
    B = A.shape[0]
    per = max(1, CHUNK_BYTES // (8 * A[0].numel()))
    return [slice(s, s + per) for s in range(0, B, per)]


def round_tf32(t):
    """float32 ``t`` rounded to nearest (ties to even) at TF32's 10
    mantissa bits, as the tensor cores round a TF32 operand."""
    i = t.contiguous().view(torch.int32)
    lsb = (i >> 13) & 1
    return ((i + 0x0FFF + lsb) & ~0x1FFF).view(torch.float32)


def at_precision(t, prec):
    """``t`` as a product takes it at ``prec``."""
    if prec == "exact":
        return t
    if prec == "tf32":
        return round_tf32(t)
    raise ValueError(f"precision {prec!r} is not one of {PRECISIONS}")


def _bmv(A, x, prec):
    """A (B, M, N) @ x (B, N) -> (B, M); A is at ``prec`` already."""
    return torch.bmm(A, at_precision(x, prec).unsqueeze(2)).squeeze(2)


def _bmtv(A, r, prec):
    """A (B, M, N)^T @ r (B, M) -> (B, N); A is at ``prec`` already."""
    return torch.bmm(at_precision(r, prec).unsqueeze(1), A).squeeze(1)


def soft_threshold(y, thr):
    return torch.sign(y) * torch.clamp(torch.abs(y) - thr, min=0.0)


def fb_step(A, b, x, gamma, thr, prec="exact"):
    """The forward-backward step of every lane: ``(z, ||x - z||_inf)``;
    A is given at ``prec``, the vectors are rounded to it here."""
    grad = _bmtv(A, _bmv(A, x, prec) - b, prec)
    z = soft_threshold(x - gamma[:, None] * grad, thr[:, None])
    return z, torch.amax(torch.abs(x - z), dim=1)


def recheck(A, b, lam, Lf, x):
    """Per-lane certificate ``||x - prox(x - grad / Lf)||_inf * Lf`` of the
    lasso ``1/2 ||A x - b||^2 + lam ||x||_1``, in float64, over
    :func:`chunks` of the lanes.  Returns (B,) float64."""
    out = []
    for sl in chunks(A):
        gam = 1.0 / Lf[sl].double()
        _, res = fb_step(A[sl].double(), b[sl].double(), x[sl].double(), gam,
                         gam * lam[sl].double())
        out.append(res / gam)
    return torch.cat(out)


def fista(A, b, lam, Lf, tol, maxit, *, x0=None, restart=False, K=1,
          prec="exact", dtype=torch.float64):
    """Batched FISTA on the lasso, every lane on its own.

    Iteration 1 is the forward-backward step from ``x0`` (zeros by
    default); each later one is the step at the extrapolated point, with
    ``t' = (1 + sqrt(1 + 4 t^2)) / 2`` and ``beta = (t - 1) / t'``, and,
    with ``restart``, ``beta = 0, t' = PHI`` where ``<x - z, z - z_prev> >
    0``.  A lane is done once ``||x - z||_inf * Lf <= tol`` at a test; the
    test comes after every iteration (``K = 1``) or after every block of
    ``K`` (lanes live at a block's start run all ``K``; a count is then the
    block's end, clamped to ``maxit``).  Done lanes keep their state.
    Products take their operands at ``prec`` and the state is in
    ``dtype``.  Returns ``(z (B, N), iters (B,) int32, done (B,) bool)``.
    """
    A, b = at_precision(A.to(dtype), prec), b.to(dtype)
    B, _, N = A.shape
    gamma = 1.0 / Lf.to(dtype)
    thr = gamma * lam.to(dtype)
    x = (torch.zeros((B, N), dtype=dtype, device=A.device) if x0 is None
         else x0.to(dtype))
    z, res = fb_step(A, b, x, gamma, thr, prec)
    x, z_prev = z, z
    t = torch.full((B,), PHI, dtype=dtype, device=A.device)
    done = res / gamma <= tol
    iters = torch.ones((B,), dtype=torch.int32, device=A.device)
    k = 1
    while k < maxit and not bool(done.all()):
        live = ~done
        for _ in range(K):
            z, res = fb_step(A, b, x, gamma, thr, prec)
            t_new = (1 + torch.sqrt(1 + 4 * t * t)) / 2
            beta = (t - 1) / t_new
            if restart:
                rs = torch.sum((x - z) * (z - z_prev), dim=1)
                beta = torch.where(rs > 0, 0.0, beta)
                t_new = torch.where(rs > 0, PHI, t_new)
            x_new = z + beta[:, None] * (z - z_prev)
            keep = (~live)[:, None] if K > 1 else done[:, None]
            x = torch.where(keep, x, x_new)
            z_prev = torch.where(keep, z_prev, z)
            t = torch.where(~live if K > 1 else done, t, t_new)
            if K == 1:
                k += 1
                iters = torch.where(done, iters, k)
                done = done | (res / gamma <= tol)
        if K > 1:
            k += K
            iters = torch.where(done, iters, k)
            done = done | (live & (res / gamma <= tol))
    iters = torch.where(done, iters, k)
    return z_prev, torch.clamp(iters, max=maxit), done


def packed_tail(A, b, lam, Lf, tol, maxit, *, k1, tail, restart,
                prec="exact", dtype=torch.float64):
    """The main path's two phases: :func:`fista` for ``k1`` iterations
    over every lane; then, where more than ``tail`` lanes are left, every
    lane again from its phase-1 answer at full width (counts add up, lanes
    done in phase 1 keep their phase-1 answer and count); otherwise the
    ``tail`` slowest lanes (the unconverged first, in lane order; then
    done lanes, which keep their phase-1 answer and count).  Returns
    ``(z, iters, done)`` in ``dtype``."""
    k1 = min(k1, maxit)
    xs1, it1, dn1 = fista(A, b, lam, Lf, tol, k1, restart=restart,
                          prec=prec, dtype=dtype)
    if k1 >= maxit:
        return xs1, it1, dn1
    B = A.shape[0]
    if B - int(dn1.sum()) > tail:
        xs2, it2, dn2 = fista(A, b, lam, Lf, tol, maxit - k1, x0=xs1,
                              restart=restart, prec=prec, dtype=dtype)
        return (torch.where(dn1[:, None], xs1, xs2),
                torch.where(dn1, it1, it1 + it2), dn1 | dn2)
    idx = torch.argsort(dn1.to(torch.int32), stable=True)[:tail]
    was = dn1[idx]
    xs2, it2, dn2 = fista(A[idx], b[idx], lam[idx], Lf[idx], tol,
                          maxit - k1, x0=xs1[idx], restart=restart,
                          prec=prec, dtype=dtype)
    xs2 = torch.where(was[:, None], xs1[idx], xs2)
    xs = xs1.index_copy(0, idx, xs2)
    iters = it1.index_add(0, idx, torch.where(was, 0, it2).to(it1.dtype))
    done = dn1.index_copy(0, idx, was | dn2)
    return xs, iters, done


# tr(G^p)^(1/p) with p = 2^SQUARINGS bounds lambda_max(G) from above
SQUARINGS = 20


def lipschitz_upper(A):
    """``||A_i||_2^2`` of every lane from above, in float64: with ``G =
    A A^T`` (or ``A^T A``, the smaller), ``tr(G^p)^(1/p)`` for ``p =
    2^SQUARINGS``, by repeated squaring with each power scaled to unit
    trace.  ``lambda_max^p <= tr(G^p) <= n lambda_max^p``, so the result
    lies in ``[||A||^2, n^(1/p) ||A||^2]`` (n the side of G: at most
    ``(1 + 6.0e-6) ||A||^2`` for n <= 512), up to float64 rounding; over
    :func:`chunks` of the lanes.  Returns (B,) float64."""
    M, N = A.shape[1:]
    out = []
    for sl in chunks(A):
        a = A[sl].double()
        G = a @ a.mT if M <= N else a.mT @ a
        log_l = torch.zeros(G.shape[0], dtype=torch.float64, device=A.device)
        for j in range(SQUARINGS + 1):
            tr = torch.diagonal(G, dim1=1, dim2=2).sum(1)
            log_l += torch.log(tr) / 2.0 ** j
            G = G / tr[:, None, None]
            if j < SQUARINGS:
                G = G @ G
        out.append(torch.exp(log_l))
    return torch.cat(out)


def f32_at_least(v):
    """float64 ``v`` as float32 no smaller than ``v``."""
    f = v.float()
    return torch.where(f.double() < v, torch.nextafter(f, torch.tensor(
        math.inf, dtype=torch.float32, device=f.device)), f)
