"""The six application families of the JAX package's benchmark scripts on
the port: their generators, their solves through ``BatchedAlgorithm``'s
generic driver and their host gates.

Each generator is a copy of its script's (numpy, seeded), so the same
seed gives the same problems in both packages; sizes and tolerances
default to the scripts' published ones.  The solves run where the operands
live and take the script's variant:

* SVM regularisation path (``benchmarks/svm_bench.py``): AFBA, theta = 2,
  ``HingeLoss`` composed with A, one A ``Shared`` or stacked per lane;
* minimum-CVaR portfolios (``benchmarks/cvar_bench.py``): Chambolle-Pock,
  ``IndSimplex`` and ``SumLargest``;
* matrix completion (``benchmarks/matrix_completion_bench.py``): FISTA,
  ``NuclearNorm``;
* graphical lasso (``benchmarks/glasso_bench.py``): Douglas-Rachford,
  ``Tilt(NegLogDet(1), S)`` and a ``Shared`` off-diagonal ``NormL1``;
* 1-D total variation (``benchmarks/tv1d_bench.py``):
  ``TotalVariation1D.prox`` under ``torch.func.vmap``;
* sparse logistic regression (``benchmarks/logistic_bench.py``, its
  "bounded_panoc_stacked" variant): PANOC on the generic driver.

Nothing here imports JAX or the benchmark scripts.

``python -m proxtpu_torch.tools.families [--device cpu]`` prints each
family's wall and PyTorch operations per iteration at the published size
(on the card unless the CPU is asked for), and min-CVaR's once more with
the JAX package's bisection in place of the port's capped-simplex
projection.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import algorithms as alg
from ..ops.linops import MatrixOperator
from ..parallel import BatchedAlgorithm
from ..prox import functions as fns
from ..prox.base import proxclass
from ..prox.combinators import Tilt
from ..utils.shared import Shared


def _t(a, device):
    return torch.tensor(np.ascontiguousarray(a), device=device)


# ---------------------------------------------------------------------------
# SVM regularisation path (benchmarks/svm_bench.py:30-75)

SVM_M, SVM_N = 400, 200  # samples x features
SVM_TOL = 1e-4
SVM_MAXIT = 100_000


def svm_data(B=256, m=SVM_M, n=SVM_N, seed=0, dtype=np.float32):
    """One m x n data matrix and its labels, B lambdas geomspace(0.01, 1)
    and the step 0.9 / ||A||_2 per lane."""
    rng = np.random.default_rng(seed)
    w_true = rng.standard_normal(n)
    A = (rng.standard_normal((m, n)) / np.sqrt(n)).astype(dtype)
    y = np.sign(A @ w_true + 0.2 * rng.standard_normal(m)).astype(dtype)
    lams = np.geomspace(0.01, 1.0, B).astype(dtype)
    gam = np.full((B,), 0.9 / float(np.linalg.norm(A, 2)), dtype)
    return dict(A=A, y=y, lams=lams, gam=gam)


def svm_solve(data, variant, device, maxit=SVM_MAXIT, tol=SVM_TOL):
    """``((xs, ys), iters, done)`` of AFBA (theta = 2) on the path, with
    the data ``Shared`` by every lane (``variant="shared"``) or copied
    per lane (``"stacked"``)."""
    A, y, lams, gam = (_t(data[k], device) for k in ("A", "y", "lams",
                                                      "gam"))
    B, (m, n) = lams.shape[0], A.shape
    if variant == "shared":
        h, L = Shared(fns.HingeLoss(y, 1.0 / m)), Shared(A)
    else:
        h = fns.HingeLoss(y.expand(B, m).contiguous(), 1.0 / m)
        L = A.expand(B, m, n).contiguous()
    return BatchedAlgorithm(alg.make_afba_iteration, maxit=maxit, tol=tol,
                            use_kernels=False)(
        x0=A.new_zeros(B, n), y0=A.new_zeros(B, m), g=fns.SqrNormL2(lams),
        h=h, L=L, theta=2.0, gamma1=gam, gamma2=gam)


# ---------------------------------------------------------------------------
# minimum-CVaR portfolios (benchmarks/cvar_bench.py:31-90)

CVAR_S, CVAR_ASSETS, CVAR_K = 250, 8, 25
CVAR_TOL = 1e-5
CVAR_MAXIT = 50_000


def cvar_data(B=64, S=CVAR_S, n_assets=CVAR_ASSETS, seed=7,
              dtype=np.float32):
    """B bootstrap-style scenario-loss matrices (S x n_assets) from one
    factor model, and the step 0.9 / ||L_i||_2 per lane."""
    rng = np.random.default_rng(seed)
    expo = rng.standard_normal((n_assets, 3)) * 0.5
    mu = np.linspace(0.08, 0.01, n_assets)
    Ls = np.empty((B, S, n_assets), dtype)
    for i in range(B):
        factors = rng.standard_normal((S, 3))
        R = (mu[None, :] + factors @ expo.T * 0.1
             + 0.05 * rng.standard_normal((S, n_assets)))
        Ls[i] = -R.astype(dtype)
    opnorms = np.array([np.linalg.norm(Ls[i], 2) for i in range(B)], dtype)
    return dict(Ls=Ls, gam=0.9 / opnorms)


def cvar_solve(data, device, k=CVAR_K, maxit=CVAR_MAXIT, tol=CVAR_TOL):
    """``((xs, ys), iters, done)`` of Chambolle-Pock on min over the
    simplex of the mean of the k largest scenario losses."""
    Ls, gam = _t(data["Ls"], device), _t(data["gam"], device)
    B, S, n = Ls.shape
    return BatchedAlgorithm(alg.make_chambolle_pock_iteration, maxit=maxit,
                            tol=tol, use_kernels=False)(
        x0=Ls.new_full((B, n), 1.0 / n), y0=Ls.new_zeros(B, S),
        g=fns.IndSimplex(1.0), h=fns.SumLargest(k, 1.0 / k), L=Ls,
        gamma1=gam, gamma2=gam)


def cvar_value(L, x, k=CVAR_K):
    """The mean of the k largest losses of the portfolio x, in float64."""
    losses = np.asarray(L, np.float64) @ np.asarray(x, np.float64)
    return float(np.mean(np.sort(losses)[-k:]))


def cvar_lp(L, k=CVAR_K):
    """The optimum of the same problem as a linear program (Rockafellar-
    Uryasev: min t + sum_s u_s / k, u_s >= L_s x - t, u >= 0, x on the
    simplex), by ``scipy.optimize.linprog`` in float64."""
    from scipy.optimize import linprog

    L = np.asarray(L, np.float64)
    S, n = L.shape
    c = np.concatenate([np.zeros(n), [1.0], np.full(S, 1.0 / k)])
    A_ub = np.hstack([L, -np.ones((S, 1)), -np.eye(S)])
    A_eq = np.concatenate([np.ones(n), [0.0], np.zeros(S)])[None, :]
    bounds = [(0, None)] * n + [(None, None)] + [(0, None)] * S
    res = linprog(c, A_ub=A_ub, b_ub=np.zeros(S), A_eq=A_eq, b_eq=[1.0],
                  bounds=bounds, method="highs")
    if res.status != 0:
        raise RuntimeError(f"linprog: {res.message}")
    return float(res.fun)


# ---------------------------------------------------------------------------
# matrix completion (benchmarks/matrix_completion_bench.py:34-108)

MC_ROWS, MC_COLS, MC_RANK = 64, 48, 3
MC_TOL = 1e-4
MC_LAM = 0.5
MC_MAXIT = 5000


@proxclass
class MaskedQuadratic:
    """f(X) = ||mask * (X - M)||_F^2 / 2 with its gradient (the script's
    own smooth term)."""

    mask: object
    M: object

    is_convex = True
    is_generalized_quadratic = True

    def __call__(self, X):
        r = self.mask * (X - self.M)
        return 0.5 * torch.sum(r * r)

    def value_and_gradient(self, X):
        r = self.mask * (X - self.M)
        return 0.5 * torch.sum(r * r), r


def mc_data(B=64, m=MC_ROWS, n=MC_COLS, rank=MC_RANK, seed=3,
            dtype=np.float32):
    """B rank-``rank`` truths, each with its own 60% observation mask."""
    rng = np.random.default_rng(seed)
    truths = np.empty((B, m, n), dtype)
    masks = np.empty((B, m, n), dtype)
    for i in range(B):
        truths[i] = (rng.standard_normal((m, rank))
                     @ rng.standard_normal((rank, n)))
        masks[i] = rng.random((m, n)) < 0.6
    return dict(truths=truths, masks=masks, obs=masks * truths)


def mc_solve(data, device, lam=MC_LAM, maxit=MC_MAXIT, tol=MC_TOL):
    """``(Xs, iters, done)`` of FISTA with ``NuclearNorm(lam)``, Lf = 1."""
    masks, obs = _t(data["masks"], device), _t(data["obs"], device)
    return BatchedAlgorithm(alg.make_fast_forward_backward_iteration,
                            maxit=maxit, tol=tol, use_kernels=False)(
        x0=torch.zeros_like(obs), f=MaskedQuadratic(masks, obs),
        g=fns.NuclearNorm(lam), Lf=1.0)


def mc_heldout_error(data, Xs):
    """Per lane, ||X - truth|| / ||truth|| over the entries not observed."""
    Xs = np.asarray(Xs, np.float64)
    rel = np.empty(len(Xs))
    for i, (truth, mask) in enumerate(zip(data["truths"], data["masks"])):
        hold = (1.0 - mask).astype(bool)
        rel[i] = (np.linalg.norm(Xs[i][hold] - truth[hold])
                  / max(np.linalg.norm(truth[hold]), 1e-12))
    return rel


# ---------------------------------------------------------------------------
# graphical lasso (benchmarks/glasso_bench.py:40-126)

GL_N = 32
GL_LAM = 0.05
GL_TOL = 1e-5
GL_GAMMA = 2.0
GL_MAXIT = 2000


def glasso_data(B=64, n=GL_N, seed=0, density=0.12, dtype=np.float32):
    """B exact covariances S of sparse SPD precision matrices."""
    rng = np.random.default_rng(seed)
    Ss = np.empty((B, n, n), dtype)
    for i in range(B):
        P = np.zeros((n, n))
        idx = rng.random((n, n)) < density
        vals = rng.uniform(0.3, 0.8, (n, n)) * np.sign(
            rng.standard_normal((n, n)))
        P[idx] = vals[idx]
        P = (P + P.T) / 2
        np.fill_diagonal(P, np.abs(P).sum(axis=1) + 0.5)
        S = np.linalg.inv(P)
        Ss[i] = (S + S.T) / 2
    return dict(Ss=Ss)


def glasso_solve(data, device, lam=GL_LAM, gamma=GL_GAMMA, maxit=GL_MAXIT,
                 tol=GL_TOL):
    """``(Thetas, iters, done)`` of Douglas-Rachford on
    tr(S T) - logdet T + lam ||T||_1,off from T = I."""
    Ss = _t(data["Ss"], device)
    B, n, _ = Ss.shape
    eye = torch.eye(n, dtype=Ss.dtype, device=Ss.device)
    return BatchedAlgorithm(alg.make_douglas_rachford_iteration, maxit=maxit,
                            tol=tol, use_kernels=False)(
        x0=eye.expand(B, n, n).contiguous(), f=Tilt(fns.NegLogDet(1.0), Ss),
        g=Shared(fns.NormL1(lam * (1 - eye))), gamma=gamma)


def kkt_residuals(Ss, thetas, lam, tol=GL_TOL):
    """Per lane, the float64 KKT block residuals of graphical lasso:
    diagonal, nonzero off-diagonal, and the bound violation of the zero
    off-diagonal entries (an entry counts as nonzero above 50 tol)."""
    B, n, _ = Ss.shape
    eye = np.eye(n, dtype=bool)
    off = ~eye
    out = np.empty((B, 3))
    for i in range(B):
        T = np.asarray(thetas[i], np.float64)
        T = (T + T.T) / 2
        G = np.asarray(Ss[i], np.float64) - np.linalg.inv(T)
        nz = off & (np.abs(T) > 50 * tol)
        z = off & ~nz
        out[i, 0] = np.abs(G[eye]).max()
        out[i, 1] = (np.abs(G[nz] + lam * np.sign(T[nz])).max()
                     if nz.any() else 0.0)
        out[i, 2] = max(np.abs(G[z]).max() - lam, 0.0) if z.any() else 0.0
    return out


# ---------------------------------------------------------------------------
# 1-D total variation (benchmarks/tv1d_bench.py:39-172)

TV1D_LAM = 0.3
TV1D_NOISE = 0.3
TV1D_PIECES = 8
TV1D_ORACLE_LANES = 1024


def tv1d_condat(y, lam):
    """Condat (2013), "A direct algorithm for 1-D total variation
    denoising", Algorithm 1 (0-indexed): argmin_x 1/2||x-y||^2 + lam*TV(x)
    in float64, the exact sequential taut-string scan: the oracle of the
    family's gate."""
    y = np.asarray(y, dtype=np.float64)
    N = y.shape[0]
    x = np.empty(N)
    if N == 1:
        return y.copy()
    k = k0 = km = kp = 0
    vmin, vmax = y[0] - lam, y[0] + lam
    umin, umax = lam, -lam
    while True:
        if k == N - 1:  # last sample: terminate or take the forced jump
            if umin < 0:
                x[k0:km + 1] = vmin
                k = k0 = km = km + 1
                kp = max(kp, k)
                vmin, umin = y[k], lam
                umax = y[k] + lam - vmax
            elif umax > 0:
                x[k0:kp + 1] = vmax
                k = k0 = kp = kp + 1
                km = max(km, k)
                vmax, umax = y[k], -lam
                umin = y[k] - lam - vmin
            else:
                x[k0:N] = vmin + umin / (k - k0 + 1)
                return x
            continue
        if y[k + 1] + umin < vmin - lam:  # negative jump necessary
            x[k0:km + 1] = vmin
            k = k0 = km = kp = km + 1
            vmin, vmax = y[k], y[k] + 2 * lam
            umin, umax = lam, -lam
        elif y[k + 1] + umax > vmax + lam:  # positive jump necessary
            x[k0:kp + 1] = vmax
            k = k0 = km = kp = kp + 1
            vmin, vmax = y[k] - 2 * lam, y[k]
            umin, umax = lam, -lam
        else:  # no jump: extend the segment, pull the string taut
            k += 1
            umin += y[k] - vmin
            umax += y[k] - vmax
            if umin >= lam:
                vmin += (umin - lam) / (k - k0 + 1)
                umin, km = lam, k
            if umax <= -lam:
                vmax += (umax + lam) / (k - k0 + 1)
                umax, kp = -lam, k


def tv1d_data(B=8192, n=512, seed=0, dtype=np.float32):
    """B noisy piecewise-constant signals of length n (8 pieces)."""
    rng = np.random.default_rng(seed)
    steps = np.cumsum(rng.standard_normal((B, TV1D_PIECES)), axis=1)
    truth = np.repeat(steps, n // TV1D_PIECES, axis=1)
    return dict(Y=(truth + TV1D_NOISE * rng.standard_normal((B, n)))
                .astype(dtype))


def tv1d_solve(Y, restart, lam=TV1D_LAM, maxit=2000):
    """``(Z, values)``: the prox at gamma = 1 of every row of the tensor
    ``Y`` under ``torch.func.vmap`` (``maxit`` masked trips per lane)."""
    tv = fns.TotalVariation1D(lam, restart=restart, maxit=maxit)
    return torch.func.vmap(lambda y: tv.prox(y, 1.0))(Y)


def tv1d_trips(Y, restart, lam=TV1D_LAM, maxit=2000):
    """Each row's own trip count of the prox's dual loop (what the host
    loop runs on that row alone), under vmap."""
    tv = fns.TotalVariation1D(lam, restart=restart, maxit=maxit)
    return torch.func.vmap(lambda y: tv.dual(y, 1.0)[1])(Y)


# ---------------------------------------------------------------------------
# sparse logistic regression (benchmarks/logistic_bench.py:52-125)

LOG_M, LOG_N = 200, 400
LOG_B = 256
LOG_TOL = 1e-5
LOG_MAXIT = 2000


def logistic_data(B=LOG_B, m=LOG_M, n=LOG_N, seed=1, dtype=np.float32):
    """One m x n design, offsets b, B lambdas lam_max * logspace(0.05,
    0.5) and Lf = ||A||^2 / 4."""
    rng = np.random.default_rng(seed)
    A = (rng.standard_normal((m, n)) / np.sqrt(m)).astype(dtype)
    b = rng.standard_normal(m).astype(dtype)
    # grad f(0) = A^T (sigmoid(-b) - 1); x = 0 is optimal above lam_max
    lam_max = float(np.max(np.abs(A.T @ (1.0 / (1.0 + np.exp(b)) - 1.0))))
    lams = (lam_max * np.logspace(np.log10(0.05), np.log10(0.5), B)) \
        .astype(dtype)
    Lf = float(np.linalg.norm(A, 2) ** 2) / 4.0  # sigmoid' <= 1/4
    return dict(A=A, b=b, lams=lams, Lf=Lf)


def logistic_solve(data, device, maxit=LOG_MAXIT, tol=LOG_TOL):
    """``(xs, iters, done)`` of PANOC (fixed step, ``adaptive=False``) on
    sum softplus(-(A x - b)) + lam ||x||_1 through the generic driver,
    every lane with its own copy of A and of the loss."""
    A, b, lams = (_t(data[k], device) for k in ("A", "b", "lams"))
    B, (m, n) = lams.shape[0], A.shape
    f = fns.Translate(fns.LogisticLoss(A.new_ones(B)),
                      (-b).expand(B, m).contiguous())
    return BatchedAlgorithm(alg.make_panoc_iteration, maxit=maxit, tol=tol,
                            use_kernels=False)(
        x0=A.new_zeros(B, n), f=f,
        A=MatrixOperator(A.expand(B, m, n).contiguous()),
        g=fns.NormL1(lams), Lf=data["Lf"], adaptive=False)


def logistic_recheck(data, xs, alpha=0.95):
    """Per lane, the forward-backward residual
    ||x - prox_{gamma lam ||.||_1}(x - gamma grad)||_inf / gamma at PANOC's
    step gamma = alpha / Lf, in float64 on the host."""
    A, b = np.asarray(data["A"], np.float64), np.asarray(data["b"],
                                                         np.float64)
    lams = np.asarray(data["lams"], np.float64)
    xs = np.asarray(xs, np.float64)
    gamma = alpha / data["Lf"]
    u = xs @ A.T - b
    grad = (1.0 / (1.0 + np.exp(-u)) - 1.0) @ A
    y = xs - gamma * grad
    z = np.sign(y) * np.maximum(np.abs(y) - gamma * lams[:, None], 0.0)
    return np.max(np.abs(xs - z), axis=1) / gamma


# ---------------------------------------------------------------------------
# host cost per iteration: python -m proxtpu_torch.tools.families


def bisect_capped_simplex(y, cap, total, iters=100):
    """The JAX package's capped-simplex projection
    (``proxtpu/prox/functions.py:1082``) line for line, 100 halvings of the
    clip threshold: the baseline the port's threshold solve is timed
    against."""
    lo = torch.amin(y, -1) - cap
    hi = torch.amax(y, -1)
    for _ in range(iters):
        mid = (lo + hi) / 2
        s = torch.sum(torch.clamp(torch.clamp(y - mid, min=0.0), max=cap), -1)
        too_big = s > total
        lo, hi = torch.where(too_big, mid, lo), torch.where(too_big, hi, mid)
    return torch.clamp(torch.clamp(y - (lo + hi) / 2, min=0.0), max=cap)


def operations_per_iteration(solve):
    """PyTorch operations (aten calls) per iteration of ``solve(maxit)``:
    the difference between 26 and 10 iterations, over 16."""
    from collections import Counter

    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n[func] += 1
            return func(*args, **(kwargs or {}))

    counts = []
    for maxit in (10, 26):
        with Count() as c:
            solve(maxit)
        counts.append(sum(c.n.values()))
    return (counts[1] - counts[0]) / 16


def ms_per_iteration(solve, device):
    """Wall ms per iteration of ``solve(maxit)`` on ``device``: the
    difference between 64 and 24 iterations, after a warm-up."""
    import time

    def wall(maxit):
        if device == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        solve(maxit)
        if device == "cuda":
            torch.cuda.synchronize()
        return time.perf_counter() - t0

    wall(4)
    return 1e3 * (wall(64) - wall(24)) / 40


def main():
    import argparse
    import subprocess
    from unittest import mock

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    dev = ap.parse_args().device
    if dev == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device (pass --device cpu for the CPU)")
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip())
    svm, cvar, mc = svm_data(), cvar_data(), mc_data()
    gl, lg = glasso_data(), logistic_data()
    Y = torch.tensor(tv1d_data()["Y"], device=dev)
    runs = {
        "SVM path, shared A": lambda c: svm_solve(svm, "shared", dev,
                                                  maxit=c),
        "SVM path, stacked A": lambda c: svm_solve(svm, "stacked", dev,
                                                   maxit=c),
        "min-CVaR": lambda c: cvar_solve(cvar, dev, maxit=c),
        "matrix completion": lambda c: mc_solve(mc, dev, maxit=c),
        "graphical lasso": lambda c: glasso_solve(gl, dev, maxit=c),
        "1-D TV, one masked trip": lambda c: tv1d_solve(Y, True, maxit=c),
        "sparse logistic": lambda c: logistic_solve(lg, dev, maxit=c),
    }
    for name, solve in runs.items():
        print(f"{name}: {ms_per_iteration(solve, dev):.3f} ms and "
              f"{operations_per_iteration(solve):.0f} operations an "
              f"iteration  [{dev}]", flush=True)
    with mock.patch.object(fns, "_capped_simplex_proj",
                           bisect_capped_simplex):
        solve = runs["min-CVaR"]
        print(f"min-CVaR with the JAX package's 100 halvings: "
              f"{ms_per_iteration(solve, dev):.3f} ms and "
              f"{operations_per_iteration(solve):.0f} operations an "
              f"iteration  [{dev}]", flush=True)


if __name__ == "__main__":
    main()
