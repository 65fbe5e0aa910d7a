"""The port's float32 -> float64 warm start (``proxtpu_torch.parallel.warm``)
against the JAX package's (``proxtpu.parallel.warm``) on the same numpy
inputs, on the CPU: ``tests/test_warm.py``'s cases.

Both stages run the generic driver (``use_kernels=False``) unless a case
says otherwise.  Stage 1 runs in float32 and stops at float32's noise
floor (``warm_tol`` 1.2e-5), where the two packages' sums round apart, so
its count is not held to the JAX package's (the totals part by up to 12
on these problems).  Each answer is held to the oracle of
``tests/test_warm.py``: every lane done, its float64 forward-backward
residual at most 1.05 tol, and within 50 tol of the cold float64 solve
(the port's, and the JAX package's warm start).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import problems as P
import proxtpu as pa
import proxtpu_torch as pt
from proxtpu.parallel import warm as jw
from proxtpu.prox import functions as jf
from proxtpu.utils.shared import Shared as JShared
from proxtpu_torch.parallel import warm as tw
from proxtpu_torch.prox import functions as tf
from proxtpu_torch.utils.shared import Shared as TShared

jax.config.update("jax_enable_x64", True)


def lam_path_problem(B=8, M=20, N=30):
    """``tests/test_warm.py``'s regularisation path: one A, 8 lambdas."""
    rng = np.random.default_rng(3)
    A = rng.standard_normal((M, N)) / np.sqrt(M)
    b = rng.standard_normal(M)
    lam_max = float(np.max(np.abs(A.T @ b)))
    lams = lam_max * np.logspace(np.log10(0.05), np.log10(0.5), B)
    Lf = float(np.linalg.norm(A, 2) ** 2)
    return A, b, lams, Lf


def fb_residual(A, b, lam, Lf, x):
    """||x - prox(x - gamma grad)||_inf / gamma at gamma = 1 / Lf."""
    x = np.asarray(x)
    gam = 1.0 / Lf
    y = x - gam * (A.conj().T @ (A @ x - b))
    mag = np.abs(y)
    z = y / np.where(mag == 0, 1, mag) * np.maximum(mag - gam * lam, 0.0)
    return float(np.max(np.abs(x - z)) / gam)


def path_kwargs(lib, A, b, lams, Lf, dtype=np.float64):
    B, N = lams.shape[0], A.shape[1]
    if lib == "jax":
        return dict(x0=jnp.zeros((B, N), dtype),
                    f=JShared(jf.LeastSquaresLoss(jnp.asarray(A),
                                                  jnp.asarray(b))),
                    g=jf.NormL1(jnp.asarray(lams)), Lf=Lf)
    return dict(x0=torch.zeros(B, N, dtype=torch.complex128
                               if np.dtype(dtype).kind == "c"
                               else torch.float64),
                f=TShared(tf.LeastSquaresLoss(torch.tensor(A),
                                              torch.tensor(b))),
                g=tf.NormL1(torch.tensor(lams)), Lf=Lf)


def solve_both(tol, warm=True, dtype=np.float64, problem=None, **opts):
    A, b, lams, Lf = problem or lam_path_problem()
    J = jw.WarmStartedBatchedAlgorithm if warm else pa.parallel.BatchedAlgorithm
    T = tw.WarmStartedBatchedAlgorithm if warm else pt.BatchedAlgorithm
    ref = J(pa.make_fast_forward_backward_iteration, maxit=50000, tol=tol,
            use_kernels=False, **opts.get("jax", {}))(
        **path_kwargs("jax", A, b, lams, Lf, dtype))
    port = T(pt.make_fast_forward_backward_iteration, maxit=50000, tol=tol,
             use_kernels=False, **opts.get("torch", {}))(
        **path_kwargs("torch", A, b, lams, Lf, dtype))
    return ref, port


@pytest.mark.parametrize("tol", [1e-6, 1e-8])
def test_warm_started_matches_cold_f64_and_jax(tol):
    A, b, lams, Lf = lam_path_problem()
    (xj, _, dj), (xw, itw, dw) = solve_both(tol)
    _, (xc, itc, dc) = solve_both(tol, warm=False)
    assert bool(dw.all()) and bool(dc.all()) and bool(np.asarray(dj).all())
    assert xw.dtype == torch.float64
    for i in range(lams.shape[0]):
        assert fb_residual(A, b, lams[i], Lf, xw[i].numpy()) <= 1.05 * tol
        assert float((xw[i] - xc[i]).abs().max()) <= 50 * tol
        assert float(np.max(np.abs(xw[i].numpy() - np.asarray(xj[i])))) \
            <= 50 * tol
    # the warm start moves work into stage 1
    assert int(itw.max()) < 2 * int(itc.max())


@pytest.mark.parametrize("tol", [1e-6, 1e-8])
def test_warm_started_adaptive_restart(tol):
    """Adaptive restart through both stages: the same float64 criterion on
    every lane, fewer iterations than plain FISTA's warm start."""
    A, b, lams, Lf = lam_path_problem()
    seq = dict(jax=dict(extrapolation_sequence=pa.AdaptiveRestartSequence()),
               torch=dict(extrapolation_sequence=pt.AdaptiveRestartSequence()))
    (xj, _, dj), (xr, itr, dr) = solve_both(tol, **seq)
    _, (xp, itp, dp) = solve_both(tol)
    assert bool(dr.all()) and bool(dp.all()) and bool(np.asarray(dj).all())
    for i in range(lams.shape[0]):
        assert fb_residual(A, b, lams[i], Lf, xr[i].numpy()) <= 1.05 * tol
        assert float((xr[i] - xp[i]).abs().max()) <= 50 * tol
        assert float(np.max(np.abs(xr[i].numpy() - np.asarray(xj[i])))) \
            <= 50 * tol
    assert int(itr.max()) < int(itp.max())


def test_cast_problem_preserves_shared_and_ints():
    tree = {"f": TShared(tf.LeastSquaresLoss(
                torch.ones(3, 4, dtype=torch.float64),
                torch.ones(3, dtype=torch.float64))),
            "idx": torch.arange(5),
            "z": torch.ones(2, dtype=torch.complex128),
            "lf": 2.0}
    out = tw.cast_problem(tree, torch.float32)
    assert isinstance(out["f"], TShared)
    assert out["f"].A.dtype == torch.float32
    assert out["idx"].dtype == torch.arange(5).dtype
    assert out["z"].dtype == torch.complex64
    assert out["lf"] == 2.0
    ref = jw.cast_problem({"z": jnp.ones(2, jnp.complex128),
                           "idx": jnp.arange(5)}, jnp.float32)
    assert str(ref["z"].dtype) == "complex64"


def test_stage_one_runs_in_float32(monkeypatch):
    """The stage-1 solver sees a float32 problem and x0; stage 2 the
    caller's float64 one."""
    seen = []
    real = pt.make_fast_forward_backward_iteration

    def factory(**kw):
        seen.append((kw["x0"].dtype, kw["f"].A.dtype))
        return real(**kw)

    factory.__name__ = real.__name__
    factory.__signature__ = __import__("inspect").signature(real)
    A, b, lams, Lf = lam_path_problem()
    tw.WarmStartedBatchedAlgorithm(factory, maxit=20000, tol=1e-6,
                                   use_kernels=False)(
        **path_kwargs("torch", A, b, lams, Lf))
    assert seen == [(torch.float32, torch.float32),
                    (torch.float64, torch.float64)]


def test_warm_started_complex128():
    """complex128 warms through a complex64 stage: the dtype kept, the
    criterion met, within 100 tol of the cold solve and the JAX package's
    warm start."""
    rng = np.random.default_rng(5)
    B, M, N = 4, 12, 16
    A = (rng.standard_normal((M, N)) + 1j * rng.standard_normal((M, N))) \
        / np.sqrt(M)
    b = rng.standard_normal(M) + 1j * rng.standard_normal(M)
    lams = 0.05 + 0.1 * rng.random(B)
    Lf = float(np.linalg.norm(A, 2) ** 2)
    tol = 1e-8
    (xj, _, dj), (xw, _, dw) = solve_both(tol, dtype=np.complex128,
                                          problem=(A, b, lams, Lf))
    _, (xc, _, dc) = solve_both(tol, warm=False, dtype=np.complex128,
                                problem=(A, b, lams, Lf))
    assert bool(dw.all()) and bool(dc.all()) and bool(np.asarray(dj).all())
    assert xw.dtype == torch.complex128
    for i in range(B):
        assert fb_residual(A, b, lams[i], Lf, xw[i].numpy()) <= 1.05 * tol
        assert float((xw[i] - xc[i]).abs().max()) <= 100 * tol
        assert float(np.max(np.abs(xw[i].numpy() - np.asarray(xj[i])))) \
            <= 100 * tol


@dataclasses.dataclass(frozen=True)
class SplitQuadF:
    """0.5 ||u - c||^2 + 0.5 ||v||^2 over a tuple iterate (u, v)."""

    c: object

    is_convex = True
    is_generalized_quadratic = True

    def __call__(self, xy):
        u, v = xy
        return 0.5 * torch.sum((u - self.c) ** 2) + 0.5 * torch.sum(v ** 2)

    def value_and_gradient(self, xy):
        u, v = xy
        return self(xy), (u - self.c, v)


def test_warm_started_pytree_iterate():
    """A tuple iterate warm-starts too (Davis-Yin over (u, v)): float64
    kept on both leaves, every lane done, finite."""
    B, n = 4, 12
    c = torch.tensor(np.random.default_rng(9).standard_normal((B, n)))
    x0 = (torch.zeros(B, n, dtype=torch.float64),
          torch.zeros(B, n, dtype=torch.float64))
    xs, it, done = tw.WarmStartedBatchedAlgorithm(
        pt.make_davis_yin_iteration, maxit=20000, tol=1e-8,
        use_kernels=False)(x0=x0, f=SplitQuadF(c), g=pt.prox.Zero(),
                           h=tf.SqrNormL2(0.5), Lf=1.0)
    assert bool(done.all())
    u, v = xs
    assert u.dtype == torch.float64 and v.dtype == torch.float64
    assert bool(torch.isfinite(u).all()) and bool(torch.isfinite(v).all())


@pytest.mark.parametrize("solver", ["FastForwardBackward", "ZeroFPR"])
def test_warm_started_single_solver(solver):
    """``WarmStartedAlgorithm``: the float32 stage and the float64 polish
    reach the reference's lasso solution (``tests/problems.py``) within
    1e-6, as the JAX package's does."""
    A, b = P.LASSO_A, P.LASSO_B
    kw = {"Lf": P.lasso_Lf()} if solver == "FastForwardBackward" else {}
    x, it = tw.WarmStartedAlgorithm(getattr(pt, solver), maxit=50000,
                                    tol=1e-8)(
        x0=torch.zeros(5, dtype=torch.float64),
        f=tf.make_least_squares(torch.tensor(A), torch.tensor(b)),
        g=tf.NormL1(P.lasso_lam()), **kw)
    xj, _ = jw.WarmStartedAlgorithm(getattr(pa, solver), maxit=50000,
                                      tol=1e-8)(
        x0=jnp.zeros(5), f=jf.make_least_squares(jnp.asarray(A),
                                                 jnp.asarray(b)),
        g=jf.NormL1(P.lasso_lam()), **kw)
    assert x.dtype == torch.float64
    for sol in (x.numpy(), np.asarray(xj)):
        assert float(np.max(np.abs(sol - P.LASSO_XSTAR))) <= 1e-6


def test_warm_single_construction_time_problem_kwargs():
    """Problem kwargs given at construction reach the warm stage narrowed
    and the polish as they are."""
    A, b = torch.tensor(P.LASSO_A), torch.tensor(P.LASSO_B)
    solver = tw.WarmStartedAlgorithm(
        pt.FastForwardBackward, maxit=50000, tol=1e-8,
        f=tf.make_least_squares(A, b), g=tf.NormL1(P.lasso_lam()),
        Lf=P.lasso_Lf())
    assert solver.warm.kwargs["f"].A.dtype == torch.float32
    assert solver.polish.kwargs["f"].A.dtype == torch.float64
    x, it = solver(x0=torch.zeros(5, dtype=torch.float64))
    assert float(np.max(np.abs(x.numpy() - P.LASSO_XSTAR))) <= 1e-6


def test_warm_stage_blowup_lane_falls_back_to_cold_start():
    """A lane whose data overflow the float32 cast must not poison the
    polish: it starts stage 2 from the cold x0.  The default routes (the
    lasso solvers, their plain versions on the CPU) in both stages."""
    rng = np.random.default_rng(11)
    B, M, N = 3, 8, 6
    A = rng.standard_normal((B, M, N)) / np.sqrt(M)
    A[0] *= 1e30  # the float32 steps overflow; fine in float64
    b = rng.standard_normal((B, M))
    lam = 0.1 * np.max(np.abs(np.einsum("bmn,bm->bn", A, b)), axis=1)
    Lf = np.array([np.linalg.norm(A[i], 2) ** 2 for i in range(B)])
    xs, it, done = tw.WarmStartedBatchedAlgorithm(
        pt.make_fast_forward_backward_iteration, maxit=20000, tol=1e-8,
        warm_maxit=200)(
        x0=torch.zeros(B, N, dtype=torch.float64),
        f=tf.LeastSquaresLoss(torch.tensor(A), torch.tensor(b)),
        g=tf.NormL1(torch.tensor(lam)), Lf=torch.tensor(Lf))
    assert bool(done.all())
    assert bool(torch.isfinite(xs).all())


def test_stacked_lasso_stage_one_takes_the_kernel_route(monkeypatch):
    """On a stacked-A lasso by FISTA the float32 stage goes through
    ``match_kernel_solver`` to the kernel solver with its kernels on
    (``use_kernel=True``: on the card, ``fb_step`` / ``fista_step``), the
    float64 polish to its plain step."""
    from proxtpu_torch.kernels import lasso as tlasso

    calls = []
    real = tlasso.solve_lasso_batch

    def spy(A, *args, **kw):
        calls.append((A.dtype, kw.get("use_kernel")))
        return real(A, *args, **kw)

    monkeypatch.setattr(tlasso, "solve_lasso_batch", spy)
    rng = np.random.default_rng(0)
    B, M, N = 4, 10, 16
    A = rng.standard_normal((B, M, N)) / np.sqrt(M)
    b = rng.standard_normal((B, M))
    lam = 0.1 * np.max(np.abs(np.einsum("bmn,bm->bn", A, b)), axis=1)
    Lf = np.array([np.linalg.norm(A[i], 2) ** 2 for i in range(B)])
    xs, it, done = tw.WarmStartedBatchedAlgorithm(
        pt.make_fast_forward_backward_iteration, maxit=20000, tol=1e-6)(
        x0=torch.zeros(B, N, dtype=torch.float64),
        f=tf.LeastSquaresLoss(torch.tensor(A), torch.tensor(b)),
        g=tf.NormL1(torch.tensor(lam)), Lf=torch.tensor(Lf))
    assert calls == [(torch.float32, True), (torch.float64, False)]
    assert bool(done.all())
    for i in range(B):
        assert fb_residual(A[i], b[i], lam[i], Lf[i], xs[i].numpy()) \
            <= 1.05 * 1e-6
