"""The six application families of the benchmark scripts (SVM path,
min-CVaR, matrix completion, graphical lasso, 1-D TV, sparse logistic) on
the port and on the JAX package, on the CPU, in float64 at a small size.

Each family's generator (``proxtpu_torch/tools/families.py``, copies of the
scripts') makes one set of numpy problems; both packages' ``BatchedAlgorithm``
(generic driver, ``use_kernels=False``, as the scripts) solve it, and give
the same iteration counts (PANOC, whose line search decides near
equality, within 2; ``ROADMAP.md`` queue 3) and solutions within 1e-8; the
family's own host gate holds on the port's answer.

Run as a script, the file prints the JAX package's own numbers behind the
chip gates of ``chip_smoke.py`` at the published sizes (float32, CPU):
``PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_families.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from proxtpu.algorithms import (
    make_douglas_rachford_iteration,
    make_fast_forward_backward_iteration,
)
from proxtpu.algorithms.panoc import make_panoc_iteration
from proxtpu.algorithms.primal_dual import (
    make_afba_iteration,
    make_chambolle_pock_iteration,
)
from proxtpu.ops.linops import MatrixOperator
from proxtpu.parallel import BatchedAlgorithm, Shared
from proxtpu.prox import base as jbase
from proxtpu.prox import functions as jf
from proxtpu.prox.combinators import Tilt
from proxtpu_torch.tools import families as fam

jax.config.update("jax_enable_x64", True)


def _jax_solve(factory, maxit, tol, **kw):
    xs, iters, done = BatchedAlgorithm(factory, maxit=maxit, tol=tol,
                                       use_kernels=False)(**kw)
    xs = xs[0] if isinstance(xs, tuple) else xs
    return np.asarray(xs), np.asarray(iters), np.asarray(done)


def _port(out):
    xs, iters, done = out
    xs = xs[0] if isinstance(xs, tuple) else xs
    return xs.numpy(), iters.numpy(), done.numpy()


def _agree(port, ref, count_slack=0, atol=1e-8):
    (x_t, it_t, d_t), (x_j, it_j, d_j) = port, ref
    assert np.array_equal(d_t, d_j)
    assert np.max(np.abs(it_t.astype(int) - it_j.astype(int))) \
        <= count_slack, (it_t, it_j)
    np.testing.assert_allclose(x_t, x_j, rtol=0, atol=atol)


# ---------------------------------------------------------------------------
# the JAX side, as each script builds it


def svm_jax(data, variant, maxit=fam.SVM_MAXIT, tol=fam.SVM_TOL):
    A, y, lams, gam = (jnp.asarray(data[k]) for k in ("A", "y", "lams",
                                                      "gam"))
    B, (m, n) = lams.shape[0], A.shape
    if variant == "shared":
        h, L = Shared(jf.HingeLoss(y, 1.0 / m)), Shared(A)
    else:
        h = jf.HingeLoss(jnp.broadcast_to(y, (B, m)), 1.0 / m)
        L = jnp.asarray(np.broadcast_to(data["A"], (B, m, n)).copy())
    return _jax_solve(make_afba_iteration, maxit, tol,
                      x0=jnp.zeros((B, n), A.dtype),
                      y0=jnp.zeros((B, m), A.dtype), g=jf.SqrNormL2(lams),
                      h=h, L=L, theta=2.0, gamma1=gam, gamma2=gam)


def cvar_jax(data, k=fam.CVAR_K, maxit=fam.CVAR_MAXIT, tol=fam.CVAR_TOL):
    Ls, gam = jnp.asarray(data["Ls"]), jnp.asarray(data["gam"])
    B, S, n = Ls.shape
    return _jax_solve(make_chambolle_pock_iteration, maxit, tol,
                      x0=jnp.full((B, n), 1.0 / n, Ls.dtype),
                      y0=jnp.zeros((B, S), Ls.dtype), g=jf.IndSimplex(1.0),
                      h=jf.SumLargest(k, 1.0 / k), L=Ls, gamma1=gam,
                      gamma2=gam)


@jbase.proxclass
class MaskedQuadratic:
    """The smooth term of benchmarks/matrix_completion_bench.py."""

    mask: object
    M: object

    is_convex = True
    is_generalized_quadratic = True

    def __call__(self, X):
        r = self.mask * (X - self.M)
        return 0.5 * jnp.sum(r * r)

    def value_and_gradient(self, X):
        r = self.mask * (X - self.M)
        return 0.5 * jnp.sum(r * r), r


def mc_jax(data, lam=fam.MC_LAM, maxit=fam.MC_MAXIT, tol=fam.MC_TOL):
    masks, obs = jnp.asarray(data["masks"]), jnp.asarray(data["obs"])
    return _jax_solve(make_fast_forward_backward_iteration, maxit, tol,
                      x0=jnp.zeros_like(obs), f=MaskedQuadratic(masks, obs),
                      g=jf.NuclearNorm(lam), Lf=1.0)


def glasso_jax(data, lam=fam.GL_LAM, maxit=fam.GL_MAXIT, tol=fam.GL_TOL):
    Ss = jnp.asarray(data["Ss"])
    B, n, _ = Ss.shape
    eye = jnp.eye(n, dtype=Ss.dtype)
    return _jax_solve(make_douglas_rachford_iteration, maxit, tol,
                      x0=jnp.broadcast_to(eye, (B, n, n)),
                      f=Tilt(jf.NegLogDet(1.0), Ss),
                      g=Shared(jf.NormL1(lam * (1 - eye))),
                      gamma=fam.GL_GAMMA)


def logistic_jax(data, maxit=fam.LOG_MAXIT, tol=fam.LOG_TOL):
    A, b, lams = (jnp.asarray(data[k]) for k in ("A", "b", "lams"))
    B, (m, n) = lams.shape[0], A.shape
    f_log = jf.Translate(jf.LogisticLoss(1.0), -b)
    A_st = jnp.broadcast_to(A, (B, m, n))
    return _jax_solve(make_panoc_iteration, maxit, tol,
                      x0=jnp.zeros((B, n), A.dtype),
                      f=jax.vmap(lambda _: f_log)(jnp.arange(B)),
                      A=jax.vmap(MatrixOperator)(A_st),
                      g=jf.NormL1(lams), Lf=data["Lf"], adaptive=False)


# ---------------------------------------------------------------------------
# the families at the test size, float64

F64 = np.float64


@pytest.mark.parametrize("variant", ["shared", "stacked"])
def test_svm_path(variant):
    data = fam.svm_data(B=4, m=30, n=12, dtype=F64)
    port = _port(fam.svm_solve(data, variant, "cpu"))
    _agree(port, svm_jax(data, variant))
    assert port[2].all()


def test_svm_shared_and_stacked_agree():
    data = fam.svm_data(B=4, m=30, n=12, dtype=F64)
    sh = _port(fam.svm_solve(data, "shared", "cpu"))
    st = _port(fam.svm_solve(data, "stacked", "cpu"))
    assert np.array_equal(sh[1], st[1])
    np.testing.assert_allclose(sh[0], st[0], rtol=0, atol=1e-12)


CVAR_SMALL = dict(B=4, S=30, n_assets=5)


def test_cvar():
    data = fam.cvar_data(**CVAR_SMALL, dtype=F64)
    kw = dict(k=5, maxit=3000, tol=1e-4)
    port = _port(fam.cvar_solve(data, "cpu", **kw))
    _agree(port, cvar_jax(data, **kw))
    assert port[2].all()
    # x lies on the simplex, so its CVaR is at least the LP optimum; the
    # fixed-point tolerance leaves it within tol of it
    for L, x in zip(data["Ls"], port[0]):
        opt = fam.cvar_lp(L, k=5)
        assert opt - 1e-12 <= fam.cvar_value(L, x, k=5) <= opt + kw["tol"]


def test_matrix_completion():
    data = fam.mc_data(B=4, m=16, n=12, rank=2, dtype=F64)
    port = _port(fam.mc_solve(data, "cpu"))
    _agree(port, mc_jax(data))
    assert port[2].all()
    assert np.median(fam.mc_heldout_error(data, port[0])) < 0.25


def test_graphical_lasso():
    data = fam.glasso_data(B=4, n=8, dtype=F64)
    port = _port(fam.glasso_solve(data, "cpu"))
    _agree(port, glasso_jax(data))
    assert port[2].all()
    kkt = fam.kkt_residuals(data["Ss"], port[0], fam.GL_LAM)
    assert kkt.max() < 100 * fam.GL_TOL


@pytest.mark.parametrize("restart", [True, False])
def test_tv1d(restart):
    Y = fam.tv1d_data(B=4, n=64, dtype=F64)["Y"]
    Z_t, v_t = fam.tv1d_solve(torch.tensor(Y), restart)
    tv = jf.TotalVariation1D(fam.TV1D_LAM, restart=restart)
    Z_j, v_j = jax.vmap(lambda y: tv.prox(y, 1.0))(jnp.asarray(Y))
    np.testing.assert_allclose(Z_t.numpy(), np.asarray(Z_j), atol=1e-9)
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), atol=1e-9)
    for y, z in zip(Y, Z_t.numpy()):
        assert np.max(np.abs(z - fam.tv1d_condat(y, fam.TV1D_LAM))) < 1e-6
    trips = fam.tv1d_trips(torch.tensor(Y), restart)
    assert trips.shape == (4,) and int(trips.max()) < 2000


def test_sparse_logistic():
    """A tall design (strongly convex): the JAX package's counts within
    2 and its solutions."""
    data = fam.logistic_data(B=4, m=40, n=20, dtype=F64)
    port = _port(fam.logistic_solve(data, "cpu"))
    _agree(port, logistic_jax(data), count_slack=2)
    assert port[2].all()
    assert fam.logistic_recheck(data, port[0]).max() <= 2 * fam.LOG_TOL


def test_sparse_logistic_wide():
    """The script's aspect (n = 2m): at small lambda the problem is flat
    and PANOC's trajectory amplifies the last-bit differences of exp
    between XLA and PyTorch (2e-16 apart at iteration 2, 2e-6 at 40, 1e-1
    at 120 on lane 0), so the counts part (216 against 222) and the
    answers differ by 2e-3 while both certify: each package's answer
    passes the float64 forward-backward recheck at 2 tol."""
    data = fam.logistic_data(B=4, m=20, n=40, dtype=F64)
    port = _port(fam.logistic_solve(data, "cpu"))
    ref = logistic_jax(data)
    assert port[2].all() and ref[2].all()
    for xs in (port[0], ref[0]):
        assert fam.logistic_recheck(data, xs).max() <= 2 * fam.LOG_TOL


def test_tv1d_oracle_is_the_taut_string():
    """The float64 oracle against a brute-force check of the prox's
    optimality (the dual certificate |cumsum(y - x)| <= lam, with equality
    where x jumps)."""
    y = fam.tv1d_data(B=1, n=64, dtype=F64)["Y"][0]
    x = fam.tv1d_condat(y, 0.3)
    u = np.cumsum(y - x)[:-1]
    assert np.max(np.abs(u)) <= 0.3 + 1e-12 and abs(np.sum(y - x)) < 1e-12
    jumps = np.abs(np.diff(x)) > 1e-12
    np.testing.assert_allclose(np.abs(u[jumps]), 0.3, atol=1e-12)


# ---------------------------------------------------------------------------
# the JAX package's numbers behind chip_smoke.py's gates


def main():
    """CVaR at the published size, float32, at chip_smoke.py's cap: the
    JAX package's done share (the card's gate is this less 2 lanes) and
    the LP gap of its first 8 done lanes; logistic's float64 recheck."""
    import time

    from chip_smoke import CVAR_MAXIT

    data = fam.cvar_data()
    t0 = time.perf_counter()
    xs, iters, done = cvar_jax(data, maxit=CVAR_MAXIT)
    print(f"JAX CVaR, B 64, 250 x 8, K 25, float32, tol 1e-5, maxit "
          f"{CVAR_MAXIT} (CPU, {time.perf_counter() - t0:.1f} s): done "
          f"{int(done.sum())}/64, iterations median "
          f"{int(np.median(iters))} max {int(iters.max())}")
    for i in range(8):
        if done[i]:
            opt = fam.cvar_lp(data["Ls"][i])
            val = fam.cvar_value(data["Ls"][i], xs[i])
            print(f"  lane {i}: CVaR {val:.9f}, LP {opt:.9f}, relative "
                  f"gap {(val - opt) / abs(opt):.3e}")
    data = fam.logistic_data()
    xs, iters, done = logistic_jax(data)
    print(f"JAX logistic (bounded PANOC, stacked), B 256, 200 x 400, "
          f"float32: done {int(done.sum())}/256, iterations median "
          f"{int(np.median(iters))} max {int(iters.max())}, float64 "
          f"recheck max {fam.logistic_recheck(data, xs).max():.3e}")


if __name__ == "__main__":
    main()
