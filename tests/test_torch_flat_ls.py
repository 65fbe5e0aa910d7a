"""The port's fixed-step flat machines (``proxtpu_torch.parallel.flat_ls``:
``batched_panoc``, ``batched_zerofpr``, ``batched_panocplus``) against the
JAX package's on the same numpy inputs, on the CPU in float64.

The oracle is the JAX package's flat machine: per lane the counts are held
exactly and the solutions within 1e-9, on quadratic f at
``max_backtracks`` 20 and 2 (the forced tau = 0 commit), with no
acceleration and with L-BFGS directions, at the ``maxit`` cap, with a
shared and a stacked operator, and with complex iterates.  The cases that
part from the JAX package's bits (a non-quadratic f; Anderson and Broyden
directions) are named and held apart in ``tests/test_torch_flat_named.py``;
DRLS is held in ``tests/test_torch_flat_drls.py``, the loop control in
``tests/test_torch_flat_loop.py``.

Run as a script, it prints the JAX package's float32 rechecks of its flat
machines on ``chip_smoke.py``'s flagship problems, from which that script
takes its gates of routes (m) and (o).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import proxtpu.accel as ja
import proxtpu.parallel.flat_ls as jfl
import proxtpu_torch as pt
import proxtpu_torch.parallel.flat_ls as tfl
from proxtpu.ops.linops import MatrixOperator as JMatrix
from proxtpu.prox import functions as jf
from proxtpu.utils.shared import Shared as JShared
from proxtpu_torch.ops.linops import MatrixOperator as TMatrix
from proxtpu_torch.prox import functions as tf
from proxtpu_torch.utils.shared import Shared as TShared

jax.config.update("jax_enable_x64", True)

TOL = 1e-6
# the float64 fixed-point recheck of a returned solution, in tol
RECHECK = 2
B, M, N = 6, 10, 16


def lasso(seed=0, dtype=np.float64):
    """``tests/test_flat_ls.py``'s stacked lassos."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((B, M, N))
    b = rng.standard_normal((B, M))
    if np.dtype(dtype).kind == "c":
        A = A + 1j * rng.standard_normal((B, M, N))
        b = b + 1j * rng.standard_normal((B, M))
    lam = 0.1 * np.max(np.abs(np.einsum("bmn,bm->bn", A.conj(), b)), axis=1)
    Lf = np.array([np.linalg.norm(A[i], 2) ** 2 for i in range(B)])
    return A, b, lam, Lf


def logistic(seed=1):
    """Its logistic problems: A / 2, lam 0.05, Lf = ||A||^2 / 4."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((B, M, N)) * 0.5
    lam = np.full(B, 0.05)
    Lf = np.array([np.linalg.norm(A[i], 2) ** 2 / 4 for i in range(B)])
    return A, lam, Lf


def _j(v):
    return jnp.asarray(v)


def _t(v):
    return torch.tensor(v)


def fag(kind, seed=0):
    """``(jax (f, A, g), port (f, A, g), x0 (B, N) numpy, Lf)`` of a
    stacked problem: ``lasso`` (quadratic f), ``logistic``, ``shared`` (one
    A for every lane, as a ``Shared`` operator) or ``complex``."""
    if kind == "logistic":
        A, lam, Lf = logistic(seed)
        j = (jf.LogisticLoss(jnp.ones(B)), JMatrix(_j(A)), jf.NormL1(_j(lam)))
        t = (tf.LogisticLoss(torch.ones(B, dtype=torch.float64)),
             TMatrix(_t(A)), tf.NormL1(_t(lam)))
        return j, t, np.zeros((B, N)), Lf
    A, b, lam, Lf = lasso(seed, np.complex128 if kind == "complex"
                          else np.float64)
    if kind == "shared":
        A = np.broadcast_to(A[0], A.shape)
        Lf = np.full(B, Lf[0])
        jA, tA = JShared(JMatrix(_j(A[0]))), TShared(TMatrix(_t(A[0])))
    else:
        jA, tA = JMatrix(_j(A)), TMatrix(_t(A))
    j = (jf.SqrDistance(_j(b)), jA, jf.NormL1(_j(lam)))
    t = (tf.SqrDistance(_t(b)), tA, tf.NormL1(_t(lam)))
    return j, t, np.zeros((B, N), A.dtype), Lf


_DIRS = {
    "lbfgs": (lambda: ja.LBFGS(5), lambda: pt.LBFGS(5)),
    "none": (ja.NoAcceleration, pt.NoAcceleration),
    "anderson": (lambda: ja.AndersonAcceleration(5),
                 lambda: pt.AndersonAcceleration(5)),
    "broyden": (ja.Broyden, pt.Broyden),
}


def both(machine, kind="lasso", seed=0, gamma_mult=0.95, directions="lbfgs",
         **kw):
    """The JAX and the port's ``batched_<machine>`` on the same problem."""
    (jfo, jA, jg), (tfo, tA, tg), x0, Lf = fag(kind, seed)
    gamma = gamma_mult / Lf
    jd, td = _DIRS[directions]
    ref = getattr(jfl, f"batched_{machine}")(
        jfo, jA, jg, _j(x0), _j(gamma), TOL, directions=jd(), **kw)
    port = getattr(tfl, f"batched_{machine}")(
        tfo, tA, tg, _t(x0), _t(gamma), TOL, directions=td(), **kw)
    return ref, port


def assert_same(ref, port, atol=1e-9):
    z_r, k_r, d_r = (np.asarray(v) for v in ref)
    z_p, k_p, d_p = (v.numpy() for v in port)
    np.testing.assert_array_equal(k_p, k_r)
    np.testing.assert_array_equal(d_p, d_r)
    np.testing.assert_allclose(z_p, z_r, rtol=0, atol=atol)


def fb_residual(kind, seed, x, gamma_mult=0.95):
    """Per lane ||x - prox(x - gamma A^T grad f(Ax))||_inf / gamma in
    float64 on the host: the fixed-point recheck."""
    if kind == "logistic":
        A, lam, Lf = logistic(seed)
        grad = lambda i: A[i].T @ (1 / (1 + np.exp(-A[i] @ x[i])) - 1)
    else:
        A, b, lam, Lf = lasso(seed)
        grad = lambda i: A[i].T @ (A[i] @ x[i] - b[i])
    out = []
    for i in range(B):
        gam = gamma_mult / Lf[i]
        y = x[i] - gam * grad(i)
        z = np.sign(y) * np.maximum(np.abs(y) - gam * lam[i], 0)
        out.append(np.max(np.abs(x[i] - z)) / gam)
    return np.array(out)


@pytest.mark.parametrize("machine", ["panoc", "zerofpr", "panocplus"])
@pytest.mark.parametrize("max_backtracks", [20, 2])
def test_fixed_machines_match_jax(machine, max_backtracks):
    """Quadratic f (PANOC's interpolation shortcut) with the forced
    tau = 0 commit at max_backtracks = 2."""
    ref, port = both(machine, maxit=2000, max_backtracks=max_backtracks)
    assert bool(port[2].all())
    assert_same(ref, port)


@pytest.mark.parametrize("machine,tol", [("panoc", TOL), ("zerofpr", 1e-4)])
def test_no_acceleration_matches_jax(machine, tol):
    """The negative residual as the direction (ZeroFPR at tol 1e-4, as in
    ``tests/test_flat_ls.py``: plain directions converge slowly here)."""
    (jfo, jA, jg), (tfo, tA, tg), x0, Lf = fag("lasso", 2)
    gamma = 0.95 / Lf
    ref = getattr(jfl, f"batched_{machine}")(
        jfo, jA, jg, _j(x0), _j(gamma), tol, maxit=5000,
        directions=ja.NoAcceleration())
    port = getattr(tfl, f"batched_{machine}")(
        tfo, tA, tg, _t(x0), _t(gamma), tol, maxit=5000,
        directions=pt.NoAcceleration())
    assert bool(port[2].all())
    assert_same(ref, port)


@pytest.mark.parametrize("machine", ["panoc", "zerofpr", "panocplus"])
def test_maxit_cap(machine):
    ref, port = both(machine, maxit=7)
    # tol 1e-6 is not reached in 7 iterations: every lane stops at the cap
    assert not bool(port[2].any())
    assert (port[1] == 7).all()
    assert_same(ref, port)


@pytest.mark.parametrize("machine", ["panoc", "zerofpr", "panocplus"])
@pytest.mark.parametrize("kind", ["shared", "complex"])
def test_shared_operator_and_complex_match_jax(machine, kind):
    """A ``Shared`` operator (one product for every lane) and complex
    iterates (gamma in the real dtype, conjugated inner products)."""
    ref, port = both(machine, kind, maxit=2000)
    assert bool(port[2].all())
    if kind == "complex":
        assert port[0].dtype == torch.complex128
    assert_same(ref, port)


def stack(objs):
    """One function object whose tensor fields stack those of ``objs``."""
    import dataclasses

    first = objs[0]
    return dataclasses.replace(first, **{
        f.name: torch.stack([getattr(o, f.name) for o in objs])
        for f in dataclasses.fields(first)
        if isinstance(getattr(first, f.name), torch.Tensor)})


def stacked_least_squares(A, b):
    return stack([tf.make_least_squares(_t(A[i]), _t(b[i]))
                  for i in range(A.shape[0])])


def recheck64(As, bs, lams, Lfs, xs):
    """Per lane the forward-backward residual of a lasso solution at
    gamma = 1 / Lf in float64 (``chip_smoke.py``'s gate of the flat
    routes)."""
    As, bs, lams, Lfs, xs = (np.asarray(v, np.float64)
                             for v in (As, bs, lams, Lfs, xs))
    gam = (1.0 / Lfs)[:, None]
    grad = np.einsum("bmn,bm->bn", As, np.einsum("bmn,bn->bm", As, xs) - bs)
    y = xs - gam * grad
    z = np.sign(y) * np.maximum(np.abs(y) - gam * lams[:, None], 0.0)
    return np.max(np.abs(xs - z), axis=1) / gam[:, 0]


def flagship_rechecks():
    """The JAX package's flat machines in float32 on the CPU on
    ``chip_smoke.py``'s problems of routes (m) and (o)
    (``bench.gen_problems(256)``, tol 1e-5): ``(name, iterations mean,
    max, done, worst float64 recheck)``."""
    import bench
    import proxtpu.parallel.adaptive_batch as jab

    As, bs, lams, Lfs = bench.gen_problems(256)
    f = jf.SqrDistance(_j(bs))
    g = jf.NormL1(_j(lams))
    A = JMatrix(_j(As))
    x0 = jnp.zeros((As.shape[0], As.shape[2]), jnp.float32)
    gam = _j(0.95 / Lfs)
    runs = {
        "panoc": lambda: jfl.batched_panoc(f, A, g, x0, gam, 1e-5,
                                           maxit=2000),
        "zerofpr": lambda: jfl.batched_zerofpr(f, A, g, x0, gam, 1e-5,
                                               maxit=2000),
        "panocplus": lambda: jfl.batched_panocplus(f, A, g, x0, gam, 1e-5,
                                                   maxit=2000),
        "adaptive_fista": lambda: jab.batched_adaptive_fista(
            jax.vmap(jf.LeastSquaresLoss)(_j(As), _j(bs)), g, x0, 1e-5,
            maxit=8000, check_every=8),
        "adaptive_panoc": lambda: jfl.batched_panoc(
            f, A, g, x0, 10 * gam, 1e-5, maxit=2000, adaptive=True,
            check_every=8),
    }
    for name, run in runs.items():
        z, it, done = (np.asarray(v) for v in run())
        yield (name, float(it.mean()), int(it.max()), int(done.sum()),
               float(recheck64(As, bs, lams, Lfs, z).max()))


if __name__ == "__main__":
    # PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_flat_ls.py
    for row in flagship_rechecks():
        print("{:16s} iterations mean {:.2f} max {:d} done {:d} "
              "recheck {:.6e}".format(*row), flush=True)
