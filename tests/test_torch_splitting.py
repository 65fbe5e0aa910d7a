"""SFISTA, Li-Lin, Davis-Yin, the nonconvex QP and the L0 prox set on the
port, against the JAX reference, on the CPU.

* SFISTA on the strongly convex lasso (``tests/test_strongly_convex.py``),
  classic and AIPP termination: the reference's oracle, and the JAX
  package's counts exactly in float64 with solutions within 1e-9.
* Li-Lin, PANOC, PANOCplus and ZeroFPR on ``tests/test_nonconvex_qp.py``'s
  tiny and random 100-d box QPs: its residual oracle, x0 unchanged, the JAX
  package's counts exactly and solutions within 1e-9; Li-Lin's theta
  restart and the NaN-safe monitor.
* Davis-Yin on the elastic net (``tests/test_elasticnet.py``) through the
  port's ``AutoDifferentiable``, real and complex.
* Each new prox function's value, prox and gradient against the JAX
  package's on numpy inputs, the stacked operator and the power iteration.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import proxtpu as pa
import proxtpu_torch as pt
from problems import (
    ENET_XSTAR,
    LASSO_A,
    LASSO_B,
    SC_XSTAR,
    strongly_convex_lasso,
)
from proxtpu.prox import base as jbase
from proxtpu.prox import combinators as jc
from proxtpu.prox import functions as jf
from proxtpu_torch.prox import combinators as tc
from proxtpu_torch.prox import functions as tf
from test_linear_programs import A_LP, B_LP
from test_nonconvex_qp import random_problem, residual_ok, tiny_problem


def _t(a, dtype=None):
    a = np.asarray(a)
    return torch.tensor(a if dtype is None else a.astype(dtype))


# ---------------------------------------------------------------------------
# SFISTA

MF, LF = 1.0, 10.0


def _sc(lib, dtype):
    A, b, lam, x0 = strongly_convex_lasso(MF, LF)
    A, b, x0 = A.astype(dtype), b.astype(dtype), x0.astype(dtype)
    if lib == "jax":
        Aj, bj = jnp.asarray(A), jnp.asarray(b)
        f = pa.AutoDifferentiable(
            lambda x: 0.5 * jnp.real(jnp.vdot(Aj @ x - bj, Aj @ x - bj)))
        return pa, dict(x0=jnp.asarray(x0), f=f, g=jf.NormL1(lam))
    At, bt = _t(A), _t(b)
    f = pt.AutoDifferentiable(
        lambda x: 0.5 * torch.real(torch.vdot(At @ x - bt, At @ x - bt)))
    return pt, dict(x0=_t(x0), f=f, g=tf.NormL1(lam))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("termination", ["", "AIPP"])
def test_sfista(dtype, termination):
    tol, maxit = (1e-4, 10_000) if not termination else (1e-6, 200)
    m, kw = _sc("torch", dtype)
    y, it = m.SFISTA(tol=tol, maxit=maxit)(Lf=LF, mf=MF,
                                           termination_type=termination,
                                           **kw)
    assert y.dtype == getattr(torch, dtype)
    err = float(torch.linalg.norm(y.double() - _t(SC_XSTAR)))
    if termination:
        assert err <= 1e-2
    else:
        assert err <= tol and it < 40
    if dtype == "float64":
        m, kw = _sc("jax", dtype)
        y_j, it_j = m.SFISTA(tol=tol, maxit=maxit)(
            Lf=LF, mf=MF, termination_type=termination, **kw)
        assert it == int(it_j)
        np.testing.assert_allclose(y.numpy(), np.asarray(y_j), rtol=0,
                                   atol=1e-9)


# ---------------------------------------------------------------------------
# nonconvex box QP

QP_SOLVERS = ["PANOC", "PANOCplus", "ZeroFPR", "LiLin"]
QP_TOL = 1e-4


def _qp(lib, Q, q, low, upp):
    if lib == "jax":
        return jf.Quadratic(jnp.asarray(Q), jnp.asarray(q)), jf.IndBox(low,
                                                                      upp)
    return tf.Quadratic(_t(Q), _t(q)), tf.IndBox(low, upp)


def _qp_solve(lib, name, problem, **extra):
    Q, q, low, upp, gamma = problem
    f, g = _qp(lib, Q, q, low, upp)
    n = q.shape[0]
    if lib == "jax":
        x0, m = jnp.zeros(n), pa
    else:
        x0, m = torch.zeros(n, dtype=torch.float64), pt
    kw = dict(x0=x0, f=f, g=g, **extra)
    if name == "LiLin":
        kw["gamma"] = gamma
    x, it = getattr(m, name)(tol=QP_TOL)(**kw)
    return x0, x, int(it)


@pytest.mark.parametrize("k", [0, 1, 2, 3, 4, 5])
@pytest.mark.parametrize("name", QP_SOLVERS)
def test_nonconvex_qp_matches_jax(name, k):
    """k = 0: the tiny 2-d QP; k = 1..5: the seeded 100-d ones."""
    problem = tiny_problem() if k == 0 else random_problem(k)
    x0, x, it = _qp_solve("torch", name, problem)
    Q, q, low, upp, gamma = problem
    assert residual_ok(x.numpy(), Q, q, low, upp, gamma, QP_TOL)
    assert bool((x0 == 0).all())
    _, x_j, it_j = _qp_solve("jax", name, problem)
    assert it == it_j
    np.testing.assert_allclose(x.numpy(), np.asarray(x_j), rtol=0,
                               atol=1e-9)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_lilin_theta_restart(k):
    problem = random_problem(k)
    _, x, it = _qp_solve("torch", "LiLin", problem, theta_restart=True)
    Q, q, low, upp, gamma = problem
    assert residual_ok(x.numpy(), Q, q, low, upp, gamma, QP_TOL)
    _, x_j, it_j = _qp_solve("jax", "LiLin", problem, theta_restart=True)
    assert it == it_j


def test_lilin_nan_monitor_recovers():
    """A NaN objective at z fails the monitor (NaN <= thresh is False), so
    the plain FB step from x runs and the moving average stays finite."""
    from proxtpu_torch.algorithms.li_lin import LiLinIteration

    f, g = _qp("torch", np.diag([1.0, 1.0]), np.array([0.1, -0.2]), -1.0,
               1.0)
    one = lambda v: torch.tensor(v, dtype=torch.float64)  # noqa: E731
    it = LiLinIteration(f=f, g=g, x0=torch.zeros(2, dtype=torch.float64),
                        gamma=one(0.5), delta=one(1e-3), eta=one(0.8))
    s0 = it.init()
    s1 = it.step(s0._replace(z=torch.tensor([float("nan"), 0.0],
                                            dtype=torch.float64)))
    assert bool(torch.isfinite(s1.x).all())
    assert bool(torch.isfinite(s1.F_average))


def test_lilin_requires_a_feasible_start():
    f, g = _qp("torch", np.eye(2), np.zeros(2), -1.0, 1.0)
    with pytest.raises(ValueError, match="feasible"):
        pt.LiLin()(x0=torch.full((2,), 2.0, dtype=torch.float64), f=f, g=g,
                   gamma=0.5)
    with pytest.raises(ValueError, match="Lf or gamma"):
        pt.LiLin()(x0=torch.zeros(2, dtype=torch.float64), f=f, g=g)


# ---------------------------------------------------------------------------
# Davis-Yin on the elastic net


@pytest.mark.parametrize("start", ["zero", "random"])
@pytest.mark.parametrize("dtype", ["float32", "float64", "complex64",
                                   "complex128"])
def test_davis_yin_elastic_net(dtype, start):
    A, b = _t(LASSO_A, dtype), _t(LASSO_B, dtype)
    cost = pt.AutoDifferentiable(
        lambda x: 0.5 * torch.real(torch.vdot(A @ x - b, A @ x - b)))
    Lf = float(np.linalg.norm(LASSO_A, 2) ** 2)
    x0 = (np.zeros(5) if start == "zero"
          else np.random.default_rng(0).standard_normal(5))
    x, it = pt.DavisYin(tol=1e-6)(x0=_t(x0, dtype), f=cost,
                                  g=tf.NormL1(1.0), h=tf.SqrNormL2(1.0),
                                  Lf=Lf)
    assert x.dtype == getattr(torch, dtype)
    assert float(torch.max(torch.abs(x - _t(ENET_XSTAR)))) <= 1e-3
    if start == "zero":
        assert it <= 140
    if dtype in ("float64", "complex128"):
        Aj, bj = jnp.asarray(LASSO_A.astype(dtype)), jnp.asarray(
            LASSO_B.astype(dtype))
        cost_j = pa.AutoDifferentiable(
            lambda x: 0.5 * jnp.real(jnp.vdot(Aj @ x - bj, Aj @ x - bj)))
        x_j, it_j = pa.DavisYin(tol=1e-6)(
            x0=jnp.asarray(x0.astype(dtype)), f=cost_j, g=jf.NormL1(1.0),
            h=jf.SqrNormL2(1.0), Lf=Lf)
        assert it == int(it_j)
        np.testing.assert_allclose(x.numpy(), np.asarray(x_j), rtol=0,
                                   atol=1e-9)


# ---------------------------------------------------------------------------
# the L0 prox set and operators against the JAX package


def _prox_pairs():
    rng = np.random.default_rng(3)
    c = rng.standard_normal(6)
    p = rng.standard_normal(6)
    A = rng.standard_normal((3, 6))
    b = rng.standard_normal(3)
    slices = ((0, 2), (2, 6))
    return {
        "Linear": (jf.Linear(jnp.asarray(c)), tf.Linear(_t(c))),
        "IndNonnegative": (jf.IndNonnegative(), tf.IndNonnegative()),
        "IndPoint": (jf.IndPoint(jnp.asarray(p)), tf.IndPoint(_t(p))),
        "IndAffine": (jf.make_ind_affine(jnp.asarray(A), jnp.asarray(b)),
                      tf.make_ind_affine(_t(A), _t(b))),
        "SlicedSeparableSum": (
            jc.SlicedSeparableSum((jf.NormL1(0.4), jf.IndNonnegative()),
                                  slices),
            tc.SlicedSeparableSum((tf.NormL1(0.4), tf.IndNonnegative()),
                                  slices)),
        "AutoDifferentiable": (
            pa.AutoDifferentiable(lambda x: jnp.sum(jnp.sin(x) * x)),
            pt.AutoDifferentiable(lambda x: torch.sum(torch.sin(x) * x))),
    }


@pytest.mark.parametrize("name", list(_prox_pairs()))
def test_prox_functions_match_jax(name):
    f_j, f_t = _prox_pairs()[name]
    rng = np.random.default_rng(4)
    for x in (rng.standard_normal(6), np.abs(rng.standard_normal(6)),
              np.zeros(6)):
        xj, xt = jnp.asarray(x), _t(x)
        np.testing.assert_allclose(float(f_t(xt)), float(f_j(xj)),
                                   rtol=1e-12)
        if hasattr(f_j, "prox"):
            z_j, v_j = pa.prox(f_j, xj, 0.37)
            z_t, v_t = pt.prox.prox(f_t, xt, 0.37)
            np.testing.assert_allclose(z_t.numpy(), np.asarray(z_j),
                                       atol=1e-12)
            np.testing.assert_allclose(float(v_t), float(v_j), rtol=1e-12,
                                       atol=1e-15)
            # the prox point is feasible: the value there is finite
            assert np.isfinite(float(f_t(z_t))) or name == "IndAffine"
        if hasattr(f_j, "value_and_gradient"):
            v_j, g_j = pa.value_and_gradient(f_j, xj)
            v_t, g_t = pt.prox.value_and_gradient(f_t, xt)
            np.testing.assert_allclose(float(v_t), float(v_j), rtol=1e-12)
            np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j),
                                       atol=1e-12)
    assert pt.prox.is_convex(f_t) == jbase.is_convex(f_j)
    assert (pt.prox.is_generalized_quadratic(f_t)
            == jbase.is_generalized_quadratic(f_j))


def test_ind_affine_projects():
    A, b = _t(A_LP), _t(B_LP)
    f = tf.make_ind_affine(A, b)
    z, _ = f.prox(torch.ones(A_LP.shape[1], dtype=torch.float64), 1.0)
    assert float(torch.max(torch.abs(A @ z - b))) <= 1e-12
    assert float(f(z)) == 0 and float(f(z + 1)) == float("inf")


def test_autodifferentiable_complex_gradient_is_not_conjugated():
    """For f(x) = ||x - a||^2 / 2 on C^n the descent gradient is x - a, as
    the reference's Zygote gives it and the JAX package makes it."""
    a = torch.tensor([1 + 2j, -0.5j], dtype=torch.complex128)
    x = torch.tensor([0.3 - 1j, 2 + 0.5j], dtype=torch.complex128)
    f = pt.AutoDifferentiable(lambda u: 0.5 * torch.sum(torch.abs(u - a)
                                                        ** 2))
    val, grad = f.value_and_gradient(x)
    torch.testing.assert_close(grad, x - a)
    fj = pa.AutoDifferentiable(
        lambda u: 0.5 * jnp.sum(jnp.abs(u - jnp.asarray(a.numpy())) ** 2))
    np.testing.assert_allclose(
        grad.numpy(), np.asarray(fj.value_and_gradient(
            jnp.asarray(x.numpy()))[1]), atol=1e-15)
    assert pt.prox.is_smooth(f) and pt.prox.is_smooth(lambda u: u)
    assert not pt.prox.is_smooth(pt.ops.MatrixOperator(a))
    assert pt.prox.is_smooth(tf.NormL1(1.0)) == jbase.is_smooth(
        jf.NormL1(1.0))  # callable, as in the JAX package


def test_vstack_operator_and_power_iteration():
    rng = np.random.default_rng(5)
    A1, A2 = rng.standard_normal((3, 4)), rng.standard_normal((2, 4))
    x, y = rng.standard_normal(4), rng.standard_normal(5)
    j = pa.ops.VStackOperator((pa.ops.MatrixOperator(
        jnp.asarray(A1)), pa.ops.MatrixOperator(jnp.asarray(A2))))
    t = pt.ops.VStackOperator((pt.ops.MatrixOperator(_t(A1)),
                               pt.ops.MatrixOperator(_t(A2))))
    np.testing.assert_allclose(t.matvec(_t(x)).numpy(),
                               np.asarray(j.matvec(jnp.asarray(x))),
                               atol=1e-13)
    np.testing.assert_allclose(t.rmatvec(_t(y)).numpy(),
                               np.asarray(j.rmatvec(jnp.asarray(y))),
                               atol=1e-13)
    nrm = float(np.linalg.norm(np.vstack([A1, A2]), 2))
    assert float(t.opnorm()) == pytest.approx(nrm, rel=1e-12)
    assert float(j.opnorm()) == pytest.approx(nrm, rel=1e-12)
    est = pt.ops.power_iteration_opnorm(t, torch.zeros(4,
                                                       dtype=torch.float64))
    assert float(est) == pytest.approx(nrm, rel=1e-6)
    C = A1 + 1j * rng.standard_normal((3, 4))
    g = torch.Generator().manual_seed(1)
    est = pt.ops.power_iteration_opnorm(
        pt.ops.MatrixOperator(_t(C)),
        torch.zeros(4, dtype=torch.complex128), iters=200, generator=g)
    assert float(est) == pytest.approx(float(np.linalg.norm(C, 2)),
                                       rel=1e-6)


def test_convert_carries_the_new_objects():
    rng = np.random.default_rng(6)
    A, b, c = rng.standard_normal((3, 6)), rng.standard_normal(3), \
        rng.standard_normal(6)
    objs = [
        jf.Linear(jnp.asarray(c)), jf.IndPoint(jnp.asarray(b)),
        jf.make_ind_affine(jnp.asarray(A), jnp.asarray(b)),
        jc.SlicedSeparableSum((jf.IndPoint(jnp.asarray(b)),
                               jf.IndNonnegative()), ((0, 3), (3, 9))),
    ]
    x = rng.standard_normal(9)
    for obj in objs:
        t = pt.prox_from_jax(obj, "cpu")
        assert type(t).__name__ == type(obj).__name__
        n = 9 if type(t).__name__ == "SlicedSeparableSum" else (
            6 if type(t).__name__ in ("Linear", "IndAffine") else 3)
        z_j, _ = pa.prox(obj, jnp.asarray(x[:n]), 0.5)
        z_t, _ = pt.prox.prox(t, _t(x[:n]), 0.5)
        np.testing.assert_allclose(z_t.numpy(), np.asarray(z_j), atol=1e-12)
    op = pt.linop_from_jax(pa.ops.VStackOperator((pa.ops.MatrixOperator(
        jnp.asarray(A)), pa.ops.MatrixOperator(jnp.eye(6)))), "cpu")
    assert isinstance(op, pt.ops.VStackOperator)
    assert op.matvec(_t(c)).shape == (9,)
    with pytest.raises(TypeError, match="JAX callable"):
        pt.prox_from_jax(pa.AutoDifferentiable(jnp.sum), "cpu")
