"""The port's primal-dual stack (AFBA, Vu-Condat, Chambolle-Pock, the
conjugate calculus, ``NormL21``, ``SqrDistance``, ``Translate`` and the 2-D
gradient operator) against the JAX reference, on the CPU.

The same numpy inputs go through both packages.  In float64 and complex128
the solvers give the JAX package's iteration counts exactly and its (x, y)
within 1e-10, and x within 1e-4 of the hardcoded solutions of
``tests/problems.py``; the default-stepsize engine gives the same numbers on
every branch; functions and operators agree within 1e-12.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import proxtpu as pa
import proxtpu_torch as pt
from problems import ENET_XSTAR, LASSO_A, LASSO_B, LASSO_XSTAR
from proxtpu.ops import linops as jops
from proxtpu.prox.base import convex_conjugate as j_conjugate
from proxtpu_torch.ops import linops as tops

# the packages, not the functions ``prox`` that their parents export
jprox = importlib.import_module("proxtpu.prox")
tprox = importlib.import_module("proxtpu_torch.prox")

DTYPES = ["float64", "complex128"]
AFBA_PARAMS = [(2, 0, 130), (1, 1, 2000), (0, 1, 320), (0, 0, 194),
               (1, 0, 130)]


def _t(a):
    return torch.tensor(np.asarray(a))


def _data(dtype):
    return LASSO_A.astype(dtype), LASSO_B.astype(dtype)


def _close(got, want, atol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=atol)


def _same_solve(j_out, t_out, x_star, budget):
    (x_j, y_j), it_j = j_out
    (x_t, y_t), it_t = t_out
    assert it_t == it_j and it_t <= budget
    assert str(x_t.dtype) == f"torch.{x_j.dtype}"
    assert str(y_t.dtype) == f"torch.{y_j.dtype}"
    _close(x_t, x_j, 1e-10)
    _close(y_t, y_j, 1e-10)
    assert float(np.max(np.abs(x_t.numpy() - x_star))) <= 1e-4


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("theta,mu,maxit", AFBA_PARAMS)
def test_afba_elastic_net_matches_jax(dtype, theta, mu, maxit):
    """The five (theta, mu) configurations of tests/test_elasticnet.py."""
    A, b = _data(dtype)
    m, n = A.shape
    j_out = pa.AFBA(theta=theta, mu=mu, tol=1e-6)(
        x0=jnp.zeros(n, dtype), y0=jnp.zeros(m, dtype),
        f=jprox.SqrNormL2(1.0), g=jprox.NormL1(1.0),
        h=jprox.Translate(jprox.SqrNormL2(1.0), jnp.asarray(-b)),
        L=jnp.asarray(A), beta_f=1)
    t_out = pt.AFBA(theta=theta, mu=mu, tol=1e-6)(
        x0=torch.zeros(n, dtype=_t(A).dtype),
        y0=torch.zeros(m, dtype=_t(A).dtype),
        f=tprox.SqrNormL2(1.0), g=tprox.NormL1(1.0),
        h=tprox.Translate(tprox.SqrNormL2(1.0), _t(-b)), L=_t(A), beta_f=1)
    _same_solve(j_out, t_out, ENET_XSTAR, maxit)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("route,budget", [("smooth_f", 80),
                                          ("h_equals_g", 100),
                                          ("h_compose_L", 150)])
def test_afba_lasso_routes_match_jax(dtype, route, budget):
    """The three AFBA routes of tests/test_lasso_small.py: a smooth f with
    beta_f (differentiated automatically: a complex gradient must come out
    in the reference's convention, conjugated once), the l1 term through
    the dual over L = I, and the data term as h(L x)."""
    A, b = _data(dtype)
    m, n = A.shape
    At, bt = _t(A), _t(b)
    Aj, bj = jnp.asarray(A), jnp.asarray(b)
    lam = 0.1 * float(np.max(np.abs(A.conj().T @ b)))
    Lf = float(np.linalg.norm(A, 2) ** 2)
    f_j = pa.AutoDifferentiable(
        lambda x: 0.5 * jnp.real(jnp.vdot(Aj @ x - bj, Aj @ x - bj)))
    f_t = lambda x: 0.5 * torch.sum(torch.abs(At @ x - bt) ** 2)  # noqa: E731
    j_kw = dict(x0=jnp.zeros(n, dtype))
    t_kw = dict(x0=torch.zeros(n, dtype=At.dtype))
    if route == "smooth_f":
        j_kw.update(y0=jnp.zeros(n, dtype), f=f_j, g=jprox.NormL1(lam),
                    beta_f=Lf)
        t_kw.update(y0=torch.zeros(n, dtype=At.dtype), f=f_t,
                    g=tprox.NormL1(lam), beta_f=Lf)
    elif route == "h_equals_g":
        j_kw.update(y0=jnp.zeros(n, dtype), f=f_j, h=jprox.NormL1(lam),
                    beta_f=Lf)
        t_kw.update(y0=torch.zeros(n, dtype=At.dtype), f=f_t,
                    h=tprox.NormL1(lam), beta_f=Lf)
    else:
        j_kw.update(y0=jnp.zeros(m, dtype), g=jprox.NormL1(lam), L=Aj,
                    h=jprox.Translate(jprox.SqrNormL2(1.0), -bj))
        t_kw.update(y0=torch.zeros(m, dtype=At.dtype), g=tprox.NormL1(lam),
                    L=At, h=tprox.Translate(tprox.SqrNormL2(1.0), -bt))
    j_out = pa.AFBA(theta=1, mu=1, tol=1e-6)(**j_kw)
    t_out = pt.AFBA(theta=1, mu=1, tol=1e-6)(**t_kw)
    _same_solve(j_out, t_out, LASSO_XSTAR, budget)


@pytest.mark.parametrize("solver", ["VuCondat", "ChambollePock"])
def test_guarded_solvers_match_jax(solver):
    """Vu-Condat and Chambolle-Pock on the lasso with the data term as
    h(L x): the JAX package's counts and solutions."""
    A, b = _data("float64")
    m, n = A.shape
    lam = 0.1 * float(np.max(np.abs(A.T @ b)))
    j_out = getattr(pa, solver)(tol=1e-6)(
        x0=jnp.zeros(n), y0=jnp.zeros(m), g=jprox.NormL1(lam),
        h=jprox.Translate(jprox.SqrNormL2(1.0), jnp.asarray(-b)),
        L=jnp.asarray(A))
    t_out = getattr(pt, solver)(tol=1e-6)(
        x0=torch.zeros(n, dtype=torch.float64),
        y0=torch.zeros(m, dtype=torch.float64), g=tprox.NormL1(lam),
        h=tprox.Translate(tprox.SqrNormL2(1.0), _t(-b)), L=_t(A))
    _same_solve(j_out, t_out, LASSO_XSTAR, 2000)


# (theta, mu, beta_f, beta_l, ||L||): every branch of the stepsize engine
_STEPSIZE_CASES = [
    (2, 1, 0.0, 0.0, 3.0), (2, 1, 1.0, 0.0, 0.1), (2, 1, 0.0, 1.0, 0.1),
    (2, 0, 1.0, 1.0, 0.1),
    (1, 1, 1.0, 0.0, 3.0), (1, 1, 0.0, 0.0, 3.0), (1, 1, 0.1, 1.0, 0.001),
    (1, 1, 1.0, 0.01, 3.0),
    (0, 1, 0.0, 0.0, 3.0), (0, 1, 0.0, 10.0, 1.0), (0, 1, 1.0, 0.0, 30.0),
    (0, 1, 10.0, 1.0, 1.0), (0, 1, 1.0, 10.0, 1.0), (0, 1, 1.0, 1.0, 1.0),
    (0, 0, 0.0, 0.0, 3.0), (0, 0, 10.0, 0.0, 1.0), (1, 0, 1.0, 0.0, 30.0),
    (1, 0, 1.0, 1.0, 30.0), (0, 0, 10.0, 1.0, 1.0), (1, 0, 1.0, 10.0, 1.0),
    (0, 0, 1.0, 1.0, 1.0),
    (0, 0.5, 0.0, 0.0, 3.0), (0, 0.5, 10.0, 0.0, 1.0),
    (0, 0.5, 0.0, 10.0, 1.0), (0, 0.5, 1.0, 4.0, 1.0),
]


@pytest.mark.parametrize("theta,mu,beta_f,beta_l,nmL", _STEPSIZE_CASES)
def test_default_stepsizes_match_jax(theta, mu, beta_f, beta_l, nmL):
    M = np.diag([nmL, nmL / 2])
    got = pt.afba_default_stepsizes(tops.MatrixOperator(_t(M)),
                                    tprox.NormL1(1.0), theta, mu, beta_f,
                                    beta_l)
    want = pa.afba_default_stepsizes(jops.MatrixOperator(jnp.asarray(M)),
                                     jprox.NormL1(1.0), theta, mu, beta_f,
                                     beta_l)
    assert tuple(got) == pytest.approx(tuple(want), rel=1e-15, abs=0)


def test_default_stepsizes_h_zero_and_unsupported():
    got = pt.afba_default_stepsizes(tops.ZeroOperator(), tprox.Zero(), 1, 1,
                                    4.0, 0.0)
    want = pa.afba_default_stepsizes(jops.ZeroOperator(), jprox.Zero(), 1, 1,
                                     4.0, 0.0)
    assert tuple(got) == tuple(want) == (1.99 / 4.0, 1.0)
    for mod, ops, px in ((pt, tops, tprox), (pa, jops, jprox)):
        with pytest.raises(ValueError, match="not supported"):
            mod.afba_default_stepsizes(ops.IdentityOperator(),
                                       px.NormL1(1.0), 0.5, 0.3, 1.0, 0.0)


def _cp_kwargs(A, b, lam):
    return dict(x0=torch.zeros(A.shape[1], dtype=torch.float64),
                y0=torch.zeros(A.shape[0], dtype=torch.float64),
                g=tprox.SqrNormL2(lam), h=tprox.NormL1(lam), L=_t(A),
                gamma1=0.01, gamma2=0.01)


@pytest.mark.parametrize("solver,extra,match", [
    ("ChambollePock", dict(theta=1.0), "Chambolle-Pock"),
    ("ChambollePock", dict(f=tprox.Zero()), "Chambolle-Pock"),
    ("ChambollePock", dict(l=tprox.IndZero()), "Chambolle-Pock"),
    ("VuCondat", dict(theta=1.0, f=tprox.SqrNormL2(1.0), beta_f=1.0),
     "Vu-Condat"),
])
def test_guarded_factories_raise(solver, extra, match):
    """As tests/test_lasso_small.py:174-194: the named solvers reject the
    parameters that define them."""
    A, b = _data("float64")
    lam = 0.1 * float(np.max(np.abs(A.T @ b)))
    with pytest.raises(ValueError, match=match):
        getattr(pt, solver)(tol=1e-4, maxit=10)(**extra,
                                                **_cp_kwargs(A, b, lam))


@pytest.mark.parametrize("kwargs,match", [
    (dict(f=tprox.SqrNormL2(1.0)), "beta_f"),
    (dict(l=tprox.SqrNormL2(1.0)), "beta_l"),
    (dict(lam=0.5, h=tprox.NormL1(1.0)), "stepsizes manually"),
    (dict(l=tprox.NormL1(1.0), beta_l=1.0, gamma=(0.1, 0.1)),
     "smooth oracle"),
])
def test_make_afba_iteration_validates(kwargs, match):
    x0 = torch.zeros(3, dtype=torch.float64)
    with pytest.raises(ValueError, match=match):
        pt.make_afba_iteration(x0=x0, y0=x0, **kwargs)


def test_afba_defaults_for_L():
    x0 = torch.zeros(3, dtype=torch.float64)
    it = pt.make_afba_iteration(x0=x0, y0=x0, f=tprox.SqrNormL2(1.0),
                                beta_f=1.0)
    assert isinstance(it.L, tops.ZeroOperator)
    it = pt.make_afba_iteration(x0=x0, y0=x0, h=tprox.NormL1(1.0))
    assert isinstance(it.L, tops.IdentityOperator)
    assert float(it.theta) == 1.0 and it.theta.dtype == torch.float64


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", ["NormL21_axis0", "NormL21_axis1",
                                  "SqrDistance", "Translate", "Conjugate_l1",
                                  "Conjugate_l21"])
def test_functions_match_jax(name, dtype):
    rng = np.random.default_rng(3)
    shape = (2, 5, 4)
    draw = lambda: (rng.standard_normal(shape)  # noqa: E731
                    + (1j * rng.standard_normal(shape)
                       if dtype == "complex128" else 0)).astype(dtype)
    x, t = draw(), draw()
    x[:, 0, 0] = 0  # a zero group: the l2,1 prox must not divide by 0
    make = {
        "NormL21_axis0": lambda p, a: p.NormL21(0.7, axis=0),
        "NormL21_axis1": lambda p, a: p.NormL21(0.7, axis=1),
        "SqrDistance": lambda p, a: p.SqrDistance(a(t)),
        "Translate": lambda p, a: p.Translate(p.NormL1(0.4), a(t)),
        "Conjugate_l1": lambda p, a: p.Conjugate(p.NormL1(0.4)),
        "Conjugate_l21": lambda p, a: p.Conjugate(p.NormL21(0.7, axis=0)),
    }[name]
    f_j, f_t = make(jprox, jnp.asarray), make(tprox, _t)
    carried = pt.prox_from_jax(f_j, device="cpu") \
        if not name.startswith("Conjugate") else f_t
    assert type(carried) is type(f_t)
    for gamma in (0.3, 1.7):
        z_j, v_j = f_j.prox(jnp.asarray(x), gamma)
        for f in (f_t, carried):
            z_t, v_t = f.prox(_t(x), gamma)
            _close(z_t, z_j, 1e-12)
            assert abs(float(v_t) - float(v_j)) <= 1e-12
    if not name.startswith("Conjugate"):
        assert abs(float(f_t(_t(x))) - float(f_j(jnp.asarray(x)))) <= 1e-12
    if name == "SqrDistance":
        v_j, g_j = f_j.value_and_gradient(jnp.asarray(x))
        v_t, g_t = f_t.value_and_gradient(_t(x))
        _close(g_t, g_j, 1e-12)
        assert abs(float(v_t) - float(v_j)) <= 1e-12
    assert tprox.is_convex(f_t) == jprox.is_convex(f_j)
    assert tprox.is_generalized_quadratic(f_t) == \
        jprox.is_generalized_quadratic(f_j)


def test_translate_gradient_matches_jax():
    rng = np.random.default_rng(4)
    x, t = rng.standard_normal(6), rng.standard_normal(6)
    v_j, g_j = jprox.Translate(jprox.SqrNormL2(2.0),
                               jnp.asarray(t)).value_and_gradient(
        jnp.asarray(x))
    v_t, g_t = tprox.Translate(tprox.SqrNormL2(2.0),
                               _t(t)).value_and_gradient(_t(x))
    _close(g_t, g_j, 1e-12)
    assert abs(float(v_t) - float(v_j)) <= 1e-12


def test_convex_conjugate_cases():
    """Zero and IndZero are conjugate to each other, a Conjugate unwraps,
    SqrNormL2 stays smooth, anything else is wrapped: as in JAX."""
    assert isinstance(pt.convex_conjugate(tprox.Zero()), tprox.IndZero)
    assert isinstance(pt.convex_conjugate(tprox.IndZero()), tprox.Zero)
    g = tprox.NormL1(0.3)
    assert pt.convex_conjugate(tprox.Conjugate(g)) is g
    assert isinstance(pt.convex_conjugate(g), tprox.Conjugate)
    c_t = pt.convex_conjugate(tprox.SqrNormL2(4.0))
    c_j = j_conjugate(jprox.SqrNormL2(4.0))
    assert isinstance(c_t, tprox.SqrNormL2)
    assert float(c_t.lam) == float(c_j.lam) == 0.25


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(5, 7), (1, 4), (6, 1)])
def test_grad2d_matches_jax(shape, dtype):
    rng = np.random.default_rng(5)
    cplx = dtype == "complex128"
    draw = lambda s: (rng.standard_normal(s)  # noqa: E731
                      + (1j * rng.standard_normal(s) if cplx else 0)
                      ).astype(dtype)
    x, y = draw(shape), draw((2,) + shape)
    L_j, L_t = jops.Grad2DOperator(shape), tops.Grad2DOperator(shape)
    carried = pt.linop_from_jax(L_j, device="cpu")
    assert carried == L_t and carried.shape == shape
    Lx, Lty = L_t.matvec(_t(x)), L_t.rmatvec(_t(y))
    _close(Lx, L_j.matvec(jnp.asarray(x)), 1e-12)
    _close(Lty, L_j.rmatvec(jnp.asarray(y)), 1e-12)
    # <L x, y> = <x, L^H y>
    lhs = np.vdot(y, Lx.numpy())
    rhs = np.vdot(Lty.numpy(), x)
    assert abs(lhs - rhs) <= 1e-12
    assert L_t.opnorm() == L_j.opnorm()


def test_zero_operator_and_as_linop():
    x = _t(np.arange(3.0))
    Z = tops.ZeroOperator()
    assert not bool(Z.matvec(x).any()) and not bool(Z.rmatvec(x).any())
    assert Z.opnorm() == 0.0 == jops.ZeroOperator().opnorm()
    assert isinstance(tops.as_linop(None), tops.IdentityOperator)
    assert isinstance(tops.as_linop(_t(np.eye(3))), tops.MatrixOperator)
    assert tops.as_linop(Z) is Z
    shared = tops.as_linop(pt.Shared(_t(np.eye(3))))
    assert isinstance(shared, pt.Shared)
    assert isinstance(shared.value, tops.MatrixOperator)


@pytest.mark.parametrize("name", ["IdentityOperator", "ZeroOperator",
                                  "MatrixOperator", "array", "Shared"])
def test_linop_from_jax(name):
    M = np.arange(6.0).reshape(2, 3)
    src = {"IdentityOperator": jops.IdentityOperator(),
           "ZeroOperator": jops.ZeroOperator(),
           "MatrixOperator": jops.MatrixOperator(jnp.asarray(M)),
           "array": jnp.asarray(M),
           "Shared": pa.Shared(jops.MatrixOperator(jnp.asarray(M)))}[name]
    got = pt.linop_from_jax(src, device="cpu")
    if name == "array":
        assert isinstance(got, torch.Tensor)
        got = tops.as_linop(got)
    if name == "Shared":
        assert isinstance(got, pt.Shared)
        got = got.value
    if name in ("MatrixOperator", "array", "Shared"):
        assert isinstance(got, tops.MatrixOperator)
        np.testing.assert_array_equal(got.A.numpy(), M)
    else:
        assert type(got).__name__ == name
    # VStackOperator has a counterpart now; the sharded operator has none
    from proxtpu.parallel.sharded_ops import ShardedMatrixOperator

    with pytest.raises(TypeError, match="no port counterpart"):
        pt.linop_from_jax(ShardedMatrixOperator(jnp.asarray(M), None, None,
                                                None), device="cpu")
