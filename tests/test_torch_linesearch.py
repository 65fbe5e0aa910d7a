"""The port's line-search family (ZeroFPR, PANOC, PANOCplus, Douglas-Rachford
and DRLS with its five directions) against the JAX reference on the lasso of
``tests/problems.py``, on the CPU.

In float64 the port gives the JAX package's iteration counts exactly and
its solutions within 1e-9, at the reference tests' tolerances
(``tests/test_lasso_linesearch.py``: 1e-4, DRLS 1e-3) and at 1e-8.  In
float32, complex64 and complex128 the port meets the reference's oracle:
``x_star`` within 1e-4 (DRLS 1e-3) inside its iteration budgets.  The
equivalences of ``tests/test_equivalence.py`` hold on the port: DR = DRLS,
FB = PANOC, PANOC = PANOCplus.  The masked searches (``backtrack_limit``,
the form that runs under ``torch.func.vmap``) give the host searches'
counts and solutions exactly on one problem.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import proxtpu as pa
import proxtpu_torch as pt
from problems import LASSO_A, LASSO_B, LASSO_XSTAR
from proxtpu.prox import functions as jf
from proxtpu_torch.prox import functions as tf
from test_torch_linesearch_batch import BATCHED, _lane_kwargs, _problems

TOL = 1e-4

# (solver, options, reference iteration budget)
_LS = {
    "zerofpr_fixed": ("ZeroFPR", {}, 20),
    "zerofpr_adaptive": ("ZeroFPR", {"adaptive": True}, 20),
    "panoc_fixed": ("PANOC", {}, 20),
    "panoc_adaptive": ("PANOC", {"adaptive": True}, 20),
    "panocplus_fixed": ("PANOCplus", {}, 20),
    "panocplus_adaptive": ("PANOCplus", {"adaptive": True}, 20),
}
_DIRECTIONS = {
    "lbfgs": (lambda m: m.LBFGS(5), 17),
    "broyden": (lambda m: m.Broyden(), 19),
    "anderson": (lambda m: m.AndersonAcceleration(5), 12),
    "nes-fixed": (lambda m: m.NesterovExtrapolation(
        m.FixedNesterovSequence()), 36),
    "nes-simple": (lambda m: m.NesterovExtrapolation(
        m.SimpleNesterovSequence()), 36),
}
CASES = (list(_LS) + ["douglas_rachford"]
         + [f"drls_{d}" for d in _DIRECTIONS])


def _setup(lib, dtype):
    """The reference test's problem in one package: kwargs, solver, its
    options, the tolerance scale and the iteration budget."""
    A = LASSO_A.astype(dtype)
    b = LASSO_B.astype(dtype)
    lam = 0.1 * float(np.max(np.abs(A.conj().T @ b)))
    Lf = float(np.linalg.norm(LASSO_A, 2) ** 2)
    if lib == "jax":
        m, fns, arr = pa, jf, jnp.asarray
        x0 = jnp.zeros(5, dtype)
    else:
        m, fns, arr = pt, tf, torch.tensor
        x0 = torch.zeros(5, dtype=getattr(torch, dtype))
    return m, fns, arr(A), arr(b), lam, Lf, x0


def _case(case, lib, dtype):
    m, fns, A, b, lam, Lf, x0 = _setup(lib, dtype)
    g = fns.NormL1(lam)
    if case in _LS:
        name, opts, budget = _LS[case]
        kw = dict(x0=x0, f=fns.SqrDistance(b), A=A, g=g)
        if not opts:
            kw["Lf"] = Lf
        return getattr(m, name), opts, kw, 1, budget
    fA_prox = fns.make_least_squares(A, b)
    if case == "douglas_rachford":
        return (m.DouglasRachford, {"gamma": 10.0 / Lf},
                dict(x0=x0, f=fA_prox, g=g), 1, 30)
    make, budget = _DIRECTIONS[case[len("drls_"):]]
    return (m.DRLS, {"directions": make(m)},
            dict(x0=x0, f=fA_prox, g=g, Lf=Lf), 10, budget)


@pytest.mark.parametrize("tol", [TOL, 1e-8])
@pytest.mark.parametrize("case", CASES)
def test_float64_matches_jax(case, tol):
    j_solver, j_opts, j_kw, scale, _ = _case(case, "jax", "float64")
    t_solver, t_opts, t_kw, _, _ = _case(case, "torch", "float64")
    x_j, it_j = j_solver(tol=scale * tol, **j_opts)(**j_kw)
    x_t, it_t = t_solver(tol=scale * tol, **t_opts)(**t_kw)
    assert x_t.dtype == torch.float64
    assert it_t == int(it_j)
    np.testing.assert_allclose(x_t.numpy(), np.asarray(x_j), rtol=0,
                               atol=1e-9)


@pytest.mark.parametrize("dtype", ["float32", "float64", "complex64",
                                   "complex128"])
@pytest.mark.parametrize("case", CASES)
def test_reference_oracle(case, dtype):
    solver, opts, kw, scale, budget = _case(case, "torch", dtype)
    x, it = solver(tol=scale * TOL, **opts)(**kw)
    assert x.dtype == getattr(torch, dtype)
    err = float(torch.max(torch.abs(x - torch.tensor(LASSO_XSTAR))))
    assert err <= scale * TOL
    assert it < budget


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_dr_equals_drls(dtype):
    """DR == DRLS(no acceleration, lambda = 1, c = -inf, one trial)."""
    _, _, A, b, lam, Lf, x0 = _setup("torch", dtype)
    f, g = tf.make_least_squares(A, b), tf.NormL1(lam)
    gamma = 10.0 / Lf
    dr = pt.make_douglas_rachford_iteration(f=f, g=g, x0=x0, gamma=gamma)
    drls = pt.make_drls_iteration(f=f, g=g, x0=x0, gamma=gamma, lam=1.0,
                                  c=-float("inf"), max_backtracks=1,
                                  directions=pt.NoAcceleration())
    s1, s2 = dr.init(), drls.init()
    for _ in range(10):
        np.testing.assert_allclose(
            s1.x.numpy(), s2.xbar.numpy(),
            rtol=2e-5 if dtype == "float32" else 1e-12)
        s1, s2 = dr.step(s1), drls.step(s2)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_fb_equals_panoc(dtype):
    """FB == PANOC(no acceleration, one trial)."""
    _, _, A, b, lam, Lf, x0 = _setup("torch", dtype)
    g = tf.NormL1(lam)
    gamma = 0.95 / Lf
    fx = pt.AutoDifferentiable(lambda x: 0.5 * torch.sum((A @ x - b) ** 2))
    fb = pt.make_forward_backward_iteration(f=fx, g=g, x0=x0, gamma=gamma)
    panoc = pt.make_panoc_iteration(f=tf.SqrDistance(b), A=A, g=g, x0=x0,
                                    gamma=gamma, max_backtracks=1,
                                    directions=pt.NoAcceleration())
    s1, s2 = fb.init(), panoc.init()
    for _ in range(10):
        np.testing.assert_allclose(
            s1.z.numpy(), s2.z.numpy(),
            rtol=2e-5 if dtype == "float32" else 1e-12)
        s1, s2 = fb.step(s1), panoc.step(s2)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_panoc_equals_panocplus(dtype):
    """PANOC == PANOCplus on a globally smooth problem."""
    _, _, A, b, lam, Lf, x0 = _setup("torch", dtype)
    kw = dict(f=tf.SqrDistance(b), A=A, g=tf.NormL1(lam), x0=x0,
              gamma=0.95 / Lf)
    panoc = pt.make_panoc_iteration(**kw)
    pplus = pt.make_panocplus_iteration(**kw)
    s1, s2 = panoc.init(), pplus.init()
    for _ in range(10):
        np.testing.assert_allclose(
            s1.z.numpy(), s2.z.numpy(),
            rtol=1e-4 if dtype == "float32" else 1e-10)
        s1, s2 = panoc.step(s1), pplus.step(s2)


def test_verbose_display(capsys):
    _, _, A, b, lam, Lf, x0 = _setup("torch", "float64")
    pt.PANOC(tol=1e-8, verbose=True, freq=5)(
        x0=x0, f=tf.SqrDistance(b), A=A, g=tf.NormL1(lam), Lf=Lf)
    rows = [r.split("|") for r in capsys.readouterr().out.splitlines()]
    assert len(rows) >= 2 and all(len(r) == 4 for r in rows)
    assert [int(r[0]) for r in rows[:2]] == [5, 10]


def test_unsupported_direction_raises():
    _, _, A, b, lam, Lf, x0 = _setup("torch", "float64")
    with pytest.raises(ValueError, match="not supported"):
        pt.PANOC(directions=pt.NesterovExtrapolation())(
            x0=x0, f=tf.SqrDistance(b), A=A, g=tf.NormL1(lam), Lf=Lf)


@pytest.mark.parametrize("name,with_lf", BATCHED)
def test_masked_search_matches_host_search(name, with_lf):
    """One problem, no vmap: ``backtrack_limit`` makes every search a
    masked loop of fixed trips, with the host searches' results."""
    kw = _lane_kwargs("torch", *_problems()[5], with_lf)
    x_h, it_h = getattr(pt, name)(tol=1e-6)(**kw)
    x_m, it_m = getattr(pt, name)(tol=1e-6, backtrack_limit=32)(**kw)
    assert it_m == it_h
    np.testing.assert_array_equal(x_m.numpy(), x_h.numpy())
