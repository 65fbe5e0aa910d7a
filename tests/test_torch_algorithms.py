"""The port's generic stack (prox functions, sequences, FB and FISTA, the
batched driver) against the JAX reference, on the CPU in float64.

Single problems: the README's quick-start lasso reaches the hardcoded
``x_star`` within 1e-5, and on ``tests/test_lasso_small.py``'s problem the
fixed, adaptive and autodiff variants give the JAX package's counts exactly
and its solutions within 1e-9.  Batched: ``BatchedAlgorithm(use_kernels=
False)`` gives the JAX package's counts exactly and solutions within 1e-9.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import proxtpu as pa
import proxtpu_torch as pt
from problems import LASSO_A, LASSO_B, LASSO_XSTAR
from proxtpu.prox import functions as jf
from proxtpu.parallel.batch import BatchedAlgorithm as JBatched
from proxtpu_torch.prox import functions as tf
from proxtpu_torch.utils import shared as tshared

TOL = 1e-6


def _t(a):
    return torch.tensor(np.asarray(a))


@pytest.fixture(scope="module")
def small():
    A, b = LASSO_A, LASSO_B
    lam = 0.1 * float(np.max(np.abs(A.T @ b)))
    Lf = float(np.linalg.norm(A, 2) ** 2)
    return A, b, lam, Lf


def test_readme_quick_start(small):
    A, b, lam, Lf = small
    x, it = pt.FastForwardBackward(tol=1e-6)(
        x0=torch.zeros(5, dtype=torch.float64),
        f=tf.make_least_squares(_t(A), _t(b)), g=tf.NormL1(lam), Lf=Lf)
    assert x.dtype == torch.float64
    assert float(torch.max(torch.abs(x - _t(LASSO_XSTAR)))) <= 1e-5
    assert it == 142  # the reference's count at tol 1e-6


def _ls_jax(A, b):
    return pa.AutoDifferentiable(
        lambda x: 0.5 * jnp.real(jnp.vdot(A @ x - b, A @ x - b)))


_VARIANTS = {
    "fb_fixed": ("ForwardBackward", {}, True, False),
    "fb_adaptive": ("ForwardBackward", {"adaptive": True}, False, False),
    "fb_adaptive_regret": ("ForwardBackward",
                           {"adaptive": True, "increase_gamma": 1.01},
                           False, False),
    "fb_autodiff": ("ForwardBackward", {}, True, True),
    "fista_fixed": ("FastForwardBackward", {}, True, False),
    "fista_adaptive": ("FastForwardBackward", {"adaptive": True}, False,
                       False),
    "fista_autodiff": ("FastForwardBackward", {}, True, True),
    "fista_restart": ("FastForwardBackward", {"restart": True}, True, False),
}


@pytest.mark.parametrize("variant", list(_VARIANTS))
def test_single_problem_matches_jax(small, variant):
    A, b, lam, Lf = small
    solver, opts, with_lf, autodiff = _VARIANTS[variant]
    opts = dict(opts)
    j_opts, t_opts = dict(opts), dict(opts)
    if opts.pop("restart", False):
        j_opts = dict(extrapolation_sequence=pa.AdaptiveRestartSequence())
        t_opts = dict(extrapolation_sequence=pt.AdaptiveRestartSequence())
    Aj, bj = jnp.asarray(A), jnp.asarray(b)
    At, bt = _t(A), _t(b)
    if autodiff:
        f_j = _ls_jax(Aj, bj)
        f_t = lambda x: 0.5 * torch.sum((At @ x - bt) ** 2)  # noqa: E731
    else:
        f_j = jf.make_least_squares(Aj, bj)
        f_t = tf.make_least_squares(At, bt)
    kw_lf = {"Lf": Lf} if with_lf else {}
    x_j, it_j = getattr(pa, solver)(tol=TOL, **j_opts)(
        x0=jnp.zeros(5), f=f_j, g=jf.NormL1(lam), **kw_lf)
    x_t, it_t = getattr(pt, solver)(tol=TOL, **t_opts)(
        x0=torch.zeros(5, dtype=torch.float64), f=f_t, g=tf.NormL1(lam),
        **kw_lf)
    assert it_t == it_j
    np.testing.assert_allclose(x_t.numpy(), np.asarray(x_j), rtol=0,
                               atol=1e-9)


def test_verbose_display(small, capsys):
    A, b, lam, Lf = small
    pt.FastForwardBackward(tol=TOL, verbose=True, freq=50)(
        x0=torch.zeros(5, dtype=torch.float64),
        f=tf.make_least_squares(_t(A), _t(b)), g=tf.NormL1(lam), Lf=Lf)
    rows = [r for r in capsys.readouterr().out.splitlines() if r.strip()]
    assert len(rows) == 3  # 50, 100 and the final row of 142


def _sequence_pairs():
    return [
        (pa.FixedNesterovSequence(), pt.FixedNesterovSequence()),
        (pa.SimpleNesterovSequence(), pt.SimpleNesterovSequence()),
        (pa.ConstantNesterovSequence(0.1, 0.5),
         pt.ConstantNesterovSequence(0.1, 0.5)),
        (pa.AdaptiveNesterovSequence(0.0), pt.AdaptiveNesterovSequence(0.0)),
        (pa.AdaptiveNesterovSequence(0.3), pt.AdaptiveNesterovSequence(0.3)),
        (pa.NesterovExtrapolation(), pt.NesterovExtrapolation()),
        (pa.AdaptiveRestartSequence(), pt.AdaptiveRestartSequence()),
    ]


@pytest.mark.parametrize("i", range(7))
def test_sequences_match_jax(i):
    j_seq, t_seq = _sequence_pairs()[i]
    s_j = j_seq.init_state(jnp.zeros(3))
    s_t = t_seq.init_state(torch.zeros(3, dtype=torch.float64))
    gammas = [0.5, 0.5, 0.25, 0.5, 0.125]
    restarts = [-1.0, 2.0, -1.0, 0.5, -3.0]
    for g, r in zip(np.array(gammas), np.array(restarts)):
        if getattr(t_seq, "restart_aware", False):
            b_j, s_j = j_seq.next_coeff(s_j, jnp.asarray(g),
                                        restart=jnp.asarray(r))
            b_t, s_t = t_seq.next_coeff(s_t, _t(g), restart=_t(r))
        else:
            b_j, s_j = j_seq.next_coeff(s_j, jnp.asarray(g))
            b_t, s_t = t_seq.next_coeff(s_t, _t(g))
        np.testing.assert_allclose(float(b_t), float(b_j), rtol=0,
                                   atol=1e-15)


def _prox_pairs(rng):
    A = rng.standard_normal((3, 4))
    Aw = rng.standard_normal((4, 3))
    b3, b4 = rng.standard_normal(3), rng.standard_normal(4)
    Q = rng.standard_normal((4, 4))
    Q = Q + Q.T
    q = rng.standard_normal(4)
    return {
        "NormL1": (jf.NormL1(0.3), tf.NormL1(0.3)),
        "NormL1_weights": (jf.NormL1(jnp.asarray(np.arange(4.0))),
                           tf.NormL1(_t(np.arange(4.0)))),
        "ElasticNet": (jf.ElasticNet(0.3, 0.7), tf.ElasticNet(0.3, 0.7)),
        "SqrNormL2": (jf.SqrNormL2(0.7), tf.SqrNormL2(0.7)),
        "IndBox": (jf.IndBox(-0.5, 0.4), tf.IndBox(-0.5, 0.4)),
        "LeastSquares_wide": (
            jf.make_least_squares(jnp.asarray(A), jnp.asarray(b3)),
            tf.make_least_squares(_t(A), _t(b3))),
        "LeastSquares_tall": (
            jf.make_least_squares(jnp.asarray(Aw), jnp.asarray(b4),
                                       lam=2.0),
            tf.make_least_squares(_t(Aw), _t(b4), lam=2.0)),
        "LeastSquaresLoss": (
            jf.LeastSquaresLoss(jnp.asarray(Aw), jnp.asarray(b4), 0.5),
            tf.LeastSquaresLoss(_t(Aw), _t(b4), 0.5)),
        "Quadratic": (jf.Quadratic(jnp.asarray(Q), jnp.asarray(q)),
                      tf.Quadratic(_t(Q), _t(q))),
        "Zero": (pa.Zero(), pt.prox.Zero()),
        "IndZero": (pa.IndZero(), pt.prox.IndZero()),
    }


@pytest.mark.parametrize("name", list(_prox_pairs(np.random.default_rng(0))))
def test_prox_functions_match_jax(name):
    f_j, f_t = _prox_pairs(np.random.default_rng(0))[name]
    for x in (np.random.default_rng(1).standard_normal(4), np.zeros(4)):
        xj, xt = jnp.asarray(x), _t(x)
        if name in ("LeastSquares_tall", "LeastSquaresLoss"):
            xj, xt = xj[:3], xt[:3]  # A is 4 x 3
        np.testing.assert_allclose(float(f_t(xt)), float(f_j(xj)), rtol=1e-12)
        if hasattr(f_j, "prox") and hasattr(f_t, "prox"):
            z_j, v_j = pa.prox(f_j, xj, 0.37)
            z_t, v_t = pt.prox.prox(f_t, xt, 0.37)
            np.testing.assert_allclose(z_t.numpy(), np.asarray(z_j),
                                       atol=1e-12)
            np.testing.assert_allclose(float(v_t), float(v_j), rtol=1e-12)
        if hasattr(f_j, "value_and_gradient"):
            v_j, g_j = pa.value_and_gradient(f_j, xj)
            v_t, g_t = pt.prox.value_and_gradient(f_t, xt)
            np.testing.assert_allclose(float(v_t), float(v_j), rtol=1e-12)
            np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j),
                                       atol=1e-12)


def test_autodiff_gradient_composes_with_vmap():
    A = _t(np.random.default_rng(2).standard_normal((3, 4, 5)))
    x = _t(np.random.default_rng(3).standard_normal((3, 5)))

    def lane(a, u):
        return pt.prox.value_and_gradient(
            lambda v: 0.5 * torch.sum((a @ v) ** 2), u)

    val, grad = torch.func.vmap(lane)(A, x)
    want = torch.einsum("bmn,bm->bn", A, torch.einsum("bmn,bn->bm", A, x))
    torch.testing.assert_close(grad, want)
    assert val.shape == (3,)


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(4)
    B, M, N = 3, 12, 10
    A = rng.standard_normal((B, M, N)) / np.sqrt(M)
    b = rng.standard_normal((B, M))
    lam = 0.1 * np.max(np.abs(np.einsum("bmn,bm->bn", A, b)), axis=1)
    Lf = np.array([np.linalg.norm(a, 2) ** 2 for a in A])
    return A, b, lam, Lf


@pytest.mark.parametrize("check_every", [1, 8])
@pytest.mark.parametrize("fista", [False, True])
def test_batched_generic_driver_matches_jax(batch, fista, check_every):
    A, b, lam, Lf = batch
    j_fac = (pa.make_fast_forward_backward_iteration if fista
             else pa.make_forward_backward_iteration)
    t_fac = (pt.make_fast_forward_backward_iteration if fista
             else pt.make_forward_backward_iteration)
    ref = JBatched(j_fac, maxit=2000, tol=TOL, use_kernels=False,
                   check_every=check_every)(
        x0=jnp.zeros(A.shape[::2]),
        f=jf.LeastSquaresLoss(jnp.asarray(A), jnp.asarray(b)),
        g=jf.NormL1(jnp.asarray(lam)), Lf=jnp.asarray(Lf))
    port = pt.BatchedAlgorithm(t_fac, maxit=2000, tol=TOL,
                               use_kernels=False, check_every=check_every)(
        x0=torch.zeros(A.shape[::2], dtype=torch.float64),
        f=tf.LeastSquaresLoss(_t(A), _t(b)), g=tf.NormL1(_t(lam)),
        Lf=_t(Lf))
    assert bool(port[2].all()) and bool(np.asarray(ref[2]).all())
    np.testing.assert_array_equal(port[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_allclose(port[0].numpy(), np.asarray(ref[0]), rtol=0,
                               atol=1e-9)


def test_batched_halt_nonfinite_matches_jax(batch):
    """A lane whose Lf is far too small diverges: it dies at its last
    finite iterate and no longer holds the others to maxit."""
    A, b, lam, Lf = batch
    Lf_bad = Lf.copy()
    Lf_bad[1] = 1e-3
    ref = JBatched(pa.make_forward_backward_iteration, maxit=2000, tol=TOL,
                   halt_nonfinite=True)(
        x0=jnp.zeros(A.shape[::2]),
        f=jf.LeastSquaresLoss(jnp.asarray(A), jnp.asarray(b)),
        g=jf.NormL1(jnp.asarray(lam)), Lf=jnp.asarray(Lf_bad))
    port = pt.BatchedAlgorithm(pt.make_forward_backward_iteration,
                               maxit=2000, tol=TOL, halt_nonfinite=True)(
        x0=torch.zeros(A.shape[::2], dtype=torch.float64),
        f=tf.LeastSquaresLoss(_t(A), _t(b)), g=tf.NormL1(_t(lam)),
        Lf=_t(Lf_bad))
    np.testing.assert_array_equal(port[2].numpy(), np.asarray(ref[2]))
    np.testing.assert_array_equal(port[1].numpy(), np.asarray(ref[1]))
    assert not bool(port[2][1]) and int(port[1][1]) < 2000
    assert bool(torch.isfinite(port[0]).all())


def test_shared_markers():
    A = torch.ones(2, 3)
    lam = torch.ones(4)
    tree = (tshared.Shared(tf.LeastSquaresLoss(A, torch.ones(2))),
            tf.NormL1(lam))
    assert tshared.batch_axes(tree) == [None, None, 0]
    assert [t is lam for t in tshared.lane_arrays(tree)] == [True]
    plain = tshared.unwrap_shared(tree)
    assert isinstance(plain[0], tf.LeastSquaresLoss) and plain[0].A is A
    # the proxy delegates attributes and calls
    assert tree[0].A is A and tshared.Shared(len)([1, 2]) == 2


def test_jax_stays_on_cpu():
    assert jax.default_backend() == "cpu"
