"""The port's adaptive flat machines against the JAX package's on the same
numpy inputs, on the CPU in float64: the two-mode (gamma search, tau
search) PANOC and ZeroFPR machines from a step ten times too large and
from the right one, with the per-lane estimated start, complex iterates and
blocked trips; PANOCplus with its gamma search in the lanes; and the
adaptive forward-backward and FISTA machines (``batched_adaptive_fb``,
``batched_adaptive_fista``) with the estimated start, a given one, the
strongly convex sequence (``mf``) and the ``maxit`` cap.  Counts are held
exactly and solutions within 1e-9.  The cases that part from the JAX
package's bits are named and held apart in
``tests/test_torch_flat_adaptive_named.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import proxtpu.parallel.adaptive_batch as jab
import proxtpu_torch.parallel.adaptive_batch as tab
import proxtpu_torch.parallel.flat_ls as tfl
from proxtpu.prox import functions as jf
from proxtpu_torch.prox import functions as tf
from test_torch_flat_ls import TOL, _t, assert_same, both, fag

jax.config.update("jax_enable_x64", True)

# tests/test_adaptive_flat.py's problems
BA, MA, NA = 5, 8, 12


@pytest.mark.parametrize("machine", ["panoc", "zerofpr"])
@pytest.mark.parametrize("gamma_mult", [10 * 0.95, 0.95])
def test_two_mode_machines_match_jax(machine, gamma_mult):
    """From a step ten times too large (the gamma search halves it) and
    from alpha / Lf (accepted at once)."""
    ref, port = both(machine, gamma_mult=gamma_mult, maxit=1000,
                     adaptive=True)
    assert bool(port[2].all())
    assert_same(ref, port)


@pytest.mark.parametrize("machine", ["panoc", "zerofpr"])
def test_estimated_gamma_matches_jax(machine):
    """The driver's cold start: gamma = alpha / (a per-lane Lipschitz lower
    bound by finite differences)."""
    ref, port = both(machine, seed=7, maxit=1000, adaptive=True,
                     estimate_gamma=True)
    assert bool(port[2].all())
    assert_same(ref, port)


@pytest.mark.parametrize("machine", ["panoc", "zerofpr"])
def test_two_mode_complex_matches_jax(machine):
    ref, port = both(machine, "complex", gamma_mult=10 * 0.95, maxit=1000,
                     adaptive=True)
    assert bool(port[2].all()) and port[0].dtype == torch.complex128
    assert_same(ref, port)


@pytest.mark.parametrize("machine", ["panoc", "zerofpr"])
def test_two_mode_blocked_bit_exact(machine):
    (_, (f, A, g), x0, Lf) = fag("lasso")
    run = getattr(tfl, f"batched_{machine}")
    out = [run(f, A, g, _t(x0), _t(9.5 / Lf), TOL, maxit=1000,
               adaptive=True, check_every=k) for k in (1, 8)]
    assert all(torch.equal(a, b) for a, b in zip(*out))


def test_panocplus_adaptive_matches_jax():
    """PANOCplus from a step twenty times too large: per-lane gamma
    shrinks inside the tau search."""
    ref, port = both("panocplus", seed=8, gamma_mult=20.0, maxit=1000,
                     adaptive=True)
    assert bool(port[2].all())
    assert_same(ref, port)


def fista_problems():
    rng = np.random.default_rng(0)
    A = rng.standard_normal((BA, MA, NA))
    b = rng.standard_normal((BA, MA))
    lam = 0.1 * np.max(np.abs(np.einsum("bmn,bm->bn", A, b)), axis=1)
    return A, b, lam


def adaptive_both(name, A, b, lam, x0, tol=TOL, maxit=5000, **kw):
    """The JAX and the port's ``batched_adaptive_<name>`` on stacked
    least squares + l1."""
    kwj = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}
    kwt = {k: torch.tensor(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}
    ref = getattr(jab, f"batched_adaptive_{name}")(
        jax.vmap(jf.LeastSquaresLoss)(jnp.asarray(A), jnp.asarray(b)),
        jax.vmap(jf.NormL1)(jnp.asarray(lam)), jnp.asarray(x0), tol,
        maxit=maxit, **kwj)
    port = getattr(tab, f"batched_adaptive_{name}")(
        tf.LeastSquaresLoss(_t(A), _t(b)), tf.NormL1(_t(lam)), _t(x0), tol,
        maxit=maxit, **kwt)
    return ref, port


@pytest.mark.parametrize("name,gamma0", [("fb", None), ("fista", None),
                                         ("fista", 0.05)])
def test_adaptive_fb_fista_match_jax(name, gamma0):
    """increase_gamma = 1 from the estimated start and from a given one
    (``tests/test_adaptive_flat.py``'s cases without the regret rule)."""
    A, b, lam = fista_problems()
    kw = {} if gamma0 is None else dict(gamma0=np.full(BA, gamma0))
    ref, port = adaptive_both(name, A, b, lam, np.zeros((BA, NA)), **kw)
    assert bool(port[2].all())
    assert_same(ref, port)


def test_adaptive_fista_strongly_convex_mf():
    """mf > 0: the strongly convex adaptive Nesterov sequence on the
    known-spectrum lasso of ``tests/problems.py``, each lane the same
    problem."""
    from problems import SC_XSTAR, strongly_convex_lasso

    A1, b1, lam, x0 = strongly_convex_lasso(mf=1.0, Lf=10.0)
    A = np.broadcast_to(A1, (3,) + A1.shape).copy()
    b = np.broadcast_to(b1, (3,) + b1.shape).copy()
    ref, port = adaptive_both(
        "fista", A, b, np.full(3, lam), np.broadcast_to(x0, (3, A1.shape[1]))
        .copy(), gamma0=np.full(3, 0.05), mf=1.0)
    assert bool(port[2].all())
    assert_same(ref, port)
    np.testing.assert_allclose(port[0][0].numpy(), SC_XSTAR, atol=1e-4)


@pytest.mark.parametrize("name", ["fb", "fista"])
def test_adaptive_maxit_cap(name):
    A, b, lam = fista_problems()
    ref, port = adaptive_both(name, A, b, lam, np.zeros((BA, NA)), tol=0.0,
                              maxit=7)
    assert not bool(port[2].any()) and (port[1] == 7).all()
    assert_same(ref, port)


def test_reduce_gamma_validated():
    A, b, lam = fista_problems()
    with pytest.raises(ValueError, match="reduce_gamma"):
        tab.batched_adaptive_fb(
            tf.LeastSquaresLoss(_t(A), _t(b)), tf.NormL1(_t(lam)),
            torch.zeros(BA, NA, dtype=torch.float64), TOL, maxit=100,
            reduce_gamma=1.0)
