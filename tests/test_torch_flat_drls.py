"""The port's flat DRLS machine (``proxtpu_torch.parallel.flat_ls.
batched_drls``) against the JAX package's on the same numpy inputs, on the
CPU in float64: counts exact and solutions within 1e-9 on a quadratic f
(the prox interpolation, ``drls.jl:172-184``) at ``max_backtracks`` 20 and
2 (the forced tau = 0 commit), on a non-quadratic f (a translated elastic
net, the trial's prox evaluated where it lies) and with no acceleration.
"""

import jax
import numpy as np
import pytest

import proxtpu.parallel.flat_ls as jfl
import proxtpu_torch.parallel.flat_ls as tfl
from proxtpu.algorithms.drls import drls_C
from proxtpu.prox import functions as jf
from proxtpu_torch.prox import functions as tf
from test_torch_flat_ls import (
    _DIRS, B, N, TOL, _j, _t, assert_same, lasso, stacked_least_squares,
)

jax.config.update("jax_enable_x64", True)


def drls_both(kind, seed=0, directions="lbfgs", **kw):
    """The JAX and the port's ``batched_drls``: ``quad`` is
    ``tests/test_flat_ls.py``'s least squares with the factory's gamma and
    c per lane, ``nonquad`` its translated elastic net with gamma 0.8 and
    c 0.01."""
    jd, td = _DIRS[directions]
    if kind == "quad":
        A, b, lam, Lf = lasso(seed)
        jfo = jax.vmap(jf.make_least_squares)(_j(A), _j(b))
        tfo = stacked_least_squares(A, b)
        gamma = 0.95 / Lf
        c = np.array([0.5 * drls_C(jf.SqrNormL2(), None, float(Lf[i]),
                                   float(gamma[i]), 1.0) for i in range(B)])
        x0 = np.zeros((B, N))
    else:
        rng = np.random.default_rng(5)
        tt = rng.standard_normal((B, N))
        _, _, lam, _ = lasso(5)
        jfo = jax.vmap(lambda ti: jf.Translate(jf.ElasticNet(0.3, 1.0), ti))(
            _j(tt))
        tfo = tf.Translate(tf.ElasticNet(0.3, 1.0), _t(tt))
        gamma, c, x0 = np.full(B, 0.8), np.full(B, 0.01), np.ones((B, N))
    ref = jfl.batched_drls(jfo, jf.NormL1(_j(lam)), _j(x0), _j(gamma), 1.0,
                           _j(c), TOL, directions=jd(), **kw)
    port = tfl.batched_drls(tfo, tf.NormL1(_t(lam)), _t(x0), _t(gamma), 1.0,
                            _t(c), TOL, directions=td(), **kw)
    return ref, port


@pytest.mark.parametrize("kind,max_backtracks", [("quad", 20), ("quad", 2),
                                                 ("nonquad", 20)])
def test_drls_matches_jax(kind, max_backtracks):
    ref, port = drls_both(kind, maxit=2000, max_backtracks=max_backtracks)
    assert bool(port[2].all())
    assert_same(ref, port)


def test_drls_noaccel_matches_jax():
    ref, port = drls_both("quad", seed=6, directions="none", maxit=5000)
    assert bool(port[2].all())
    assert_same(ref, port)


def test_drls_maxit_cap():
    ref, port = drls_both("quad", maxit=5)
    assert not bool(port[2].any()) and (port[1] == 5).all()
    assert_same(ref, port)
