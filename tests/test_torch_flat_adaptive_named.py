"""The named exceptions to the adaptive flat machines' parity with the JAX
package (``tests/test_torch_flat_adaptive.py`` holds the rest exactly):
cases where a step search decides on a near-tie, so that the last bits of
sums the two packages add in different orders flip a decision and the
trajectories part.  Each is held as the JAX package's own tests hold such
cases (``tests/test_flat_ls.py``, ``tests/test_adaptive_flat.py``), and
both answers are held to the float64 fixed-point recheck.
"""

import numpy as np
import pytest

from test_torch_flat_adaptive import BA, NA, adaptive_both, fista_problems
from test_torch_flat_ls import (
    B, N, RECHECK, TOL, _j, _t, assert_same, both, fag, fb_residual,
)


def lasso_residual(A, b, lam, x):
    """Per lane ||x - prox(x - A^T (A x - b) / L)||_inf L at L = ||A||^2,
    in float64 on the host."""
    out = []
    for i in range(A.shape[0]):
        L = np.linalg.norm(A[i], 2) ** 2
        y = x[i] - A[i].T @ (A[i] @ x[i] - b[i]) / L
        z = np.sign(y) * np.maximum(np.abs(y) - lam[i] / L, 0)
        out.append(np.max(np.abs(x[i] - z)) * L)
    return np.array(out)


@pytest.mark.parametrize("name,opts", [
    ("fb", dict(increase_gamma=1.01)),
    ("fista", dict(increase_gamma=1.01)),
    ("fb", dict(reduce_gamma=0.9, increase_gamma=1.1))])
def test_regret_rule_named_exception(name, opts):
    """Named exception: the regret rule (increase_gamma > 1) from gamma0 =
    0.05, ``tests/test_adaptive_flat.py``'s cases.  Every step first tries
    a gamma larger than the last accepted one, so every accept test rides
    the boundary of the quadratic model: a last-bit difference flips one,
    and the lanes' counts part (FB 702 against 727 on one lane of five,
    FISTA up to 53 apart on three).  The JAX package pins these only
    because its batched and single programs compute the same bits.  Held:
    every lane converged in both, both answers under the float64
    fixed-point recheck, and within 1e-5 of each other."""
    A, b, lam = fista_problems()
    ref, port = adaptive_both(name, A, b, lam, np.zeros((BA, NA)),
                              gamma0=np.full(BA, 0.05), **opts)
    assert bool(port[2].all()) and bool(np.asarray(ref[2]).all())
    for z in (np.asarray(ref[0]), port[0].numpy()):
        assert lasso_residual(A, b, lam, z).max() <= RECHECK * TOL
    np.testing.assert_allclose(port[0].numpy(), np.asarray(ref[0]), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("machine", ["panoc", "zerofpr"])
def test_two_mode_nonquadratic_named_exception(machine):
    """Named exception: the two-mode machines on a non-quadratic f
    (logistic, from a step eight times too large), as the fixed machines'
    case in ``tests/test_torch_flat_named.py``: a 15-step zip to 1e-10,
    then both full solves converged (counts up to 24 apart), both under
    the fixed-point recheck and within 1e-3."""
    ref, port = both(machine, "logistic", seed=1, gamma_mult=8 * 0.95,
                     maxit=15, adaptive=True)
    assert (port[1] == 15).all()
    assert_same(ref, port, atol=1e-10)
    ref, port = both(machine, "logistic", seed=1, gamma_mult=8 * 0.95,
                     maxit=2000, adaptive=True)
    assert bool(port[2].all()) and bool(np.asarray(ref[2]).all())
    for z in (np.asarray(ref[0]), port[0].numpy()):
        assert fb_residual("logistic", 1, z).max() <= RECHECK * TOL
    np.testing.assert_allclose(port[0].numpy(), np.asarray(ref[0]), rtol=0,
                               atol=1e-3)


def test_panocplus_estimated_gamma_named_exception():
    """Named exception: PANOCplus with gamma = None (the per-lane estimate,
    then the gamma search in the lanes).  One lane of six takes 116
    iterations against 114 (``tests/test_flat_ls.py`` holds the JAX
    package's own batched and single runs to a count within max(5, 10%)
    and 1e-4).  Held: every lane converged, counts within that margin, both
    answers under the fixed-point recheck and within 1e-5."""
    import proxtpu.parallel.flat_ls as jfl
    import proxtpu_torch.parallel.flat_ls as tfl

    (jfo, jA, jg), (tfo, tA, tg), x0, Lf = fag("lasso", 9)
    ref = jfl.batched_panocplus(jfo, jA, jg, _j(x0), None, TOL, maxit=1000)
    port = tfl.batched_panocplus(tfo, tA, tg, _t(x0), None, TOL, maxit=1000)
    assert bool(port[2].all()) and bool(np.asarray(ref[2]).all())
    k_r, k_p = np.asarray(ref[1]), port[1].numpy()
    assert (np.abs(k_p - k_r) <= np.maximum(5, k_r // 10)).all()
    for z in (np.asarray(ref[0]), port[0].numpy()):
        assert fb_residual("lasso", 9, z).max() <= RECHECK * TOL
    np.testing.assert_allclose(port[0].numpy(), np.asarray(ref[0]), rtol=0,
                               atol=1e-5)
    assert port[0].shape == (B, N)
