"""The two named exceptions to the flat machines' parity with the JAX
package (``tests/test_torch_flat_ls.py`` holds the rest exactly): cases
where the port's flat machine and the JAX package's part after many
iterations, because the line searches amplify the last bits of sums that
the two packages add in different orders.  Each is held as the JAX
package's own tests hold its batched runs against its single ones
(``tests/test_flat_ls.py``), and both answers are held to the float64
fixed-point recheck.
"""

import numpy as np
import pytest

from test_torch_flat_ls import RECHECK, TOL, assert_same, both, fb_residual


@pytest.mark.parametrize("machine", ["panoc", "zerofpr", "panocplus"])
@pytest.mark.parametrize("max_backtracks", [20, 2])
def test_nonquadratic_f_named_exception(machine, max_backtracks):
    """Named exception: non-quadratic f (logistic), where the trial is
    evaluated where it lies.  The two packages' loss and sums round in
    their last bits, and the line searches amplify that: the trajectories
    agree to 1e-10 for 15 iterations and then part (1e-8 at 30, 1e-4 at 60
    and counts up to 9 apart at convergence), as the JAX package's own
    batched and single runs do (``tests/test_flat_ls.py``).  Held as that
    test holds them: the 15-step zip, then both full solves converged and
    both under the float64 fixed-point recheck.  The problem (10 x 16,
    all-one labels) is not strongly convex, so two certified answers may
    lie apart: up to 1.6e-4 here, held under 1e-3."""
    ref, port = both(machine, "logistic", seed=1, maxit=15,
                     max_backtracks=max_backtracks)
    assert (port[1] == 15).all()
    assert_same(ref, port, atol=1e-10)
    ref, port = both(machine, "logistic", seed=1, maxit=2000,
                     max_backtracks=max_backtracks)
    assert bool(port[2].all()) and bool(np.asarray(ref[2]).all())
    for z in (np.asarray(ref[0]), port[0].numpy()):
        assert fb_residual("logistic", 1, z).max() <= RECHECK * TOL
    np.testing.assert_allclose(port[0].numpy(), np.asarray(ref[0]), rtol=0,
                               atol=1e-3)


@pytest.mark.parametrize("machine,directions", [
    ("panoc", "anderson"), ("zerofpr", "anderson"), ("panoc", "broyden")])
def test_anderson_broyden_named_exception(machine, directions):
    """Named exception: Anderson and Broyden directions.  Their dense
    recursions (Anderson's pseudo-inverse, Broyden's rank-1 updates of H)
    amplify the last bits of the batched products, so on one or two lanes
    of six the counts part (up to 2.5 times apart, as the JAX package's
    own batched and single runs, ``tests/test_flat_ls.py``).  Held as that
    test holds them: every lane converged in both, counts within a factor
    2.5, solutions within 2e-5, and both under the fixed-point recheck."""
    ref, port = both(machine, seed=2, directions=directions, maxit=1000)
    assert bool(port[2].all()) and bool(np.asarray(ref[2]).all())
    ratio = port[1].numpy() / np.asarray(ref[1])
    assert (ratio >= 1 / 2.5).all() and (ratio <= 2.5).all()
    np.testing.assert_allclose(port[0].numpy(), np.asarray(ref[0]), rtol=0,
                               atol=2e-5)
    for z in (np.asarray(ref[0]), port[0].numpy()):
        assert fb_residual("lasso", 2, z).max() <= RECHECK * TOL
