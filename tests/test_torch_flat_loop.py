"""Loop control of the port's flat machines, on the CPU in float64: the
host tests "no lane active" once per block of ``check_every`` trips, and
every update is masked on the lane being active, so ``check_every`` 1 and
8 give the same bits; the inputs are validated as in the JAX package
(``tests/test_flat_ls.py``); no trip waits on the device (the host syncs,
counted by a ``TorchDispatchMode``, are exactly the host's tests); and a
shared A is one ``mm`` a product, a stacked A one ``bmm``.
"""

import collections

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import proxtpu_torch as pt
import proxtpu_torch.parallel.flat_ls as tfl
from proxtpu_torch.prox import functions as tf
from test_torch_flat_ls import B, N, TOL, _t, fag, lasso, \
    stacked_least_squares


def _run(machine, check_every):
    """``tests/test_flat_ls.py``'s blocked problems (A = I, f the
    least-squares loss of A x - b)."""
    A, b, lam, Lf = lasso(3)
    f = tf.LeastSquaresLoss(_t(A), _t(b))
    g = tf.NormL1(_t(lam))
    x0 = torch.zeros(B, N, dtype=torch.float64)
    if machine == "adaptive_fista":
        return pt.parallel.batched_adaptive_fista(
            f, g, x0, 1e-5, maxit=3000, check_every=check_every)
    if machine == "drls":
        return tfl.batched_drls(
            stacked_least_squares(A, b), g, x0, _t(1.0 / Lf), 1.0,
            torch.full((B,), -np.inf, dtype=torch.float64), 1e-5, maxit=300,
            check_every=check_every)
    return getattr(tfl, f"batched_{machine}")(
        f, pt.ops.linops.IdentityOperator(), g, x0, _t(0.95 / Lf), 1e-5,
        maxit=300, check_every=check_every)


@pytest.mark.parametrize("machine", ["panoc", "zerofpr", "panocplus", "drls",
                                     "adaptive_fista"])
def test_blocked_flat_machines_bit_exact(machine):
    """K = 1 and K = 8 trips between the host's tests: the same bits."""
    z1, k1, d1 = _run(machine, 1)
    z8, k8, d8 = _run(machine, 8)
    assert bool(d1.all())
    assert torch.equal(k1, k8) and torch.equal(d1, d8) and torch.equal(z1, z8)


def test_validate_inputs():
    """check_every < 1 raises, an explicit trip_cap with check_every > 1
    raises, a direction style other than quasi-Newton or none raises."""
    A, b, lam, Lf = lasso(5)
    f, g = tf.LeastSquaresLoss(_t(A), _t(b)), tf.NormL1(_t(lam))
    x0 = torch.zeros(B, N, dtype=torch.float64)
    Id = pt.ops.linops.IdentityOperator()
    gam = _t(0.95 / Lf)
    with pytest.raises(ValueError, match="check_every"):
        tfl.batched_panoc(f, Id, g, x0, gam, 1e-5, maxit=50, check_every=0)
    with pytest.raises(ValueError, match="trip_cap"):
        tfl.batched_panoc(f, Id, g, x0, gam, 1e-5, maxit=50, trip_cap=10,
                          check_every=8)
    with pytest.raises(ValueError, match="direction style"):
        tfl.batched_zerofpr(f, Id, g, x0, gam, 1e-5, maxit=50,
                            directions=pt.NesterovExtrapolation(
                                pt.FixedNesterovSequence()))


class _Ops(TorchDispatchMode):
    """Counts the aten operations run under it."""

    def __init__(self):
        super().__init__()
        self.count = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.count[func] += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("machine,check_every", [
    ("panoc", 1), ("panoc", 8), ("zerofpr", 4), ("panocplus", 8),
    ("drls", 8)])
def test_no_host_sync_inside_a_trip(monkeypatch, machine, check_every):
    """Every wait on the device (``aten._local_scalar_dense``) is one of the
    host's tests, one per block of ``check_every`` trips."""
    checks = []
    real = tfl._host_while

    def counting(active_of, body, s, every, cap):
        def test(s):
            checks.append(1)
            return active_of(s)
        return real(test, body, s, every, cap)

    monkeypatch.setattr(tfl, "_host_while", counting)
    with _Ops() as ops:
        _run(machine, check_every)
    syncs = ops.count[torch.ops.aten._local_scalar_dense.default]
    assert syncs == len(checks) > 0


@pytest.mark.parametrize("kind,op", [("lasso", torch.ops.aten.bmm.default),
                                     ("shared", torch.ops.aten.mm.default)])
def test_products_are_one_batched_call(kind, op):
    """A stacked A is one ``bmm`` a product and a ``Shared`` A one
    ``(B, n) @ (n, m)`` ``mm``; no matrix-vector call per lane."""
    _, (f, A, g), x0, Lf = fag(kind)
    with _Ops() as ops:
        tfl.batched_panoc(f, A, g, _t(x0), _t(0.95 / Lf), TOL, maxit=20)
    names = {str(k) for k, v in ops.count.items() if v}
    assert ops.count[op] > 0
    assert not names & {"aten.mv.default", "aten.dot.default"}
    other = (torch.ops.aten.mm.default if op == torch.ops.aten.bmm.default
             else torch.ops.aten.bmm.default)
    assert ops.count[other] == 0
