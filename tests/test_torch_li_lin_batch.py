"""Li-Lin under the batched driver, on the port and on the JAX package, on
the CPU in float64.

For one problem the port tests Li-Lin's monitor on the host; under the
batched drivers the iteration computes both branches and each lane selects
its own (``LiLinIteration.select_branches``, set by ``batch.py::_Lanes``),
as ``lax.cond`` does under ``vmap``.  Held: ``tests/test_nonconvex_qp.py``'s
random 100-d problems 0-3 through ``BatchedAlgorithm`` give the JAX
package's counts, 38, 20, 51, 63, and its batched solutions within 1e-9;
the tiny problem; ``theta_restart``; every driver that maps lanes.

Run as a script, the file prints the lanes of ``chip_smoke.py``'s phase
"batched Li-Lin" (route (b)'s 64 box QPs of n = 512, ``tools/problems.py::
box_qp_problems`` seed 7) on which Li-Lin cycles in float64 in both
packages: ``PYTHONPATH=. JAX_PLATFORMS=cpu python
tests/test_torch_li_lin_batch.py`` (a few minutes).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from proxtpu.algorithms.li_lin import make_li_lin_iteration as j_make
from proxtpu.parallel import BatchedAlgorithm as JBatchedAlgorithm
from proxtpu.prox import IndBox as JIndBox
from proxtpu.prox import Quadratic as JQuadratic
import proxtpu_torch as pt
from proxtpu_torch.parallel import (
    batched_run_loop,
    batched_run_segments,
    compacting_batched_run,
)
from proxtpu_torch.prox import IndBox, Quadratic
from test_nonconvex_qp import random_problem, tiny_problem

jax.config.update("jax_enable_x64", True)

TOL, MAXIT = 1e-4, 5000


def _stack(problems):
    Q = np.stack([p[0] for p in problems])
    q = np.stack([p[1] for p in problems])
    gamma = np.array([p[4] for p in problems])
    return Q, q, gamma


def _jax(Q, q, gamma, **kw):
    out = JBatchedAlgorithm(j_make, maxit=MAXIT, tol=TOL)(
        x0=jnp.zeros(q.shape), f=JQuadratic(jnp.asarray(Q), jnp.asarray(q)),
        g=JIndBox(-1.0, 1.0), gamma=jnp.asarray(gamma), **kw)
    return tuple(np.asarray(v) for v in out)


def _port_kwargs(Q, q, gamma):
    return dict(x0=torch.zeros(q.shape, dtype=torch.float64),
                f=Quadratic(torch.tensor(Q), torch.tensor(q)),
                g=IndBox(-1.0, 1.0), gamma=torch.tensor(gamma))


def _port(Q, q, gamma, **kw):
    out = pt.BatchedAlgorithm(pt.make_li_lin_iteration, maxit=MAXIT,
                              tol=TOL)(**_port_kwargs(Q, q, gamma), **kw)
    return tuple(v.numpy() for v in out)


@pytest.fixture(scope="module")
def random4():
    return _stack([random_problem(k) for k in range(4)])


def test_batched_counts_and_solutions_match_jax(random4):
    xj, kj, dj = _jax(*random4)
    x, k, d = _port(*random4)
    assert d.all() and dj.all()
    np.testing.assert_array_equal(k, [38, 20, 51, 63])
    np.testing.assert_array_equal(k, kj)
    np.testing.assert_allclose(x, xj, rtol=0, atol=1e-9)


def test_batched_lanes_are_the_single_solves(random4):
    """Each lane's count is its single solve's (the host branch), and the
    solutions agree to the last bits the batched products allow."""
    Q, q, gamma = random4
    x, k, _ = _port(Q, q, gamma)
    for i in range(len(gamma)):
        xi, ki = pt.LiLin(tol=TOL)(
            x0=torch.zeros(q.shape[1], dtype=torch.float64),
            f=Quadratic(torch.tensor(Q[i]), torch.tensor(q[i])),
            g=IndBox(-1.0, 1.0), gamma=float(gamma[i]))
        assert ki == k[i]
        np.testing.assert_allclose(xi.numpy(), x[i], rtol=0, atol=1e-12)


def test_tiny_problem_batched_matches_jax():
    Q, q, gamma = _stack([tiny_problem()])
    xj, kj, dj = _jax(Q, q, gamma)
    x, k, d = _port(Q, q, gamma)
    assert d.all() and dj.all()
    np.testing.assert_array_equal(k, kj)
    np.testing.assert_allclose(x, xj, rtol=0, atol=1e-12)
    z = np.clip(x[0] - gamma[0] * (Q[0] @ x[0] + q[0]), -1.0, 1.0)
    assert np.max(np.abs(x[0] - z)) / gamma[0] <= TOL


def test_theta_restart_batched_matches_jax():
    Q, q, gamma = _stack([random_problem(k) for k in (1, 2, 3)])
    xj, kj, dj = _jax(Q, q, gamma, theta_restart=True)
    x, k, d = _port(Q, q, gamma, theta_restart=True)
    assert d.all() and dj.all()
    np.testing.assert_array_equal(k, kj)
    np.testing.assert_allclose(x, xj, rtol=0, atol=1e-9)


@pytest.mark.parametrize("driver", ["loop", "segments", "compacting"])
def test_every_lane_mapping_driver_selects(random4, driver):
    """The drivers set the select form themselves: a stacked iteration the
    caller made (``select_branches`` off) runs under each of them, with
    ``batched_run_loop``'s counts and bits."""
    it = pt.make_li_lin_iteration(**_port_kwargs(*random4))
    assert not it.select_branches
    run = {"loop": lambda: batched_run_loop(it, MAXIT, TOL),
           "segments": lambda: batched_run_segments(it, MAXIT, TOL,
                                                    segment=16),
           "compacting": lambda: compacting_batched_run(
               it, MAXIT, TOL, chunk=16, min_batch=1)}[driver]
    x, k, d = run()
    xr, kr, dr = batched_run_loop(it, MAXIT, TOL)
    assert torch.equal(k, kr) and torch.equal(d, dr) and bool(d.all())
    assert torch.equal(x, xr)


def test_single_problem_keeps_the_host_branch(random4):
    """One problem: the monitor is tested on the host (``bool`` of a
    tensor), so the step does not map under vmap unless the drivers set
    the select form."""
    Q, q, gamma = random4
    it = pt.make_li_lin_iteration(
        x0=torch.zeros(q.shape[1], dtype=torch.float64),
        f=Quadratic(torch.tensor(Q[0]), torch.tensor(q[0])),
        g=IndBox(-1.0, 1.0), gamma=float(gamma[0]))
    s = it.init()
    for _ in range(5):
        s = it.step(s)
    sel = dataclasses.replace(it, select_branches=True)
    t = sel.init()
    for _ in range(5):
        t = sel.step(t)
    assert all(torch.equal(a, b) for a, b in zip(s, t))


def main():
    """Route (b)'s 64 box QPs of n = 512 in float64 on both packages, at
    ``chip_smoke.py``'s cap of 2,000 iterations: the lanes that do not
    converge (Li-Lin's limit cycles, BASELINE.md) and each package's
    counts."""
    from proxtpu_torch.tools.problems import box_qp_problems

    Qs, qs, gam = box_qp_problems(64, 512, seed=7)
    Qs, qs, gam = (v.astype(np.float64) for v in (Qs, qs, gam))
    maxit = 2000
    _, kj, dj = (np.asarray(v) for v in JBatchedAlgorithm(
        j_make, maxit=maxit, tol=TOL, use_kernels=False)(
        x0=jnp.zeros(qs.shape), f=JQuadratic(jnp.asarray(Qs),
                                             jnp.asarray(qs)),
        g=JIndBox(-1.0, 1.0), gamma=jnp.asarray(gam)))
    _, k, d = (v.numpy() for v in pt.BatchedAlgorithm(
        pt.make_li_lin_iteration, maxit=maxit, tol=TOL)(
        **_port_kwargs(Qs, qs, gam)))
    print(f"JAX, float64: {int(dj.sum())}/64 done; not done "
          f"{np.flatnonzero(~dj).tolist()}; counts {kj.tolist()}")
    print(f"port, float64: {int(d.sum())}/64 done; not done "
          f"{np.flatnonzero(~d).tolist()}; counts {k.tolist()}")
    assert np.array_equal(d, dj) and np.array_equal(k, kj)


if __name__ == "__main__":
    main()
