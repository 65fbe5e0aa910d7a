"""The port's iteration history (``run_recorded``, ``run_loop_recorded``,
``batched_run_recorded``, ``BatchedAlgorithm.run_recorded``) against the
JAX package, on the CPU in float64: ports of ``tests/test_recording.py``.

Every test holds the port to its own eager ``states()`` stream (the
reference's execution model) as the JAX test does, and to the JAX
package's trace on the same numpy inputs: the same counts, and values
within 1e-12.
"""

import jax.numpy as jnp
import numpy as np
import torch

import proxtpu as pa
import proxtpu_torch as pt
from problems import LASSO_A, LASSO_B, LASSO_XSTAR
from proxtpu.prox import NormL1 as JNormL1
from proxtpu.prox import make_least_squares as j_make_least_squares
from proxtpu.utils.tree import tree_inf_norm as j_inf_norm
from proxtpu_torch.prox import NormL1, make_least_squares
from proxtpu_torch.utils.tree import tree_inf_norm

LAM = 0.1 * float(np.max(np.abs(LASSO_A.T @ LASSO_B)))
LF = float(np.linalg.norm(LASSO_A, 2) ** 2)


def _t(a):
    return torch.tensor(np.asarray(a))


def setup():
    return (make_least_squares(_t(LASSO_A), _t(LASSO_B)), NormL1(LAM), LF)


def jax_kw():
    return dict(x0=jnp.zeros(5, jnp.float64),
                f=j_make_least_squares(jnp.asarray(LASSO_A),
                                       jnp.asarray(LASSO_B)),
                g=JNormL1(LAM), Lf=LF)


def residual(it, k, s):
    return tree_inf_norm(s.res) / s.gamma


def j_residual(it, k, s):
    return j_inf_norm(s.res) / s.gamma


def eager_residuals(solver, n, **kw):
    iteration = solver.make_iteration(**kw)
    return np.array([float(residual(iteration, k, s)) for k, s in enumerate(
        pt.states(iteration, max_states=n), start=1)])


def test_recorded_matches_plain_run_and_eager_states():
    fA, g, Lf = setup()
    kw = dict(x0=torch.zeros(5, dtype=torch.float64), f=fA, g=g, Lf=Lf)
    solver = pt.FastForwardBackward(tol=1e-8, maxit=500)

    x_plain, it_plain = solver(**kw)
    x_rec, it_rec, tr = solver.run_recorded(residual, **kw)

    # recording does not perturb the solve
    assert int(it_rec) == it_plain
    assert torch.equal(x_rec, x_plain)
    np.testing.assert_allclose(x_rec.numpy(), LASSO_XSTAR, atol=1e-6)

    # every-iteration trace == the eager states() stream
    assert int(tr.count) == it_plain
    got = tr.values.numpy()[: int(tr.count)]
    np.testing.assert_allclose(got, eager_residuals(solver, it_plain, **kw),
                               rtol=1e-12)
    assert np.all(np.isnan(tr.values.numpy()[int(tr.count):]))

    # the JAX package's trace on the same problem
    _, it_j, tr_j = pa.FastForwardBackward(tol=1e-8, maxit=500).run_recorded(
        j_residual, **jax_kw())
    assert int(it_j) == it_plain and int(tr_j.count) == int(tr.count)
    np.testing.assert_allclose(got, np.asarray(tr_j.values)[: int(tr.count)],
                               rtol=0, atol=1e-12)


def test_record_every_samples_the_right_iterations():
    fA, g, Lf = setup()
    kw = dict(x0=torch.zeros(5, dtype=torch.float64), f=fA, g=g, Lf=Lf)
    solver = pt.FastForwardBackward(tol=1e-8, maxit=500)
    every = 10

    _, it, tr = solver.run_recorded(residual, record_every=every, **kw)
    n = int(it) // every
    assert int(tr.count) == n

    eager = eager_residuals(solver, int(it), **kw)
    got = tr.valid().numpy()
    # slot j holds iteration (j+1)*every, i.e. eager index (j+1)*every - 1
    np.testing.assert_allclose(got, eager[every - 1:: every][:n], rtol=1e-12)
    _, it_j, tr_j = pa.FastForwardBackward(tol=1e-8, maxit=500).run_recorded(
        j_residual, record_every=every, **jax_kw())
    assert int(it_j) == it and int(tr_j.count) == n
    np.testing.assert_allclose(got, np.asarray(tr_j.valid()), rtol=0,
                               atol=1e-12)


def test_record_whole_iterates_tree():
    fA, g, Lf = setup()
    kw = dict(x0=torch.zeros(5, dtype=torch.float64), f=fA, g=g, Lf=Lf)
    solver = pt.FastForwardBackward(tol=1e-6, maxit=300)

    def rec(it, k, s):
        return {"x": s.x, "res_norm": tree_inf_norm(s.res)}

    x, it, tr = solver.run_recorded(rec, **kw)
    n = int(tr.count)
    xs = tr.values["x"].numpy()
    assert xs.shape == (300, 5)
    # the final recorded iterate is the state the solution was read from
    iteration = solver.make_iteration(**kw)
    last = pt.utils.iteration_tools.loop(pt.states(iteration, max_states=n))
    np.testing.assert_allclose(xs[n - 1], last.x.numpy(), rtol=1e-12)
    assert np.all(np.isnan(xs[n:]))
    assert tuple(tr.values["res_norm"].shape) == (300,)

    def j_rec(it, k, s):
        return {"x": s.x, "res_norm": j_inf_norm(s.res)}

    _, it_j, tr_j = pa.FastForwardBackward(tol=1e-6, maxit=300).run_recorded(
        j_rec, **jax_kw())
    assert int(it_j) == it
    np.testing.assert_allclose(xs[:n], np.asarray(tr_j.values["x"])[:n],
                               rtol=0, atol=1e-12)


def test_recorded_panoc_end_to_end():
    """The JAX test runs the recorded PANOC solve under ``jax.jit``; the
    port has no trace step, so the same solve runs eagerly and is held to
    the JAX package's count."""
    fA, g, Lf = setup()
    solver = pt.PANOC(tol=1e-7, maxit=200)
    x, it, tr = solver.run_recorded(
        residual, record_every=5, x0=torch.zeros(5, dtype=torch.float64),
        f=fA, g=g, Lf=Lf)
    assert int(tr.count) == int(it) // 5
    vals = tr.values.numpy()[: int(tr.count)]
    assert np.all(np.isfinite(vals))
    np.testing.assert_allclose(x.numpy(), LASSO_XSTAR, atol=1e-5)
    _, it_j, tr_j = pa.PANOC(tol=1e-7, maxit=200).run_recorded(
        j_residual, record_every=5, **jax_kw())
    assert int(it_j) == int(it)
    np.testing.assert_allclose(vals, np.asarray(tr_j.valid()), rtol=0,
                               atol=1e-12)


def _random_problems(jax_side):
    rng = np.random.default_rng(7)
    out = []
    for k in range(4):
        A = rng.standard_normal((8, 12))
        b = rng.standard_normal(8)
        lam = (0.05 + 0.1 * k) * float(np.max(np.abs(A.T @ b)))
        Lf = float(np.linalg.norm(A, 2) ** 2)
        if jax_side:
            out.append(dict(x0=jnp.zeros(12, jnp.float64),
                            f=j_make_least_squares(jnp.asarray(A),
                                                   jnp.asarray(b)),
                            g=JNormL1(lam), Lf=Lf))
        else:
            # a number is not a lane array in the port: per-problem lam
            # goes in as a tensor (see stack_iterations)
            out.append(dict(x0=torch.zeros(12, dtype=torch.float64),
                            f=make_least_squares(_t(A), _t(b)),
                            g=NormL1(torch.tensor(lam, dtype=torch.float64)),
                            Lf=Lf))
    return out


def test_batched_recorded_matches_per_lane_single_runs():
    from proxtpu.algorithms import make_fast_forward_backward_iteration as jmk
    from proxtpu.parallel import batch_problems as j_batch_problems
    from proxtpu.parallel import batched_run_recorded as j_recorded
    from proxtpu_torch.algorithms import make_fast_forward_backward_iteration
    from proxtpu_torch.parallel import batch_problems, batched_run_recorded

    problems = _random_problems(False)
    iteration = batch_problems(make_fast_forward_backward_iteration, problems)
    maxit, tol, every = 2000, 1e-6, 5
    xs, iters, done, tr = batched_run_recorded(
        iteration, maxit, tol, residual, record_every=every)
    assert bool(done.all())
    vals = tr.values.numpy()  # (slots, B)
    assert vals.shape == (maxit // every, 4)
    assert int(tr.count) == int(iters.max()) // every

    solver = pt.FastForwardBackward(tol=tol, maxit=maxit)
    for i, kw in enumerate(problems):
        x1, it1, tr1 = solver.run_recorded(residual, record_every=every, **kw)
        assert int(it1) == int(iters[i])
        n1 = int(tr1.count)
        lane = vals[:, i]
        np.testing.assert_allclose(lane[:n1], tr1.values.numpy()[:n1],
                                   rtol=0, atol=1e-12)
        # after the lane converges it freezes: the curve plateaus at the
        # converged state's residual, which passed the criterion
        plateau = lane[n1: int(tr.count)]
        if plateau.size:
            assert np.all(plateau == plateau[0])
            assert plateau[0] <= tol
        np.testing.assert_allclose(xs[i].numpy(), x1.numpy(), rtol=0,
                                   atol=1e-12)
    # beyond the global count everything is NaN padding
    assert np.all(np.isnan(vals[int(tr.count):]))

    xs_j, iters_j, done_j, tr_j = j_recorded(
        j_batch_problems(jmk, _random_problems(True)), maxit, tol,
        j_residual, record_every=every)
    np.testing.assert_array_equal(iters.numpy(), np.asarray(iters_j))
    assert int(tr.count) == int(tr_j.count)
    np.testing.assert_allclose(vals, np.asarray(tr_j.values), rtol=0,
                               atol=1e-12, equal_nan=True)
    np.testing.assert_allclose(xs.numpy(), np.asarray(xs_j), rtol=0,
                               atol=1e-12)


def test_batched_algorithm_run_recorded_linesearch():
    """BatchedAlgorithm.run_recorded takes the generic driver and injects
    the bounded line search, so PANOC records out of the box."""
    from proxtpu.algorithms import make_panoc_iteration as j_make_panoc
    from proxtpu.parallel import BatchedAlgorithm as JBatched
    from proxtpu_torch.algorithms import make_panoc_iteration

    fA, g, Lf = setup()
    lams = np.array([0.5, 1.0, 2.0]) * LAM
    alg = pt.BatchedAlgorithm(make_panoc_iteration, maxit=200, tol=1e-7)
    xs, iters, done, tr = alg.run_recorded(
        residual, record_every=2, x0=torch.zeros((3, 5), dtype=torch.float64),
        f=fA, g=NormL1(_t(lams)), Lf=Lf)
    assert bool(done.all())
    vals = tr.values.numpy()
    assert vals.shape == (100, 3)
    live = vals[: int(tr.count)]
    # every lane's curve ends at (or, for the slowest lane, whose final
    # sample can land one step before its stop fires, near) tolerance
    assert np.all(live[-1] <= 1e-5)
    assert np.all(live[-1] < live[0])

    kw = jax_kw()
    _, iters_j, _, tr_j = JBatched(j_make_panoc, maxit=200, tol=1e-7) \
        .run_recorded(j_residual, record_every=2,
                      x0=jnp.zeros((3, 5), jnp.float64), f=kw["f"],
                      g=JNormL1(jnp.asarray(lams)), Lf=Lf)
    np.testing.assert_array_equal(iters.numpy(), np.asarray(iters_j))
    assert int(tr.count) == int(tr_j.count)
    np.testing.assert_allclose(live, np.asarray(tr_j.values)[: len(live)],
                               rtol=0, atol=1e-12)


def test_recorded_resume_continues_slots():
    fA, g, Lf = setup()
    kw = dict(x0=torch.zeros(5, dtype=torch.float64), f=fA, g=g, Lf=Lf)
    solver = pt.FastForwardBackward(tol=1e-8, maxit=500)

    _, it_full, tr_full = solver.run_recorded(residual, **kw)

    snap = pt.utils.iteration_tools.loop(
        pt.states(solver.make_iteration(**kw), max_states=50))
    _, it_res, tr_res = solver.run_recorded(
        residual, resume_from=snap, resume_iters=50, **kw)
    assert int(it_res) == int(it_full)
    full = tr_full.values.numpy()
    res = tr_res.values.numpy()
    # the resumed run writes slots 49.. (iterations 50..); earlier slots
    # stay unwritten
    np.testing.assert_allclose(res[49: int(it_res)], full[49: int(it_full)],
                               rtol=1e-12)
    assert np.all(np.isnan(res[:49]))
