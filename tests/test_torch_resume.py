"""Resume, checkpoints and the blocked single-problem driver of the port
against the JAX package, on the CPU in float64: ports of
``tests/test_resume.py``, ``test_batched_adaptive.py::
test_resume_counter_spans_segments`` and ``test_lasso_small.py``'s
``check_every`` cases.

A solve resumed from a captured state reaches the same solution;
``resume_iters`` carries the count across segments; ``save_state`` /
``load_state`` round-trip a state (``like=`` restoring dtype and device);
``batched_run_segments`` equals ``batched_run_loop`` bit for bit, also
resumed from a snapshot on disk; ``check_every=K`` gives the counts and
bits of K = 1.
"""

import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import proxtpu as pa
import proxtpu_torch as pt
from problems import LASSO_A, LASSO_B
from proxtpu.prox import NormL1 as JNormL1
from proxtpu.prox import make_least_squares as j_make_least_squares
from proxtpu_torch.prox import LeastSquaresLoss, NormL1, make_least_squares
from proxtpu_torch.utils.checkpoint import load_state, save_state
from proxtpu_torch.utils.iteration_tools import loop

LAM = 0.1 * float(np.max(np.abs(LASSO_A.T @ LASSO_B)))
LF = float(np.linalg.norm(LASSO_A, 2) ** 2)


def _t(a):
    return torch.tensor(np.asarray(a))


def problem():
    return dict(x0=torch.zeros(5, dtype=torch.float64),
                f=make_least_squares(_t(LASSO_A), _t(LASSO_B)),
                g=NormL1(LAM), Lf=LF)


def jax_problem():
    return dict(x0=jnp.zeros(5, jnp.float64),
                f=j_make_least_squares(jnp.asarray(LASSO_A),
                                       jnp.asarray(LASSO_B)),
                g=JNormL1(LAM), Lf=LF)


def snapshot(solver, n, **kw):
    return loop(pt.states(solver.make_iteration(**kw), max_states=n))


def test_resume_reaches_same_solution():
    kw = problem()
    solver = pt.FastForwardBackward(tol=1e-8)
    x_full, it_full = solver(**kw)
    x_res, it_res = solver(resume_from=snapshot(solver, 50, **kw), **kw)
    np.testing.assert_allclose(x_res.numpy(), x_full.numpy(), atol=1e-8)
    # without resume_iters the count restarts at 1: ~50 fewer iterations
    assert it_res <= it_full - 40
    # the JAX package's counts
    jsolver = pa.FastForwardBackward(tol=1e-8)
    _, it_j = jsolver(**jax_problem())
    j_iteration = jsolver.make_iteration(**jax_problem())
    j_snap = None
    for s in pa.algorithms.core.states(j_iteration, max_states=50):
        j_snap = s
    _, it_jres = jsolver(resume_from=j_snap, **jax_problem())
    assert (it_full, it_res) == (it_j, it_jres)


def test_checkpoint_roundtrip(tmp_path):
    """The port of the orbax round trip: ``save_state`` / ``load_state``
    with ``like=``, the resumed solve bit-equal to resuming from the state
    in memory."""
    kw = problem()
    solver = pt.FastForwardBackward(tol=1e-8)
    snap = snapshot(solver, 30, **kw)
    path = str(tmp_path / "ckpt.pt")
    assert save_state(path, snap) == path
    restored = load_state(path, like=solver.make_iteration(**kw).init())
    assert type(restored) is type(snap)
    x1, it1 = solver(resume_from=snap, resume_iters=30, **kw)
    x2, it2 = solver(resume_from=restored, resume_iters=30, **kw)
    assert it1 == it2
    assert torch.equal(x1, x2)
    # without like: the saved tree as it was
    raw = load_state(path)
    assert all(torch.equal(a, b) for a, b in zip(raw, snap)
               if isinstance(a, torch.Tensor))


def test_load_state_like_sets_dtype_and_device(tmp_path):
    """``like`` gives every tensor its dtype and device (the card and the
    CPU the same way; here the CPU and a float32 template)."""
    kw = problem()
    solver = pt.FastForwardBackward(tol=1e-8)
    snap = snapshot(solver, 10, **kw)
    path = str(tmp_path / "s.pt")
    save_state(path, snap)
    like = type(snap)(*(v.to(torch.float32) if isinstance(v, torch.Tensor)
                        and v.is_floating_point() else v for v in snap))
    got = load_state(path, like=like)
    for g, l, s in zip(got, like, snap):
        if isinstance(l, torch.Tensor):
            assert g.dtype == l.dtype and g.device == l.device
            assert torch.equal(g, s.to(l.dtype))


def test_state_pickle_roundtrip():
    kw = problem()
    solver = pt.FastForwardBackward(tol=1e-8)
    snap = snapshot(solver, 20, **kw)
    restored = pickle.loads(pickle.dumps(snap))
    x1, it1 = solver(resume_from=snap, **kw)
    x2, it2 = solver(resume_from=restored, **kw)
    assert it1 == it2
    assert torch.equal(x1, x2)


def _stacked_lasso(dtype=np.float64):
    rng = np.random.default_rng(13)
    B, M, N = 8, 20, 32
    A = rng.standard_normal((B, M, N)) / np.sqrt(M)
    b = rng.standard_normal((B, M))
    lam = 0.1 * np.max(np.abs(np.einsum("bmn,bm->bn", A, b)), axis=1)
    Lf = np.array([np.linalg.norm(A[i], 2) ** 2 for i in range(B)])
    return A, b, lam, Lf


def test_batched_run_segments_parity_and_resume(tmp_path):
    """Segmented batched run == batched_run_loop bit for bit (the same
    chunk core), snapshots round-trip through save_state / load_state, and
    a run resumed from a snapshot on disk finishes with the same bits; the
    counts are the JAX package's."""
    from proxtpu.algorithms.fast_forward_backward import (
        make_fast_forward_backward_iteration as j_make,
    )
    from proxtpu.parallel import batched_run_loop as j_run_loop
    from proxtpu.prox import LeastSquaresLoss as JLeastSquaresLoss
    from proxtpu_torch.algorithms import make_fast_forward_backward_iteration
    from proxtpu_torch.parallel import batched_run_loop, batched_run_segments

    A, b, lam, Lf = _stacked_lasso()
    B, _, N = A.shape
    iteration = make_fast_forward_backward_iteration(
        x0=torch.zeros((B, N), dtype=torch.float64),
        f=LeastSquaresLoss(_t(A), _t(b)), g=NormL1(_t(lam)), Lf=_t(Lf))

    xs0, it0, d0 = batched_run_loop(iteration, 3000, 1e-6)
    snaps = []
    xs1, it1, d1 = batched_run_segments(iteration, 3000, 1e-6, segment=64,
                                        callback=snaps.append)
    assert bool(d1.all())
    assert torch.equal(it0, it1) and torch.equal(d0, d1)
    assert torch.equal(xs0, xs1)
    assert len(snaps) >= 2  # a run of several segments
    assert sorted(snaps[0]) == ["done", "iters", "k", "state"]
    assert [s["k"] for s in snaps[:2]] == [65, 129]

    mid = snaps[1]
    path = str(tmp_path / "ckpt.pt")
    save_state(path, mid)
    restored = load_state(path, like=mid)
    assert int(restored["k"]) == int(mid["k"])
    xs2, it2, d2 = batched_run_segments(iteration, 3000, 1e-6, segment=64,
                                        resume=restored)
    assert bool(d2.all())
    assert torch.equal(it1, it2)
    assert torch.equal(xs1, xs2)

    j_it = j_make(x0=jnp.zeros((B, N)), f=JLeastSquaresLoss(jnp.asarray(A),
                                                            jnp.asarray(b)),
                  g=JNormL1(jnp.asarray(lam)), Lf=jnp.asarray(Lf))
    xs_j, it_j, _ = j_run_loop(j_it, 3000, 1e-6)
    np.testing.assert_array_equal(it1.numpy(), np.asarray(it_j))
    np.testing.assert_allclose(xs1.numpy(), np.asarray(xs_j), rtol=0,
                               atol=1e-12)
    # the snapshots' k are the JAX package's, the last one where the last
    # lane stopped (the port's host tests every few steps)
    from proxtpu.parallel import batched_run_segments as j_segments

    j_snaps = []
    j_segments(j_it, 3000, 1e-6, segment=64, callback=j_snaps.append)
    assert [s["k"] for s in snaps] == [s["k"] for s in j_snaps]

    with pytest.raises(ValueError, match="segment"):
        batched_run_segments(iteration, 100, 1e-6, segment=0)


def test_resume_counter_spans_segments():
    """resume_iters continues the count and the maxit budget across
    segments: a solve split at k = 50 returns the count and bits of one
    run, and the JAX package's count."""
    from proxtpu_torch.algorithms.core import run_loop

    kw = dict(problem(), adaptive=False)
    solver = pt.ForwardBackward(tol=1e-6, maxit=10_000)
    x_ref, it_ref = solver(**kw)
    assert it_ref > 60

    # segment 1: exactly 50 iterations, tol 0
    seg1 = pt.ForwardBackward(tol=0.0, maxit=50)
    iteration = seg1.make_iteration(**kw)
    sol1, k1 = run_loop(iteration, 50, 0.0, seg1.stop, lambda it, s: s,
                        False, 100, seg1.display)
    assert int(k1) == 50
    x2, it2 = solver(resume_from=sol1, resume_iters=int(k1), **kw)
    assert it2 == it_ref
    assert torch.equal(x2, x_ref)
    _, it_j = pa.ForwardBackward(tol=1e-6, maxit=10_000)(
        **jax_problem(), adaptive=False)
    assert it_ref == it_j


def _suite():
    A, b = _t(LASSO_A), _t(LASSO_B)
    fA = make_least_squares(A, b)
    x0 = torch.zeros(5, dtype=torch.float64)
    return [
        (pt.FastForwardBackward, dict(x0=x0, f=fA, g=NormL1(LAM), Lf=LF)),
        (pt.ForwardBackward, dict(x0=x0, f=fA, g=NormL1(LAM), Lf=LF)),
        (pt.DouglasRachford, dict(x0=x0, f=fA, g=NormL1(LAM), gamma=1.0)),
        (pt.PANOC, dict(x0=x0, f=pt.AutoDifferentiable(
            lambda x: 0.5 * torch.sum((A @ x - b) ** 2)), g=NormL1(LAM))),
    ]


@pytest.mark.parametrize("K", [2, 8])
def test_check_every_exact_single_driver(K):
    """check_every=K on the single-problem driver is exact: masked steps
    freeze the state at convergence, so counts and solutions are
    bit-equal to K = 1's, and the counts are the JAX package's."""
    jA, jb = jnp.asarray(LASSO_A), jnp.asarray(LASSO_B)
    jf = j_make_least_squares(jA, jb)
    jx0 = jnp.zeros(5, jnp.float64)
    jax_kw = [dict(x0=jx0, f=jf, g=JNormL1(LAM), Lf=LF),
              dict(x0=jx0, f=jf, g=JNormL1(LAM), Lf=LF),
              dict(x0=jx0, f=jf, g=JNormL1(LAM), gamma=1.0),
              dict(x0=jx0, f=pa.AutoDifferentiable(
                  lambda x: 0.5 * jnp.real(jnp.vdot(jA @ x - jb,
                                                    jA @ x - jb))),
                   g=JNormL1(LAM))]
    for (make, kw), jkw in zip(_suite(), jax_kw):
        x1, it1 = make(tol=1e-6)(**kw)
        xk, itk = make(tol=1e-6, check_every=K)(**kw)
        assert it1 == itk
        assert torch.equal(x1, xk)
        _, it_j = getattr(pa, make.__name__)(tol=1e-6, check_every=K)(**jkw)
        assert itk == it_j


def test_check_every_at_maxit_cap_and_validation():
    """A block that straddles maxit neither steps nor counts past it, and
    check_every < 1 raises."""
    kw = problem()
    x1, it1 = pt.FastForwardBackward(tol=1e-12, maxit=13)(**kw)
    x4, it4 = pt.FastForwardBackward(tol=1e-12, maxit=13, check_every=4)(**kw)
    assert it1 == it4 == 13
    assert torch.equal(x1, x4)
    with pytest.raises(ValueError, match="check_every"):
        pt.FastForwardBackward(tol=1e-6, check_every=0)(**kw)


def test_check_every_verbose_cadence(capfd):
    """The blocked driver keeps the K = 1 display cadence: rows at
    k % freq == 0 for steps that ran, then the final row."""
    pt.FastForwardBackward(tol=1e-6, verbose=True, freq=50, check_every=8)(
        **problem())
    rows = [ln for ln in capfd.readouterr().out.splitlines() if ln.strip()]
    # 142-iteration solve at freq=50: rows at 50, 100 + the final row
    assert len(rows) == 3
    assert [int(r.split("|")[0]) for r in rows] == [50, 100, 142]


@pytest.mark.parametrize("name", [
    "ForwardBackward", "FastForwardBackward", "ZeroFPR", "PANOC",
    "PANOCplus", "DouglasRachford", "DRLS", "DavisYin", "LiLin", "SFISTA",
    "AFBA", "VuCondat", "ChambollePock"])
def test_every_solver_takes_check_every(name):
    """Each solver passes ``check_every`` to the driver, not to its
    iteration factory (which would raise the factory's TypeError), as the
    JAX package's do."""
    solver = getattr(pt, name)(check_every=4)
    assert solver.check_every == 4
    assert "check_every" not in solver.kwargs
    assert getattr(pa, name)(check_every=4).check_every == 4
