"""The rest of the port's batched surface against the JAX package, on the
CPU in float64: ``stack_iterations``, ``batch_problems``,
``broadcast_hyperparams`` and ``compacting_batched_run``.  Ports of
``tests/test_batch.py:96-123, 161-208`` and
``tests/test_shared_batch.py:161-184, 354-380, 452-471``.

Compaction is held to ``batched_run_loop`` at ``atol=0`` (counts, done
flags and solutions), and both to the JAX package's counts on the same
numpy inputs.
"""

import copy
import dataclasses
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import proxtpu.parallel as jpar
from proxtpu.algorithms import (
    make_fast_forward_backward_iteration as j_make_fista,
)
from proxtpu.prox import LeastSquaresLoss as JLeastSquaresLoss
from proxtpu.prox import NormL1 as JNormL1
from proxtpu.prox import make_least_squares as j_make_least_squares
from proxtpu_torch.algorithms import make_fast_forward_backward_iteration
from proxtpu_torch.parallel import (
    Shared,
    batch_problems,
    batched_run_loop,
    broadcast_hyperparams,
    compacting_batched_run,
    stack_iterations,
)
from proxtpu_torch.prox import LeastSquaresLoss, NormL1, make_least_squares

TOL = 1e-6


def random_lasso(k, m=8, n=12, jax_side=False):
    rng = np.random.default_rng(k)
    A = rng.standard_normal((m, n))
    b = rng.standard_normal(m)
    lam = 0.1 * float(np.max(np.abs(A.T @ b)))
    Lf = float(np.linalg.norm(A, 2) ** 2)
    if jax_side:
        return dict(x0=jnp.zeros(n, jnp.float64),
                    f=j_make_least_squares(jnp.asarray(A), jnp.asarray(b)),
                    g=JNormL1(lam), Lf=Lf)
    # per-problem numbers go in as tensors (see stack_iterations)
    return dict(x0=torch.zeros(n, dtype=torch.float64),
                f=make_least_squares(torch.tensor(A), torch.tensor(b)),
                g=NormL1(torch.tensor(lam, dtype=torch.float64)), Lf=Lf)


def _jax_run(n, maxit):
    it = jpar.batch_problems(j_make_fista,
                             [random_lasso(k, jax_side=True)
                              for k in range(n)])
    return jpar.batched_run_loop(it, maxit, TOL)


def test_check_every_exact_at_maxit_cap():
    """A K-block straddling maxit neither steps nor counts past it: capped
    lanes report iters == maxit and the iterate of K = 1."""
    iteration = batch_problems(make_fast_forward_backward_iteration,
                               [random_lasso(k) for k in range(4)])
    # maxit=10 caps every lane; 10 is not a multiple of K=4
    xs1, i1, d1 = batched_run_loop(iteration, 10, TOL)
    xs4, i4, d4 = batched_run_loop(iteration, 10, TOL, check_every=4)
    assert torch.equal(i1, i4) and torch.equal(d1, d4)
    assert torch.equal(xs1, xs4)
    assert (i1 == 10).all()
    xs_j, i_j, _ = _jax_run(4, 10)
    np.testing.assert_array_equal(i1.numpy(), np.asarray(i_j))
    np.testing.assert_allclose(xs1.numpy(), np.asarray(xs_j), rtol=0,
                               atol=1e-12)


@pytest.mark.parametrize("maxit,chunk", [(2000, 100), (50, 20)])
def test_compacting_run_matches_plain(maxit, chunk):
    """Lane compaction is an optimization only: per-lane solutions,
    iteration counts and done flags match batched_run_loop exactly, also
    where maxit caps lanes."""
    iteration = batch_problems(make_fast_forward_backward_iteration,
                               [random_lasso(k) for k in range(12)])
    xs1, i1, d1 = batched_run_loop(iteration, maxit, TOL)
    xs2, i2, d2 = compacting_batched_run(iteration, maxit, TOL, chunk=chunk,
                                         min_batch=4)
    assert torch.equal(i1, i2) and torch.equal(d1, d2)
    assert torch.equal(xs1, xs2)
    _, i_j, d_j = _jax_run(12, maxit)
    np.testing.assert_array_equal(i2.numpy(), np.asarray(i_j))
    np.testing.assert_array_equal(d2.numpy(), np.asarray(d_j))


@dataclasses.dataclass(frozen=True)
class Bag:
    a: object
    b: object


@dataclasses.dataclass(frozen=True)
class BagX0:
    x0: object
    b: object


def test_auto_shared_only_with_x0_batch_inference():
    """broadcast_hyperparams wraps unstacked tensors in Shared only when
    the batch size came from x0; with no x0 field, B comes from the first
    tensor, which cannot tell an unstacked operand from the batch axis, so
    nothing is wrapped (the JAX package's rule)."""
    out = broadcast_hyperparams(Bag(torch.zeros(4, 3), torch.zeros(7, 3)))
    assert not isinstance(out.b, Shared)
    assert out.b.shape == (7, 3)
    out = broadcast_hyperparams(BagX0(torch.zeros(4, 3), torch.zeros(7, 3)))
    assert isinstance(out.b, Shared)
    # the JAX package's answer on the same two shapes
    j_out = jpar.broadcast_hyperparams({"a": jnp.zeros((4, 3)),
                                        "b": jnp.zeros((7, 3))})
    assert not isinstance(j_out["b"], jpar.Shared)


def test_generic_driver_follows_the_rule():
    """The generic driver runs through broadcast_hyperparams: a tensor
    whose leading dim is not B rides unmapped only when B comes from x0.
    Without x0, the port's driver maps it and vmap refuses the mismatch,
    as the JAX package's does."""

    @dataclasses.dataclass(frozen=True)
    class Shift:
        x0: object
        c: object

        def init(self):
            return self.x0

        def step(self, s):
            return s + self.c.sum()

        def default_stopping_criterion(self, tol, s):
            return s.sum() > 1

        def default_solution(self, s):
            return s

    # c (3,) against B = 4 from x0: lane-invariant
    xs, iters, done = batched_run_loop(
        Shift(torch.zeros(4), torch.full((3,), 0.25)), 50, 0.0)
    assert bool(done.all()) and (iters == 3).all()

    @dataclasses.dataclass(frozen=True)
    class NoX0:
        start: object
        c: object

        init = lambda self: self.start  # noqa: E731
        step = Shift.step
        default_stopping_criterion = Shift.default_stopping_criterion
        default_solution = Shift.default_solution

    with pytest.raises(ValueError):
        batched_run_loop(NoX0(torch.zeros(4), torch.full((3,), 0.25)), 50,
                         0.0)


def test_broadcast_hyperparams_tuple_x0():
    """B comes from x0's tensors, not from the container: a tuple iterate
    (Davis-Yin's product space) must not read B as the tuple's length."""
    from proxtpu_torch.algorithms import make_davis_yin_iteration
    from proxtpu_torch.prox import SqrNormL2, Zero

    Bn = 5
    X = torch.zeros(Bn, 7, dtype=torch.float64)
    it = make_davis_yin_iteration(x0=(X, X), f=SqrNormL2(1.0),
                                  g=NormL1(0.1), h=Zero(), gamma=0.5)
    out = broadcast_hyperparams(it)
    # rank-0 hyperparameters gained exactly the (Bn,) batch axis
    assert out.gamma.shape == (Bn,)
    # x0's own tensors stayed unwrapped and batched
    assert not isinstance(out.x0[0], Shared)
    assert out.x0[0].shape == (Bn, 7)


B, M, N = 6, 48, 32


def shared_lasso_problem():
    rng = np.random.default_rng(7)
    A = rng.standard_normal((M, N)) / np.sqrt(M)
    b = rng.standard_normal(M)
    lam = 0.05 + 0.25 * rng.random(B)
    Lf = float(np.linalg.norm(A, 2) ** 2)
    return A, b, lam, Lf


def test_compacting_run_keeps_shared_subtrees():
    A, b, lam, Lf = shared_lasso_problem()
    iteration = make_fast_forward_backward_iteration(
        x0=torch.zeros((B, N), dtype=torch.float64),
        f=Shared(LeastSquaresLoss(torch.tensor(A), torch.tensor(b))),
        g=NormL1(torch.tensor(lam)), Lf=torch.full((B,), Lf,
                                                   dtype=torch.float64))
    xs, iters, done = batched_run_loop(iteration, 5000, TOL)
    xs_c, iters_c, done_c = compacting_batched_run(iteration, 5000, TOL,
                                                   chunk=64, min_batch=2)
    assert bool(done.all()) and bool(done_c.all())
    assert torch.equal(xs, xs_c)
    assert torch.equal(iters, iters_c)

    j_it = j_make_fista(
        x0=jnp.zeros((B, N)),
        f=jpar.Shared(JLeastSquaresLoss(jnp.asarray(A), jnp.asarray(b))),
        g=JNormL1(jnp.asarray(lam)), Lf=jnp.full((B,), Lf))
    xs_j, iters_j, _ = jpar.compacting_batched_run(j_it, 5000, TOL, chunk=64,
                                                   min_batch=2)
    np.testing.assert_array_equal(iters_c.numpy(), np.asarray(iters_j))
    np.testing.assert_allclose(xs_c.numpy(), np.asarray(xs_j), rtol=0,
                               atol=1e-9)


def test_shared_pickles_and_refuses_stacking():
    """Checkpoints serialize iteration objects, so Shared must pickle and
    deepcopy; and stack_iterations must refuse Shared members (stacking B
    copies inside the wrapper would batch data the drivers then treat as
    lane-invariant)."""
    A, b, _, _ = shared_lasso_problem()
    s = Shared(LeastSquaresLoss(torch.tensor(A), torch.tensor(b)))
    s2 = pickle.loads(pickle.dumps(s))
    assert isinstance(s2, Shared)
    assert torch.equal(s2.A, s.A)
    assert isinstance(copy.deepcopy(s), Shared)
    with pytest.raises(ValueError, match="Shared"):
        stack_iterations([{"f": s}, {"f": s}])


def test_stack_iterations_accepts_generators():
    """Generator inputs survive the Shared guard (the JAX package's
    regression: the guard used to exhaust the generator)."""
    rng = np.random.default_rng(5)
    A = torch.tensor((rng.standard_normal((8, 12)) / np.sqrt(8))
                     .astype(np.float32))
    Lf = float(np.linalg.norm(A.numpy(), 2) ** 2)

    def make(i):
        b = torch.tensor(rng.standard_normal(8).astype(np.float32))
        return make_fast_forward_backward_iteration(
            x0=torch.zeros(12), f=LeastSquaresLoss(A, b), g=NormL1(0.1),
            Lf=Lf)

    stacked = stack_iterations(make(i) for i in range(3))
    assert stacked.x0.shape == (3, 12)
    assert stacked.f.A.shape == (3, 8, 12)


def test_stack_iterations_refuses_differing_numbers():
    """A number is not a lane array in the port: iterations whose
    non-tensor parts differ are refused (the JAX package stacks Python
    numbers as leaves; pass them as tensors here)."""
    problems = [random_lasso(k) for k in range(2)]
    for p, lam in zip(problems, (0.1, 0.2)):
        p["g"] = NormL1(lam)
    with pytest.raises(ValueError, match="not a tensor"):
        batch_problems(make_fast_forward_backward_iteration, problems)
