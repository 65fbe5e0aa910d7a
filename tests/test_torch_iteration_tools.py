"""The port's iteration-tool combinators and oracle-counting wrapper:
ports of ``tests/test_iteration_tools.py`` (the reference's
``test/utilities/test_iteration_tools.jl`` and the ``Counting`` wrapper of
``docs/src/guide/custom_objectives.jl:99-137``).

The combinators' semantics are the JAX package's.  ``Counting`` differs
where the two packages run differently: under ``jit`` the JAX package
traces a step once, so its counters tick once per traced function (2 for
``init`` + ``step`` over 10 states); the port runs eagerly and counts
every call (10 over 10 states), as the reference does.  Under the batched
driver a vmapped call counts once for all lanes.
"""

import jax.numpy as jnp
import numpy as np
import torch

import proxtpu as pa
import proxtpu_torch as pt
from problems import LASSO_A, LASSO_B
from proxtpu.prox import NormL1 as JNormL1
from proxtpu.prox import make_least_squares as j_make_least_squares
from proxtpu.utils import iteration_tools as jtools
from proxtpu_torch.prox import LeastSquaresLoss, NormL1, make_least_squares
from proxtpu_torch.utils.iteration_tools import (
    Counting,
    halt,
    loop,
    sample,
    stopwatch,
    tee,
)

LAM = 0.1 * float(np.max(np.abs(LASSO_A.T @ LASSO_B)))
LF = float(np.linalg.norm(LASSO_A, 2) ** 2)


def test_halt_includes_triggering_item():
    out = list(halt(iter(range(10)), lambda x: x >= 3))
    assert out == [0, 1, 2, 3]
    assert out == list(jtools.halt(iter(range(10)), lambda x: x >= 3))


def test_tee_side_effects_every_item():
    seen = []
    out = list(tee(iter(range(4)), seen.append))
    assert out == [0, 1, 2, 3]
    assert seen == out


def test_sample_keeps_every_kth():
    assert list(sample(iter(range(1, 11)), 3)) == [3, 6, 9]
    assert list(jtools.sample(iter(range(1, 11)), 3)) == [3, 6, 9]


def test_stopwatch_monotone():
    ts = [t for t, _ in stopwatch(iter(range(5)))]
    assert all(b >= a for a, b in zip(ts, ts[1:]))
    assert all(t >= 0 for t in ts)


def test_loop_returns_last():
    assert loop(iter(range(7))) == 6
    assert loop(iter([])) is None


def test_counting_through_solver_states():
    """Eager counts: ``init`` and each of 9 steps take one gradient and
    one prox (the JAX package's jitted steps count 2 and 2).  The last
    state is the JAX package's."""
    A, b = torch.tensor(LASSO_A), torch.tensor(LASSO_B)
    cf = Counting(make_least_squares(A, b))
    cg = Counting(NormL1(LAM))
    iteration = pt.ForwardBackward(tol=1e-6).make_iteration(
        x0=torch.zeros(5, dtype=torch.float64), f=cf, g=cg, Lf=LF)
    last = loop(pt.states(iteration, max_states=10))
    assert cf.gradient_count == 10
    assert cg.prox_count == 10
    cf.reset()
    assert cf.gradient_count == 0

    jcf = jtools.Counting(j_make_least_squares(jnp.asarray(LASSO_A),
                                               jnp.asarray(LASSO_B)))
    jcg = jtools.Counting(JNormL1(LAM))
    j_iteration = pa.ForwardBackward(tol=1e-6).make_iteration(
        x0=jnp.zeros(5, jnp.float64), f=jcf, g=jcg, Lf=LF)
    j_last = jtools.loop(pa.algorithms.core.states(j_iteration,
                                                   max_states=10))
    assert (jcf.gradient_count, jcg.prox_count) == (2, 2)
    np.testing.assert_allclose(last.x.numpy(), np.asarray(j_last.x), rtol=0,
                               atol=1e-13)


def test_counting_eager_counts_every_call():
    cg = Counting(NormL1(0.5))
    x = torch.arange(4.0)
    for _ in range(5):
        cg.prox(x, 1.0)
    assert cg.prox_count == 5
    # the wrapped function's own evaluation inside prox does not tick
    # eval_count
    assert cg.eval_count == 0
    cg(x)
    assert cg.eval_count == 1


def test_counting_under_the_batched_driver():
    """``Counting`` is a dataclass, so the batched driver opens it and maps
    the stacked tensors of its ``f``; the rebuilt copies share the
    caller's counters.  One vmapped call counts once: ``init`` and one
    step per iteration of the slowest lane."""
    from proxtpu_torch.algorithms import make_forward_backward_iteration

    rng = np.random.default_rng(0)
    A = rng.standard_normal((3, 4, 5))
    b = rng.standard_normal((3, 4))
    Lf = torch.tensor([np.linalg.norm(A[i], 2) ** 2 for i in range(3)])
    cf = Counting(LeastSquaresLoss(torch.tensor(A), torch.tensor(b)))
    xs, iters, done = pt.BatchedAlgorithm(
        make_forward_backward_iteration, maxit=100, tol=1e-6,
        use_kernels=False, check_every=1)(
        x0=torch.zeros((3, 5), dtype=torch.float64), f=cf, g=NormL1(LAM),
        Lf=Lf)
    assert bool(done.all())
    assert cf.gradient_count == int(iters.max())
    for i in range(3):
        x1, it1 = pt.ForwardBackward(tol=1e-6, maxit=100)(
            x0=torch.zeros(5, dtype=torch.float64),
            f=LeastSquaresLoss(torch.tensor(A[i]), torch.tensor(b[i])),
            g=NormL1(LAM), Lf=float(Lf[i]))
        assert it1 == int(iters[i])
        np.testing.assert_allclose(xs[i].numpy(), x1.numpy(), rtol=0,
                                   atol=1e-12)
