"""The port's spans (``proxtpu_torch.utils.tracing``): recorded only inside
a ``torch.profiler`` session, nested and named as the layers set them, with
one call id a solve, the counts they carry, and no effect on the answers."""

import collections
import gc

import pytest
import torch

import proxtpu_torch as pt
from proxtpu_torch.kernels import dispatch
from proxtpu_torch.kernels.lasso import solve_lasso_batch_packed_tail
from proxtpu_torch.parallel.stream import stream_solve
from proxtpu_torch.prox import LeastSquaresLoss, NormL1
from proxtpu_torch.utils import tracing
from proxtpu_torch.utils.host_loop import run_host_loop


@pytest.fixture(autouse=True)
def empty_buffer():
    tracing.clear()
    yield
    tracing.clear()


def profiled():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def lasso(B, M, N, seed=0):
    g = torch.Generator().manual_seed(seed)
    A = torch.randn(B, M, N, generator=g) / M ** 0.5
    b = torch.randn(B, M, generator=g)
    lam = 0.1 * torch.einsum("bmn,bm->bn", A, b).abs().amax(1)
    Lf = torch.linalg.matrix_norm(A, 2) ** 2 * 1.001
    return A, b, lam, Lf


# 16 lanes of N = 200: 16 problems a packed row, so phase 1 and a full
# phase 2 pack A; tail 16 sends phase 2 to the narrow solver
def packed_tail(tail):
    A, b, lam, Lf = lasso(16, 12, 200)
    return solve_lasso_batch_packed_tail(A, b, lam, Lf, 1e-5, maxit=200,
                                         k1=24, tail=tail)


def dispatched(solve):
    """``solve()``'s answer, dispatched as the benchmark's cells do."""
    return next(stream_solve(lambda _: solve(), [None], depth=0))


def parents(records):
    byid = {r.id: r for r in records}
    return collections.Counter(
        (r.name, byid[r.parent].name if r.parent else None) for r in records)


def test_nothing_is_recorded_without_a_session():
    packed_tail(4)
    gc.collect()
    assert tracing.records() == []
    # off, a span is one shared object that records nothing
    assert tracing.span("a") is tracing.span("b", 3)


@pytest.mark.parametrize("tail, phase2", [(4, "solve.phase2_full"),
                                          (16, "solve.phase2_tail")])
def test_a_packed_tail_solve_gives_the_spans_of_its_layers(tail, phase2):
    with profiled():
        dispatched(lambda: packed_tail(tail))
    records = tracing.records()
    root, = [r for r in records if r.parent is None]
    assert root.name == "stream.dispatch"
    assert {r.call for r in records} == {root.id}
    got = parents(records)
    children = {"solve.phase1": 1, "sync.phase_count": 1, phase2: 1}
    assert {k[0]: n for k, n in got.items()
            if k[1] == "stream.dispatch"} == children
    assert got["solve.pack", "solve.phase1"] == 1
    assert got["solve.init", "solve.phase1"] == 1
    assert got["solve.init", phase2] == 1
    assert got["solve.pack", phase2] == (phase2 == "solve.phase2_full")
    for phase in ("solve.phase1", phase2):
        assert got["loop.issue", phase] >= 1
        assert got["sync.loop_check", phase] >= got["loop.issue", phase]
    assert set(r.name for r in records) <= {
        "stream.dispatch", "solve.phase1", "sync.phase_count", phase2,
        "solve.pack",
        "solve.init", "loop.issue", "sync.loop_check", "host.gc"}
    # a child lies inside its parent
    byid = {r.id: r for r in records}
    for r in records:
        if r.parent:
            p = byid[r.parent]
            assert p.start_ns <= r.start_ns <= r.end_ns <= p.end_ns


@pytest.mark.parametrize("maxit, k_step, check_every, done_at", [
    (100, 1, 16, 40), (100, 8, 16, 1000), (37, 8, 16, 1000),
    (50, 1, 4, 0), (30, 1, 16, 17)])
def test_the_host_loop_counts_its_tests_and_steps(maxit, k_step,
                                                  check_every, done_at):
    tests, calls = [], []

    def body(k, state):
        calls.append(k)
        return k

    def done_of(state):
        tests.append(state)
        return torch.tensor([state >= done_at])

    with profiled():
        run_host_loop(body, 1, done_of, maxit, k_step=k_step,
                      check_every=check_every)
    records = tracing.records()
    checks = [r for r in records if r.name == "sync.loop_check"]
    issues = [r for r in records if r.name == "loop.issue"]
    assert len(checks) == len(tests) and tests
    assert sum(r.n for r in issues) == len(calls)
    assert all(1 <= r.n <= max(1, check_every // k_step) for r in issues)


def test_a_blocked_batched_call_gives_the_match_and_the_blocked_leg():
    A, b, lam, Lf = lasso(2, 256, 1024)
    assert A[0].numel() * A.element_size() >= dispatch.BLOCKED_LANE_BYTES
    solver = pt.BatchedAlgorithm(pt.make_fast_forward_backward_iteration,
                                 maxit=24, tol=1e-5)
    with profiled():
        xs, iters, done = dispatched(lambda: solver(
            x0=torch.zeros(2, 1024), f=LeastSquaresLoss(A, b),
            g=NormL1(lam), Lf=Lf))
    assert int(iters.max()) == 24
    records = tracing.records()
    assert len({r.call for r in records}) == 1
    got = parents(records)
    assert got["batched.match", "stream.dispatch"] == 1
    assert got["batched.solve", "stream.dispatch"] == 1
    assert got["sync.x0_any", "batched.match"] == 1
    assert got["solve.init", "batched.solve"] == 1
    assert got["sync.loop_check", "batched.solve"] >= 1
    # 23 iterations after the FB step, 8 a launch: 3 launches, tested
    # every 16 iterations
    assert sum(r.n for r in records if r.name == "loop.issue") == 3


def test_stream_solve_traces_each_dispatch_in_call_order():
    def solve(p):
        with tracing.span("inner", p):
            return torch.full((2,), p)

    with profiled():
        outs = list(stream_solve(solve, range(4), depth=2))
    assert [int(o[0]) for o in outs] == [0, 1, 2, 3]
    records = sorted(tracing.records(), key=lambda r: r.start_ns)
    roots = [r for r in records if r.name == "stream.dispatch"]
    assert len(roots) == 4 and all(r.parent is None for r in roots)
    # each call is its dispatch's id, in call order
    assert [r.call for r in roots] == [r.id for r in roots]
    assert sorted(r.id for r in roots) == [r.id for r in roots]
    inner = [r for r in records if r.name == "inner"]
    assert [r.n for r in inner] == [0, 1, 2, 3]
    assert [(r.parent, r.call) for r in inner] == [(r.id, r.id)
                                                   for r in roots]


def test_a_solve_in_the_stream_takes_the_dispatch_call():
    A, b, lam, Lf = lasso(16, 12, 200)
    with profiled():
        list(stream_solve(lambda p: solve_lasso_batch_packed_tail(
            A, b, lam, Lf, 1e-5, maxit=60, k1=24, tail=4), range(2)))
    records = tracing.records()
    calls = {r.call for r in records if r.name == "stream.dispatch"}
    assert len(calls) == 2 and {r.call for r in records} == calls
    got = parents(records)
    assert got["solve.phase1", "stream.dispatch"] == 2


def test_a_collection_gives_host_gc():
    with profiled():
        gc.collect()
    gcs = [r for r in tracing.records() if r.name == "host.gc"]
    assert gcs and gcs[-1].n == 2 and gcs[-1].end_ns > gcs[-1].start_ns


def test_the_answers_are_the_same_bits_traced():
    plain = packed_tail(4)
    with profiled():
        traced = packed_tail(4)
    assert tracing.records()
    for p, t in zip(plain, traced):
        assert torch.equal(p, t)


def test_the_buffer_drops_the_oldest_past_its_bound_and_counts_them():
    tracing.clear(capacity=3)
    with profiled():
        for i in range(5):
            with tracing.span("s", i):
                pass
    records = tracing.records()
    assert [r.n for r in records] == [2, 3, 4]
    count, end = tracing.dropped()
    assert count == 2 and end < records[0].start_ns
    tracing.clear()
    assert tracing.dropped() == (0, -1) and tracing.records() == []
