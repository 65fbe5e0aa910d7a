"""Tests for :func:`proxtpu_torch.parallel.stream_solve` on the CPU.

The counterparts of ``tests/test_stream.py``: order preservation, depth
handling, parity with sequential execution, fence invocation.  The default
CUDA-event fence does nothing for CPU tensors; on the card it is exercised
by ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

from proxtpu_torch import problems_from_numpy
from proxtpu_torch.kernels.lasso import solve_lasso_batch
from proxtpu_torch.parallel import stream_solve


def _gen(B, m, n, seed):
    rng = np.random.default_rng(seed)
    As = (rng.standard_normal((B, m, n)) / np.sqrt(m)).astype(np.float32)
    bs = rng.standard_normal((B, m)).astype(np.float32)
    lams = 0.1 * np.max(
        np.abs(np.einsum("bmn,bm->bn", As, bs)), axis=1
    ).astype(np.float32)
    Lfs = np.array(
        [np.linalg.norm(As[i], 2) ** 2 for i in range(B)], np.float32
    )
    return problems_from_numpy(As, bs, lams, Lfs, device="cpu")


@pytest.mark.parametrize("depth", [0, 1, 2, 3])
def test_stream_solve_matches_sequential(depth):
    problems = [_gen(4, 12, 16, seed) for seed in range(5)]

    def solve(p):
        A, b, lam, Lf = p
        return solve_lasso_batch(
            A, b, lam, Lf, 1e-6, maxit=2000, use_kernel=False
        )

    streamed = list(stream_solve(solve, problems, depth=depth))
    assert len(streamed) == len(problems)
    for p, out in zip(problems, streamed):
        xs_ref, iters_ref, done_ref = solve(p)
        assert torch.equal(out[0], xs_ref)
        assert torch.equal(out[1], iters_ref)
        assert bool(out[2].all())


def test_stream_solve_order_and_fence_calls():
    seen = []

    def solve(i):
        return {"i": torch.tensor([i]), "big": torch.zeros((8, 8)) + i}

    def fence(out):
        seen.append(int(out["i"][0]))

    outs = list(stream_solve(solve, range(7), depth=2, fence=fence))
    assert [int(o["i"][0]) for o in outs] == list(range(7))
    assert seen == list(range(7))  # fenced in order, exactly once each


def test_stream_solve_depth_validation():
    with pytest.raises(ValueError):
        stream_solve(lambda p: p, [1], depth=-1)


def test_stream_solve_default_fence_handles_scalars():
    outs = list(
        stream_solve(lambda i: (torch.tensor(i), torch.zeros(16), i),
                     range(3))
    )
    assert [o[2] for o in outs] == [0, 1, 2]
