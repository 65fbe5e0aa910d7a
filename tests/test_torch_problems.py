"""The port's one copy of the harness's lasso generators
(``proxtpu_torch/tools/problems.py``) against the JAX side's three:
``bench.gen_problems``, ``benchmarks/kernel_sweep.py::gen`` and
``benchmarks/scaling.py::gen_problems``, byte for byte."""

import numpy as np
import pytest

import bench
from benchmarks import kernel_sweep, scaling
from proxtpu_torch.tools import problems


def _same_bytes(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()


@pytest.mark.parametrize("batch", [1, 8])
def test_bench_gen_problems(batch):
    assert (problems.M, problems.N, problems.BATCH) == (
        bench.M, bench.N, bench.BATCH)
    _same_bytes(problems.lasso_problems(batch), bench.gen_problems(batch))


@pytest.mark.parametrize("shape", [(4, 33, 17), (2, 64, 128)])
def test_kernel_sweep_gen(shape):
    _same_bytes(problems.lasso_problems(*shape), kernel_sweep.gen(*shape))


@pytest.mark.parametrize("dtype,seed", [(np.float32, 0), (np.float64, 3)])
def test_scaling_gen_problems(dtype, seed):
    _same_bytes(problems.lasso_problems(6, 20, 40, dtype, seed),
                scaling.gen_problems(6, 20, 40, dtype, seed))
