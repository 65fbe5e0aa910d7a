"""The reference benchmark matrix on the port against the JAX reference, on
the CPU in float64: the ten configurations of
``benchmarks/run_benchmarks.py`` (``proxtpu_torch.tools.reference_suite``)
on ``lasso_tiny.npz`` give the JAX package's iteration counts exactly,
solutions within 1e-8 and the same forward-backward recheck.

Run as a script, it prints the JAX package's iterations and rechecks on
the instances ``chip_smoke.py`` times, in float64 and float32, from which it
takes its gates.
"""

import numpy as np
import pytest
import torch

from benchmarks import run_benchmarks as rb
from proxtpu_torch.tools import reference_suite as rs


@pytest.fixture(scope="module")
def tiny():
    return rs.load_workload("lasso_tiny")


@pytest.mark.parametrize("name", rs.CONFIGS)
def test_reference_matrix_lasso_tiny_matches_jax(tiny, name):
    A, b, lam = tiny
    configs = rb.solver_configs(A, b, lam, np.float64)
    assert tuple(configs) == rs.CONFIGS
    solver, kw = configs[name]
    x_j, it_j = solver(**kw)
    solver, kw = rs.solver_configs(torch.tensor(A), torch.tensor(b),
                                   lam)[name]
    x_t, it_t = solver(**kw)
    x_j, x_t = rs.primal(x_j), rs.primal(x_t)
    assert it_t == int(it_j) < solver.maxit
    np.testing.assert_allclose(x_t.numpy(), np.asarray(x_j), rtol=0,
                               atol=1e-8)
    assert rs.fb_recheck(A, b, lam, x_t) == pytest.approx(
        rs.fb_recheck(A, b, lam, np.asarray(x_j)), rel=1e-6)


def test_workloads_load():
    for name in rs.WORKLOADS:
        A, b, lam = rs.load_workload(name)
        assert A.dtype == np.float64 and b.shape == (A.shape[0],) and lam > 0


def reference_rechecks():
    """``(dtype, name, iterations, recheck)`` of the JAX package on the
    instances the suite times (``lasso_medium.npz``, Douglas-Rachford on
    ``lasso_small.npz``): the ten configurations in float64 and the float32
    line at its tolerances, the figures behind ``chip_smoke.py``'s gates."""
    for dtype, names in ((np.float64, rs.CONFIGS),
                         (np.float32, tuple(rs.FLOAT32_LINE))):
        for name in names:
            A, b, lam = rs.load_workload(rs.TIMED_ON.get(name,
                                                         "lasso_medium"))
            solver, kw = rb.solver_configs(A, b, lam, dtype)[name]
            if dtype == np.float32:
                solver = getattr(pa, name)(tol=rs.FLOAT32_LINE[name])
            x, it = solver(**kw)
            yield (np.dtype(dtype).name, name, int(it),
                   rs.fb_recheck(A, b, lam, np.asarray(rs.primal(x))))


if __name__ == "__main__":
    # PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_reference_suite.py
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import proxtpu as pa

    for dtype, name, it, r in reference_rechecks():
        print(f"{dtype:8s} {name:20s} {it:6d} {r:.6e}", flush=True)
