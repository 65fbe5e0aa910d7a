"""``docs/tpu_scaling.md``'s twelve blocks on the port
(``proxtpu_torch/examples/scaling_guide.py``) against the same blocks
executed under JAX, as ``tests/test_torch_guides.py`` executes its blocks:
the doc's text, with the names it uses supplied.  Where the text holds
``...`` (blocks 1, 6, 11) the test writes out the call the block shows,
filled as the port's function fills it; on the CPU the Pallas kernels of
blocks 9 and 11 run in interpret mode, as ``tests/test_kernels.py`` runs
them.  Both sides get the same numpy inputs (``scaling_guide.lassos``) at
``scaling_guide.SMALL``'s sizes.

Tolerances: blocks 1-3 and 6 in float64, equal counts and solutions within
1e-9 (block 5: 1e-10, as ``tests/test_torch_multiprocess.py``); block 4
within 1e-12 of per-lane calls; block 8 by ``tests/test_warm.py``'s oracle
(its float32 stage is not held to JAX's), the cold float64 solve at equal
counts; the float32 blocks
9-11 by the reference's cross-path contract, counts within 1 and
solutions within 1e-4 (``tests/test_kernels.py:49-61``).  The port's result
also meets what its block claims (``scaling_guide.check``).  Blocks 5, 6
and 12: ``tests/test_torch_scaling_guide_ranks.py``; blocks 4 and 8 at their
own scale, where the JAX blocks miss their text's claims:
``tests/test_torch_scaling_guide_scale.py``.
"""

import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import proxtpu as pa  # noqa: F401  (the blocks' own name)
from proxtpu.algorithms import (
    make_fast_forward_backward_iteration,
    make_forward_backward_iteration,
)
from proxtpu.kernels import lasso as jl
from proxtpu.parallel import BatchedAlgorithm, Shared, batched_run_loop
from proxtpu.prox import LeastSquaresLoss, NormL1
from proxtpu.utils.precision import get_matmul_precision
import torch_scaling_jax as tj
from proxtpu_torch.examples import SCALING_JAX_ITERATIONS, \
    SCALING_POWER_JAX_WORST
from proxtpu_torch.examples import scaling_guide as sg
from proxtpu_torch.tools import problems


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with tj.one_thread():
        yield


F32_ATOL = 1e-4


def _data(i, dtype=np.float64):
    s = sg.SMALL[i]
    lanes = s.get("source", s["lanes"])
    data = sg.lassos(lanes, s["m"], s["n"],
                     first=s["lanes"] * s.get("payloads", 1), dtype=dtype)
    return tuple(jnp.asarray(v) for v in data)


def _equal_counts(port, ref):
    np.testing.assert_array_equal(tj.numpy(port), tj.numpy(ref))


def _cross_path(port, ref, atol=F32_ATOL):
    """The reference's float32 cross-path contract: counts within 1,
    solutions within ``atol``."""
    (xs, it), (xs_j, it_j) = port, ref
    assert int(np.abs(tj.numpy(it).astype(int)
                      - tj.numpy(it_j).astype(int)).max()) <= 1
    tj.close(xs, xs_j, atol)


@pytest.fixture(scope="module")
def scenario():
    """Block 1 in JAX and on the port, shared by blocks 1 and 2."""
    return _jax_scenario(), tj.port(1)


def test_every_block_has_its_port():
    assert set(sg.BLOCKS) == {("tpu_scaling.md", i + 1)
                              for i in range(tj.count())}
    assert set(sg.SMALL) == {i for _, i in sg.BLOCKS}
    assert set(SCALING_JAX_ITERATIONS) == {
        f"tpu_scaling.md:{i}" for i in (1, 2, 3, 5, 6, 8, 9, 10, 11)}


def _jax_scenario():
    A, b, lam, Lf = _data(1)
    problems_ = [dict(x0=jnp.zeros(A.shape[2]), f=LeastSquaresLoss(A[i], b[i]),
                      g=NormL1(float(lam[i])), Lf=float(Lf[i]))
                 for i in range(A.shape[0])]
    text = re.sub(r"problems = \[dict\(x0=\.\.\..*\n", "", tj.block(1))
    ns = tj.run(1, {"problems": problems_}, text)
    return ns["xs"], ns["iters"], ns["done"]


def test_block_1_batch_problems_with_python_numbers(scenario):
    (xs, iters, done), port = scenario
    _equal_counts(port["iters"], iters)
    tj.close(port["xs"], xs, tj.ATOL)
    assert port["iters_single"] == [int(k) for k in iters[:sg.SINGLE]]
    assert SCALING_JAX_ITERATIONS["tpu_scaling.md:1"] == np.asarray(
        iters).tolist()


def test_block_2_vmapped_factory(scenario):
    As, bs, lams, Lfs = _data(2)
    ns = tj.run(2, {"jax": jax, "jnp": jnp, "N": As.shape[2],
                   "DTYPE": jnp.float64, "As": As, "bs": bs, "lams": lams,
                   "Lfs": Lfs, "LeastSquaresLoss": LeastSquaresLoss,
                   "NormL1": NormL1, "make_fast_forward_backward_iteration":
                   make_fast_forward_backward_iteration})
    xs, iters, done = batched_run_loop(ns["iteration"], 2000, 1e-6)
    (_, iters_1, _), port_1 = scenario
    port = sg.vmapped_factory("cpu", **sg.SMALL[2], scenario=port_1)
    sg.check(("tpu_scaling.md", 2), port)
    _equal_counts(port["iters"], iters)
    tj.close(port["xs"], xs, tj.ATOL)
    _equal_counts(iters_1, iters)  # the JAX block 1's too
    assert SCALING_JAX_ITERATIONS["tpu_scaling.md:2"] == np.asarray(
        iters).tolist()


def test_block_3_adaptive_backtrack_limit():
    s = sg.SMALL[3]
    As, bs, lams = (jnp.asarray(v) for v in problems.lasso_data(
        s["lanes"], s["m"], s["n"], np.float64))
    ns = tj.run(3, {"BatchedAlgorithm": BatchedAlgorithm,
                   "make_forward_backward_iteration":
                   make_forward_backward_iteration,
                   "X0": jnp.zeros((s["lanes"], s["n"])),
                   "fs": LeastSquaresLoss(As, bs), "gs": NormL1(lams)})
    port = tj.port(3)
    _equal_counts(port["iters"], ns["it"])
    tj.close(port["xs"], ns["xs"], tj.ATOL)
    assert int(np.max(ns["it"])) < 3000  # never at the cap
    assert SCALING_JAX_ITERATIONS["tpu_scaling.md:3"] == np.asarray(
        ns["it"]).tolist()


def test_block_4_vmapped_power_iteration():
    port = tj.port(4)
    (As, *_), exact = _data(4), port["Lfs_exact"].numpy()
    # vmap with randomness="same": each lane's unvmapped call
    tj.close(port["Lfs"], port["Lfs_looped"], 1e-12 * float(exact.max()))
    # both packages estimate the same norms; their normal starts differ
    for est in (port["Lfs"].numpy(), tj.jax_power(As)):
        assert float(np.max(np.abs(est - exact) / exact)) <= max(
            sg.OPNORM_CLAIM, SCALING_POWER_JAX_WORST)


def test_power_iteration_vmap_same_gives_each_lane_its_bits():
    """``power_iteration_opnorm`` under ``torch.func.vmap(...,
    randomness="same")``: every lane within 1e-12 of its unvmapped call
    (its docstring's claim)."""
    from proxtpu_torch.ops.linops import MatrixOperator, \
        power_iteration_opnorm

    As = torch.as_tensor(problems.lasso_data(6, 12, 20, np.float64)[0])

    def one(A):
        return power_iteration_opnorm(
            MatrixOperator(A), torch.zeros(20, dtype=A.dtype))

    vmapped = torch.func.vmap(one, randomness="same")(As)
    looped = torch.stack([one(A) for A in As])
    np.testing.assert_allclose(vmapped.numpy(), looped.numpy(), rtol=1e-12,
                               atol=0)
    with pytest.raises(RuntimeError, match="randomness"):
        torch.func.vmap(one)(As)


def test_block_7_tf32_raises_and_restores():
    """The doc's call in JAX, then the FISTA solve of the block's lanes on
    the generic driver at its setting against the port's at the same
    setting (float32: the cross-path contract); on the CPU the port's
    three settings give the same bits, and the setting, the flags and the
    TF32 guard's raise are as ``scaling_guide.check`` holds them."""
    ns = {}
    saved = get_matmul_precision()
    try:
        tj.run(7, ns)
        assert get_matmul_precision() != saved
        A, b, lam, Lf = _data(7, np.float32)
        xs, iters, _ = BatchedAlgorithm(
            make_fast_forward_backward_iteration, maxit=2000, tol=1e-5,
            use_kernels=False)(x0=jnp.zeros((A.shape[0], A.shape[2]),
                                            jnp.float32),
                               f=LeastSquaresLoss(A, b), g=NormL1(lam),
                               Lf=Lf)
    finally:
        pa.set_matmul_precision(saved)
    flags = torch.backends.cuda.matmul
    before = flags.allow_tf32
    port = tj.port(7)
    assert flags.allow_tf32 == before and port["restored"]
    runs = port["runs"]
    assert list(runs) == list(sg.PRECISIONS)
    for run in runs.values():
        assert torch.equal(run["xs"], runs["highest"]["xs"])
        assert torch.equal(run["iters"], runs["highest"]["iters"])
    _cross_path((runs["default"]["xs"], runs["default"]["iters"]),
                (xs, iters))


def test_block_8_warm_start():
    s = sg.SMALL[8]
    A, b, lams, Lf = problems.shared_lasso_problem(s["lanes"], s["m"],
                                                   s["n"], np.float64)
    kw = dict(x0_f64=jnp.zeros((s["lanes"], s["n"])),
              f=LeastSquaresLoss(jnp.asarray(A), jnp.asarray(b)),
              lams=jnp.asarray(lams), Lf=Lf)
    from proxtpu.parallel import WarmStartedBatchedAlgorithm

    ns = tj.run(8, dict(kw, Shared=Shared, NormL1=NormL1,
                       make_fast_forward_backward_iteration=(
                           make_fast_forward_backward_iteration),
                       WarmStartedBatchedAlgorithm=(
                           WarmStartedBatchedAlgorithm)))
    xs_c, it_c, _ = BatchedAlgorithm(
        make_fast_forward_backward_iteration, maxit=20_000, tol=1e-8)(
        x0=kw["x0_f64"], f=Shared(kw["f"]), g=NormL1(kw["lams"]), Lf=Lf)
    port = tj.port(8)
    _equal_counts(port["iters_cold"], it_c)
    tj.close(port["xs_cold"], xs_c, tj.ATOL)
    assert bool(np.all(ns["done"]))
    # tests/test_warm.py's oracle: the warm solution within 50 tol of the
    # cold one (the port's float32 stage is not held to JAX's)
    tj.close(port["xs"], xs_c, 50 * 1e-8)
    tj.close(ns["xs"], xs_c, 50 * 1e-8)
    assert SCALING_JAX_ITERATIONS["tpu_scaling.md:8"] == np.asarray(
        ns["iters"]).tolist()


def test_block_9_kernel_solver():
    A, b, lam, Lf = _data(9, np.float32)
    text = tj.block(9).replace("maxit=2000)", "maxit=2000, interpret=True)")
    ns = tj.run(9, {"A": A, "b": b, "lam": lam, "Lf": Lf}, text)
    port = tj.port(9)
    _cross_path((port["xs"], port["iters"]), (ns["z"], ns["iters"]))
    _cross_path((port["xs_plain"], port["iters_plain"]),
                (ns["z"], ns["iters"]))
    assert SCALING_JAX_ITERATIONS["tpu_scaling.md:9"] == np.asarray(
        ns["iters"]).tolist()


def test_block_10_shared_design_matrix():
    s = sg.SMALL[10]
    A, b, lams, Lf = (jnp.asarray(v) if isinstance(v, np.ndarray) else v
                      for v in problems.shared_lasso_problem(
                          s["lanes"], s["m"], s["n"]))
    ns = tj.run(10, {"make_fast_forward_backward_iteration":
                    make_fast_forward_backward_iteration,
                    "X0": jnp.zeros((s["lanes"], s["n"]), jnp.float32),
                    "A": A, "b": b, "lams": lams, "Lf": Lf})
    port = tj.port(10)
    _cross_path((port["xs"], port["iters"]), (ns["xs"], ns["iters"]))
    _cross_path((port["xs_stacked"], port["iters_stacked"]),
                (ns["xs"], ns["iters"]))
    assert SCALING_JAX_ITERATIONS["tpu_scaling.md:10"] == np.asarray(
        ns["iters"]).tolist()


def test_block_11_stream_solve():
    s = sg.SMALL[11]
    data = _data(11, np.float32)
    payloads = [tuple(v[k * s["lanes"]:(k + 1) * s["lanes"]] for v in data)
                for k in range(s["payloads"])]
    text = tj.block(11).replace(
        "    ...        # yielded", "    results.append((xs, iters, done))"
        "  # yielded")
    ns = tj.run(11, {"payloads": payloads, "results": [],
                    "solve_lasso_batch_packed": functools.partial(
                        jl.solve_lasso_batch_packed, interpret=True)}, text)
    port = tj.port(11)
    assert len(ns["results"]) == len(port["streamed"]) == s["payloads"]
    for (xs, it, _), (xs_j, it_j, _) in zip(port["streamed"],
                                            ns["results"]):
        _cross_path((xs, it), (xs_j, it_j))
    assert SCALING_JAX_ITERATIONS["tpu_scaling.md:11"] == [
        np.asarray(r[1]).tolist() for r in ns["results"]]
