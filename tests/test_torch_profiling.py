"""The port's profiling hooks: ports of ``tests/test_profiling.py`` (a
trace on disk that TensorBoard or Perfetto opens, a cost analysis with real
flop counts), and one case per kernel wrapper: on the plain route (CPU
tensors) ``compiled_stats`` of one wrapper call reports exactly the
``pl.CostEstimate`` that the JAX wrapper gives its ``pallas_call`` on the
same operands (read from its jaxpr), the plain version's own ATen
operations not counted.  The main path is held to the same estimates at
each launch's width.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import proxtpu_torch as pt
from proxtpu.kernels import box_qp as jb
from proxtpu.kernels import lasso as jl
from proxtpu.kernels import tv as jt
from proxtpu_torch.kernels import box_qp as tb
from proxtpu_torch.kernels import lasso as tl
from proxtpu_torch.kernels import probe, tv
from proxtpu_torch.prox import NormL1, make_least_squares
from proxtpu_torch.utils.iteration_tools import Counting
from proxtpu_torch.utils.profiling import compiled_stats, trace

M, N = 16, 8


def _problem(seed):
    rng = np.random.default_rng(seed)
    A = torch.tensor(rng.standard_normal((M, N)))
    b = torch.tensor(rng.standard_normal(M))
    return A, b, float(np.linalg.norm(A.numpy(), 2) ** 2)


def _solve(x0, f, Lf):
    return pt.ForwardBackward(tol=1e-6, maxit=200).run(
        x0=x0, f=f, g=NormL1(0.1), Lf=Lf)


def test_compiled_stats_reports_flops():
    """Every gradient of the lasso is two (16, 8) matvecs of 2 * 16 * 8
    operations.  XLA counts the loop's body once (the JAX test's bound is
    one iteration); the port counts the whole call, one gradient for each
    of the JAX solve's iterations (the initial state's included)."""
    import proxtpu as pa
    from proxtpu.prox import NormL1 as JNormL1
    from proxtpu.prox import make_least_squares as j_least_squares
    from proxtpu.utils.profiling import compiled_stats as j_compiled_stats

    A, b, Lf = _problem(0)

    def j_solve(x0, A, b, Lf):
        return pa.ForwardBackward(tol=1e-6, maxit=200).run(
            x0=x0, f=j_least_squares(A, b), g=JNormL1(0.1), Lf=Lf)

    jargs = (jnp.zeros(N), jnp.asarray(A.numpy()), jnp.asarray(b.numpy()),
             Lf)
    j_flops = j_compiled_stats(j_solve, *jargs)["cost_analysis"]["flops"]
    j_iters = int(j_solve(*jargs)[1])
    f = Counting(make_least_squares(A, b))
    out = compiled_stats(_solve, torch.zeros(N, dtype=torch.float64), f, Lf)
    cost = out["cost_analysis"]
    assert j_flops >= 2 * M * N * 2 and cost["flops"] >= j_flops
    assert f.gradient_count == j_iters
    assert cost["flops"] == j_iters * 2 * (2 * M * N)
    assert cost["bytes accessed"] > 0 and cost["transcendentals"] == 0
    mem = out["memory_analysis"]
    assert mem is not None
    assert mem["argument_size_in_bytes"] == N * 8
    assert mem["output_size_in_bytes"] == N * 8  # the solution; k is an int
    assert mem["peak_size_in_bytes"] is None  # no allocator statistic
    assert out["kernels"] == {}


def test_trace_writes_profile(tmp_path):
    A, b, Lf = _problem(1)
    log_dir = os.path.join(str(tmp_path), "prof")
    with trace(log_dir):
        x, it = _solve(torch.zeros(N, dtype=torch.float64),
                       make_least_squares(A, b), Lf)
    files = [os.path.join(r, f) for r, _, fs in os.walk(log_dir) for f in fs]
    assert files, "trace wrote no profile artifacts"
    traces = [f for f in files if f.endswith(".pt.trace.json")]
    assert traces, files
    with open(traces[0]) as fh:
        events = json.load(fh)["traceEvents"]
    assert any(e.get("name") == "aten::matmul" for e in events)


def _lasso_operands(B, Mk, Nk, dtype=torch.float32, seed=0):
    g = torch.Generator().manual_seed(seed)
    A = torch.randn(B, Mk, Nk, generator=g).to(dtype)
    b = torch.randn(B, Mk, generator=g)
    x = torch.randn(B, Nk, generator=g)
    z = torch.randn(B, Nk, generator=g)
    gamma = torch.full((B,), 0.01)
    return A, b, x, z, gamma, gamma * 0.1, torch.zeros(B)


def _box_operands(B, n, seed=0):
    g = torch.Generator().manual_seed(seed)
    Q = torch.randn(B, n, n, generator=g)
    Q = Q + Q.transpose(1, 2)
    q = torch.randn(B, n, generator=g)
    x = torch.zeros(B, n)
    ones = torch.ones(B)
    return Q, q, x, 0.01 * ones, -ones, ones, torch.zeros(B)


def _tv_operands(B, H, W, seed=0):
    g = torch.Generator().manual_seed(seed)
    b = torch.randn(B, H, W, generator=g)
    z = torch.zeros(B, H, W)
    ones = torch.ones(B)
    return b, z, z.clone(), z.clone(), 0.3 * ones, 0.3 * ones, 0.1 * ones


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _jax_cost(fn, *args, **kwargs):
    """The ``pl.CostEstimate`` of the one ``pallas_call`` that the JAX
    function reaches on these arguments, read from its jaxpr (traced, not
    run), in the keys of ``compiled_stats``."""
    def calls(jaxpr):
        for eqn in jaxpr.eqns:
            if eqn.primitive.name == "pallas_call":
                yield eqn
                continue
            for param in eqn.params.values():
                for sub in (param if isinstance(param, (tuple, list))
                            else (param,)):
                    sub = getattr(sub, "jaxpr", sub)
                    if hasattr(sub, "eqns"):
                        yield from calls(sub)

    (eqn,) = calls(jax.make_jaxpr(lambda *a: fn(*a, **kwargs))(*args).jaxpr)
    ce = eqn.params["cost_estimate"]
    return {"flops": ce.flops, "bytes accessed": ce.bytes_accessed,
            "transcendentals": ce.transcendentals}


# name -> (wrapper call on CPU tensors, JAX's estimate at that shape): the
# JAX wrapper traced on the same operands, in interpret mode.  The packed
# step has the packed kernel's estimate (proxtpu/kernels/lasso.py:1403).
def _case(name):
    B, Mk, Nk, K = 3, 20, 12, 4
    if name in ("fb_step", "fb_step_bf16"):
        dtype = torch.bfloat16 if name == "fb_step_bf16" else torch.float32
        ops = _lasso_operands(B, Mk, Nk, dtype)
        A, b, x, _, gamma, thr, _ = ops
        jA = jnp.asarray(_np(A), jnp.bfloat16 if dtype == torch.bfloat16
                         else jnp.float32)
        return (lambda: tl.fused_fb_prox_grad(A, b, x, gamma, thr),
                _jax_cost(jl.fused_fb_prox_grad, jA,
                          *(jnp.asarray(_np(t)) for t in (b, x, gamma, thr)),
                          interpret=True))
    if name == "fista_step":
        A, b, x, z, gamma, thr, done = _lasso_operands(B, Mk, Nk)
        beta = torch.full((B,), 0.3)
        ops = (A, b, x, z, beta, gamma, thr, done)
        return (lambda: tl.fused_fista_full_step(*ops, restart=True),
                _jax_cost(jl.fused_fista_full_step,
                          *(jnp.asarray(_np(t)) for t in ops),
                          interpret=True, restart=True))
    if name == "fista_packed_step":
        # 4 problems of 20 x 136, two to a packed row of 272 columns
        A, b, x, z, gamma, thr, done = _lasso_operands(4, Mk, 136)
        beta = torch.full((4,), 0.3)
        Ap, bp = tl.pack_lasso_batch(A, b, 2)
        rows = [tl._pack_rows(v, 2, 128) for v in (x, z)]
        lanes = [v.reshape(2, 2) for v in (beta, gamma, thr, done)]
        return (lambda: tl.fused_fista_packed_step(Ap, bp, *rows, *lanes,
                                                   136, 2, restart=True),
                _jax_cost(jl.fused_fista_packed_step,
                          *(jnp.asarray(_np(t)) for t in (Ap, bp, *rows,
                                                          *lanes)),
                          N=136, pack=2, interpret=True, restart=True))
    if name == "fista_k_steps":
        A, b, x, z, gamma, thr, done = _lasso_operands(B, Mk, Nk)
        ops = (A, b, x, z, torch.ones(B), gamma, thr, done)
        return (lambda: tl.fused_fista_k_steps(*ops, K=K),
                _jax_cost(jl.fused_fista_k_steps,
                          *(jnp.asarray(_np(t)) for t in ops), K=K,
                          interpret=True))
    if name == "pg_step":
        Q, q, x, gamma, lo, hi, _ = _box_operands(B, Nk)
        ops = (Q, q, x, gamma, lo, hi)
        return (lambda: tb.fused_pg_box_step(*ops),
                _jax_cost(jb.fused_pg_box_step,
                          *(jnp.asarray(_np(t)) for t in ops),
                          interpret=True))
    if name == "pg_k_steps":
        ops = _box_operands(B, Nk)
        return (lambda: tb.fused_pg_box_k_steps(*ops, K),
                _jax_cost(jb.fused_pg_box_k_steps,
                          *(jnp.asarray(_np(t)) for t in ops), K=K,
                          interpret=True))
    if name == "cp_k_steps":
        ops = _tv_operands(B, 9, 7)
        return (lambda: tv.fused_cp_k_steps(*ops, K=K),
                _jax_cost(jt.fused_cp_k_steps,
                          *(jnp.asarray(_np(t)) for t in ops), K=K,
                          interpret=True))
    if name in ("read_reduce", "read_reduce_bf16"):
        # the JAX probe sizes its bytes by A's dtype, as the port's does
        bf16 = name == "read_reduce_bf16"
        A = _lasso_operands(B, Mk, Nk,
                            torch.bfloat16 if bf16 else torch.float32)[0]
        jA = jnp.asarray(_np(A), jnp.bfloat16 if bf16 else jnp.float32)
        return (lambda: probe.read_reduce(A),
                _jax_cost(_trip_overhead_bench().dma_floor_loop, jA,
                          trips=1))
    raise KeyError(name)


def _trip_overhead_bench():
    """``benchmarks/trip_overhead_bench.py``, whose ``dma_floor_loop``
    holds the TPU read-floor kernel (imported, not run)."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "benchmarks", "trip_overhead_bench.py")
    spec = importlib.util.spec_from_file_location("trip_overhead_bench", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("name", [
    "fb_step", "fb_step_bf16", "fista_step", "fista_packed_step",
    "fista_k_steps", "pg_step",
    "pg_k_steps", "cp_k_steps", "read_reduce", "read_reduce_bf16"])
def test_kernel_cost_on_the_plain_route(name):
    call, want = _case(name)
    out = compiled_stats(call)
    # the plain version's own ATen operations are not counted again
    assert out["cost_analysis"] == want
    kernel = name.replace("_bf16", "")
    assert out["kernels"] == {kernel: dict(launches=1, **want)}


def test_main_path_cost_is_the_kernels():
    """``solve_lasso_batch_packed_tail`` on the plain route: every flop is
    a kernel wrapper's (the host loop does no product), one entry a
    wrapper call at the batch width of that call, and the solve's bits
    are those of a run without ``compiled_stats``."""
    import bench
    from proxtpu_torch import problems_from_numpy

    As, bs, _, _ = bench.gen_problems(12)
    As, bs = As[:, :20, :40].copy(), bs[:, :20].copy()
    lams = 0.1 * np.abs(np.einsum("bmn,bm->bn", As, bs)).max(axis=1)
    Lfs = np.array([np.linalg.norm(a, 2) ** 2 for a in As])
    A, b, lam, Lf = problems_from_numpy(As, bs, lams, Lfs, device="cpu")
    # 3 lanes are left after k1 = 100: the narrow phase runs at tail = 4
    kw = dict(maxit=400, k1=100, tail=4, restart=True)
    want = tl.solve_lasso_batch_packed_tail(A, b, lam, Lf, 1e-5, **kw)
    before = (tl.fused_fb_prox_grad.launches,
              tl.fused_fista_full_step.launches)
    out = compiled_stats(tl.solve_lasso_batch_packed_tail, A, b, lam, Lf,
                         1e-5, **kw)
    # the plain route launches nothing
    assert (tl.fused_fb_prox_grad.launches,
            tl.fused_fista_full_step.launches) == before
    kernels = out["kernels"]
    n_f = kernels["fista_step"]["launches"]
    n_fb = kernels["fb_step"]["launches"]
    assert n_fb == 1 and n_f > 100
    # phase 1: 100 fista_step calls at B = 12; phase 2: fb_step, then
    # fista_step, at tail = 4; each call at JAX's estimate for its width
    def jax_fista(B):
        return _jax_cost(jl.fused_fista_full_step,
                         *(jnp.zeros(s, jnp.float32) for s in (
                             (B, 20, 40), (B, 20), (B, 40), (B, 40), (B,),
                             (B,), (B,), (B,))), interpret=True, restart=True)

    wide, narrow = jax_fista(12), jax_fista(4)
    fb = _jax_cost(jl.fused_fb_prox_grad,
                   *(jnp.zeros(s, jnp.float32) for s in (
                       (4, 20, 40), (4, 20), (4, 40), (4,), (4,))),
                   interpret=True)
    for key in ("flops", "bytes accessed", "transcendentals"):
        assert kernels["fista_step"][key] == (
            100 * wide[key] + (n_f - 100) * narrow[key]), key
        assert kernels["fb_step"][key] == fb[key], key
    assert out["cost_analysis"]["flops"] == (kernels["fista_step"]["flops"]
                                             + kernels["fb_step"]["flops"])
    got = tl.solve_lasso_batch_packed_tail(A, b, lam, Lf, 1e-5, **kw)
    assert all(torch.equal(u, v) for u, v in zip(got, want))
