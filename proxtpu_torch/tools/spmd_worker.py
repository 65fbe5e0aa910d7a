"""Run named cases of the sharding layer on N ranks of one process group.

    python -m proxtpu_torch.tools.spmd_worker --ranks 4 --backend gloo \\
        --device cpu --cases cpu --out DIR

starts N processes (rank r on ``cuda:r``, or on ``cuda:0`` where the ranks
share one card; one thread each on the CPU), brings up a process group of
the named backend over a ``tcp://localhost`` store, runs the cases in
order on every rank and writes each case's gathered outputs from rank 0 to
``DIR/spmd.npz`` (keys ``case__name``).  A rank that fails, or a run past
``--timeout`` seconds, stops every rank and exits non-zero.  With
``--device cuda`` the kernels are built before the ranks start.

Each data-parallel case asserts that its gathered per-lane outputs are
``torch.equal`` to the unsharded solve of the same lanes, and that no
collective ran inside the sharded solve (``torch.distributed``'s
collectives and the port's collective helper are counted).  The dp x tp
cases (one ``Shared`` operand in row stripes over ``tp``, lanes over
``dp``) assert instead one all-reduce over ``tp`` at init and at every
step run, none over ``dp``, and bit-equal solutions on the ranks of a tp
group.  The data generators are numpy only, so a test can feed the JAX
package the same inputs.

``--cases cpu`` runs the counterparts of the JAX package's sharding tests
(``tests/test_sharding.py``, ``tests/test_multiprocess.py``) and
``dryrun_multichip``; ``--cases card`` runs the flagship lanes through
``sharded_solve_lasso_batch_packed``, a row-sharded PANOC and a consensus
with a block a rank, each against its run on one rank.  ``--cases
shared_tp`` (four ranks) runs ``benchmarks/scaling.py --path shared_tp``
at full width and times it.  ``--cases tp`` (four ranks) runs the tp
layout on the shared-A solver, the flat machines, DRLS and Douglas-Rachford
on the JAX dp x tp test's problem (``multirhs_tp``, ``flat_tp``,
``drls_tp``: the design's all-reduces a step or trip, tp ranks bit-equal,
the bits of the stripes emulated in one process); ``--cases tp_legs`` runs
them at ``shared_tp``'s width and times them.  ``--cases scaling`` runs
``docs/tpu_scaling.md``'s blocks 5 and 6 and the dry run
(``examples/scaling_guide.py``; its block 12 starts the ranks).
"""

from __future__ import annotations

import argparse
import contextlib
import os
import socket
import subprocess
import sys
import time

import numpy as np
import torch

from ..prox.base import proxclass
from .problems import lasso_problems

# ---------------------------------------------------------------------------
# data (numpy, seeded as the JAX package's tests)


def big_lasso(seed=0, m=64, n=48):
    """``tests/test_sharding.py::big_lasso``: float64 A, b, lam, Lf."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n))
    b = rng.standard_normal(m)
    lam = 0.1 * float(np.max(np.abs(A.T @ b)))
    Lf = float(np.linalg.norm(A, 2) ** 2)
    return A, b, lam, Lf


def lasso_batch(B=16, M=16, N=24, seed=3, dtype=np.float32):
    """``tests/test_sharding.py::_lasso_batch``."""
    return lasso_problems(B, M, N, dtype, seed)


def dp_problems():
    """``test_dp_sharded_batch_solve``'s 16 float64 lassos."""
    out = []
    for k in range(16):
        rng = np.random.default_rng(k)
        A = rng.standard_normal((8, 12))
        b = rng.standard_normal(8)
        lam = 0.1 * float(np.max(np.abs(A.T @ b)))
        out.append((A, b, lam, float(np.linalg.norm(A, 2) ** 2)))
    return out


def global_mesh_batch():
    """``test_global_mesh_runs_sharded_solve``'s float32 batch."""
    rng = np.random.default_rng(0)
    B, M, N = 8, 16, 24
    A = (rng.standard_normal((B, M, N)) / 4).astype(np.float32)
    b = rng.standard_normal((B, M)).astype(np.float32)
    lam = (0.1 * np.max(np.abs(np.einsum("bmn,bm->bn", A, b)), axis=1)
           ).astype(np.float32)
    Lf = np.asarray([np.linalg.norm(A[i], 2) ** 2 for i in range(B)],
                    np.float32)
    return A, b, lam, Lf


def multirhs_data():
    rng = np.random.default_rng(5)
    M, N, B = 24, 32, 16
    A = (rng.standard_normal((M, N)) / np.sqrt(M)).astype(np.float32)
    Bmat = rng.standard_normal((B, M)).astype(np.float32)
    lam = (0.1 * np.max(np.abs(Bmat @ A), axis=1)).astype(np.float32)
    return A, Bmat, lam, float(np.linalg.norm(A, 2) ** 2)


def box_qp_data():
    rng = np.random.default_rng(6)
    n, B = 16, 16
    Qs, qs, Lips = [], [], []
    for _ in range(B):
        U, _ = np.linalg.qr(rng.standard_normal((n, n)))
        ev = 2 * rng.random(n) - 1
        Q0 = (U @ np.diag(ev) @ U.T).astype(np.float32)
        Qs.append(0.5 * (Q0 + Q0.T))
        qs.append(rng.standard_normal(n).astype(np.float32))
        Lips.append(np.max(np.abs(ev)))
    return np.stack(Qs), np.stack(qs), np.array(Lips, np.float32)


def restart_data():
    return lasso_problems(16, 12, 20, seed=7)


def tv_data():
    rng = np.random.default_rng(6)
    B, H, W = 8, 16, 16
    b = rng.standard_normal((B, H, W)).astype(np.float32)
    lam = (0.05 + 0.2 * rng.random(B)).astype(np.float32)
    return b, lam


def shared_operand_data():
    rng = np.random.default_rng(7)
    B, M, N = 16, 24, 32
    A = (rng.standard_normal((M, N)) / np.sqrt(M)).astype(np.float32)
    b = rng.standard_normal(M).astype(np.float32)
    lam = (0.1 + 0.2 * rng.random(B)).astype(np.float32)
    return A, b, lam, float(np.linalg.norm(A, 2) ** 2)


def flat_data():
    rng = np.random.default_rng(21)
    B, M, N = 16, 24, 40
    A = rng.standard_normal((B, M, N)) / np.sqrt(M)
    b = rng.standard_normal((B, M))
    lam = 0.1 * np.max(np.abs(np.einsum("bmn,bm->bn", A, b)), axis=1)
    Lf = np.asarray([float(np.linalg.norm(A[i], 2) ** 2) for i in range(B)])
    return A, b, lam, Lf


def multiprocess_batch():
    """``tests/multiprocess_worker.py``'s batch (2 processes x 4 devices:
    16 lanes of 12 x 20, float32)."""
    return lasso_problems(16, 12, 20, seed=11)


def dp_x_tp_data(dtype=np.float32, M=24):
    """``tests/test_sharding.py::test_generic_driver_shared_operand_dp_x_tp
    _sharded``'s problem: one A (24, 32) and b, 16 lanes of lam, seed 11;
    ``Lf`` a number.  ``M=48``: a tall A (48, 32) from the same seed, on
    which the least squares' prox factors ``A^H A`` (N x N)."""
    rng = np.random.default_rng(11)
    B, N = 16, 32
    A = (rng.standard_normal((M, N)) / np.sqrt(M)).astype(dtype)
    b = rng.standard_normal(M).astype(dtype)
    lam = (0.1 + 0.2 * rng.random(B)).astype(dtype)
    return A, b, lam, float(np.linalg.norm(A, 2) ** 2)


def shared_tp_data(lanes):
    """``benchmarks/scaling.py --path shared_tp``'s problem at ``lanes``
    lanes: ``A = As[0]`` (200 x 400), ``b = bs[0]``, the lanes' ``lams`` and
    the scalar ``Lf`` of ``As[0]``, float32."""
    As, bs, lams, _ = lasso_problems(lanes)
    return As[0], bs[0], lams, float(np.linalg.norm(As[0], 2) ** 2)


def rows_problem(ranks):
    """``dryrun_multichip``'s tp problem at ``ranks`` row stripes: A
    (256 ranks, 96), float32."""
    rng = np.random.default_rng(0)
    m, n = 256 * ranks, 96
    A = (rng.standard_normal((m, n)) / np.sqrt(m)).astype(np.float32)
    b = rng.standard_normal(m).astype(np.float32)
    return A, b, float(np.linalg.norm(A, 2) ** 2)


def consensus_blocks(ranks):
    """``dryrun_multichip``'s consensus blocks: ``ranks`` blocks of 32 x
    96, float32."""
    rng = np.random.default_rng(1)
    return [(rng.standard_normal((32, 96)).astype(np.float32),
             rng.standard_normal(32).astype(np.float32))
            for _ in range(ranks)]


# the card's sizes and tolerances for the row-sharded PANOC and the
# consensus (chip_smoke.py's route (w) runs the same on one rank)
ROWS_TOL, ROWS_MAXIT = 1e-5, 1000
CONSENSUS_TOL, CONSENSUS_MAXIT = 1e-4, 5000
FLAGSHIP_TOL, FLAGSHIP_MAXIT = 1e-5, 2000
# benchmarks/scaling.py --path shared_tp: 64 lanes a device, tol, maxit,
# the host's test every 8 steps; timed solves after one warm-up
SHARED_TP_LANES, SHARED_TP_TOL, SHARED_TP_MAXIT = 256, 1e-5, 2000
SHARED_TP_K, SHARED_TP_REPEAT = 8, 2


# ---------------------------------------------------------------------------
# counting collectives

_DIST_COLLECTIVES = (
    "all_reduce", "all_gather", "all_gather_into_tensor", "all_to_all",
    "all_to_all_single", "broadcast", "reduce", "reduce_scatter",
    "reduce_scatter_tensor", "gather", "scatter", "barrier", "send",
    "recv", "isend", "irecv", "all_gather_object", "broadcast_object_list")


@contextlib.contextmanager
def no_collectives(what):
    """Fail unless the block runs no collective: every collective of
    ``torch.distributed`` is wrapped with a counter for the block, and the
    port's collective helper keeps its own count."""
    import torch.distributed as dist

    from ..parallel.sharded_ops import COLLECTIVES

    calls = []
    saved = {n: getattr(dist, n) for n in _DIST_COLLECTIVES
             if hasattr(dist, n)}

    def counting(name, fn):
        def run(*args, **kwargs):
            calls.append(name)
            return fn(*args, **kwargs)
        return run

    before = sum(COLLECTIVES.values())
    for n, fn in saved.items():
        setattr(dist, n, counting(n, fn))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(dist, n, fn)
    helper = sum(COLLECTIVES.values()) - before
    assert not calls and not helper, (
        f"{what}: collectives inside the sharded solve: {calls}, "
        f"{helper} by the helper")


@contextlib.contextmanager
def groups_reduced():
    """The process group of every ``torch.distributed.all_reduce`` the
    block runs, in a list (the port's collective helper reaches
    ``torch.distributed`` through this attribute)."""
    import torch.distributed as dist

    groups, saved = [], dist.all_reduce

    def counting(tensor, *args, group=None, **kwargs):
        groups.append(group)
        return saved(tensor, *args, group=group, **kwargs)

    dist.all_reduce = counting
    try:
        yield groups
    finally:
        dist.all_reduce = saved


def steps_run(iters, check_every, maxit):
    """The steps the generic driver runs on lanes whose counts are
    ``iters``: blocks of ``check_every`` until the host finds every lane
    done after the last one stopped, or ``maxit``."""
    last = int(iters.max())
    return min(maxit - 1, check_every * -(-(last - 1) // check_every))


# ---------------------------------------------------------------------------
# the cases

CASES = {}
CPU_CASES = ("operator", "panoc", "consensus", "dp_batch", "global_mesh",
             "lasso_kernel", "blocked", "multirhs", "box_qp",
             "restart_warm", "tv", "shared_operand", "flat", "packed",
             "errors", "multiprocess", "dp_x_tp", "dryrun")
# the tp legs on the CPU (tests/test_torch_tp_legs.py runs them alone)
TP_CASES = ("multirhs_tp", "flat_tp", "drls_tp")
CARD_CASES = ("flagship", "rows_panoc", "blocks_consensus")
# docs/tpu_scaling.md's blocks 5, 6 and 12 (examples/scaling_guide.py);
# block 6 in eight blocks, one a device of the JAX tests' mesh
SCALING_CASES = ("scaling_panoc", "scaling_consensus", "dryrun")
SCALING_BLOCKS = 8


def case(fn):
    CASES[fn.__name__] = fn
    return fn


class Context:
    """A rank's view: its rank, the world, its device and the meshes the
    cases build (built once, in the same order on every rank)."""

    def __init__(self, rank, world, device_type, device):
        self.rank, self.world = rank, world
        self.device_type, self.device = device_type, device
        self._meshes = {}

    def mesh(self, shape, names):
        from ..parallel import make_mesh

        key = (tuple(shape), tuple(names))
        if key not in self._meshes:
            self._meshes[key] = make_mesh(shape, names, self.device_type)
        return self._meshes[key]

    def dp(self):
        return self.mesh((self.world,), ("dp",))

    def tp(self):
        return self.mesh((self.world,), ("tp",))

    def dp_tp(self):
        """The ``("dp", "tp")`` mesh of the dp x tp composition: tp = 2
        where the world is even, the rest over dp."""
        tp = 2 if self.world % 2 == 0 else 1
        return self.mesh((self.world // tp, tp), ("dp", "tp"))

    def t(self, v):
        return torch.as_tensor(np.asarray(v), device=self.device)


def _np(x):
    from ..parallel.sharded_ops import full_tensor

    return full_tensor(x).detach().cpu().numpy()


def _equal_lanes(what, got, want):
    """Gathered sharded outputs against the unsharded solve, bit for
    bit."""
    from ..parallel.sharded_ops import full_tensor

    for i, (g, w) in enumerate(zip(got, want)):
        g = full_tensor(g)
        assert torch.equal(g, w), (
            f"{what}: output {i} differs from the unsharded solve "
            f"(max {float((g.double() - w.double()).abs().max()):.3e})")


def _lasso_outputs(z, it, d):
    return {"z": _np(z), "it": _np(it), "done": _np(d)}


@case
def operator(ctx):
    from ..parallel import shard_matrix_operator

    A, b, _, _ = big_lasso()
    op = shard_matrix_operator(ctx.t(A), ctx.tp(), row_axis="tp")
    x = ctx.t(np.random.default_rng(1).standard_normal(A.shape[1]))
    y = ctx.t(np.random.default_rng(2).standard_normal(A.shape[0]))
    Ax, Aty = op.matvec(x), op.rmatvec(y)
    # A is distributed: each rank holds a stripe of the rows
    assert op.A.to_local().shape == (A.shape[0] // ctx.world, A.shape[1])
    np.testing.assert_allclose(Ax.cpu().numpy(), A @ x.cpu().numpy())
    np.testing.assert_allclose(Aty.cpu().numpy(), A.T @ y.cpu().numpy())
    return {"Ax": Ax.cpu().numpy(), "Aty": Aty.cpu().numpy()}


@case
def panoc(ctx):
    from .. import PANOC
    from ..parallel import replicate, shard_matrix_operator
    from ..prox import NormL1, SqrNormL2, Translate

    A, b, lam, Lf = big_lasso()
    mesh = ctx.tp()
    x0 = torch.zeros(A.shape[1], dtype=torch.float64, device=ctx.device)
    fo = Translate(SqrNormL2(1.0), replicate(-ctx.t(b), mesh))
    op = shard_matrix_operator(ctx.t(A), mesh, row_axis="tp")
    x_s, it_s = PANOC(tol=1e-6)(x0=replicate(x0, mesh), f=fo, A=op,
                                g=NormL1(lam), Lf=Lf)
    x_d, it_d = PANOC(tol=1e-6)(x0=x0, f=Translate(SqrNormL2(1.0),
                                                   -ctx.t(b)),
                                A=ctx.t(A), g=NormL1(lam), Lf=Lf)
    assert it_s == it_d, (it_s, it_d)
    np.testing.assert_allclose(x_s.cpu().numpy(), x_d.cpu().numpy(),
                               atol=1e-10)
    return {"x": x_s.cpu().numpy(), "it": np.asarray(it_s)}


@case
def consensus(ctx):
    from ..parallel import ConsensusADMM, shard_batch, stack_functions
    from ..prox import NormL1, make_least_squares

    A, b, lam, _ = big_lasso(m=64, n=16)
    blocks = [make_least_squares(ctx.t(A[i * 8:(i + 1) * 8]),
                                 ctx.t(b[i * 8:(i + 1) * 8]))
              for i in range(8)]
    fs = stack_functions(blocks)
    solver = ConsensusADMM(tol=1e-7, maxit=20_000)
    x0 = torch.zeros(16, dtype=torch.float64, device=ctx.device)
    x_s, it_s = solver(x0=x0, fs=shard_batch(fs, ctx.tp(), "tp"),
                       g=NormL1(lam), gamma=1.0)
    x_d, it_d = solver(x0=x0, fs=fs, g=NormL1(lam), gamma=1.0)
    assert it_s == it_d, (it_s, it_d)
    np.testing.assert_allclose(x_s.cpu().numpy(), x_d.cpu().numpy(),
                               atol=1e-12)
    return {"x": x_s.cpu().numpy(), "it": np.asarray(it_s)}


@case
def dp_batch(ctx):
    from ..algorithms import make_fast_forward_backward_iteration
    from ..parallel import batch_problems, batched_run_loop, shard_batch
    from ..prox import NormL1, make_least_squares

    f64 = lambda v: torch.as_tensor(v, dtype=torch.float64,  # noqa: E731
                                    device=ctx.device)
    problems = [dict(x0=f64(np.zeros(12)),
                     f=make_least_squares(f64(A), f64(b)),
                     g=NormL1(f64(lam)), Lf=f64(Lf))
                for A, b, lam, Lf in dp_problems()]
    iteration = batch_problems(make_fast_forward_backward_iteration,
                               problems)
    plain = batched_run_loop(iteration, 2000, 1e-6)
    placed = shard_batch(iteration, ctx.tp(), "tp")
    with no_collectives("dp_batch"):
        xs, iters, done = batched_run_loop(placed, 2000, 1e-6)
    _equal_lanes("dp_batch", (xs, iters, done), plain)
    return {"xs": _np(xs), "iters": _np(iters)}


@case
def global_mesh(ctx):
    from ..kernels.lasso import solve_lasso_batch
    from ..parallel import global_mesh as make_global, shard_batch

    mesh = make_global((2, ctx.world // 2), ("dp", "tp"),
                       device_type=ctx.device_type)
    assert tuple(mesh.shape) == (2, ctx.world // 2)
    args = [ctx.t(v) for v in global_mesh_batch()]
    ref = solve_lasso_batch(*args, 1e-5, maxit=3000, use_kernel=False)
    placed = shard_batch(tuple(args), mesh, "dp")
    with no_collectives("global_mesh"):
        out = solve_lasso_batch(*placed, 1e-5, maxit=3000,
                                use_kernel=False)
    _equal_lanes("global_mesh", out, ref)
    return _lasso_outputs(*out)


def _kernel_case(ctx, name, sharded, plain, args, **kw):
    ref = plain(*args, **kw)
    with no_collectives(name):
        out = sharded(*args, mesh=ctx.dp(), **kw)
    _equal_lanes(name, out, ref)
    assert all(len(_np(v)) == len(ref[0]) for v in out)
    return _lasso_outputs(*out)


@case
def lasso_kernel(ctx):
    from ..kernels.lasso import solve_lasso_batch
    from ..parallel import sharded_solve_lasso_batch

    args = [ctx.t(v) for v in lasso_batch()] + [1e-5]
    return _kernel_case(ctx, "lasso_kernel", sharded_solve_lasso_batch,
                        solve_lasso_batch, args, maxit=3000,
                        use_kernel=True)


@case
def blocked(ctx):
    from ..kernels.lasso import solve_lasso_batch, solve_lasso_batch_blocked
    from ..parallel import sharded_solve_lasso_batch_blocked

    args = [ctx.t(v) for v in lasso_batch(seed=4)] + [1e-5]
    out = _kernel_case(ctx, "blocked", sharded_solve_lasso_batch_blocked,
                       solve_lasso_batch_blocked, args, maxit=3000,
                       iter_block=4)
    # the one-step counts, of which the blocked ones are upper bounds
    out["it_one"] = solve_lasso_batch(*args, maxit=3000)[1].cpu().numpy()
    return out


@case
def multirhs(ctx):
    from ..kernels.lasso import solve_lasso_multirhs
    from ..parallel import sharded_solve_lasso_multirhs

    A, Bmat, lam, Lf = multirhs_data()
    args = [ctx.t(A), ctx.t(Bmat), ctx.t(lam), Lf, 1e-5]
    return _kernel_case(ctx, "multirhs", sharded_solve_lasso_multirhs,
                        solve_lasso_multirhs, args, maxit=3000)


@case
def box_qp(ctx):
    from ..kernels.box_qp import solve_box_qp_batch
    from ..parallel import sharded_solve_box_qp_batch

    Q, q, Lip = box_qp_data()
    args = [ctx.t(Q), ctx.t(q), -1.0, 1.0, ctx.t(Lip), 1e-4]
    return _kernel_case(ctx, "box_qp", sharded_solve_box_qp_batch,
                        solve_box_qp_batch, args, maxit=20_000,
                        use_kernel=True)


@case
def restart_warm(ctx):
    from ..kernels.lasso import solve_lasso_batch, solve_lasso_multirhs
    from ..parallel import (
        sharded_solve_lasso_batch,
        sharded_solve_lasso_multirhs,
    )

    A, b, lam, Lf = (ctx.t(v) for v in restart_data())
    out = _kernel_case(ctx, "restart", sharded_solve_lasso_batch,
                       solve_lasso_batch, [A, b, lam, Lf, 1e-5],
                       maxit=3000, use_kernel=False, restart=True)
    # warm start from the solution: every lane finishes at once
    z = ctx.t(out["z"])
    warm = _kernel_case(ctx, "warm", sharded_solve_lasso_batch,
                        solve_lasso_batch, [A, b, lam, Lf, 1e-5],
                        maxit=3000, use_kernel=False, x0=z)
    multi = _kernel_case(ctx, "multirhs restart",
                         sharded_solve_lasso_multirhs, solve_lasso_multirhs,
                         [A[0], b, lam, float(Lf[0]), 1e-5], maxit=3000,
                         restart=True)
    out.update({k + "_warm": v for k, v in warm.items()})
    out.update({k + "_multi": v for k, v in multi.items()})
    return out


@case
def tv(ctx):
    from ..kernels.tv import solve_tv_batch
    from ..parallel import sharded_solve_tv_batch

    b, lam = tv_data()
    return _kernel_case(ctx, "tv", sharded_solve_tv_batch, solve_tv_batch,
                        [ctx.t(b), ctx.t(lam), 1e-3], maxit=4000,
                        iter_block=4, use_kernel=True)


@case
def shared_operand(ctx):
    from ..algorithms import make_fast_forward_backward_iteration
    from ..parallel import (
        Shared,
        batched_run_loop,
        broadcast_hyperparams,
        shard_batch,
    )
    from ..prox import LeastSquaresLoss, NormL1

    A, b, lam, Lf = shared_operand_data()
    B, N = lam.shape[0], A.shape[1]
    iteration = broadcast_hyperparams(make_fast_forward_backward_iteration(
        x0=torch.zeros((B, N), dtype=torch.float32, device=ctx.device),
        f=Shared(LeastSquaresLoss(ctx.t(A), ctx.t(b))), g=NormL1(ctx.t(lam)),
        Lf=torch.full((B,), Lf, dtype=torch.float32, device=ctx.device)))
    ref = batched_run_loop(iteration, 3000, 1e-5)
    placed = shard_batch(iteration, ctx.dp(), "dp")
    with no_collectives("shared_operand"):
        out = batched_run_loop(placed, 3000, 1e-5)
    _equal_lanes("shared_operand", out, ref)
    return _lasso_outputs(*out)


def dp_x_tp_iteration(A, b, lam, Lf, device):
    """FISTA on one ``Shared(LeastSquaresLoss(A, b))`` with a lam per lane,
    the scalar step ``1 / Lf`` and ``x0 = 0``, unplaced (the JAX
    package's dp x tp test and ``benchmarks/scaling.py --path
    shared_tp``)."""
    from ..algorithms import make_fast_forward_backward_iteration
    from ..parallel import Shared
    from ..prox import LeastSquaresLoss, NormL1

    t = lambda v: torch.as_tensor(v, device=device)  # noqa: E731
    return make_fast_forward_backward_iteration(
        x0=torch.zeros((len(lam), A.shape[1]), dtype=t(A).dtype,
                       device=device),
        f=Shared(LeastSquaresLoss(t(A), t(b))), g=NormL1(t(lam)), Lf=Lf)


@proxclass(meta_fields=("parts",))
class EmulatedStripes:
    """``lam/2 ||A x - b||^2`` as ``RowShardedLeastSquaresLoss`` computes
    it over a tp group of ``parts`` ranks, in one process: each stripe's
    ``A_i^H r_i`` and ``||r_i||^2`` in one buffer, the buffers summed in
    rank order (two ranks' sum has the same bits in either order) and
    laid out as the collective returns them (``lanes_last``)."""

    A: object
    b: object
    parts: int

    is_convex = True
    is_generalized_quadratic = True

    def __call__(self, x):
        return self.value_and_gradient(x)[0]

    def value_and_gradient(self, x):
        from ..parallel.sharded_ops import lanes_last
        from ..prox.functions import _rparam, _vdot_real
        from ..utils.precision import pdot

        total = None
        for A, b in zip(self.A.chunk(self.parts), self.b.chunk(self.parts)):
            r = pdot(A, x) - b
            grad = pdot(A.mH, r)
            part = torch.cat([grad.reshape(-1),
                              _vdot_real(r, r).to(grad.dtype).reshape(1)])
            total = part if total is None else total + part
        total = lanes_last(total)
        lam = _rparam(1.0, x)
        return (lam / 2 * torch.real(total[-1]),
                lam * total[:-1].reshape(grad.shape))


def emulated_dp_x_tp(A, b, lam, Lf, device, mesh_shape, maxit, tol,
                     check_every):
    """The dp x tp solve of ``mesh_shape = (dp, tp)`` emulated in one
    process, one dp block of lanes at a time at a rank's batch: the bits
    the placed solve must give.  Returns ``(z, iters, done)``."""
    from ..algorithms import make_fast_forward_backward_iteration
    from ..parallel import Shared, batched_run_loop
    from ..prox import NormL1

    dp, tp = mesh_shape
    t = lambda v: torch.as_tensor(v, device=device)  # noqa: E731
    f = Shared(EmulatedStripes(t(A), t(b), tp))
    outs = [batched_run_loop(make_fast_forward_backward_iteration(
        x0=torch.zeros((len(block), A.shape[1]), dtype=t(A).dtype,
                       device=device), f=f, g=NormL1(t(block)), Lf=Lf),
        maxit, tol, check_every=check_every)
        for block in np.split(lam, dp)]
    return tuple(torch.cat(parts) for parts in zip(*outs))


def dp_x_tp_solve(mesh, iteration, maxit, tol, check_every):
    """``batched_run_loop`` on ``iteration`` with its Shared operand in row
    stripes over ``tp`` and its lanes over ``dp``.  Asserts the design's
    collectives (one all-reduce at init and one at every step run, each
    over tp, so none over dp) and that the ranks of a tp group end with
    the same bits.  Returns ``(outputs, seconds, all-reduces)``."""
    from ..parallel import batched_run_loop, shard_batch
    from ..parallel.sharded_ops import COLLECTIVES, all_gather, shard_rows

    placed = shard_batch(shard_rows(iteration, mesh, "tp"), mesh, "dp")
    device = iteration.x0.device
    before = COLLECTIVES["all_reduce"]
    with groups_reduced() as groups:
        t0 = time.perf_counter()
        out = batched_run_loop(placed, maxit, tol, check_every=check_every)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
    helper = COLLECTIVES["all_reduce"] - before
    want = 1 + steps_run(out[1].to_local(), check_every, maxit)
    tp_group = mesh.get_group("tp")
    assert helper == want == len(groups), (helper, want, len(groups))
    assert all(g is tp_group for g in groups), "an all-reduce not over tp"
    x = out[0].to_local()
    both = all_gather(x[None], tp_group)
    assert all(torch.equal(both[0], xr) for xr in both[1:]), (
        "the ranks of a tp group hold different solutions")
    return out, wall, helper


@case
def dp_x_tp(ctx):
    """The JAX package's dp x tp test on a (2, 2) mesh in float32 and
    float64, through ``batched_run_loop`` and ``BatchedAlgorithm``'s
    generic driver (``use_kernels=False``; the same bits), held against the
    port's unplaced run under the JAX test's contract (the test holds both
    against the JAX package).  ``BatchedAlgorithm``'s default route on it
    is the shared-A leg: case ``multirhs_tp``."""
    from ..algorithms import make_fast_forward_backward_iteration
    from ..parallel import (
        BatchedAlgorithm,
        Shared,
        batched_run_loop,
        shard_batch,
    )
    from ..parallel.sharded_ops import full_tensor, shard_rows
    from ..prox import LeastSquaresLoss, NormL1

    mesh = ctx.dp_tp()
    out = {}
    for dtype in (np.float32, np.float64):
        A, b, lam, Lf = dp_x_tp_data(dtype)
        it = dp_x_tp_iteration(A, b, lam, Lf, ctx.device)
        got = dp_x_tp_solve(mesh, it, 3000, 1e-5, 1)[0]
        placed = BatchedAlgorithm(
            make_fast_forward_backward_iteration, maxit=3000, tol=1e-5,
            use_kernels=False)(
            x0=shard_batch(it.x0, mesh, "dp"),
            f=shard_rows(Shared(LeastSquaresLoss(ctx.t(A), ctx.t(b))), mesh,
                         "tp"),
            g=NormL1(shard_batch(ctx.t(lam), mesh, "dp")), Lf=Lf)
        _equal_lanes("dp_x_tp BatchedAlgorithm", placed,
                     [full_tensor(v) for v in got])
        _equal_lanes("dp_x_tp, the stripes emulated in one process", got,
                     emulated_dp_x_tp(A, b, lam, Lf, ctx.device,
                                      tuple(mesh.shape), 3000, 1e-5, 1))
        z, k, done = (full_tensor(v) for v in got)
        zp, kp, _ = batched_run_loop(it, 3000, 1e-5)
        assert bool(done.all()), "dp_x_tp: lanes left"
        assert float((k == kp).double().mean()) >= 0.75, (k, kp)
        assert float((z - zp).abs().max()) <= 1e-3
        name = np.dtype(dtype).name
        out.update({f"{key}_{name}": v for key, v in
                    _lasso_outputs(z, k, done).items()})
    return out


@case
def shared_tp(ctx):
    """``benchmarks/scaling.py --path shared_tp`` at full width: 256 lanes
    over dp, ``A = As[0]`` (200 x 400) in row stripes over tp, one warm-up
    solve, then ``SHARED_TP_REPEAT`` timed ones, each rank's wall and the
    wall from barrier to barrier, and the time of one all-reduce of the
    step's buffer over tp."""
    import torch.distributed as dist

    from ..parallel.sharded_ops import all_reduce, full_tensor

    mesh = ctx.dp_tp()
    A, b, lam, Lf = shared_tp_data(SHARED_TP_LANES)
    it = dp_x_tp_iteration(A, b, lam, Lf, ctx.device)
    args = (mesh, it, SHARED_TP_MAXIT, SHARED_TP_TOL, SHARED_TP_K)
    dp_x_tp_solve(*args)  # warm-up
    walls, both = [], []
    for _ in range(SHARED_TP_REPEAT):
        dist.barrier()
        t0 = time.perf_counter()
        out, wall, reduces = dp_x_tp_solve(*args)
        dist.barrier()
        walls.append(wall)
        both.append(time.perf_counter() - t0)
    # one all-reduce of the step's buffer (a lane's N + 1 entries)
    buf = torch.zeros((out[0].to_local().shape[0], A.shape[1] + 1),
                      dtype=torch.float32, device=ctx.device)
    tp_group = mesh.get_group("tp")
    all_reduce(buf, tp_group)
    _sync(ctx)
    reps = 50
    t0 = time.perf_counter()
    for _ in range(reps):
        all_reduce(buf, tp_group)
    _sync(ctx)
    reduce_us = 1e6 * (time.perf_counter() - t0) / reps
    it_local = out[1].to_local()
    steps = steps_run(it_local, SHARED_TP_K, SHARED_TP_MAXIT)
    print(f"rank {ctx.rank}: shared_tp {it_local.shape[0]} lanes, walls "
          f"{', '.join(f'{w:.4f}' for w in walls)} s, {steps} steps, "
          f"{reduces} all-reduces, {reduce_us:.1f} us an all-reduce",
          flush=True)
    z, k, done = (full_tensor(v) for v in out)
    return {**_lasso_outputs(z, k, done),
            "walls": np.stack([_per_rank(ctx, w) for w in walls]),
            "both": np.asarray(both), "reduces": _per_rank(ctx, reduces),
            "steps": _per_rank(ctx, steps),
            "reduce_us": _per_rank(ctx, reduce_us)}


# ---------------------------------------------------------------------------
# the tp legs: one Shared operand in row stripes over tp, lanes over dp, on
# the shared-A solver and the flat machines

# BatchedAlgorithm's routes on one Shared problem, each with its
# all-reduces over tp a step (the shared-A leg) or a trip (the flat
# machines: an oracle round of the line searches is two, whole rows out of
# matvec and rmatvec's sum, and PANOCplus makes two rounds a trip, at the
# trial point and at its prox point; the adaptive machine sums a
# gradient's N + 1 entries at its candidate, FISTA's also at the
# extrapolated point)
# DRLS (a trip of its flat machine) and Douglas-Rachford (a step of the
# generic driver) run one prox of a least squares in row stripes
# (RowShardedLeastSquares): three all-reduces where A is wide (Woodbury's
# U^H A v and A^H U w, and the value), one where it is tall (the value;
# the routes "*_tall", on dp_x_tp_data(M=48))
TP_ROUTES = {"multirhs": 1, "panoc": 2, "zerofpr": 2, "panocplus": 4,
             "adaptive_fb": 1, "adaptive_fista": 2, "logistic_zerofpr": 2,
             "drls": 3, "douglas_rachford": 3, "drls_tall": 1,
             "douglas_rachford_tall": 1}
# the CPU cases on dp_x_tp_data; the card's routes (aa) (the shared-A leg)
# and (ab) (the flat machines) at benchmarks/scaling.py --path shared_tp's
# width, with route (n)'s flat_zerofpr_shared on tools/families.py's
# logistic data
TP_LEGS_TOL, TP_LEGS_MAXIT = 1e-5, 3000
# Douglas-Rachford's gamma times Lf: about 80 iterations on the wide
# problem, where DRLS's own 0.95 / Lf takes about 900
DR_GAMMA_LF = 10.0
TP_CARD_ROUTES = ("multirhs", "panoc", "zerofpr", "adaptive_fista",
                  "logistic_zerofpr", "drls")


def tp_data(route, dtype):
    """The CPU problem of a tp-legs route: ``dp_x_tp_data``, tall for the
    routes "*_tall"."""
    return dp_x_tp_data(dtype, M=48 if route.endswith("_tall") else 24)


@proxclass(meta_fields=("parts",))
class EmulatedRowOperator:
    """``RowShardedMatrixOperator`` over a tp group of ``parts`` ranks, in
    one process: ``matvec`` the stripes' products stacked (whole rows, as
    the sum of zero-padded stripes gives them), ``rmatvec`` the stripes'
    ``A_i^H y_i`` summed in rank order."""

    A: object
    parts: int

    def matvec(self, x):
        from ..parallel.sharded_ops import lanes_last
        from ..utils.precision import pdot

        return lanes_last(torch.cat([pdot(A, x)
                                     for A in self.A.chunk(self.parts)]))

    def rmatvec(self, y):
        from ..parallel.sharded_ops import lanes_last
        from ..utils.precision import pdot

        total = None
        for A, part in zip(self.A.chunk(self.parts), y.chunk(self.parts)):
            out = pdot(A.mH, part)
            total = out if total is None else total + out
        return lanes_last(total)


@proxclass(meta_fields=("parts", "wide"))
class EmulatedLeastSquares(EmulatedStripes):
    """``RowShardedLeastSquares`` over a tp group of ``parts`` ranks, in one
    process (see :func:`emulated_least_squares` for the factors): the
    prox's sums over the stripes in rank order, laid out as the collective
    returns them; the value and gradient of :class:`EmulatedStripes`."""

    U: object
    s: object
    Atb: object
    wide: bool

    def prox(self, x, gamma):
        from ..parallel.sharded_ops import lanes_last
        from ..prox.functions import _rparam
        from ..utils.precision import pdot

        c = _rparam(1.0, x) * gamma
        rhs = x + c * self.Atb
        if not self.wide:
            z = pdot(self.U, (pdot(self.U.mH, rhs) / (1 + c * self.s))
                     .to(rhs.dtype))
            return z, self(z)
        stripes = list(zip(self.A.chunk(self.parts),
                           self.U.chunk(self.parts)))
        total = None
        for A, U in stripes:
            w = pdot(A, rhs)
            part = pdot(U.mH, w)
            total = part if total is None else total + part
        w = (lanes_last(total) / (1 + c * self.s)).to(w.dtype)
        total = None
        for A, U in stripes:
            part = pdot(A.mH, pdot(U, w))
            total = part if total is None else total + part
        z = rhs - c * lanes_last(total)
        return z, self(z)


def emulated_least_squares(A, b, parts):
    """:class:`EmulatedLeastSquares` with the factors of
    ``sharded_ops._least_squares_factors``: a wide A's are the whole
    problem's (``make_least_squares``); a tall A's come from the stripes'
    Gram matrices (in double precision) and ``A_i^H b_i``, summed in rank
    order."""
    from ..prox.functions import make_least_squares
    from ..utils.precision import pdot

    m, n = A.shape
    if m < n:
        whole = make_least_squares(A, b)
        return EmulatedLeastSquares(A, b, parts, whole.U, whole.s,
                                    whole.Atb, True)
    total = None
    for A_i, b_i in zip(A.chunk(parts), b.chunk(parts)):
        Ad, Atb = A_i.double(), pdot(A_i.mH, b_i)
        part = torch.cat([pdot(Ad.mH, Ad).reshape(-1), Atb.double()])
        total = part if total is None else total + part
    s, U = torch.linalg.eigh(total[:n * n].reshape(n, n))
    return EmulatedLeastSquares(A, b, parts, U.to(A.dtype), s.to(A.dtype),
                                total[n * n:].to(Atb.dtype), False)


def tp_card_data():
    """``{route: numpy problem}`` of ``TP_CARD_ROUTES``: one
    ``shared_tp_data(SHARED_TP_LANES)`` (seconds to make) for the lasso
    routes, tools/families.py's logistic data for the logistic one."""
    from .families import logistic_data

    shared = shared_tp_data(SHARED_TP_LANES)
    return {route: logistic_data() if route == "logistic_zerofpr"
            else shared for route in TP_CARD_ROUTES}


def tp_problem(route, data, device, maxit, tol, parts=None):
    """``(solve, kwargs)`` of a tp-legs route, unplaced: ``solve(**kwargs)``
    returns ``(z, iters, done)``.  ``data`` is ``(A, b, lam, Lf)`` (one A
    for every lane) or the logistic data.  With ``parts``, the operands
    are emulated in one process over a tp group of that many ranks
    (:class:`EmulatedStripes`, :class:`EmulatedRowOperator`,
    :func:`emulated_least_squares`); the shared-A leg has no such form (see
    :func:`emulated_tp`).  DRLS and Douglas-Rachford take
    ``Shared(make_least_squares(A, b))``; Douglas-Rachford's gamma is
    ``DR_GAMMA_LF / Lf``."""
    from functools import partial

    from .. import algorithms as alg
    from ..ops.linops import MatrixOperator
    from ..parallel import BatchedAlgorithm, Shared, batched_zerofpr
    from ..prox import (
        LeastSquaresLoss,
        LogisticLoss,
        NormL1,
        SqrDistance,
        Translate,
        make_least_squares,
    )

    t = lambda v: torch.as_tensor(v, device=device)  # noqa: E731
    if route == "logistic_zerofpr":
        A, b, lam = t(data["A"]), t(data["b"]), t(data["lams"])
    else:
        A, b, lam, Lf = (t(v) if isinstance(v, np.ndarray) else v
                         for v in data)
    op = Shared(MatrixOperator(A) if parts is None
                else EmulatedRowOperator(A, parts))
    x0 = A.new_zeros((len(lam), A.shape[1]))
    if route == "logistic_zerofpr":
        # route (n)'s flat_zerofpr_shared, gamma = 0.95 / Lf a lane
        return partial(batched_zerofpr, tol=tol, maxit=maxit), dict(
            f=Shared(Translate(LogisticLoss(1.0), -b)), A=op, g=NormL1(lam),
            x0=x0, gamma=torch.full((len(lam),), 0.95 / data["Lf"],
                                    device=device))
    if route in ("panoc", "zerofpr", "panocplus"):
        return (BatchedAlgorithm(getattr(alg, f"make_{route}_iteration"),
                                 maxit=maxit, tol=tol),
                dict(x0=x0, f=Shared(SqrDistance(b)), A=op, g=NormL1(lam),
                     Lf=Lf))
    if route.removesuffix("_tall") in ("drls", "douglas_rachford"):
        f = Shared(make_least_squares(A, b) if parts is None
                   else emulated_least_squares(A, b, parts))
        if route.startswith("drls"):
            return (BatchedAlgorithm(alg.make_drls_iteration, maxit=maxit,
                                     tol=tol),
                    dict(x0=x0, f=f, g=NormL1(lam), Lf=Lf))
        return (BatchedAlgorithm(alg.make_douglas_rachford_iteration,
                                 maxit=maxit, tol=tol),
                dict(x0=x0, f=f, g=NormL1(lam), gamma=DR_GAMMA_LF / Lf))
    f = Shared(LeastSquaresLoss(A, b) if parts is None
               else EmulatedStripes(A, b, parts))
    kwargs = dict(x0=x0, f=f, g=NormL1(lam))
    if route == "multirhs":
        kwargs["Lf"] = Lf
    factory = (alg.make_forward_backward_iteration if route == "adaptive_fb"
               else alg.make_fast_forward_backward_iteration)
    return BatchedAlgorithm(factory, maxit=maxit, tol=tol), kwargs


def _lane_block(tree, i, n):
    """Block ``i`` of ``n`` of the lanes of ``tree``: every tensor not
    under a ``Shared`` marker cut along its batch dim."""
    from ..utils.tree import flatten

    leaves, spec = flatten(tree)
    return spec.unflatten([l if s or l.dim() == 0 else l.chunk(n)[i]
                           for l, s in zip(leaves, spec.shared)])


def emulated_tp(route, data, device, mesh_shape, maxit, tol):
    """The placed solve of a tp-legs route on ``mesh_shape = (dp, tp)``
    emulated in one process, one dp block of lanes at a time: the bits
    the placed solve must give.  The shared-A leg runs the solver's core
    on the stripes as the matcher hands them over.  Returns ``(z, iters,
    done)``."""
    from ..kernels import lasso

    dp, tp = mesh_shape
    if route == "multirhs":
        A, b, lam, Lf = data
        A, b, lam = (torch.as_tensor(v, device=device) for v in (A, b, lam))
        Lf = torch.tensor(Lf, dtype=torch.float64, device=device)
        outs = [lasso._solve_multirhs(
            tuple((A_i, b_i.expand(len(block), -1))
                  for A_i, b_i in zip(A.chunk(tp), b.chunk(tp))),
            block, Lf, tol, maxit=maxit) for block in lam.chunk(dp)]
    else:
        solve, kwargs = tp_problem(route, data, device, maxit, tol, parts=tp)
        outs = [solve(**_lane_block(kwargs, i, dp)) for i in range(dp)]
    return tuple(torch.cat(parts) for parts in zip(*outs))


@contextlib.contextmanager
def tp_route_seen():
    """What a tp-legs solve ran, in a dict: the process group of every call
    of the shared-A solver's core (``"multirhs"``) and the helper's
    all-reduces in each trip of the flat machines (``"trips"``) and in
    each step of the generic driver (``"steps"``)."""
    from ..kernels import lasso
    from ..parallel import adaptive_batch, batch, flat_ls
    from ..parallel.sharded_ops import COLLECTIVES

    seen = {"multirhs": [], "trips": [], "steps": []}
    core, host_while = lasso._solve_multirhs, flat_ls._host_while
    host_loop = batch.run_host_loop

    def core_spy(*args, **kwargs):
        seen["multirhs"].append(kwargs.get("group"))
        return core(*args, **kwargs)

    def counting_while(active_of, body, s, check_every, cap):
        def trip(s):
            before = COLLECTIVES["all_reduce"]
            s = body(s)
            seen["trips"].append(COLLECTIVES["all_reduce"] - before)
            return s

        return host_while(active_of, trip, s, check_every, cap)

    def counting_loop(body, *args, **kwargs):
        def step(k, state):
            before = COLLECTIVES["all_reduce"]
            state = body(k, state)
            seen["steps"].append(COLLECTIVES["all_reduce"] - before)
            return state

        return host_loop(step, *args, **kwargs)

    lasso._solve_multirhs = core_spy
    flat_ls._host_while = adaptive_batch._host_while = counting_while
    batch.run_host_loop = counting_loop
    try:
        yield seen
    finally:
        lasso._solve_multirhs = core
        flat_ls._host_while = adaptive_batch._host_while = host_while
        batch.run_host_loop = host_loop


def place_tp(tree, mesh):
    """``tree`` with its Shared operands in row stripes over ``tp`` and its
    lanes over ``dp``."""
    from ..parallel import shard_batch
    from ..parallel.sharded_ops import shard_rows

    return shard_batch(shard_rows(tree, mesh, "tp"), mesh, "dp")


def tp_leg_solve(mesh, route, solve, kwargs, maxit):
    """``solve(**kwargs)`` placed by :func:`place_tp`.  Asserts the route
    taken (the shared-A core called once with the tp group, the generic
    driver's steps for Douglas-Rachford, or the flat machine's trips),
    every all-reduce over tp (none over dp), the all-reduces a step (the
    shared-A leg: one at init and one a step) or a trip or generic step
    (``TP_ROUTES``), and tp ranks that end with the same bits.  Returns
    ``(outputs, seconds, all-reduces, steps or trips)``."""
    from ..parallel.sharded_ops import COLLECTIVES, all_gather
    from ..utils.host_loop import CHECK_EVERY

    placed = place_tp(kwargs, mesh)
    device = kwargs["x0"].device
    tp_group = mesh.get_group("tp")
    before = COLLECTIVES["all_reduce"]
    with groups_reduced() as groups, tp_route_seen() as seen:
        t0 = time.perf_counter()
        out = solve(**placed)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
    reduces = COLLECTIVES["all_reduce"] - before
    assert len(groups) == reduces, (len(groups), reduces)
    assert all(g is tp_group for g in groups), "an all-reduce not over tp"
    if route == "multirhs":
        assert seen["multirhs"] == [tp_group], seen["multirhs"]
        steps = steps_run(out[1].to_local(), CHECK_EVERY, maxit)
        assert reduces == 1 + steps, (reduces, steps)
    else:
        kind, other = (("steps", "trips") if route.startswith("douglas")
                       else ("trips", "steps"))
        counts = seen[kind]
        assert counts and set(counts) == {TP_ROUTES[route]}, (route, counts)
        assert not seen[other], route
        steps = len(counts)
    x = out[0].to_local()
    both = all_gather(x[None], tp_group)
    assert all(torch.equal(both[0], xr) for xr in both[1:]), (
        f"{route}: the ranks of a tp group hold different solutions")
    return out, wall, reduces, steps


def _tp_legs_case(ctx, routes):
    """``routes`` on ``tp_data`` in float32 and float64 on the (dp, tp)
    mesh: the collectives and tp ranks asserted by :func:`tp_leg_solve`,
    the bits of :func:`emulated_tp` (each rank emulates its own lanes'
    block), every lane done.  Returns the gathered outputs by route and
    dtype."""
    from ..parallel.sharded_ops import full_tensor

    mesh = ctx.dp_tp()
    dp, tp = mesh.shape
    block = mesh.get_local_rank("dp")
    out = {}
    for dtype in (np.float32, np.float64):
        name = np.dtype(dtype).name
        for route in routes:
            data = tp_data(route, dtype)
            solve, kwargs = tp_problem(route, data, ctx.device,
                                       TP_LEGS_MAXIT, TP_LEGS_TOL)
            got, _, reduces, steps = tp_leg_solve(mesh, route, solve, kwargs,
                                                  TP_LEGS_MAXIT)
            A, b, lam, Lf = data
            want = emulated_tp(route, (A, b, np.split(lam, dp)[block], Lf),
                               ctx.device, (1, tp), TP_LEGS_MAXIT,
                               TP_LEGS_TOL)
            assert all(torch.equal(g.to_local(), e)
                       for g, e in zip(got, want)), (
                f"{route} {name}: differs from the stripes emulated in one "
                "process")
            z, k, done = (full_tensor(v) for v in got)
            assert bool(done.all()), f"{route} {name}: lanes left"
            out.update({f"{key}_{route}_{name}": v for key, v in
                        _lasso_outputs(z, k, done).items()})
            out[f"reduces_{route}_{name}"] = np.asarray([reduces, steps])
    return out


@case
def multirhs_tp(ctx):
    """The shared-A leg over tp: ``BatchedAlgorithm`` on a
    ``Shared(LeastSquaresLoss)`` in row stripes takes
    ``solve_lasso_multirhs``'s core (one all-reduce a step), and
    ``solve_lasso_multirhs`` on DTensors (A ``Shard(0)`` over tp, Bmat's
    lanes over dp with its columns replicated or ``Shard(1)`` over tp)
    gives the same bits."""
    from ..kernels.lasso import solve_lasso_multirhs
    from ..parallel import shard_batch
    from ..parallel.sharded_ops import _place, full_tensor

    out = _tp_legs_case(ctx, ("multirhs",))
    mesh = ctx.dp_tp()
    for dtype in (np.float32, np.float64):
        A, b, lam, Lf = (ctx.t(v) if isinstance(v, np.ndarray) else v
                         for v in dp_x_tp_data(dtype))
        name = np.dtype(dtype).name
        want = [ctx.t(out[f"{key}_multirhs_{name}"])
                for key in ("z", "it", "done")]
        Bmat = b.expand(len(lam), -1).contiguous()
        for cols in (None, "tp"):
            got = solve_lasso_multirhs(
                _place(A, mesh, ("tp", None)),
                _place(Bmat, mesh, ("dp", cols)), shard_batch(lam, mesh, "dp"),
                torch.tensor(Lf, dtype=torch.float64, device=ctx.device),
                TP_LEGS_TOL, maxit=TP_LEGS_MAXIT)
            _equal_lanes(f"solve_lasso_multirhs on DTensors, Bmat columns "
                         f"over {cols} ({name})",
                         [full_tensor(v) for v in got], want)
    return out


@case
def flat_tp(ctx):
    """The flat machines over tp through ``BatchedAlgorithm``: PANOC,
    ZeroFPR and PANOCplus on ``Shared(SqrDistance(b))`` beside
    ``Shared(MatrixOperator(A))``, both in row stripes (b gathered whole
    once), two all-reduces a trip; adaptive FB and FISTA on a
    ``Shared(LeastSquaresLoss)`` in row stripes, one a trip."""
    return _tp_legs_case(ctx, ("panoc", "zerofpr", "panocplus",
                               "adaptive_fb", "adaptive_fista"))


@case
def drls_tp(ctx):
    """DRLS (its flat machine) and Douglas-Rachford (the generic driver)
    over tp through ``BatchedAlgorithm`` on ``Shared(make_least_squares(A,
    b))`` in row stripes, on the wide and the tall problem; and the JAX
    package's spelling of DRLS's problem, ``make_least_squares`` on
    DTensors in row stripes, with the same bits (float64)."""
    from ..parallel import Shared
    from ..parallel.sharded_ops import _place, full_tensor
    from ..prox import make_least_squares

    out = _tp_legs_case(ctx, ("drls", "douglas_rachford", "drls_tall",
                              "douglas_rachford_tall"))
    mesh = ctx.dp_tp()
    for route in ("drls", "drls_tall"):
        solve, kwargs = tp_problem(route, tp_data(route, np.float64),
                                   ctx.device, TP_LEGS_MAXIT, TP_LEGS_TOL)
        ls = kwargs.pop("f").value
        f = Shared(make_least_squares(_place(ls.A, mesh, ("tp", None)),
                                      _place(ls.b, mesh, ("tp",))))
        _equal_lanes(f"{route} float64: make_least_squares on DTensors",
                     [full_tensor(v)
                      for v in solve(f=f, **place_tp(kwargs, mesh))],
                     [ctx.t(out[f"{key}_{route}_float64"])
                      for key in ("z", "it", "done")])
    return out


@case
def tp_legs(ctx):
    """Routes (aa), (ab) and (ac): ``TP_CARD_ROUTES`` at full width
    (:func:`tp_card_data`) on the (dp, tp) mesh,
    each after a warm-up of a few steps: a rank's wall, the wall from
    barrier to barrier, the all-reduces and the steps or trips, and the
    time of one all-reduce over tp at each size the routes reduce."""
    import torch.distributed as dist

    from ..parallel.sharded_ops import all_reduce, full_tensor

    mesh = ctx.dp_tp()
    tp_group = mesh.get_group("tp")
    out = {}
    problems = tp_card_data()
    for route, data in problems.items():
        tp_leg_solve(mesh, route, *tp_problem(route, data, ctx.device, 10,
                                              SHARED_TP_TOL), 10)
        solve, kwargs = tp_problem(route, data, ctx.device, SHARED_TP_MAXIT,
                                   SHARED_TP_TOL)
        dist.barrier()
        t0 = time.perf_counter()
        got, wall, reduces, steps = tp_leg_solve(mesh, route, solve, kwargs,
                                                 SHARED_TP_MAXIT)
        dist.barrier()
        both = time.perf_counter() - t0
        unit = "steps" if route == "multirhs" else "trips"
        print(f"rank {ctx.rank}: {route} {got[0].to_local().shape[0]} lanes, "
              f"{wall:.4f} s, {steps} {unit}, {reduces} all-reduces",
              flush=True)
        z, k, done = (full_tensor(v) for v in got)
        out.update({f"{key}_{route}": v for key, v in
                    _lasso_outputs(z, k, done).items()})
        out.update({f"walls_{route}": _per_rank(ctx, wall),
                    f"both_{route}": np.asarray(both),
                    f"reduces_{route}": _per_rank(ctx, reduces),
                    f"steps_{route}": _per_rank(ctx, steps)})
    # one all-reduce over tp at each size the routes reduce: a lane's N
    # (multirhs, rmatvec, A^H U w in the least squares' prox), M (matvec's
    # whole rows, U^H A v), N + 1 (the adaptive machine's value and
    # gradient) and 1 (the prox's value) entries
    M, N = problems["multirhs"][0].shape
    lanes = SHARED_TP_LANES // mesh.size(0)
    sizes = (N, M, N + 1, 1)
    us = []
    for n in sizes:
        buf = torch.zeros((lanes, n), dtype=torch.float32, device=ctx.device)
        all_reduce(buf, tp_group)
        _sync(ctx)
        t0 = time.perf_counter()
        for _ in range(50):
            all_reduce(buf, tp_group)
        _sync(ctx)
        us.append(1e6 * (time.perf_counter() - t0) / 50)
    out["reduce_sizes"] = np.asarray([[lanes, n] for n in sizes])
    out["reduce_us"] = np.stack([_per_rank(ctx, u) for u in us])
    return out


@case
def flat(ctx):
    from ..ops.linops import MatrixOperator
    from ..parallel import (
        Shared,
        batched_panoc,
        batched_zerofpr,
        shard_batch,
    )
    from ..prox import NormL1, SqrDistance

    A, b, lam, Lf = (ctx.t(v) for v in flat_data())
    mesh = ctx.dp()
    # 0.95 / Lf as a division (a number over a tensor is a reciprocal
    # times the number in PyTorch, one rounding more than the JAX test's)
    gamma = torch.full_like(Lf, 0.95) / Lf
    problem = (SqrDistance(b), MatrixOperator(A), NormL1(lam),
               torch.zeros((A.shape[0], A.shape[2]), dtype=A.dtype,
                           device=ctx.device), gamma)
    out = {}
    for fn in (batched_zerofpr, batched_panoc):
        name = fn.__name__
        ref = fn(*problem, 1e-6, maxit=400)
        placed = shard_batch(problem, mesh, "dp")
        with no_collectives(name):
            got = fn(*placed, 1e-6, maxit=400)
        _equal_lanes(name, got, ref)
        out.update({f"{k}_{name}": v for k, v in _lasso_outputs(*got)
                    .items()})
    # a Shared operand: one (A, b), per-lane lam, dp lanes
    f_sh, A_sh = Shared(SqrDistance(b[0])), Shared(MatrixOperator(A[0]))
    lanes = (NormL1(lam), problem[3], torch.full_like(lam, 0.95) / Lf[0])
    ref = batched_zerofpr(f_sh, A_sh, lanes[0], lanes[1], lanes[2], 1e-6,
                          maxit=400)
    placed = shard_batch(lanes, mesh, "dp")
    with no_collectives("batched_zerofpr, Shared"):
        got = batched_zerofpr(f_sh, A_sh, *placed, 1e-6, maxit=400)
    _equal_lanes("batched_zerofpr, Shared", got, ref)
    out.update({f"{k}_shared": v for k, v in _lasso_outputs(*got).items()})
    return out


@case
def packed(ctx):
    from ..kernels.lasso import solve_lasso_batch_packed
    from ..parallel import sharded_solve_lasso_batch_packed

    args = [ctx.t(v) for v in lasso_batch(B=16, M=16, N=192, seed=6)]
    return _kernel_case(ctx, "packed", sharded_solve_lasso_batch_packed,
                        solve_lasso_batch_packed, args + [1e-5],
                        maxit=3000)


def _raises(fn, message):
    try:
        fn()
    except ValueError as err:
        assert str(err) == message, (str(err), message)
        return
    raise AssertionError(f"no ValueError: {message}")


@case
def errors(ctx):
    from ..parallel import (
        sharded_solve_box_qp_batch,
        sharded_solve_lasso_batch,
        sharded_solve_lasso_batch_packed,
        sharded_solve_lasso_multirhs,
        sharded_solve_tv_batch,
    )

    mesh, w = ctx.dp(), ctx.world
    A, b, lam, Lf = (ctx.t(v) for v in lasso_batch(B=4 * w, M=16, N=192,
                                                   seed=7))
    _raises(lambda: sharded_solve_lasso_batch_packed(
        A, b, lam, Lf, 1e-5, mesh=mesh, maxit=10, pack=3),
        f"explicit pack=3 does not divide the per-device batch 4 (= "
        f"{4 * w} / dp={w}); use pack=None for automatic selection with "
        f"natural-layout fallback")
    odd = 4 * w + 1
    A1, b1, lam1, Lf1 = (ctx.t(v) for v in lasso_batch(B=odd, seed=7))
    _raises(lambda: sharded_solve_lasso_batch(
        A1, b1, lam1, Lf1, 1e-5, mesh=mesh, maxit=10),
        f"batch {odd} not divisible by mesh axis dp={w}")
    Am, Bmat, lamm, _ = multirhs_data()
    _raises(lambda: sharded_solve_lasso_multirhs(
        ctx.t(Am), ctx.t(Bmat), ctx.t(lamm), ctx.t(np.ones(16, np.float32)),
        1e-5, mesh=mesh, maxit=10),
        "Lf must be a scalar for the shared-A multirhs wrapper, got shape "
        "(16,)")
    Q, q, Lip = (ctx.t(v) for v in box_qp_data())
    lo = ctx.t(-np.ones(16, np.float32))
    _raises(lambda: sharded_solve_box_qp_batch(
        Q, q, lo, 1.0, Lip, 1e-4, mesh=mesh, maxit=10),
        "lo must be lane-uniform (scalar) in the sharded wrapper, got "
        "shape (16,)")
    bt, lamt = (ctx.t(v) for v in tv_data())
    _raises(lambda: sharded_solve_tv_batch(
        bt, lamt, 1e-3, mesh=mesh, maxit=10, gamma1=np.ones(8)),
        "gamma1 must be lane-uniform (scalar) in the sharded wrapper, got "
        "shape (8,)")
    return {"checked": np.asarray(5)}


@case
def multiprocess(ctx):
    from ..kernels.lasso import solve_lasso_batch
    from ..parallel import global_mesh as make_global, shard_batch

    mesh = make_global((ctx.world,), ("dp",), device_type=ctx.device_type)
    args = [ctx.t(v) for v in multiprocess_batch()]
    ref = solve_lasso_batch(*args, 1e-5, maxit=3000, use_kernel=False)
    placed = shard_batch(tuple(args), mesh, "dp")
    with no_collectives("multiprocess"):
        out = solve_lasso_batch(*placed, 1e-5, maxit=3000,
                                use_kernel=False)
    _equal_lanes("multiprocess", out, ref)
    return _lasso_outputs(*out)


@case
def scaling_panoc(ctx):
    """docs/tpu_scaling.md's block 5 on every rank."""
    from ..examples import scaling_guide as sg

    out = sg.sharded_panoc(ctx.device_type)
    sg.check(("tpu_scaling.md", 5), out)
    return {"x": _np(out["x"]), "it": np.asarray(out["iterations"])}


@case
def scaling_consensus(ctx):
    """docs/tpu_scaling.md's block 6 on every rank, in SCALING_BLOCKS
    blocks."""
    from ..examples import scaling_guide as sg

    out = sg.consensus(ctx.device_type, blocks=SCALING_BLOCKS)
    sg.check(("tpu_scaling.md", 6), out)
    return {"x": _np(out["x"]), "it": np.asarray(out["iterations"]),
            "all_reduces": np.asarray(out["all_reduces"])}


@case
def dryrun(ctx):
    from .graft_entry import dryrun_multichip

    dryrun_multichip(ctx.world, ctx.device_type)
    return {"ran": np.asarray(ctx.world)}


def _sync(ctx):
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)


def _per_rank(ctx, value):
    """Every rank's ``value`` (a number), gathered."""
    import torch.distributed as dist

    from ..parallel.sharded_ops import all_gather

    t = torch.tensor([value], dtype=torch.float64, device=ctx.device)
    return all_gather(t, dist.group.WORLD).cpu().numpy()


@case
def flagship(ctx):
    """The main path's 256 lanes, ``256 / ranks`` a rank, through
    ``sharded_solve_lasso_batch_packed(restart=True)``, each rank uploading
    only its own lanes."""
    import torch.distributed as dist

    from ..kernels import lasso as tl
    from ..parallel import sharded_solve_lasso_batch_packed
    from ..parallel.sharded_ops import _dtensor

    dt = _dtensor()
    mesh = ctx.dp()
    data = lasso_problems(256)
    per = data[0].shape[0] // ctx.world
    mine = [dt.DTensor.from_local(
        ctx.t(v[ctx.rank * per:(ctx.rank + 1) * per]), mesh, [dt.Shard(0)],
        run_check=False) for v in data]

    def solve():
        return sharded_solve_lasso_batch_packed(
            *mine, FLAGSHIP_TOL, mesh=mesh, maxit=FLAGSHIP_MAXIT,
            restart=True)

    solve()  # warm-up
    _sync(ctx)
    dist.barrier()
    tl.fused_fista_full_step.launches = 0
    t0 = time.perf_counter()
    with no_collectives("flagship"):
        z, it, done = solve()
        _sync(ctx)
    wall = time.perf_counter() - t0
    dist.barrier()
    # from the barrier before the solves to the barrier after them
    both = time.perf_counter() - t0
    launches = tl.fused_fista_full_step.launches
    walls = _per_rank(ctx, wall)
    print(f"rank {ctx.rank}: flagship {per} lanes, {wall:.4f} s a solve, "
          f"fista_step launches {launches}", flush=True)
    if ctx.rank == 0:
        print(f"flagship: ranks' walls {', '.join(f'{w:.4f}' for w in walls)}"
              f" s; two-rank wall {both:.4f} s (one card shared)",
              flush=True)
    assert launches > 0 or ctx.device_type == "cpu"
    out = _lasso_outputs(z, it, done)
    out.update(walls=walls, both=np.asarray(both),
               launches=_per_rank(ctx, launches))
    return out


def rows_panoc_solve(ranks, device, mesh):
    """PANOC on :func:`rows_problem` (``ranks`` stripes): A row-sharded
    over the mesh's one axis where ``mesh`` is given, a plain matrix
    otherwise.  Returns ``(x, iterations, seconds)``."""
    from .. import PANOC
    from ..parallel import shard_matrix_operator
    from ..prox import NormL1, SqrNormL2, Translate

    A, b, Lf = (torch.as_tensor(v, device=device) if isinstance(
        v, np.ndarray) else v for v in rows_problem(ranks))
    op = A if mesh is None else shard_matrix_operator(
        A, mesh, row_axis=mesh.mesh_dim_names[0])
    t0 = time.perf_counter()
    x, it = PANOC(tol=ROWS_TOL, maxit=ROWS_MAXIT)(
        x0=torch.zeros(A.shape[1], dtype=A.dtype, device=device),
        f=Translate(SqrNormL2(1.0), -b), A=op, g=NormL1(0.1), Lf=Lf)
    return x, it, time.perf_counter() - t0


def consensus_solve(ranks, device, mesh):
    """ConsensusADMM over :func:`consensus_blocks` (``ranks`` blocks), the
    blocks sharded over the mesh's one axis where ``mesh`` is given.
    Returns ``(x, iterations, seconds)``."""
    from ..parallel import ConsensusADMM, shard_batch, stack_functions
    from ..prox import NormL1, make_least_squares

    fs = stack_functions([
        make_least_squares(torch.as_tensor(A, device=device),
                           torch.as_tensor(b, device=device))
        for A, b in consensus_blocks(ranks)])
    if mesh is not None:
        fs = shard_batch(fs, mesh, mesh.mesh_dim_names[0])
    t0 = time.perf_counter()
    x, it = ConsensusADMM(tol=CONSENSUS_TOL, maxit=CONSENSUS_MAXIT)(
        x0=torch.zeros(96, dtype=torch.float32, device=device), fs=fs,
        g=NormL1(0.1), gamma=1.0)
    return x, it, time.perf_counter() - t0


def _against_one_rank(ctx, name, solve, maxit):
    x_s, it_s, wall = solve(ctx.world, ctx.device, ctx.dp())
    x_1, it_1, wall_1 = solve(ctx.world, ctx.device, None)
    assert it_s < maxit and it_1 < maxit, (name, it_s, it_1)
    err = float((x_s - x_1).abs().max())
    scale = 1.0 + float(x_1.abs().max())
    # float32 reduce-order slack, as dryrun_multichip's
    assert err <= 1e-4 * scale, (name, err, scale)
    if ctx.rank == 0:
        print(f"{name}: {ctx.world} ranks {it_s} iterations, {wall:.4f} s; "
              f"one rank {it_1} iterations, {wall_1:.4f} s; max|dx| "
              f"{err:.3e}", flush=True)
    return {"x": x_s.cpu().numpy(), "it": np.asarray(it_s),
            "x_one": x_1.cpu().numpy(), "it_one": np.asarray(it_1),
            "walls": _per_rank(ctx, wall)}


@case
def rows_panoc(ctx):
    return _against_one_rank(ctx, "rows_panoc", rows_panoc_solve,
                             ROWS_MAXIT)


@case
def blocks_consensus(ctx):
    return _against_one_rank(ctx, "blocks_consensus", consensus_solve,
                             CONSENSUS_MAXIT)


# ---------------------------------------------------------------------------
# ranks and the launcher


def _device(device_type, rank, world):
    if device_type == "cpu":
        return torch.device("cpu")
    # a card a rank where there are enough, else the ranks share card 0
    return torch.device("cuda", rank if torch.cuda.device_count() >= world
                        else 0)


def rank_main(args):
    import torch.distributed as dist

    from ..parallel import initialize_distributed
    from ..parallel.sharded_ops import COLLECTIVES

    if args.device == "cpu":
        torch.set_num_threads(1)
    device = _device(args.device, args.rank, args.ranks)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    initialize_distributed(f"localhost:{args.port}", args.ranks, args.rank,
                           backend=args.backend, device_type=args.device)
    ctx = Context(args.rank, args.ranks, args.device, device)
    results = {}
    try:
        for name in _case_names(args.cases):
            t0 = time.perf_counter()
            out = CASES[name](ctx)
            results.update({f"{name}__{k}": v for k, v in out.items()})
            print(f"rank {args.rank}: {name} ok "
                  f"({time.perf_counter() - t0:.2f} s)", flush=True)
        if args.rank == 0:
            np.savez(os.path.join(args.out, "spmd.npz"), **results)
        print(f"rank {args.rank}: collectives {dict(COLLECTIVES)}",
              flush=True)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _case_names(cases):
    names = {"cpu": CPU_CASES, "card": CARD_CASES, "tp": TP_CASES,
             "scaling": SCALING_CASES}.get(cases)
    names = names or tuple(cases.split(","))
    unknown = [n for n in names if n not in CASES]
    if unknown:
        raise SystemExit(f"spmd_worker: unknown cases {unknown}")
    return names


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(args):
    """Start the ranks, wait for them, stop all of them if one fails."""
    _case_names(args.cases)
    os.makedirs(args.out, exist_ok=True)
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("spmd_worker: --device cuda and no card")
        from ..kernels import _build

        _build.library()  # once, before the ranks load it
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (root, env.get("PYTHONPATH")) if p)
    if args.device == "cpu":
        # one thread a rank, numpy's BLAS too
        env.update(OMP_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1",
                   MKL_NUM_THREADS="1")
    port = _free_port()
    cmd = [sys.executable, "-m", "proxtpu_torch.tools.spmd_worker",
           "--ranks", str(args.ranks), "--backend", args.backend,
           "--device", args.device, "--cases", args.cases, "--out",
           args.out, "--port", str(port)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(cmd + ["--rank", str(r)], env=env)
             for r in range(args.ranks)]
    failed = None
    try:
        while any(p.poll() is None for p in procs):
            failed = next((r for r, p in enumerate(procs)
                           if p.poll() not in (None, 0)), None)
            if failed is not None:
                break
            if time.perf_counter() - t0 > args.timeout:
                failed = "timeout"
                break
            time.sleep(0.05)
        failed = failed if failed is not None else next(
            (r for r, p in enumerate(procs) if p.returncode != 0), None)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    if failed is not None:
        raise SystemExit(f"spmd_worker: rank {failed} failed")
    print(f"spmd_worker: {args.ranks} ranks, cases {args.cases}: "
          f"{time.perf_counter() - t0:.2f} s", flush=True)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--ranks", type=int, required=True)
    p.add_argument("--backend", choices=("gloo", "nccl"), required=True)
    p.add_argument("--device", choices=("cpu", "cuda"), required=True)
    p.add_argument("--cases", default="cpu",
                   help="'cpu', 'card', 'tp', 'scaling' or a "
                   "comma-separated list")
    p.add_argument("--out", required=True)
    p.add_argument("--timeout", type=float, default=240.0)
    p.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    p.add_argument("--port", type=int, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.rank is None:
        launch(args)
    else:
        rank_main(args)


if __name__ == "__main__":
    main()
