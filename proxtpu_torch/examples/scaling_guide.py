"""The twelve Python blocks of the JAX package's ``docs/tpu_scaling.md`` on
the port, one function per block, each returning what its block makes
beside what :func:`check` holds it against.  :data:`BLOCKS` names them by
file and block, as :mod:`.guides` does.

Every function runs on the card unless ``device="cpu"`` is passed (with no
card it raises), at the scale its block's own text gives; the keyword
arguments cut it down (:data:`SMALL`, the sizes the CPU tests run).  The
problems are the flagship family (``tools/problems.py::lasso_data``, 200 x
400) in float64 with ``Lf = ||A||_2^2`` taken as the largest eigenvalue of
the Gram matrix (:func:`lassos`): the blocks that take flagship lanes take
the first lanes of block 1's.  Where the JAX text
differs, the port's form:

* block 2's ``jax.vmap`` of the factory is the factory called once on
  stacked tensors: ``torch.func.vmap`` cannot return the iteration object,
  and every tensor of the factory's output already carries the lanes;
* block 4's ``jax.vmap`` is ``torch.func.vmap(..., randomness="same")``:
  the power iteration draws its normal start from a generator, which
  ``vmap`` refuses in its default mode; ``"same"`` gives every lane the
  bits of its own unvmapped call;
* blocks 5 and 6 run on the default process group (a one-rank group of the
  device's backend is brought up around the block when there is none), the
  mesh over every rank; block 6 makes one block of rows a rank unless told
  otherwise, as the text's "one per device";
* block 7's ``set_matmul_precision("default")`` runs as written; on the
  card ``"default"`` multiplies bfloat16 inputs in float32 and ``"high"``
  runs TF32 (``utils/precision.py``), and :func:`matmul_precision` solves
  at all three settings;
* block 12's eight virtual devices are N Gloo processes
  (``tools/spmd_worker.py``) running ``graft_entry.dryrun_multichip(N)``.
"""

import contextlib
import functools
import os
import tempfile
import time

import numpy as np
import torch

from . import device_of

# the blocks' own scale: block 1's 4096 lanes of the flagship shape
LANES = 4096
M, N = 200, 400
FLAGSHIP = 256          # lanes of the flagship batch (blocks 4, 7, 9, 11)
PAYLOADS = 8            # block 11's stream
SINGLE = 8              # block 1's lanes held against the single driver
DRYRUN_TIMEOUT_S = 240  # block 12's ranks


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _timed(dev, fn):
    _sync(dev)
    t0 = time.perf_counter()
    out = fn()
    _sync(dev)
    return out, time.perf_counter() - t0


@functools.lru_cache(maxsize=4)
def prepare(lanes=LANES, m=M, n=N):
    """``lasso_data(lanes, m, n)`` in float64, made once and kept (numpy's
    generator leaves the interpreter free while it fills the arrays, so a
    caller may make block 1's 4096 lanes in a thread ahead of time)."""
    return _problems().lasso_data(lanes, m, n, np.float64)


@functools.lru_cache(maxsize=4)
def _lassos(lanes, m, n):
    As, bs, lams = prepare(lanes, m, n)
    return As, bs, lams, lipschitz(As)


def _problems():
    from ..tools import problems

    return problems


def lipschitz(As):
    """``||A_i||_2^2`` of each lane of a (B, m, n) float64 array: the largest
    eigenvalue of the smaller Gram matrix, by LAPACK on the host, blocks of
    lanes on every core (4096 lanes of 200 x 400 in seconds, where one SVD a
    lane takes a minute)."""
    import concurrent.futures

    A = torch.from_numpy(np.ascontiguousarray(As))
    G = A @ A.mT if A.shape[1] <= A.shape[2] else A.mT @ A
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # one LAPACK call a core
    try:
        with concurrent.futures.ThreadPoolExecutor(os.cpu_count()) as pool:
            top = pool.map(lambda g: torch.linalg.eigvalsh(g)[:, -1],
                           G.split(64))
            return torch.cat(list(top)).numpy()
    finally:
        torch.set_num_threads(threads)


def lassos(lanes, m=M, n=N, first=None, dtype=np.float64):
    """``(As, bs, lams, Lfs)`` as numpy arrays: ``prepare(lanes, m, n)`` and
    ``Lfs = lipschitz(As)``; the first ``first`` lanes, cast to ``dtype``.
    Kept for the next block (four sets at most)."""
    return tuple(v[:first].astype(dtype, copy=False)
                 for v in _lassos(lanes, m, n))


def _tensors(dev, *arrays):
    return tuple(torch.as_tensor(a, device=dev) for a in arrays)


def fb_recheck(A, b, lam, Lf, xs):
    """Each lane's forward-backward residual ``||x - prox(x - grad/Lf)||_inf
    * Lf`` in float64 (``tests/test_dispatch.py:88-95``); ``A`` is (B, m, n)
    or one shared (m, n)."""
    xs = torch.as_tensor(xs).double()
    B = xs.shape[0]
    A = torch.as_tensor(A).double().expand(B, *A.shape[-2:])
    b = torch.as_tensor(b).double().expand(B, b.shape[-1])
    lam, Lf = (torch.as_tensor(v, device=xs.device).double()
               for v in (lam, Lf))
    gam = (1.0 / Lf).reshape(-1, 1).expand(B, 1)
    r = torch.einsum("bmn,bn->bm", A, xs) - b
    y = xs - gam * torch.einsum("bmn,bm->bn", A, r)
    z = torch.sign(y) * torch.clamp(y.abs() - gam * lam.reshape(-1, 1), min=0)
    return (xs - z).abs().amax(dim=1) / gam[:, 0]


# ---------------------------------------------------------------------------
# 1. scenario batching


def scenario_batch(device="cuda", lanes=LANES, m=M, n=N, single=SINGLE):
    """Block 1 (``:13-20``): one problem dict a lane, with Python ``lam``
    and ``Lf``, through ``batch_problems`` and ``batched_run_loop``; the
    first ``single`` lanes again through ``FastForwardBackward``, one at a
    time.  float64."""
    from ..algorithms import FastForwardBackward, \
        make_fast_forward_backward_iteration
    from ..parallel import batch_problems, batched_run_loop
    from ..prox import LeastSquaresLoss, NormL1

    tol, maxit = 1e-6, 2000
    dev = device_of(device)
    As, bs, lams, Lfs = lassos(lanes, m, n)
    A, b = _tensors(dev, As, bs)
    problems = [dict(x0=torch.zeros(n, dtype=torch.float64, device=dev),
                     f=LeastSquaresLoss(A[i], b[i]), g=NormL1(float(lams[i])),
                     Lf=float(Lfs[i])) for i in range(lanes)]

    def solve():
        iteration = batch_problems(make_fast_forward_backward_iteration,
                                   problems)
        return batched_run_loop(iteration, maxit=maxit, tol=tol)

    (xs, iters, done), wall = _timed(dev, solve)
    solo = [FastForwardBackward(tol=tol, maxit=maxit)(**p)
            for p in problems[:single]]
    xs_1 = torch.stack([x for x, _ in solo]) if solo else xs[:0]
    return {"xs": xs, "iters": iters, "done": done, "wall": wall,
            "tol": tol, "recheck": fb_recheck(A, b, lams, Lfs, xs),
            "xs_single": xs_1, "iters_single": [int(k) for _, k in solo],
            "recheck_single": fb_recheck(A[:single], b[:single],
                                         lams[:single], Lfs[:single], xs_1)}


def vmapped_factory(device="cuda", lanes=LANES, m=M, n=N, scenario=None):
    """Block 2 (``:84-90``): the factory called once on stacked ``As``,
    ``bs``, ``lams`` and ``gamma = 1 / Lfs`` (the port's form of the
    ``jax.vmap``), run by ``batched_run_loop``; ``scenario`` is block 1's
    result on the same lanes (run here when not given)."""
    from ..algorithms import make_fast_forward_backward_iteration
    from ..parallel import batched_run_loop
    from ..prox import LeastSquaresLoss, NormL1

    dev = device_of(device)
    A, b, lam, Lf = _tensors(dev, *lassos(lanes, m, n))

    def solve():
        iteration = make_fast_forward_backward_iteration(
            x0=torch.zeros(lanes, n, dtype=torch.float64, device=dev),
            f=LeastSquaresLoss(A, b), g=NormL1(lam), gamma=1.0 / Lf)
        return batched_run_loop(iteration, maxit=2000, tol=1e-6)

    (xs, iters, done), wall = _timed(dev, solve)
    if scenario is None:
        scenario = scenario_batch(device, lanes, m, n, single=0)
    return {"xs": xs, "iters": iters, "done": done, "wall": wall,
            "xs_1": scenario["xs"], "iters_1": scenario["iters"],
            "done_1": scenario["done"]}


def adaptive_backtracking(device="cuda", lanes=64, m=400, n=200):
    """Block 3 (``:104-108``): adaptive forward-backward through
    ``BatchedAlgorithm`` with ``backtrack_limit=32`` (the bounded generic
    driver, as in the JAX package), on ``lasso_data(lanes, m, n)`` in
    float64."""
    from ..algorithms import make_forward_backward_iteration
    from ..parallel import BatchedAlgorithm
    from ..prox import LeastSquaresLoss, NormL1

    dev = device_of(device)
    As, bs, lams = _problems().lasso_data(lanes, m, n, np.float64)
    A, b, lam = _tensors(dev, As, bs, lams)
    solver = BatchedAlgorithm(make_forward_backward_iteration, maxit=3000,
                              tol=1e-6)
    (xs, iters, done), wall = _timed(dev, lambda: solver(
        x0=torch.zeros(lanes, n, dtype=torch.float64, device=dev),
        f=LeastSquaresLoss(A, b), g=NormL1(lam), adaptive=True,
        backtrack_limit=32))
    return {"xs": xs, "iters": iters, "done": done, "wall": wall}


def power_iteration(device="cuda", lanes=FLAGSHIP, source=LANES, m=M, n=N):
    """Block 4 (``:138-145``): ``||A||_2^2`` of each of the first ``lanes``
    of block 1's ``source`` lanes by ``power_iteration_opnorm`` under
    ``torch.func.vmap(..., randomness="same")``; beside it the exact value
    and the first ``SINGLE`` lanes' unvmapped calls."""
    from ..ops.linops import MatrixOperator, power_iteration_opnorm

    dev = device_of(device)
    As, _, _, Lfs = lassos(source, m, n, first=lanes)
    (A,) = _tensors(dev, As)

    def one(Ai):
        return power_iteration_opnorm(
            MatrixOperator(Ai), torch.zeros(Ai.shape[1], dtype=Ai.dtype,
                                            device=Ai.device)) ** 2

    est, wall = _timed(dev, lambda: torch.func.vmap(
        one, randomness="same")(A))
    loop = torch.stack([one(A[i]) for i in range(min(SINGLE, lanes))])
    return {"Lfs": est, "Lfs_exact": torch.as_tensor(Lfs, device=dev),
            "Lfs_looped": loop, "wall": wall}


# ---------------------------------------------------------------------------
# 2. sharded operators, 3. consensus


@contextlib.contextmanager
def process_group(dev):
    """The default process group; where none exists, a one-rank group of
    the device's backend (NCCL on the card, Gloo on the CPU) around the
    block."""
    import socket

    import torch.distributed as dist

    from ..parallel import initialize_distributed

    if dist.is_initialized():
        yield dist.get_world_size()
        return
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    initialize_distributed(f"localhost:{port}", 1, 0, device_type=dev.type)
    try:
        yield 1
    finally:
        dist.destroy_process_group()


def _rank_device(dev):
    import torch.distributed as dist

    if dev.type != "cuda":
        return dev
    rank = dist.get_rank()
    return torch.device("cuda", rank if torch.cuda.device_count() > rank
                        else 0)


def sharded_panoc(device="cuda"):
    """Block 5 (``:153-160``): ``spmd_worker.big_lasso()``'s A row-sharded
    over a ``("tp",)`` mesh of every rank, PANOC on ``f(Ax) + g(x)`` with
    ``f = ||. - b||^2 / 2``; beside it the unsharded PANOC."""
    from .. import PANOC
    from ..parallel import make_mesh, replicate, shard_matrix_operator
    from ..parallel.sharded_ops import full_tensor
    from ..prox import NormL1, SqrNormL2, Translate
    from ..tools.spmd_worker import big_lasso

    dev = device_of(device)
    A_np, b_np, lam, Lf = big_lasso()
    with process_group(dev) as ranks:
        dev = _rank_device(dev)
        A, b = _tensors(dev, A_np, b_np)
        x0 = torch.zeros(A.shape[1], dtype=torch.float64, device=dev)
        mesh = make_mesh((ranks,), ("tp",), dev.type)
        op = shard_matrix_operator(A, mesh, row_axis="tp")
        f = Translate(SqrNormL2(1.0), replicate(-b, mesh))
        (x, it), wall = _timed(dev, lambda: PANOC(tol=1e-6)(
            x0=replicate(x0, mesh), f=f, A=op, g=NormL1(lam), Lf=Lf))
        x = full_tensor(x)
        x_1, it_1 = PANOC(tol=1e-6)(x0=x0, f=Translate(SqrNormL2(1.0), -b),
                                    A=A, g=NormL1(lam), Lf=Lf)
    return {"x": x, "iterations": int(it), "x_unsharded": x_1,
            "iterations_unsharded": int(it_1), "ranks": ranks, "wall": wall}


def consensus(device="cuda", blocks=None):
    """Block 6 (``:183-189``): ``big_lasso(m=64, n=16)``'s rows in
    ``blocks`` equal blocks (default: one a rank), stacked, sharded over a
    ``("tp",)`` mesh of every rank, ``ConsensusADMM``; the all-reduces the
    sharded solve ran, and the unsharded solve beside it."""
    from ..parallel import ConsensusADMM, make_mesh, shard_batch, \
        stack_functions
    from ..parallel.sharded_ops import COLLECTIVES
    from ..prox import NormL1, make_least_squares
    from ..tools.spmd_worker import big_lasso

    dev = device_of(device)
    A_np, b_np, lam, _ = big_lasso(m=64, n=16)
    with process_group(dev) as ranks:
        dev = _rank_device(dev)
        count = ranks if blocks is None else blocks
        rows = A_np.shape[0] // count
        fs = stack_functions([make_least_squares(
            *_tensors(dev, A_np[i * rows:(i + 1) * rows],
                      b_np[i * rows:(i + 1) * rows])) for i in range(count)])
        mesh = make_mesh((ranks,), ("tp",), dev.type)
        x0 = torch.zeros(16, dtype=torch.float64, device=dev)
        before = COLLECTIVES["all_reduce"]
        (x, it), wall = _timed(dev, lambda: ConsensusADMM(tol=1e-7)(
            x0=x0, fs=shard_batch(fs, mesh, "tp"), g=NormL1(lam), gamma=1.0))
        reduces = COLLECTIVES["all_reduce"] - before
        x_1, it_1 = ConsensusADMM(tol=1e-7)(x0=x0, fs=fs, g=NormL1(lam),
                                            gamma=1.0)
    return {"x": x, "iterations": int(it), "x_unsharded": x_1,
            "iterations_unsharded": int(it_1), "ranks": ranks,
            "blocks": count, "all_reduces": reduces, "wall": wall}


# ---------------------------------------------------------------------------
# 4. matmul precision, warm starts


PRECISIONS = ("default", "high", "highest")  # block 7's call comes first


def matmul_precision(device="cuda", lanes=FLAGSHIP, source=LANES, m=M, n=N,
                     maxit=2000, reduced_maxit=None):
    """Block 7 (``:198-201``): ``pa.set_matmul_precision("default")`` as the
    text writes it, then the FISTA solve of the first ``lanes`` flagship
    lanes (float32, the generic driver: ``use_kernels=False``, whose
    matvecs go through ``pdot``) at each setting, ``"default"`` first;
    ``maxit`` at ``"highest"``, ``reduced_maxit`` (``maxit`` unless given)
    at the other two.  The caller's setting is put back after.  Beside it
    the guard of ``"highest"``: with ``allow_tf32`` switched on the same
    solve raises ``RuntimeError``, and the flag is restored."""
    import proxtpu_torch as pa

    from ..algorithms import make_fast_forward_backward_iteration
    from ..parallel import BatchedAlgorithm
    from ..prox import LeastSquaresLoss, NormL1

    tol = 1e-5
    dev = device_of(device)
    A, b, lam, Lf = _tensors(dev, *lassos(source, m, n, first=lanes,
                                          dtype=np.float32))

    def solve(cap):
        return BatchedAlgorithm(
            make_fast_forward_backward_iteration, maxit=cap, tol=tol,
            use_kernels=False)(
            x0=torch.zeros(lanes, n, device=dev), f=LeastSquaresLoss(A, b),
            g=NormL1(lam), Lf=Lf)

    flags = torch.backends.cuda.matmul
    torch_flags = (flags.allow_tf32, torch.get_float32_matmul_precision())
    saved = pa.get_matmul_precision()
    runs = {}
    try:
        previous = pa.set_matmul_precision("default")   # the block
        for setting in PRECISIONS:
            pa.set_matmul_precision(setting)
            cap = maxit if setting == "highest" else (reduced_maxit or maxit)
            (xs, iters, done), wall = _timed(dev, lambda: solve(cap))
            runs[setting] = {"xs": xs, "iters": iters, "done": done,
                             "wall": wall, "maxit": cap,
                             "recheck": fb_recheck(A, b, lam, Lf, xs)}
    finally:
        pa.set_matmul_precision(saved)
    message = None
    try:
        flags.allow_tf32 = True
        solve(maxit)
    except RuntimeError as e:
        message = str(e)
    finally:
        flags.allow_tf32 = torch_flags[0]
    return {"runs": runs, "tol": tol, "previous": previous, "saved": saved,
            "raised": message is not None, "message": message,
            "restored": (pa.get_matmul_precision() == saved and (
                flags.allow_tf32, torch.get_float32_matmul_precision())
                == torch_flags)}


def warm_start(device="cuda", lanes=FLAGSHIP, m=M, n=N):
    """Block 8 (``:210-215``): ``WarmStartedBatchedAlgorithm`` on
    ``Shared(LeastSquaresLoss(A, b))`` and ``lanes`` lambdas
    (``shared_lasso_problem``, float64 ``x0``); beside it the cold float64
    solve the block's "~4x" is against."""
    from ..algorithms import make_fast_forward_backward_iteration
    from ..parallel import BatchedAlgorithm, Shared, \
        WarmStartedBatchedAlgorithm
    from ..prox import LeastSquaresLoss, NormL1

    tol, maxit = 1e-8, 20_000
    dev = device_of(device)
    A_np, b_np, lams_np, Lf = _problems().shared_lasso_problem(
        lanes, m, n, np.float64)
    A, b, lams = _tensors(dev, A_np, b_np, lams_np)
    kw = dict(x0=torch.zeros(lanes, n, dtype=torch.float64, device=dev),
              f=Shared(LeastSquaresLoss(A, b)), g=NormL1(lams), Lf=Lf)
    solver = WarmStartedBatchedAlgorithm(
        make_fast_forward_backward_iteration, maxit=maxit, tol=tol)
    (xs, iters, done), wall = _timed(dev, lambda: solver(**kw))
    cold = BatchedAlgorithm(make_fast_forward_backward_iteration,
                            maxit=maxit, tol=tol)
    (xs_c, iters_c, done_c), wall_c = _timed(dev, lambda: cold(**kw))
    return {"xs": xs, "iters": iters, "done": done, "wall": wall,
            "xs_cold": xs_c, "iters_cold": iters_c, "done_cold": done_c,
            "wall_cold": wall_c, "tol": tol,
            "recheck": fb_recheck(A, b, lams, Lf, xs)}


# ---------------------------------------------------------------------------
# 5. the kernels, the shared design matrix


def kernel_solver(device="cuda", lanes=FLAGSHIP, source=LANES, m=M, n=N):
    """Block 9 (``:240-243``): ``solve_lasso_batch`` on the first ``lanes``
    flagship lanes in float32 (on the card ``fb_step`` for the first step,
    then ``fista_step``); beside it ``use_kernel=False``."""
    from ..kernels.lasso import solve_lasso_batch

    tol, maxit = 1e-5, 2000
    dev = device_of(device)
    data = lassos(source, m, n, first=lanes, dtype=np.float32)
    A, b, lam, Lf = _tensors(dev, *data)
    (z, iters, done), wall = _timed(dev, lambda: solve_lasso_batch(
        A, b, lam, Lf, tol=tol, maxit=maxit))
    z_p, iters_p, done_p = solve_lasso_batch(A, b, lam, Lf, tol=tol,
                                             maxit=maxit, use_kernel=False)
    return {"xs": z, "iters": iters, "done": done, "wall": wall,
            "xs_plain": z_p, "iters_plain": iters_p, "done_plain": done_p,
            "tol": tol, "recheck": fb_recheck(A, b, lam, Lf, z)}


def shared_design_matrix(device="cuda", lanes=FLAGSHIP, m=M, n=N):
    """Block 10 (``:365-374``): ``BatchedAlgorithm`` FISTA on
    ``Shared(LeastSquaresLoss(A, b))`` and ``lanes`` lambdas in float32
    (the shared-A leg: two matmuls a step); beside it the same lanes as
    stacked copies of A on the generic driver."""
    from ..algorithms import make_fast_forward_backward_iteration
    from ..parallel import BatchedAlgorithm, Shared
    from ..prox import LeastSquaresLoss, NormL1

    tol, maxit = 1e-5, 3000
    dev = device_of(device)
    A_np, b_np, lams_np, Lf = _problems().shared_lasso_problem(lanes, m, n)
    A, b, lams = _tensors(dev, A_np, b_np, lams_np)
    X0 = torch.zeros(lanes, n, device=dev)
    solver = BatchedAlgorithm(make_fast_forward_backward_iteration,
                              maxit=maxit, tol=tol)
    (xs, iters, done), wall = _timed(dev, lambda: solver(
        x0=X0, f=Shared(LeastSquaresLoss(A, b)), g=NormL1(lams), Lf=Lf))
    stacked = BatchedAlgorithm(make_fast_forward_backward_iteration,
                               maxit=maxit, tol=tol, use_kernels=False)
    (xs_s, iters_s, done_s), wall_s = _timed(dev, lambda: stacked(
        x0=X0, f=LeastSquaresLoss(A.expand(lanes, m, n).contiguous(),
                                  b.expand(lanes, m).contiguous()),
        g=NormL1(lams), Lf=torch.full((lanes,), Lf, device=dev)))
    return {"xs": xs, "iters": iters, "done": done, "wall": wall,
            "xs_stacked": xs_s, "iters_stacked": iters_s,
            "done_stacked": done_s, "wall_stacked": wall_s, "tol": tol,
            "recheck": fb_recheck(A, b, lams, Lf, xs)}


# ---------------------------------------------------------------------------
# 7. streaming dispatch


def streaming(device="cuda", payloads=PAYLOADS, lanes=FLAGSHIP,
              source=LANES, m=M, n=N):
    """Block 11 (``:428-438``): ``payloads`` batches of ``lanes`` flagship
    lanes (float32, lanes ``k * lanes`` on of block 1's) through
    ``stream_solve`` of ``solve_lasso_batch_packed(..., restart=True)`` at
    depth 2 (on the card ``fista_step`` from the first step); beside it the
    same calls one at a time, each fenced."""
    from ..kernels.lasso import solve_lasso_batch_packed
    from ..parallel import stream_solve

    tol = 1e-5
    dev = device_of(device)
    data = lassos(source, m, n, first=payloads * lanes,
                  dtype=np.float32)
    batches = [_tensors(dev, *(v[k * lanes:(k + 1) * lanes] for v in data))
               for k in range(payloads)]

    def solve(payload):
        A, b, lam, Lf = payload
        return solve_lasso_batch_packed(A, b, lam, Lf, tol, restart=True)

    streamed, wall = _timed(dev, lambda: list(
        stream_solve(solve, batches, depth=2)))
    fenced, wall_f = _timed(dev, lambda: [
        _timed(dev, lambda: solve(p))[0] for p in batches])
    return {"streamed": streamed, "fenced": fenced, "wall": wall,
            "wall_fenced": wall_f, "problems": payloads * lanes,
            "tol": tol, "rechecks": [fb_recheck(*p, out[0]) for p, out in
                                     zip(batches, streamed)]}


# ---------------------------------------------------------------------------
# testing multi-chip code without a pod


def multichip_dryrun(device="cuda", ranks=2, cases=("dryrun",)):
    """Block 12 (``:468-472``): ``ranks`` Gloo processes started by
    ``tools/spmd_worker.py``'s launcher from this process (on the card every
    rank shares ``cuda:0`` where there are fewer cards) running ``cases``,
    by default ``graft_entry.dryrun_multichip(ranks)``, whose asserts hold
    every sharded layout to its unsharded run (``("scaling",)``: blocks 5
    and 6 on those ranks too).  Returns each case's rank-0 outputs."""
    import argparse

    from ..tools import spmd_worker

    dev = device_of(device)
    with tempfile.TemporaryDirectory() as out:
        t0 = time.perf_counter()
        try:
            spmd_worker.launch(argparse.Namespace(
                ranks=ranks, backend="gloo", device=dev.type,
                cases=",".join(cases), out=out, timeout=DRYRUN_TIMEOUT_S))
        except SystemExit as e:
            raise RuntimeError(f"multichip dry run: {e}") from None
        wall = time.perf_counter() - t0
        with np.load(os.path.join(out, "spmd.npz")) as f:
            outputs = {k: f[k] for k in f.files}
    return {"outputs": outputs, "ranks": ranks, "wall": wall}


BLOCKS = {
    ("tpu_scaling.md", 1): scenario_batch,
    ("tpu_scaling.md", 2): vmapped_factory,
    ("tpu_scaling.md", 3): adaptive_backtracking,
    ("tpu_scaling.md", 4): power_iteration,
    ("tpu_scaling.md", 5): sharded_panoc,
    ("tpu_scaling.md", 6): consensus,
    ("tpu_scaling.md", 7): matmul_precision,
    ("tpu_scaling.md", 8): warm_start,
    ("tpu_scaling.md", 9): kernel_solver,
    ("tpu_scaling.md", 10): shared_design_matrix,
    ("tpu_scaling.md", 11): streaming,
    ("tpu_scaling.md", 12): multichip_dryrun,
}

# the sizes of the CPU tests (tests/test_torch_scaling_guide.py), at which
# examples.SCALING_JAX_ITERATIONS holds the JAX blocks' counts
SMALL = {
    1: dict(lanes=8, m=20, n=40),
    2: dict(lanes=8, m=20, n=40),
    3: dict(lanes=8, m=40, n=20),
    4: dict(lanes=8, source=8, m=20, n=40),
    5: dict(),
    6: dict(blocks=8),
    7: dict(lanes=8, source=8, m=20, n=40),
    8: dict(lanes=8, m=20, n=30),
    9: dict(lanes=5, source=5, m=16, n=24),
    10: dict(lanes=8, m=20, n=40),
    11: dict(payloads=2, lanes=16, source=32, m=16, n=24),
    12: dict(ranks=4, cases=("scaling",)),
}

# block 4's claim: power iteration is 0.5% accurate in ~50 iterations; on
# block 1's first 256 As the JAX block itself misses it on 95 lanes, by at
# most examples.SCALING_POWER_JAX_WORST, which the port is held to
OPNORM_CLAIM = 5e-3


def check(key, out):
    """Assert what block ``key``'s paragraph claims on its result ``out``:
    every lane done and rechecked (blocks 1, 3, 8-11; the recheck within
    2 tol, block 8 within 1.05 tol and 50 tol of the cold solve, as
    ``tests/test_warm.py``, or twice the JAX block's own gap at the
    block's scale, ``SCALING_WARM_JAX_GAP``); block 2 equal to block 1;
    the power iteration within 0.5% of ``||A||_2^2`` (or the JAX block's
    own worst error on block 1's As, ``SCALING_POWER_JAX_WORST``); the
    sharded PANOC and consensus at the unsharded counts, bit-equal on one
    rank, the consensus with two all-reduces an iteration; block 7's
    solve at ``"highest"`` done and within 2 tol, the setting and the
    flags put back, the raise of its guard (the doc's "stalls around
    1e-3" at ``"default"`` is a TPU figure, not held); block 11's stream
    in order and equal to the fenced calls."""
    i = key[1]
    if i in (1, 2, 3, 8, 9, 10):
        assert bool(out["done"].all()), out["iters"]
    if i == 1:
        worst = float(torch.cat([out["recheck"],
                                 out["recheck_single"]]).max())
        assert worst <= 2 * out["tol"], worst
    elif i == 2:
        for a in ("xs", "iters", "done"):
            assert torch.equal(out[a], out[f"{a}_1"]), a
    elif i == 4:
        from . import SCALING_POWER_JAX_WORST

        rel = (out["Lfs"] - out["Lfs_exact"]).abs() / out["Lfs_exact"]
        assert float(rel.max()) <= max(OPNORM_CLAIM,
                                       SCALING_POWER_JAX_WORST), rel
        k = out["Lfs_looped"].shape[0]
        gap = (out["Lfs"][:k] - out["Lfs_looped"]).abs() / out["Lfs_looped"]
        assert float(gap.max()) <= 1e-12, gap
    elif i in (5, 6):
        assert out["iterations"] == out["iterations_unsharded"], out
        if i == 6:  # the mean and the primal residual's max
            assert out["all_reduces"] == 2 * out["iterations"], out
        if out["ranks"] == 1:
            assert torch.equal(out["x"], out["x_unsharded"])
        else:
            gap = (out["x"] - out["x_unsharded"]).abs().max()
            assert float(gap) <= 1e-10, float(gap)
    elif i == 7:
        best = out["runs"]["highest"]
        assert bool(best["done"].all()), best["iters"]
        assert float(best["recheck"].max()) <= 2 * out["tol"], \
            best["recheck"].max()
        assert out["previous"] == out["saved"], out["previous"]
        assert out["raised"] and "TF32" in out["message"], out
        assert out["restored"]
    elif i == 8:
        from . import SCALING_WARM_JAX_GAP

        tol = out["tol"]
        assert bool(out["done_cold"].all())
        assert float(out["recheck"].max()) <= 1.05 * tol
        gap = (out["xs"] - out["xs_cold"]).abs().max()
        assert float(gap) <= max(50 * tol, 2 * SCALING_WARM_JAX_GAP), \
            float(gap)
    elif i in (9, 10):
        assert float(out["recheck"].max()) <= 2 * out["tol"], \
            out["recheck"].max()
    elif i == 11:
        assert len(out["streamed"]) == len(out["fenced"])
        for got, want in zip(out["streamed"], out["fenced"]):
            for g, w in zip(got, want):
                assert torch.equal(g, w)
            assert bool(got[2].all())
        worst = max(float(r.max()) for r in out["rechecks"])
        assert worst <= 2 * out["tol"], worst
    elif i == 12:
        assert "dryrun__ran" in out["outputs"], sorted(out["outputs"])
