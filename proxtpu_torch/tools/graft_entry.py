"""Entry points of the port: one batched step, and a dry run of the sharded
layouts (counterparts of ``__graft_entry__.py``'s ``entry`` and
``dryrun_multichip``).

``entry()`` returns one vmapped FISTA step on the flagship workload's
batched solver (a batch of lasso instances) and its example arguments, on
the card unless the caller asks for the CPU (``entry("cpu")``); with no
card it raises.

``dryrun_multichip(n)`` builds an n-rank ``("dp", "tp")`` mesh over the
default process group (``initialize_distributed`` first; every rank calls
it) and runs three steps of each sharded layout, holding every result
against a run of the same steps without a mesh:

* dp: a scenario batch sharded over ``dp``, each rank stepping its lanes;
* tp: a big single problem's A row-sharded over ``tp`` under PANOC, so the
  step's ``A^H grad`` is a local product and an all-reduce;
* consensus blocks sharded over ``tp`` (the mean all-reduce);
* the fused one-step lasso solver, a ``Shared`` operand, the flat ZeroFPR
  machine and ``halt_nonfinite`` on dp lanes;
* dp x tp: the same ``Shared`` operand in row stripes over ``tp`` inside
  the dp lanes, its products ending in one all-reduce over ``tp`` a step.
"""

from __future__ import annotations

import numpy as np
import torch

STEPS = 3  # let any partitioning divergence compound before comparing


def _lasso_batch_iteration(batch, m, n, dtype, device="cuda"):
    from ..algorithms import make_fast_forward_backward_iteration
    from ..parallel import batch_problems
    from ..prox import LeastSquaresLoss, NormL1

    rng = np.random.default_rng(0)
    problems = []
    for _ in range(batch):
        A = (rng.standard_normal((m, n)) / np.sqrt(m)).astype(dtype)
        b = rng.standard_normal(m).astype(dtype)
        lam = 0.1 * float(np.max(np.abs(A.T @ b)))
        Lf = float(np.linalg.norm(A, 2) ** 2)
        t = lambda v: torch.as_tensor(v, device=device)  # noqa: E731
        # per-problem numbers go in as tensors (see stack_iterations)
        problems.append(dict(
            x0=torch.zeros(n, dtype=t(A).dtype, device=device),
            f=LeastSquaresLoss(t(A), t(b)),
            g=NormL1(t(np.asarray(lam, dtype))),
            Lf=t(np.asarray(Lf, dtype))))
    return batch_problems(make_fast_forward_backward_iteration, problems)


def entry(device="cuda"):
    """``(fn, example_args)``: one vmapped FISTA step on a 64-problem
    batch (128 x 256, float32) on ``device``; a CUDA device and no card
    raise ``RuntimeError`` (no fallback to the CPU)."""
    from ..parallel.batch import _Lanes

    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "entry: no CUDA device; the entry point runs on the card unless "
            "the caller asks for the CPU (entry('cpu'))")

    iteration = _lasso_batch_iteration(64, 128, 256, np.float32, device)
    state = _Lanes(iteration, 0.0).init()

    def fn(it, s):
        return _Lanes(it, 0.0).step(s)

    return fn, (iteration, state)


def _steps(iteration, steps=STEPS):
    """init and ``steps`` steps of a batched iteration on this rank's lanes;
    the state's per-lane tensors back on the mesh as they came in."""
    from ..parallel.batch import _Lanes
    from ..parallel.sharded_ops import localize, place_lanes

    local, lanes = localize(iteration, stripes=True)
    run = _Lanes(local, 0.0)
    s = run.init()
    for _ in range(steps):
        s = run.step(s)
    return s if lanes is None else place_lanes(s, *lanes)


def _close(a, b, what):
    """Sharded against unsharded: within float32's reduce-order slack."""
    from ..parallel.sharded_ops import full_tensor
    from ..utils.tree import tree_leaves

    for la, lb in zip(tree_leaves(a), tree_leaves(b)):
        da = full_tensor(la).detach().cpu().double().numpy()
        db = full_tensor(lb).detach().cpu().double().numpy()
        err = np.max(np.abs(da - db)) if da.size else 0.0
        scale = 1.0 + np.max(np.abs(db)) if db.size else 1.0
        assert err <= 1e-4 * scale, (
            f"{what}: sharded/replicated mismatch {err:.3e} "
            f"(scale {scale:.3e})")


def dryrun_multichip(n_devices, device_type="cuda"):
    """Run three steps of each sharded layout over an ``n_devices``-rank
    ``("dp", "tp")`` mesh and assert that sharding does not change the
    numbers: every sharded output matches an unsharded run of the same
    steps.  Every rank of the default process group calls it; rank r works
    on ``cuda:r``, or ``cuda:0`` where the ranks share one card."""
    import torch.distributed as dist

    from ..algorithms import (
        make_fast_forward_backward_iteration,
        make_panoc_iteration,
    )
    from ..kernels.lasso import solve_lasso_batch
    from ..ops.linops import MatrixOperator
    from ..parallel import (
        Shared,
        batched_run_loop,
        batched_zerofpr,
        broadcast_hyperparams,
        make_mesh,
        shard_batch,
        shard_matrix_operator,
        sharded_solve_lasso_batch,
        stack_functions,
    )
    from ..parallel.consensus import make_consensus_admm_iteration
    from ..parallel.sharded_ops import block, full_tensor, shard_rows
    from ..prox import (
        LeastSquaresLoss,
        NormL1,
        SqrDistance,
        SqrNormL2,
        Translate,
        make_least_squares,
    )

    dp = max(1, n_devices // 2)
    tp = n_devices // dp
    mesh = make_mesh((dp, tp), ("dp", "tp"), device_type=device_type)
    if device_type == "cuda":
        cards = torch.cuda.device_count()
        device = torch.device(
            "cuda", dist.get_rank() if cards >= n_devices else 0)
    else:
        device = torch.device("cpu")
    dtype = np.float32
    rng = np.random.default_rng(0)
    t = lambda v: torch.as_tensor(v, device=device)  # noqa: E731

    # --- dp: a scenario batch sharded over dp (non-toy lanes)
    batch_host = _lasso_batch_iteration(4 * dp, 64, 128, dtype, device)
    bs_s = _steps(shard_batch(batch_host, mesh, "dp"))
    bs = _steps(batch_host)
    _close(bs_s.z, bs.z, "dp-sharded batch iterate")

    # --- tp: one big problem (m = 256 * tp rows), A row-sharded; PANOC
    # with L-BFGS: the adjoint matvec is a local product and an all-reduce
    m, n = 256 * tp, 96
    A = (rng.standard_normal((m, n)) / np.sqrt(m)).astype(dtype)
    b = t(rng.standard_normal(m).astype(dtype))
    fo = Translate(SqrNormL2(1.0), -b)
    Lf = float(np.linalg.norm(A, 2) ** 2)

    def panoc_steps(op):
        it = make_panoc_iteration(x0=torch.zeros(n, dtype=b.dtype,
                                                 device=device),
                                  f=fo, A=op, g=NormL1(0.1), Lf=Lf)
        s = it.init()
        for _ in range(STEPS):
            s = it.step(s)
        return s

    ts_s = panoc_steps(shard_matrix_operator(t(A), mesh, row_axis="tp"))
    ts = panoc_steps(MatrixOperator(t(A)))
    _close(ts_s.z, ts.z, "tp row-sharded PANOC iterate")

    # --- consensus: row blocks sharded over tp, the mean all-reduce
    blocks = [make_least_squares(t(rng.standard_normal((32, n))
                                   .astype(dtype)),
                                 t(rng.standard_normal(32).astype(dtype)))
              for _ in range(tp)]
    stacked = stack_functions(blocks)

    def consensus_steps(fs):
        it = make_consensus_admm_iteration(
            x0=torch.zeros(n, dtype=b.dtype, device=device), fs=fs,
            g=NormL1(0.1), gamma=1.0)
        s = it.init()
        for _ in range(STEPS):
            s = it.step(s)
        return s

    cs_s = consensus_steps(shard_batch(stacked, mesh, "tp"))
    cs = consensus_steps(stacked)
    _close(cs_s.z, cs.z, "consensus point")
    # this rank's blocks against the same blocks of the unsharded run
    _close(cs_s.x, block(cs.x, mesh, "tp"), "consensus iterate")

    # --- the fused one-step lasso solver on dp lanes against the plain
    # route on one rank
    Bk, mk, nk = 2 * dp, 16, 24
    Ak = (rng.standard_normal((Bk, mk, nk)) / np.sqrt(mk)).astype(dtype)
    bk = rng.standard_normal((Bk, mk)).astype(dtype)
    lamk = (0.1 * np.max(np.abs(np.einsum("bmn,bm->bn", Ak, bk)), axis=1)
            ).astype(dtype)
    Lfk = np.array([np.linalg.norm(Ak[i], 2) ** 2 for i in range(Bk)],
                   dtype)
    zk_s, itk_s, dk_s = sharded_solve_lasso_batch(
        t(Ak), t(bk), t(lamk), t(Lfk), 1e-5, mesh=mesh, axis="dp",
        maxit=2000, use_kernel=True)
    zk_r, itk_r, dk_r = solve_lasso_batch(
        t(Ak), t(bk), t(lamk), t(Lfk), 1e-5, maxit=2000, use_kernel=False)
    assert bool(full_tensor(dk_s).all()) and bool(dk_r.all())
    _close(zk_s, zk_r, "dp-sharded fused-kernel lasso solve")
    assert int((full_tensor(itk_s) - itk_r).abs().max()) <= 1, \
        "dp-sharded kernel iteration counts diverged"

    # --- a Shared (lane-invariant) operand with dp lanes: the design
    # matrix replicated, the lanes' data sharded
    Bs, ms, ns = 4 * dp, 48, 64
    As = t((rng.standard_normal((ms, ns)) / np.sqrt(ms)).astype(dtype))
    bsh = t(rng.standard_normal(ms).astype(dtype))
    lams = t((0.1 + 0.2 * rng.random(Bs)).astype(dtype))
    Lfs = float(np.linalg.norm(As.cpu().numpy(), 2) ** 2)
    sh_host = broadcast_hyperparams(make_fast_forward_backward_iteration(
        x0=torch.zeros((Bs, ns), dtype=As.dtype, device=device),
        f=Shared(LeastSquaresLoss(As, bsh)), g=NormL1(lams),
        Lf=torch.full((Bs,), Lfs, dtype=As.dtype, device=device)))
    rep_z = _steps(sh_host).z
    _close(_steps(shard_batch(sh_host, mesh, "dp")).z, rep_z,
           "Shared-operand dp-sharded batch")

    # --- dp x tp: the same Shared operand in row stripes over tp (48 / tp
    # rows a rank), the lanes over dp; the step's products end in one
    # all-reduce over tp
    _close(_steps(shard_batch(shard_rows(sh_host, mesh, "tp"), mesh,
                              "dp")).z, rep_z,
           "dp x tp Shared-operand batch (A in row stripes over tp, dp "
           "lanes)")

    # --- the flat ZeroFPR machine on dp lanes
    Bf, mf_, nf = 4 * dp, 32, 48
    Af = (rng.standard_normal((Bf, mf_, nf)) / np.sqrt(mf_)).astype(dtype)
    bf = rng.standard_normal((Bf, mf_)).astype(dtype)
    lamf = 0.1 * np.max(np.abs(np.einsum("bmn,bm->bn", Af, bf)), axis=1)
    Lff = np.array([np.linalg.norm(Af[i], 2) ** 2 for i in range(Bf)],
                   dtype)
    flat = (SqrDistance(t(bf)), MatrixOperator(t(Af)),
            NormL1(t(lamf.astype(dtype))), torch.zeros(
                (Bf, nf), dtype=torch.float32, device=device),
            t(0.95 / Lff))
    zf_r, kf_r, df_r = batched_zerofpr(*flat, 1e-5, maxit=500)
    zf_s, kf_s, df_s = batched_zerofpr(*shard_batch(flat, mesh, "dp"),
                                       1e-5, maxit=500)
    assert bool(full_tensor(df_s).all()), "flat dp-sharded lanes converged"
    assert int((full_tensor(kf_s) - kf_r).abs().max()) <= 1, \
        "flat dp-sharded iteration counts diverged"
    _close(zf_s, zf_r, "flat ZeroFPR dp-sharded solve")

    # --- halt_nonfinite on dp lanes: one poisoned lane (Lf too small)
    # dies on the sharded run as on the unsharded one
    Lf_bad = Lff.copy()
    Lf_bad[1] /= 1e3
    hn_host = make_fast_forward_backward_iteration(
        x0=torch.zeros((Bf, nf), dtype=torch.float32, device=device),
        f=LeastSquaresLoss(t(Af), t(bf)),
        g=NormL1(t(lamf.astype(dtype))), gamma=t(1.0 / Lf_bad))
    xs_r, it_r, dn_r = batched_run_loop(hn_host, 500, 1e-5,
                                        halt_nonfinite=True)
    xs_s, it_s, dn_s = batched_run_loop(shard_batch(hn_host, mesh, "dp"),
                                        500, 1e-5, halt_nonfinite=True)
    dn_s, xs_s = full_tensor(dn_s), full_tensor(xs_s)
    assert not bool(dn_s[1]), "poisoned lane must be dead"
    assert bool(dn_s[0]), "healthy lanes must converge"
    assert torch.equal(dn_s, dn_r), "dead/done pattern diverged"
    assert bool(torch.isfinite(xs_s[1]).all()), \
        "dead lane must freeze at its last finite iterate"
    _close(xs_s[dn_r], xs_r[dn_r], "halt_nonfinite dp-sharded healthy lanes")
