"""Drive the PyTorch port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:

1. identify the card (there is no CPU path: no CUDA device is an error);
2. build the CUDA kernels from ``proxtpu_torch/csrc`` (first use);
3. hold each kernel against its plain PyTorch version on the card at the
   main path's shapes and a ragged one, then time both;
4. run the main path at full size: 256 distinct-A lasso problems of
   200 x 400 (``bench.gen_problems``, seed 0) through
   ``solve_lasso_batch_packed_tail(restart=True, k1=192, tail=64)``, drained
   by ``stream_solve`` at depth 2, with a host residual recheck, the kernels'
   launch counts, and a cross-check against the plain route;
5. drive the library route, ``BatchedAlgorithm`` -> ``match_kernel_solver``,
   at full width, on the kernel route and on the plain route
   (``use_kernels=False``), with every lane done on both, a host recheck
   and the launch counts of each route's kernels:
   (a) lasso 64 x 512 x 1024 (``benchmarks/kernel_sweep.py``, seed 0, 2 MB
       of A per lane): the blocked solver, ``fb_step`` then
       ``fista_k_steps``; once more with adaptive restart;
   (b) nonconvex box QP, n = 512, B = 64 (``benchmarks/families_bench.py``'s
       family, rng 7, 1 MB of Q per lane): ``pg_step`` then ``pg_k_steps``;
   (c) the flagship 256 x 200 x 400: the packed solver, ``fista_step``;
   (d) 256 tall 400 x 200 lasso problems with the strong-convexity modulus
       ``mf``: ``fb_step`` then ``fista_step`` with a constant beta;
6. print the kernels' JSON line, then the result line.

Imports no JAX.  Needs one card, ``nvcc`` (CUDA_HOME) and a few minutes.
"""

import json
import statistics
import subprocess
import time

import numpy as np
import torch

DEVICE = "cuda"
TOL = 1e-5
MAXIT = 2000
N_STREAM = 6
MAIN_SHAPES = [(256, 200, 400), (64, 200, 400)]  # bulk phase, narrow tail
# fb_step and fista_step at every shape a path gives them: the main path's,
# route (a)'s first step (64 x 512 x 1024), route (d)'s tall 400 x 200
# (route (c) is MAIN_SHAPES[0]), and a ragged M and N
CHECK_SHAPES = MAIN_SHAPES + [(64, 512, 1024), (256, 400, 200), (7, 33, 161)]
# One step against its plain version.  Both sum 200- to 1024-term f32
# products in different orders (warp shuffles vs cuBLAS), so each output
# carries a few ulps of its largest partial sums: iterates and residuals
# are O(1) here, so 1e-5 absolute is ~100 ulps of headroom.  rs sums up to
# 1024 such products of O(1) differences and can reach O(10), so it is
# held relative to its size.
ATOL = 1e-5
RS_RTOL = 1e-4
# K = 8 steps against the plain version.  Each step carries the one-step
# difference above into the next; on these inputs the plain version in f32
# sits up to 4.5e-6 from the same eight steps in f64 (iterates up to ~10),
# so two f32 versions are held to 5e-5, ten times that.
K = 8
ATOL_K = 5e-5
BLOCKED_SHAPES = [(64, 512, 1024), (7, 33, 161)]  # route (a), ragged
BOX_SHAPES = [(64, 512), (7, 161)]                # route (b), ragged
SMALL_LASSO = (1024, 64, 128)  # kernel_sweep.py:22, sent to XLA on a v5e
SMALL_BOX = (256, 128)         # dispatch.py:767-770, sent to XLA on a v5e


def run(cmd):
    return subprocess.run(cmd, capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip()


def phase_identify():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; the port's smoke test "
                         "runs only on a GPU")
    card = run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"]).splitlines()[0]
    print(card)
    from torch.utils.cpp_extension import CUDA_HOME
    nvcc = run([f"{CUDA_HOME}/bin/nvcc", "--version"]).splitlines()[-1]
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"nvcc {nvcc}, device 0: {torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} device(s)")
    return card


def phase_build():
    from proxtpu_torch.kernels import _build

    t0 = time.perf_counter()
    _build.library()
    dt = time.perf_counter() - t0
    print(f"build: {dt:.2f} s into {_build.build_dir()}")
    log = _build.build_dir() / "nvcc.log"
    if log.exists():
        print(log.read_text().strip())


def step_inputs(B, M, N, seed):
    rng = np.random.default_rng(seed)
    A = (rng.standard_normal((B, M, N)) / np.sqrt(M)).astype(np.float32)
    Lf = np.array([np.linalg.norm(a, 2) ** 2 for a in A], np.float32)
    gamma = 1.0 / Lf
    arrays = dict(
        A=A,
        b=rng.standard_normal((B, M)).astype(np.float32),
        x=rng.standard_normal((B, N)).astype(np.float32),
        z_prev=rng.standard_normal((B, N)).astype(np.float32),
        beta=rng.uniform(0.1, 0.9, B).astype(np.float32),
        gamma=gamma.astype(np.float32),
        thr=(gamma * rng.uniform(0.05, 0.5, B)).astype(np.float32),
        shrink=(1.0 + gamma * 0.3).astype(np.float32),
        done=(rng.random(B) < 0.5).astype(np.float32),
    )
    return {k: torch.tensor(v, device=DEVICE) for k, v in arrays.items()}


def max_err(got, want):
    return float((got - want).abs().max())


def check_kernels():
    """Every variant against the plain version at every check shape;
    returns the largest absolute error of z, x+ and res per kernel."""
    from proxtpu_torch.kernels import lasso as tl

    worst = {"fb_step": 0.0, "fista_step": 0.0}
    for B, M, N in CHECK_SHAPES:
        d = step_inputs(B, M, N, seed=B + M + N)
        for shrink in (None, d["shrink"]):
            args = (d["A"], d["b"], d["x"], d["gamma"], d["thr"])
            z_k, r_k = tl.fused_fb_prox_grad(*args, shrink=shrink)
            z_p, r_p = tl.reference_fb_prox_grad(*args, shrink=shrink)
            torch.cuda.synchronize()
            err = max(max_err(z_k, z_p), max_err(r_k, r_p))
            assert err <= ATOL, (B, M, N, shrink is not None, err)
            worst["fb_step"] = max(worst["fb_step"], err)
            print(f"  fb_step    {(B, M, N)} shrink={shrink is not None}: "
                  f"max|err| {err:.3e}")
            for restart in (False, True):
                for done in (torch.zeros_like(d["done"]), d["done"]):
                    rest = (d["beta"], d["gamma"], d["thr"], done)
                    want = tl.reference_fista_full_step(
                        d["A"], d["b"], d["x"], d["z_prev"], *rest,
                        shrink=shrink, restart=restart)
                    got = tl.fused_fista_full_step(
                        d["A"], d["b"], d["x"].clone(), d["z_prev"].clone(),
                        *rest, shrink=shrink, restart=restart)
                    torch.cuda.synchronize()
                    err = max(max_err(g, w) for g, w in
                              zip(got[:3], want[:3]))
                    rs_err = float(((got[3] - want[3]).abs()
                                    / (1 + want[3].abs())).max())
                    assert err <= ATOL and rs_err <= RS_RTOL, (
                        B, M, N, restart, err, rs_err)
                    frozen = done != 0
                    assert torch.equal(got[0][frozen], d["x"][frozen])
                    worst["fista_step"] = max(worst["fista_step"], err)
                    print(f"  fista_step {(B, M, N)} shrink="
                          f"{shrink is not None} restart={restart} "
                          f"frozen={int(frozen.sum())}: max|err| {err:.3e}, "
                          f"rs rel {rs_err:.3e}")
    return worst


def time_ms(fn, reps=20, inner=10):
    """``reps`` samples of one step's time in ms, each from CUDA events
    around ``inner`` back-to-back calls, after a warm-up.  This is the
    step's cost in an eager loop: the device's time, or the host's where
    the host cannot keep up.  A is not flushed from L2 between calls: the
    solver reads the same A on every iteration."""
    for _ in range(3):
        fn()
    ts = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        ts.append(start.elapsed_time(end) / inner)
    return ts


def time_kernels(card):
    """Kernel vs plain version at the main path's shapes; returns the
    flagship-shape medians per kernel."""
    from proxtpu_torch.kernels import lasso as tl

    flagship = {}
    for B, M, N in MAIN_SHAPES:
        d = step_inputs(B, M, N, seed=1)
        live = torch.zeros_like(d["done"])
        fb = (d["A"], d["b"], d["x"], d["gamma"], d["thr"])
        full = (d["A"], d["b"], d["x"], d["z_prev"], d["beta"], d["gamma"],
                d["thr"], live)
        x, zp = d["x"].clone(), d["z_prev"].clone()
        pairs = {
            "fb_step": (lambda: tl.fused_fb_prox_grad(*fb),
                        lambda: tl.reference_fb_prox_grad(*fb)),
            "fista_step": (
                lambda: tl.fused_fista_full_step(
                    d["A"], d["b"], x, zp, *full[4:], restart=True),
                lambda: tl.reference_fista_full_step(*full, restart=True)),
        }
        gb = B * M * N * 4 / 1e9
        for name, (kernel, plain) in pairs.items():
            # plain, kernel, kernel, plain: a drift in clocks shows as a
            # difference between the two runs of one side
            p1, k1, k2, p2 = (time_ms(plain), time_ms(kernel),
                              time_ms(kernel), time_ms(plain))
            k, p = statistics.median(k1 + k2), statistics.median(p1 + p2)
            print(f"  {name:10s} {(B, M, N)}: kernel {1e3 * k:.1f} us "
                  f"(runs {1e3 * statistics.median(k1):.1f} / "
                  f"{1e3 * statistics.median(k2):.1f}), plain "
                  f"{1e3 * p:.1f} us (runs {1e3 * statistics.median(p1):.1f}"
                  f" / {1e3 * statistics.median(p2):.1f}) per step; A read "
                  f"once = {gb / (k * 1e-3):.0f} GB/s kernel, "
                  f"{gb / (p * 1e-3):.0f} GB/s plain  [{card}]")
            if (B, M, N) == MAIN_SHAPES[0]:
                flagship[name] = (k, p)
    return flagship


def box_inputs(B, n, seed):
    """Random symmetric Q (eigenvalues within about [-1, 1]), q, x in the
    box, gamma = 0.95 / ||Q||, bounds +-1, half the lanes frozen."""
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((B, n, n))
    Q = ((G + G.transpose(0, 2, 1)) / (2 * np.sqrt(2 * n))).astype(np.float32)
    L = np.abs(np.linalg.eigvalsh(Q.astype(np.float64))).max(axis=1)
    arrays = dict(
        Q=Q,
        q=rng.standard_normal((B, n)).astype(np.float32),
        x=rng.uniform(-1, 1, (B, n)).astype(np.float32),
        gamma=(0.95 / L).astype(np.float32),
        lo=np.full(B, -1.0, np.float32),
        hi=np.full(B, 1.0, np.float32),
        done=(rng.random(B) < 0.5).astype(np.float32),
    )
    return {k: torch.tensor(v, device=DEVICE) for k, v in arrays.items()}


def check_new_kernels():
    """fista_k_steps, pg_step and pg_k_steps against their plain versions
    at the library route's shapes and a ragged one, restart on and off,
    with and without frozen lanes; frozen lanes come back bit-equal.
    Returns the largest absolute error per kernel."""
    from proxtpu_torch.kernels import box_qp as tb
    from proxtpu_torch.kernels import lasso as tl

    worst = {"fista_k_steps": 0.0, "pg_step": 0.0, "pg_k_steps": 0.0}
    for B, M, N in BLOCKED_SHAPES:
        d = step_inputs(B, M, N, seed=B + M + N)
        t0 = torch.tensor(np.random.default_rng(B).uniform(1, 5, B)
                          .astype(np.float32), device=DEVICE)
        for restart in (False, True):
            for done in (torch.zeros_like(d["done"]), d["done"]):
                args = (d["A"], d["b"], d["x"], d["z_prev"], t0, d["gamma"],
                        d["thr"], done)
                want = tl.reference_fista_k_steps(*args, K=K,
                                                  restart=restart)
                got = tl.fused_fista_k_steps(
                    d["A"], d["b"], d["x"].clone(), d["z_prev"].clone(),
                    t0.clone(), d["gamma"], d["thr"], done, K=K,
                    restart=restart)
                torch.cuda.synchronize()
                err = max(max_err(g, w) for g, w in zip(got, want))
                assert err <= ATOL_K, (B, M, N, restart, err)
                frozen = done != 0
                for g, w in zip(got[:3], (d["x"], d["z_prev"], t0)):
                    assert torch.equal(g[frozen], w[frozen])
                assert bool((got[3][frozen] == 0).all())
                worst["fista_k_steps"] = max(worst["fista_k_steps"], err)
                print(f"  fista_k_steps {(B, M, N)} K={K} restart={restart}"
                      f" frozen={int(frozen.sum())}: max|err| {err:.3e}")
    for B, n in BOX_SHAPES:
        d = box_inputs(B, n, seed=B + n)
        for done in (torch.zeros_like(d["done"]), d["done"]):
            frozen = done != 0
            rest = (d["gamma"], d["lo"], d["hi"])
            z_p, r_p = tb.reference_pg_box_step(d["Q"], d["q"], d["x"],
                                                *rest)
            z_p = torch.where(frozen[:, None], d["x"], z_p)
            r_p = torch.where(frozen, 0.0, r_p)
            z_k, r_k = tb.fused_pg_box_step(d["Q"], d["q"], d["x"].clone(),
                                            *rest, done)
            x_p, s_p = tb.reference_pg_box_k_steps(d["Q"], d["q"], d["x"],
                                                   *rest, done, K=K)
            x_k, s_k = tb.fused_pg_box_k_steps(d["Q"], d["q"],
                                               d["x"].clone(), *rest, done,
                                               K=K)
            torch.cuda.synchronize()
            e1 = max(max_err(z_k, z_p), max_err(r_k, r_p))
            eK = max(max_err(x_k, x_p), max_err(s_k, s_p))
            assert e1 <= ATOL and eK <= ATOL_K, (B, n, e1, eK)
            for x_got in (z_k, x_k):
                assert torch.equal(x_got[frozen], d["x"][frozen])
            worst["pg_step"] = max(worst["pg_step"], e1)
            worst["pg_k_steps"] = max(worst["pg_k_steps"], eK)
            print(f"  pg_step / pg_k_steps {(B, n)} K={K} "
                  f"frozen={int(frozen.sum())}: max|err| {e1:.3e} / "
                  f"{eK:.3e}")
    return worst


def time_pair(name, kernel, plain, label, card, nbytes):
    """Plain, kernel, kernel, plain; returns the medians (ms) and prints
    them with the rate of ``nbytes`` read once per call."""
    p1, k1, k2, p2 = (time_ms(plain, reps=10), time_ms(kernel, reps=10),
                      time_ms(kernel, reps=10), time_ms(plain, reps=10))
    k, p = statistics.median(k1 + k2), statistics.median(p1 + p2)
    gb = nbytes / 1e9
    print(f"  {name:13s} {label}: kernel {1e3 * k:.1f} us (runs "
          f"{1e3 * statistics.median(k1):.1f} / "
          f"{1e3 * statistics.median(k2):.1f}), plain {1e3 * p:.1f} us "
          f"(runs {1e3 * statistics.median(p1):.1f} / "
          f"{1e3 * statistics.median(p2):.1f}) per call; "
          f"{gb / (k * 1e-3):.0f} GB/s kernel, {gb / (p * 1e-3):.0f} GB/s "
          f"plain  [{card}]")
    return k, p


def time_new_kernels(card):
    """The new kernels against their plain versions at the library route's
    shapes, and the one-step kernels at the small shapes the reference sent
    to XLA on a v5e (dispatch.py:668-676, :767-771), all lanes live.
    Returns the route-shape medians per kernel."""
    from proxtpu_torch.kernels import box_qp as tb
    from proxtpu_torch.kernels import lasso as tl

    out = {}
    B, M, N = BLOCKED_SHAPES[0]
    d = step_inputs(B, M, N, seed=1)
    live = torch.zeros_like(d["done"])
    t0 = torch.ones_like(d["beta"])
    x, zp, t = d["x"].clone(), d["z_prev"].clone(), t0.clone()
    out["fista_k_steps"] = time_pair(
        "fista_k_steps",
        lambda: tl.fused_fista_k_steps(d["A"], d["b"], x, zp, t, d["gamma"],
                                       d["thr"], live, K=K, restart=True),
        lambda: tl.reference_fista_k_steps(
            d["A"], d["b"], d["x"], d["z_prev"], t0, d["gamma"], d["thr"],
            live, K=K, restart=True),
        f"{(B, M, N)} K={K}", card, K * B * M * N * 4)
    B, n = BOX_SHAPES[0]
    d = box_inputs(B, n, seed=1)
    live = torch.zeros_like(d["done"])
    rest = (d["gamma"], d["lo"], d["hi"])
    x = d["x"].clone()
    out["pg_step"] = time_pair(
        "pg_step",
        lambda: tb.fused_pg_box_step(d["Q"], d["q"], x, *rest, live),
        lambda: tb.reference_pg_box_step(d["Q"], d["q"], d["x"], *rest),
        f"{(B, n)}", card, B * n * n * 4)
    out["pg_k_steps"] = time_pair(
        "pg_k_steps",
        lambda: tb.fused_pg_box_k_steps(d["Q"], d["q"], x, *rest, live, K),
        lambda: tb.reference_pg_box_k_steps(d["Q"], d["q"], d["x"], *rest,
                                            live, K),
        f"{(B, n)} K={K}", card, K * B * n * n * 4)
    print("  small shapes (the reference's XLA routes on a v5e):")
    B, M, N = SMALL_LASSO
    d = step_inputs(B, M, N, seed=2)
    live = torch.zeros_like(d["done"])
    x, zp = d["x"].clone(), d["z_prev"].clone()
    full = (d["beta"], d["gamma"], d["thr"], live)
    time_pair("fista_step",
              lambda: tl.fused_fista_full_step(d["A"], d["b"], x, zp, *full,
                                               restart=True),
              lambda: tl.reference_fista_full_step(
                  d["A"], d["b"], d["x"], d["z_prev"], *full, restart=True),
              f"{(B, M, N)}", card, B * M * N * 4)
    B, n = SMALL_BOX
    d = box_inputs(B, n, seed=3)
    live = torch.zeros_like(d["done"])
    rest = (d["gamma"], d["lo"], d["hi"])
    x = d["x"].clone()
    time_pair("pg_step",
              lambda: tb.fused_pg_box_step(d["Q"], d["q"], x, *rest, live),
              lambda: tb.reference_pg_box_step(d["Q"], d["q"], d["x"],
                                               *rest),
              f"{(B, n)}", card, B * n * n * 4)
    return out


def recheck(As, bs, lams, Lfs, xs):
    """bench.py's residual recheck: the f32 FB residual of every lane."""
    gam = (1.0 / Lfs)[:, None]
    grad = np.einsum("bmn,bm->bn", As, np.einsum("bmn,bn->bm", As, xs) - bs)
    y = xs - gam * grad
    z = np.sign(y) * np.maximum(np.abs(y) - gam * lams[:, None], 0.0)
    return float(np.max(np.max(np.abs(xs - z), axis=1) / gam[:, 0]))


def check_contract_small():
    """The reference's cross-path contract, kernel route vs plain route on
    the card, at the reference tests' shapes, where the JAX package holds
    it itself (tests/test_kernels.py:49-61, :94-149, :218-266): every lane
    done, counts within +-1, solutions within 1e-4.  The blocked solvers,
    whose counts are sampled every K, are held at the shapes of the
    reference's blocked tests (:218-266) to +-K and 1e-4, and on each route
    to the reference's blocked contract: counts no lower than the one-step
    solver's less 1 (FISTA's residual is not monotone, so a sampled count
    is an upper bound, not one within K), solutions within 5e-4 (lasso) and
    2e-3 (box QP) of the one-step solver's."""
    from proxtpu_torch import box_qp_from_numpy, problems_from_numpy
    from proxtpu_torch.kernels import box_qp as tb
    from proxtpu_torch.kernels import lasso as tl

    def hold(name, shape, kw, kernel, plain, slack):
        z1, i1, d1 = kernel
        z2, i2, d2 = plain
        assert bool(d1.all()) and bool(d2.all()), (name, shape, kw)
        dit = int((i1 - i2).abs().max())
        dz = max_err(z1, z2)
        assert dit <= slack and dz <= 1e-4, (name, shape, kw, dit, dz)
        print(f"  {name} {shape} {kw}: max|d iters| {dit}, "
              f"max|d x| {dz:.2e}")

    def upper_bound(name, blocked, one_step, atol):
        for (zb, ib, _), (z1, i1, _) in zip(blocked, one_step):
            assert bool((ib >= i1 - 1).all()), (name, ib, i1)
            assert max_err(zb, z1) <= atol, (name, max_err(zb, z1))

    for (B, M, N, seed) in ((5, 16, 24, 0), (8, 16, 160, 5)):
        rng = np.random.default_rng(seed)
        As = (rng.standard_normal((B, M, N)) / np.sqrt(M)).astype(np.float32)
        bs = rng.standard_normal((B, M)).astype(np.float32)
        lams = 0.1 * np.max(np.abs(np.einsum("bmn,bm->bn", As, bs)), axis=1)
        Lfs = np.array([np.linalg.norm(a, 2) ** 2 for a in As])
        P = problems_from_numpy(As, bs, lams, Lfs, device=DEVICE)
        for restart in (False, True):
            runs = {}
            for solver, kw in (
                    (tl.solve_lasso_batch, {}),
                    (tl.solve_lasso_batch_packed_tail,
                     dict(k1=40, tail=B // 2)),
                    (tl.solve_lasso_batch_blocked, dict(iter_block=K))):
                if kw.get("iter_block") and (B, M, N) != (5, 16, 24):
                    continue
                runs[solver] = [solver(*P, TOL, maxit=3000, restart=restart,
                                       use_kernel=use, **kw)
                                for use in (True, False)]
                hold(solver.__name__, (B, M, N), dict(restart=restart),
                     *runs[solver], K if kw.get("iter_block") else 1)
            if tl.solve_lasso_batch_blocked in runs:
                upper_bound("solve_lasso_batch_blocked",
                            runs[tl.solve_lasso_batch_blocked],
                            runs[tl.solve_lasso_batch], 5e-4)
    for (B, n, seed) in ((6, 16, 0), (8, 16, 3)):
        Qs, qs, gam = box_qp_problems(B, n, seed)
        Q, q, lo, hi, Lip = box_qp_from_numpy(Qs, qs, -1.0, 1.0, 0.95 / gam,
                                              device=DEVICE)
        runs = {}
        for solver, kw in ((tb.solve_box_qp_batch, {}),
                           (tb.solve_box_qp_batch_blocked,
                            dict(iter_block=K))):
            if kw and (B, n, seed) != (8, 16, 3):
                continue
            runs[solver] = [solver(Q, q, lo, hi, Lip, 1e-4, use_kernel=use,
                                   **kw) for use in (True, False)]
            hold(solver.__name__, (B, n), {}, *runs[solver],
                 K if kw else 1)
        if tb.solve_box_qp_batch_blocked in runs:
            upper_bound("solve_box_qp_batch_blocked",
                        runs[tb.solve_box_qp_batch_blocked],
                        runs[tb.solve_box_qp_batch], 2e-3)


def box_qp_problems(B, n, seed):
    """The reference's nonconvex box-QP family
    (benchmarks/families_bench.py:123-133): Q = U diag(eig) U^T with U from
    a QR and eig uniform in [-1, 1], q standard normal, gamma = 0.95 /
    max|eig|.  Returns float32 ``(Qs, qs, gammas)``."""
    rng = np.random.default_rng(seed)
    Qs = np.empty((B, n, n), np.float32)
    gammas = np.empty((B,), np.float32)
    for i in range(B):
        U, _ = np.linalg.qr(rng.standard_normal((n, n)))
        eig = 2 * rng.random(n) - 1
        Qs[i] = (U * eig) @ U.T
        gammas[i] = 0.95 / np.max(np.abs(eig))
    qs = rng.standard_normal((B, n)).astype(np.float32)
    return Qs, qs, gammas


def box_recheck(Qs, qs, gammas, xs):
    """max over lanes of ||x - clip(x - gamma (Q x + q), -1, 1)||_inf /
    gamma, in float64."""
    x = xs.astype(np.float64)
    g = gammas.astype(np.float64)[:, None]
    grad = np.einsum("bij,bj->bi", Qs.astype(np.float64), x) + qs
    return float(np.max(np.max(np.abs(x - np.clip(x - g * grad, -1, 1)),
                               axis=1) / g[:, 0]))


def phase_main_path(card):
    import bench
    from proxtpu_torch import problems_from_numpy
    from proxtpu_torch.kernels import lasso as tl
    from proxtpu_torch.parallel import stream_solve

    As, bs, lams, Lfs = bench.gen_problems(bench.BATCH)
    A, b, lam, Lf = problems_from_numpy(As, bs, lams, Lfs, device=DEVICE)

    def solve(use_kernel=True):
        return tl.solve_lasso_batch_packed_tail(
            A, b, lam, Lf, TOL, maxit=MAXIT, k1=192, tail=64, restart=True,
            use_kernel=use_kernel)

    solve()  # warm-up
    torch.cuda.synchronize()
    tl.fused_fb_prox_grad.launches = 0
    tl.fused_fista_full_step.launches = 0
    t0 = time.perf_counter()
    outs = list(stream_solve(lambda _: solve(), range(N_STREAM), depth=2))
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / N_STREAM
    launches = {"fb_step": tl.fused_fb_prox_grad.launches,
                "fista_step": tl.fused_fista_full_step.launches}
    print(f"main path launches over {N_STREAM} solves: {launches}")
    assert all(n > 0 for n in launches.values()), launches

    xs, iters, done = outs[0]
    for other in outs[1:]:  # the kernels are deterministic
        assert all(torch.equal(a, b) for a, b in zip(other, outs[0]))
    assert bool(done.all()), f"{int((~done).sum())} lanes not converged"
    xs_np, it_np = xs.cpu().numpy(), iters.cpu().numpy()
    worst = recheck(As, bs, lams, Lfs, xs_np)
    assert worst <= 1.1 * TOL, worst
    assert np.isfinite(xs_np).all() and xs_np.shape == (bench.BATCH, bench.N)
    print(f"main path: {bench.BATCH} lanes done, worst residual recheck "
          f"{worst:.3e} (limit {1.1 * TOL:.1e}), iterations mean "
          f"{it_np.mean():.2f} max {it_np.max()}  [{card}]")
    print(f"main path: {dt:.4f} s per solve, {bench.BATCH / dt:.1f} "
          f"problems/s (stream_solve depth 2, {N_STREAM} solves after one "
          f"warm-up)  [{card}]")

    # The plain route on the card.  At this width the two routes sum in
    # different orders and their trajectories part: the JAX package's own
    # kernel and XLA routes differ by up to 4 iterations (restart) on
    # bench.gen_problems(64) on the CPU (ROADMAP.md queue 3), so the +-1 /
    # 1e-4 contract is held at the test shapes in check_contract_small.
    # Here the plain route must converge every lane; its recheck, which
    # sits as near the 1.1 * tol gate as the kernel route's, is reported.
    xs_p, it_p, done_p = solve(use_kernel=False)
    assert bool(done_p.all()), f"{int((~done_p).sum())} plain lanes left"
    worst_p = recheck(As, bs, lams, Lfs, xs_p.cpu().numpy())
    dit = (iters - it_p).abs()
    print(f"plain route: worst recheck {worst_p:.3e}, iterations mean "
          f"{it_p.float().mean():.2f} max {int(it_p.max())}; kernel vs "
          f"plain: max|d iters| {int(dit.max())} ({int((dit > 1).sum())} "
          f"lanes > 1), max|d x| {max_err(xs, xs_p):.3e}")
    return launches


def launch_counters():
    """The kernel wrappers, whose ``launches`` attributes count launches."""
    from proxtpu_torch.kernels import box_qp as tb
    from proxtpu_torch.kernels import lasso as tl

    return {"fb_step": tl.fused_fb_prox_grad,
            "fista_step": tl.fused_fista_full_step,
            "fista_k_steps": tl.fused_fista_k_steps,
            "pg_step": tb.fused_pg_box_step,
            "pg_k_steps": tb.fused_pg_box_k_steps}


def drive(name, solve, check, tol, card, expect):
    """Drive one route through BatchedAlgorithm: once on the kernel route
    with every launch counter set to 0 just before and read just after
    (the counts this route adds to the kernels' JSON line), once on the
    plain route.  Every lane done on both; ``check`` rechecks a solution on
    the host, held to 2 tol on both; ``expect`` lists the kernels the route
    must launch, and no other kernel may launch."""
    wrappers = launch_counters()
    solve(True)  # warm-up (the kernel route's first call)
    torch.cuda.synchronize()
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    xs, iters, done = solve(True)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    t0 = time.perf_counter()
    xs_p, it_p, done_p = solve(False)
    torch.cuda.synchronize()
    dt_p = time.perf_counter() - t0
    assert bool(done.all()), f"{name}: {int((~done).sum())} lanes left"
    assert bool(done_p.all()), f"{name}: {int((~done_p).sum())} plain left"
    assert bool(torch.isfinite(xs).all()) and xs.shape == xs_p.shape
    moved = {k for k, n in launches.items() if n > 0}
    assert moved == set(expect), (name, launches, expect)
    r, r_p = check(xs.cpu().numpy()), check(xs_p.cpu().numpy())
    assert r <= 2 * tol and r_p <= 2 * tol, (name, r, r_p)
    dit = (iters - it_p).abs()
    print(f"{name}: launches {launches}; kernel route {dt:.4f} s, "
          f"recheck {r:.3e}, iterations mean {iters.float().mean():.2f} "
          f"max {int(iters.max())}; plain route {dt_p:.4f} s, recheck "
          f"{r_p:.3e}, iterations mean {it_p.float().mean():.2f} max "
          f"{int(it_p.max())}; max|d iters| {int(dit.max())}, max|d x| "
          f"{max_err(xs, xs_p):.3e}  [{card}]")
    return launches


def phase_routes(card):
    """Routes (a) to (d) of the library entry point at full width.
    Returns the launches per kernel summed over the routes."""
    import bench
    from benchmarks import kernel_sweep
    from proxtpu_torch import (
        AdaptiveRestartSequence,
        BatchedAlgorithm,
        FixedNesterovSequence,
        make_fast_forward_backward_iteration as ffb,
        make_forward_backward_iteration as fb,
    )
    from proxtpu_torch.prox import IndBox, LeastSquaresLoss, NormL1, Quadratic

    def lasso_route(As, bs, lams, Lfs, maxit, **extra):
        A, b, lam, Lf = (torch.tensor(v, device=DEVICE)
                         for v in (As, bs, lams, Lfs))
        kw = dict(x0=torch.zeros(A.shape[0], A.shape[2], device=DEVICE),
                  f=LeastSquaresLoss(A, b), g=NormL1(lam), Lf=Lf, **extra)
        solve = lambda use: BatchedAlgorithm(  # noqa: E731
            ffb, maxit=maxit, tol=TOL,
            use_kernels="auto" if use else False)(**kw)
        check = lambda xs: recheck(As, bs, lams, Lfs, xs)  # noqa: E731
        return solve, check

    total = {}

    def add(launches):
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n

    # (a) the DMA-bound lasso shape: the blocked solver at K = 8
    prob = kernel_sweep.gen(*BLOCKED_SHAPES[0])
    for extra in ({}, {"extrapolation_sequence":
                       AdaptiveRestartSequence(FixedNesterovSequence())}):
        solve, check = lasso_route(*prob, 3000, **extra)
        add(drive(f"route (a) {BLOCKED_SHAPES[0]} restart={bool(extra)}",
                  solve, check, TOL, card, ("fb_step", "fista_k_steps")))
    del prob
    # (b) the nonconvex box-QP family, n = 512, B = 64
    B, n = BOX_SHAPES[0]
    Qs, qs, gam = box_qp_problems(B, n, seed=7)
    kw = dict(x0=torch.zeros(B, n, device=DEVICE),
              f=Quadratic(torch.tensor(Qs, device=DEVICE),
                          torch.tensor(qs, device=DEVICE)),
              g=IndBox(-1.0, 1.0), gamma=torch.tensor(gam, device=DEVICE))
    add(drive(f"route (b) box QP {(B, n)}",
              lambda use: BatchedAlgorithm(
                  fb, maxit=10_000, tol=1e-4,
                  use_kernels="auto" if use else False)(**kw),
              lambda xs: box_recheck(Qs, qs, gam, xs), 1e-4, card,
              ("pg_step", "pg_k_steps")))
    # (c) the flagship through the library entry point: the packed solver
    solve, check = lasso_route(*bench.gen_problems(bench.BATCH), 3000)
    add(drive(f"route (c) flagship {MAIN_SHAPES[0]}", solve, check, TOL,
              card, ("fista_step",)))
    # (d) tall strongly convex problems, mf = the smallest sigma_min^2
    rng = np.random.default_rng(0)
    B, M, N = bench.BATCH, bench.N, bench.M
    As = (rng.standard_normal((B, M, N)) / np.sqrt(M)).astype(np.float32)
    bs = rng.standard_normal((B, M)).astype(np.float32)
    lams = (0.1 * np.max(np.abs(np.einsum("bmn,bm->bn", As, bs)), axis=1)
            ).astype(np.float32)
    sv = np.linalg.svd(As.astype(np.float64), compute_uv=False)
    Lfs = (sv[:, 0] ** 2).astype(np.float32)
    mf = float(np.min(sv[:, -1] ** 2))
    solve, check = lasso_route(As, bs, lams, Lfs, 3000, mf=mf)
    add(drive(f"route (d) tall {(B, M, N)} mf={mf:.4f}", solve, check, TOL,
              card, ("fb_step", "fista_step")))
    return total


def main():
    card = phase_identify()
    phase_build()
    print("kernel vs plain on the card:")
    worst = check_kernels()
    worst.update(check_new_kernels())
    flagship = time_kernels(card)
    flagship.update(time_new_kernels(card))
    print("cross-path contract at the reference test shapes:")
    check_contract_small()
    launches = phase_main_path(card)
    print("library route, BatchedAlgorithm -> match_kernel_solver:")
    for k, n in phase_routes(card).items():
        launches[k] = launches.get(k, 0) + n
    kernels = {
        "fista_step": ("lasso_step.cu", "proxtpu/kernels/lasso.py:156"),
        "fb_step": ("lasso_step.cu", "proxtpu/kernels/lasso.py:37"),
        "fista_k_steps": ("lasso_step.cu", "proxtpu/kernels/lasso.py:768"),
        "pg_step": ("box_qp_step.cu", "proxtpu/kernels/box_qp.py:31"),
        "pg_k_steps": ("box_qp_step.cu", "proxtpu/kernels/box_qp.py:174"),
    }
    assert all(launches[k] > 0 for k in kernels), launches
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda",
         "source": f"proxtpu_torch/csrc/{source}", "replaces": replaces,
         "launches": launches[name], "max_abs_err": worst[name],
         "ms": flagship[name][0], "plain_ms": flagship[name][1]}
        for name, (source, replaces) in kernels.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
