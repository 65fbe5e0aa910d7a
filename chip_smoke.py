"""Drive the PyTorch port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:

1. identify the card (there is no CPU path: no CUDA device is an error);
2. build the CUDA kernels from ``proxtpu_torch/csrc`` (first use);
3. hold each kernel against its plain PyTorch version on the card at the
   shapes the driven paths give it and a ragged one (``fista_k_steps`` at
   every branch of its launch plan: 1, 2, 4 and 8 thread blocks per lane,
   stages filled by the bulk copy or by ordinary loads, tiles read in
   place), then time both; time the read-floor probe ``read_reduce`` at
   every step kernel's shape, and its wrapper's host time by part;
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
6. drive the TV route, ``BatchedAlgorithm(make_chambolle_pock_iteration)``
   -> ``match_tv_solver`` -> ``solve_tv_batch`` -> ``cp_k_steps``, on the
   kernel route and on the generic driver, with a float64 fixed-point
   recheck of every returned (x, y) on the host:
   (e) 64 images of 64 x 64 (``benchmarks/tv_bench.py``, seed 0, noise
       0.15, lam 0.12, tol 1e-4): one thread block per image;
   (f) 64 images of 256 x 256, the same generator: tiles with a halo;
7. print the kernels' JSON line (time, plain version's time, bound and,
   where one PyTorch call computes the same function, that call's time),
   then the result line.

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
# fista_k_steps at every branch of its launch plan on 132 SMs: clusters of
# 4 and 8 thread blocks per lane (route (a) has 2, the ragged shape 1), M
# that does not divide over the cluster with a short last tile, rows of no
# multiple of 16 bytes under a cluster (stages filled by ordinary loads),
# and rows too wide for a ring of stages (tiles read in place by one block
# per lane, also where the rows alone would have made a cluster)
CLUSTER_SHAPES = [(32, 256, 512), (16, 512, 256), (16, 515, 256),
                  (16, 515, 250), (3, 40, 8400), (2, 130, 8404)]
# B above the SM count: one block per lane, two waves
WIDE_BATCH_SHAPE = (256, 512, 512)
BOX_SHAPES = [(64, 512), (7, 161)]                # route (b), ragged
SMALL_LASSO = (1024, 64, 128)  # kernel_sweep.py:22, sent to XLA on a v5e
SMALL_BOX = (256, 128)         # dispatch.py:767-770, sent to XLA on a v5e


# TV denoising (benchmarks/tv_bench.py:28-37, 61-66)
TV_LAM = 0.12
TV_TOL = 1e-4
TV_MAXIT = 5000
TV_SHAPES = [(64, 64, 64), (64, 256, 256)]  # routes (e) and (f)
TV_RAGGED = (7, 33, 21)
# cp_k_steps against its plain version.  The kernel rounds every operation
# on its own, in the plain version's order, so the two should agree to the
# last bit or nearly; they are held to the JAX package's own one-step
# tolerance for its kernel (5e-6), and after K = 8 steps to eight times
# that: one Chambolle-Pock step is nonexpansive in the stepsize-weighted
# norm, so one-step differences at most add up.
ATOL_CP = 5e-6
ATOL_CP_K = 4e-5
# read_reduce against A.sum: both sum M * N f32 terms of size O(1/sqrt(M))
# in different orders; each carries a few ulps of its largest partial sum
# (at most about |A|_1 of a lane, ~2e4 at 512 x 1024), so the sums are held
# relative to the lane's sum of absolute values.
READ_RTOL = 1e-5
# every step kernel's operator shape, for the measured read floor
FLOOR_SHAPES = [(256, 200, 400), (64, 200, 400), (64, 512, 1024),
                (1024, 64, 128), (64, 512, 512), (256, 128, 128)]
# datasheet rates of one H100 SXM: device memory, f32 outside tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12


def bound(nbytes, ops):
    """``(ms, by)``: the least time the card could take to move ``nbytes``
    (each input read once, each output written once) or do ``ops`` float32
    operations, whichever is larger, and which of the two it is."""
    tb, to = nbytes / PEAK_BYTES_S, ops / PEAK_F32_S
    return 1e3 * max(tb, to), "bytes" if tb >= to else "operations"


def cp_bound(B, H, W):
    """cp_k_steps at K steps: b, x, yx, yy, g1, g2, lam -> x, yx, yy, res;
    25 operations per pixel and step, counted from the plain version (3 for
    the divergence, 5 for xbar, 2 for mid, 2 differences, 4 for v, 4 for
    its norm, 3 for the scale, 2 products)."""
    return bound(4 * (7 * B * H * W + 4 * B), 25 * K * B * H * W)


def read_bound(B, M, N):
    """read_reduce: A -> out, one addition per entry."""
    return bound(4 * (B * M * N + B), B * M * N)


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


def graph_ms(fn, reps=20, inner=10):
    """The median time in ms of one call at the device's own pace:
    ``inner`` calls are captured into a CUDA graph, whose replay costs the
    host one launch, and ``reps`` replays are timed with CUDA events.
    Where :func:`time_ms` reads more, the host sets the pace of the eager
    loop."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    ts = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        ts.append(start.elapsed_time(end) / inner)
    return statistics.median(ts)


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
    at the library route's shapes and a ragged one (fista_k_steps also at
    every branch of its launch plan, see CLUSTER_SHAPES), restart on and
    off, with and without frozen lanes; frozen lanes come back bit-equal,
    and two calls of fista_k_steps give the same bits.  Returns the largest
    absolute error per kernel."""
    from proxtpu_torch.kernels import box_qp as tb
    from proxtpu_torch.kernels import lasso as tl

    from proxtpu_torch.kernels import _build

    worst = {"fista_k_steps": 0.0, "pg_step": 0.0, "pg_k_steps": 0.0}
    sms, limit = _build.sm_count(0), _build.max_shared_bytes(0)
    plans = set()
    cases = [(shape, False) for shape in BLOCKED_SHAPES + CLUSTER_SHAPES]
    # and route (a)'s shape in a buffer whose lanes do not start on 16
    # bytes (stages filled by ordinary loads)
    for (B, M, N), shifted in cases + [(BLOCKED_SHAPES[0], True)]:
        d = step_inputs(B, M, N, seed=B + M + N)
        if shifted:
            flat = torch.empty(B * M * N + 1, device=DEVICE)
            flat[1:] = d["A"].reshape(-1)
            d["A"] = flat[1:].view(B, M, N)
            assert d["A"].data_ptr() % 16 == 4 and d["A"].is_contiguous()
        C, R, S = tl.k_steps_plan(B, M, N, sms, limit)
        fill = ("in place" if S == 0 else "bulk copy"
                if N % 4 == 0 and not shifted else "ordinary loads")
        plans.add((C, fill))
        t0 = torch.tensor(np.random.default_rng(B).uniform(1, 5, B)
                          .astype(np.float32), device=DEVICE)
        for restart in (False, True):
            for done in (torch.zeros_like(d["done"]), d["done"]):
                args = (d["A"], d["b"], d["x"], d["z_prev"], t0, d["gamma"],
                        d["thr"], done)
                want = tl.reference_fista_k_steps(*args, K=K,
                                                  restart=restart)
                got, again = (tl.fused_fista_k_steps(
                    d["A"], d["b"], d["x"].clone(), d["z_prev"].clone(),
                    t0.clone(), d["gamma"], d["thr"], done, K=K,
                    restart=restart) for _ in range(2))
                torch.cuda.synchronize()
                err = max(max_err(g, w) for g, w in zip(got, want))
                assert err <= ATOL_K, (B, M, N, restart, err)
                assert all(torch.equal(g, a) for g, a in zip(got, again)), (
                    "two calls differ", B, M, N, restart)
                frozen = done != 0
                for g, w in zip(got[:3], (d["x"], d["z_prev"], t0)):
                    assert torch.equal(g[frozen], w[frozen])
                assert bool((got[3][frozen] == 0).all())
                worst["fista_k_steps"] = max(worst["fista_k_steps"], err)
                print(f"  fista_k_steps {(B, M, N)} K={K} C={C} R={R} S={S} "
                      f"({fill}) restart={restart} "
                      f"frozen={int(frozen.sum())}: max|err| {err:.3e}, two "
                      f"calls bit-equal")
    # every branch of the plan was reached
    assert {c for c, _ in plans} == {1, 2, 4, 8}, plans
    assert {f for _, f in plans} == {"bulk copy", "ordinary loads",
                                     "in place"}, plans
    assert (8, "ordinary loads") in plans, plans
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
    from proxtpu_torch.kernels import _build
    from proxtpu_torch.kernels import box_qp as tb
    from proxtpu_torch.kernels import lasso as tl

    out = {}
    for B, M, N in (BLOCKED_SHAPES[0], WIDE_BATCH_SHAPE):
        d = step_inputs(B, M, N, seed=1)
        live = torch.zeros_like(d["done"])
        t0 = torch.ones_like(d["beta"])
        x, zp, t = d["x"].clone(), d["z_prev"].clone(), t0.clone()
        kernel = lambda: tl.fused_fista_k_steps(  # noqa: E731
            d["A"], d["b"], x, zp, t, d["gamma"], d["thr"], live, K=K,
            restart=True)
        pair = time_pair(
            "fista_k_steps", kernel,
            lambda: tl.reference_fista_k_steps(
                d["A"], d["b"], d["x"], d["z_prev"], t0, d["gamma"],
                d["thr"], live, K=K, restart=True),
            f"{(B, M, N)} K={K}", card, K * B * M * N * 4)
        out.setdefault("fista_k_steps", pair)
        C, R, S = tl.k_steps_plan(B, M, N, _build.sm_count(0),
                                  _build.max_shared_bytes(0))
        print(f"    at the device's pace (CUDA graph): kernel "
              f"{1e3 * graph_ms(kernel):.1f} us; {B} x {C} thread blocks, "
              f"{S} stages of {R} rows; A streamed once per inner step "
              f"{1e3 * K * bound(4 * B * M * N, 0)[0]:.1f} us at "
              f"{PEAK_BYTES_S / 1e12} TB/s  [{card}]")
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


def tv_images(B, H, W, seed=0, noise=0.15):
    """The reference's TV test images (benchmarks/tv_bench.py:61-66): a
    centred square of ones plus Gaussian noise, float32."""
    rng = np.random.default_rng(seed)
    clean = np.zeros((B, H, W), np.float32)
    clean[:, H // 4: 3 * H // 4, W // 4: 3 * W // 4] = 1.0
    return clean + noise * rng.standard_normal((B, H, W)).astype(np.float32)


def tv_inputs(B, H, W, seed):
    """Operands of one cp_k_steps call: noisy images, a warm state, the
    default stepsizes, a per-image lam and a done mask with about half the
    images frozen."""
    from proxtpu_torch.kernels.tv import default_tv_stepsizes

    rng = np.random.default_rng(seed)
    g1, g2 = default_tv_stepsizes()
    arrays = dict(
        b=tv_images(B, H, W, seed),
        x=rng.standard_normal((B, H, W)).astype(np.float32),
        yx=(0.05 * rng.standard_normal((B, H, W))).astype(np.float32),
        yy=(0.05 * rng.standard_normal((B, H, W))).astype(np.float32),
        g1=np.full(B, g1, np.float32),
        g2=np.full(B, g2, np.float32),
        lam=np.full(B, TV_LAM, np.float32),
        lams=rng.uniform(0.05, 0.3, B).astype(np.float32),
        done=(rng.random(B) < 0.5).astype(np.float32),
    )
    return {k: torch.tensor(v, device=DEVICE) for k, v in arrays.items()}


def check_tv_kernel():
    """cp_k_steps against its plain version at the routes' shapes and a
    ragged one, K = 1 and K = 8, uniform and per-image lam, from zero and
    from a warm state, with and without frozen images (which come back
    bit-equal, copied at done = 1 and left in place at done = 2).  Returns
    the largest absolute error."""
    from proxtpu_torch.kernels import tv

    worst = 0.0
    for B, H, W in TV_SHAPES + [TV_RAGGED]:
        d = tv_inputs(B, H, W, seed=B + H + W)
        zero = torch.zeros_like(d["b"])
        for k, atol in ((1, ATOL_CP), (K, ATOL_CP_K)):
            for lam in (d["lam"], d["lams"]):
                for state in ((zero, zero, zero), (d["x"], d["yx"], d["yy"])):
                    for done in (None, d["done"]):
                        args = (d["b"], *state, d["g1"], d["g2"], lam)
                        want = tv.reference_cp_k_steps(*args, k, done)
                        got = tv.fused_cp_k_steps(*args, k, done)
                        torch.cuda.synchronize()
                        err = max(max_err(g, w) for g, w in zip(got, want))
                        assert err <= atol, (B, H, W, k, err)
                        worst = max(worst, err)
                        if done is not None:
                            frozen = done != 0
                            for g, w in zip(got[:3], state):
                                assert torch.equal(g[frozen], w[frozen])
                            assert bool((got[3][frozen] == 0).all())
                            # done = 2: the outputs hold the frozen state
                            out = tuple(w.clone() for w in want[:3])
                            again = tv.fused_cp_k_steps(*args, k, 2 * done,
                                                        out=out)
                            torch.cuda.synchronize()
                            assert all(torch.equal(g, w) for g, w in
                                       zip(again, got)), (B, H, W, k)
                        print(f"  cp_k_steps {(B, H, W)} K={k} per-image "
                              f"lam={lam is d['lams']} warm="
                              f"{state[0] is not zero} frozen="
                              f"{0 if done is None else int(done.sum())}: "
                              f"max|err| {err:.3e}")
    return worst


def time_tv_kernel(card):
    """cp_k_steps (K = 8, writing into given buffers, as the solver calls
    it) beside its plain version at the two routes' shapes, in an eager
    loop, and the kernel at the device's own pace.  Returns ``{shape:
    (kernel ms, plain ms)}``."""
    from proxtpu_torch.kernels import tv

    out = {}
    for B, H, W in TV_SHAPES:
        d = tv_inputs(B, H, W, seed=1)
        args = (d["b"], d["x"], d["yx"], d["yy"], d["g1"], d["g2"], d["lam"])
        bufs = tuple(torch.empty_like(d["b"]) for _ in range(3))
        kernel = lambda: tv.fused_cp_k_steps(  # noqa: E731
            *args, K, None, out=bufs)
        nbytes = 4 * (7 * B * H * W + 4 * B)
        out[(B, H, W)] = time_pair(
            "cp_k_steps", kernel, lambda: tv.reference_cp_k_steps(*args, K),
            f"{(B, H, W)} K={K}", card, nbytes)
        print(f"    at the device's pace (CUDA graph): kernel "
              f"{1e3 * graph_ms(kernel):.1f} us; bound "
              f"{1e3 * cp_bound(B, H, W)[0]:.1f} us ({nbytes / 1e6:.1f} MB "
              f"over {PEAK_BYTES_S / 1e12} TB/s)  [{card}]")
    return out


def floor_operand(B, M, N, seed):
    rng = np.random.default_rng(seed)
    return torch.tensor((rng.standard_normal((B, M, N)) / np.sqrt(M))
                        .astype(np.float32), device=DEVICE)


def check_read_reduce():
    """read_reduce against A.sum(dim=(1, 2)) at every floor shape and a
    ragged one whose lanes do not start on 16 bytes; two calls give the
    same bits, with the wrapper's own scratch or a given one.  Returns the
    largest absolute error."""
    from proxtpu_torch.kernels import probe

    worst = 0.0
    for B, M, N in FLOOR_SHAPES + [(7, 33, 161)]:
        A = floor_operand(B, M, N, seed=B + M + N)
        got, again = probe.read_reduce(A), probe.read_reduce(A)
        # with the output and the scratch given, twice on one scratch
        res, scratch = torch.empty(B, device=DEVICE), \
            probe.read_reduce_scratch(A)
        for _ in range(2):
            given = probe.read_reduce(A, out=res, scratch=scratch)
        want = probe.reference_read_reduce(A)
        torch.cuda.synchronize()
        assert given is res
        assert torch.equal(got, again) and torch.equal(got, res), (B, M, N)
        err = max_err(got, want)
        rel = float(((got - want).abs() / A.abs().sum(dim=(1, 2))).max())
        assert rel <= READ_RTOL, (B, M, N, err, rel)
        worst = max(worst, err)
        print(f"  read_reduce {(B, M, N)}: max|err| {err:.3e}, relative to "
              f"the lane's sum of |A| {rel:.3e}")
    return worst


def host_us(fn, batches=10, batch=200):
    """Microseconds of host time per call of ``fn``: the median over
    ``batches`` of the mean of ``batch`` calls by ``time.perf_counter``,
    synchronising between batches, outside the clock, so that a part that
    launches never waits for a full queue."""
    fn()
    ts = []
    for _ in range(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(batch):
            fn()
        ts.append(1e6 * (time.perf_counter() - t0) / batch)
    torch.cuda.synchronize()
    return statistics.median(ts)


def read_reduce_host_parts(A, card):
    """Where the host time of one read_reduce call goes: each part of the
    wrapper, as it is and as it was with a plan, two allocations, a device
    context and a boxed stream per call, timed on its own."""
    import ctypes

    from proxtpu_torch.kernels import _build, probe

    B, n = A.shape[0], A.shape[1] * A.shape[2]
    dev = A.device
    sms = _build.sm_count(dev.index)
    S, chunk = probe.chunk_plan(B, n, sms)
    out = torch.empty(B, device=dev)
    scratch = probe.read_reduce_scratch(A)
    entry = _build.library().proxtpu_read_reduce
    raw = torch._C._cuda_getCurrentRawStream(dev.index)
    ptrs = (A.data_ptr(), scratch.data_ptr() + 4 * B, scratch.data_ptr(),
            out.data_ptr())

    def device_context():
        with torch.cuda.device(dev):
            pass

    parts = {
        "get_device_properties(...).multi_processor_count":
            lambda: torch.cuda.get_device_properties(dev)
            .multi_processor_count,
        "sm_count, cached": lambda: _build.sm_count(dev.index),
        "chunk_plan": lambda: probe.chunk_plan(B, n, sms),
        "chunk plan, cached": lambda: probe.cached_chunk_plan(B, n, sms),
        "torch.empty((B, S))": lambda: torch.empty((B, S), device=dev),
        "torch.empty(B)": lambda: torch.empty(B, device=dev),
        "A.new_empty(B)": lambda: A.new_empty(B),
        "stream scratch, cached":
            lambda: probe._stream_scratch(dev.index, raw, B, S),
        "with torch.cuda.device(A.device)": device_context,
        "torch.cuda.current_device()": torch.cuda.current_device,
        "torch.cuda.current_stream().cuda_stream":
            lambda: torch.cuda.current_stream().cuda_stream,
        "raw current stream":
            lambda: torch._C._cuda_getCurrentRawStream(dev.index),
        "is_current_stream_capturing":
            torch.cuda.is_current_stream_capturing,
        "the checks of A": lambda: (
            A.dim() != 3, A.is_cuda, A.dtype != torch.float32,
            A.is_contiguous(), A.shape, A.get_device()),
        "three data_ptr()": lambda: (A.data_ptr(), scratch.data_ptr(),
                                     out.data_ptr()),
        "_build.library() and the entry's lookup":
            lambda: _build.library().proxtpu_read_reduce,
        "ctypes call (one launch), stream boxed in c_void_p":
            lambda: entry(*ptrs, B, n, S, chunk, ctypes.c_void_p(raw)),
        "ctypes call (one launch), stream as int":
            lambda: entry(*ptrs, B, n, S, chunk, raw),
        "_build.check(0, ...)": lambda: _build.check(0, "read_reduce"),
        "read_reduce(A), whole":
            lambda: probe.read_reduce(A),
        "read_reduce(A, out=, scratch=), whole":
            lambda: probe.read_reduce(A, out=out, scratch=scratch),
        "A.sum(dim=(1, 2)), whole": lambda: A.sum(dim=(1, 2)),
    }
    print(f"    host time per call by part at {tuple(A.shape)} "
          f"(time.perf_counter, median of 10 batches of 200 calls)  [{card}]:")
    for name, fn in parts.items():
        print(f"      {name}: {host_us(fn):.2f} us")


def phase_read_floor(card):
    """The probe's own path: the measured read floor at every step kernel's
    operator shape, beside the library call ``A.sum(dim=(1, 2))`` and the
    datasheet bound.  An operand under the 50 MB of L2 stays there between
    calls, as a solver's operator does between iterations.  Both are timed
    in an eager loop (the probe also with its output and scratch passed
    back in, so that a call allocates nothing) and at the device's own pace
    (the floor proper); at the two main-path shapes the wrapper's host time
    is printed by part.  Returns ``({shape: (kernel ms, library ms)},
    launches)``."""
    from proxtpu_torch.kernels import probe

    probe.read_reduce.launches = 0
    out = {}
    for B, M, N in FLOOR_SHAPES:
        A = floor_operand(B, M, N, seed=1)
        nbytes = A.numel() * 4 + B * 4
        kernel = lambda: probe.read_reduce(A)  # noqa: E731
        library = lambda: A.sum(dim=(1, 2))  # noqa: E731
        out[(B, M, N)] = time_pair("read_reduce", kernel, library,
                                   f"{(B, M, N)}", card, nbytes)
        res, scratch = torch.empty(B, device=DEVICE), \
            probe.read_reduce_scratch(A)
        reuse = lambda: probe.read_reduce(  # noqa: E731
            A, out=res, scratch=scratch)
        lean = statistics.median(time_ms(reuse, reps=10)
                                 + time_ms(reuse, reps=10))
        print(f"    eager with out= and scratch= passed back in: kernel "
              f"{1e3 * lean:.1f} us")
        print(f"    at the device's pace (CUDA graph): kernel "
              f"{1e3 * graph_ms(reuse):.1f} us, library "
              f"{1e3 * graph_ms(library):.1f} us; bound "
              f"{1e3 * read_bound(B, M, N)[0]:.1f} us ({nbytes / 1e6:.1f} MB "
              f"over {PEAK_BYTES_S / 1e12} TB/s)  [{card}]")
        if (B, M, N) in MAIN_SHAPES:
            read_reduce_host_parts(A, card)
    return out, probe.read_reduce.launches


def tv_recheck(b, lam, x, y):
    """One Chambolle-Pock step from (x, y) in float64 on the host: the
    largest ||xbar - x||_inf + ||ybar - y||_inf over the images, the
    solver's own stopping quantity at the returned point."""
    from proxtpu_torch.kernels.tv import default_tv_stepsizes

    g1, g2 = default_tv_stepsizes()
    b, x, y = (np.asarray(v, np.float64) for v in (b, x, y))
    yx, yy = y[:, 0].copy(), y[:, 1].copy()
    yx[:, -1, :] = 0.0
    yy[:, :, -1] = 0.0
    div = yx + yy
    div[:, 1:, :] -= yx[:, :-1, :]
    div[:, :, 1:] -= yy[:, :, :-1]
    xbar = (x + g1 * div + g1 * b) / (1 + g1)
    mid = 2 * xbar - x
    v = y.copy()
    v[:, 0, :-1, :] += g2 * (mid[:, 1:, :] - mid[:, :-1, :])
    v[:, 1, :, :-1] += g2 * (mid[:, :, 1:] - mid[:, :, :-1])
    nrm = np.sqrt(v[:, 0] ** 2 + v[:, 1] ** 2)
    scale = np.where(nrm > lam, lam / np.maximum(nrm, 1e-30), 1.0)
    ybar = v * scale[:, None]
    return float(np.max(np.abs(xbar - x).max(axis=(1, 2))
                        + np.abs(ybar - y).max(axis=(1, 2, 3))))


def tv_route(noisy):
    """``solve(use_kernels)`` and ``check(x, y)`` for the TV problem on
    ``noisy`` (B, H, W) through ``BatchedAlgorithm``."""
    from proxtpu_torch import (
        BatchedAlgorithm,
        make_chambolle_pock_iteration,
        tv_from_numpy,
    )
    from proxtpu_torch.ops import Grad2DOperator
    from proxtpu_torch.prox import NormL21, SqrDistance

    B, H, W = noisy.shape
    b, lam = tv_from_numpy(noisy, TV_LAM, device=DEVICE)
    kw = dict(x0=torch.zeros_like(b),
              y0=torch.zeros((B, 2, H, W), device=DEVICE), g=SqrDistance(b),
              h=NormL21(lam, axis=0), L=Grad2DOperator((H, W)))
    solve = lambda use: BatchedAlgorithm(  # noqa: E731
        make_chambolle_pock_iteration, maxit=TV_MAXIT, tol=TV_TOL,
        use_kernels="auto" if use else False)(**kw)
    check = lambda x, y: tv_recheck(noisy, TV_LAM, x, y)  # noqa: E731
    return solve, check


def check_tv_contract_small():
    """The reference's cross-path contract for TV at its test shape
    (tests/test_tv_kernel.py:27-29, 177-192): the kernel route against the
    generic driver, every image done, x within 1e-3, counts an upper bound
    within one block: in [iters - 1, iters + 8]."""
    solve, _ = tv_route(tv_images(4, 16, 24))
    (x, y), it, done = solve(True)
    (x_g, y_g), it_g, done_g = solve(False)
    assert bool(done.all()) and bool(done_g.all())
    dx = max_err(x, x_g)
    assert dx <= 1e-3, dx
    assert bool((it >= it_g - 1).all()) and bool((it <= it_g + 8).all()), (
        it, it_g)
    print(f"  TV (4, 16, 24): kernel route iterations {it.tolist()}, generic "
          f"driver {it_g.tolist()}, max|d x| {dx:.2e}")


def phase_tv_routes(card):
    """Routes (e) and (f): the TV configuration of benchmarks/tv_bench.py at
    64 x 64 and at 256 x 256, 64 images each.  Returns the launches per
    kernel summed over the two."""
    total = {}
    for tag, (B, H, W) in zip("ef", TV_SHAPES):
        solve, check = tv_route(tv_images(B, H, W))
        launches = drive(f"route ({tag}) TV {(B, H, W)}", solve, check,
                         TV_TOL, card, ("cp_k_steps",), dx_tol=1e-3)
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n
    return total


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
    from proxtpu_torch.kernels import probe, tv

    return {"cp_k_steps": tv.fused_cp_k_steps,
            "read_reduce": probe.read_reduce,
            "fb_step": tl.fused_fb_prox_grad,
            "fista_step": tl.fused_fista_full_step,
            "fista_k_steps": tl.fused_fista_k_steps,
            "pg_step": tb.fused_pg_box_step,
            "pg_k_steps": tb.fused_pg_box_k_steps}


def drive(name, solve, check, tol, card, expect, dx_tol=None):
    """Drive one route through BatchedAlgorithm: once on the kernel route
    with every launch counter set to 0 just before and read just after
    (the counts this route adds to the kernels' JSON line), once on the
    plain route, which must launch no kernel.  Every lane done on both;
    ``check`` rechecks a solution (the arrays of its structure) on the
    host, held to 2 tol on both; ``expect`` lists the kernels the route
    must launch, and no other kernel may launch.  ``dx_tol``, where given,
    bounds the distance of the two routes' primal solutions."""
    def arrays(sol):
        sol = sol if isinstance(sol, tuple) else (sol,)
        return [t.cpu().numpy() for t in sol]

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
    assert all(w.launches == launches[k] for k, w in wrappers.items()), (
        f"{name}: the plain route launched a kernel")
    assert bool(done.all()), f"{name}: {int((~done).sum())} lanes left"
    assert bool(done_p.all()), f"{name}: {int((~done_p).sum())} plain left"
    moved = {k for k, n in launches.items() if n > 0}
    assert moved == set(expect), (name, launches, expect)
    sol, sol_p = arrays(xs), arrays(xs_p)
    assert all(np.isfinite(a).all() and a.shape == a_p.shape
               for a, a_p in zip(sol, sol_p))
    r, r_p = check(*sol), check(*sol_p)
    assert r <= 2 * tol and r_p <= 2 * tol, (name, r, r_p)
    xs, xs_p = (v[0] if isinstance(v, tuple) else v for v in (xs, xs_p))
    if dx_tol is not None:
        assert max_err(xs, xs_p) <= dx_tol, (name, max_err(xs, xs_p))
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


def kernel_bounds():
    """``{kernel: (shape, ms, by)}``: the bound of each kernel at the shape
    its times in the JSON line are taken at.  Bytes: every operand read
    once, every result written once, float32.  Operations: two products
    with the operator per step (2 M N each) plus about ten per entry of the
    iterate; for the last two see :func:`cp_bound`, :func:`read_bound`."""
    B, M, N = MAIN_SHAPES[0]
    Bk, Mk, Nk = BLOCKED_SHAPES[0]
    Bq, n = BOX_SHAPES[0]
    Bt, H, W = TV_SHAPES[1]

    def lasso(B, M, N, vecs, scalars, steps):
        return bound(4 * (B * M * N + B * M + vecs * B * N + scalars * B),
                     steps * B * (4 * M * N + 10 * N))

    def box(B, n, steps):
        return bound(4 * (B * n * n + 3 * B * n + 5 * B),
                     steps * B * (2 * n * n + 6 * n))

    return {
        # A, b, x, gamma, thr -> z, res
        "fb_step": ((B, M, N), *lasso(B, M, N, 2, 3, 1)),
        # A, b, x, z_prev, beta, gamma, thr, done -> x, z_prev, res, rs
        "fista_step": ((B, M, N), *lasso(B, M, N, 4, 6, 1)),
        # A, b, x, z_prev, t, gamma, thr, done -> x, z_prev, t, res
        "fista_k_steps": ((Bk, Mk, Nk), *lasso(Bk, Mk, Nk, 4, 6, K)),
        # Q, q, x, gamma, lo, hi, done -> x, res
        "pg_step": ((Bq, n), *box(Bq, n, 1)),
        "pg_k_steps": ((Bq, n), *box(Bq, n, K)),
        "cp_k_steps": ((Bt, H, W), *cp_bound(Bt, H, W)),
        "read_reduce": ((B, M, N), *read_bound(B, M, N)),
    }


def main():
    card = phase_identify()
    phase_build()
    print("kernel vs plain on the card:")
    worst = check_kernels()
    worst.update(check_new_kernels())
    worst["cp_k_steps"] = check_tv_kernel()
    worst["read_reduce"] = check_read_reduce()
    times = time_kernels(card)
    times.update(time_new_kernels(card))
    tv_times = time_tv_kernel(card)
    times["cp_k_steps"] = tv_times[TV_SHAPES[1]]
    print("read floor, read_reduce vs A.sum(dim=(1, 2)):")
    floors, floor_launches = phase_read_floor(card)
    times["read_reduce"] = floors[MAIN_SHAPES[0]]
    print("cross-path contract at the reference test shapes:")
    check_contract_small()
    check_tv_contract_small()
    launches = phase_main_path(card)
    print("library route, BatchedAlgorithm -> match_kernel_solver:")
    for k, n in phase_routes(card).items():
        launches[k] = launches.get(k, 0) + n
    print("TV route, BatchedAlgorithm -> match_tv_solver:")
    for k, n in phase_tv_routes(card).items():
        launches[k] = launches.get(k, 0) + n
    launches["read_reduce"] = floor_launches
    kernels = {
        "fista_step": ("lasso_step.cu", "proxtpu/kernels/lasso.py:156"),
        "fb_step": ("lasso_step.cu", "proxtpu/kernels/lasso.py:37"),
        "fista_k_steps": ("lasso_step.cu", "proxtpu/kernels/lasso.py:768"),
        "pg_step": ("box_qp_step.cu", "proxtpu/kernels/box_qp.py:31"),
        "pg_k_steps": ("box_qp_step.cu", "proxtpu/kernels/box_qp.py:174"),
        "cp_k_steps": ("tv_step.cu", "proxtpu/kernels/tv.py:76"),
        "read_reduce": ("probe.cu", "benchmarks/trip_overhead_bench.py:83"),
    }
    assert all(launches[k] > 0 for k in kernels), launches
    bounds = kernel_bounds()
    # the one PyTorch call that computes a kernel's function, where there
    # is one: read_reduce's plain version is that call
    library = {"read_reduce": times["read_reduce"][1]}
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda",
         "source": f"proxtpu_torch/csrc/{source}", "replaces": replaces,
         "shape": list(bounds[name][0]), "launches": launches[name],
         "max_abs_err": worst[name], "ms": times[name][0],
         "plain_ms": times[name][1], "bound_ms": bounds[name][1],
         "bound_by": bounds[name][2], "library_ms": library.get(name)}
        for name, (source, replaces) in kernels.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
