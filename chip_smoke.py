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
5. print the kernels' JSON line, then the result line.

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
CHECK_SHAPES = MAIN_SHAPES + [(7, 33, 161)]      # + ragged M and N
# One step against its plain version.  Both sum 200- and 400-term f32
# products in different orders (warp shuffles vs cuBLAS), so each output
# carries a few ulps of its largest partial sums: iterates and residuals
# are O(1) here, so 1e-5 absolute is ~100 ulps of headroom.  rs sums 400
# such products of O(1) differences and can reach O(10), so it is held
# relative to its size.
ATOL = 1e-5
RS_RTOL = 1e-4


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
    it itself (tests/test_kernels.py:49-61): every lane done, counts within
    +-1, solutions within 1e-4."""
    from proxtpu_torch import problems_from_numpy
    from proxtpu_torch.kernels import lasso as tl

    for (B, M, N, seed) in ((5, 16, 24, 0), (8, 16, 160, 5)):
        rng = np.random.default_rng(seed)
        As = (rng.standard_normal((B, M, N)) / np.sqrt(M)).astype(np.float32)
        bs = rng.standard_normal((B, M)).astype(np.float32)
        lams = 0.1 * np.max(np.abs(np.einsum("bmn,bm->bn", As, bs)), axis=1)
        Lfs = np.array([np.linalg.norm(a, 2) ** 2 for a in As])
        P = problems_from_numpy(As, bs, lams, Lfs, device=DEVICE)
        for restart in (False, True):
            for solver, kw in (
                    (tl.solve_lasso_batch, {}),
                    (tl.solve_lasso_batch_packed_tail,
                     dict(k1=40, tail=B // 2))):
                z1, i1, d1 = solver(*P, TOL, maxit=3000, restart=restart,
                                    **kw)
                z2, i2, d2 = solver(*P, TOL, maxit=3000, restart=restart,
                                    use_kernel=False, **kw)
                assert bool(d1.all()) and bool(d2.all())
                dit = int((i1 - i2).abs().max())
                dz = max_err(z1, z2)
                assert dit <= 1 and dz <= 1e-4, (B, M, N, restart, dit, dz)
                print(f"  {solver.__name__} {(B, M, N)} restart={restart}: "
                      f"max|d iters| {dit}, max|d x| {dz:.2e}")


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


def main():
    card = phase_identify()
    phase_build()
    print("kernel vs plain on the card:")
    worst = check_kernels()
    flagship = time_kernels(card)
    print("cross-path contract at the reference test shapes:")
    check_contract_small()
    launches = phase_main_path(card)
    replaces = {"fb_step": "proxtpu/kernels/lasso.py:37",
                "fista_step": "proxtpu/kernels/lasso.py:156"}
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda",
         "source": "proxtpu_torch/csrc/lasso_step.cu",
         "replaces": replaces[name], "launches": launches[name],
         "max_abs_err": worst[name], "ms": flagship[name][0],
         "plain_ms": flagship[name][1]}
        for name in ("fista_step", "fb_step")]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
