"""Hold this tree's lasso and probe kernels against an earlier tree's on one
GPU: the same bits, and the time of both in one call.

    python -m proxtpu_torch.tools.compare_earlier --other-csrc DIR [--plans]

``DIR`` holds the ``lasso_step.cu``, ``probe.cu`` and ``common.cuh`` of the
earlier tree, whose entries ``proxtpu_fista_step`` and ``proxtpu_fb_step``
take no launch plan (one block of 256 threads per lane, A read twice per
step) and whose ``proxtpu_fista_k_steps`` and ``proxtpu_read_reduce`` take
the arguments they take in this tree.

``fista_step`` and ``fb_step``: at every shape a path gives them, a ragged
one, one whose rows take ordinary loads through the ring, one read in place
and one that fits a single stage, the two kernels run on the same inputs,
restart off and on, shrink off and on, with and without frozen lanes: x,
z_prev (= z), ``res`` and ``rs`` must be equal to the last bit.  Then both
are timed, earlier, this, this, earlier, in an eager loop (CUDA events around
the C entries) and at the device's pace (CUDA graph).  ``--plans`` also times
this tree's ``fista_step`` over a grid of threads per block, rows per tile
and stages, with the blocks one SM holds at each plan.

``fista_k_steps``: the two kernels at the wrapper's plan must be equal to the
last bit, restart off and on, and are timed the same way.

``read_reduce``: at every shape the read floor is taken at, the two sums
must be equal to the last bit, and both C entries are timed at the device's
pace.

Needs one GPU and ``nvcc``; prints the card's name and power limit.
"""

import argparse
import ctypes
import statistics
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import torch

from proxtpu_torch.kernels import _build
from proxtpu_torch.kernels import lasso as tl

K = 8
ATOL_K = 5e-5  # chip_smoke.py: K steps of two f32 versions
SHAPES = [(64, 512, 1024), (256, 512, 512), (100, 300, 256), (7, 33, 161),
          (5, 16, 24)]
# the one-step kernels: the main path's two shapes, route (a)'s first step,
# route (d)'s, the small shape, a ragged one, rows off 16 bytes through the
# ring, a lane read in place
STEP_SHAPES = [(256, 200, 400), (64, 200, 400), (256, 400, 200),
               (64, 512, 1024), (1024, 64, 128), (7, 33, 161), (5, 300, 250),
               (2, 24, 12000)]
STEP_TIMED = STEP_SHAPES[:5]
# --plans: threads per block, rows per tile, stages
PLAN_SHAPES = [(256, 200, 400), (64, 200, 400), (256, 400, 200),
               (1024, 64, 128)]
PLAN_ROWS = (8, 10, 16, 20, 23, 25, 32, 40, 50, 64)
PLAN_STAGES = (1, 3, 4, 6)
FLOOR_SHAPES = [(256, 200, 400), (64, 200, 400), (64, 512, 1024),
                (1024, 64, 128), (64, 512, 512), (256, 128, 128)]
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def build_other(csrc):
    """Compile the earlier ``lasso_step.cu`` and ``probe.cu`` into a library
    of their own, with the earlier entries' signatures."""
    out = Path(tempfile.mkdtemp()) / "libother.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                    str(out), str(Path(csrc) / "lasso_step.cu"),
                    str(Path(csrc) / "probe.cu")], check=True,
                   capture_output=True, text=True)
    lib = ctypes.CDLL(str(out))
    lib.proxtpu_fista_step.argtypes = [_P] * 11 + [_I] * 4 + [_P]
    lib.proxtpu_fb_step.argtypes = [_P] * 8 + [_I] * 3 + [_P]
    lib.proxtpu_fista_k_steps.argtypes = [_P] * 9 + [_I] * 9 + [_P]
    lib.proxtpu_read_reduce.argtypes = [_P] * 4 + [_I, _L, _I, _L, _P]
    return lib


def stream():
    return torch._C._cuda_getCurrentRawStream(0)


def compare_read_reduce(other, card):
    from proxtpu_torch.kernels import probe

    this = _build.library().proxtpu_read_reduce
    sms = _build.sm_count(0)
    for B, M, N in FLOOR_SHAPES:
        rng = np.random.default_rng(1)
        A = torch.tensor((rng.standard_normal((B, M, N)) / np.sqrt(M))
                         .astype(np.float32), device="cuda")
        n = M * N
        S, chunk = probe.chunk_plan(B, n, sms)
        partial = torch.empty(B * S, device="cuda")
        counter = torch.zeros(B, dtype=torch.int32, device="cuda")
        out_old, out_new = (torch.empty(B, device="cuda") for _ in range(2))

        def run(fn, out):
            _build.check(fn(A.data_ptr(), partial.data_ptr(),
                            counter.data_ptr(), out.data_ptr(), B, n, S,
                            chunk, stream()), "read_reduce")

        old, new = (lambda: run(other, out_old)), (lambda: run(this, out_new))
        old()
        new()
        torch.cuda.synchronize()
        assert torch.equal(out_old, out_new), (B, M, N)
        assert int(counter.abs().max()) == 0
        o1, n1, n2, o2 = (graph_us(old), graph_us(new), graph_us(new),
                          graph_us(old))
        print(f"read_reduce {(B, M, N)} S={S}: equal to the earlier "
              f"kernel's bits; device pace earlier {o1:.2f} / {o2:.2f} us, "
              f"this {n1:.2f} / {n2:.2f} us  [{card}]")


def inputs(B, M, N, seed, frozen=0.3):
    rng = np.random.default_rng(seed)
    A = (rng.standard_normal((B, M, N)) / np.sqrt(M)).astype(np.float32)
    gamma = (1.0 / np.array([np.linalg.norm(a, 2) ** 2 for a in A])
             ).astype(np.float32)
    arrays = dict(
        A=A, b=rng.standard_normal((B, M)).astype(np.float32),
        x=rng.standard_normal((B, N)).astype(np.float32),
        z_prev=rng.standard_normal((B, N)).astype(np.float32),
        t=rng.uniform(1, 5, B).astype(np.float32), gamma=gamma,
        beta=rng.uniform(0.1, 0.9, B).astype(np.float32),
        thr=(gamma * rng.uniform(0.05, 0.5, B)).astype(np.float32),
        shrink=(1.0 + gamma * 0.3).astype(np.float32),
        done=(rng.random(B) < frozen).astype(np.float32))
    return {k: torch.tensor(v, device="cuda") for k, v in arrays.items()}


def step_plan(B, M, N):
    return tl.step_plan(B, M, N, _build.sm_count(0),
                        _build.max_shared_bytes(0))


def call_fista_step(lib, d, state, restart, shrink, done, plan=None):
    """Launch ``proxtpu_fista_step`` of ``lib`` on ``state`` = (x, z_prev,
    res, rs), x and z_prev updated in place; ``plan`` is ``(threads, R, S,
    bytes)`` for this tree's entry, None for the earlier one."""
    B, M, N = d["A"].shape
    x, zp, res, rs = state
    err = lib.proxtpu_fista_step(
        d["A"].data_ptr(), d["b"].data_ptr(), x.data_ptr(), zp.data_ptr(),
        d["beta"].data_ptr(), d["gamma"].data_ptr(), d["thr"].data_ptr(),
        done.data_ptr(), shrink.data_ptr() if shrink is not None else None,
        res.data_ptr(), rs.data_ptr(), B, M, N, int(restart),
        *(plan or ()), stream())
    _build.check(err, "fista_step")


def call_fb_step(lib, d, out, shrink, plan=None):
    """Launch ``proxtpu_fb_step`` of ``lib``; ``out`` = (z, res)."""
    B, M, N = d["A"].shape
    z, res = out
    err = lib.proxtpu_fb_step(
        d["A"].data_ptr(), d["b"].data_ptr(), d["x"].data_ptr(),
        d["gamma"].data_ptr(), d["thr"].data_ptr(),
        shrink.data_ptr() if shrink is not None else None, z.data_ptr(),
        res.data_ptr(), B, M, N, *(plan or ()), stream())
    _build.check(err, "fb_step")


def fresh_step(d):
    return (d["x"].clone(), d["z_prev"].clone(), torch.empty_like(d["t"]),
            torch.empty_like(d["t"]))


def compare_steps(other, this, card, plans):
    """``fista_step`` and ``fb_step``: bits, then times."""
    for B, M, N in STEP_SHAPES:
        d = inputs(B, M, N, seed=B + M + N, frozen=0.5)
        plan = step_plan(B, M, N)
        live = torch.zeros_like(d["done"])
        cases = 0
        for shrink in (None, d["shrink"]):
            old = (torch.empty_like(d["x"]), torch.empty_like(d["t"]))
            new = (torch.empty_like(d["x"]), torch.empty_like(d["t"]))
            call_fb_step(other, d, old, shrink)
            call_fb_step(this, d, new, shrink, plan)
            torch.cuda.synchronize()
            assert all(torch.equal(a, b) for a, b in zip(old, new)), (
                "fb_step", B, M, N, shrink is not None)
            for restart in (False, True):
                for done in (live, d["done"]):
                    old, new = fresh_step(d), fresh_step(d)
                    call_fista_step(other, d, old, restart, shrink, done)
                    call_fista_step(this, d, new, restart, shrink, done,
                                    plan)
                    torch.cuda.synchronize()
                    assert all(torch.equal(a, b)
                               for a, b in zip(old, new)), (
                        "fista_step", B, M, N, restart, shrink is not None,
                        [float((a - b).abs().max())
                         for a, b in zip(old, new)])
                    cases += 1
        print(f"fista_step, fb_step {(B, M, N)} plan (threads, R, S, bytes) "
              f"= {plan}: x, z_prev, res, rs equal to the earlier kernels' "
              f"bits in {cases} + 2 cases")

    for B, M, N in STEP_TIMED:
        d = inputs(B, M, N, seed=1, frozen=0.0)
        plan = step_plan(B, M, N)
        state = fresh_step(d)
        out = (torch.empty_like(d["x"]), torch.empty_like(d["t"]))
        pairs = {
            "fista_step": (
                lambda: call_fista_step(other, d, state, True, None,
                                        d["done"]),
                lambda: call_fista_step(this, d, state, True, None,
                                        d["done"], plan)),
            "fb_step": (lambda: call_fb_step(other, d, out, None),
                        lambda: call_fb_step(this, d, out, None, plan)),
        }
        for name, (old_fn, new_fn) in pairs.items():
            o1, n1, n2, o2 = (event_us(old_fn), event_us(new_fn),
                              event_us(new_fn), event_us(old_fn))
            g = (graph_us(old_fn), graph_us(new_fn), graph_us(new_fn),
                 graph_us(old_fn))
            print(f"{name} {(B, M, N)} plan {plan}, "
                  f"{blocks_per_sm(name == 'fista_step', M, N, plan)} blocks "
                  f"per SM: eager earlier {o1:.1f} / {o2:.1f} us, this "
                  f"{n1:.1f} / {n2:.1f} us; device pace earlier {g[0]:.1f} / "
                  f"{g[3]:.1f} us, this {g[1]:.1f} / {g[2]:.1f} us  [{card}]")
        if plans and (B, M, N) in PLAN_SHAPES:
            plan_grid(this, d, state, card)


def blocks_per_sm(fista, M, N, plan):
    out = ctypes.c_int()
    _build.check(_build.library().proxtpu_step_blocks_per_sm(
        int(fista), M, N, *plan, ctypes.byref(out)), "step_blocks_per_sm")
    return out.value


def plan_grid(this, d, state, card):
    """This tree's ``fista_step`` at the device's pace over threads per
    block, rows per tile and stages, with the blocks an SM holds."""
    B, M, N = d["A"].shape
    limit = _build.max_shared_bytes(0)
    print(f"  fista_step {(B, M, N)} over plans, device pace  [{card}]:")
    for threads in tl.STEP_THREADS:
        for R in PLAN_ROWS:
            for S in PLAN_STAGES:
                smem = tl.step_shared_bytes(M, N, R, S)
                if R > M or smem + 512 > limit or (S == 1 and R < M):
                    continue
                plan = (threads, R, S, smem)
                fn = lambda: call_fista_step(  # noqa: E731
                    this, d, state, True, None, d["done"], plan)
                print(f"    threads={threads} R={R} S={S} ({smem} B, "
                      f"{blocks_per_sm(True, M, N, plan)} per SM, "
                      f"{-(-M // R)} tiles): {graph_us(fn, reps=5):.1f} us")


def call_k_steps(lib, d, state, restart, plan):
    """Launch ``proxtpu_fista_k_steps`` of ``lib`` on the state tensors
    (updated in place) at ``plan`` = (C, R, S)."""
    B, M, N = d["A"].shape
    x, zp, t, res = state
    C, R, S = plan
    err = lib.proxtpu_fista_k_steps(
        d["A"].data_ptr(), d["b"].data_ptr(), x.data_ptr(), zp.data_ptr(),
        t.data_ptr(), d["gamma"].data_ptr(), d["thr"].data_ptr(),
        d["done"].data_ptr(), res.data_ptr(), B, M, N, K, int(restart), C, R,
        S, tl.k_steps_shared_bytes(M, N, C, R, S), stream())
    _build.check(err, "fista_k_steps")


def fresh(d):
    return (d["x"].clone(), d["z_prev"].clone(), d["t"].clone(),
            torch.empty_like(d["t"]))


def compare_k_steps(other, this, card):
    limit, sms = _build.max_shared_bytes(0), _build.sm_count(0)
    for B, M, N in SHAPES:
        d = inputs(B, M, N, seed=B + M + N)
        plan = tl.k_steps_plan(B, M, N, sms, limit)
        for restart in (False, True):
            want = tl.reference_fista_k_steps(
                d["A"], d["b"], d["x"], d["z_prev"], d["t"], d["gamma"],
                d["thr"], d["done"], K=K, restart=restart)
            old, new = fresh(d), fresh(d)
            call_k_steps(other, d, old, restart, plan)
            call_k_steps(this, d, new, restart, plan)
            torch.cuda.synchronize()
            err = max(float((g - w).abs().max()) for g, w in zip(new, want))
            same = all(torch.equal(a, b) for a, b in zip(old, new))
            line = (f"fista_k_steps {(B, M, N)} restart={restart} plan C, R, "
                    f"S = {plan}: equal to the earlier kernel's bits: {same}, "
                    f"max|err| to plain {err:.3e}")
            print(line)
            assert same and err <= ATOL_K, line
    for B, M, N in SHAPES[:2]:
        d = inputs(B, M, N, seed=1, frozen=0.0)
        plan = tl.k_steps_plan(B, M, N, sms, limit)
        state = fresh(d)
        old_fn = lambda: call_k_steps(other, d, state, True, plan)  # noqa: E731
        new_fn = lambda: call_k_steps(this, d, state, True, plan)  # noqa: E731
        o1, n1, n2, o2 = (event_us(old_fn), event_us(new_fn),
                          event_us(new_fn), event_us(old_fn))
        g = (graph_us(old_fn), graph_us(new_fn), graph_us(new_fn),
             graph_us(old_fn))
        print(f"fista_k_steps {(B, M, N)} K={K} plan C, R, S = {plan}: eager "
              f"earlier {o1:.1f} / {o2:.1f} us, this {n1:.1f} / {n2:.1f} us; "
              f"device pace earlier {g[0]:.1f} / {g[3]:.1f} us, this "
              f"{g[1]:.1f} / {g[2]:.1f} us  [{card}]")


def event_us(fn, reps=10, inner=10):
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
        ts.append(1e3 * start.elapsed_time(end) / inner)
    return statistics.median(ts)


def graph_us(fn, reps=20, inner=10):
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
        ts.append(1e3 * start.elapsed_time(end) / inner)
    return statistics.median(ts)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other-csrc", required=True)
    ap.add_argument("--plans", action="store_true")
    args = ap.parse_args()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    other = build_other(args.other_csrc)
    this = _build.library()
    print((_build.build_dir() / "nvcc.log").read_text())
    compare_steps(other, this, card, args.plans)
    compare_k_steps(other, this, card)
    compare_read_reduce(other.proxtpu_read_reduce, card)


if __name__ == "__main__":
    main()
