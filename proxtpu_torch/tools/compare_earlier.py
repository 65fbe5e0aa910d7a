"""Hold this tree's kernels against an earlier tree's on one GPU: the same
bits, and the time of both in one call.

    python -m proxtpu_torch.tools.compare_earlier --other-csrc DIR [--plans]

``DIR`` holds the kernel sources (every ``*.cu`` is built) and headers of
the earlier tree, for example

    mkdir -p build/parent_csrc && git archive COMMIT proxtpu_torch/csrc \\
        | tar -x --strip-components=2 -C build/parent_csrc

whose entries ``proxtpu_fista_step``, ``proxtpu_fb_step``, their bfloat16
instances, ``proxtpu_fista_k_steps``, ``proxtpu_read_reduce``,
``proxtpu_pg_k_steps`` and ``proxtpu_cp_k_steps`` take the arguments they
take in this tree: the sources of commit 00b8358 and later.  Earlier trees,
whose bf16 entries take no ``cols`` and ``xregs``, are out of scope.

``fista_step`` and ``fb_step``: at every shape a path gives them, a ragged
one, one whose rows take ordinary loads through the ring, one read in place
and one that fits a single stage, the two kernels run on the same inputs,
restart off and on, shrink off and on, with and without frozen lanes: x,
z_prev (= z), ``res`` and ``rs`` must be equal to the last bit; so must this
tree's bfloat16-A instance of each against the earlier float32 kernel on
``A16.float()`` and against the earlier bfloat16 instance at the same
plan.  Then both are timed, earlier, this, this, earlier, in an eager loop
(CUDA events around the C entries) and at the device's pace (CUDA graph),
and the bfloat16 instances likewise at the device's pace, beside this
tree's float32 instance.  ``--plans`` also times this tree's
``fista_step`` over a grid of threads per block, rows per tile and stages,
with the blocks one SM holds at each plan; and the bfloat16 instances over
threads, rows per tile and stages, the earlier kernel and this one at each
plan (each plan's bits held), then both at this tree's plan with each of
the passes' choices (x in registers, two columns a thread) on and off.

``fista_k_steps``: the two kernels at the wrapper's plan must be equal to the
last bit, restart off and on, and are timed the same way.

``pg_step`` and ``pg_k_steps``: at route (b)'s shape, the small one and a
ragged one, K = 1 and 8, with and without frozen lanes, x and ``res`` equal
to the last bit, and both timed at route (b)'s shape.  ``--plans`` also
times this tree's kernel over blocks per lane, rows per tile and stages
(each plan's bits held too).

``cp_k_steps``: at routes (e) and (f)'s shapes, a ragged one, the
reference's test shape and an image no cluster holds, K = 1 and 8, lam
uniform and per image, from zero and from a warm state, with and without
frozen images, x, yx, yy and ``res`` equal to the last bit (this tree
through its wrapper; the earlier entry at the same plan, or its halo
variant where no cluster holds an image); both timed at the routes'
shapes.  ``--plans`` also times this tree's cluster variant over blocks per
image and threads per block (each plan's bits held too).

``read_reduce``: at every shape the read floor is taken at, the two sums
must be equal to the last bit, and both C entries are timed at the device's
pace.  ``--plans`` also times this tree's bfloat16 instance at the one-step
kernels' two main shapes over the chunks a lane is cut into.

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
from proxtpu_torch.kernels import box_qp as tb
from proxtpu_torch.kernels import lasso as tl
from proxtpu_torch.kernels import tv

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
# --plans, the bfloat16 instances: threads per block, rows per tile, stages
BF16_PLAN_SHAPES = [(256, 200, 400), (64, 200, 400)]
BF16_PLAN_THREADS = (256, 512)
BF16_PLAN_ROWS = (8, 16, 24, 29, 32, 40, 44, 48, 64, 67, 68, 80)
BF16_PLAN_STAGES = (3, 4, 5, 6)
# --plans, the bf16 read floor: chunks a lane
FLOOR_CHUNKS = (1, 2, 3, 4, 5, 6, 8, 16)
FLOOR_SHAPES = [(256, 200, 400), (64, 200, 400), (64, 512, 1024),
                (1024, 64, 128), (64, 512, 512), (256, 128, 128)]
# the box-QP kernels: route (b), the small shape, ragged rows
PG_SHAPES = [(64, 512), (256, 128), (7, 161)]
# --plans: blocks per lane, rows per tile, stages
PG_PLAN_C = (1, 2, 4)
PG_PLAN_ROWS = (8, 16, 32, 64)
PG_PLAN_STAGES = (3, 4)
# cp_k_steps: routes (e) and (f), ragged, the reference's test shape, the
# halo variant; timed at the first two
TV_SHAPES = [(64, 64, 64), (64, 256, 256), (7, 33, 21), (4, 16, 24),
             (3, 301, 203), (2, 40, 1500), (2, 512, 512)]
TV_TIMED = TV_SHAPES[:2]
# --plans: blocks per image and threads per block
TV_PLAN_C = {(64, 64, 64): (1, 2, 4), (64, 256, 256): (6, 8, 16)}
TV_PLAN_THREADS = tv.CP_THREADS


def build_other(csrc):
    """Compile the earlier sources into a library of their own; the entries
    compared take this tree's signatures."""
    out = Path(tempfile.mkdtemp()) / "libother.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                    str(out), *map(str, sorted(Path(csrc).glob("*.cu")))],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(out))
    for name in ("proxtpu_fista_step", "proxtpu_fb_step",
                 "proxtpu_fista_step_bf16", "proxtpu_fb_step_bf16",
                 "proxtpu_fista_k_steps", "proxtpu_read_reduce",
                 "proxtpu_pg_k_steps", "proxtpu_cp_k_steps",
                 "proxtpu_cp_k_steps_halo"):
        getattr(lib, name).argtypes = _build._SIGNATURES[name]
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


def floor_bf16_grid(card):
    """This tree's bf16 ``read_reduce`` at the device's pace over the chunks
    a lane is cut into, beside the wrapper's plan and the library call."""
    from proxtpu_torch.kernels import probe

    entry = _build.library().proxtpu_read_reduce_bf16
    for B, M, N in BF16_PLAN_SHAPES:
        rng = np.random.default_rng(1)
        A = torch.tensor((rng.standard_normal((B, M, N)) / np.sqrt(M))
                         .astype(np.float32), device="cuda").to(torch.bfloat16)
        n = M * N
        want = A.float().sum(dim=(1, 2))
        library = graph_us(lambda: A.sum(dim=(1, 2), dtype=torch.float32))
        print(f"read_reduce_bf16 {(B, M, N)} over chunks a lane, device pace; "
              f"plan {probe.chunk_plan(B, n, _build.sm_count(0), 2)}, "
              f"library A.sum(dtype=float32) {library:.2f} us  [{card}]")
        for chunks in FLOOR_CHUNKS:
            chunk = -(-n // chunks)
            chunk += -chunk % 8
            S = -(-n // chunk)
            partial = torch.empty(B * S, device="cuda")
            counter = torch.zeros(B, dtype=torch.int32, device="cuda")
            out = torch.empty(B, device="cuda")

            def run():
                _build.check(entry(A.data_ptr(), partial.data_ptr(),
                                   counter.data_ptr(), out.data_ptr(), B, n,
                                   S, chunk, stream()), "read_reduce_bf16")

            run()
            torch.cuda.synchronize()
            rel = float(((out - want).abs()
                         / A.float().abs().sum(dim=(1, 2))).max())
            assert rel <= 1e-5, (S, rel)
            print(f"  S={S} chunk={chunk} ({B * S} blocks): "
                  f"{graph_us(run):.2f} us")


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


def step_plan(B, M, N, elem=4):
    return tl.step_plan(B, M, N, _build.sm_count(0),
                        _build.max_shared_bytes(0), elem)


def call_fista_step(lib, d, state, restart, shrink, done, plan, A=None):
    """Launch ``proxtpu_fista_step`` of ``lib`` on ``state`` = (x, z_prev,
    res, rs), x and z_prev updated in place, at ``plan`` = ``(threads, R,
    S, bytes)``; an ``A`` in bfloat16 takes ``proxtpu_fista_step_bf16``,
    whose plan has ``(cols, xregs)`` after the bytes."""
    A = d["A"] if A is None else A
    B, M, N = A.shape
    x, zp, res, rs = state
    entry = (lib.proxtpu_fista_step_bf16 if A.dtype == torch.bfloat16
             else lib.proxtpu_fista_step)
    err = entry(
        A.data_ptr(), d["b"].data_ptr(), x.data_ptr(), zp.data_ptr(),
        d["beta"].data_ptr(), d["gamma"].data_ptr(), d["thr"].data_ptr(),
        done.data_ptr(), shrink.data_ptr() if shrink is not None else None,
        res.data_ptr(), rs.data_ptr(), B, M, N, int(restart), *plan,
        stream())
    _build.check(err, "fista_step")


def call_fb_step(lib, d, out, shrink, plan, A=None):
    """Launch ``proxtpu_fb_step`` of ``lib``, or ``proxtpu_fb_step_bf16``
    for an ``A`` in bfloat16; ``out`` = (z, res)."""
    A = d["A"] if A is None else A
    B, M, N = A.shape
    z, res = out
    entry = (lib.proxtpu_fb_step_bf16 if A.dtype == torch.bfloat16
             else lib.proxtpu_fb_step)
    err = entry(
        A.data_ptr(), d["b"].data_ptr(), d["x"].data_ptr(),
        d["gamma"].data_ptr(), d["thr"].data_ptr(),
        shrink.data_ptr() if shrink is not None else None, z.data_ptr(),
        res.data_ptr(), B, M, N, *plan, stream())
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
            call_fb_step(other, d, old, shrink, plan)
            call_fb_step(this, d, new, shrink, plan)
            torch.cuda.synchronize()
            assert all(torch.equal(a, b) for a, b in zip(old, new)), (
                "fb_step", B, M, N, shrink is not None)
            for restart in (False, True):
                for done in (live, d["done"]):
                    old, new = fresh_step(d), fresh_step(d)
                    call_fista_step(other, d, old, restart, shrink, done,
                                    plan)
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
        compare_bf16(other, this, d, plan)

    for B, M, N in STEP_TIMED:
        d = inputs(B, M, N, seed=1, frozen=0.0)
        plan = step_plan(B, M, N)
        state = fresh_step(d)
        out = (torch.empty_like(d["x"]), torch.empty_like(d["t"]))
        pairs = {
            "fista_step": (
                lambda: call_fista_step(other, d, state, True, None,
                                        d["done"], plan),
                lambda: call_fista_step(this, d, state, True, None,
                                        d["done"], plan)),
            "fb_step": (lambda: call_fb_step(other, d, out, None, plan),
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
        time_bf16(other, this, d, state, out, card)
        if plans and (B, M, N) in PLAN_SHAPES:
            plan_grid(this, d, state, card)
        if plans and (B, M, N) in BF16_PLAN_SHAPES:
            bf16_plan_grid(other, this, d, state, out, card)


def compare_bf16(other, this, d, plan):
    """This tree's bfloat16-A instances against the earlier float32 kernels
    on ``A16.float()`` (at the float32 plan ``plan``) and against the
    earlier bf16 instances (at this tree's bf16 plan), shrink, restart,
    frozen lanes: equal to the last bit."""
    B, M, N = d["A"].shape
    A16 = d["A"].to(torch.bfloat16)
    d32 = dict(d, A=A16.float())
    plan16 = step_plan(B, M, N, 2)
    live = torch.zeros_like(d["done"])
    cases = 0
    for shrink in (None, d["shrink"]):
        outs = [(torch.empty_like(d["x"]), torch.empty_like(d["t"]))
                for _ in range(3)]
        call_fb_step(other, d32, outs[0], shrink, plan)
        call_fb_step(other, d, outs[1], shrink, plan16, A=A16)
        call_fb_step(this, d, outs[2], shrink, plan16, A=A16)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for o in outs[1:]
                   for a, b in zip(outs[0], o)), (
            "fb_step_bf16", B, M, N, shrink is not None)
        for restart in (False, True):
            for done in (live, d["done"]):
                states = [fresh_step(d) for _ in range(3)]
                call_fista_step(other, d32, states[0], restart, shrink, done,
                                plan)
                call_fista_step(other, d, states[1], restart, shrink, done,
                                plan16, A=A16)
                call_fista_step(this, d, states[2], restart, shrink, done,
                                plan16, A=A16)
                torch.cuda.synchronize()
                assert all(torch.equal(a, b) for s in states[1:]
                           for a, b in zip(states[0], s)), (
                    "fista_step_bf16", B, M, N, restart, shrink is not None)
                cases += 1
    print(f"fista_step_bf16, fb_step_bf16 {(B, M, N)} plan {plan16}: equal "
          f"to the earlier float32 kernels' bits on A16.float() and to the "
          f"earlier bf16 instances' in {cases} + 2 cases")


def time_bf16(other, this, d, state, out, card):
    """The bf16 instances at the device's pace, the earlier and this at this
    tree's plan, in turns, beside this tree's float32 instance."""
    B, M, N = d["A"].shape
    A16 = d["A"].to(torch.bfloat16)
    plan, plan16 = step_plan(B, M, N), step_plan(B, M, N, 2)
    for name in ("fista_step", "fb_step"):
        fista = name == "fista_step"

        def run(lib, p, A=None):
            if fista:
                return lambda: call_fista_step(lib, d, state, True, None,
                                               d["done"], p, A=A)
            return lambda: call_fb_step(lib, d, out, None, p, A=A)

        old_fn, new_fn = run(other, plan16, A16), run(this, plan16, A16)
        g = (graph_us(old_fn), graph_us(new_fn), graph_us(new_fn),
             graph_us(old_fn))
        f32 = graph_us(run(this, plan))
        print(f"{name}_bf16 {(B, M, N)} plan {plan16}, "
              f"{blocks_per_sm(fista, M, N, plan16, 2)} blocks per SM: "
              f"device pace earlier {g[0]:.1f} / {g[3]:.1f} us, this "
              f"{g[1]:.1f} / {g[2]:.1f} us; float32 instance {f32:.1f} us  "
              f"[{card}]")


def blocks_per_sm(fista, M, N, plan, elem=4):
    """Blocks of this tree's kernel one SM holds at ``plan``: (threads, R,
    S, bytes), and for bf16 (cols, xregs) after them."""
    out = ctypes.c_int()
    fields = tuple(plan[4:]) if elem == 2 else (1, 0)
    _build.check(_build.library().proxtpu_step_blocks_per_sm(
        int(fista), elem, M, N, *plan[:4], *fields, ctypes.byref(out)),
        "step_blocks_per_sm")
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


def bf16_plan_grid(other, this, d, state, out, card):
    """The bf16 instances at the device's pace: ``fista_step`` over threads
    per block, rows per tile and stages, the earlier kernel and this one at
    each plan, each plan's bits held against the float32 kernel on
    ``A16.float()``; then both kernels at this tree's plan with x in
    registers and two columns a thread each on and off."""
    B, M, N = d["A"].shape
    A16 = d["A"].to(torch.bfloat16)
    d32 = dict(d, A=A16.float())
    limit = _build.max_shared_bytes(0)
    plan32 = step_plan(B, M, N)
    want = fresh_step(d)
    call_fista_step(this, d32, want, True, None, d["done"], plan32)

    def held(lib, plan):
        got = fresh_step(d)
        call_fista_step(lib, d, got, True, None, d["done"], plan, A=A16)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(want, got)), (
            "bf16 plan", plan)
        return lambda: call_fista_step(lib, d, state, True, None, d["done"],
                                       plan, A=A16)

    print(f"  fista_step_bf16 {(B, M, N)} over plans, device pace, earlier "
          f"kernel / this one  [{card}]:")
    for threads in BF16_PLAN_THREADS:
        for R in BF16_PLAN_ROWS:
            for S in BF16_PLAN_STAGES:
                smem = tl.step_shared_bytes(M, N, R, S, 2)
                if R > M or smem + 512 > limit:
                    continue
                plan = (threads, R, S, smem) + tl.bf16_fields(N, threads, S)
                old_us = graph_us(held(other, plan), reps=5)
                new_us = graph_us(held(this, plan), reps=5)
                print(f"    threads={threads} R={R} S={S} ({smem} B, "
                      f"{blocks_per_sm(True, M, N, plan, 2)} per SM, "
                      f"{-(-M // R)} tiles): {old_us:.1f} / {new_us:.1f} us")
    plan16 = step_plan(B, M, N, 2)
    print(f"  the bf16 instances {(B, M, N)} by pass choice, device pace, "
          f"plan {plan16[:4]}, earlier kernel / this one  [{card}]:")
    for name in ("fista_step", "fb_step"):
        fista = name == "fista_step"

        def run(lib, plan):
            if fista:
                return held(lib, plan)
            return lambda: call_fb_step(lib, d, out, None, plan, A=A16)

        most_cols, most_xregs = plan16[4:]
        for cols in range(1, most_cols + 1):
            for xregs in range(most_xregs + 1):
                plan = plan16[:4] + (cols, xregs)
                print(f"    {name}_bf16 cols={cols} xregs={xregs}: "
                      f"{graph_us(run(other, plan), reps=10):.1f} / "
                      f"{graph_us(run(this, plan), reps=10):.1f} us")


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


def pg_inputs(B, n, seed, frozen=0.3):
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((B, n, n))
    Q = ((G + G.transpose(0, 2, 1)) / (2 * np.sqrt(2 * n))).astype(np.float32)
    L = np.abs(np.linalg.eigvalsh(Q.astype(np.float64))).max(axis=1)
    arrays = dict(
        Q=Q, q=rng.standard_normal((B, n)).astype(np.float32),
        x=rng.uniform(-1, 1, (B, n)).astype(np.float32),
        gamma=(0.95 / L).astype(np.float32),
        lo=np.full(B, -1.0, np.float32), hi=np.full(B, 1.0, np.float32),
        done=(rng.random(B) < frozen).astype(np.float32))
    return {k: torch.tensor(v, device="cuda") for k, v in arrays.items()}


def call_pg(lib, d, x, res, K, done, plan):
    """K steps of ``lib``'s ``pg_k_steps`` on x (in place) at ``plan`` =
    (C, R, S)."""
    B, n = d["q"].shape
    ptrs = (d["Q"].data_ptr(), d["q"].data_ptr(), x.data_ptr(),
            d["gamma"].data_ptr(), d["lo"].data_ptr(), d["hi"].data_ptr(),
            None if done is None else done.data_ptr(), res.data_ptr())
    err = lib.proxtpu_pg_k_steps(*ptrs, B, n, K, *plan,
                                 tb.pg_shared_bytes(n, n, *plan), stream())
    _build.check(err, "pg_k_steps")


def compare_pg(other, this, card, plans):
    """``pg_step`` and ``pg_k_steps``: bits at PG_SHAPES, then times."""
    sms, limit = _build.sm_count(0), _build.max_shared_bytes(0)

    def same(d, K, done, plan):
        B, n = d["q"].shape
        old = (d["x"].clone(), torch.empty(B, device="cuda"))
        new = (d["x"].clone(), torch.empty(B, device="cuda"))
        call_pg(other, d, *old, K, done, tb.pg_plan(B, n, sms, limit))
        call_pg(this, d, *new, K, done, plan)
        torch.cuda.synchronize()
        return all(torch.equal(a, b) for a, b in zip(old, new))

    for B, n in PG_SHAPES:
        d = pg_inputs(B, n, seed=B + n)
        plan = tb.pg_plan(B, n, sms, limit)
        for K_ in (1, K):
            for done in (None, d["done"]):
                assert same(d, K_, done, plan), ("pg", B, n, K_, plan)
        print(f"pg_step, pg_k_steps {(B, n)} plan C, R, S = {plan}: x, res "
              f"equal to the earlier kernel's bits, K = 1 and {K}, "
              f"{int(d['done'].sum())} lanes frozen or none")
    B, n = PG_SHAPES[0]
    d = pg_inputs(B, n, seed=1, frozen=0.0)
    plan = tb.pg_plan(B, n, sms, limit)
    x, res = d["x"].clone(), torch.empty(B, device="cuda")
    live = d["done"]
    for K_ in (1, K):
        old_fn = lambda: call_pg(other, d, x, res, K_, live,  # noqa: E731
                                 plan)
        new_fn = lambda: call_pg(this, d, x, res, K_, live,  # noqa: E731
                                 plan)
        o1, n1, n2, o2 = (event_us(old_fn), event_us(new_fn),
                          event_us(new_fn), event_us(old_fn))
        g = (graph_us(old_fn), graph_us(new_fn), graph_us(new_fn),
             graph_us(old_fn))
        print(f"pg_k_steps {(B, n)} K={K_} plan C, R, S = {plan}: eager "
              f"earlier {o1:.1f} / {o2:.1f} us, this {n1:.1f} / {n2:.1f} us; "
              f"device pace earlier {g[0]:.1f} / {g[3]:.1f} us, this "
              f"{g[1]:.1f} / {g[2]:.1f} us  [{card}]")
    if not plans:
        return
    print(f"  pg_k_steps {(B, n)} K={K} over plans, device pace  [{card}]:")
    for C in PG_PLAN_C:
        for R in PG_PLAN_ROWS:
            for S in PG_PLAN_STAGES:
                if tb.pg_shared_bytes(n, n, C, R, S) > limit:
                    continue
                d_live = dict(d, done=live)
                assert same(d_live, K, live, (C, R, S)), ("pg", C, R, S)
                fn = lambda: call_pg(this, d, x, res, K, live,  # noqa: E731
                                     (C, R, S))
                print(f"    C={C} R={R} S={S} ({-(-(n // C) // R)} tiles a "
                      f"step): {graph_us(fn, reps=5):.1f} us, bits equal")


def tv_inputs(B, H, W, seed, frozen=0.5):
    rng = np.random.default_rng(seed)
    g1, g2 = tv.default_tv_stepsizes()
    clean = np.zeros((B, H, W), np.float32)
    clean[:, H // 4: 3 * H // 4, W // 4: 3 * W // 4] = 1.0
    arrays = dict(
        b=clean + 0.15 * rng.standard_normal((B, H, W)).astype(np.float32),
        x=rng.standard_normal((B, H, W)).astype(np.float32),
        yx=(0.05 * rng.standard_normal((B, H, W))).astype(np.float32),
        yy=(0.05 * rng.standard_normal((B, H, W))).astype(np.float32),
        g1=np.full(B, g1, np.float32), g2=np.full(B, g2, np.float32),
        lam=np.full(B, 0.12, np.float32),
        lams=rng.uniform(0.05, 0.3, B).astype(np.float32),
        done=(rng.random(B) < frozen).astype(np.float32))
    return {k: torch.tensor(v, device="cuda") for k, v in arrays.items()}


def call_cp(lib, ops, out, res, K, done, plan):
    """K steps of ``lib``'s ``cp_k_steps`` from ``ops`` = (b, x, yx, yy, g1,
    g2, lam) into ``out`` and ``res``: the cluster variant at ``plan`` =
    (C, threads), or the halo variant where ``plan`` is ``cp_plan``'s halo
    plan (a scratch of its own, zeroed)."""
    B, H, W = ops[0].shape
    ptrs = [t.data_ptr() for t in ops]
    ptrs += [None if done is None else done.data_ptr()]
    ptrs += [t.data_ptr() for t in out] + [res.data_ptr()]
    if getattr(plan, "variant", "cluster") == "halo":
        scratch = torch.zeros((B, 4), dtype=torch.int32, device="cuda")
        err = lib.proxtpu_cp_k_steps_halo(*ptrs, scratch.data_ptr(), B, H, W,
                                          K, plan.TH, plan.TW, stream())
    else:
        C, threads = plan[1:3] if hasattr(plan, "variant") else plan
        err = lib.proxtpu_cp_k_steps(*ptrs, B, H, W, K, C, threads,
                                     tv.cp_band_bytes(H, W, C), stream())
    _build.check(err, "cp_k_steps")


def active_clusters(H, W, C, threads):
    out = ctypes.c_int()
    _build.check(_build.library().proxtpu_cp_active_clusters(
        H, W, C, threads, tv.cp_band_bytes(H, W, C), ctypes.byref(out)),
        "cp_active_clusters")
    return out.value


def compare_tv(other, card, plans):
    """``cp_k_steps``: bits at TV_SHAPES (this tree through its wrapper, at
    its plan), then times at TV_TIMED."""
    sms, limit = _build.sm_count(0), _build.max_shared_bytes(0)

    def run_old(d, ops, K_, done):
        B, H, W = ops[0].shape
        out = tuple(torch.empty_like(ops[0]) for _ in range(3))
        res = torch.empty(B, device="cuda")
        call_cp(other, ops, out, res, K_, done,
                tv.cp_plan(B, H, W, K_, sms, limit))
        return (*out, res)

    for B, H, W in TV_SHAPES:
        d = tv_inputs(B, H, W, seed=B + H + W)
        zero = torch.zeros_like(d["b"])
        for K_ in (1, K):
            plan = tv.cp_plan(B, H, W, K_, sms, limit)
            cases = 0
            for lam in (d["lam"], d["lams"]):
                for state in ((zero,) * 3, (d["x"], d["yx"], d["yy"])):
                    for done in (None, d["done"]):
                        ops = (d["b"], *state, d["g1"], d["g2"], lam)
                        old = run_old(d, ops, K_, done)
                        new = tv.fused_cp_k_steps(*ops, K_, done)
                        torch.cuda.synchronize()
                        assert all(torch.equal(a, b) for a, b in
                                   zip(old, new)), ("cp", B, H, W, K_, plan)
                        cases += 1
            print(f"cp_k_steps {(B, H, W)} K={K_} plan {tuple(plan)}: x, "
                  f"yx, yy, res equal to the earlier kernel's bits in "
                  f"{cases} cases")
    for B, H, W in TV_TIMED:
        d = tv_inputs(B, H, W, seed=1, frozen=0.0)
        ops = (d["b"], d["x"], d["yx"], d["yy"], d["g1"], d["g2"], d["lam"])
        out = tuple(torch.empty_like(d["b"]) for _ in range(3))
        res = torch.empty(B, device="cuda")
        plan = tv.cp_plan(B, H, W, K, sms, limit)
        old_fn = lambda: call_cp(other, ops, out, res, K,  # noqa: E731
                                 None, plan)
        new_fn = lambda: call_cp(_build.library(), ops, out,  # noqa: E731
                                 res, K, None, (plan.C, plan.threads))
        o1, n1, n2, o2 = (event_us(old_fn), event_us(new_fn),
                          event_us(new_fn), event_us(old_fn))
        g = (graph_us(old_fn), graph_us(new_fn), graph_us(new_fn),
             graph_us(old_fn))
        print(f"cp_k_steps {(B, H, W)} K={K} plan {tuple(plan)}: eager "
              f"earlier {o1:.1f} / {o2:.1f} us, this {n1:.1f} / {n2:.1f} us; "
              f"device pace earlier {g[0]:.1f} / {g[3]:.1f} us, this "
              f"{g[1]:.1f} / {g[2]:.1f} us  [{card}]")
        if not plans:
            continue
        want = run_old(d, ops, K, None)
        print(f"  cp_k_steps {(B, H, W)} K={K} over plans, device pace "
              f"[{card}]:")
        for C in TV_PLAN_C[(B, H, W)]:
            for threads in TV_PLAN_THREADS:
                if tv.cp_band_bytes(H, W, C) + 1024 > limit:
                    continue
                fn = lambda: call_cp(  # noqa: E731
                    _build.library(), ops, out, res, K, None, (C, threads))
                fn()
                torch.cuda.synchronize()
                assert all(torch.equal(a, b) for a, b in
                           zip(want, (*out, res))), ("cp", C, threads)
                print(f"    C={C} threads={threads} "
                      f"({-(-H // C)} rows a block, "
                      f"{active_clusters(H, W, C, threads)} clusters at "
                      f"once): {graph_us(fn, reps=5):.1f} us, bits equal")


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
    if args.plans:
        floor_bf16_grid(card)
    compare_pg(other, this, card, args.plans)
    compare_tv(other, card, args.plans)


if __name__ == "__main__":
    main()
