"""Hold this tree's ``fista_k_steps`` and ``read_reduce`` kernels against an
earlier tree's on one GPU: the same bits, and the time of both in one call.

    python -m proxtpu_torch.tools.compare_earlier --other-csrc DIR [--plans]

``DIR`` holds the ``lasso_step.cu``, ``probe.cu`` and ``common.cuh`` of the
earlier tree, whose entry ``proxtpu_fista_k_steps`` takes no launch plan (one
thread block per lane, A read twice per inner step) and whose
``proxtpu_read_reduce`` takes no ticket counters (two launches a call).

``fista_k_steps``: for each shape the two kernels run on the same inputs,
restart off and on: with one block per lane (C = 1) the results must be
equal to the last bit; at the plan the wrapper would choose they must agree
with the plain version within 5e-5.  Then both are timed, earlier, this,
this, earlier, in an eager loop (CUDA events) and at the device's pace (CUDA
graph).  ``--plans`` also times this tree's kernel over a grid of blocks per
lane, rows per tile and stages.

``read_reduce``: at every shape the read floor is taken at, the two sums
must be equal to the last bit (both add a lane's partial sums in order), and
both C entries are timed at the device's pace.

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
_P, _I = ctypes.c_void_p, ctypes.c_int


FLOOR_SHAPES = [(256, 200, 400), (64, 200, 400), (64, 512, 1024),
                (1024, 64, 128), (64, 512, 512), (256, 128, 128)]
_L = ctypes.c_longlong


def build_other(csrc):
    """Compile the earlier ``lasso_step.cu`` and ``probe.cu`` into a library
    of their own; returns its two entries."""
    out = Path(tempfile.mkdtemp()) / "libother.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                    str(out), str(Path(csrc) / "lasso_step.cu"),
                    str(Path(csrc) / "probe.cu")], check=True,
                   capture_output=True, text=True)
    lib = ctypes.CDLL(str(out))
    lib.proxtpu_fista_k_steps.argtypes = [_P] * 9 + [_I] * 5 + [_P]
    lib.proxtpu_read_reduce.argtypes = [_P] * 3 + [_I, _L, _I, _L, _P]
    return lib.proxtpu_fista_k_steps, lib.proxtpu_read_reduce


def compare_read_reduce(other, card):
    """The earlier probe (two launches) against this tree's (one)."""
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
        out_old, out_new = torch.empty(B, device="cuda"), \
            torch.empty(B, device="cuda")

        def old():
            _build.check(other(A.data_ptr(), partial.data_ptr(),
                               out_old.data_ptr(), B, n, S, chunk,
                               torch.cuda.current_stream().cuda_stream),
                         "earlier read_reduce")

        def new():
            _build.check(this(A.data_ptr(), partial.data_ptr(),
                              counter.data_ptr(), out_new.data_ptr(), B, n,
                              S, chunk,
                              torch.cuda.current_stream().cuda_stream),
                         "read_reduce")

        old()
        new()
        new()
        torch.cuda.synchronize()
        assert torch.equal(out_old, out_new), (B, M, N)
        assert int(counter.abs().max()) == 0
        o1, n1, n2, o2 = (graph_us(old), graph_us(new), graph_us(new),
                          graph_us(old))
        print(f"read_reduce {(B, M, N)} S={S}: equal to the earlier "
              f"kernel's bits; device pace earlier {o1:.2f} / {o2:.2f} us, "
              f"this {n1:.2f} / {n2:.2f} us  [{card}]")


def inputs(B, M, N, seed):
    rng = np.random.default_rng(seed)
    A = (rng.standard_normal((B, M, N)) / np.sqrt(M)).astype(np.float32)
    gamma = (1.0 / np.array([np.linalg.norm(a, 2) ** 2 for a in A])
             ).astype(np.float32)
    arrays = dict(
        A=A, b=rng.standard_normal((B, M)).astype(np.float32),
        x=rng.standard_normal((B, N)).astype(np.float32),
        z_prev=rng.standard_normal((B, N)).astype(np.float32),
        t=rng.uniform(1, 5, B).astype(np.float32), gamma=gamma,
        thr=(gamma * rng.uniform(0.05, 0.5, B)).astype(np.float32),
        done=(rng.random(B) < 0.3).astype(np.float32))
    return {k: torch.tensor(v, device="cuda") for k, v in arrays.items()}


def call(fn, d, state, restart, plan=None):
    """Launch ``fn`` on the state tensors (updated in place); ``plan`` is
    ``(C, R, S)`` for this tree's entry, None for the earlier one."""
    B, M, N = d["A"].shape
    x, zp, t, res = state
    head = (d["A"].data_ptr(), d["b"].data_ptr(), x.data_ptr(),
            zp.data_ptr(), t.data_ptr(), d["gamma"].data_ptr(),
            d["thr"].data_ptr(), d["done"].data_ptr(), res.data_ptr(), B, M,
            N, K, int(restart))
    stream = torch.cuda.current_stream().cuda_stream
    if plan is None:
        err = fn(*head, stream)
    else:
        C, R, S = plan
        err = fn(*head, C, R, S, tl.k_steps_shared_bytes(M, N, C, R, S),
                 stream)
    _build.check(err, "fista_k_steps")


def fresh(d):
    return (d["x"].clone(), d["z_prev"].clone(), d["t"].clone(),
            torch.empty_like(d["t"]))


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
    other, other_probe = build_other(args.other_csrc)
    this = _build.library().proxtpu_fista_k_steps
    print((_build.build_dir() / "nvcc.log").read_text())
    compare_read_reduce(other_probe, card)
    limit = _build.max_shared_bytes(0)
    sms = _build.sm_count(0)

    for B, M, N in SHAPES:
        d = inputs(B, M, N, seed=B + M + N)
        C = tl.k_steps_plan(B, M, N, sms, limit)[0]
        for restart in (False, True):
            want = tl.reference_fista_k_steps(
                d["A"], d["b"], d["x"], d["z_prev"], d["t"], d["gamma"],
                d["thr"], d["done"], K=K, restart=restart)
            old = fresh(d)
            call(other, d, old, restart)
            one = fresh(d)
            call(this, d, one, restart, (1, *tl.ring_plan(M, N, 1, limit)))
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(old, one))
            worst = max(float((a - b).abs().max()) for a, b in zip(old, one))
            err1 = max(float((g - w).abs().max()) for g, w in zip(one, want))
            line = (f"{(B, M, N)} restart={restart}: C=1 equal to the "
                    f"earlier kernel: {same} (max|d| {worst:.3e}), "
                    f"max|err| to plain {err1:.3e}")
            assert err1 <= ATOL_K, line
            if C > 1:
                many = fresh(d)
                call(this, d, many, restart,
                     tl.k_steps_plan(B, M, N, sms, limit))
                torch.cuda.synchronize()
                errC = max(float((g - w).abs().max())
                           for g, w in zip(many, want))
                line += f"; C={C} max|err| to plain {errC:.3e}"
                assert errC <= ATOL_K, line
            print(line)
            assert same, line

    for B, M, N in SHAPES[:2]:
        d = inputs(B, M, N, seed=1)
        d["done"].zero_()
        plan = tl.k_steps_plan(B, M, N, sms, limit)
        state = fresh(d)
        old_fn = lambda: call(other, d, state, True)  # noqa: E731
        new_fn = lambda: call(this, d, state, True, plan)  # noqa: E731
        o1, n1, n2, o2 = (event_us(old_fn), event_us(new_fn),
                          event_us(new_fn), event_us(old_fn))
        print(f"{(B, M, N)} K={K} plan C, R, S = {plan}: eager earlier "
              f"{o1:.1f} / {o2:.1f} us, this {n1:.1f} / {n2:.1f} us; device "
              f"pace earlier {graph_us(old_fn):.1f} us, this "
              f"{graph_us(new_fn):.1f} us  [{card}]")
        if args.plans:
            for Cp in (1, 2, 4):
                for R in (4, 8, 16, 32):
                    for S in (3, 4, 6):
                        smem = tl.k_steps_shared_bytes(M, N, Cp, R, S)
                        if smem > limit:
                            continue
                        fn = lambda: call(this, d, state, True,  # noqa: E731
                                          (Cp, R, S))
                        print(f"  C={Cp} R={R} S={S} ({smem} B): "
                              f"{graph_us(fn, reps=5):.1f} us")


if __name__ == "__main__":
    main()
