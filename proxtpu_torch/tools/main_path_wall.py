"""The main path's wall on one card, with the ``proxtpu_torch`` of a given
checkout, so that two trees are timed in one call.

    python proxtpu_torch/tools/main_path_wall.py [--tree DIR]

``DIR`` (default: the checkout this file is in) is the root of a checkout
whose package is imported in place of this one; an earlier tree is
unpacked with ``git archive COMMIT | tar -x -C build/parent``.  Run it as a
file, not with ``-m``, and once per tree in one command, in the order
parent, this, this, parent: each run builds its tree's kernels under the
tree's own ``build/``.

The main path is ``chip_smoke.py``'s: ``solve_lasso_batch_packed_tail`` on
the 256 lassos of 200 x 400 of ``tools/problems.py`` (seed 0), tol 1e-5,
maxit 2000, k1 = 192, tail = 64, restart, through ``stream_solve`` at
depth 2.  After one warm-up solve it prints the seconds a solve of each of
``BATCHES`` batches of ``SOLVES`` solves and their median, the iterations
(mean, max) and the launches a solve of each one-step wrapper the tree has.
Needs one GPU; prints the card's name and power limit.
"""

import argparse
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve()
BATCHES, SOLVES = 5, 6
WRAPPERS = ("fused_fb_prox_grad", "fused_fista_full_step",
            "fused_fista_packed_step")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(HERE.parents[2]))
    tree = Path(ap.parse_args().tree).resolve()
    # the tree's package, not the one beside this file
    sys.path[:] = [str(tree)] + [p for p in sys.path
                                 if Path(p or ".").resolve() != HERE.parent]

    import torch
    if not torch.cuda.is_available():
        sys.exit("main_path_wall needs a GPU")
    import proxtpu_torch
    from proxtpu_torch import problems_from_numpy
    from proxtpu_torch.kernels import lasso as tl
    from proxtpu_torch.parallel import stream_solve
    from proxtpu_torch.tools import problems

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"tree {tree}: {proxtpu_torch.__file__}  [{card}]")
    A, b, lam, Lf = problems_from_numpy(
        *problems.lasso_problems(problems.BATCH), device="cuda")

    def solve():
        return tl.solve_lasso_batch_packed_tail(
            A, b, lam, Lf, 1e-5, maxit=2000, k1=192, tail=64, restart=True)

    solve()  # warm-up: the kernels' build and first uses
    torch.cuda.synchronize()
    wrappers = {w: getattr(tl, w) for w in WRAPPERS if hasattr(tl, w)}
    for fn in wrappers.values():
        fn.launches = 0
    walls = []
    for _ in range(BATCHES):
        t0 = time.perf_counter()
        outs = list(stream_solve(lambda _: solve(), range(SOLVES), depth=2))
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) / SOLVES)
    _, iters, done = outs[0]
    assert bool(done.all()), f"{int((~done).sum())} lanes not converged"
    solves = BATCHES * SOLVES
    launches = {w: fn.launches / solves for w, fn in wrappers.items()}
    print(f"main path: {statistics.median(walls):.5f} s a solve (median of "
          f"{BATCHES} batches of {SOLVES}: "
          f"{', '.join(f'{w:.5f}' for w in walls)}); iterations mean "
          f"{iters.float().mean():.2f} max {int(iters.max())}; launches a "
          f"solve {launches}  [{card}]")


if __name__ == "__main__":
    main()
