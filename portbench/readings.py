"""The two readings that each limit of the check is set between.

    python3 portbench/readings.py --workload <name> --seeds <n> ... \\
        [--control-seeds <n> ...]

In one process, for each seed of ``--seeds``: the cell's problems, one
call of the program on every batch of the pool through the window's own
path (``stream_solve`` at the mix's depth), and the check's numbers; for
each seed of ``--control-seeds`` the same with the control in the
program's place: the cell's plain reference in float32 with every product
taking its operands in TF32 (the precision below the configuration's
full float32).  Prints one JSON line a seed and, last, the lower reading
(the largest over the program's seeds) and the upper (the smallest over
the control's) of each number.  The benchmark's own runs never run this.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def control(cell):
    """The control in the program's place: the plain reference in float32,
    products in TF32."""
    import torch

    from portbench import harness

    entry = harness.load_module("entries", cell.config["entry"])
    return entry.reference(cell.config, prec="tf32", dtype=torch.float32)


def read(cell, seed, device, solve=None):
    """The check's numbers for one seed (one call on each pool batch)."""
    from portbench import harness

    run, pool = harness.measure(cell, seed, 0.0, False, device,
                                time.perf_counter(), solve=solve,
                                calls=cell.traffic["pool_batches"])
    entry = harness.load_module("entries", cell.config["entry"])
    numbers = harness.check(run, pool, entry.reference(cell.config), seed)
    numbers["failed"] = sum(len(c.iters) - c.certified for c in run.calls)
    numbers["undone"] = sum(int((~c.done).sum()) for c in run.calls)
    return numbers


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--device", default="cuda:0")
    args = p.parse_args(argv)

    from portbench import harness

    cell = harness.cell(harness.load_manifest(), args.workload)
    rows = {"program": [], "control": []}
    for side, seeds in (("program", args.seeds),
                        ("control", args.control_seeds)):
        for seed in seeds:
            t = time.perf_counter()
            numbers = read(cell, seed, args.device,
                           control(cell) if side == "control" else None)
            rows[side].append(numbers)
            print(json.dumps({"side": side, "seed": seed, **numbers,
                              "seconds": time.perf_counter() - t}),
                  flush=True)
    keys = list(cell.limits)
    summary = {"lower": {k: max(r[k] for r in rows["program"]) for k in keys}}
    if rows["control"]:
        summary["upper"] = {k: min(r[k] for r in rows["control"])
                            for k in keys}
    summary["limits"] = cell.limits
    print(json.dumps(summary), flush=True)
    found = harness.banned_modules()
    if found:
        print("loaded: " + ", ".join(found), file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
