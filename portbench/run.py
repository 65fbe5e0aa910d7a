"""Run one cell of the benchmark once on this machine's cards.

    python3 portbench/run.py --workload <name> --seed <n> \
        --seconds <s> --trace <0|1>

Prints, as its last line on standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``check``, each number the check compared beside
its limit (also the last lines on standard error).  Exits non-zero and
prints no result without enough CUDA cards, without the program beside
this folder, or if JAX or the JAX package was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def power_limit():
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"not read ({e})"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else (
        f"not read ({out.stderr.strip()})")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from portbench import harness

    cell = harness.cell(harness.load_manifest(), args.workload)
    if not torch.cuda.is_available() or (torch.cuda.device_count()
                                         < cell.chips):
        log(f"{args.workload} needs {cell.chips} CUDA card(s); "
            f"torch.cuda.is_available() = {torch.cuda.is_available()}, "
            f"{torch.cuda.device_count()} found")
        return 2
    import proxtpu_torch

    if not Path(proxtpu_torch.__file__).resolve().is_relative_to(ROOT):
        log(f"proxtpu_torch comes from {proxtpu_torch.__file__}, not from "
            f"the checkout at {ROOT}")
        return 2
    kind = torch.cuda.get_device_name(0)
    log(f"card: {power_limit()}; peaks: {harness.peaks_for(kind)}")
    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                              "cuda:0", T0, log=log)
    found = harness.banned_modules()
    if found:
        log("loaded in this process, which no run may load: "
            + ", ".join(found))
        return 3
    for name, c in result["check"].items():
        log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
