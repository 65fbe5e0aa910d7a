"""One run of one cell: set-up, the measured window, the check, the metrics.

Everything that belongs to one configuration, mix, entry or metric is found
by its name:

* ``BENCHMARK.json`` names the cells and metrics;
* ``portbench/configs/<config>.json``: the problem (``problem.kind`` names
  ``portbench/problems/<kind>.py``, which makes the problems on the device,
  reads an answer's counts and judges its lanes: ``make_batches``,
  ``counts``, ``certificate``),
  the solver's options and the entry (``portbench/entries/<entry>.py``:
  ``program(config)`` is the system under test, ``reference(config, prec,
  dtype)`` its plain version, ``COUNTED_KERNELS`` the launch counters it
  drives and the kernel each counts);
* ``portbench/traffic/<traffic>.json``: the mix, read by the general
  generator it names (``portbench/generators/<generator>.py``);
* ``portbench/limits/<workload>.json``: the limit of each number that the
  check compares;
* ``portbench/metrics/<metric>.py``: ``read(run)`` returns the metric's
  value from the run, or None where it finds nothing to read.

A later cell, configuration, mix, entry or metric is new files and new
entries of ``BENCHMARK.json``; nothing here changes.
"""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import random
import sys
import time
from dataclasses import dataclass
from pathlib import Path

import torch

from . import trace

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
MANIFEST = ROOT / "BENCHMARK.json"

# top-level module names that no run may load: JAX, its libraries, the JAX
# package and its harness
BANNED_MODULES = ("jax", "jaxlib", "flax", "proxtpu", "bench", "benchmarks")


def banned_modules(modules=None):
    """Loaded modules whose top-level name (before the first dot) is one of
    :data:`BANNED_MODULES`, compared whole."""
    modules = sys.modules if modules is None else modules
    return sorted(m for m in modules if m.split(".")[0] in BANNED_MODULES)


def load_manifest(path=MANIFEST):
    return json.loads(Path(path).read_text())


def load_json(kind, name):
    path = HERE / kind / f"{name}.json"
    if not path.is_file():
        raise LookupError(f"no {kind} file named {name!r} ({path})")
    return json.loads(path.read_text())


def load_module(kind, name):
    """``portbench/<kind>/<name>.py`` as a module of the package
    ``portbench.<kind>`` (a name may hold dots)."""
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise LookupError(f"no {kind} module named {name!r} ({path})")
    importlib.import_module(f"portbench.{kind}")
    spec = importlib.util.spec_from_file_location(f"portbench.{kind}.{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    mod.__package__ = f"portbench.{kind}"
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    metrics: list  # (metric entry, "end_to_end" or "per_layer")


def applies(metric, workload):
    return "workloads" not in metric or workload in metric["workloads"]


def cell(manifest, workload):
    """The cell named ``workload``, with its files read."""
    for w in manifest["workloads"]:
        if w["name"] == workload:
            break
    else:
        raise LookupError(f"no workload named {workload!r}")
    cfg = next(c for c in manifest["configs"] if c["name"] == w["config"])
    metrics = [(m, group) for group in ("end_to_end", "per_layer")
               for m in manifest[group] if applies(m, workload)]
    return Cell(workload, w["chips"], json.loads((ROOT / cfg["file"])
                                                 .read_text()),
                load_json("traffic", w["traffic"]),
                load_json("limits", workload), metrics)


@dataclass
class Call:
    """One batch call of the window."""
    pool_index: int
    t_dispatch: float
    t_done: float = 0.0
    out: tuple = None
    iters: torch.Tensor = None
    done: torch.Tensor = None
    certified: int = 0


@dataclass
class Run:
    """What the metrics read."""
    cell: Cell
    problems: object          # the config's problem module
    setup_s: float
    start: float
    end: float
    calls: list
    launches: dict            # counter -> launches in the window
    device_kind: str
    peaks: dict = None        # this card's row of portbench/peaks.json
    trace: dict = None        # trace.summarise() of the traced window


def launch_counters():
    """``{"<wrapper>.<counter>": count}`` over the program's kernel
    modules: every function with a ``launches`` or ``launches_bf16``
    attribute."""
    import proxtpu_torch.kernels as pk

    out = {}
    for info in _submodules(pk):
        mod = importlib.import_module(f"proxtpu_torch.kernels.{info}")
        for name, obj in vars(mod).items():
            for attr in ("launches", "launches_bf16"):
                v = getattr(obj, attr, None)
                if callable(obj) and isinstance(v, int):
                    out[f"{name}.{attr}"] = v
    return out


def _submodules(pkg):
    import pkgutil

    return [m.name for m in pkgutil.iter_modules(pkg.__path__)
            if not m.name.startswith("_")]


def peaks_for(kind):
    table = json.loads((HERE / "peaks.json").read_text())
    return table["cards"].get(kind)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def measure(cell, seed, seconds, trace_on, device, t0, solve=None,
            calls=None, log=None):
    """Set up, run the window and close it; returns ``(run, pool)`` with
    the outputs of every call kept for the check.

    ``t0`` is the process's start on ``time.perf_counter``'s clock.
    ``solve`` takes the program's place (the control, a planted fault).
    ``calls`` runs that many calls in place of a window of ``seconds``."""
    from proxtpu_torch.parallel.stream import stream_solve

    log = log or (lambda *a: None)
    cfg, trf = cell.config, cell.traffic
    problems = load_module("problems", cfg["problem"]["kind"])
    generator = load_module("generators", trf["generator"])
    entry = load_module("entries", cfg["entry"])
    pool = generator.make(problems, cfg, trf, seed, device)
    if solve is None:
        solve = entry.program(cfg)
    # the warm-up: one batch of the cell's shape, every kernel built and
    # every plan cached
    solve(pool.batches[pool.index(0)])
    _sync(device)
    before = launch_counters()
    setup_s = time.perf_counter() - t0
    log(f"set-up {setup_s:.3f} s")

    record, entry_spans, next_spans = [], [], []

    def timed(p):
        a = time.perf_counter_ns()
        out = solve(p)
        entry_spans.append((a, time.perf_counter_ns()))
        return out

    def payloads():
        i = 0
        while (i < calls if calls is not None
               else time.perf_counter() < deadline):
            record.append(Call(pool.index(i), time.perf_counter()))
            yield pool.batches[pool.index(i)]
            i += 1

    tracer = trace.Tracer() if trace_on else contextlib.nullcontext()
    with tracer:
        offset = trace.wall_offset_ns()
        start = time.perf_counter()
        deadline = start + seconds
        taken = time.perf_counter_ns()
        for j, out in enumerate(stream_solve(timed, payloads(),
                                             depth=pool.depth)):
            # next() on the stream began where the last result was taken
            next_spans.append((taken, time.perf_counter_ns()))
            record[j].t_done = time.perf_counter()
            record[j].out = out
            taken = time.perf_counter_ns()
        end = record[-1].t_done
    launches = {k: v - before.get(k, 0) for k, v in launch_counters().items()
                if v != before.get(k, 0)}
    gaps = sorted(b.t_done - a.t_done for a, b in zip(record, record[1:]))
    if gaps:
        log(f"{len(record)} calls; seconds between fenced results: "
            f"p10 {gaps[len(gaps) // 10]:.5f}, p50 {gaps[len(gaps) // 2]:.5f}"
            f", p90 {gaps[9 * len(gaps) // 10]:.5f}")
    kind = (torch.cuda.get_device_name(device)
            if torch.device(device).type == "cuda" else "cpu")
    run = Run(cell, problems, setup_s, start, end, record, launches, kind,
              peaks=peaks_for(kind))
    if trace_on:
        def wall(spans):
            return [(a + offset, b + offset) for a, b in spans]

        run.trace = trace.summarise(
            tracer.device_records(), int(start * 1e9) + offset,
            int(end * 1e9) + offset, wall(entry_spans), wall(next_spans))
        run.trace["offset_ns"] = offset
        del tracer
    return run, pool


def check(run, pool, entry_reference, seed, log=None):
    """Compare the window's answers with the plain references; fills each
    call's ``iters``, ``done`` and ``certified`` and returns ``{number:
    value}``.  The problem module (``run.problems``) reads an answer's
    counts and judges its lanes.

    * ``recheck``: the largest certificate (the problem module's
      ``certificate``) over every lane of every call;
    * ``iters_gap``, ``done_gap``: on ``reference_batches`` pool batches
      drawn from the seed, the gap of the mean count to the float64
      reference's, as a share of it, and the lanes whose ``done`` differs.
    """
    log = log or (lambda *a: None)
    cfg, problems = run.cell.config, run.problems
    gate = cfg["gate"]
    worst = 0.0
    for c in run.calls:
        crit = problems.certificate(pool.batches[c.pool_index], c.out)
        worst = max(worst, float(crit.max()))
        iters, done = problems.counts(c.out)
        c.certified = int(((crit <= gate) & done).sum())
        c.iters, c.done = iters.cpu(), done.cpu()
        c.out = None
    served = sorted({c.pool_index for c in run.calls})
    rng = random.Random(seed)
    sample = rng.sample(served, min(cfg["reference_batches"], len(served)))
    first = {}
    for c in run.calls:
        first.setdefault(c.pool_index, c)
    it_prog, it_ref, done_gap = 0, 0, 0
    for i in sample:
        it, dn = problems.counts(entry_reference(pool.batches[i]))
        c = first[i]
        it_prog += int(c.iters.sum())
        it_ref += int(it.sum())
        done_gap += int((c.done != dn.cpu()).sum())
        log(f"reference on pool batch {i}: mean iterations "
            f"{c.iters.double().mean():.4f} (program) "
            f"{it.double().mean():.4f} (reference)")
    return {"recheck": worst,
            "iters_gap": abs(it_prog - it_ref) / max(it_ref, 1),
            "done_gap": done_gap}


def chunk_lines(run, seconds=5.0):
    """The window in chunks of ``seconds``, by the calls whose fenced
    result came in each: calls, certified problems and their rate, and,
    in a traced run, the device's busy share of the chunk.  One line a
    chunk, to show whether anything drifts inside a window."""
    lines, a = [], run.start
    while a < run.end:
        b = min(a + seconds, run.end)
        done = [c for c in run.calls if a <= c.t_done < b
                or (b == run.end and c.t_done == b)]
        cert = sum(c.certified for c in done)
        line = (f"window {a - run.start:6.1f}-{b - run.start:6.1f} s: "
                f"{len(done)} calls, {cert} certified, "
                f"{cert / (b - a):.1f}/s")
        if run.trace is not None:
            off = run.trace["offset_ns"]
            busy = trace.busy_between(run.trace, int(a * 1e9) + off,
                                      int(b * 1e9) + off)
            line += f", device busy {100 * busy / (b - a):.1f}%"
        lines.append(line)
        a = b
    return lines


def read_metrics(run, names):
    out = {}
    for name in names:
        value = load_module("metrics", name).read(run)
        if value is not None:
            out[name] = float(value)
    return out


def run_cell(cell, seed, seconds, trace_on, device, t0, solve=None,
             calls=None, log=None):
    """One whole run; returns the result line's dict, ``check`` last."""
    from proxtpu_torch import get_matmul_precision

    log = log or (lambda *a: None)
    precision = get_matmul_precision()
    if precision != "highest" or torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(f"matmul precision {precision!r}, allow_tf32 "
                           f"{torch.backends.cuda.matmul.allow_tf32}: the "
                           "configurations state full float32")
    log(f"matmul precision {precision}")
    run, pool = measure(cell, seed, seconds, trace_on, device, t0,
                        solve=solve, calls=calls, log=log)
    cuda = torch.device(device).type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    log("launches in the window: " + json.dumps(run.launches))
    entry = load_module("entries", cell.config["entry"])
    if run.trace is not None:
        log("trace records lost, by counter: " + json.dumps(
            trace.lost_records(run.trace, run.launches,
                               getattr(entry, "COUNTED_KERNELS", {}))))
    numbers = check(run, pool, entry.reference(cell.config), seed, log=log)
    del pool
    for line in chunk_lines(run):
        log(line)
    group = "per_layer" if trace_on else "end_to_end"
    names = [m["name"] for m, g in cell.metrics if g == group]
    metrics = read_metrics(run, names)
    units = {m["name"]: m["unit"] for m, _ in cell.metrics}
    attempted = sum(len(c.iters) for c in run.calls)
    certified = sum(c.certified for c in run.calls)
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": run.device_kind, "count": cell.chips,
                   "memory_peak_bytes": int(peak)}
    result = {"correct": all(numbers[k] <= cell.limits[k] for k in numbers),
              "attempted": attempted, "failed": attempted - certified,
              "metrics": {k: {"value": v, "unit": units[k]}
                          for k, v in metrics.items()},
              "device": device_info}
    if run.trace is not None:
        device_info["busy_s"] = run.trace["busy_s"]
        device_info["window_s"] = run.trace["window_s"]
        result["breakdown"] = trace.breakdown(run.trace)
    result["check"] = {k: {"value": v, "limit": cell.limits[k]}
                       for k, v in numbers.items()}
    return result
