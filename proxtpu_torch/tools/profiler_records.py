"""Which kernel records a ``torch.profiler`` session on the card loses, and
on what the loss depends: the count of kernels launched, the time since the
session opened, or the device's time.

    python -m proxtpu_torch.tools.profiler_records [--after HISTORY]
        [--json PATH]

Runs several profiler sessions (CPU and CUDA activity) one after another in
this process, each launching one-element kernels in its own way, and prints
one line a session: the launches whose kernel record the trace lacks (by
their place in the session's launch order, matched by correlation id), and
the host time from the session's first launch to its last lost one.  With
no ``--after``, the sessions are:

* ``first``, ``second``: 200 kernels back to back (the first session of
  the process, then the next);
* ``idle 50 ms``: 50 ms of host sleep inside the session, then 200 kernels;
* ``busy 20 ms``: a 20 ms kernel (``torch.cuda._sleep``) first, then 200;
* ``spaced 1 ms``: 60 kernels, 1 ms of host sleep after each;
* ``after 3``, then ``next``: a session of 3 kernels, then one of 200;
* ``2000``: 2000 kernels back to back;
* ``trace()``: :func:`proxtpu_torch.utils.profiling.trace` around 200.

``--after HISTORY`` first does what ``chip_smoke.py``'s earlier phases do
to the process, and then runs ``probe``, ``probe again`` and ``trace()``
(200 kernels each): ``cuda_only`` a profiler session of CUDA activity
alone (as ``chip_smoke.py::profiled_device_ms``), ``graph`` the capture and
replay of a CUDA graph on a side stream (as ``chip_smoke.py::graph_ms``),
``side_stream`` 200 kernels on a side stream, ``library`` 200 launches of
the port's own ``read_reduce`` kernel (built by ``nvcc``, launched through
ctypes), ``big`` a session of CUDA activity alone over 30,000 kernels,
``sessions`` 30 sessions of CUDA activity alone over 200 kernels each.

Needs a card; exits with 1 without one.
"""

import argparse
import json
import os
import sys
import tempfile
import time

import torch


def _lost(path):
    """``(launches, lost places, ms from the first launch to the last lost
    one)`` of the chrome trace at ``path``."""
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    kept = {e.get("args", {}).get("correlation") for e in events
            if e.get("cat") == "kernel"}
    runtime = sorted((e for e in events if e.get("cat") == "cuda_runtime"
                      and "Launch" in e["name"]), key=lambda e: e["ts"])
    lost = [i for i, e in enumerate(runtime)
            if e.get("args", {}).get("correlation") not in kept]
    span = ((runtime[lost[-1]]["ts"] - runtime[0]["ts"]) / 1e3
            if lost else 0.0)
    return len(runtime), lost, span


def _session(body, log_dir):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        body()
        torch.cuda.synchronize()
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    return _lost(path)


def _traced(body, log_dir):
    from proxtpu_torch.utils.profiling import trace

    sub = os.path.join(log_dir, "trace")
    with trace(sub):
        body()
    (name,) = [f for f in os.listdir(sub) if f.endswith(".pt.trace.json")]
    out = _lost(os.path.join(sub, name))
    os.remove(os.path.join(sub, name))
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--after", choices=("cuda_only", "graph",
                                            "side_stream", "library", "big",
                                            "sessions"))
    parser.add_argument("--json", help="also write the rows to this file")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("profiler_records: no CUDA device", file=sys.stderr)
        return 1
    t = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    # clock rate of the sleep kernel: cycles for 20 ms
    cycles = int(torch.cuda.get_device_properties(0).clock_rate * 1e3 * 0.02) \
        if hasattr(torch.cuda.get_device_properties(0), "clock_rate") \
        else 40_000_000

    def kernels(n, spacing=0.0):
        def run():
            for _ in range(n):
                t.add_(1)
                if spacing:
                    time.sleep(spacing)
        return run

    def idle_then(n):
        def run():
            time.sleep(0.05)
            kernels(n)()
        return run

    def busy_then(n):
        def run():
            torch.cuda._sleep(cycles)
            kernels(n)()
        return run

    def cuda_only(log_dir, n=200):
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            kernels(n)()
            torch.cuda.synchronize()
        path = os.path.join(log_dir, "trace.json")
        prof.export_chrome_trace(path)
        return _lost(path)

    def graph():
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            kernels(3)()
        torch.cuda.current_stream().wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            kernels(10)()
        for _ in range(20):
            g.replay()
        torch.cuda.synchronize()

    def side_stream():
        side = torch.cuda.Stream()
        with torch.cuda.stream(side):
            kernels(200)()
        torch.cuda.synchronize()

    def library():
        from proxtpu_torch.kernels.probe import read_reduce

        A = torch.ones(64, 200, 400, device="cuda")
        for _ in range(200):
            read_reduce(A)
        torch.cuda.synchronize()

    if args.after is None:
        sessions = [("first", _session, kernels(200)),
                    ("second", _session, kernels(200)),
                    ("idle 50 ms", _session, idle_then(200)),
                    ("busy 20 ms", _session, busy_then(200)),
                    ("spaced 1 ms", _session, kernels(60, 1e-3)),
                    ("after 3", _session, kernels(3)),
                    ("next", _session, kernels(200)),
                    ("2000", _session, kernels(2000)),
                    ("trace()", _traced, kernels(200))]
    else:
        sessions = [("probe", _session, kernels(200)),
                    ("probe again", _session, kernels(200)),
                    ("trace()", _traced, kernels(200))]
        if args.after in ("cuda_only", "big", "sessions"):
            n, times = {"cuda_only": (200, 1), "big": (30_000, 1),
                        "sessions": (200, 30)}[args.after]
            for i in range(times):
                sessions.insert(i, (f"CUDA only {i}",
                                    lambda body, d: cuda_only(d, n), None))
        else:
            {"graph": graph, "side_stream": side_stream,
             "library": library}[args.after]()
    rows = []
    with tempfile.TemporaryDirectory() as log_dir:
        for name, session, body in sessions:
            n, lost, span = session(body, log_dir)
            rows.append({"after": args.after, "session": name,
                         "launches": n, "lost": len(lost),
                         "first_lost": lost[:3], "last_lost": lost[-3:],
                         "lost_span_ms": round(span, 3)})
            print(json.dumps(rows[-1]))
    print(f"card: {torch.cuda.get_device_name(0)}, torch {torch.__version__},"
          f" CUDA {torch.version.cuda}")
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(rows, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
