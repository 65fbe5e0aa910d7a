"""The traced run: a ``torch.profiler`` trace of the card over the window,
summarised in memory (no trace file is written).

The summary holds the device's records (kernels, copies, fills) clipped to
the window, their union (the busy time), the time of each kernel by name,
the idle time under each of the benchmark's host spans, and the kernel
records of the program's hand-written kernels, by the counter of the
wrapper that launches them, to compare with the counters.
"""

from __future__ import annotations

import re
import time

import numpy as np
import torch

# the host spans, in the order the breakdown lists them
SPANS = ("entry", "fence", "between")


def short_name(name, width=120):
    """A record's name without a leading ``void`` and cut to ``width``
    characters."""
    name = name.removeprefix("void ")
    return name if len(name) <= width else name[:width - 3] + "..."


def counted(counts, kernel):
    """Records of ``kernel`` among ``{name: records}``: names holding the
    kernel's name as a whole word."""
    pat = re.compile(rf"(?<![A-Za-z0-9_]){kernel}(?![A-Za-z0-9_])")
    return sum(n for name, n in counts.items() if pat.search(name))


class Tracer:
    """Profile the card inside ``with``; times are the wall clock's ns."""

    def __enter__(self):
        act = torch.profiler.ProfilerActivity
        # the card's records; on a machine without one (the tests) the
        # host's, which hold no device record
        self.prof = torch.profiler.profile(activities=[
            act.CUDA if torch.cuda.is_available() else act.CPU])
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        self.prof.__exit__(*exc)
        return False

    def device_records(self):
        """``(start_ns, end_ns, name)`` of every record that ran on the
        card."""
        out = []
        for e in self.prof.profiler.kineto_results.events():
            if str(e.device_type()).endswith("CUDA"):
                s = e.start_ns()
                out.append((s, s + e.duration_ns(), e.name()))
        return out


def wall_offset_ns():
    """Add to ``time.perf_counter_ns()`` to get the profiler's clock (the
    wall clock in ns)."""
    return time.time_ns() - time.perf_counter_ns()


def _merge(starts, ends):
    """The union of intervals as sorted disjoint ``(s, e)`` arrays."""
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], ends[order]
    reach = np.maximum.accumulate(e)
    new = np.ones(len(s), bool)
    new[1:] = s[1:] > reach[:-1]
    idx = np.flatnonzero(new)
    return s[idx], np.append(reach[idx[1:] - 1], reach[-1])


def _busy_upto(ms, me, cum, t):
    """Busy time of the merged intervals before each time in ``t``."""
    k = np.searchsorted(ms, t, side="right") - 1
    kk = np.clip(k, 0, None)
    part = np.clip(t - ms[kk], 0, me[kk] - ms[kk])
    return np.where(k < 0, 0, cum[kk] + part)


def summarise(records, t0, t1, entry, nexts):
    """Reduce the device records to what the metrics read.

    ``t0``, ``t1``: the window in the profiler's clock (ns); ``entry``:
    the spans inside the program's entry call; ``nexts``: the spans inside
    ``next()`` on the stream, which hold the entry spans and the wait on
    the fence.  Returns a dict: ``busy_s``, ``window_s``, ``kernel_s``
    (summed time of every kernel), ``by_name`` (seconds by name, all
    records), ``kernel_counts`` (records by name), ``idle_by_span``
    (idle seconds under each of :data:`SPANS`) and ``gaps`` (the longest
    idle gaps as ``(span, seconds)``)."""
    recs = [(max(s, t0), min(e, t1), n) for s, e, n in records
            if e > t0 and s < t1]
    window_s = (t1 - t0) * 1e-9
    by_name, counts, kernel_ns = {}, {}, 0
    for s, e, n in recs:
        by_name[n] = by_name.get(n, 0) + (e - s)
        counts[n] = counts.get(n, 0) + 1
        if not (n.startswith("Memcpy") or n.startswith("Memset")):
            kernel_ns += e - s
    out = dict(window_s=window_s, kernel_s=kernel_ns * 1e-9,
               by_name={k: v * 1e-9 for k, v in by_name.items()},
               kernel_counts=counts, busy_s=0.0, gaps=[],
               idle_by_span={k: window_s for k in SPANS})
    if not recs:
        out["idle_by_span"] = {"entry": 0.0, "fence": 0.0,
                               "between": window_s}
        return out
    ms, me = _merge(np.array([r[0] for r in recs], np.int64),
                    np.array([r[1] for r in recs], np.int64))
    cum = np.concatenate(([0], np.cumsum(me - ms)[:-1]))
    out["busy_s"] = float((me - ms).sum()) * 1e-9
    out["merged"] = (ms, me, cum)

    def idle(spans):
        if not spans:
            return 0.0
        a = np.clip(np.array([s[0] for s in spans], np.int64), t0, t1)
        b = np.clip(np.array([s[1] for s in spans], np.int64), t0, t1)
        busy = _busy_upto(ms, me, cum, b) - _busy_upto(ms, me, cum, a)
        return float(((b - a) - busy).sum()) * 1e-9

    idle_entry, idle_next = idle(entry), idle(nexts)
    idle_all = window_s - out["busy_s"]
    out["idle_by_span"] = {"entry": idle_entry,
                           "fence": idle_next - idle_entry,
                           "between": idle_all - idle_next}
    # the gaps between busy intervals, and the window's two ends
    gs = np.concatenate(([t0], me))
    ge = np.concatenate((ms, [t1]))
    keep = ge > gs
    gs, ge = gs[keep], ge[keep]
    longest = np.argsort(ge - gs)[::-1][:10]
    mids = (gs[longest] + ge[longest]) // 2
    out["gaps"] = [(span_at(int(m), entry, nexts), float(ge[i] - gs[i]) * 1e-9)
                   for m, i in zip(mids, longest)]
    return out


def busy_between(summary, a, b):
    """Seconds of the device's busy time between ``a`` and ``b`` (ns, the
    profiler's clock)."""
    if "merged" not in summary:
        return 0.0
    ms, me, cum = summary["merged"]
    t = np.array([a, b], np.int64)
    lo, hi = _busy_upto(ms, me, cum, t)
    return float(hi - lo) * 1e-9


def span_at(t, entry, nexts):
    """Which of :data:`SPANS` the host was in at ``t``."""
    if any(a <= t < b for a, b in entry):
        return "entry"
    if any(a <= t < b for a, b in nexts):
        return "fence"
    return "between"


def lost_records(summary, launches, kernels):
    """``{counter: launches - records}`` for each counter of ``kernels``
    (``{counter: kernel name}``) that moved: what the trace lost (or,
    below zero, records that no counter explains)."""
    return {c: n - counted(summary["kernel_counts"], kernels[c])
            for c, n in launches.items() if c in kernels and n}


def breakdown(summary):
    """The result line's ``breakdown``: the ten records that took most
    device time, and the idle time under each host span, then the longest
    single idle gaps, ten entries in all."""
    ops = sorted(summary["by_name"].items(), key=lambda kv: -kv[1])[:10]
    idle = [[f"idle under {k}", summary["idle_by_span"][k]] for k in SPANS]
    gaps = [[f"longest gap, host in {s}", v] for s, v in summary["gaps"]]
    return {"device_ops": [[short_name(k), v] for k, v in ops],
            "idle_gaps": (idle + gaps)[:10]}
