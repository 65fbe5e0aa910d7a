"""The program's own spans (``proxtpu_torch.utils.tracing``) over a traced
run's window, for the metrics that read them.

The program records its spans on ``time.perf_counter_ns()``'s clock, the
clock of the harness's window; ``run.trace["offset_ns"]``, taken once at
the window's start, maps them onto the device's records.  A program
without the span module, a window with no span in it, or a buffer that
dropped a record inside the window reads as nothing.

The mapping is checked where it is used.  A blocking read returns once the
device has finished its queue, so a ``sync.*`` span's end, mapped, lies
outside every device record, or at most :data:`DEEP_NS` inside the one
that was ending; and it returns within microseconds of the device's last
record (its copy to the host).  :func:`agreed` keeps the whole seconds of
the window in which no more than :data:`SHARE` of the sync ends lie
deeper than that, and the median sync end lies at most :data:`LEAD_NS`
after the device's last record.  In the others the time stamps of the
device's records have moved against ``perf_counter_ns`` since the offset
was taken (the profiler's mapping of the card's timer ramps by about 1 ms
a second for seconds at a time on an H100), and the spans cannot say what
the device was doing under them.

:func:`split` divides the device's idle time inside the program's
``stream.dispatch`` spans (the breakdown's "idle under entry", up to the
few microseconds between the two), over the agreed seconds, into three
parts:

* refill: from the end of each ``sync.*`` span (a blocking read) to the
  device's next record;
* issue: under a ``loop.issue`` span (the host issuing the loop's steps),
  outside a refill;
* set-up: the rest: matching, packing, the first steps, the phase switch,
  collections.
"""

from __future__ import annotations

import numpy as np

from . import trace

# how far inside a device record a mapped sync end may lie (the device
# ending the record it was running), and the share of sync ends in a second
# that may lie deeper, before that second's clocks count as disagreeing
DEEP_NS = 20_000
SHARE = 0.01
# how far after the device's last record a second's median sync end may
# lie: 9-25 us where the clocks agree on an H100, 80 us and more where
# they drift apart by less than a refill
LEAD_NS = 50_000
SECOND_NS = 1_000_000_000


def window_spans(run):
    """The span records that start in the run's window, or None."""
    try:
        from proxtpu_torch.utils import tracing
    except ImportError:
        return None
    t0, t1 = int(run.start * 1e9), int(run.end * 1e9)
    count, last_end = tracing.dropped()
    if count and last_end >= t0:
        return None
    spans = [r for r in tracing.records() if t0 <= r.start_ns <= t1]
    return spans or None


def is_sync(record):
    return record.name.startswith("sync.")


def _union(starts, ends):
    """Sorted disjoint ``(s, e)`` int64 arrays covering the intervals."""
    starts = np.asarray(starts, np.int64)
    ends = np.asarray(ends, np.int64)
    keep = ends > starts
    if not keep.any():
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    return trace._merge(starts[keep], ends[keep])


def _inside(t, s, e):
    """Whether each time of ``t`` lies in one of the disjoint ``[s, e)``,
    and the index of the interval at or before it."""
    k = np.searchsorted(s, t, side="right") - 1
    kk = np.clip(k, 0, None)
    if not len(s):
        return np.zeros(len(t), bool), kk
    return (k >= 0) & (t < e[kk]), kk


def _combine(keep, *sets):
    """The set of the elementary pieces between every interval end of
    ``sets`` (each disjoint ``(s, e)``) whose membership in each set
    satisfies ``keep(*memberships)``."""
    points = np.unique(np.concatenate([a for s, e in sets for a in (s, e)]))
    if len(points) < 2:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    lo, hi = points[:-1], points[1:]
    chosen = keep(*(_inside(lo, s, e)[0] for s, e in sets))
    return _union(lo[chosen], hi[chosen])


def _idle_s(summary, s, e):
    """Seconds of the intervals in which the device ran nothing."""
    ms, me, cum = summary["merged"]
    busy = trace._busy_upto(ms, me, cum, e) - trace._busy_upto(ms, me, cum, s)
    return float(((e - s) - busy).sum()) * 1e-9


def _window(run):
    off = run.trace["offset_ns"]
    return off, int(run.start * 1e9) + off, int(run.end * 1e9) + off


def sync_ends(run, spans):
    """``(ends, depths, leads)``: the end of each ``sync.*`` span of
    ``spans`` in the window, on the profiler's clock; how far inside a
    device record it lies (0 outside every record); and how far after the
    end of the device's last record before it (0 inside one, or before
    every record)."""
    off, t0, t1 = _window(run)
    ms, me, _ = run.trace["merged"]
    ends = np.sort(np.array([r.end_ns + off for r in spans if is_sync(r)],
                            np.int64))
    ends = ends[(ends >= t0) & (ends < t1)]
    inside, k = _inside(ends, ms, me)
    after = ~inside & (np.searchsorted(ms, ends, side="right") > 0)
    return (ends, np.where(inside, me[k] - ends, 0),
            np.where(after, ends - me[k], 0))


def agreed(run, spans):
    """Sorted disjoint ``(s, e)`` on the profiler's clock: the seconds of
    the window (counted from its start, the last one shorter) that hold a
    sync end, in which at most :data:`SHARE` of the sync ends lie more
    than :data:`DEEP_NS` inside a device record and the median sync end
    lies at most :data:`LEAD_NS` after the device's last record."""
    _, t0, t1 = _window(run)
    ends, depths, leads = sync_ends(run, spans)
    second = (ends - t0) // SECOND_NS
    count = np.bincount(second, minlength=1)
    deep = np.bincount(second, weights=depths > DEEP_NS, minlength=1)
    good = [i for i in np.flatnonzero(count)
            if deep[i] <= SHARE * count[i]
            and np.median(leads[second == i]) <= LEAD_NS]
    good = np.array(good, np.int64)
    return _union(t0 + good * SECOND_NS,
                  np.minimum(t0 + (good + 1) * SECOND_NS, t1))


def split(run):
    """``{"refill", "issue", "setup": seconds}`` of the device's idle time
    inside ``stream.dispatch`` over the agreed seconds of the window
    (:func:`agreed`), and ``"window_s"``, their length; None without spans,
    without device records or without an agreed second."""
    spans = window_spans(run)
    if spans is None or run.trace is None or "merged" not in run.trace:
        return None
    off, t0, t1 = _window(run)
    ok = agreed(run, spans)
    if not len(ok[0]):
        return None

    def spans_named(name):
        sel = [r for r in spans if r.name == name]
        return _union(np.clip([r.start_ns + off for r in sel], t0, t1),
                      np.clip([r.end_ns + off for r in sel], t0, t1))

    dispatch = spans_named("stream.dispatch")
    issue = spans_named("loop.issue")
    ms, me, _ = run.trace["merged"]
    ends, _, _ = sync_ends(run, spans)
    # the device finishes the record in progress at a sync's end, then
    # idles until its next record
    busy, k = _inside(ends, ms, me)
    start = np.where(busy, me[k], ends)
    nxt = np.searchsorted(ms, start, side="right")
    stop = np.where(nxt < len(ms), ms[np.clip(nxt, None, len(ms) - 1)], t1)
    # while the host is still inside the dispatch the sync ended in
    held, d = _inside(ends, *dispatch)
    if len(dispatch[1]):
        stop = np.minimum(stop, dispatch[1][d])
    refill = _union(start[held], np.minimum(stop, t1)[held])

    def agreed_part(keep, *sets):
        return _combine(lambda a, *m: a & keep(*m), ok, *sets)

    return {
        "refill": _idle_s(run.trace, *agreed_part(lambda r: r, refill)),
        "issue": _idle_s(run.trace, *agreed_part(
            lambda d_, i_, r_: d_ & i_ & ~r_, dispatch, issue, refill)),
        "setup": _idle_s(run.trace, *agreed_part(
            lambda d_, i_, r_: d_ & ~i_ & ~r_, dispatch, issue, refill)),
        "window_s": float((ok[1] - ok[0]).sum()) * 1e-9,
    }


def self_ns(spans, name, minus):
    """``{span id: ns}``: the duration of each span called ``name`` less
    the part of it that the spans below it satisfying ``minus(record)``
    cover."""
    byid = {r.id: r for r in spans}
    out = {r.id: r.end_ns - r.start_ns for r in spans if r.name == name}
    covered = {}
    for r in spans:
        if not minus(r):
            continue
        p = byid.get(r.parent)
        while p is not None and p.name != name:
            p = byid.get(p.parent)
        if p is not None:
            covered.setdefault(p.id, []).append((r.start_ns, r.end_ns))
    for i, pieces in covered.items():
        s, e = _union(*zip(*pieces))
        out[i] -= int((e - s).sum())
    return out
