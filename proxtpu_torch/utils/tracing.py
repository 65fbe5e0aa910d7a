"""Spans and host-sync counts inside the port, recorded only while a
``torch.profiler`` session is active.

A span marks one layer's work on the host::

    with span("solve.pack"):
        Ap, bp = pack_lasso_batch(A, b, pack)

Each record holds the span's name, its start and end on
``time.perf_counter_ns()``'s clock (the clock of ``portbench``'s own
spans), the id of its parent span, the id of its call and an optional
integer ``n``.  A span opened with no span open around it starts a call,
and its id is the call's: every span of a solve that ``stream_solve``
dispatched carries the id of its ``stream.dispatch``.  Records go into a
bounded buffer in memory (:data:`CAPACITY`; the oldest go first, and are
counted), read with :func:`records` and :func:`dropped`; nothing is
written to disk.

While recording, each span also opens a ``record_function`` of its name,
so a trace that records the host's activity (``utils.profiling.trace``)
shows the spans above the device's rows: there the solvers' spans show
where a call's host time goes.  The benchmark's metrics
(``portbench/spans.py``) read ``stream.dispatch``, ``loop.issue``, the
``sync.*`` spans and ``host.gc``.  With no session a span costs one flag
check and records nothing.

The names in use, by layer:

* entry: ``stream.dispatch`` (``solve(p)`` in ``stream_solve``),
  ``batched.match``, ``batched.solve`` (``BatchedAlgorithm``);
* solvers: ``solve.pack``, ``solve.init``, ``solve.phase1``,
  ``solve.phase2_full``, ``solve.phase2_tail``;
* host loop: ``loop.issue`` (``n``: the ``body`` calls between two
  all-done tests);
* host syncs: ``sync.<site>``, one a blocking read of the device
  (``sync.loop_check``, ``sync.phase_count``, ``sync.x0_any``);
* host: ``host.gc``, one a garbage collection.
"""

from __future__ import annotations

import collections
import gc
import itertools
import threading
import time

import torch
import torch.autograd.profiler as _profiler

# records the buffer keeps; past that the oldest go
CAPACITY = 1_000_000

Span = collections.namedtuple(
    "Span", "id name start_ns end_ns parent call n")

_buffer = collections.deque(maxlen=CAPACITY)
# records pushed out of the buffer, and the latest end among them
_dropped = [0, -1]
_ids = itertools.count(1)
_local = threading.local()

_RecordFunction = torch._C._profiler._RecordFunctionFast


def _stack():
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    __slots__ = ("name", "n", "id", "call", "parent", "start", "rf")

    def __init__(self, name, n=None):
        self.name, self.n = name, n

    def __enter__(self):
        stack = _stack()
        self.id = next(_ids)
        if stack:
            self.parent, self.call = stack[-1].id, stack[-1].call
        else:
            self.parent, self.call = None, self.id
        stack.append(self)
        self.rf = _RecordFunction(self.name)
        self.rf.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        self.rf.__exit__(*exc)
        stack = _stack()
        if stack and stack[-1] is self:
            stack.pop()
        _append(Span(self.id, self.name, self.start, end, self.parent,
                     self.call, self.n))
        return False


class _Off:
    """What :func:`span` returns while nothing is recorded."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def span(name, n=None):
    """A context manager that records the span ``name`` (with ``n``, where
    given) while a profiler session is active, and does nothing
    otherwise."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, n)


def _append(record):
    if len(_buffer) == _buffer.maxlen:
        _dropped[0] += 1
        _dropped[1] = max(_dropped[1], _buffer[0].end_ns)
    _buffer.append(record)


def records():
    """The buffer's records, oldest first (a list of :class:`Span`)."""
    return list(_buffer)


def dropped():
    """``(count, end_ns)``: the records the bound pushed out, and the
    latest end among them (-1 where none was)."""
    return tuple(_dropped)


def clear(capacity=CAPACITY):
    """Empty the buffer, reset the count of dropped records and bound the
    buffer at ``capacity`` records."""
    global _buffer
    _buffer = collections.deque(maxlen=capacity)
    _dropped[:] = [0, -1]


def _on_gc(phase, info):
    """``gc.callbacks`` hook: the span ``host.gc`` around a collection
    (``n``: the generation) that starts while recording."""
    if phase == "start":
        if _profiler._is_profiler_enabled:
            s = _local.gc = _Span("host.gc", info.get("generation"))
            s.__enter__()
    else:
        s = getattr(_local, "gc", None)
        if s is not None:
            _local.gc = None
            s.__exit__(None, None, None)


gc.callbacks.append(_on_gc)
