"""Pipelined dispatch of batched solves (counterpart of
``proxtpu/parallel/stream.py``).

PyTorch queues CUDA work asynchronously, so a producer that keeps ``depth``
solves in flight overlaps one call's host work with another's device work.
:func:`stream_solve` drains an iterable of problem payloads through a solve
callable that way and yields the results in order, each once it is fenced.
"""

from __future__ import annotations

from collections import deque

import torch

from ..utils.tracing import span


def _cuda_tensors(out):
    """The CUDA tensors among the leaves of tuples, lists and dicts."""
    if isinstance(out, torch.Tensor):
        return [out] if out.is_cuda else []
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (tuple, list)):
        return [t for leaf in out for t in _cuda_tensors(leaf)]
    return []


def _record_events(out):
    """One event per CUDA device of ``out``, recorded on its current stream
    right after the call that made ``out``."""
    events = []
    for device in {t.device for t in _cuda_tensors(out)}:
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(device))
        events.append(event)
    return events


def stream_solve(solve, problems, depth=2, fence=None):
    """Yield ``solve(p)`` for each payload ``p`` in ``problems``, in order,
    with up to ``depth`` further solves dispatched ahead; ``depth=0`` is
    fully synchronous.

    ``fence(out)`` blocks until ``out``'s computation has finished.  The
    default records a CUDA event on the current stream right after each
    call and synchronises on it before yielding; for an output that holds
    no CUDA tensor it does nothing.  Recording at call time, not at fence
    time, keeps the fence from waiting on the solves dispatched after it.

    Traced (:mod:`..utils.tracing`): ``stream.dispatch`` around each
    ``solve(p)``.
    """
    if depth < 0:
        raise ValueError(f"depth must be >= 0, got {depth}")

    def _fenced(out, events):
        if fence is None:
            for event in events:
                event.synchronize()
        else:
            fence(out)
        return out

    def _gen():
        q = deque()
        for p in problems:
            with span("stream.dispatch"):
                out = solve(p)
            q.append((out, _record_events(out) if fence is None else None))
            if len(q) > depth:
                yield _fenced(*q.popleft())
        while q:
            yield _fenced(*q.popleft())

    # validated at call time, not at the first next()
    return _gen()
