"""Loops for data-dependent but bounded searches (counterpart of
``proxtpu/utils/loops.py``).

Every search of the line-search solvers is bounded (``max_backtracks`` for
the tau searches, the ``minimum_gamma`` floor for gamma).  On one problem
the search runs on the host, testing its condition after every trip.  Under
``torch.func.vmap`` a Python loop may not branch on a tensor, so the search
runs a fixed number of trips instead, each one masked by the condition:
once the loop would have stopped, later trips compute and discard.  Both
forms give the same result whenever the search ends within the bound.
"""

from __future__ import annotations

from .tree import tree_where


def bounded_while(cond, body, init, max_trips):
    """``while cond(c): c = body(c)`` from ``init``.

    ``max_trips=None`` loops on the host on ``bool(cond(c))`` (one
    problem: no trip is paid once the condition fails).  ``max_trips=T``
    runs exactly T trips, each kept only where ``cond`` held before it:
    the form that runs under ``torch.func.vmap``."""
    c = init
    if max_trips is None:
        while bool(cond(c)):
            c = body(c)
        return c
    for _ in range(int(max_trips)):
        c = tree_where(cond(c), body(c), c)
    return c
