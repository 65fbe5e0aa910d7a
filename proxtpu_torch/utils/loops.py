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

import torch

from .tree import tree_leaves, tree_where


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


def vmap_while(cond, body, init, maxit, inputs):
    """A ``lax.while_loop`` whose ``cond`` also tests ``k < maxit`` (the
    inner loops of the prox functions).

    Which form runs is decided once, by the loop's ``inputs`` (the tensors
    its result depends on): plain tensors (one problem) loop on the host
    and pay no trip after the condition fails; if any is a batched tensor
    of ``torch.func.vmap``, the loop runs ``maxit`` masked trips, which
    gives what JAX's ``while_loop`` gives under ``vmap`` (every lane's
    result as if alone, finished lanes frozen) and pays ``maxit`` trips
    whatever the lanes need."""
    mapped = any(torch._C._functorch.is_batchedtensor(t)
                 for t in tree_leaves(inputs) if isinstance(t, torch.Tensor))
    return bounded_while(cond, body, init, maxit if mapped else None)
