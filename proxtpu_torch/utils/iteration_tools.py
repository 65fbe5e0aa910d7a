"""Iterator combinators over eager state streams (counterpart of
``proxtpu/utils/iteration_tools.py``).

``halt``, ``tee``, ``sample``, ``stopwatch`` and ``loop`` are the
reference's ``IterationTools`` (``src/utilities/iteration_tools.jl``), for
the power-user path: the generator of states of
:func:`proxtpu_torch.algorithms.core.states`, for debugging, plotting and
stopping rules of one's own.  :class:`Counting` counts a function's oracle
calls, the cost metric of this domain.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any


def halt(iterable, fun):
    """Yield items until ``fun(item)`` is true; the triggering item is the
    last one yielded (``iteration_tools.jl:9-40``)."""
    for item in iterable:
        yield item
        if fun(item):
            return


def tee(iterable, fun):
    """Call ``fun(item)`` on every item as a side effect
    (``iteration_tools.jl:44-64``)."""
    for item in iterable:
        fun(item)
        yield item


def sample(iterable, period):
    """Yield every ``period``-th item (``iteration_tools.jl:68-100``)."""
    for k, item in enumerate(iterable, start=1):
        if k % period == 0:
            yield item


def stopwatch(iterable):
    """Pair every item with the nanoseconds elapsed since iteration started
    (``iteration_tools.jl:104-133``)."""
    t0 = time.perf_counter_ns()
    for item in iterable:
        yield (time.perf_counter_ns() - t0, item)


def loop(iterable):
    """Drain the iterable, returning the last item
    (``iteration_tools.jl:137-145``)."""
    item = None
    for item in iterable:
        pass
    return item


class _CountStore:
    """The counters of a :class:`Counting`, shared by identity: the batched
    driver rebuilds an iteration object from its tensors (and every copy of
    a ``Counting`` keeps the same store), so the counts of the copies land
    on the caller's wrapper."""

    __slots__ = ("eval", "gradient", "prox")

    def __init__(self):
        self.eval = self.gradient = self.prox = 0


@dataclasses.dataclass(eq=False)
class Counting:
    """Oracle-call counting wrapper (the ``Counting`` wrapper of the
    reference docs, ``docs/src/guide/custom_objectives.jl:99-137``).

    The port runs eagerly, so the counters count every actual call, as the
    reference does; the JAX package counts once per traced step under
    ``jit``.  ``f`` is a dataclass field, so the batched driver's
    ``flatten`` opens the wrapper and maps the tensors of ``f``."""

    f: Any
    _store: _CountStore = dataclasses.field(default_factory=_CountStore)

    @property
    def eval_count(self):
        return self._store.eval

    @property
    def gradient_count(self):
        return self._store.gradient

    @property
    def prox_count(self):
        return self._store.prox

    @property
    def is_convex(self):
        return bool(getattr(self.f, "is_convex", False))

    @property
    def is_generalized_quadratic(self):
        return bool(getattr(self.f, "is_generalized_quadratic", False))

    def __call__(self, x):
        self._store.eval += 1
        return self.f(x)

    def value_and_gradient(self, x):
        from ..prox.base import value_and_gradient

        self._store.gradient += 1
        return value_and_gradient(self.f, x)

    def prox(self, x, gamma):
        from ..prox.base import prox

        self._store.prox += 1
        return prox(self.f, x, gamma)

    def reset(self):
        self._store.eval = self._store.gradient = self._store.prox = 0
