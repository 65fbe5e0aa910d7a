"""Generic solver driver (counterpart of ``proxtpu/algorithms/core.py``).

The two-stage use is the reference's: options at construction
(``solver = FastForwardBackward(tol=1e-6)``), problem at call
(``x, it = solver(x0=x0, f=f, g=g, Lf=Lf)``), call-site kwargs overriding
construction kwargs.  Iteration objects provide ``init()``, ``step(s)``,
``default_stopping_criterion(tol, s)``, ``default_solution(s)`` and
``default_display(k, s)``.  Where the JAX package compiles one
``while_loop``, the port runs the loop on the host and tests the stopping
criterion after every step; one problem is small, so the test is cheap.
"""

from __future__ import annotations


def _default_stop(iteration, tol, state):
    return iteration.default_stopping_criterion(tol, state)


def _default_solution(iteration, state):
    return iteration.default_solution(state)


def _default_display(k, iteration, state):
    iteration.default_display(k, state)


def run_loop(iteration, maxit, tol, stop, solution, verbose, freq, display):
    """Run an iteration to convergence; returns ``(solution, k)``.

    The reference's loop: the initial state counts as iteration 1, and the
    loop exits as soon as ``k >= maxit`` or the stopping criterion holds at
    state k.  With ``verbose``, ``display`` runs every ``freq`` iterations
    and once at the end."""
    state = iteration.init()
    k = 1
    while k < maxit and not bool(stop(iteration, tol, state)):
        state = iteration.step(state)
        k += 1
        if verbose and k % freq == 0:
            display(k, iteration, state)
    if verbose:
        display(k, iteration, state)
    return solution(iteration, state), k


class IterativeAlgorithm:
    """An iteration factory plus run options.

    ``IterativeAlgorithm(factory, maxit=..., tol=..., **iter_kwargs)``;
    call the result with the remaining problem kwargs to solve."""

    def __init__(self, iteration_factory, *, maxit, tol, stop=None,
                 solution=None, verbose=False, freq=100, display=None,
                 **kwargs):
        self.iteration_factory = iteration_factory
        self.maxit = maxit
        self.tol = tol
        self.stop = stop or _default_stop
        self.solution = solution or _default_solution
        self.verbose = verbose
        self.freq = freq
        self.display = display or _default_display
        self.kwargs = kwargs

    def make_iteration(self, **kwargs):
        return self.iteration_factory(**{**self.kwargs, **kwargs})

    def run(self, **kwargs):
        """Returns ``(solution, iteration count)``."""
        return run_loop(self.make_iteration(**kwargs), self.maxit, self.tol,
                        self.stop, self.solution, self.verbose, self.freq,
                        self.display)

    def __call__(self, **kwargs):
        return self.run(**kwargs)
