"""Generic solver driver (counterpart of ``proxtpu/algorithms/core.py``).

The two-stage use is the reference's: options at construction
(``solver = FastForwardBackward(tol=1e-6)``), problem at call
(``x, it = solver(x0=x0, f=f, g=g, Lf=Lf)``), call-site kwargs overriding
construction kwargs.  Iteration objects provide ``init()``, ``step(s)``,
``default_stopping_criterion(tol, s)``, ``default_solution(s)`` and
``default_display(k, s)``.  Where the JAX package compiles one
``while_loop``, the port runs the loop on the host.  By default it tests
the stopping criterion after every step; ``check_every=K`` runs K masked
steps on the device between the host's tests, with the same counts and
bits.

Beside the driver: :func:`run_loop_recorded` (an iteration history in
preallocated buffers), resume from a captured state (``resume_from`` /
``resume_iters``) and :func:`states`, the eager generator of states.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..utils.tree import tree_leaves, tree_map


def _default_stop(iteration, tol, state):
    return iteration.default_stopping_criterion(tol, state)


def _default_solution(iteration, state):
    return iteration.default_solution(state)


def _default_display(k, iteration, state):
    iteration.default_display(k, state)


def _select(done, old, new):
    """``old`` where the scalar ``done`` holds, else ``new``, leaf by leaf
    (a leaf that is no tensor must be the same object in both)."""
    def sel(o, n):
        if isinstance(n, torch.Tensor):
            return torch.where(done, o, n)
        if o is not n and o != n:
            raise TypeError("check_every > 1 needs a state whose leaves are "
                            f"tensors; got {type(n).__name__}")
        return n

    return tree_map(sel, old, new)


def _run_blocked(iteration, state, k, maxit, tol, stop, verbose, freq,
                 display, check_every):
    """``check_every`` masked steps between the host's tests of ``done``:
    a step after convergence (or the ``maxit`` cap) keeps the state and
    the count, so both equal ``check_every=1``'s, bit for bit."""
    dev = tree_leaves(state)[0].device
    k = torch.tensor(k, device=dev)
    done = (k >= maxit) | torch.as_tensor(stop(iteration, tol, state),
                                          device=dev)
    while not bool(done):
        for _ in range(check_every):
            ran = ~done
            state = _select(done, state, iteration.step(state))
            k = torch.where(done, k, k + 1)
            done = done | (k >= maxit) | torch.as_tensor(
                stop(iteration, tol, state), device=dev)
            # the cadence of check_every=1: a step that ran displays at
            # k % freq == 0, also the step that converged
            if verbose and bool(ran & (k % freq == 0)):
                display(int(k), iteration, state)
    return state, int(k)


def run_loop(iteration, maxit, tol, stop, solution, verbose, freq, display,
             initial_state=None, k0=1, check_every=1):
    """Run an iteration to convergence; returns ``(solution, k)``.

    The reference's loop: the initial state counts as iteration 1, and the
    loop exits as soon as ``k >= maxit`` or the stopping criterion holds at
    state k.  With ``verbose``, ``display`` runs every ``freq`` iterations
    and once at the end.

    ``initial_state`` resumes from a captured state (one of
    :func:`states`, or one restored by
    :func:`proxtpu_torch.utils.checkpoint.load_state`); ``k0`` is its
    iteration number (the count a previous segment returned), so ``maxit``
    bounds the whole solve and the returned count is the total across
    segments.

    ``check_every=K`` runs K steps between the host's tests of the
    stopping criterion, each masked on a ``done`` flag kept on the device:
    the counts and solutions of ``check_every=1``, bit for bit, with one
    wait on the device every K steps instead of every step.  At most
    ``K - 1`` masked steps run after convergence.  The option is there for
    parity with the JAX package: on an H100 a single problem's solve was
    slower at K = 16 than at K = 1 in every measured run (the masked
    selects cost more than the waits they save; ``PERF.md``, route (q)),
    so K = 1 stays the default."""
    if check_every < 1:
        raise ValueError(f"check_every must be >= 1, got {check_every}")
    state = iteration.init() if initial_state is None else initial_state
    k = int(k0)
    if check_every == 1:
        while k < maxit and not bool(stop(iteration, tol, state)):
            state = iteration.step(state)
            k += 1
            if verbose and k % freq == 0:
                display(k, iteration, state)
    else:
        state, k = _run_blocked(iteration, state, k, maxit, tol, stop,
                                verbose, freq, display, check_every)
    if verbose:
        display(k, iteration, state)
    return solution(iteration, state), k


class RecordedTrace(NamedTuple):
    """Iteration history returned by :func:`run_loop_recorded`.

    ``values`` is the tree ``record`` returned, with a leading time axis of
    length ``maxit // record_every``; slot ``j`` holds the record taken at
    iteration ``k = (j + 1) * record_every``.  ``count`` is how many slots
    were written (the rest hold NaN for floating dtypes, ``False`` for
    bool and the type's minimum for integers), so ``values[:count]`` is
    the valid prefix."""

    values: Any
    count: Any

    def valid(self):
        """The written prefix of every leaf.

        On resume (``k0 > 1``) ``count`` is ``k // record_every``, slots
        before the resume point included, which this segment never wrote:
        the prefix then leads with fill values.  Concatenate the previous
        segment's trace over them, or slice from
        ``(k0 - 1) // record_every``."""
        n = int(self.count)
        return tree_map(lambda v: v[:n], self.values)


def _trace_buffers(slots, vals):
    """Buffers of ``(slots + 1, *leaf.shape)`` for every leaf of the
    sample ``vals``, filled with NaN (floating and complex), ``False``
    (bool) or the type's minimum (integers).

    The spare slot takes the degenerate resume write: with ``k0 > maxit``
    the write before the loop lands at slot ``>= slots``, which is clamped
    to the spare slot so that it cannot overwrite the last real one."""
    def alloc(leaf):
        leaf = torch.as_tensor(leaf)
        if leaf.is_floating_point() or leaf.is_complex():
            fill = float("nan")
        elif leaf.dtype == torch.bool:
            fill = False
        else:
            fill = torch.iinfo(leaf.dtype).min
        return torch.full((slots + 1,) + tuple(leaf.shape), fill,
                          dtype=leaf.dtype, device=leaf.device)

    return tree_map(alloc, vals)


def _trace_write(buf, vals, k, record_every, keep=None):
    """Write ``vals`` in place at slot ``k // record_every - 1`` when the
    host's ``k`` is a recording iteration.  ``keep`` (a bool tensor), where
    given, keeps the buffers' contents instead: a step the loop runs past
    its exit (see :func:`~proxtpu_torch.parallel.batch.batched_run_recorded`)
    writes nothing."""
    if k % record_every:
        return buf
    slot = min(max(k // record_every - 1, 0), tree_leaves(buf)[0].shape[0]
               - 1)

    def write(b, v):
        v = torch.as_tensor(v, device=b.device).to(b.dtype)
        b[slot] = v if keep is None else torch.where(keep, b[slot], v)
        return b

    return tree_map(write, buf, vals)


def run_loop_recorded(iteration, maxit, tol, stop, solution, record,
                      record_every=1, verbose=False, freq=100, display=None,
                      initial_state=None, k0=1):
    """Like :func:`run_loop`, and also samples ``record(iteration, k,
    state)`` every ``record_every`` iterations into preallocated buffers
    on the state's device.  Returns ``(solution, k, RecordedTrace)``.

    The counterpart of the reference's ``tee`` / ``sample`` combinators
    (``src/utilities/iteration_tools.jl:44-100``) and of the guide's
    collect-the-iterates pattern: ``record`` may return any tree of
    tensors, scalars (objective, residual) or whole iterates.  On resume
    (``k0 > 1``) slots before ``k0`` are left unwritten and ``count`` is
    still ``k // record_every``."""
    state = iteration.init() if initial_state is None else initial_state
    k = int(k0)
    slots = maxit // record_every
    first = record(iteration, k, state)
    buf = _trace_write(_trace_buffers(slots, first), first, k, record_every)
    while k < maxit and not bool(stop(iteration, tol, state)):
        state = iteration.step(state)
        k += 1
        if k % record_every == 0:
            buf = _trace_write(buf, record(iteration, k, state), k,
                               record_every)
        if verbose and k % freq == 0:
            display(k, iteration, state)
    if verbose:
        display(k, iteration, state)
    trace = RecordedTrace(values=tree_map(lambda b: b[:slots], buf),
                          count=k // record_every)
    return solution(iteration, state), k, trace


class IterativeAlgorithm:
    """An iteration factory plus run options.

    ``IterativeAlgorithm(factory, maxit=..., tol=..., **iter_kwargs)``;
    call the result with the remaining problem kwargs to solve.
    ``check_every=K`` runs K masked steps between the host's tests of the
    stopping criterion (see :func:`run_loop`)."""

    def __init__(self, iteration_factory, *, maxit, tol, stop=None,
                 solution=None, verbose=False, freq=100, display=None,
                 check_every=1, **kwargs):
        self.iteration_factory = iteration_factory
        self.maxit = maxit
        self.tol = tol
        self.stop = stop or _default_stop
        self.solution = solution or _default_solution
        self.verbose = verbose
        self.freq = freq
        self.display = display or _default_display
        self.check_every = check_every
        self.kwargs = kwargs

    def make_iteration(self, **kwargs):
        """The iteration of this solver on the problem ``kwargs``.
        Replicated DTensors (``parallel.replicate``) enter as their local
        full tensors; sharded ones stay placed for the objects that
        communicate (``ShardedMatrixOperator``, consensus blocks)."""
        from ..parallel.sharded_ops import localize

        merged, _ = localize({**self.kwargs, **kwargs}, lanes=False)
        return self.iteration_factory(**merged)

    def run(self, resume_from=None, resume_iters=None, **kwargs):
        """Returns ``(solution, iteration count)``.

        ``resume_from`` continues from a captured state (one of
        :func:`states`, or one restored by
        :func:`~proxtpu_torch.utils.checkpoint.load_state`);
        ``resume_iters`` is that state's iteration count (the count the
        previous segment returned), so that the count and the ``maxit``
        budget span the whole solve."""
        return run_loop(
            self.make_iteration(**kwargs), self.maxit, self.tol, self.stop,
            self.solution, self.verbose, self.freq, self.display,
            initial_state=resume_from,
            k0=1 if resume_iters is None else resume_iters,
            check_every=self.check_every)

    def run_recorded(self, record, record_every=1, resume_from=None,
                     resume_iters=None, **kwargs):
        """Returns ``(solution, iteration count, RecordedTrace)``:
        ``record(iteration, k, state) -> tree`` sampled every
        ``record_every`` iterations (see :func:`run_loop_recorded`)::

            x, it, tr = solver.run_recorded(
                lambda it, k, s: tree_inf_norm(s.res) / s.gamma,
                record_every=10, x0=x0, f=f, g=g, Lf=Lf)
            residual_curve = tr.valid()
        """
        return run_loop_recorded(
            self.make_iteration(**kwargs), self.maxit, self.tol, self.stop,
            self.solution, record, record_every=record_every,
            verbose=self.verbose, freq=self.freq,
            display=self.display if self.verbose else None,
            initial_state=resume_from,
            k0=1 if resume_iters is None else resume_iters)

    def __call__(self, resume_from=None, resume_iters=None, **kwargs):
        sol, k = self.run(resume_from=resume_from, resume_iters=resume_iters,
                          **kwargs)
        return sol, int(k)


def states(iteration, max_states=None):
    """Yield successive states eagerly (the power-user iterator path,
    ``docs/src/guide/getting_started.jl:136-152``): ``init()`` first, then
    one ``step`` per item, ``max_states`` items at most.  States are not
    changed in place, so they may be kept."""
    state = iteration.init()
    k = 0
    while True:
        yield state
        k += 1
        if max_states is not None and k >= max_states:
            return
        state = iteration.step(state)
