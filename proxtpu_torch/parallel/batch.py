"""Scenario batching: many problem instances advanced in lockstep
(counterpart of ``proxtpu/parallel/batch.py``).

A batched iteration is one iteration object whose tensors carry a leading
batch axis (what a factory returns when called with stacked problem data,
or :func:`stack_iterations` of single ones).  ``torch.func.vmap`` maps its
``init``, ``step`` and stopping criterion over the lanes.  Converged lanes
freeze (a ``torch.where`` select: inside the mapped functions no tensor may
steer Python control flow), and per-lane iteration counts are returned:
exactly what running each problem alone would give.

One chunk core (:func:`_chunk_loop`) advances the batch for every driver
here: :func:`batched_run_loop`, the segmented run with its snapshots
(:func:`batched_run_segments`) and the compacting run
(:func:`compacting_batched_run`), so their counts and bits agree.
:func:`batched_run_recorded` keeps a per-lane history.
"""

from __future__ import annotations

import dataclasses
import inspect
import math

import numpy as np
import torch

from ..utils.host_loop import run_host_loop
from ..utils.shared import Shared, unwrap_shared
from ..utils.tracing import span
from ..utils.tree import _children, flatten, real_dtype_of, tree_leaves, \
    tree_map
from .sharded_ops import lane_parallel

# steps between the host's all-done tests: the generic driver's default K
# (the JAX package's) and the K of the drivers that take none (segments,
# compaction, recording); every step is masked, so K changes no count and
# no bit
_CHECK_EVERY = 8


def _is_number(v):
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def _same(a, b):
    return a is b or bool(a == b)


def stack_iterations(iterations):
    """Stack iteration objects of one structure into one batched iteration:
    every tensor gains a leading batch axis.

    A number that differs across the iterations becomes a ``(B,)`` tensor
    (in the real dtype of the iterations' tensors, on their device), as the
    JAX package stacks a Python number that is a pytree leaf; numbers equal
    in every iteration stay numbers.  Flags, strategies and whatever lies in
    a field that the object's class declares static (``proxclass``'s
    ``meta_fields``: ``backtrack_limit``, a memory, ``k``) must be equal, or
    this raises, as the JAX package's stacking does.  Shared-marked data
    cannot be stacked: stacking B copies inside a Shared wrapper would
    batch data the drivers then treat as lane-invariant.  Build the batched
    iteration through one factory call with stacked kwargs (or
    :class:`BatchedAlgorithm`) instead."""
    return _stack(iterations, "stack_iterations")


def _stack(objs, name):
    """Stack objects of one structure (``name`` is the caller, for the
    errors): every tensor gains a leading batch axis, every number that
    differs outside a static field (``proxclass``'s ``meta_fields``)
    becomes a lane tensor."""
    objs = list(objs)  # accept generators
    for o in objs:
        if any(flatten(o)[1].shared):
            raise ValueError(
                f"{name} cannot stack Shared-marked problem data; "
                "call the factory once with stacked kwargs and keep the "
                "Shared operand outside the stack (see BatchedAlgorithm)")
    x0 = getattr(objs[0], "x0", None)
    tensors = flatten(x0)[0] or flatten(objs[0])[0]
    like = next((t for t in tensors if t.is_floating_point()
                 or t.is_complex()), None)

    def numbers(values):
        if all(isinstance(v, int) for v in values):
            dtype = torch.int64
        else:
            dtype = (torch.get_default_dtype() if like is None
                     else real_dtype_of(like))
        return torch.tensor(values, dtype=dtype,
                            device=None if like is None else like.device)

    def refuse(i, static=None):
        raise ValueError(
            f"{name}: iteration {i} differs from iteration 0 in a part "
            "that is not a tensor or a number to stack ("
            + (f"the static field {static}" if static
               else "a flag or a strategy") + ")")

    def walk(nodes, static):
        first = nodes[0]
        kinds = [type(n) for n in nodes]
        if isinstance(first, torch.Tensor):
            for i, n in enumerate(nodes):
                if not isinstance(n, torch.Tensor):
                    refuse(i)
            return torch.stack(nodes)
        if dataclasses.is_dataclass(first) and not isinstance(first, type):
            for i, k in enumerate(kinds):
                if k is not kinds[0]:
                    refuse(i)
            meta = getattr(kinds[0], "_meta_fields", ())
            return dataclasses.replace(first, **{
                f.name: walk([getattr(n, f.name) for n in nodes], static or (
                    f"{kinds[0].__name__}.{f.name}" if f.name in meta
                    else None))
                for f in dataclasses.fields(first)})
        kids = None if first is None else _children(first)
        if kids is not None:
            keys = tuple(first) if isinstance(first, dict) else None
            parts = []
            for i, n in enumerate(nodes):
                if (type(n) is not kinds[0] or len(n) != len(first)
                        or (keys is not None and tuple(n) != keys)):
                    refuse(i)
                parts.append(_children(n)[0])
            return kids[1]([walk(list(c), static) for c in zip(*parts)])
        for i, n in enumerate(nodes):
            if not _same(n, first):
                if static or not all(_is_number(v) for v in nodes):
                    refuse(i, static)
                return numbers(nodes)
        return first

    return walk(objs, None)


def broadcast_hyperparams(iteration):
    """Normalize a batched iteration's tensors against the batch axis.

    * rank-0 tensors (the factory's hyperparameters, ``gamma``, ``alpha``)
      are broadcast to ``(B,)`` (a view);
    * tensors of rank >= 1 whose leading dim is NOT the batch size are
      wrapped in :class:`Shared`, the lane-invariant convention the kernel
      dispatch applies to a bare 2-D ``A``;
    * tensors already under a Shared marker stay as they are.

    B comes from the first tensor of ``iteration.x0`` not under a Shared
    marker (a tuple ``x0`` too), and only then are mismatched tensors
    wrapped.  Without such an ``x0``, B is the leading dim of the first
    tensor of rank >= 1, which cannot tell an unstacked operand from the
    batch axis, so only the rank-0 broadcast applies.  A lane-invariant
    tensor whose leading dim happens to equal B looks stacked: wrap it in
    ``Shared`` to say otherwise."""
    x0 = getattr(iteration, "x0", None)
    x0_leaves, x0_spec = flatten(x0)
    x0_leaves = [l for l, s in zip(x0_leaves, x0_spec.shared) if not s]
    leaves, spec = flatten(iteration)
    b_from_x0 = bool(x0_leaves) and x0_leaves[0].dim() > 0
    if b_from_x0:
        B = x0_leaves[0].shape[0]
    else:
        B = next((l.shape[0] for l, s in zip(leaves, spec.shared)
                  if not s and l.dim() > 0), None)
    if B is None:
        return iteration

    def fix(l, shared):
        if shared:
            return l
        if l.dim() == 0:
            return l.expand(B)
        if b_from_x0 and l.shape[0] != B:
            return Shared(l)
        return l

    return spec.unflatten([fix(l, s) for l, s in zip(leaves, spec.shared)])


def _lane_finite(state, B):
    """(B,) bool: every floating leaf of the lane's state is finite."""
    ok = torch.ones(B, dtype=torch.bool, device=tree_leaves(state)[0].device)
    for leaf in tree_leaves(state):
        if leaf.is_floating_point() or leaf.is_complex():
            ok = ok & torch.isfinite(leaf).reshape(B, -1).all(dim=1)
    return ok


def _freeze(done, old, new):
    """Per-lane select: lanes with done=True keep their old state."""
    return tree_map(
        lambda o, n: torch.where(
            done.reshape(done.shape + (1,) * (n.dim() - 1)), o, n),
        old, new)


def _default_stop(it, tol, s):
    return it.default_stopping_criterion(tol, s)


def _default_solution(it, s):
    return it.default_solution(s)


def _select_branches(iteration):
    """An iteration that branches on the host for one problem (a
    ``select_branches`` field, as ``LiLinIteration``'s) set to compute
    both branches and select per lane: what ``lax.cond`` becomes under
    ``vmap`` in the JAX package."""
    if dataclasses.is_dataclass(iteration) and "select_branches" in {
            f.name for f in dataclasses.fields(iteration)}:
        return dataclasses.replace(iteration, select_branches=True)
    return iteration


class _Lanes:
    """A batched iteration (through :func:`broadcast_hyperparams`) and its
    ``init``, ``step``, stopping criterion and solution mapped over the
    lanes: tensors under a Shared marker unmapped, every other one at
    axis 0."""

    def __init__(self, iteration, tol, stop=None, solution=None):
        self.iteration = broadcast_hyperparams(_select_branches(iteration))
        self.tol, self.stop_fn = tol, stop or _default_stop
        self.solution_fn = solution or _default_solution
        self.leaves, self.spec = flatten(self.iteration)
        self.axes = [None if s else 0 for s in self.spec.shared]
        stop_fn = self.stop_fn
        self._init = self.map(lambda it: it.init(), ())
        self._step = self.map(lambda it, s: it.step(s), (0,))
        self._stop = self.map(lambda it, s: stop_fn(it, tol, s), (0,))
        self._solution = self.map(self.solution_fn, (0,))

    def map(self, fn, in_dims):
        """``fn(lane_iteration, *args)`` over the lanes, ``in_dims`` the
        axes of ``args``."""
        spec = self.spec
        mapped = torch.func.vmap(
            lambda lv, *args: fn(unwrap_shared(spec.unflatten(lv)), *args),
            in_dims=(self.axes,) + tuple(in_dims))
        return lambda *args: mapped(self.leaves, *args)

    def init(self):
        return self._init()

    def step(self, state):
        return self._step(state)

    def stop(self, state):
        return self._stop(state)

    def solution(self, state):
        return self._solution(state)

    def take(self, index):
        """The lanes ``index`` (a tensor of lane numbers): the batched
        tensors gathered, the Shared ones left as they are."""
        leaves = [l if a is None else l[index]
                  for l, a in zip(self.leaves, self.axes)]
        return _Lanes(self.spec.unflatten(leaves), self.tol, self.stop_fn,
                      self.solution_fn)


def _chunk_loop(lanes, state, k0, done, iters, chunk, maxit, check_every=1,
                verbose=False, freq=100, halt_nonfinite=False):
    """Advance a batch from iteration ``k0`` for up to ``chunk`` iterations,
    until every lane is done or ``maxit``, freezing done lanes: the one
    core of every driver here.  Returns ``(k, state, done, iters)``, and
    ``dead`` fifth with ``halt_nonfinite``.

    The host tests all-done every ``check_every`` steps; the steps are
    masked, so counts and bits do not depend on it, and the returned ``k``
    is the device-tested loop's: where every lane stopped, the iteration
    at which the last one did.  ``verbose`` prints the converged-lane
    count every ``freq`` iterations.  ``halt_nonfinite``: a lane whose
    state turns non-finite is frozen at its last finite iterate, reported
    ``done=False`` with the iteration it died at, and no longer holds the
    batch to ``maxit``."""
    B = done.shape[0]
    dead = torch.zeros_like(done)
    if halt_nonfinite:
        dead = ~_lane_finite(state, B)

    def body(k, carry):
        state, done, dead, iters = carry
        frozen = done | dead
        new = _freeze(frozen, state, lanes.step(state))
        if halt_nonfinite:
            # a lane that turned non-finite dies and rolls back to its last
            # finite state
            newly_dead = ~frozen & ~_lane_finite(new, B)
            dead = dead | newly_dead
            new = _freeze(newly_dead, state, new)
        iters = torch.where(frozen, iters, k)
        done = done | (lanes.stop(new) & ~dead)
        if verbose and k % freq == 0:
            print(f"{k:6d} | {int(done.sum()):6d}/{B} lanes converged")
        return new, done, dead, iters

    (state, done, dead, iters), k = run_host_loop(
        body, (state, done, dead, iters), lambda c: c[1] | c[2],
        min(maxit, k0 + chunk), check_every=check_every, k=k0)
    stopped = done | dead
    if bool(stopped.all()):
        # masked steps may have run past the last lane's stop
        k = max(k0, int(iters.max()))
    iters = torch.clamp(torch.where(stopped, iters, k), max=maxit)
    if halt_nonfinite:
        return k, state, done, iters, dead
    return k, state, done, iters


def _start(lanes):
    """``(state, done, iters)`` of a batch at iteration 1."""
    state = lanes.init()
    done = lanes.stop(state)
    return state, done, torch.ones(done.shape, dtype=torch.int32,
                                   device=done.device)


@lane_parallel(stripes=True)
def batched_run_loop(iteration, maxit, tol, stop=None, solution=None,
                     check_every=1, verbose=False, freq=100,
                     halt_nonfinite=False):
    """Run a batched iteration until every lane converges or ``maxit``.

    Returns ``(solutions, iters, done)``: ``iters[i]`` is the iteration at
    which lane i converged (the ``maxit`` cap applies), the single-problem
    driver's count.  Lane-invariant data goes under
    :class:`~proxtpu_torch.utils.shared.Shared` (and see
    :func:`broadcast_hyperparams`).  ``check_every=K`` runs K steps between
    the host's all-done tests; every step is masked on the per-lane
    ``done`` flags, so counts and solutions do not depend on K (the JAX
    package's exact masked K-block): K sets only how often the host waits
    on the device.  ``verbose`` prints the converged-lane count every
    ``freq`` iterations.  ``halt_nonfinite``: a lane whose state turns
    non-finite is frozen at its last finite iterate, reported
    ``done=False`` with the iteration it died at, and no longer holds the
    batch to ``maxit``."""
    if check_every < 1:
        raise ValueError(f"check_every must be >= 1, got {check_every}")
    lanes = _Lanes(iteration, tol, stop, solution)
    state, done, iters = _start(lanes)
    _, state, done, iters = _chunk_loop(
        lanes, state, 1, done, iters, maxit, maxit, check_every=check_every,
        verbose=verbose, freq=freq, halt_nonfinite=halt_nonfinite)[:4]
    return lanes.solution(state), iters, done


def batched_run_recorded(iteration, maxit, tol, record, record_every=1,
                         stop=None, solution=None):
    """Batched solve with a per-lane history: returns ``(solutions, iters,
    done, RecordedTrace)``.

    The batched counterpart of
    :func:`proxtpu_torch.algorithms.core.run_loop_recorded`:
    ``record(iteration, k, state) -> tree`` is evaluated per lane (vmapped,
    Shared-aware) every ``record_every`` iterations, so every trace leaf
    gains a leading ``(slots, B)`` block.  Converged lanes freeze, so
    their recorded values plateau from their convergence on;
    ``trace.count`` is the number of slots written (the slowest lane's
    progress), and slot ``j`` of lane ``i`` is meaningful up to
    ``iters[i]``.

    The host tests all-done every few steps, and the steps it runs past
    the last lane's stop are masked no-ops.  The iteration at which the
    loop stops is kept on the device, and a step past it writes nothing,
    so ``count`` and the NaN after it are those of a loop tested before
    every step, without a wait on the device every step."""
    from ..algorithms.core import RecordedTrace, _trace_buffers, _trace_write

    lanes = _Lanes(iteration, tol, stop, solution)
    vrecord = lanes.map(record, (None, 0))
    state, done, iters = _start(lanes)
    slots = maxit // record_every
    first = vrecord(1, state)
    buf = _trace_write(_trace_buffers(slots, first), first, 1, record_every)
    k_stop = torch.ones((), dtype=torch.int64, device=done.device)

    def body(k, carry):
        state, done, iters, buf, k_stop = carry
        live = ~done.all()
        state = _freeze(done, state, lanes.step(state))
        if k % record_every == 0:
            buf = _trace_write(buf, vrecord(k, state), k, record_every,
                               keep=~live)
        iters = torch.where(done, iters, k)
        done = done | lanes.stop(state)
        return state, done, iters, buf, torch.where(live, k, k_stop)

    (state, done, iters, buf, k_stop), k = run_host_loop(
        body, (state, done, iters, buf, k_stop), lambda c: c[1], maxit,
        check_every=_CHECK_EVERY)
    iters = torch.clamp(torch.where(done, iters, k), max=maxit)
    trace = RecordedTrace(values=tree_map(lambda b: b[:slots], buf),
                          count=k_stop // record_every)
    return lanes.solution(state), iters, done, trace


def batched_run_segments(iteration, maxit, tol, *, segment, stop=None,
                         solution=None, callback=None, resume=None):
    """Segmented batched run: checkpoint and resume for long batched sweeps.

    The same chunk core as :func:`batched_run_loop` advances the batch, so
    per-lane counts and solutions are the same, bit for bit, but the run is
    cut into segments of ``segment`` iterations.  After each segment
    ``callback`` (if given) receives a snapshot dict, ``{"state": <batched
    state>, "k": int, "done": (B,) bool, "iters": (B,) int32}``: pass it
    to :func:`proxtpu_torch.utils.checkpoint.save_state` to keep a long
    run; ``resume=snapshot`` goes on exactly where a previous run stopped.
    A segment boundary costs the host a wait on the device.

    Returns ``(solutions, iters, done)`` like ``batched_run_loop``."""
    if segment < 1:
        raise ValueError(f"segment must be >= 1, got {segment}")
    lanes = _Lanes(iteration, tol, stop, solution)
    if resume is None:
        state, done, iters = _start(lanes)
        k = 1
    else:
        state, k = resume["state"], int(resume["k"])
        done = torch.as_tensor(resume["done"])
        iters = torch.as_tensor(resume["iters"], dtype=torch.int32)
    while True:
        k, state, done, iters = _chunk_loop(
            lanes, state, k, done, iters, segment, maxit,
            check_every=_CHECK_EVERY)
        if callback is not None:
            callback({"state": state, "k": k, "done": done, "iters": iters})
        if k >= maxit or bool(done.all()):
            break
    return lanes.solution(state), iters, done


def _bucket(n, min_batch):
    b = max(min_batch, 1)
    while b < n:
        b *= 2
    return b


def compacting_batched_run(iteration, maxit, tol, stop=None, solution=None,
                           chunk=256, min_batch=8):
    """Batched run with lane compaction: after every ``chunk`` iterations,
    converged lanes are retired and the remaining ones gathered into a
    smaller batch (a power of two, at least ``min_batch``), so a long
    convergence tail runs on a shrinking problem set.

    Per-lane solutions, counts and done flags are those of
    :func:`batched_run_loop`, as long as a lane's arithmetic does not
    depend on the batch size (it does not on the CPU in float64; a
    batched product on the card may sum in another order at another
    batch size).  Shared subtrees pass through unchanged.  Padding lanes
    repeat the first live lane, start done, and carry a sentinel id, so
    they are never written back.  One wait on the device per chunk."""
    lanes = _Lanes(iteration, tol, stop, solution)
    state, done, iters = _start(lanes)
    dev = done.device
    B = done.shape[0]
    out_solution = None  # allocated from the first retired lanes
    out_iters = torch.zeros(B, dtype=torch.int32, device=dev)
    out_done = torch.zeros(B, dtype=torch.bool, device=dev)
    lane_ids = np.arange(B)
    k = 1
    while True:
        k, state, done, iters = _chunk_loop(
            lanes, state, k, done, iters, chunk, maxit,
            check_every=_CHECK_EVERY)
        done_h = done.cpu().numpy()
        finished = done_h | (k >= maxit)
        sel = np.nonzero(finished & (lane_ids >= 0))[0]
        if sel.size:
            sols = lanes.solution(state)
            if out_solution is None:
                out_solution = tree_map(
                    lambda l: l.new_zeros((B,) + tuple(l.shape[1:])), sols)
            sel_t = torch.as_tensor(sel, device=dev)
            ids = torch.as_tensor(lane_ids[sel], device=dev)
            tree_map(lambda o, l: o.index_copy_(0, ids, l[sel_t]),
                     out_solution, sols)
            out_iters[ids] = iters[sel_t]
            out_done[ids] = done[sel_t]
        live = np.nonzero(~finished)[0]
        if live.size == 0 or k >= maxit:
            break
        bucket = _bucket(live.size, min_batch)
        pad = torch.as_tensor(np.concatenate(
            [live, np.full(bucket - live.size, live[0])]), device=dev)
        lanes = lanes.take(pad)
        state = tree_map(lambda l: l[pad], state)
        iters = iters[pad]
        done = torch.arange(bucket, device=dev) >= live.size
        # padding lanes get a sentinel id, so their copies are never
        # written back over the real lane's result
        lane_ids = np.concatenate([lane_ids[live],
                                   np.full(bucket - live.size, -1)])
    return out_solution, out_iters, out_done


def _default_backtrack_limit(kwargs):
    """Trip budget of the masked step search: enough halvings to reach
    acceptance or the ``minimum_gamma`` floor, ``ceil(log2(gamma0 /
    minimum_gamma))`` + 4, and never below 32 (as the JAX package)."""
    min_g = float(kwargs.get("minimum_gamma") or 1e-7)
    g0 = None
    if kwargs.get("gamma") is not None:
        g0 = float(torch.as_tensor(kwargs["gamma"]).max())
    elif kwargs.get("Lf") is not None:
        g0 = 1.0 / float(torch.as_tensor(kwargs["Lf"]).min())
    if g0 is None or g0 <= 0 or min_g <= 0:
        return 32
    return max(32, int(math.ceil(math.log2(max(g0 / min_g, 1.0)))) + 4)


class BatchedAlgorithm:
    """Batched counterpart of
    :class:`~proxtpu_torch.algorithms.core.IterativeAlgorithm`.

    Construct from an iteration factory, call with stacked problem kwargs
    (leading batch axis on every tensor)::

        solver = BatchedAlgorithm(make_fast_forward_backward_iteration,
                                  maxit=1000, tol=1e-6)
        xs, iters, done = solver(x0=X0, f=LeastSquaresLoss(A, b),
                                 g=NormL1(lam), Lf=Lfs)

    ``use_kernels="auto"`` (default) routes the shapes that
    :func:`~proxtpu_torch.kernels.dispatch.match_kernel_solver` and
    :func:`~proxtpu_torch.kernels.dispatch.match_tv_solver` recognise
    (batched lasso FISTA, batched box-QP projected gradient, batched TV
    denoising by Chambolle-Pock, options at their defaults) to the kernel
    solvers; then adaptive FB / FISTA
    (:func:`~proxtpu_torch.kernels.dispatch.match_flat_adaptive`) and
    PANOC, ZeroFPR, PANOCplus, DRLS
    (:func:`~proxtpu_torch.kernels.dispatch.match_flat_linesearch`) to the
    flat trial/commit machines; anything else runs the generic driver,
    :func:`batched_run_loop`.  ``use_kernels=False`` forces the generic
    driver.  ``verbose`` and ``halt_nonfinite`` also force it (the other
    routes have neither).

    Traced (:mod:`..utils.tracing`): ``batched.match`` around the matchers
    and ``batched.solve`` around the route they chose."""

    def __init__(self, iteration_factory, *, maxit, tol, stop=None,
                 solution=None, use_kernels="auto", check_every=None,
                 verbose=False, freq=100, halt_nonfinite=False, **kwargs):
        self.iteration_factory = iteration_factory
        self.maxit = maxit
        self.tol = tol
        self.stop = stop
        self.solution = solution
        self.use_kernels = use_kernels
        # steps between the generic driver's all-done tests; blocking is
        # exact (masked), None = 8 as in the JAX package
        self.check_every = check_every
        self.verbose = verbose
        self.freq = freq
        self.halt_nonfinite = halt_nonfinite
        self.kwargs = kwargs

    def _inject_backtrack_limit(self, merged):
        """Default ``backtrack_limit`` in ``merged`` (in place) where the
        factory takes one and the caller did not set it: under vmap the
        step search must be the masked loop with a fixed number of
        trips."""
        if "backtrack_limit" not in merged:
            params = inspect.signature(self.iteration_factory).parameters
            if "backtrack_limit" in params:
                merged["backtrack_limit"] = _default_backtrack_limit(merged)

    @lane_parallel(stripes=True)
    def __call__(self, **kwargs):
        merged = {**self.kwargs, **kwargs}
        # a kwarg the factory does not take must not be dropped by a
        # structural matcher: skip the kernel routes so that the factory
        # raises its own TypeError
        params = inspect.signature(self.iteration_factory).parameters
        has_var_kw = any(p.kind is inspect.Parameter.VAR_KEYWORD
                         for p in params.values())
        unknown = not has_var_kw and any(k not in params for k in merged)
        if (self.use_kernels and not unknown and not self.verbose
                and not self.halt_nonfinite):
            from ..kernels.dispatch import (
                match_flat_adaptive,
                match_flat_linesearch,
                match_kernel_solver,
                match_tv_solver,
            )

            with span("batched.match"):
                for match, extra in (
                        (match_kernel_solver, {}), (match_tv_solver, {}),
                        # the flat machines' counts do not depend on the
                        # block of trips between host tests; 8 for the
                        # adaptive FB / FISTA machine, the matcher's choice
                        # otherwise
                        (match_flat_adaptive,
                         dict(check_every=self.check_every or 8)),
                        (match_flat_linesearch,
                         dict(check_every=self.check_every))):
                    run = match(
                        self.iteration_factory, merged, tol=self.tol,
                        maxit=self.maxit, stop=self.stop,
                        solution=self.solution, **extra)
                    if run is not None:
                        break
            if run is not None:
                with span("batched.solve"):
                    return run()
        # injected after the match, so that a matcher sees backtrack_limit
        # only when the caller set it
        self._inject_backtrack_limit(merged)
        iteration = self.iteration_factory(**merged)
        return batched_run_loop(
            iteration, self.maxit, self.tol, stop=self.stop,
            solution=self.solution,
            check_every=self.check_every or _CHECK_EVERY,
            verbose=self.verbose, freq=self.freq,
            halt_nonfinite=self.halt_nonfinite)

    def run_recorded(self, record, record_every=1, **kwargs):
        """Batched solve with a per-lane history: returns ``(solutions,
        iters, done, RecordedTrace)`` (see :func:`batched_run_recorded`).
        Always the generic driver (the other routes have no record hook),
        with the bounded step search injected as in ``__call__``."""
        merged = {**self.kwargs, **kwargs}
        self._inject_backtrack_limit(merged)
        iteration = self.iteration_factory(**merged)
        return batched_run_recorded(
            iteration, self.maxit, self.tol, record,
            record_every=record_every, stop=self.stop,
            solution=self.solution)


def batch_problems(factory, problem_list):
    """A batched iteration from a list of per-problem kwargs dicts (each
    must give an iteration of one structure, see
    :func:`stack_iterations`)."""
    return stack_iterations([factory(**kw) for kw in problem_list])
