"""Profiling hooks (counterpart of ``proxtpu/utils/profiling.py``).

* :func:`trace` — a ``torch.profiler`` trace of everything inside the
  block (host operations, and the card's kernels and copies where a card
  is present), written as ``*.pt.trace.json`` for TensorBoard or Perfetto;
* :func:`compiled_stats` — the operations, bytes and transcendentals of
  one solver call, and its memory.

The JAX package asks XLA for a compiled program's cost analysis without
running it.  PyTorch has no ahead-of-time cost analysis of a solve that
loops on the host, so :func:`compiled_stats` runs ``fn`` once and counts
what ran: the ATen operations through
``torch.utils.flop_counter.FlopCounterMode`` (matrix products, matvecs,
inner products and convolutions; elementwise operations count no flops
there) and a dispatch mode that counts each operation's tensor bytes, and
the hand-written kernels through their wrappers.  A wrapper adds its
kernel's share by the JAX package's ``pl.CostEstimate`` formula for that
kernel, whether it launches the kernel or runs the plain version (on the
CPU); the plain version's own ATen operations are then not counted, so one
solve gives the same numbers on the CPU and on the card for the same
launches.  XLA counts a ``while_loop``'s body once; the port counts the
whole call, every iteration.
"""

from __future__ import annotations

import contextlib
import functools
import time

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# the tallies of the compiled_stats calls under way (innermost last)
_tallies = []

# ATen operations whose output elements count as transcendentals
_TRANSCENDENTAL = {"exp", "exp2", "expm1", "log", "log1p", "log2", "log10",
                   "sqrt", "rsqrt", "sin", "cos", "tan", "tanh", "sigmoid",
                   "erf", "erfc", "pow", "atan2", "asin", "acos", "atan"}


def _nbytes(tree):
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(_nbytes(t) for t in tree)
    return 0


def _numel(tree):
    if isinstance(tree, torch.Tensor):
        return tree.numel()
    if isinstance(tree, (tuple, list)):
        return sum(_numel(t) for t in tree)
    return 0


class _BytesMode(TorchDispatchMode):
    """Counts, for every ATen operation but views, the bytes of its tensor
    arguments (read once) and results (written once), and the result
    elements of the transcendental ones."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.transcendentals = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            self.bytes += (_nbytes(list(args)) + _nbytes(kwargs or {})
                           + _nbytes(out))
            if func.overloadpacket.__name__.rstrip("_") in _TRANSCENDENTAL:
                self.transcendentals += _numel(out)
        return out


class _Tally:
    """What one :func:`compiled_stats` call counts: the modes over the ATen
    operations, the kernels' estimates, and the ATen counts made inside a
    kernel wrapper, which its estimate replaces."""

    def __init__(self, flop_mode, bytes_mode):
        self.flop_mode, self.bytes_mode = flop_mode, bytes_mode
        self.kernels = {}
        self.inside = 0
        self.skipped = [0, 0, 0]

    def _aten(self):
        return (self.flop_mode.get_total_flops(), self.bytes_mode.bytes,
                self.bytes_mode.transcendentals)

    @contextlib.contextmanager
    def wrapper(self):
        """The span of a kernel wrapper's call: its ATen counts are set
        aside.  Yields the tally, or ``None`` inside another wrapper (the
        outer one counts)."""
        if self.inside:
            yield None
            return
        before = self._aten()
        self.inside += 1
        try:
            yield self
        finally:
            self.inside -= 1
            self.skipped = [s + a - b for s, a, b in
                            zip(self.skipped, self._aten(), before)]

    def add(self, name, cost):
        entry = self.kernels.setdefault(name, {
            "launches": 0, "flops": 0, "bytes accessed": 0,
            "transcendentals": 0})
        entry["launches"] += 1
        for key, v in cost.items():
            entry[key] += v

    def totals(self):
        aten = [a - s for a, s in zip(self._aten(), self.skipped)]
        for entry in self.kernels.values():
            aten[0] += entry["flops"]
            aten[1] += entry["bytes accessed"]
            aten[2] += entry["transcendentals"]
        return dict(zip(("flops", "bytes accessed", "transcendentals"),
                        aten))


def kernel_cost(name, cost):
    """Decorate a kernel wrapper: under :func:`compiled_stats`, each call
    that returns adds ``cost(*args, **kwargs)`` (:func:`estimate` of the
    JAX package's ``CostEstimate`` for the kernel) under ``name``, in place
    of the ATen operations it runs."""
    def wrap(fn):
        @functools.wraps(fn)
        def counted(*args, **kwargs):
            if not _tallies:
                return fn(*args, **kwargs)
            with _tallies[-1].wrapper() as tally:
                out = fn(*args, **kwargs)
                if tally is not None:
                    tally.add(name, cost(*args, **kwargs))
            return out
        return counted
    return wrap


def estimate(flops, nbytes, transcendentals=0):
    """A kernel's cost in the keys of :func:`compiled_stats`."""
    return {"flops": int(flops), "bytes accessed": int(nbytes),
            "transcendentals": int(transcendentals)}


@contextlib.contextmanager
def trace(log_dir):
    """Profile everything inside the block into ``log_dir``::

        with trace("prof"):
            x, it = solver(x0=x0, f=f, g=g, Lf=Lf)

    Host activity always, the card's (kernels, copies) where CUDA is
    available.  On the card the trace opens with a warm-up, which shows in
    it: one-element kernels launched for ``WARMUP_SECONDS`` under the range
    ``proxtpu_torch.trace: warm-up`` (see there), then a synchronisation;
    the card is synchronised again before the trace is written.  The trace
    is ``log_dir/<host>_<pid>.<time>.pt.trace.json``."""
    from torch.profiler import ProfilerActivity, profile, \
        tensorboard_trace_handler

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        if cuda:
            _warm_up_device()
        try:
            yield
        finally:
            if cuda:
                torch.cuda.synchronize()


# On an H100 (torch 2.11, CUDA 12.8) the profiler has lost the kernel
# records of a session's first launches (19 to 22 of them, one a fista_step
# launch) in a process that had run for minutes and profiled before
# (chip_smoke.py, route (v)); tools/profiler_records.py, which profiles
# after each of the things that process did before, lost none, so the
# condition is not known.  The loss fell on the session's first launches,
# whatever the wait before them, so the warm-up launches one-element
# kernels for WARMUP_SECONDS of host time, and a loss of the session's
# start falls on them, however slow the host.
WARMUP_SECONDS = 0.01


def _warm_up_device():
    from torch.profiler import record_function

    with record_function("proxtpu_torch.trace: warm-up"):
        t = torch.zeros(1, device="cuda")
        end = time.perf_counter() + WARMUP_SECONDS
        while time.perf_counter() < end:
            t.add_(1)
        torch.cuda.synchronize()


def _mv_flops(a_shape, x_shape, *args, **kwargs):
    return 2 * a_shape[0] * a_shape[1]


def _addmv_flops(y_shape, a_shape, x_shape, *args, **kwargs):
    return 2 * a_shape[0] * a_shape[1]


def _dot_flops(a_shape, b_shape, *args, **kwargs):
    return 2 * a_shape[0]


def _flop_counter():
    """``FlopCounterMode`` with the products it does not count by default:
    a single problem's matvecs and inner products (``mv``, ``addmv``,
    ``dot``, ``vdot``), two operations a multiply-add as for ``mm``."""
    from torch.utils.flop_counter import FlopCounterMode

    aten = torch.ops.aten
    return FlopCounterMode(display=False, custom_mapping={
        aten.mv: _mv_flops, aten.addmv: _addmv_flops, aten.dot: _dot_flops,
        aten.vdot: _dot_flops})


def _devices(tree, out):
    if isinstance(tree, torch.Tensor):
        out.add(tree.device)
    elif isinstance(tree, dict):
        _devices(list(tree.values()), out)
    elif isinstance(tree, (tuple, list)):
        for t in tree:
            _devices(t, out)
    return out


def compiled_stats(fn, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` once and return what it cost::

        {"cost_analysis": {"flops", "bytes accessed", "transcendentals"},
         "memory_analysis": {...},
         "kernels": {name: {"launches", "flops", "bytes accessed",
                            "transcendentals"}}}

    ``cost_analysis`` sums the ATen operations that ran outside the kernel
    wrappers (flops as ``FlopCounterMode`` counts them, matvecs and inner
    products included; bytes as each
    operation's tensor arguments and results) and every kernel wrapper's
    estimate, listed by kernel in ``kernels``.  It counts the whole call,
    every iteration, where XLA counts a loop's body once.

    ``memory_analysis`` holds ``argument_size_in_bytes`` and
    ``output_size_in_bytes`` (the tensors passed in and returned) and, on
    the card (that of the first CUDA tensor argument, else the current one
    once CUDA is in use), ``peak_size_in_bytes``, the most the caching
    allocator held there during the call (``torch.cuda.max_memory_allocated``)
    less what it held before.  On the CPU there is no allocator statistic,
    and it is ``None``."""
    cards = [d for d in _devices((args, kwargs), set()) if d.type == "cuda"]
    card = cards[0] if cards else (
        torch.device("cuda", torch.cuda.current_device())
        if torch.cuda.is_available() and torch.cuda.is_initialized()
        else None)
    if card is not None:
        torch.cuda.synchronize(card)
        torch.cuda.reset_peak_memory_stats(card)
        start = torch.cuda.memory_allocated(card)
    with _flop_counter() as flop_mode, _BytesMode() as bmode:
        tally = _Tally(flop_mode, bmode)
        _tallies.append(tally)
        try:
            out = fn(*args, **kwargs)
        finally:
            _tallies.pop()
    peak = None
    if card is not None:
        torch.cuda.synchronize(card)
        peak = torch.cuda.max_memory_allocated(card) - start
    return {
        "cost_analysis": tally.totals(),
        "memory_analysis": {
            "argument_size_in_bytes": _nbytes((list(args), kwargs)),
            "output_size_in_bytes": _nbytes(out),
            "peak_size_in_bytes": peak,
        },
        "kernels": tally.kernels,
    }
