"""Solver-state checkpointing (counterpart of
``proxtpu/utils/checkpoint.py``).

A solver's state is a tree of tensors (a named tuple for the single-problem
driver, the snapshot dict of
:func:`~proxtpu_torch.parallel.batch.batched_run_segments` for the batched
one), so it is saved with ``torch.save`` and restored with ``torch.load``.
This replaces the JAX package's pair of orbax (where installed) and a
pickle of numpy arrays: there is one format, a file.

Typical use with the driver::

    snapshot = None
    for s in states(iteration, max_states=1000):
        snapshot = s
    save_state("lasso-run.pt", snapshot)
    ...
    s = load_state("lasso-run.pt", like=iteration.init())
    x, it = solver(resume_from=s, resume_iters=1000, **problem)

The states hold named tuples and Python numbers, which ``torch.load``'s
``weights_only=True`` refuses, so the file is read with
``weights_only=False``: that unpickles, so load only files this program
wrote.
"""

from __future__ import annotations

import torch


def save_state(path, state):
    """Write a solver state (a tree of tensors, named tuples, dicts and
    Python numbers) to the file ``path``; returns ``path``."""
    torch.save(state, path)
    return path


def _device_of(tree):
    if isinstance(tree, torch.Tensor):
        return tree.device
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (tuple, list)):
        for child in tree:
            dev = _device_of(child)
            if dev is not None:
                return dev
    return None


def _restore(like, raw):
    """``raw`` in the structure of ``like``, each tensor in the dtype and
    on the device of its counterpart in ``like``."""
    if isinstance(like, torch.Tensor):
        return torch.as_tensor(raw).to(device=like.device, dtype=like.dtype)
    if isinstance(like, dict):
        return {k: _restore(v, raw[k]) for k, v in like.items()}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_restore(l, r) for l, r in zip(like, raw)))
    if isinstance(like, (tuple, list)):
        return type(like)(_restore(l, r) for l, r in zip(like, raw))
    return raw


def load_state(path, like=None):
    """Read a solver state written by :func:`save_state`.

    ``like`` (an example state, e.g. ``iteration.init()``) gives the
    structure, and each tensor's dtype and device: a state saved on the
    card loads onto the CPU and the reverse.  Without it, the tensors come
    back on the devices they were saved from (on the CPU where no card is
    present)."""
    if like is not None:
        where = _device_of(like) or torch.device("cpu")
    else:
        where = None if torch.cuda.is_available() else torch.device("cpu")
    raw = torch.load(path, map_location=where, weights_only=False)
    return raw if like is None else _restore(like, raw)
