"""Shared helpers of the kernel solvers (counterpart of
``proxtpu/kernels/common.py``)."""

from __future__ import annotations


def auto_lanes(B, bytes_per_lane, lanes=None, budget=4 * 1024 * 1024):
    """Problems per grid step of a TPU kernel, as the JAX package picks
    them: the largest of {8, 4, 2, 1} dividing B whose lanes fit ``budget``
    bytes (the TPU's VMEM), or an explicit ``lanes``, which must divide B.
    The budget is the TPU's; no kernel of this package reads the result
    (a Hopper kernel here runs one block per lane)."""
    if lanes is None:
        for cand in (8, 4, 2):
            if B % cand == 0 and cand * bytes_per_lane <= budget:
                return cand
        return 1
    if B % lanes != 0:
        raise ValueError(
            f"lanes={lanes} must divide the batch size B={B} (a truncated "
            "grid would leave the tail lanes uninitialized)")
    return lanes
