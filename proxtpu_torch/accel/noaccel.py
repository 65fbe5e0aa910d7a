"""Null direction strategy (counterpart of ``proxtpu/accel/noaccel.py``):
the solvers fall back to the negative residual direction."""

from __future__ import annotations

from ..prox.base import proxclass
from .base import NO_ACCELERATION


@proxclass
class NoAcceleration:
    style = NO_ACCELERATION

    def init_state(self, x):
        return ()

    def apply(self, state, v):
        return v

    def update(self, state, s, y):
        return state

    def reset(self, state):
        return state
