"""Nesterov extrapolation-coefficient sequences (counterpart of
``proxtpu/accel/nesterov.py``).

Each strategy is a pure transition ``next_coeff(state, gamma) -> (beta,
state)`` from ``init_state(x)``, carried in the algorithm state; the
sequences that do not depend on the stepsize ignore ``gamma``.  Every
operation is elementwise, so a sequence state may also be a (B,) tensor,
one entry per lane.
"""

from __future__ import annotations

import math

import torch

from ..prox.base import proxclass
from ..utils.tree import real_dtype_of, tree_leaves, tree_map
from .base import NESTEROV


def _scalar(x, value):
    return torch.full((), value, dtype=real_dtype_of(x),
                      device=tree_leaves(x)[0].device)


@proxclass
class FixedNesterovSequence:
    """The t-recursion t' = (1 + sqrt(1 + 4 t^2)) / 2, beta = (t-1)/t'."""

    style = NESTEROV

    def init_state(self, x):
        return _scalar(x, 1.0)

    def next_coeff(self, t, gamma=None):
        t_next = (1 + torch.sqrt(1 + 4 * t**2)) / 2
        return (t - 1) / t_next, t_next


@proxclass
class SimpleNesterovSequence:
    """beta = (k - 1) / (k + 2)."""

    style = NESTEROV

    def init_state(self, x):
        return _scalar(x, 1.0)

    def next_coeff(self, k, gamma=None):
        return (k - 1) / (k + 2), k + 1


@proxclass(meta_fields=("m", "stepsize"))
class ConstantNesterovSequence:
    """The strongly-convex constant beta for modulus ``m`` and a fixed
    ``stepsize``."""

    m: float
    stepsize: float

    style = NESTEROV

    def init_state(self, x):
        return _scalar(x, 0.0)

    def next_coeff(self, state, gamma=None):
        k_inv = self.m * self.stepsize
        beta = (1 - math.sqrt(k_inv)) / (1 + math.sqrt(k_inv))
        return torch.full_like(state, beta), state


@proxclass(meta_fields=("m",))
class AdaptiveNesterovSequence:
    """Stepsize-fed sequence; ``m`` is the strong-convexity modulus.  It
    reproduces the fixed sequence for m = 0 and the constant one for m > 0
    under a constant stepsize."""

    m: float = 0.0

    style = NESTEROV

    def init_state(self, x):
        return (_scalar(x, -1.0), _scalar(x, -1.0))  # (stepsize, theta)

    def next_coeff(self, state, gamma):
        stepsize, theta = state
        first = stepsize < 0
        if self.m > 0:
            theta_init = torch.sqrt(self.m * gamma)
        else:
            theta_init = torch.ones_like(theta)
        stepsize = torch.where(first, gamma, stepsize)
        theta = torch.where(first, theta_init, theta)
        b = theta**2 / stepsize - self.m
        delta = b**2 + 4 * (theta**2) / (stepsize * gamma)
        theta_new = gamma * (-b + torch.sqrt(delta)) / 2
        beta = (gamma * theta * (1 - theta)
                / (stepsize * theta_new + gamma * theta**2))
        return beta, (gamma, theta_new)


@proxclass(meta_fields=("sequence",))
class NesterovExtrapolation:
    """Direction strategy wrapping a coefficient sequence."""

    sequence: object = SimpleNesterovSequence()

    style = NESTEROV

    def init_state(self, x):
        return self.sequence.init_state(x)

    def next_coeff(self, state, gamma=None):
        return self.sequence.next_coeff(state, gamma)

    def update(self, state, s, y):
        return state

    def reset(self, state):
        return state


@proxclass(meta_fields=("sequence",))
class AdaptiveRestartSequence:
    """O'Donoghue-Candès adaptive restart (gradient scheme) around any
    sequence: when the driver's signal ``real(<x - z, z - z_prev>)`` is
    positive, the inner state goes back to its initial value before the
    coefficient is drawn.  Drivers that support it look for
    ``restart_aware``."""

    sequence: object = FixedNesterovSequence()

    style = NESTEROV
    restart_aware = True

    def init_state(self, x):
        inner = self.sequence.init_state(x)
        return (inner, inner)  # (current, initial)

    def next_coeff(self, state, gamma=None, restart=None):
        cur, init = state
        if restart is not None:
            cur = tree_map(lambda c, i: torch.where(restart > 0, i, c),
                           cur, init)
        beta, nxt = self.sequence.next_coeff(cur, gamma)
        return beta, (nxt, init)
