"""Full-matrix Broyden quasi-Newton updates with Powell regularisation
(counterpart of ``proxtpu/accel/broyden.py``): a dense n x n inverse
Jacobian ``H`` (initially I), updated as

    H += (s - H y) / <s, (1/theta - 1) s + H y> * (s^H H)

with the damping ``theta_bar = 0.2`` against singular updates.  Meant for
moderate n, as in the reference.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..prox.base import proxclass
from .base import QUASI_NEWTON
from .flatten import flatten_like, unflatten_like


class BroydenState(NamedTuple):
    H: torch.Tensor  # (n, n)


def _sign(x):
    """sign(x) with sign(0) = 1 (x / |x| for complex x)."""
    s = torch.sgn(x)
    return torch.where(x == 0, torch.ones_like(s), s)


def _vdot(a, b):
    return torch.sum(a.conj() * b)


@proxclass
class Broyden:
    theta_bar: float = 0.2

    style = QUASI_NEWTON

    def init_state(self, x):
        flat, _ = flatten_like(x)
        return BroydenState(H=torch.eye(flat.shape[0], dtype=flat.dtype,
                                        device=flat.device))

    def reset(self, state):
        return BroydenState(H=torch.eye(state.H.shape[0], dtype=state.H.dtype,
                                        device=state.H.device))

    def update(self, state, s, y):
        s_flat, _ = flatten_like(s)
        y_flat, _ = flatten_like(y)
        H = state.H
        Hy = H @ y_flat
        sH = s_flat.conj() @ H  # s' H (a row)
        nrm2 = torch.real(_vdot(s_flat, s_flat))
        delta = _vdot(Hy, s_flat) / torch.where(nrm2 == 0,
                                                torch.ones_like(nrm2), nrm2)
        one = torch.ones_like(delta)
        theta = torch.where(
            torch.abs(delta) >= self.theta_bar, one,
            (one - _sign(delta) * self.theta_bar) / (one - delta))
        denom = _vdot(s_flat, (one / theta - 1) * s_flat + Hy)
        return BroydenState(H=H + torch.outer((s_flat - Hy) / denom, sH))

    def apply(self, state, v):
        v_flat, spec = flatten_like(v)
        return unflatten_like(state.H @ v_flat, spec)
