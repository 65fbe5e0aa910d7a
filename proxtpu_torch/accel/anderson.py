"""Type-I Anderson acceleration with fixed-shape ring buffers (counterpart
of ``proxtpu/accel/anderson.py``):

    d = v + (S - Y) pinv(Y^H Y) Y^H v

The buffers are (n, M) matrices whose inactive columns are zero; the
pseudo-inverse annihilates them, so no shape depends on the fill.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..prox.base import proxclass
from .base import QUASI_NEWTON
from .flatten import flatten_like, unflatten_like


class AndersonState(NamedTuple):
    S: torch.Tensor  # (n, M)
    Y: torch.Tensor  # (n, M)
    currmem: torch.Tensor
    curridx: torch.Tensor


def _pinv(G):
    """``jnp.linalg.pinv``'s cutoff, 10 max(m, n) eps of the largest
    singular value; ``torch.linalg.pinv``'s default is ten times smaller,
    which keeps directions the reference drops on a near-singular Y^H Y."""
    eps = torch.finfo(G.real.dtype).eps
    return torch.linalg.pinv(G, rtol=10 * max(G.shape[-2:]) * eps)


@proxclass(meta_fields=("mem",))
class AndersonAcceleration:
    mem: int = 5

    style = QUASI_NEWTON

    def init_state(self, x):
        flat, _ = flatten_like(x)
        zeros = flat.new_zeros((flat.shape[0], self.mem))
        i0 = torch.zeros((), dtype=torch.int32, device=flat.device)
        return AndersonState(S=zeros, Y=zeros, currmem=i0, curridx=i0)

    def reset(self, state):
        i0 = torch.zeros_like(state.currmem)
        return AndersonState(torch.zeros_like(state.S),
                             torch.zeros_like(state.Y), i0, i0)

    def update(self, state, s, y):
        M = self.mem
        s_flat, _ = flatten_like(s)
        y_flat, _ = flatten_like(y)
        slot = state.curridx % M
        hot = torch.arange(M, device=slot.device) == slot
        return AndersonState(
            S=torch.where(hot, s_flat[:, None], state.S),
            Y=torch.where(hot, y_flat[:, None], state.Y),
            currmem=torch.clamp(state.currmem + 1, max=M),
            curridx=slot + 1)

    def apply(self, state, v):
        v_flat, spec = flatten_like(v)
        # column-normalise Y before the M x M pinv: the same coefficients,
        # far better conditioned in float32 (as the JAX package)
        col = torch.sqrt(torch.real(torch.sum(state.Y.conj() * state.Y,
                                              dim=0)))
        scale = torch.where(col == 0, torch.ones_like(col), col)
        Yn = state.Y / scale[None, :].to(state.Y.dtype)
        G = Yn.mH @ Yn
        rhs = Yn.mH @ v_flat
        coef = (_pinv(G) @ rhs) / scale.to(state.Y.dtype)
        d = v_flat + (state.S - state.Y) @ coef
        # a fresh operator acts as the identity
        d = torch.where(state.currmem == 0, v_flat, d)
        return unflatten_like(d, spec)
