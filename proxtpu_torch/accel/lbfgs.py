"""Limited-memory BFGS as a fixed-shape state (counterpart of
``proxtpu/accel/lbfgs.py``).

Ring buffers ``s_M`` / ``y_M`` with a leading memory axis M, the curvature
guard ``ys > 0``, the initial scaling ``H = ys / yty`` and the two-loop
recursion, unrolled over M with masking.  The ring position and fill
(``curridx``, ``currmem``) are tensors, so a push lands at a per-lane slot
under ``torch.func.vmap``: the write is a one-hot ``torch.where`` over the
memory axis, the reads index with the slot tensor.  Iterates may be trees
of tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..prox.base import proxclass
from ..utils.tree import (
    real_dtype_of,
    tree_leaves,
    tree_map,
    tree_vdot_real,
    tree_where,
)
from .base import QUASI_NEWTON


class LBFGSState(NamedTuple):
    s_M: object  # tree, leaves (M, *shape)
    y_M: object  # tree, leaves (M, *shape)
    ys_M: torch.Tensor  # (M,)
    H: torch.Tensor  # scalar initial inverse-Hessian scaling
    currmem: torch.Tensor  # int32
    curridx: torch.Tensor  # int32


def _slot(tree, idx):
    return tree_map(lambda l: l[idx], tree)


def _onehot(M, idx):
    return torch.arange(M, device=idx.device) == idx


def _set_slot(tree, hot, val):
    """Write ``val`` at the memory slot where ``hot`` (M,) is True."""
    return tree_map(
        lambda buf, v: torch.where(
            hot.reshape((-1,) + (1,) * v.dim()), v.unsqueeze(0), buf),
        tree, val)


@proxclass(meta_fields=("mem",))
class LBFGS:
    """L-BFGS direction strategy with memory ``mem`` (the reference's
    default ``LBFGS(5)``)."""

    mem: int = 5

    style = QUASI_NEWTON

    def init_state(self, x):
        M = self.mem
        R = real_dtype_of(x)
        dev = tree_leaves(x)[0].device
        def ring(l):
            return l.new_zeros((M,) + l.shape)

        return LBFGSState(
            s_M=tree_map(ring, x), y_M=tree_map(ring, x),
            ys_M=torch.zeros((M,), dtype=R, device=dev),
            H=torch.ones((), dtype=R, device=dev),
            currmem=torch.zeros((), dtype=torch.int32, device=dev),
            curridx=torch.zeros((), dtype=torch.int32, device=dev))

    def reset(self, state):
        return state._replace(currmem=torch.zeros_like(state.currmem),
                              curridx=torch.zeros_like(state.curridx),
                              H=torch.ones_like(state.H))

    def update(self, state, s, y):
        """Push (s, y) if the curvature condition ys > 0 holds."""
        M = self.mem
        ys = tree_vdot_real(s, y)
        accept = ys > 0
        curridx = torch.where(accept, (state.curridx % M) + 1, state.curridx)
        # the reference's ring position is 1-based: store at curridx - 1
        hot = _onehot(M, curridx - 1)
        currmem = torch.where(accept, torch.clamp(state.currmem + 1, max=M),
                              state.currmem)
        yty = tree_vdot_real(y, y)
        H = torch.where(
            accept, ys / torch.where(yty == 0, torch.ones_like(yty), yty),
            state.H)
        s_M = tree_where(accept, _set_slot(state.s_M, hot, s), state.s_M)
        y_M = tree_where(accept, _set_slot(state.y_M, hot, y), state.y_M)
        ys_M = torch.where(accept & hot, ys, state.ys_M)
        return LBFGSState(s_M, y_M, ys_M, H, currmem, curridx)

    def apply(self, state, v):
        """d = H v by the two-loop recursion, unrolled over the memory
        with masking."""
        M = self.mem
        d = v
        alphas = torch.zeros_like(state.ys_M)
        # loop 1: newest -> oldest
        for i in range(M):
            active = i < state.currmem
            slot = (state.curridx - 1 - i) % M
            ys = state.ys_M[slot]
            a = (tree_vdot_real(_slot(state.s_M, slot), d)
                 / torch.where(ys == 0, torch.ones_like(ys), ys))
            a = torch.where(active, a, torch.zeros_like(a))
            alphas = torch.where(_onehot(M, slot), a, alphas)
            d = tree_map(lambda dl, yl: dl - a * yl, d,
                         _slot(state.y_M, slot))
        d = tree_map(lambda dl: state.H * dl, d)
        # loop 2: oldest -> newest
        for i in range(M):
            active = i < state.currmem
            slot = (state.curridx - state.currmem + i) % M
            ys = state.ys_M[slot]
            b = (tree_vdot_real(_slot(state.y_M, slot), d)
                 / torch.where(ys == 0, torch.ones_like(ys), ys))
            coeff = torch.where(active, alphas[slot] - b, torch.zeros_like(b))
            d = tree_map(lambda dl, sl: dl + coeff * sl, d,
                         _slot(state.s_M, slot))
        return d
