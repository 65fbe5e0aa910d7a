"""Linear operators (counterpart of ``proxtpu/ops/linops.py``): identity,
zero, dense, stacked dense and 2-D gradient operators, and the power
iteration for ||A||_2.  ``matvec(x)`` is A x, ``rmatvec(y)`` is A^H y,
``opnorm()`` is ||A||_2."""

from __future__ import annotations

import math

import torch

from ..prox.base import proxclass
from ..utils.precision import pdot
from ..utils.tree import tree_leaves, tree_map, tree_norm, tree_scale, \
    tree_zeros_like


@proxclass
class IdentityOperator:
    """A = I, on any iterate."""

    def matvec(self, x):
        return x

    def rmatvec(self, y):
        return y

    def opnorm(self):
        return 1.0


@proxclass
class ZeroOperator:
    """A = 0 (AFBA's default ``L`` when h is ``Zero``)."""

    def matvec(self, x):
        return tree_zeros_like(x)

    def rmatvec(self, y):
        return tree_zeros_like(y)

    def opnorm(self):
        return 0.0


@proxclass
class MatrixOperator:
    """A dense matrix."""

    A: object

    def matvec(self, x):
        return pdot(self.A, x)

    def rmatvec(self, y):
        return pdot(self.A.mH, y)

    def opnorm(self):
        return torch.linalg.matrix_norm(self.A, 2)


@proxclass
class VStackOperator:
    """A = vcat(ops...): x -> concat([op x for op in ops]), for dense
    blocks (the L = [A; I] of a linear program by Chambolle-Pock)."""

    ops: tuple

    def matvec(self, x):
        return torch.cat([op.matvec(x) for op in self.ops])

    def rmatvec(self, y):
        out, start = None, 0
        for op in self.ops:
            if not hasattr(op, "A"):
                raise ValueError("VStackOperator.rmatvec requires sized "
                                 "blocks")
            m = op.A.shape[0]
            part = op.rmatvec(y[start:start + m])
            out = part if out is None else out + part
            start += m
        return out

    def opnorm(self):
        return torch.linalg.matrix_norm(
            torch.cat([op.A for op in self.ops]), 2)


@proxclass(meta_fields=("shape",))
class Grad2DOperator:
    """Discrete 2-D gradient (forward differences, Neumann boundary).

    Maps an (H, W) image to a (2, H, W) field of (dx, dy) differences; the
    ``L`` of TV denoising by Chambolle-Pock.  ||L||^2 <= 8.  ``shape`` is
    fixed, not data."""

    shape: tuple

    def matvec(self, x):
        dx = torch.diff(x, dim=0, append=x[-1:, :])
        dy = torch.diff(x, dim=1, append=x[:, -1:])
        return torch.stack([dx, dy])

    def rmatvec(self, y):
        # negative divergence: the last row of dx and the last column of dy
        # count as 0, and the backward difference takes 0 before the first
        dx, dy = y[0], y[1]
        dx = torch.cat([dx[:-1, :], torch.zeros_like(dx[-1:, :])], dim=0)
        dy = torch.cat([dy[:, :-1], torch.zeros_like(dy[:, -1:])], dim=1)
        div_x = torch.diff(dx, dim=0, prepend=torch.zeros_like(dx[:1, :]))
        div_y = torch.diff(dy, dim=1, prepend=torch.zeros_like(dy[:, :1]))
        return -(div_x + div_y)

    def opnorm(self):
        return math.sqrt(8.0)


def as_linop(A):
    """``None``, a tensor or an operator as an operator.  A
    :class:`~proxtpu_torch.utils.shared.Shared` operand stays marked, so
    that a batched driver still sees it as lane-invariant."""
    from ..utils.shared import Shared

    if isinstance(A, Shared):
        return Shared(as_linop(object.__getattribute__(A, "value")))
    if A is None:
        return IdentityOperator()
    if hasattr(A, "matvec"):
        return A
    if hasattr(A, "shape"):
        return MatrixOperator(torch.as_tensor(A))
    return A


def power_iteration_opnorm(op, x_like, iters=50, generator=None):
    """Estimate ||A||_2 by power iteration on A^H A, from a normal start
    drawn by ``generator`` (a ``torch.Generator`` on the iterate's device;
    default: seeded with 0).

    Under ``torch.func.vmap`` (one estimate a lane, as the JAX package's
    ``jax.vmap`` of its fixed-key version) pass ``randomness="same"``:
    ``vmap`` refuses the draw in its default mode, and ``"same"`` gives
    every lane the start, and so the estimate, of its own unvmapped call
    (to rounding: the batched products sum in another order)."""
    dev = tree_leaves(x_like)[0].device
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    v = tree_map(
        lambda l: torch.randn(l.shape, dtype=l.real.dtype, device=dev,
                              generator=generator).to(l.dtype), x_like)
    for _ in range(iters):
        w = op.rmatvec(op.matvec(v))
        nrm = tree_norm(w)
        v = tree_scale(1 / torch.where(nrm == 0, torch.ones_like(nrm), nrm),
                       w)
    return tree_norm(op.matvec(v)) / torch.clamp(tree_norm(v), min=1e-30)
