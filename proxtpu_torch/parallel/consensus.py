"""Consensus splitting across devices: block parallelism for
block-separable problems (counterpart of ``proxtpu/parallel/consensus.py``).

Solves  minimize  sum_i f_i(x) + g(x)  by consensus ADMM: each of B blocks
(e.g. row blocks of a huge least squares) holds a local copy x_i advanced
by its own prox, coupled through the consensus average.

Layout: block quantities are stacked on a leading axis (B, ...).  Without
a mesh every block lives here and the per-block proxes are one vmapped
call.  With ``fs`` placed by :func:`~proxtpu_torch.parallel.shard_batch`,
each rank holds its own blocks and applies the vmapped prox to them; the
mean ``mean_i(x_i + u_i)`` is a local sum and one all-reduce, and the
primal residual a local max and one all-reduce, so every rank holds the
same consensus point and stops at the same iteration.

    x_i <- prox_{gamma f_i}(z - u_i)
    xbar <- mean_i(x_i + u_i)
    z    <- prox_{gamma/B g}(xbar)
    u_i  <- u_i + x_i - z

(scaled-dual consensus ADMM; Boyd et al. 2011, §7.1-7.2.)
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from ..algorithms.common import astree, device_of, real_dtype, rscalar
from ..algorithms.core import IterativeAlgorithm
from ..prox.base import Zero, prox, proxclass
from ..utils.tree import flatten, tree_inf_norm, tree_map, tree_sub
from .batch import _stack
from .flat_ls import _lane_map
from .sharded_ops import all_reduce, localize


class ConsensusADMMState(NamedTuple):
    x: object      # (B, ...) block-local iterates (this rank's blocks)
    z: object      # (...) consensus point
    u: object      # (B, ...) scaled duals
    res_primal: torch.Tensor
    res_dual: torch.Tensor


@proxclass(meta_fields=("num_blocks",))
class ConsensusADMMIteration:
    fs: object     # stacked block functions (leading axis: this rank's)
    g: object      # shared regularizer applied to the consensus point
    x0: object     # (...) initial consensus point
    gamma: object
    num_blocks: int  # B over every rank
    group: object = None  # the process group the blocks are spread over

    def _sum(self, v):
        return v if self.group is None else all_reduce(v, self.group)

    def _max(self, v):
        return v if self.group is None else all_reduce(v, self.group, "max")

    def init(self):
        z = self.x0
        local = flatten(self.fs)[0][0].shape[0]
        x = tree_map(lambda l: l.expand((local,) + l.shape), z)
        u = tree_map(torch.zeros_like, x)
        inf = torch.full((), torch.inf, dtype=self.gamma.dtype,
                         device=self.gamma.device)
        return self.step(ConsensusADMMState(x, z, u, inf, inf))

    def step(self, s):
        B = self.num_blocks
        gamma = self.gamma
        vprox = _lane_map(self.fs, lambda f, v: prox(f, v, gamma)[0], 1)
        arg = tree_map(lambda zl, ul: zl[None] - ul, s.z, s.u)
        x = vprox(arg)
        xbar_pu = tree_map(
            lambda xl, ul: self._sum(torch.sum(xl + ul, 0)) / B, x, s.u)
        z, _ = prox(self.g, xbar_pu, gamma / B)
        u = tree_map(lambda ul, xl, zl: ul + xl - zl[None], s.u, x, z)
        res_primal = self._max(tree_inf_norm(
            tree_map(lambda xl, zl: xl - zl[None], x, z)))
        res_dual = tree_inf_norm(tree_sub(z, s.z)) / gamma
        return ConsensusADMMState(x, z, u, res_primal, res_dual)

    def default_stopping_criterion(self, tol, s):
        return (s.res_primal <= tol) & (s.res_dual <= tol)

    def default_solution(self, s):
        return s.z

    def default_display(self, k, s):
        print(f"{k:5d} | {float(s.res_primal):.3e} | "
              f"{float(s.res_dual):.3e}")


def make_consensus_admm_iteration(*, x0, fs, g=None, gamma,
                                  num_blocks=None):
    """``fs`` is a stacked tree of B block functions (build with
    :func:`stack_functions`), or the same placed by ``shard_batch`` over
    one mesh axis: each rank then keeps its own blocks."""
    g = Zero() if g is None else g
    fs, lanes = localize(fs)
    group = None
    if lanes is not None:
        mesh, placements = lanes
        dims = [i for i, p in enumerate(placements) if p.is_shard()]
        if len(dims) != 1:
            raise ValueError("consensus blocks must be sharded over one "
                             f"mesh axis, got {placements}")
        group = mesh.get_group(dims[0])
    x0 = astree(x0)
    R = real_dtype(x0)
    if num_blocks is None:
        num_blocks = flatten(fs)[0][0].shape[0] * (
            1 if group is None else dist.get_world_size(group))
    return ConsensusADMMIteration(
        fs=fs, g=g, x0=x0, gamma=rscalar(gamma, R, device_of(x0)),
        num_blocks=int(num_blocks), group=group)


def ConsensusADMM(*, maxit=10_000, tol=1e-8, stop=None, solution=None,
                  verbose=False, freq=100, display=None, **kwargs):
    """Consensus-ADMM solver over stacked (optionally rank-sharded)
    blocks."""
    return IterativeAlgorithm(
        make_consensus_admm_iteration, maxit=maxit, tol=tol, stop=stop,
        solution=solution, verbose=verbose, freq=freq, display=display,
        **kwargs,
    )


def stack_functions(fns):
    """Stack identically structured prox functions along a new leading
    axis (their non-tensor parts must be equal)."""
    return _stack(fns, "stack_functions")
