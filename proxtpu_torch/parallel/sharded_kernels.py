"""Multi-device kernel paths: the fused batched solvers on each rank's own
lanes (counterpart of ``proxtpu/parallel/sharded_kernels.py``).

The JAX package puts the whole solver body (loop, kernel calls,
convergence bookkeeping) inside ``jax.shard_map``.  The port runs one
process per device, so a wrapper here takes the rank's block of the lanes
(a ``Shard(0)`` DTensor's local tensor, or this rank's slice of a full
tensor), runs the unsharded solver on it, and returns ``(z, iters, done)``
as ``Shard(0)`` DTensors over the mesh axis.  Every rank iterates on its
own lanes and stops when *they* are done: no collective runs inside a
solve, and per-lane iterates, counts and flags are those of the unsharded
solver on the same lanes.  The kernels launch on the device of the
operands (rank r's ``cuda:r`` on a machine with a card per rank).

The scaling contract is BASELINE.json's >= 80% weak-scaling efficiency; it
needs a machine with more than one card.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import torch

from .distributed import world_mesh
from .sharded_ops import _dtensor_module, _placements, axis_size, block, \
    place_lanes


def default_dp_mesh(n_devices=None, axis="dp", device_type="cuda"):
    """A 1-axis mesh over every rank of the default process group.
    ``n_devices``, where given, must be the world size: the JAX package
    takes the first n devices, but a port mesh over fewer ranks than the
    world would need every rank to agree on the ones left out."""
    import torch.distributed as dist

    world = dist.get_world_size() if dist.is_initialized() else None
    if n_devices is not None and world is not None and n_devices != world:
        raise ValueError(
            f"default_dp_mesh({n_devices}): the port's meshes span every "
            f"rank, and the world has {world}")
    return world_mesh((n_devices or world or 1,), (axis,), device_type)


def _check_batch(n, mesh, axis):
    nd = axis_size(mesh, axis)
    if n % nd:
        raise ValueError(f"batch {n} not divisible by mesh axis {axis}={nd}")
    return nd


def _lanes(x, mesh, axis):
    """This rank's lanes of ``x``: a DTensor sharded on its batch dim over
    ``axis`` gives its local block, a full tensor its slice."""
    mod = _dtensor_module()
    if mod is not None and isinstance(x, mod.DTensor):
        if tuple(x.placements) != tuple(_placements(mesh, (axis,))):
            raise ValueError(
                f"lanes must be sharded on dim 0 over mesh axis {axis!r}, "
                f"got {x.placements}")
        return x.to_local()
    return block(torch.as_tensor(x), mesh, axis)


def _whole(x):
    """A replicated operand as a plain tensor (a ``Replicate`` DTensor's
    local tensor); a number stays a number."""
    mod = _dtensor_module()
    if mod is not None and isinstance(x, mod.DTensor):
        if not all(p.is_replicate() for p in x.placements):
            raise ValueError(f"operand must be replicated, got "
                             f"{x.placements}")
        return x.to_local()
    return x


def _shape(v):
    return tuple(v.shape) if isinstance(v, torch.Tensor) else np.shape(v)


def _run(solve, lanes, whole, mesh, axis):
    """``solve(*whole, *local lanes)`` on this rank, its outputs placed
    ``Shard(0)`` over ``axis``."""
    local = [None if v is None else _lanes(v, mesh, axis) for v in lanes]
    out = solve(*(_whole(v) for v in whole), *local)
    return place_lanes(out, mesh, _placements(mesh, (axis,)))


def _per_lane(v, B, like):
    """A scalar or (B,) value as a (B,) tensor of ``like``'s dtype; lanes
    already placed stay as they are."""
    mod = _dtensor_module()
    if mod is not None and isinstance(v, mod.DTensor) and not all(
            p.is_replicate() for p in v.placements):
        return v
    return torch.as_tensor(_whole(v), dtype=like.dtype,
                           device=like.device).expand(B).contiguous()


def _lasso(solver, A, b, lam, Lf, x0, mesh, axis, **kw):
    _check_batch(A.shape[0], mesh, axis)
    B = A.shape[0]
    lam, Lf = (_per_lane(v, B, b) for v in (lam, Lf))

    def solve(A_, b_, l_, L_, x_):
        return solver(A_, b_, l_, L_, x0=x_, **kw)

    return _run(solve, (A, b, lam, Lf, x0), (), mesh, axis)


def sharded_solve_lasso_batch(
    A, b, lam, Lf, tol, *, mesh, axis="dp", maxit=1000, use_kernel=True,
    restart=False, x0=None,
):
    """:func:`proxtpu_torch.kernels.lasso.solve_lasso_batch` data-parallel
    over ``axis``: A (B, M, N), b (B, M), lam / Lf scalars or (B,), full or
    placed on the batch dim; each rank solves its own lanes with the
    one-step kernels.  B must be divisible by the mesh axis size.  Returns
    ``(z, iters, done)`` as ``Shard(0)`` DTensors."""
    from ..kernels.lasso import solve_lasso_batch

    return _lasso(solve_lasso_batch, A, b, lam, Lf, x0, mesh, axis,
                  tol=tol, maxit=maxit, use_kernel=use_kernel,
                  restart=restart)


def sharded_solve_lasso_batch_packed(
    A, b, lam, Lf, tol, *, mesh, axis="dp", maxit=1000, restart=False,
    x0=None, pack=None, mf=None,
):
    """:func:`proxtpu_torch.kernels.lasso.solve_lasso_batch_packed`
    data-parallel over ``axis``: each rank solves its own lanes.  An
    explicit ``pack`` must divide the per-rank batch."""
    from ..kernels.lasso import solve_lasso_batch_packed

    nd = _check_batch(A.shape[0], mesh, axis)
    if pack is not None and pack > 1 and (A.shape[0] // nd) % pack:
        raise ValueError(
            f"explicit pack={pack} does not divide the per-device batch "
            f"{A.shape[0] // nd} (= {A.shape[0]} / {axis}={nd}); use "
            f"pack=None for automatic selection with natural-layout "
            f"fallback"
        )
    return _lasso(solve_lasso_batch_packed, A, b, lam, Lf, x0, mesh, axis,
                  tol=tol, maxit=maxit, restart=restart, pack=pack, mf=mf)


def sharded_solve_lasso_batch_blocked(
    A, b, lam, Lf, tol, *, mesh, axis="dp", maxit=2000, iter_block=8,
    restart=False, x0=None,
):
    """:func:`proxtpu_torch.kernels.lasso.solve_lasso_batch_blocked`
    (``fb_step``, then K steps a launch) data-parallel over ``axis``."""
    from ..kernels.lasso import solve_lasso_batch_blocked

    return _lasso(solve_lasso_batch_blocked, A, b, lam, Lf, x0, mesh, axis,
                  tol=tol, maxit=maxit, iter_block=iter_block,
                  restart=restart)


def sharded_solve_lasso_multirhs(
    A, Bmat, lam, Lf, tol, *, mesh, axis="dp", maxit=2000, iter_block=1,
    restart=False, x0=None,
):
    """:func:`proxtpu_torch.kernels.lasso.solve_lasso_multirhs` (one
    design matrix, two matrix products a step) with the right-hand sides
    sharded over ``axis`` and A replicated: each rank runs the products on
    its own lanes."""
    from ..kernels.lasso import solve_lasso_multirhs

    _check_batch(Bmat.shape[0], mesh, axis)
    A = _whole(A)
    B = Bmat.shape[0]
    lam_v = _per_lane(lam, B, A)
    Lf_s = torch.as_tensor(_whole(Lf), dtype=A.dtype, device=A.device)
    if Lf_s.dim() != 0:
        # shared-A formulation: one Lipschitz constant
        raise ValueError(
            f"Lf must be a scalar for the shared-A multirhs wrapper, "
            f"got shape {tuple(Lf_s.shape)}"
        )
    solve = partial(solve_lasso_multirhs, tol=tol, maxit=maxit,
                    iter_block=iter_block, restart=restart)
    return _run(lambda A_, B_, l_, x_: solve(A_, B_, l_, Lf_s, x0=x_),
                (Bmat, lam_v, x0), (A,), mesh, axis)


def sharded_solve_box_qp_batch(
    Q, q, lo, hi, Lip, tol, *, mesh, axis="dp", maxit=20_000,
    use_kernel=True, iter_block=None, x0=None,
):
    """:func:`proxtpu_torch.kernels.box_qp.solve_box_qp_batch` (or its
    K-blocked variant when ``iter_block`` is given) data-parallel over
    ``axis``.  ``lo`` and ``hi`` must be lane-uniform (scalars)."""
    from ..kernels.box_qp import solve_box_qp_batch, \
        solve_box_qp_batch_blocked

    _check_batch(Q.shape[0], mesh, axis)
    for name, v in (("lo", lo), ("hi", hi)):
        if len(_shape(v)) != 0:
            raise ValueError(
                f"{name} must be lane-uniform (scalar) in the sharded "
                f"wrapper, got shape {_shape(v)}"
            )
    lo, hi = _whole(lo), _whole(hi)
    if iter_block is not None:
        solve = partial(solve_box_qp_batch_blocked, maxit=maxit,
                        iter_block=iter_block, use_kernel=use_kernel)
    else:
        solve = partial(solve_box_qp_batch, maxit=maxit,
                        use_kernel=use_kernel)
    Lip = _per_lane(Lip, Q.shape[0], q)
    return _run(lambda Q_, q_, L_, x_: solve(Q_, q_, lo, hi, L_, tol, x0=x_),
                (Q, q, Lip, x0), (), mesh, axis)


def sharded_solve_tv_batch(
    b, lam, tol, *, mesh, axis="dp", maxit=5000, iter_block=8,
    gamma1=None, gamma2=None, use_kernel=True, formulation="roll",
    x0=None, y0=None,
):
    """:func:`proxtpu_torch.kernels.tv.solve_tv_batch` (Chambolle-Pock TV
    denoising) data-parallel over ``axis``: b (B, H, W) and a scalar or
    per-image (B,) ``lam`` on the batch dim, each rank denoising its own
    images with ``cp_k_steps``.  The stepsizes ``gamma1`` / ``gamma2`` must
    be lane-uniform (scalars)."""
    from ..kernels.tv import solve_tv_batch

    _check_batch(b.shape[0], mesh, axis)
    for name, v in (("gamma1", gamma1), ("gamma2", gamma2)):
        if v is not None and len(_shape(v)) != 0:
            raise ValueError(
                f"{name} must be lane-uniform (scalar) in the sharded "
                f"wrapper, got shape {_shape(v)}"
            )
    lam_v = _per_lane(lam, b.shape[0], b)
    solve = partial(solve_tv_batch, tol=tol, maxit=maxit,
                    iter_block=iter_block, gamma1=_whole(gamma1),
                    gamma2=_whole(gamma2), use_kernel=use_kernel,
                    formulation=formulation)
    return _run(lambda b_, l_, x_, y_: solve(b_, l_, x0=x_, y0=y_),
                (b, lam_v, x0, y0), (), mesh, axis)
