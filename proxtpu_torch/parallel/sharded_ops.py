"""Sharded operators and placed data (counterpart of
``proxtpu/parallel/sharded_ops.py``).

The JAX package places arrays with ``NamedSharding`` and lets GSPMD insert
the collectives.  The port runs one process per device: a placed tensor is
a ``torch.distributed.tensor.DTensor`` (``Shard(d)`` or ``Replicate()`` on
each mesh dim), and the collectives are written out here, in one helper
(:func:`all_reduce`, :func:`all_gather`) that counts them.  Gloo takes both
on CUDA tensors too (torch 2.11), so ranks that share one card run them
as they are.

* :class:`ShardedMatrixOperator`: ``A`` row- and/or column-sharded.
  ``matvec`` is the local product then an all-gather of the row blocks (an
  all-reduce first where the columns are sharded); ``rmatvec`` is the
  local ``A_i^H y_i`` then an all-reduce.  Both take and return plain
  vectors that every rank holds whole, so every single-problem solver runs
  on the operator unchanged.
* :func:`shard_batch`, :func:`replicate`: place data with
  ``DTensor.from_local`` from the full tensor that every rank holds (no
  scatter, no communication).
* :func:`lane_parallel`: the one place where placed lanes meet the
  batched drivers.  Compute never runs DTensor operations: a decorated
  entry point runs on each rank's own lanes as plain tensors (``Shard(0)``
  leaves to their local block, ``Replicate`` leaves to the local full
  tensor) and returns its per-lane outputs as DTensors placed as the lanes
  came in.  No collective runs inside the solve: each rank stops when its
  own lanes are done.
"""

from __future__ import annotations

import collections
import functools
import sys
from dataclasses import dataclass

import torch
import torch.distributed as dist

from ..utils.precision import pdot
from ..utils.tree import flatten, tree_map
from .distributed import world_mesh

# calls of the collective helper by name; a test or a smoke run sets them
# to 0 around a solve to show that none ran inside it
COLLECTIVES = collections.Counter()


def _dtensor_module():
    """``torch.distributed.tensor`` where some caller has imported it, else
    ``None``: without it no DTensor can exist, and importing it costs a
    second, so the undistributed paths never do."""
    return sys.modules.get("torch.distributed.tensor")


def _dtensor():
    import torch.distributed.tensor as dt

    return dt


# ---------------------------------------------------------------------------
# the collective helper


def all_reduce(t, group, op="sum"):
    """A copy of ``t`` reduced over ``group`` (``op`` "sum" or "max")."""
    COLLECTIVES["all_reduce"] += 1
    out = t.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op={"sum": dist.ReduceOp.SUM,
                             "max": dist.ReduceOp.MAX}[op], group=group)
    return out


def all_gather(t, group, dim=0):
    """The blocks ``t`` of every rank of ``group``, in rank order,
    concatenated along ``dim``."""
    COLLECTIVES["all_gather"] += 1
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim)


# ---------------------------------------------------------------------------
# meshes and placements


def make_mesh(axis_sizes, axis_names, device_type="cuda"):
    """A mesh of ``axis_sizes`` named ``axis_names`` over every rank of the
    default process group (the JAX package takes the first devices; a
    port mesh spans the world, see
    :func:`~proxtpu_torch.parallel.distributed.world_mesh`)."""
    return world_mesh(axis_sizes, axis_names, device_type)


def mesh_dim(mesh, axis):
    """The index of the mesh dim named ``axis``."""
    names = mesh.mesh_dim_names or ()
    if axis not in names:
        raise ValueError(f"mesh has no axis {axis!r} (axes {names})")
    return names.index(axis)


def axis_size(mesh, axis):
    return mesh.size(mesh_dim(mesh, axis))


def _axis_rank(mesh, axis):
    return mesh.get_local_rank(mesh_dim(mesh, axis))


def block(t, mesh, axis, dim=0):
    """This rank's block of the full tensor ``t`` along ``dim`` when ``dim``
    is split evenly over the mesh axis ``axis``."""
    n, size = axis_size(mesh, axis), t.shape[dim]
    if size % n:
        raise ValueError(f"dim {dim} of size {size} does not split evenly "
                         f"over mesh axis {axis}={n}")
    return t.narrow(dim, _axis_rank(mesh, axis) * (size // n), size // n)


def _placements(mesh, dims):
    """Placements for a tensor whose dim ``d`` is sharded over the mesh
    axis ``dims[d]`` (``None``: not sharded)."""
    dt = _dtensor()
    out = [dt.Replicate()] * mesh.ndim
    for d, axis in enumerate(dims):
        if axis is not None:
            out[mesh_dim(mesh, axis)] = dt.Shard(d)
    return out


def _place(t, mesh, dims):
    """``t`` (the full tensor, the same on every rank) as a DTensor sharded
    by ``dims`` (see :func:`_placements`), from this rank's block."""
    local = t
    for d, axis in enumerate(dims):
        if axis is not None:
            local = block(local, mesh, axis, d)
    return _dtensor().DTensor.from_local(
        local, mesh, _placements(mesh, dims), run_check=False)


def replicate(tree, mesh):
    """Replicate every tensor of ``tree`` (frozen dataclasses included)
    over the mesh (for x0, b, scalars)."""
    leaves, spec = flatten(tree)
    return spec.unflatten([_place(l, mesh, ()) for l in leaves])


def shard_batch(tree, mesh, axis_name, batch_dim=0):
    """Shard the batch dim of every tensor of ``tree`` (frozen dataclasses
    included: prox functions, operators, iterations) over the mesh axis
    ``axis_name``: the data-parallel layout of scenario batching.  Every
    rank passes the same full tree and keeps its block; tensors under a
    :class:`~proxtpu_torch.utils.shared.Shared` marker are lane-invariant
    and are replicated."""
    leaves, spec = flatten(tree)
    dims = [None] * (batch_dim + 1)
    dims[batch_dim] = axis_name
    return spec.unflatten([
        _place(l, mesh, () if s or l.dim() == 0 else dims)
        for l, s in zip(leaves, spec.shared)])


def full_tensor(x):
    """The whole tensor of a DTensor, gathered by the collective helper
    (the JAX package's ``process_allgather``); a plain tensor as it is."""
    mod = _dtensor_module()
    if mod is None or not isinstance(x, mod.DTensor):
        return x
    t = x.to_local()
    mesh = x.device_mesh
    # the last mesh dim splits innermost
    for i in reversed(range(mesh.ndim)):
        p = x.placements[i]
        if p.is_shard():
            t = all_gather(t, mesh.get_group(i), dim=p.dim)
        elif not p.is_replicate():
            raise ValueError(f"full_tensor: placement {p} is not supported")
    return t


# ---------------------------------------------------------------------------
# placed lanes into the batched drivers


def _is_replicated(x):
    return all(p.is_replicate() for p in x.placements)


def localize(tree, lanes=True):
    """``(tree on this rank, lanes)``: every ``Replicate`` DTensor of
    ``tree`` as its local full tensor, and with ``lanes=True`` every
    lane-sharded one (``Shard(0)`` on some mesh dims, ``Replicate`` on the
    others) as its local block.  ``lanes`` is ``(mesh, placements)`` of
    those lanes, or ``None`` where none were placed.  Lanes placed two ways
    at once, and a sharded tensor under a ``Shared`` marker (one operand
    split inside the lanes, which needs a collective in the vmapped step),
    raise ``ValueError``."""
    mod = _dtensor_module()
    if mod is None:
        return tree, None
    leaves, spec = flatten(tree)
    if not any(isinstance(l, mod.DTensor) for l in leaves):
        return tree, None
    placed = None
    out = []
    for leaf, shared in zip(leaves, spec.shared):
        if not isinstance(leaf, mod.DTensor):
            out.append(leaf)
        elif _is_replicated(leaf):
            out.append(leaf.to_local())
        elif not lanes:
            out.append(leaf)
        else:
            if shared:
                raise ValueError(
                    "a sharded tensor under a Shared marker (one operand "
                    "split inside data-parallel lanes) is not supported; "
                    "replicate the Shared operand")
            if any(p.is_shard() and p.dim != 0 or p.is_partial()
                   for p in leaf.placements):
                raise ValueError(
                    f"lanes must be sharded on their batch dim (Shard(0)), "
                    f"got {leaf.placements}")
            here = (leaf.device_mesh, tuple(leaf.placements))
            if placed is not None and here != placed:
                raise ValueError(
                    f"lanes placed two ways: {placed[1]} and {here[1]}")
            placed = here
            out.append(leaf.to_local())
    return spec.unflatten(out), placed


def place_lanes(tree, mesh, placements):
    """Every tensor of ``tree`` with a batch dim (a rank's per-lane
    outputs) as a DTensor placed by ``placements``; no communication."""
    DTensor = _dtensor().DTensor
    return tree_map(
        lambda l: DTensor.from_local(l, mesh, placements, run_check=False)
        if isinstance(l, torch.Tensor) and l.dim() > 0 else l, tree)


def lane_parallel(fn):
    """Run a batched entry point on each rank's own lanes: placed
    arguments as plain local tensors (see :func:`localize`), the per-lane
    outputs placed as the lanes came in.  Unplaced arguments take the
    entry point's own path, unchanged."""
    @functools.wraps(fn)
    def run(*args, **kwargs):
        (args, kwargs), lanes = localize((args, kwargs))
        out = fn(*args, **kwargs)
        return out if lanes is None else place_lanes(out, *lanes)

    return run


# ---------------------------------------------------------------------------
# the sharded operator


@dataclass(frozen=True)
class ShardedMatrixOperator:
    """Dense operator with ``A`` (a DTensor) sharded over mesh axes.

    ``row_axis`` shards the output dim m: ``matvec`` is the local product
    and an all-gather of the row blocks, ``rmatvec`` the local product and
    an all-reduce.  ``col_axis`` shards the input dim n (the transpose
    layout).  Both may be set for 2-D sharding of a huge A.  Vectors in
    and out are plain tensors held whole by every rank."""

    A: object
    mesh: object
    row_axis: object
    col_axis: object

    def _group(self, axis):
        return self.mesh.get_group(mesh_dim(self.mesh, axis))

    def matvec(self, x):
        if self.col_axis is not None:
            x = block(x, self.mesh, self.col_axis)
        y = pdot(self.A.to_local(), x)
        if self.col_axis is not None:
            y = all_reduce(y, self._group(self.col_axis))
        if self.row_axis is not None:
            y = all_gather(y, self._group(self.row_axis))
        return y

    def rmatvec(self, y):
        if self.row_axis is not None:
            y = block(y, self.mesh, self.row_axis)
        x = pdot(self.A.to_local().mH, y)
        if self.row_axis is not None:
            x = all_reduce(x, self._group(self.row_axis))
        if self.col_axis is not None:
            x = all_gather(x, self._group(self.col_axis))
        return x

    def opnorm(self):
        from ..ops.linops import power_iteration_opnorm

        A = self.A.to_local()
        x_like = torch.zeros((self.A.shape[1],), dtype=A.dtype,
                             device=A.device)
        return power_iteration_opnorm(self, x_like)


def shard_matrix_operator(A, mesh, row_axis=None, col_axis=None):
    """Place ``A`` (the full matrix, the same on every rank) on the mesh
    with the requested row / column sharding and wrap it.  Typical use for
    a tall A (m >> n): ``row_axis='tp'``, each rank holds a horizontal
    stripe and the step's ``A^H grad`` is a local product and one
    all-reduce."""
    A = _place(torch.as_tensor(A), mesh, (row_axis, col_axis))
    return ShardedMatrixOperator(A, mesh, row_axis, col_axis)
