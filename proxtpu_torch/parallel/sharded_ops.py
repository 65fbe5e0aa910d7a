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
* :func:`shard_batch`, :func:`replicate`, :func:`shard_rows`: place data
  with ``DTensor.from_local`` from the full tensor that every rank holds
  (no scatter, no communication).
* :func:`lane_parallel`: the one place where placed lanes meet the
  batched drivers.  Compute never runs DTensor operations: a decorated
  entry point runs on each rank's own lanes as plain tensors (``Shard(0)``
  leaves to their local block, ``Replicate`` leaves to the local full
  tensor) and returns its per-lane outputs as DTensors placed as the lanes
  came in.  No collective runs inside the solve: each rank stops when its
  own lanes are done.
* The dp x tp composition (``lane_parallel(stripes=True)``: the generic
  batched driver, ``BatchedAlgorithm`` and the flat PANOC, ZeroFPR,
  PANOCplus, DRLS and adaptive FB / FISTA machines): one ``Shared``
  operand whose tensors are row stripes over a ``tp`` mesh axis, inside
  lanes placed over ``dp``.  The operand becomes
  :class:`RowShardedLeastSquaresLoss`, :class:`RowShardedLeastSquares`
  (with a prox, from factors made once from the stripes) or
  :class:`RowShardedMatrixOperator`, which hold this rank's stripe and end
  their products in :func:`sum_over`: one all-reduce over ``tp`` for the
  whole stacked batch inside the vmapped step.  Another ``Shared``
  function in the same stripes as a row-sharded operator beside it
  (``SqrDistance(b)``) is gathered whole once, before the solve.  The
  ranks of a ``tp`` group hold the same bits after every collective, so
  they stop at the same step.  :func:`localize_multirhs` takes
  ``solve_lasso_multirhs``'s placed arrays (A in row stripes; its step
  ends in one :func:`all_reduce` over ``tp``).
"""

from __future__ import annotations

import collections
import functools
import sys

import torch
import torch.distributed as dist

from ..ops.linops import MatrixOperator
from ..prox.base import proxclass
from ..prox.functions import (
    LeastSquares,
    LeastSquaresLoss,
    _rparam,
    _vdot_real,
    make_least_squares,
)
from ..utils.precision import pdot
from ..utils.shared import Shared, map_shared, shared_values
from ..utils.tree import flatten, real_dtype_of, tree_map
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


class _SumOver(torch.autograd.Function):
    """:func:`all_reduce` as a function ``torch.func.vmap`` passes through:
    under each vmap level the batch dim moves last, so the one collective
    runs once on the whole stacked batch and returns it in the layout of
    a plain product ``A @ x`` mapped over the lanes (lanes last,
    contiguous; see :func:`lanes_last`)."""

    generate_vmap_rule = False

    @staticmethod
    def forward(t, group):
        return all_reduce(t, group)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, t, group):
        if in_dims[0] is None:
            return _SumOver.apply(t, group), None
        return _SumOver.apply(t.movedim(in_dims[0], -1), group), t.dim() - 1


class _LanesLast(torch.autograd.Function):
    """A contiguous copy; under ``torch.func.vmap``, with the batch dim
    moved last first."""

    generate_vmap_rule = False

    @staticmethod
    def forward(t):
        return t.clone(memory_format=torch.contiguous_format)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, t):
        if in_dims[0] is None:
            return _LanesLast.apply(t), None
        return _LanesLast.apply(t.movedim(in_dims[0], -1)), t.dim() - 1


def lanes_last(t):
    """``t``, laid out as a plain product ``A @ x`` mapped over lanes by
    ``torch.func.vmap`` lays out its result: lanes last, contiguous.  The
    sums of the row-sharded forms come out so (:func:`sum_over`), and a
    later reduction over their entries then runs in the plain product's
    order: on one rank the placed solve keeps the unplaced one's bits.
    The one-process emulations of the stripes apply it where the ranks
    sum."""
    return _LanesLast.apply(t)


def sum_over(t, group):
    """The sum of ``t`` over the ranks of ``group``.  Inside
    ``torch.func.vmap`` (nested too, any ``in_dims``) it is one
    :func:`all_reduce` of the whole stacked batch, outside it a plain one.
    Raises where no process group exists: there is no local fallback."""
    if not dist.is_initialized():
        raise RuntimeError(
            "sum_over: no process group; call initialize_distributed(...) "
            "before a collective")
    return _SumOver.apply(t, group)


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
        l if _is_dtensor(l) else
        _place(l, mesh, () if s or l.dim() == 0 else dims)
        for l, s in zip(leaves, spec.shared)])


def shard_rows(tree, mesh, axis_name):
    """Place every tensor under a :class:`~proxtpu_torch.utils.shared.
    Shared` marker in ``tree`` as row stripes over the mesh axis
    ``axis_name`` (``Shard(0)`` there, replicated on the other axes; a
    rank-0 tensor replicated): the tp half of the dp x tp composition.
    Tensors outside a Shared marker are left as they are, so that
    :func:`shard_batch` can place the lanes after it::

        it = shard_batch(shard_rows(iteration, mesh, "tp"), mesh, "dp")
    """
    def place(leaf, shared):
        if not shared or _is_dtensor(leaf):
            return leaf
        return _place(leaf, mesh, (axis_name,) if leaf.dim() else ())

    leaves, spec = flatten(tree)
    return spec.unflatten([place(l, s) for l, s in zip(leaves, spec.shared)])


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


def _is_dtensor(x):
    mod = _dtensor_module()
    return mod is not None and isinstance(x, mod.DTensor)


def _is_replicated(x):
    return all(p.is_replicate() for p in x.placements)


def localize(tree, lanes=True, stripes=False):
    """``(tree on this rank, lanes)``: every ``Replicate`` DTensor of
    ``tree`` as its local full tensor, and with ``lanes=True`` every
    lane-sharded one (``Shard(0)`` on some mesh dims, ``Replicate`` on the
    others) as its local block.  ``lanes`` is ``(mesh, placements)`` of
    those lanes, or ``None`` where none were placed.  Lanes placed two ways
    at once raise ``ValueError``.

    A sharded tensor under a ``Shared`` marker (one operand split inside
    the lanes) raises ``ValueError`` unless ``stripes=True``; then the
    Shared operand must be row stripes over one mesh axis (see
    :func:`_row_sharded`) and becomes its row-sharded form, whose products
    end in :func:`sum_over` over that axis, or is gathered whole beside a
    row-sharded operator."""
    mod = _dtensor_module()
    if mod is None:
        return tree, None
    leaves, spec = flatten(tree)
    if not any(isinstance(l, mod.DTensor) for l in leaves):
        return tree, None
    if lanes and stripes and any(
            s and isinstance(l, mod.DTensor) and not _is_replicated(l)
            for l, s in zip(leaves, spec.shared)):
        axes = _operator_stripes(tree)
        tree = map_shared(tree, lambda v: _row_sharded(v, axes))
        leaves, spec = flatten(tree)
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
                    f"a sharded tensor ({leaf.placements}) under a Shared "
                    "marker: one operand split inside data-parallel lanes "
                    "runs only on the entry points that take row stripes "
                    "(batched_run_loop, BatchedAlgorithm, the flat PANOC, "
                    "ZeroFPR, PANOCplus, DRLS and adaptive FB / FISTA "
                    "machines, solve_lasso_multirhs); replicate the Shared "
                    "operand here")
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


def lane_parallel(fn=None, *, stripes=False):
    """Run a batched entry point on each rank's own lanes: placed
    arguments as plain local tensors (see :func:`localize`), the per-lane
    outputs placed as the lanes came in.  Unplaced arguments take the
    entry point's own path, unchanged.  ``stripes=True`` (the generic
    driver and the flat machines) also takes a ``Shared`` operand in row
    stripes over a tp axis."""
    if fn is None:
        return functools.partial(lane_parallel, stripes=stripes)

    @functools.wraps(fn)
    def run(*args, **kwargs):
        (args, kwargs), lanes = localize((args, kwargs), stripes=stripes)
        out = fn(*args, **kwargs)
        return out if lanes is None else place_lanes(out, *lanes)

    return run


def localize_multirhs(A, Bmat, rest):
    """``solve_lasso_multirhs``'s placed arguments on this rank, as GSPMD
    takes them: ``(A, Bmat, rest, group, lanes)``.  Where A is in row
    stripes over one mesh axis (``Shard(0)`` there, ``Replicate`` on the
    others), ``A`` is this rank's stripe, ``Bmat`` its lanes' columns of
    the stripe's rows (``Bmat`` columns ``Replicate`` on A's axis are
    narrowed here, ``Shard(1)`` there are the stripe's already) and
    ``group`` the stripes' process group; otherwise ``group`` is ``None``
    and every argument is localized as :func:`localize` does.  ``rest``
    (lam, x0, ...) is localized by :func:`localize`; ``lanes`` is the
    lanes' ``(mesh, placements)``, or ``None``.  Layouts that disagree
    raise ``ValueError``."""
    axis = _stripe_axis(A)
    if axis is None:
        (A, Bmat, rest), lanes = localize((A, Bmat, rest))
        return A, Bmat, rest, None, lanes
    mesh, dim = axis
    stripe = A.to_local()
    rows = stripe.shape[0]
    offset = mesh.get_local_rank(dim) * rows
    lanes = None
    if _is_dtensor(Bmat):
        p = Bmat.placements
        if (Bmat.device_mesh != mesh
                or not (p[dim].is_replicate() or p[dim].is_shard(1))
                or any(not (q.is_replicate() or q.is_shard(0))
                       for i, q in enumerate(p) if i != dim)):
            raise ValueError(
                f"solve_lasso_multirhs: A in row stripes {tuple(A.placements)}"
                f" and Bmat {tuple(p)}: Bmat's lanes go Shard(0) on the other"
                " mesh axes, its columns Replicate or Shard(1) on A's")
        local = Bmat.to_local()
        if p[dim].is_replicate():
            local = local.narrow(1, offset, rows)
        placed = [q if i != dim else _dtensor().Replicate()
                  for i, q in enumerate(p)]
        if any(q.is_shard() for q in placed):
            lanes = (mesh, tuple(placed))
    else:
        local = Bmat.narrow(1, offset, rows)
    rest, placed = localize(rest)
    if placed is not None and placed != lanes:
        raise ValueError(
            f"solve_lasso_multirhs: lanes placed two ways: Bmat "
            f"{None if lanes is None else lanes[1]} and {placed[1]}")
    return stripe, local, rest, mesh.get_group(dim), lanes


# ---------------------------------------------------------------------------
# a Shared operand in row stripes over a tp axis


def _stripe_axis(t):
    """``(mesh, mesh dim)`` of a DTensor in row stripes (``Shard(0)`` on
    exactly one mesh dim, ``Replicate`` on the others), else ``None``."""
    if not _is_dtensor(t):
        return None
    cut = [i for i, p in enumerate(t.placements) if not p.is_replicate()]
    if len(cut) == 1 and t.placements[cut[0]].is_shard(0):
        return t.device_mesh, cut[0]
    return None


def _stripe(t, owner, name):
    """``(local stripe, mesh, mesh dim)`` of ``t``, a DTensor in row
    stripes (see :func:`_stripe_axis`); anything else raises
    ``ValueError`` naming ``owner`` and the placements."""
    axis = _stripe_axis(t)
    if axis is not None:
        return (t.to_local(),) + axis
    placements = tuple(t.placements) if _is_dtensor(t) else "not placed"
    raise ValueError(
        f"{owner} under a Shared marker: {name} has placements "
        f"{placements}; the tp layout takes row stripes, Shard(0) on one "
        "mesh axis and Replicate on the others")


def _local(v):
    return v.to_local() if _is_dtensor(v) else v


def _operator_stripes(tree):
    """The ``(mesh, mesh dim)`` of every ``Shared(MatrixOperator)`` of
    ``tree`` whose matrix is sharded, which must be in row stripes (else
    ``ValueError``, naming the placements)."""
    return {_stripe(v.A, "MatrixOperator", "A")[1:]
            for v in shared_values(tree) if isinstance(v, MatrixOperator)
            and _is_dtensor(v.A) and not _is_replicated(v.A)}


def _same_stripes(A, b, owner):
    """``(A_i, b_i, mesh, mesh dim)``: the row stripes of ``A`` and ``b``,
    which must be split alike (else ``ValueError``, naming ``owner``)."""
    A_i, mesh, dim = _stripe(A, owner, "A")
    b_i, mesh_b, dim_b = _stripe(b, owner, "b")
    if (mesh_b, dim_b) != (mesh, dim) or b_i.shape[0] != A_i.shape[0]:
        raise ValueError(
            f"{owner} under a Shared marker: A {tuple(A.placements)}"
            f" and b {tuple(b.placements)} are split differently;"
            " the tp layout takes the same row stripes of both")
    return A_i, b_i, mesh, dim


def _row_sharded(value, operator_axes=()):
    """``Shared(value)`` with a ``LeastSquares``, a ``LeastSquaresLoss``
    or a ``MatrixOperator`` in row stripes as its row-sharded form.
    Another class whose sharded tensors are row stripes on the axis of a
    row-sharded operator in the same call (``operator_axes``, see
    :func:`_operator_stripes`) is gathered whole, one counted
    :func:`all_gather` a tensor: the operator's ``matvec`` gives whole
    rows.  Anything else with a sharded tensor raises ``ValueError``."""
    leaves, spec = flatten(value)
    sharded = [tuple(l.placements) for l in leaves
               if _is_dtensor(l) and not _is_replicated(l)]
    if not sharded:
        return Shared(value)
    owner = type(value).__name__
    if isinstance(value, (LeastSquares, LeastSquaresLoss)):
        A, b, mesh, dim = _same_stripes(value.A, value.b, owner)
        lam, group = _local(value.lam), mesh.get_group(dim)
        if isinstance(value, LeastSquaresLoss):
            return Shared(RowShardedLeastSquaresLoss(A, b, lam, group))
        if _is_dtensor(value.s) and _is_replicated(value.s):
            # made by make_least_squares on the stripes: the stripes' own
            factors = (_local(value.U), _local(value.s), _local(value.Atb),
                       value.wide)
        else:
            # shard_rows cut the whole problem's factors into stripes,
            # which no rank can use: made again from the stripes of A, b
            factors = _least_squares_factors(A, b, mesh, dim)
        return Shared(RowShardedLeastSquares(A, b, lam, group, *factors))
    if isinstance(value, MatrixOperator):
        A, mesh, dim = _stripe(value.A, owner, "A")
        return Shared(RowShardedMatrixOperator(
            A, mesh.get_group(dim), mesh.get_local_rank(dim) * A.shape[0],
            value.A.shape[0]))
    axes = {_stripe_axis(l) for l in leaves
            if _is_dtensor(l) and not _is_replicated(l)}
    if None in axes or not axes <= set(operator_axes):
        raise ValueError(
            f"{owner} under a Shared marker holds sharded tensors {sharded};"
            " the tp layout covers LeastSquares, LeastSquaresLoss and "
            "MatrixOperator in row stripes, and another class only in the "
            "row stripes of a MatrixOperator beside it (gathered whole)")
    return Shared(spec.unflatten([
        all_gather(l.to_local(), l.device_mesh.get_group(_stripe_axis(l)[1]))
        if _is_dtensor(l) and not _is_replicated(l) else _local(l)
        for l in leaves]))


def holds_row_stripes(tree):
    """Whether ``tree`` holds an operand in row stripes (the dp x tp
    composition after :func:`localize`): the stacked-A and box-QP legs of
    the kernel matcher and the TV matcher decline such a problem, and the
    flat DRLS leg takes only a row-sharded least squares."""
    return any(isinstance(v, (RowShardedLeastSquaresLoss,
                              RowShardedMatrixOperator))
               for v in shared_values(tree))


def _least_squares_factors(A, b, mesh, dim):
    """``(U, s, Atb, wide)`` of :func:`~proxtpu_torch.prox.functions.
    make_least_squares` on the whole problem whose row stripes ``A``,
    ``b`` the ranks of mesh dim ``dim`` hold, each rank's ``U`` as
    :class:`RowShardedLeastSquares` keeps it.  Tall A (M >= N): the Gram
    matrix ``A^H A`` (in double precision) and ``A^H b`` summed in one
    counted :func:`all_reduce`, then ``eigh`` on every rank (the same
    bits everywhere).  Wide A: ``A A^H`` needs every stripe, so the
    stripes are gathered once (one counted :func:`all_gather`; equal
    heights) and factored as ``make_least_squares`` factors the whole,
    and a rank keeps its stripe's rows of ``U``."""
    group, parts = mesh.get_group(dim), mesh.size(dim)
    m, n = A.shape
    if m * parts < n:
        both = all_gather(torch.cat([A, b.unsqueeze(1).to(A.dtype)], 1),
                          group)
        whole = make_least_squares(both[:, :n].contiguous(),
                                   both[:, n].to(b.dtype).contiguous())
        return (whole.U.narrow(0, mesh.get_local_rank(dim) * m, m), whole.s,
                whole.Atb, True)
    Ad = A.to(torch.complex128 if A.is_complex() else torch.float64)
    Atb = pdot(A.mH, b)
    total = all_reduce(torch.cat([pdot(Ad.mH, Ad).reshape(-1),
                                  Atb.to(Ad.dtype)]), group)
    s, U = torch.linalg.eigh(total[:n * n].reshape(n, n))
    return (U.to(A.dtype), s.to(real_dtype_of(A)),
            total[n * n:].to(Atb.dtype), False)


def least_squares_on_stripes(A, b, lam=1.0):
    """:func:`~proxtpu_torch.prox.functions.make_least_squares` on DTensors
    ``A``, ``b`` in the same row stripes over one mesh axis (the JAX
    package's spelling of the tp layout): the factors are made from the
    stripes by :func:`_least_squares_factors` (nothing gathers A into
    ``eigh``) and placed as each rank holds them: ``U`` in A's stripes
    where A is wide, else whole, ``s`` and ``Atb`` whole.  Under a
    ``Shared`` marker it runs as :class:`RowShardedLeastSquares` with
    these factors: the bits of ``shard_rows(Shared(make_least_squares(A,
    b)), mesh, axis)``."""
    A_i, b_i, mesh, dim = _same_stripes(A, b, "LeastSquares")
    rows = mesh.size(dim) * A_i.shape[0]
    if rows != A.shape[0]:
        raise ValueError(
            f"LeastSquares on row stripes: A's {A.shape[0]} rows are not "
            f"split evenly over {mesh.size(dim)} ranks")
    U, s, Atb, wide = _least_squares_factors(A_i, b_i, mesh, dim)
    dt = _dtensor()
    whole = [dt.Replicate()] * mesh.ndim

    def place(t, placements):
        return dt.DTensor.from_local(t, mesh, placements, run_check=False)

    return LeastSquares(A, b, lam, place(U, A.placements if wide else whole),
                        place(s, whole), place(Atb, whole), wide)


@proxclass(meta_fields=("group",))
class RowShardedLeastSquaresLoss:
    """``f(x) = lam/2 ||A x - b||^2`` with this rank's row stripe ``A_i``,
    ``b_i``; ``x`` is whole on every rank.  ``r_i = A_i x - b_i`` is local;
    ``||r||^2`` and ``A^H r`` are sums of the stripes' parts over
    ``group``, and ``value_and_gradient`` carries both in one buffer of
    ``N + 1`` entries a lane, so a step costs one collective."""

    A: object
    b: object
    lam: object
    group: object

    is_convex = True
    is_generalized_quadratic = True

    def __call__(self, x):
        r = pdot(self.A, x) - self.b
        return _rparam(self.lam, x) / 2 * sum_over(_vdot_real(r, r),
                                                  self.group)

    def value_and_gradient(self, x):
        r = pdot(self.A, x) - self.b
        grad = pdot(self.A.mH, r)
        parts = torch.cat([grad.reshape(-1),
                           _vdot_real(r, r).to(grad.dtype).reshape(1)])
        total = sum_over(parts, self.group)
        lam = _rparam(self.lam, x)
        return (lam / 2 * torch.real(total[-1]),
                lam * total[:-1].reshape(grad.shape))


@proxclass(meta_fields=("group", "wide"))
class RowShardedLeastSquares(RowShardedLeastSquaresLoss):
    """``f(x) = lam/2 ||A x - b||^2`` with its prox (the tp form of
    :class:`~proxtpu_torch.prox.functions.LeastSquares`), from this rank's
    row stripe ``A_i``, ``b_i`` and the factors of
    :func:`_least_squares_factors`: ``U`` the eigenvectors of the smaller
    Gram matrix (whole where A is tall, this stripe's rows where it is
    wide), ``s`` its eigenvalues and ``A^H b``, both whole.  The value and
    the gradient are :class:`RowShardedLeastSquaresLoss`'s.  A prox costs
    one :func:`sum_over` for its value where A is tall (the solve is local)
    and three where A is wide: Woodbury's ``U^H A v`` (M entries a lane),
    ``A^H U w`` (N) and the value."""

    U: object
    s: object
    Atb: object
    wide: bool

    def prox(self, x, gamma):
        c = _rparam(self.lam, x) * gamma
        rhs = x + c * self.Atb
        if self.wide:
            # (I + c A^H A)^{-1} v = v - c A^H (I + c A A^H)^{-1} A v
            w = pdot(self.A, rhs)
            w = pdot(self.U, (sum_over(pdot(self.U.mH, w), self.group)
                              / (1 + c * self.s)).to(w.dtype))
            z = rhs - c * sum_over(pdot(self.A.mH, w), self.group)
        else:
            z = pdot(self.U, (pdot(self.U.mH, rhs) / (1 + c * self.s))
                     .to(rhs.dtype))
        return z, self(z)


@proxclass(meta_fields=("group", "offset", "rows"))
class RowShardedMatrixOperator:
    """A dense matrix held as this rank's row stripe ``A`` (rows
    ``offset`` to ``offset + A.shape[0]`` of ``rows``).  ``rmatvec`` takes
    the stripe's rows of ``y`` and ends in :func:`sum_over`.  ``matvec``
    returns whole rows: each stripe's product placed at its rows and
    summed over ``group`` (an all-gather by the one collective), since no
    function of this port takes row stripes of its input."""

    A: object
    group: object
    offset: int
    rows: int

    def matvec(self, x):
        y = pdot(self.A, x)
        tail = self.rows - self.offset - y.shape[0]
        return sum_over(torch.cat([
            y.new_zeros((self.offset,) + y.shape[1:]), y,
            y.new_zeros((tail,) + y.shape[1:])]), self.group)

    def rmatvec(self, y):
        return sum_over(
            pdot(self.A.mH, y.narrow(0, self.offset, self.A.shape[0])),
            self.group)

    def opnorm(self):
        gram = sum_over(pdot(self.A.mH, self.A), self.group)
        return torch.sqrt(torch.linalg.eigvalsh(gram)[-1].clamp_min(0))


# ---------------------------------------------------------------------------
# the sharded operator


@proxclass(meta_fields=("mesh", "row_axis", "col_axis"))
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
