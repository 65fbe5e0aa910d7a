"""The dp x tp composition of the port in one process: one ``Shared``
operand in row stripes over a ``tp`` mesh axis inside lanes placed over
``dp``, on a module-scoped Gloo process group of world size 1 on the CPU
(as ``tests/test_torch_sharding.py``).

Held: the vmap-aware sum (``sharded_ops.sum_over``) against the plain sum
under ``torch.func.vmap``, nested vmap and ``in_dims=1``, one collective a
call; a (1, 1)-mesh dp x tp solve bit-equal to the unplaced one, with one
all-reduce at init and one a step, through ``batched_run_loop`` and
``BatchedAlgorithm``; the row-sharded ``MatrixOperator`` bit-equal to the
plain one; the JAX package's replicated run in float64 (equal counts,
1e-9); the layouts this slice leaves out refused by name.  Many ranks:
``tests/test_torch_multiprocess.py``.

Run as a script, the file prints how far float32 sums in another order move
the counts at ``benchmarks/scaling.py --path shared_tp``'s full width (256
lanes of 200 x 400, tol 1e-5): the port's unplaced run against its (2, 2)
stripes emulated in one process and against the JAX package's unplaced run,
on the CPU: ``PYTHONPATH=. JAX_PLATFORMS=cpu python
tests/test_torch_dp_tp.py`` (about a minute).
"""

import socket

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import proxtpu_torch as pt
import proxtpu_torch.parallel as tpar
from proxtpu_torch.ops.linops import MatrixOperator
from proxtpu_torch.parallel.sharded_ops import (
    COLLECTIVES,
    RowShardedLeastSquaresLoss,
    RowShardedMatrixOperator,
    full_tensor,
    localize,
    shard_rows,
    sum_over,
)
from proxtpu_torch.prox import (
    LeastSquaresLoss,
    NormL1,
    SqrDistance,
    make_least_squares,
)
from proxtpu_torch.tools import spmd_worker as w

TOL, MAXIT = 1e-5, 3000


def test_sum_over_needs_a_process_group(monkeypatch):
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    with pytest.raises(RuntimeError, match="no process group"):
        sum_over(torch.ones(3), None)


@pytest.fixture(scope="module")
def group():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    assert tpar.initialize_distributed(f"localhost:{port}", 1, 0,
                                       device_type="cpu") == 1
    yield dist.group.WORLD
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def mesh(group):
    return tpar.make_mesh((1, 1), ("dp", "tp"), device_type="cpu")


def _reduces(fn):
    """``(fn(), all-reduces of the collective helper inside it)``."""
    before = COLLECTIVES["all_reduce"]
    out = fn()
    return out, COLLECTIVES["all_reduce"] - before


@pytest.mark.parametrize("form", ["vmap", "nested", "in_dims=1", "plain"])
def test_sum_over_passes_through_vmap(group, form):
    x = torch.tensor(np.random.default_rng(0).standard_normal((3, 4, 5)))
    vmap = torch.func.vmap
    fn, want = {
        "vmap": (lambda: vmap(lambda t: sum_over(2 * t, group))(x), 2 * x),
        "nested": (lambda: vmap(vmap(lambda t: sum_over(t.sin(), group)))(
            x), x.sin()),
        "in_dims=1": (lambda: vmap(lambda t: sum_over(t, group),
                                   in_dims=1)(x), x.movedim(1, 0)),
        "plain": (lambda: sum_over(x, group), x),
    }[form]
    got, reduces = _reduces(fn)
    # one collective for the whole stacked batch, at every vmap depth
    assert reduces == 1
    assert torch.equal(got, want)


def _placed_iteration(mesh, dtype):
    A, b, lam, Lf = w.dp_x_tp_data(dtype)
    it = w.dp_x_tp_iteration(A, b, lam, Lf, "cpu")
    return it, tpar.shard_batch(shard_rows(it, mesh, "tp"), mesh, "dp")


@pytest.mark.parametrize("check_every", [1, 8])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_world_one_dp_x_tp_is_the_unplaced_run(mesh, dtype, check_every):
    it, placed = _placed_iteration(mesh, dtype)
    assert [str(p) for p in placed.f.value.A.placements] == ["R", "S(0)"]
    assert [str(p) for p in placed.x0.placements] == ["S(0)", "R"]
    plain = tpar.batched_run_loop(it, MAXIT, TOL, check_every=check_every)
    out, reduces = _reduces(lambda: tpar.batched_run_loop(
        placed, MAXIT, TOL, check_every=check_every))
    assert [str(p) for p in out[0].placements] == ["S(0)", "R"]
    assert all(torch.equal(full_tensor(o), p) for o, p in zip(out, plain))
    # one all-reduce at init and one a step run
    assert reduces == 1 + w.steps_run(plain[1], check_every, MAXIT)


@pytest.mark.parametrize("use_kernels", [False, "auto"])
def test_batched_algorithm_takes_the_dp_x_tp_kwargs(mesh, use_kernels):
    """The generic driver (``use_kernels=False``) at its default K = 8,
    bit-equal to ``batched_run_loop``; by default the shared-A leg
    (``solve_lasso_multirhs`` on the stripe: one all-reduce at init and
    one a step, the host's test every 16), bit-equal to its unplaced
    run."""
    from proxtpu_torch.utils.host_loop import CHECK_EVERY

    A, b, lam, Lf = w.dp_x_tp_data(np.float32)
    it, _ = _placed_iteration(mesh, np.float32)
    solver = tpar.BatchedAlgorithm(pt.make_fast_forward_backward_iteration,
                                   maxit=MAXIT, tol=TOL,
                                   use_kernels=use_kernels)
    f = tpar.Shared(LeastSquaresLoss(torch.tensor(A), torch.tensor(b)))
    lam = torch.tensor(lam)
    plain = solver(x0=it.x0, f=f, g=NormL1(lam), Lf=Lf)
    if not use_kernels:
        assert all(torch.equal(o, p) for o, p in zip(
            plain, tpar.batched_run_loop(it, MAXIT, TOL)))
    out, reduces = _reduces(lambda: solver(
        x0=tpar.shard_batch(it.x0, mesh, "dp"), f=shard_rows(f, mesh, "tp"),
        g=NormL1(tpar.shard_batch(lam, mesh, "dp")), Lf=Lf))
    assert all(torch.equal(full_tensor(o), p) for o, p in zip(out, plain))
    assert reduces == 1 + w.steps_run(
        plain[1], CHECK_EVERY if use_kernels else 8, MAXIT)


def test_world_one_dp_x_tp_matches_jax_float64(mesh):
    from proxtpu.algorithms.fast_forward_backward import (
        make_fast_forward_backward_iteration,
    )
    from proxtpu.parallel import Shared, batched_run_loop
    from proxtpu.prox import LeastSquaresLoss as JLeastSquaresLoss
    from proxtpu.prox import NormL1 as JNormL1

    A, b, lam, Lf = w.dp_x_tp_data(np.float64)
    B, N = lam.shape[0], A.shape[1]
    zj, kj, dj = (np.asarray(v) for v in batched_run_loop(
        make_fast_forward_backward_iteration(
            x0=jnp.zeros((B, N)),
            f=Shared(JLeastSquaresLoss(jnp.asarray(A), jnp.asarray(b))),
            g=JNormL1(jnp.asarray(lam)), Lf=jnp.full((B,), Lf)),
        MAXIT, TOL))
    _, placed = _placed_iteration(mesh, np.float64)
    z, k, d = (full_tensor(v).numpy()
               for v in tpar.batched_run_loop(placed, MAXIT, TOL))
    assert d.all() and dj.all()
    np.testing.assert_array_equal(k, kj)
    np.testing.assert_allclose(z, zj, atol=1e-9)


def test_row_sharded_forms(mesh):
    """At world size 1 the stripes are the whole operands: the row-sharded
    forms give the plain ones' bits, one all-reduce a product."""
    rng = np.random.default_rng(3)
    A = torch.tensor(rng.standard_normal((6, 4)))
    b, x = torch.tensor(rng.standard_normal(6)), torch.tensor(
        rng.standard_normal((5, 4)))
    y = torch.tensor(rng.standard_normal((5, 6)))
    f, lanes = localize((tpar.shard_batch(x, mesh, "dp"), shard_rows(
        tpar.Shared(LeastSquaresLoss(A, b, 0.5)), mesh, "tp")),
        stripes=True)
    assert lanes is not None
    f = f[1].value
    assert isinstance(f, RowShardedLeastSquaresLoss)
    plain = LeastSquaresLoss(A, b, 0.5)
    vmap = torch.func.vmap
    for got, want, n in (
            (_reduces(lambda: vmap(f)(x)), vmap(plain)(x), 1),
            (_reduces(lambda: vmap(f.value_and_gradient)(x)),
             vmap(plain.value_and_gradient)(x), 1)):
        assert got[1] == n
        assert all(torch.equal(g, v) for g, v in zip(
            got[0] if isinstance(got[0], tuple) else (got[0],),
            want if isinstance(want, tuple) else (want,)))
    op = localize(shard_rows(tpar.Shared(MatrixOperator(A)), mesh, "tp"),
                  stripes=True)[0]
    # a lone Shared tree: no lanes placed, the operand still localized
    op = op.value if isinstance(op, tpar.Shared) else op
    assert isinstance(op, RowShardedMatrixOperator)
    plain = MatrixOperator(A)
    assert torch.equal(vmap(op.matvec)(x), vmap(plain.matvec)(x))
    assert torch.equal(vmap(op.rmatvec)(y), vmap(plain.rmatvec)(y))
    assert torch.allclose(op.opnorm(), plain.opnorm(), rtol=1e-12)


def test_row_sharded_operator_under_the_generic_driver(mesh):
    """PANOC with ``A = Shared(MatrixOperator)`` in row stripes and a
    per-lane ``SqrDistance`` on the generic driver (``use_kernels=False``;
    by default the flat machine takes it, tests/test_torch_tp_legs.py):
    the masked search runs, bit-equal to the unplaced generic run."""
    A, b, lam, Lf = w.flat_data()
    A1 = torch.tensor(A[0])
    kw = dict(x0=torch.zeros((4, A.shape[2]), dtype=torch.float64),
              f=SqrDistance(torch.tensor(b[:4])),
              g=NormL1(torch.tensor(lam[:4])), Lf=float(Lf[0]))
    solver = tpar.BatchedAlgorithm(pt.make_panoc_iteration, maxit=400,
                                   tol=1e-6, use_kernels=False)
    plain = tpar.BatchedAlgorithm(pt.make_panoc_iteration, maxit=400,
                                  tol=1e-6, use_kernels=False)(
        A=tpar.Shared(MatrixOperator(A1)), **kw)
    placed = {k: tpar.shard_batch(v, mesh, "dp") for k, v in kw.items()}
    out, reduces = _reduces(lambda: solver(
        A=shard_rows(tpar.Shared(MatrixOperator(A1)), mesh, "tp"),
        **placed))
    assert bool(plain[2].all())
    assert all(torch.equal(full_tensor(o), p) for o, p in zip(out, plain))
    assert reduces > 0


def _refused(mesh, f, match):
    it = pt.make_fast_forward_backward_iteration(
        x0=torch.zeros((4, 32)), f=f, g=NormL1(torch.full((4,), 0.1)),
        Lf=1.0)
    with pytest.raises(ValueError, match=match):
        tpar.batched_run_loop(tpar.shard_batch(it, mesh, "dp"), 10, TOL)


def test_refused_layouts_name_class_and_placements(mesh):
    A, b, _, _ = w.dp_x_tp_data(np.float32)
    A, b = torch.tensor(A), torch.tensor(b)
    rows = lambda t, axis="tp": shard_rows(  # noqa: E731
        tpar.Shared(t), mesh, axis).value
    import torch.distributed.tensor as dt
    # another class under the Shared marker
    _refused(mesh, tpar.Shared(rows(SqrDistance(b))),
             r"SqrDistance under a Shared marker holds sharded tensors "
             r"\[\(Replicate\(\), Shard\(dim=0\)\)\]")
    # a column-sharded A
    cols = dt.DTensor.from_local(A, mesh, [dt.Replicate(), dt.Shard(1)],
                                 run_check=False)
    _refused(mesh, tpar.Shared(LeastSquaresLoss(cols, rows(b))),
             r"LeastSquaresLoss under a Shared marker: A has placements "
             r"\(Replicate\(\), Shard\(dim=1\)\)")
    # A and b split differently: b over dp, or b replicated
    _refused(mesh, tpar.Shared(LeastSquaresLoss(rows(A), rows(b, "dp"))),
             r"LeastSquaresLoss under a Shared marker: A \(Replicate\(\), "
             r"Shard\(dim=0\)\) and b \(Shard\(dim=0\), Replicate\(\)\) are "
             "split differently")
    _refused(mesh, tpar.Shared(LeastSquaresLoss(rows(A), b)),
             r"b has placements \(Replicate\(\), Replicate\(\)\)")


def test_kernel_and_flat_routes_refuse_the_stripes(mesh):
    """The routes that still refuse row stripes, each beside the same
    problem unplaced, which it takes: the stacked-A and box-QP legs of
    ``match_kernel_solver``, ``match_tv_solver``, and DRLS beside stripes
    of another operand or on a least squares without a prox.  The
    shared-A leg, the flat matchers and DRLS on a least squares with its
    prox now take the stripes (their runs: tests/test_torch_tp_legs.py,
    tests/test_torch_tp_drls.py)."""
    from proxtpu_torch.kernels import dispatch
    from proxtpu_torch.ops.linops import Grad2DOperator
    from proxtpu_torch.prox import IndBox, NormL21, Quadratic

    A, b, lam, Lf = w.dp_x_tp_data(np.float32)
    A, b = torch.tensor(A), torch.tensor(b)
    lam4 = NormL1(torch.tensor(lam[:4]))
    x0 = torch.zeros((4, A.shape[1]))
    f_rows = shard_rows(tpar.Shared(LeastSquaresLoss(A, b)), mesh, "tp")
    op_rows = shard_rows(tpar.Shared(MatrixOperator(A)), mesh, "tp")
    stripes = localize(op_rows, stripes=True)[0]
    ffb = pt.make_fast_forward_backward_iteration

    def both(match, factory, kw, **opts):
        """(unplaced match, match beside an operand in row stripes)"""
        return (match(factory, kw, tol=TOL, maxit=10, **opts),
                match(factory, {**kw, "stripes": stripes}, tol=TOL,
                      maxit=10, **opts))

    # now taken: the shared-A leg and the flat machines
    kw, _ = localize(dict(x0=x0, f=f_rows, g=lam4, Lf=Lf), stripes=True)
    assert dispatch.match_kernel_solver(ffb, kw, tol=TOL, maxit=10)
    assert dispatch.match_flat_adaptive(ffb, {**kw, "Lf": None}, tol=TOL,
                                        maxit=10)
    kw_op, _ = localize(dict(x0=x0, f=tpar.Shared(SqrDistance(b)),
                             A=op_rows, g=lam4, Lf=Lf), stripes=True)
    for factory in (pt.make_panoc_iteration, pt.make_zerofpr_iteration,
                    pt.make_panocplus_iteration):
        assert dispatch.match_flat_linesearch(factory, kw_op, tol=TOL,
                                              maxit=10)
    # the stacked-A lasso leg
    As = A.expand(4, *A.shape).contiguous()
    kw_st = dict(x0=x0, f=LeastSquaresLoss(As, b.expand(4, -1)), g=lam4,
                 Lf=torch.full((4,), Lf))
    plain, placed = both(dispatch.match_kernel_solver, ffb, kw_st)
    assert plain is not None and placed is None
    # the box-QP leg
    kw_qp = dict(x0=torch.zeros((4, 8)), f=Quadratic(
        torch.eye(8).expand(4, 8, 8).contiguous(), torch.ones((4, 8))),
        g=IndBox(-1.0, 1.0), Lf=1.0)
    plain, placed = both(dispatch.match_kernel_solver,
                         pt.make_forward_backward_iteration, kw_qp)
    assert plain is not None and placed is None
    # TV
    kw_tv = dict(x0=torch.zeros((2, 6, 5)), y0=torch.zeros((2, 2, 6, 5)),
                 g=SqrDistance(torch.ones((2, 6, 5))),
                 h=NormL21(0.1, axis=0), L=Grad2DOperator((6, 5)))
    plain, placed = both(dispatch.match_tv_solver,
                         pt.make_chambolle_pock_iteration, kw_tv)
    assert plain is not None and placed is None
    # DRLS: the matcher declines stripes beside f, and a least squares in
    # stripes without a prox (batched_drls raises on it, naming its
    # row-sharded form, as it names LeastSquaresLoss unplaced); it takes
    # make_least_squares' in stripes
    kw_dr = dict(x0=x0, f=LeastSquaresLoss(As, b.expand(4, -1)), g=lam4,
                 Lf=torch.full((4,), Lf))
    plain, placed = both(dispatch.match_flat_linesearch,
                         pt.make_drls_iteration, kw_dr)
    assert plain is not None and placed is None
    kw_dr, _ = localize(dict(x0=x0, f=f_rows, g=lam4, Lf=Lf), stripes=True)
    assert dispatch.match_flat_linesearch(pt.make_drls_iteration, kw_dr,
                                          tol=TOL, maxit=10) is None
    with pytest.raises(AttributeError, match=(
            "'RowShardedLeastSquaresLoss' object has no attribute 'prox'")):
        tpar.batched_drls(f_rows, lam4, x0, torch.full((4,), 0.5),
                          torch.ones(4), torch.ones(4), TOL, maxit=10)
    kw_ls, _ = localize(dict(x0=x0, f=shard_rows(tpar.Shared(
        make_least_squares(A, b)), mesh, "tp"), g=lam4, Lf=Lf), stripes=True)
    assert dispatch.match_flat_linesearch(pt.make_drls_iteration, kw_ls,
                                          tol=TOL, maxit=10)


def main():
    from proxtpu.algorithms.fast_forward_backward import (
        make_fast_forward_backward_iteration,
    )
    from proxtpu.parallel import Shared, batched_run_loop
    from proxtpu.prox import LeastSquaresLoss as JLeastSquaresLoss
    from proxtpu.prox import NormL1 as JNormL1

    A, b, lam, Lf = w.shared_tp_data(w.SHARED_TP_LANES)
    args = (w.SHARED_TP_MAXIT, w.SHARED_TP_TOL)
    K = w.SHARED_TP_K
    runs = {
        "port": tpar.batched_run_loop(w.dp_x_tp_iteration(
            A, b, lam, Lf, "cpu"), *args, check_every=K),
        "stripes (2, 2)": w.emulated_dp_x_tp(A, b, lam, Lf, "cpu", (2, 2),
                                             *args, K),
        "JAX": batched_run_loop(make_fast_forward_backward_iteration(
            x0=jnp.zeros((len(lam), A.shape[1]), jnp.float32),
            f=Shared(JLeastSquaresLoss(jnp.asarray(A), jnp.asarray(b))),
            g=JNormL1(jnp.asarray(lam)), Lf=Lf), *args, check_every=K)}
    runs = {k: [np.asarray(v) for v in out] for k, out in runs.items()}
    z0, k0, _ = runs["port"]
    for name in ("stripes (2, 2)", "JAX"):
        z, k, d = runs[name]
        apart = np.abs(k.astype(int) - k0.astype(int))
        print(f"port unplaced against {name}: {int(d.sum())} done, "
              f"{(apart == 0).mean():.4f} of counts equal, "
              f"{(apart > 1).mean():.4f} more than 1 apart, max "
              f"{apart.max()}; max|dx| {np.abs(z - z0).max():.3e}")


if __name__ == "__main__":
    main()
