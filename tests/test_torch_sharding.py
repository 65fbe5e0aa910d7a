"""The port's sharding layer in one process, against the JAX package.

A module-scoped Gloo process group of world size 1 on the CPU (set up here
and destroyed at the end of the module) carries the meshes.  Held against
the JAX package on the same numpy inputs: consensus ADMM without a mesh
(float64 counts equal, solutions within 1e-9), the sharded operator and
PANOC on it, the data-parallel entry points, the wrappers' ``ValueError``
messages, the entry step of ``tools/graft_entry.py``; and the port's own
rules: no-op initialization, meshes on the card unless the CPU is asked
for, ``__all__``.  Many ranks: ``tests/test_torch_multiprocess.py``.
"""

import socket

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import proxtpu as pa
import proxtpu.parallel as jpar
import proxtpu_torch as pt
import proxtpu_torch.parallel as tpar
from proxtpu.prox import NormL1 as JNormL1
from proxtpu.prox import SqrNormL2 as JSqrNormL2
from proxtpu.prox import Translate as JTranslate
from proxtpu.prox import make_least_squares as j_make_least_squares
from proxtpu_torch.parallel.sharded_ops import COLLECTIVES, all_gather, \
    all_reduce, full_tensor
from proxtpu_torch.prox import NormL1, SqrNormL2, Translate, \
    make_least_squares
from proxtpu_torch.tools import spmd_worker as w


def test_initialize_distributed_single_process_noop():
    """The all-default and ``num_processes=1`` calls create no group and
    return 1 (``tests/test_sharding.py:127-135``)."""
    had = dist.is_initialized()
    assert tpar.initialize_distributed() == 1
    assert tpar.initialize_distributed(num_processes=1) == 1
    assert dist.is_initialized() == had


def test_all_matches_jax():
    assert tpar.__all__ == jpar.__all__


def test_meshes_and_groups_need_a_card_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (lambda: tpar.make_mesh((1,), ("dp",)),
                  lambda: tpar.global_mesh((1,), ("dp",)),
                  lambda: tpar.default_dp_mesh(),
                  lambda: tpar.initialize_distributed(
                      "localhost:1", num_processes=1, process_id=0)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()
    with pytest.raises(ValueError, match="device_type"):
        tpar.make_mesh((1,), ("dp",), device_type="tpu")


def test_explicit_initialization_needs_every_argument():
    with pytest.raises(ValueError, match="process_id"):
        tpar.initialize_distributed("localhost:1", num_processes=2,
                                    device_type="cpu")


@pytest.fixture(scope="module")
def group():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    assert tpar.initialize_distributed(f"localhost:{port}", 1, 0,
                                       device_type="cpu") == 1
    assert dist.get_backend() == "gloo"
    yield
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def mesh(group):
    return tpar.make_mesh((1,), ("tp",), device_type="cpu")


def test_mesh_rules(group):
    # a port mesh spans every rank; a smaller or larger one is refused
    with pytest.raises(ValueError, match="span every rank"):
        tpar.make_mesh((2,), ("dp",), device_type="cpu")
    with pytest.raises(ValueError, match="span every rank"):
        tpar.default_dp_mesh(2, device_type="cpu")
    with pytest.raises(ValueError, match="every rank in order"):
        tpar.global_mesh((1,), ("dp",), devices=[3], device_type="cpu")
    m = tpar.global_mesh((1, 1), ("dp", "tp"), devices=[0],
                         device_type="cpu")
    assert m.mesh_dim_names == ("dp", "tp")
    assert tpar.default_dp_mesh(device_type="cpu").mesh_dim_names == ("dp",)


def test_collective_helper(mesh):
    g = mesh.get_group(0)
    before = sum(COLLECTIVES.values())
    t = torch.arange(6.0).reshape(3, 2)
    assert torch.equal(all_reduce(t, g), t)
    assert torch.equal(all_reduce(t, g, "max"), t)
    assert torch.equal(all_gather(t, g, dim=1), t)
    assert sum(COLLECTIVES.values()) == before + 3


def _consensus_problem():
    """``tests/test_sharding.py:79-96``: 8 row blocks of the 64 x 16
    lasso."""
    A, b, lam, Lf = w.big_lasso(m=64, n=16)
    return A, b, lam, Lf


def test_consensus_admm_without_mesh_matches_jax():
    A, b, lam, Lf = _consensus_problem()
    jfs = jpar.stack_functions([
        j_make_least_squares(jnp.asarray(A[i * 8:(i + 1) * 8]),
                             jnp.asarray(b[i * 8:(i + 1) * 8]))
        for i in range(8)])
    xj, itj = jpar.ConsensusADMM(tol=1e-7, maxit=20_000)(
        x0=jnp.zeros(16), fs=jfs, g=JNormL1(lam), gamma=1.0)
    tfs = tpar.stack_functions([
        make_least_squares(torch.tensor(A[i * 8:(i + 1) * 8]),
                           torch.tensor(b[i * 8:(i + 1) * 8]))
        for i in range(8)])
    xt, itt = tpar.ConsensusADMM(tol=1e-7, maxit=20_000)(
        x0=torch.zeros(16, dtype=torch.float64), fs=tfs, g=NormL1(lam),
        gamma=1.0)
    assert itt == itj
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=1e-9)
    # the JAX test's own check: the full lasso's solution
    x_ref, _ = pt.FastForwardBackward(tol=1e-10)(
        x0=torch.zeros(16, dtype=torch.float64),
        f=make_least_squares(torch.tensor(A), torch.tensor(b)),
        g=NormL1(lam), Lf=Lf)
    np.testing.assert_allclose(xt.numpy(), x_ref.numpy(), atol=1e-5)


def test_consensus_iteration_matches_jax_state():
    """Three steps of the iteration, field by field, in float64."""
    A, b, lam, _ = _consensus_problem()
    jit = jpar.make_consensus_admm_iteration(
        x0=jnp.zeros(16), g=JNormL1(lam), gamma=0.5,
        fs=jpar.stack_functions([
            j_make_least_squares(jnp.asarray(A[i * 8:(i + 1) * 8]),
                                 jnp.asarray(b[i * 8:(i + 1) * 8]))
            for i in range(8)]))
    tit = tpar.make_consensus_admm_iteration(
        x0=torch.zeros(16, dtype=torch.float64), g=NormL1(lam), gamma=0.5,
        fs=tpar.stack_functions([
            make_least_squares(torch.tensor(A[i * 8:(i + 1) * 8]),
                               torch.tensor(b[i * 8:(i + 1) * 8]))
            for i in range(8)]))
    assert tit.num_blocks == jit.num_blocks == 8
    sj, st = jit.init(), tit.init()
    for _ in range(3):
        sj, st = jit.step(sj), tit.step(st)
    for name in sj._fields:
        np.testing.assert_allclose(getattr(st, name).numpy(),
                                   np.asarray(getattr(sj, name)),
                                   atol=1e-12, err_msg=name)


@pytest.mark.parametrize("layout", ["rows", "cols", "both"])
def test_sharded_operator_world_one(group, layout):
    mesh2 = tpar.make_mesh((1, 1), ("dp", "tp"), device_type="cpu")
    A, b, lam, Lf = w.big_lasso()
    axes = {"rows": ("tp", None), "cols": (None, "tp"),
            "both": ("dp", "tp")}[layout]
    op = tpar.shard_matrix_operator(torch.tensor(A), mesh2, *axes)
    assert isinstance(op, tpar.ShardedMatrixOperator)
    x = np.random.default_rng(1).standard_normal(A.shape[1])
    y = np.random.default_rng(2).standard_normal(A.shape[0])
    np.testing.assert_allclose(op.matvec(torch.tensor(x)).numpy(), A @ x)
    np.testing.assert_allclose(op.rmatvec(torch.tensor(y)).numpy(), A.T @ y)
    # the power iteration from the same start as on the unsharded matrix
    from proxtpu_torch.ops.linops import MatrixOperator, \
        power_iteration_opnorm

    np.testing.assert_allclose(
        float(op.opnorm()), float(power_iteration_opnorm(
            MatrixOperator(torch.tensor(A)),
            torch.zeros(A.shape[1], dtype=torch.float64))), rtol=1e-12)
    np.testing.assert_allclose(float(op.opnorm()), np.sqrt(Lf), rtol=1e-5)


def test_sharded_panoc_world_one_matches_jax(mesh):
    """``tests/test_sharding.py:55-76`` at world size 1: PANOC with the
    row-sharded operator and replicated x0 and b against the JAX package's
    dense PANOC, float64 counts exact, 1e-10."""
    A, b, lam, Lf = w.big_lasso()
    xj, itj = pa.PANOC(tol=1e-6)(
        x0=jnp.zeros(A.shape[1]),
        f=JTranslate(JSqrNormL2(1.0), -jnp.asarray(b)),
        A=jnp.asarray(A), g=JNormL1(lam), Lf=Lf)
    op = tpar.shard_matrix_operator(torch.tensor(A), mesh, row_axis="tp")
    xt, itt = pt.PANOC(tol=1e-6)(
        x0=tpar.replicate(torch.zeros(A.shape[1], dtype=torch.float64),
                          mesh),
        f=Translate(SqrNormL2(1.0), tpar.replicate(-torch.tensor(b), mesh)),
        A=op, g=NormL1(lam), Lf=Lf)
    assert type(xt) is torch.Tensor
    assert itt == itj
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=1e-10)


def test_placed_lanes_world_one(mesh):
    """The dp entry points on placed lanes: outputs placed Shard(0) and
    bit-equal to the unplaced run; unplaced input takes the plain path."""
    from proxtpu_torch.algorithms import make_fast_forward_backward_iteration

    problems = [dict(x0=torch.zeros(12, dtype=torch.float64),
                     f=make_least_squares(torch.tensor(A), torch.tensor(b)),
                     g=NormL1(torch.tensor(lam)), Lf=torch.tensor(Lf))
                for A, b, lam, Lf in w.dp_problems()]
    iteration = tpar.batch_problems(make_fast_forward_backward_iteration,
                                    problems)
    plain = tpar.batched_run_loop(iteration, 2000, 1e-6)
    assert all(type(v) is torch.Tensor for v in plain)
    placed = tpar.batched_run_loop(tpar.shard_batch(iteration, mesh, "tp"),
                                   2000, 1e-6)
    for p, q in zip(placed, plain):
        assert [str(pl) for pl in p.placements] == ["S(0)"]
        assert torch.equal(full_tensor(p), q)


def test_sharded_shared_operand_is_refused(mesh):
    """One operand sharded inside data-parallel lanes with A in row stripes
    and b whole (split differently): refused by name.  The dp x tp layout
    that is taken, A and b in the same stripes: tests/test_torch_dp_tp.py."""
    from proxtpu_torch.algorithms import make_fast_forward_backward_iteration
    from proxtpu_torch.prox import LeastSquaresLoss

    A, b, _, Lf = w.shared_operand_data()
    A_rows = tpar.shard_batch(torch.tensor(A), mesh, "tp")
    it = make_fast_forward_backward_iteration(
        x0=torch.zeros((4, A.shape[1])),
        f=tpar.Shared(LeastSquaresLoss(A_rows, torch.tensor(b))),
        g=NormL1(torch.full((4,), 0.1)), Lf=torch.full((4,), Lf))
    with pytest.raises(ValueError, match="under a Shared marker"):
        tpar.batched_run_loop(it, 10, 1e-5)


def test_sharded_wrappers_match_jax_messages(group):
    """At world size 1 the wrappers' ValueErrors read as the JAX package's
    on a one-device mesh."""
    tmesh = tpar.default_dp_mesh(device_type="cpu")
    jmesh = jpar.default_dp_mesh(1)
    A, b, lam, Lf = w.lasso_batch(B=16, M=16, N=192, seed=7)
    Am, Bmat, lamm, _ = w.multirhs_data()
    Q, q, Lip = w.box_qp_data()
    bt, lamt = w.tv_data()
    calls = [
        ("sharded_solve_lasso_batch_packed", (A, b, lam, Lf, 1e-5),
         dict(maxit=10, pack=3)),
        ("sharded_solve_lasso_multirhs",
         (Am, Bmat, lamm, np.ones(16, np.float32), 1e-5), dict(maxit=10)),
        ("sharded_solve_box_qp_batch",
         (Q, q, -np.ones(16, np.float32), 1.0, Lip, 1e-4), dict(maxit=10)),
        ("sharded_solve_box_qp_batch",
         (Q, q, -1.0, np.ones(16, np.float32), Lip, 1e-4), dict(maxit=10)),
        ("sharded_solve_tv_batch", (bt, lamt, 1e-3),
         dict(maxit=10, gamma2=np.ones(8))),
    ]
    for name, args, kw in calls:
        with pytest.raises(ValueError) as je:
            getattr(jpar, name)(*(jnp.asarray(a) if isinstance(
                a, np.ndarray) else a for a in args), mesh=jmesh, **kw)
        with pytest.raises(ValueError) as te:
            getattr(tpar, name)(*(torch.tensor(a) if isinstance(
                a, np.ndarray) else a for a in args), mesh=tmesh, **kw)
        assert str(te.value) == str(je.value), name


def test_sharded_kernel_wrapper_world_one_matches_jax(group):
    """``sharded_solve_lasso_batch`` at world size 1 against the JAX
    wrapper on a one-device mesh (float32: counts within 1, 1e-4)."""
    tmesh = tpar.default_dp_mesh(device_type="cpu")
    data = w.lasso_batch()
    zj, ij, dj = jpar.sharded_solve_lasso_batch(
        *(jnp.asarray(v) for v in data), 1e-5,
        mesh=jpar.default_dp_mesh(1), maxit=3000, use_kernel=False)
    zt, it, dt = (full_tensor(v) for v in tpar.sharded_solve_lasso_batch(
        *(torch.tensor(v) for v in data), 1e-5, mesh=tmesh, maxit=3000,
        use_kernel=False))
    assert bool(dt.all()) and bool(np.asarray(dj).all())
    assert int(np.abs(it.numpy() - np.asarray(ij)).max()) <= 1
    np.testing.assert_allclose(zt.numpy(), np.asarray(zj), atol=1e-4)


def test_entry_step_matches_jax():
    """``tools/graft_entry.py::entry``: one vmapped FISTA step on the
    64-problem batch, against ``__graft_entry__.entry``'s."""
    import __graft_entry__ as jentry
    from proxtpu_torch.tools import graft_entry

    jfn, (jit, js) = jentry.entry()
    tfn, (tit, ts) = graft_entry.entry("cpu")
    sj, st = jfn(jit, js), tfn(tit, ts)
    for name in ("x", "z", "res"):
        np.testing.assert_allclose(getattr(st, name).numpy(),
                                   np.asarray(getattr(sj, name)),
                                   atol=1e-5, err_msg=name)


def test_dryrun_multichip_world_one(group):
    """``dryrun_multichip(1)`` on the CPU: every layout's parity assert."""
    from proxtpu_torch.tools import graft_entry

    graft_entry.dryrun_multichip(1, device_type="cpu")
