"""The port's box-QP steps and solvers against the JAX reference, on the CPU.

The same numpy problems, made from a seed as ``tests/test_kernels.py``
makes them (Q from a QR with eigenvalues uniform in [-1, 1]), go through
``proxtpu`` (its Pallas kernels in interpret mode) and through
``proxtpu_torch``, whose wrappers run their plain versions for CPU tensors.
Tolerances are the reference's: 5e-6 on a step (``test_kernels.py:130``);
counts within +-1 (+-K when blocked) and solutions within 1e-4 across
paths; the fixed-point residual within 2e-4 (``test_kernels.py:141-149``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from proxtpu.kernels import box_qp as jb
from proxtpu_torch import box_qp_from_numpy
from proxtpu_torch.kernels import box_qp as tb

TOL = 1e-4


def _qp(B, n, seed):
    rng = np.random.default_rng(seed)
    Qs, qs, Lips = [], [], []
    for _ in range(B):
        U, _ = np.linalg.qr(rng.standard_normal((n, n)))
        ev = 2 * rng.random(n) - 1
        Q = (U @ np.diag(ev) @ U.T).astype(np.float32)
        Qs.append(0.5 * (Q + Q.T))
        qs.append(rng.standard_normal(n).astype(np.float32))
        Lips.append(np.max(np.abs(ev)))
    return np.stack(Qs), np.stack(qs), np.array(Lips, np.float32)


@pytest.fixture(scope="module", params=[(6, 16, 0), (5, 13, 1)],
            ids=["6x16", "ragged5x13"])
def qp(request):
    return _qp(*request.param)


def _step_args(qp):
    Q, q, Lip = qp
    B, n = q.shape
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, n)).astype(np.float32)
    gam = (0.95 / Lip).astype(np.float32)
    lo = np.full(B, -1.0, np.float32)
    hi = np.full(B, 1.0, np.float32)
    done = (np.arange(B) % 3 == 1).astype(np.float32)
    return (Q, q, x, gam, lo, hi), done


def _t(a):
    return torch.tensor(np.asarray(a))


def test_pg_step_matches_jax(qp):
    args, done = _step_args(qp)
    z_k, r_k = jb.fused_pg_box_step(*map(jnp.asarray, args),
                                    jnp.asarray(done), interpret=True)
    z_r, r_r = jb.reference_pg_box_step(*map(jnp.asarray, args))
    z_p, r_p = tb.reference_pg_box_step(*map(_t, args))
    np.testing.assert_allclose(z_p.numpy(), np.asarray(z_r), atol=5e-6)
    np.testing.assert_allclose(r_p.numpy(), np.asarray(r_r), atol=5e-6)
    x = _t(args[2])
    before = tb.fused_pg_box_step.launches
    out, res = tb.fused_pg_box_step(*map(_t, args[:2]), x,
                                    *map(_t, args[3:]), _t(done))
    assert tb.fused_pg_box_step.launches == before and out is x
    np.testing.assert_allclose(out.numpy(), np.asarray(z_k), atol=5e-6)
    np.testing.assert_allclose(res.numpy(), np.asarray(r_k), atol=5e-6)
    frozen = done != 0
    np.testing.assert_array_equal(out.numpy()[frozen], args[2][frozen])
    assert (res.numpy()[frozen] == 0).all()


@pytest.mark.parametrize("K", [1, 8])
def test_pg_k_steps_matches_jax(qp, K):
    args, done = _step_args(qp)
    x_r, r_r = jb.fused_pg_box_k_steps(*map(jnp.asarray, args),
                                       jnp.asarray(done), K=K,
                                       interpret=True)
    plain = tb.reference_pg_box_k_steps(*map(_t, args), _t(done), K=K)
    x = _t(args[2])
    out = tb.fused_pg_box_k_steps(*map(_t, args[:2]), x, *map(_t, args[3:]),
                                  _t(done), K=K)
    assert out[0] is x
    for x_p, r_p in (plain, out):
        np.testing.assert_allclose(x_p.numpy(), np.asarray(x_r), atol=5e-6)
        np.testing.assert_allclose(r_p.numpy(), np.asarray(r_r), atol=5e-6)
    frozen = done != 0
    np.testing.assert_array_equal(out[0].numpy()[frozen], args[2][frozen])


def _fixed_point_residual(Q, q, Lip, z):
    gamma = 0.95 / Lip.astype(np.float64)[:, None]
    z = z.astype(np.float64)
    grad = np.einsum("bij,bj->bi", Q.astype(np.float64), z) + q
    return np.max(np.abs(z - np.clip(z - gamma * grad, -1, 1)), axis=1) \
        / gamma[:, 0]


@pytest.mark.parametrize("use_kernel", [True, False])
def test_solve_box_qp_batch_matches_jax(qp, use_kernel):
    Q, q, Lip = qp
    ref = jb.solve_box_qp_batch(*map(jnp.asarray, (Q, q)), -1.0, 1.0,
                                jnp.asarray(Lip), TOL, use_kernel=True,
                                interpret=True)
    port = tb.solve_box_qp_batch(_t(Q), _t(q), -1.0, 1.0, _t(Lip), TOL,
                                 use_kernel=use_kernel)
    z_p, it_p, d_p = (np.asarray(v) for v in port)
    z_r, it_r, d_r = (np.asarray(v) for v in ref)
    assert d_p.all() and d_r.all()
    assert int(np.max(np.abs(it_p.astype(np.int64) - it_r))) <= 1
    np.testing.assert_allclose(z_p, z_r, atol=1e-4)
    assert _fixed_point_residual(Q, q, Lip, z_p).max() <= 2 * TOL


def test_solve_box_qp_batch_blocked_matches_jax(qp):
    Q, q, Lip = qp
    K = 8
    ref = jb.solve_box_qp_batch_blocked(*map(jnp.asarray, (Q, q)), -1.0,
                                        1.0, jnp.asarray(Lip), TOL,
                                        iter_block=K, interpret=True)
    port = tb.solve_box_qp_batch_blocked(_t(Q), _t(q), -1.0, 1.0, _t(Lip),
                                         TOL, iter_block=K)
    z_p, it_p, d_p = (np.asarray(v) for v in port)
    z_r, it_r, d_r = (np.asarray(v) for v in ref)
    assert d_p.all() and d_r.all()
    assert int(np.max(np.abs(it_p.astype(np.int64) - it_r))) <= K
    np.testing.assert_allclose(z_p, z_r, atol=1e-4)
    assert _fixed_point_residual(Q, q, Lip, z_p).max() <= 2 * TOL
    # sampled stopping: upper-bound counts against the one-step solver
    one = tb.solve_box_qp_batch(_t(Q), _t(q), -1.0, 1.0, _t(Lip), TOL)
    assert (it_p >= one[1].numpy() - 1).all()
    plain = tb.solve_box_qp_batch_blocked(_t(Q), _t(q), -1.0, 1.0, _t(Lip),
                                          TOL, iter_block=K,
                                          use_kernel=False)
    for a, b in zip(plain, port):
        assert torch.equal(a, b)


def test_solvers_warm_start_and_maxit(qp):
    Q, q, Lip = map(_t, qp)
    z, it, done = tb.solve_box_qp_batch(Q, q, -1.0, 1.0, Lip, TOL)
    x0 = z.clone()
    for solver in (tb.solve_box_qp_batch, tb.solve_box_qp_batch_blocked):
        zw, itw, dw = solver(Q, q, -1.0, 1.0, Lip, TOL, x0=x0)
        assert bool(dw.all()) and int(itw.max()) <= 9
        assert torch.equal(x0, z)  # the caller's x0 is not written
        # a negative tol is never met (a lane clipped to the box can
        # reach a residual of exactly 0)
        zc, itc, dc = solver(Q, q, -1.0, 1.0, Lip, -1.0, maxit=11)
        assert not dc.any() and (itc == 11).all()


def test_box_qp_from_numpy_round_trip(qp):
    Q, q, Lip = qp
    B = q.shape[0]
    out = box_qp_from_numpy(jnp.asarray(Q), q.astype(np.float64), -1.0,
                            np.ones(B), Lip, device="cpu")
    want = (Q, q, np.full(B, -1.0), np.ones(B), Lip)
    for t, ref in zip(out, want):
        assert t.dtype == torch.float32 and t.is_contiguous()
        np.testing.assert_array_equal(t.numpy(), ref.astype(np.float32))
    with pytest.raises(ValueError, match="Qs"):
        box_qp_from_numpy(Q[:, :, :-1], q, -1.0, 1.0, Lip, device="cpu")
    with pytest.raises(ValueError, match="Lips"):
        box_qp_from_numpy(Q, q, -1.0, 1.0, Lip[:-1], device="cpu")
