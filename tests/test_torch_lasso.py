"""The port's lasso steps and solvers against the JAX reference, on the CPU.

The same numpy inputs, made from a seed, go through ``proxtpu`` (its Pallas
kernels in interpret mode, as ``tests/test_kernels.py`` runs them) and
through ``proxtpu_torch``, whose wrappers run their plain versions for CPU
tensors.  Tolerances are the reference's own: 5e-6 on one step
(``test_kernels.py:45-46``); counts within +-1 and solutions within 1e-4
across solver paths (``test_kernels.py:58-61``).  K fused steps are held to
1e-5: each of up to eight steps adds its own 5e-6-sized rounding difference.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from proxtpu.kernels import lasso as jl
from proxtpu_torch import problems_from_numpy
from proxtpu_torch.kernels import lasso as tl

TOL = 1e-5


def _problems(B, M, N, seed):
    rng = np.random.default_rng(seed)
    A = (rng.standard_normal((B, M, N)) / np.sqrt(M)).astype(np.float32)
    b = rng.standard_normal((B, M)).astype(np.float32)
    lam = (0.1 * np.max(np.abs(np.einsum("bmn,bm->bn", A, b)), axis=1)
           ).astype(np.float32)
    Lf = np.array([np.linalg.norm(A[i], 2) ** 2 for i in range(B)],
                  np.float32)
    return A, b, lam, Lf


def _t(a):
    return torch.tensor(np.asarray(a))


def _fb_residual(A, b, lam, Lf, x):
    """||x - prox(x - grad/Lf)||_inf * Lf per lane, in numpy (bench.py's
    residual recheck)."""
    gam = (1.0 / Lf)[:, None]
    grad = np.einsum("bmn,bm->bn", A, np.einsum("bmn,bn->bm", A, x) - b)
    y = x - gam * grad
    z = np.sign(y) * np.maximum(np.abs(y) - gam * lam[:, None], 0.0)
    return np.max(np.abs(x - z), axis=1) / gam[:, 0]


def _assert_solver_parity(port, ref, every_lane_done=True):
    """The reference's cross-path contract between two solver results."""
    z_p, it_p, d_p = (np.asarray(v) for v in port)
    z_r, it_r, d_r = (np.asarray(v) for v in ref)
    if every_lane_done:
        assert d_p.all() and d_r.all()
    np.testing.assert_array_equal(d_p, d_r)
    assert int(np.max(np.abs(it_p.astype(np.int64) - it_r))) <= 1
    np.testing.assert_allclose(z_p, z_r, atol=1e-4)


@pytest.fixture(scope="module")
def step_data():
    A, b, lam, Lf = _problems(8, 16, 24, 0)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((8, 24)).astype(np.float32)
    z_prev = rng.standard_normal((8, 24)).astype(np.float32)
    beta = rng.uniform(0.1, 0.9, 8).astype(np.float32)
    gamma = (1.0 / Lf).astype(np.float32)
    thr = (gamma * lam).astype(np.float32)
    shrink = (1.0 + gamma * 0.3).astype(np.float32)
    done = np.array([0, 1, 0, 0, 1, 0, 0, 0], np.float32)
    return dict(A=A, b=b, x=x, z_prev=z_prev, beta=beta, gamma=gamma,
                thr=thr, shrink=shrink, done=done)


@pytest.mark.parametrize("with_shrink", [False, True])
def test_fb_step_matches_jax(step_data, with_shrink):
    d = step_data
    shrink = d["shrink"] if with_shrink else None
    args = (d["A"], d["b"], d["x"], d["gamma"], d["thr"])
    z_k, r_k = jl.fused_fb_prox_grad(
        *map(jnp.asarray, args),
        shrink=None if shrink is None else jnp.asarray(shrink),
        interpret=True)
    z_x, r_x = jl.reference_fb_prox_grad(
        *map(jnp.asarray, args),
        shrink=None if shrink is None else jnp.asarray(shrink))
    before = tl.fused_fb_prox_grad.launches
    z_p, r_p = tl.fused_fb_prox_grad(
        *map(_t, args), shrink=None if shrink is None else _t(shrink))
    # a CPU tensor runs the plain version: no kernel launch is counted
    assert tl.fused_fb_prox_grad.launches == before
    for z_j, r_j in ((z_k, r_k), (z_x, r_x)):
        np.testing.assert_allclose(z_p.numpy(), np.asarray(z_j), atol=5e-6)
        np.testing.assert_allclose(r_p.numpy(), np.asarray(r_j), atol=5e-6)


def _port_full_step(d, restart, shrink=None, x=None, z_prev=None):
    x = _t(d["x"] if x is None else x)
    z_prev = _t(d["z_prev"] if z_prev is None else z_prev)
    out = tl.fused_fista_full_step(
        _t(d["A"]), _t(d["b"]), x, z_prev, _t(d["beta"]), _t(d["gamma"]),
        _t(d["thr"]), _t(d["done"]),
        shrink=None if shrink is None else _t(shrink), restart=restart)
    # updated in place and returned, like the aliased JAX kernel outputs
    assert out[0] is x and out[1] is z_prev
    return [v.numpy() for v in out]


@pytest.mark.parametrize("with_shrink", [False, True])
@pytest.mark.parametrize("restart", [False, True])
def test_full_step_matches_jax(step_data, restart, with_shrink):
    d = step_data
    shrink = d["shrink"] if with_shrink else None
    ref = jl.fused_fista_full_step(
        *(jnp.asarray(d[k]) for k in ("A", "b", "x", "z_prev", "beta",
                                      "gamma", "thr", "done")),
        shrink=None if shrink is None else jnp.asarray(shrink),
        interpret=True, restart=restart)
    port = _port_full_step(d, restart, shrink)
    for p, r in zip(port, ref):
        np.testing.assert_allclose(p, np.asarray(r), atol=5e-6)
    live = d["done"] == 0
    rs = np.asarray(ref[3])
    # the inputs exercise both sides of the restart test, and frozen lanes
    assert (rs[live] > 0).any() and (rs[live] <= 0).any()
    np.testing.assert_array_equal(port[0][~live], d["x"][~live])
    np.testing.assert_array_equal(port[1][~live], d["z_prev"][~live])
    assert (port[2][~live] == 0).all() and (port[3][~live] == 0).all()


def test_full_step_rejects_aliased_carries(step_data):
    x = _t(step_data["x"])
    with pytest.raises(ValueError, match="separate buffers"):
        tl.fused_fista_full_step(
            _t(step_data["A"]), _t(step_data["b"]), x, x,
            *(_t(step_data[k]) for k in ("beta", "gamma", "thr", "done")))


@pytest.mark.parametrize("restart", [False, True])
def test_packed_step_matches_jax(restart):
    """The JAX packed kernel (pack = 4 at N = 160), unpacked, against the
    port's full step on the natural layout."""
    B, M, N, pack = 8, 16, 160, 4
    A, b, lam, Lf = _problems(B, M, N, 3)
    rng = np.random.default_rng(4)
    d = dict(A=A, b=b,
             x=rng.standard_normal((B, N)).astype(np.float32),
             z_prev=rng.standard_normal((B, N)).astype(np.float32),
             beta=rng.uniform(0.1, 0.9, B).astype(np.float32),
             gamma=(1.0 / Lf).astype(np.float32),
             done=np.array([0, 0, 1, 0, 0, 0, 1, 0], np.float32))
    d["thr"] = (d["gamma"] * lam).astype(np.float32)
    assert jl._pack_count(N, B) == pack
    nfull = (N // 128) * 128
    Ap, bp = jl.pack_lasso_batch(jnp.asarray(A), jnp.asarray(b), pack)
    rows = lambda v: jl._pack_rows(jnp.asarray(v), pack, nfull)
    cols = lambda v: jnp.asarray(v).reshape(B // pack, pack)
    x_n, z_n, res, rs = jl.fused_fista_packed_step(
        Ap, bp, rows(d["x"]), rows(d["z_prev"]), cols(d["beta"]),
        cols(d["gamma"]), cols(d["thr"]), cols(d["done"]), N=N, pack=pack,
        interpret=True, restart=restart)
    ref = [jl._unpack_rows(x_n, pack, N), jl._unpack_rows(z_n, pack, N),
           res.reshape(B), rs.reshape(B)]
    port = _port_full_step(d, restart)
    for p, r in zip(port, ref):
        np.testing.assert_allclose(p, np.asarray(r), atol=5e-6)


@pytest.fixture(scope="module")
def small():
    return _problems(5, 16, 24, 0)


_SOLVE_CASES = {
    "textbook": {},
    "restart": {"restart": True},
    "lam2": {"lam2": 0.3},
    "restart_lam2_x0": {"restart": True, "lam2": 0.3, "x0": True},
}


@pytest.mark.parametrize("case", list(_SOLVE_CASES))
def test_solve_lasso_batch_matches_jax(small, case):
    A, b, lam, Lf = small
    kw = dict(_SOLVE_CASES[case])
    if kw.pop("x0", False):
        kw["x0"] = np.random.default_rng(2).standard_normal(
            (A.shape[0], A.shape[2])).astype(np.float32) * 0.1
    jkw = {k: (jnp.asarray(v) if k == "x0" else v) for k, v in kw.items()}
    tkw = {k: (_t(v) if k == "x0" else v) for k, v in kw.items()}
    ref = jl.solve_lasso_batch(*map(jnp.asarray, small), TOL, maxit=3000,
                               use_kernel=True, interpret=True, **jkw)
    port = tl.solve_lasso_batch(*map(_t, small), TOL, maxit=3000, **tkw)
    _assert_solver_parity(port, ref)
    # the plain route of the port holds the same contract
    plain = tl.solve_lasso_batch(*map(_t, small), TOL, maxit=3000,
                                 use_kernel=False, **tkw)
    _assert_solver_parity(plain, ref)


@pytest.fixture(scope="module")
def packed_problems():
    return _problems(8, 16, 160, 5)


@pytest.mark.parametrize("restart", [False, True])
def test_solve_lasso_batch_packed_matches_jax(packed_problems, restart):
    ref = jl.solve_lasso_batch_packed(
        *map(jnp.asarray, packed_problems), TOL, maxit=3000, interpret=True,
        restart=restart)
    port = tl.solve_lasso_batch_packed(
        *map(_t, packed_problems), TOL, maxit=3000, restart=restart, pack=4)
    _assert_solver_parity(port, ref)


def test_solve_lasso_batch_packed_keeps_x0_and_checks_pack(packed_problems):
    A, b, lam, Lf = map(_t, packed_problems)
    x0 = torch.full((8, 160), 0.01)
    kept = x0.clone()
    tl.solve_lasso_batch_packed(A, b, lam, Lf, TOL, maxit=5, x0=x0)
    assert torch.equal(x0, kept)
    for pack in (0, 3):
        with pytest.raises(ValueError, match="pack"):
            tl.solve_lasso_batch_packed(A, b, lam, Lf, TOL, pack=pack)


@pytest.fixture(scope="module")
def tail_ref(packed_problems):
    """The JAX solves the tail tests compare with, computed once: the
    packed single-phase solve, the narrow branch and the wide branch."""
    args = (*map(jnp.asarray, packed_problems), TOL)
    z0, i0, d0 = jl.solve_lasso_batch_packed(*args, maxit=3000,
                                             interpret=True, restart=True)
    k1 = int(np.median(np.asarray(i0)))
    narrow = jl.solve_lasso_batch_packed_tail(
        *args, maxit=3000, k1=k1, tail=4, restart=True, interpret=True)
    wide = jl.solve_lasso_batch_packed_tail(
        *args, maxit=3000, k1=5, tail=1, restart=True, interpret=True)
    return dict(single=(z0, i0, d0), k1=k1, narrow=narrow, wide=wide)


def _port_tail(packed_problems, **kw):
    return tl.solve_lasso_batch_packed_tail(*map(_t, packed_problems), **kw)


@pytest.mark.parametrize("branch", ["narrow", "wide"])
def test_packed_tail_matches_jax(packed_problems, tail_ref, branch):
    """Both branches converge every lane to the shared criterion and agree
    with the JAX tail solver on the same inputs (narrow: k1 past the median
    with a tail of B/2; wide: k1 so small that a tail of 1 cannot fit)."""
    kw = (dict(k1=tail_ref["k1"], tail=4) if branch == "narrow"
          else dict(k1=5, tail=1))
    n_live_after_k1 = int(np.sum(~np.asarray(tl.solve_lasso_batch_packed(
        *map(_t, packed_problems), TOL, maxit=kw["k1"], restart=True)[2])))
    assert (n_live_after_k1 <= kw["tail"]) == (branch == "narrow")
    port = _port_tail(packed_problems, tol=TOL, maxit=3000, restart=True,
                      **kw)
    _assert_solver_parity(port, tail_ref[branch])
    assert _fb_residual(*packed_problems, port[0].numpy()).max() <= 1.1 * TOL
    np.testing.assert_allclose(port[0].numpy(),
                               np.asarray(tail_ref["single"][0]), atol=1e-3)


def test_packed_tail_k1_at_least_maxit(packed_problems):
    """k1 >= maxit degrades to the single-phase solve."""
    z, it, done = _port_tail(packed_problems, tol=TOL, maxit=100, k1=100,
                             tail=4)
    single = tl.solve_lasso_batch_packed(*map(_t, packed_problems), TOL,
                                         maxit=100, restart=True)
    assert (it.numpy() <= 100).all()
    for a, b in zip((z, it, done), single):
        assert torch.equal(a, b)


def test_packed_tail_maxit_below_k1(packed_problems):
    """maxit < k1: phase 1 is capped at maxit."""
    z, it, done = _port_tail(packed_problems, tol=1e-12, maxit=7, k1=100,
                             tail=4)
    assert (it.numpy() <= 7).all() and it.numpy().max() == 7
    assert not done.any()


def test_packed_tail_rejects_zero_tail(packed_problems):
    with pytest.raises(ValueError, match="tail"):
        _port_tail(packed_problems, tol=TOL, tail=0)


def test_packed_tail_scalar_lam_and_Lf(packed_problems, tail_ref):
    A, b, lam, Lf = packed_problems
    z, it, done = tl.solve_lasso_batch_packed_tail(
        _t(A), _t(b), 0.05, float(np.max(Lf)), TOL, maxit=3000,
        k1=tail_ref["k1"], tail=4, restart=True)
    assert bool(done.all())
    lam_b = np.full(8, 0.05, np.float32)
    Lf_b = np.full(8, np.max(Lf), np.float32)
    assert _fb_residual(A, b, lam_b, Lf_b, z.numpy()).max() <= 1.1 * TOL


def test_packed_tail_plain_route_matches_kernel_route(packed_problems,
                                                      tail_ref):
    """``use_kernel=False`` (the plain route the chip smoke test
    cross-checks against) holds the contract against the wrapper route."""
    kw = dict(tol=TOL, maxit=3000, k1=tail_ref["k1"], tail=4, restart=True)
    _assert_solver_parity(_port_tail(packed_problems, use_kernel=False, **kw),
                          _port_tail(packed_problems, **kw))


@pytest.mark.parametrize("solver", [tl.solve_lasso_batch,
                                    tl.solve_lasso_batch_packed])
@pytest.mark.parametrize("kw", [{"step_mult": 1.5}])
def test_unported_options_raise(small, solver, kw):
    """Every option is ported; one that does not compose (over-relaxation
    without restart) raises the reference's ValueError."""
    with pytest.raises(ValueError, match="requires restart"):
        solver(*map(_t, small), TOL, **kw)


@pytest.mark.parametrize("K", [1, 3, 8])
@pytest.mark.parametrize("restart", [False, True])
def test_fista_k_steps_matches_jax(step_data, K, restart):
    """The plain K-step version (and its wrapper on CPU tensors) against
    the JAX kernel in interpret mode; frozen lanes come back bit-equal."""
    d = step_data
    t = np.random.default_rng(3).uniform(1, 5, 8).astype(np.float32)
    names = ("A", "b", "x", "z_prev")
    rest = ("gamma", "thr")
    ref = jl.fused_fista_k_steps(
        *(jnp.asarray(d[k]) for k in names), jnp.asarray(t),
        *(jnp.asarray(d[k]) for k in rest), jnp.asarray(d["done"]), K=K,
        interpret=True, restart=restart)
    plain = tl.reference_fista_k_steps(
        *(_t(d[k]) for k in names), _t(t), *(_t(d[k]) for k in rest),
        _t(d["done"]), K=K, restart=restart)
    x, zp, tt = _t(d["x"]), _t(d["z_prev"]), _t(t)
    before = tl.fused_fista_k_steps.launches
    out = tl.fused_fista_k_steps(_t(d["A"]), _t(d["b"]), x, zp, tt,
                                 *(_t(d[k]) for k in rest), _t(d["done"]),
                                 K=K, restart=restart)
    assert tl.fused_fista_k_steps.launches == before
    assert out[0] is x and out[1] is zp and out[2] is tt  # in place
    for port in (plain, out):
        for p, r in zip(port, ref):
            np.testing.assert_allclose(p.numpy(), np.asarray(r), atol=1e-5)
    frozen = d["done"] != 0
    for p, inp in zip(out[:3], (d["x"], d["z_prev"], t)):
        np.testing.assert_array_equal(p.numpy()[frozen], inp[frozen])
    assert (out[3].numpy()[frozen] == 0).all()


def test_fista_k_steps_rejects_aliased_carries(step_data):
    d = step_data
    x = _t(d["x"])
    with pytest.raises(ValueError, match="separate buffers"):
        tl.fused_fista_k_steps(_t(d["A"]), _t(d["b"]), x, x,
                               torch.ones(8), _t(d["gamma"]), _t(d["thr"]),
                               _t(d["done"]))


@pytest.mark.parametrize("restart", [False, True])
def test_solve_lasso_batch_blocked_matches_jax(small, restart):
    """Against the JAX blocked solver: solutions within 1e-4, counts equal
    or one block apart on at most one lane; and the reference's own
    blocked-versus-one-step contract (tests/test_kernels.py:218-236)."""
    K = 8
    ref = jl.solve_lasso_batch_blocked(*map(jnp.asarray, small), TOL,
                                       maxit=3000, iter_block=K,
                                       interpret=True, restart=restart)
    port = tl.solve_lasso_batch_blocked(*map(_t, small), TOL, maxit=3000,
                                        iter_block=K, restart=restart)
    z_p, it_p, d_p = (np.asarray(v) for v in port)
    z_r, it_r, d_r = (np.asarray(v) for v in ref)
    assert d_p.all() and d_r.all()
    np.testing.assert_allclose(z_p, z_r, atol=1e-4)
    diff = np.abs(it_p.astype(np.int64) - it_r)
    assert set(diff.tolist()) <= {0, K} and int((diff == K).sum()) <= 1
    one = tl.solve_lasso_batch(*map(_t, small), TOL, maxit=3000,
                               restart=restart)
    assert bool(one[2].all())
    np.testing.assert_allclose(z_p, one[0].numpy(), atol=5e-4)
    assert (it_p >= one[1].numpy() - 1).all()
    plain = tl.solve_lasso_batch_blocked(*map(_t, small), TOL, maxit=3000,
                                         iter_block=K, restart=restart,
                                         use_kernel=False)
    for a, b in zip(plain, port):
        assert torch.equal(a, b)


# The launch plan of the fista_k_steps kernel: pure functions of the shape.
SHARED_LIMIT = 232448  # bytes of shared memory a block may use on an H100
_PLAN_B = (1, 2, 5, 16, 17, 32, 33, 64, 66, 67, 100, 132, 133, 256, 1024)
_PLAN_M = (1, 16, 63, 64, 127, 128, 255, 256, 257, 511, 512, 515, 2048)


@pytest.mark.parametrize("sms", [108, 132, 144])
def test_cluster_plan(sms):
    """Blocks per lane: one of 1, 2, 4, 8, one wave, at least MIN_SLAB_ROWS
    rows each, and no larger size would do; the slabs cover [0, M) once and
    differ by at most a row."""
    for B in _PLAN_B:
        for M in _PLAN_M:
            C = tl.cluster_plan(B, M, sms)
            ok = lambda c: (B * c <= sms  # noqa: E731
                            and M // c >= tl.MIN_SLAB_ROWS)
            assert C in (1, 2, 4, 8)
            assert C == 1 or ok(C), (B, M, C)
            assert not any(ok(c) for c in (2, 4, 8) if c > C), (B, M, C)
            slabs = tl.slab_bounds(M, C)
            assert slabs[0][0] == 0 and slabs[-1][1] == M
            assert all(a[1] == b[0] for a, b in zip(slabs, slabs[1:]))
            rows = [hi - lo for lo, hi in slabs]
            assert min(rows) == M // C and max(rows) - min(rows) <= 1


@pytest.mark.parametrize("shape, C", [
    ((64, 512, 1024), 2),   # route (a): 128 blocks on 132 SMs
    ((256, 512, 512), 1),   # more lanes than SMs
    ((16, 512, 256), 8), ((32, 256, 512), 4),
    ((5, 16, 24), 1), ((8, 16, 160), 1), ((7, 33, 161), 1),  # small: as before
])
def test_cluster_plan_of_known_shapes(shape, C):
    B, M, N = shape
    assert tl.cluster_plan(B, M, 132) == C
    assert tl.k_steps_plan(B, M, N, 132, SHARED_LIMIT)[0] == C


@pytest.mark.parametrize("shape, plan, nbytes", [
    ((64, 512, 1024), (2, 16, 3), 214040),
    ((256, 512, 512), (1, 32, 3), 206872),
    ((5, 16, 24), (1, 16, 3), 5144),
    # no three one-row stages: tiles read in place by one block per lane,
    # in the shared memory the kernel took before it had a ring
    ((3, 40, 8400), (1, 8, 0), (2 * 8400 + 40) * 4),
    ((2, 130, 8404), (1, 8, 0), (2 * 8404 + 132) * 4),
])
def test_k_steps_plan_and_shared_bytes(shape, plan, nbytes):
    B, M, N = shape
    assert tl.k_steps_plan(B, M, N, 132, SHARED_LIMIT) == plan
    assert tl.k_steps_shared_bytes(M, N, *plan) == nbytes <= SHARED_LIMIT


def test_k_steps_shared_bytes_over_the_blocked_route():
    """Every shape the dispatch sends to the blocked route (a lane of at
    least 1 MB) whose rows the kernel took before (2 N + M floats of shared
    memory) still gets a plan that fits; the ring is used wherever three
    one-row stages fit, and its stages stay under the bulk copy's 1 MB."""
    from proxtpu_torch.kernels.dispatch import BLOCKED_LANE_BYTES

    for N in (128, 1000, 1024, 4096, 8000, 8188, 8192, 8400, 14520, 29040):
        for M in {-(-BLOCKED_LANE_BYTES // (4 * N)), 512, 4096}:
            if (M * N * 4 < BLOCKED_LANE_BYTES
                    or (2 * N + M) * 4 > SHARED_LIMIT):
                continue
            for B in (1, 16, 64, 256):
                C, R, S = tl.k_steps_plan(B, M, N, 132, SHARED_LIMIT)
                used = tl.k_steps_shared_bytes(M, N, C, R, S)
                assert used <= SHARED_LIMIT, (B, M, N, C, R, S)
                one_row_ring = tl.k_steps_shared_bytes(M, N, C, 1, 3)
                assert (S == 3) == (one_row_ring <= SHARED_LIMIT)
                assert 1 <= R and R * N * 4 < 1 << 20
                assert S == 3 or (C, S) == (1, 0)
    # the widest row: what the kernel took before, to the rounding of N
    # and M up to 4
    assert tl.k_steps_shared_bytes(19, 29040, 1, 8, 0) <= SHARED_LIMIT
    assert tl.k_steps_shared_bytes(19, 29048, 1, 8, 0) > SHARED_LIMIT


def _replay_k_steps(d, t, K, restart, C):
    """The kernel's arithmetic order in numpy float32: a lane's rows cut
    into C slabs, each slab's g summed over its rows in ascending order,
    the partial sums added in the order c = 0 .. C - 1; then the prox, the
    restart signal, the t-recursion and the extrapolation as the plain
    version does them.  Frozen lanes are left as they are."""
    f = np.float32
    A, b = d["A"], d["b"]
    x, zp, t = d["x"].copy(), d["z_prev"].copy(), t.copy()
    res = np.zeros(len(A), f)
    for i in np.flatnonzero(d["done"] == 0):
        g_, thr = d["gamma"][i], d["thr"][i]
        for _ in range(K):
            r = (A[i] @ x[i] - b[i]).astype(f)
            partial = []
            for lo, hi in tl.slab_bounds(A.shape[1], C):
                acc = np.zeros(A.shape[2], f)
                for m in range(lo, hi):
                    acc = (acc + r[m] * A[i, m]).astype(f)
                partial.append(acc)
            g = partial[0]
            for part in partial[1:]:
                g = (g + part).astype(f)
            y = (x[i] - g_ * g).astype(f)
            z = (np.sign(y) * np.maximum(np.abs(y) - thr, 0)).astype(f)
            res[i] = np.max(np.abs(x[i] - z))
            tk = t[i]
            if restart and np.sum((x[i] - z) * (z - zp[i]), dtype=f) > 0:
                tk = f(1)
            t_new = f((1 + np.sqrt(f(1 + 4 * tk * tk))) / 2)
            beta = f((tk - 1) / t_new)
            x[i], zp[i], t[i] = (z + beta * (z - zp[i])).astype(f), z, t_new
    return x, zp, t, res


@pytest.mark.parametrize("C", [1, 2, 4, 8])
@pytest.mark.parametrize("restart", [False, True])
def test_k_steps_slab_order_matches_plain_version(step_data, C, restart):
    """The kernel's order of the sums, replayed in numpy for C blocks per
    lane, against the plain version after K = 8 steps.  The two sum the
    16-term column products in different orders (slab by slab here, a
    batched matrix product there); each step carries a few ulps of O(1)
    iterates into the next, so 5e-5 absolute, the tolerance the kernel is
    held to on the card, is ample.  Frozen lanes are bit-equal."""
    d = step_data
    t = np.random.default_rng(3).uniform(1, 5, 8).astype(np.float32)
    got = _replay_k_steps(d, t, 8, restart, C)
    want = tl.reference_fista_k_steps(
        *(_t(d[k]) for k in ("A", "b", "x", "z_prev")), _t(t),
        _t(d["gamma"]), _t(d["thr"]), _t(d["done"]), K=8, restart=restart)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w.numpy(), atol=5e-5)
    frozen = d["done"] != 0
    for g, inp in zip(got[:3], (d["x"], d["z_prev"], t)):
        np.testing.assert_array_equal(g[frozen], inp[frozen])


def test_one_slab_is_the_straight_sum(step_data):
    """With one block per lane the slab order is a plain loop over the
    lane's rows: the bits of the kernel this one replaced."""
    d = step_data
    A, r = d["A"][0], d["b"][0]
    (lo, hi), = tl.slab_bounds(A.shape[0], 1)
    straight = np.zeros(A.shape[1], np.float32)
    for m in range(A.shape[0]):
        straight = (straight + r[m] * A[m]).astype(np.float32)
    slab = np.zeros(A.shape[1], np.float32)
    for m in range(lo, hi):
        slab = (slab + r[m] * A[m]).astype(np.float32)
    np.testing.assert_array_equal(slab, straight)


# The launch plan of the fb_step and fista_step kernels on an H100's shared
# memory: (threads, rows per tile, stages, shared bytes).
_STEP_PLANS = {
    (256, 200, 400): (512, 16, 3, 80920),    # main path, route (c): 2 per SM
    (64, 200, 400): (512, 29, 3, 143512),    # the main path's narrow phase
    (256, 400, 200): (512, 31, 3, 77720),    # route (d)
    (64, 512, 1024): (1024, 16, 3, 206872),  # route (a)'s first step
    (1024, 64, 128): (256, 64, 1, 34056),    # a lane that fits one stage
    (7, 33, 161): (256, 33, 1, 22920),       # ragged
    (2, 24, 12000): (256, 24, 0, 48096),     # too wide for a ring: in place
}


@pytest.mark.parametrize("sms", [108, 132, 144])
@pytest.mark.parametrize("shape", list(_STEP_PLANS))
def test_step_plan_of_known_shapes(shape, sms):
    plan = tl.step_plan(*shape, sms, SHARED_LIMIT)
    assert plan == _STEP_PLANS[shape]
    assert tl.step_shared_bytes(*shape[1:], *plan[1:3]) == plan[3]
    assert tl.cached_step_plan(*shape, sms, SHARED_LIMIT) == plan


def test_step_plan_shares_an_sm_only_above_the_sm_count():
    """120 flagship lanes are more than 108 SMs but fewer than 132: two
    blocks per SM (half its shared memory each) on the first, a block with
    taller tiles per SM on the others."""
    assert tl.step_plan(120, 200, 400, 108, SHARED_LIMIT) == (
        512, 16, 3, 80920)
    for sms in (132, 144):
        assert tl.step_plan(120, 200, 400, sms, SHARED_LIMIT) == (
            512, 29, 3, 143512)
    assert 2 * (80920 + 1024) <= SHARED_LIMIT + 1024 < 2 * (143512 + 1024)


def _step_layout_bytes(M, N, R, S):
    """StepLayout of csrc/lasso_step.cuh, written out once more."""
    if S == 0:
        return 4 * (N + M)
    fixed = 4 * (2 * (-(-N // 4) * 4) + -(-M // 4) * 4)
    return (-(-fixed // 128) * 128 + S * (-(-4 * R * N // 128) * 128)
            + 8 * S)


@pytest.mark.parametrize("sms", [108, 132, 144])
def test_step_plan_over_the_one_step_routes(sms):
    """Every shape the dispatch sends to the one-step solvers (a lane under
    1 MB) that the kernels took before (N + M floats of shared memory)
    gets a plan that fits: the layout's bytes, room left for the kernels'
    static scratch, one stage only where it holds the whole lane (nothing
    is refilled), a ring of three stages wherever three one-row stages fit,
    else the lane in place in N + M floats."""
    from proxtpu_torch.kernels.dispatch import BLOCKED_LANE_BYTES

    seen = set()
    for N in (24, 128, 161, 200, 400, 512, 513, 1024, 4096, 8400, 11000,
              12000, 29040, 57000):
        for M in (1, 16, 33, 64, 200, 400, 1000):
            if (M * N * 4 >= BLOCKED_LANE_BYTES
                    or (N + M) * 4 > SHARED_LIMIT):
                continue
            for B in (1, 64, 120, 256, 1024):
                threads, R, S, used = tl.step_plan(B, M, N, sms,
                                                   SHARED_LIMIT)
                seen.add(S)
                assert used == _step_layout_bytes(M, N, R, S)
                assert used + 512 <= SHARED_LIMIT, (B, M, N)
                assert 1 <= R <= M and S in (0, 1, 3)
                if S == 1:
                    assert R == M and threads == 256
                    assert 4 * (used + 1024 + 512) <= SHARED_LIMIT + 1024
                elif S == 3:
                    assert threads == (512 if N <= 512 else 1024)
                    assert R * N * 4 < 1 << 20
                else:
                    assert threads == 256 and used == (N + M) * 4
                    one_row_ring = _step_layout_bytes(M, N, 1, 3)
                    assert one_row_ring + 1024 + 512 > SHARED_LIMIT + 1024
    assert seen == {0, 1, 3}


def _replay_step_tiles(A, b, x, R):
    """One lane's two products in the tile order of the one-step kernels, in
    numpy float32: the lane's rows cut into tiles of R (the last may be
    short); per tile, r for its rows (a row's 32 strided partial chains,
    then the warp's xor tree), then every column's chain carried on over the
    tile's rows in ascending order."""
    f = np.float32
    M, N = A.shape
    r, g = np.zeros(M, f), np.zeros(N, f)
    for lo in range(0, M, R):
        for m in range(lo, min(lo + R, M)):
            r[m] = _replay_row_dot(A[m], x) - b[m]
        for m in range(lo, min(lo + R, M)):
            g = (g + r[m] * A[m].astype(np.float64)).astype(f)
    return r, g


def _replay_row_dot(row, x):
    """a . x as a warp sums it: lane l chains n = l, l + 32, ... by fma,
    then the xor tree over the 32 lanes."""
    f = np.float32
    lanes = np.zeros(32, f)
    for n in range(len(row)):
        # fma: the product is not rounded before the sum
        lanes[n % 32] = f(np.float64(row[n]) * np.float64(x[n])
                          + np.float64(lanes[n % 32]))
    return _xor_tree(lanes)[0]


def _xor_tree(v):
    v = v.copy()
    for o in (16, 8, 4, 2, 1):
        v = (v + v[np.arange(32) ^ o]).astype(np.float32)
    return v


@pytest.mark.parametrize("R", [1, 3, 5, 16, 23])
def test_step_tile_order_is_the_straight_sum(step_data, R):
    """Cutting a lane into tiles of R rows changes no bit of r or g: r is
    summed row by row, g by ascending rows across the tiles, as a kernel
    that walks all rows twice sums them (R = M, one tile)."""
    d = step_data
    A, b, x = d["A"][0], d["b"][0], d["x"][0]
    r, g = _replay_step_tiles(A, b, x, R)
    r_one, g_one = _replay_step_tiles(A, b, x, A.shape[0])
    np.testing.assert_array_equal(r, r_one)
    np.testing.assert_array_equal(g, g_one)
    np.testing.assert_allclose(r, A @ x - b, atol=1e-5)
    np.testing.assert_allclose(g, A.T @ (A @ x - b), atol=1e-5)


def _replay_block_sum(per_thread, order_threads=256):
    """block_reduce's sum over the first ``order_threads`` threads of a
    block: each warp's xor tree, then warp 0's xor tree over the warps'
    sums (lanes beyond the warps hold 0).  What the block's other threads
    hold is ignored."""
    warps = order_threads // 32
    sums = np.zeros(32, np.float32)
    for w in range(warps):
        sums[w] = _xor_tree(per_thread[32 * w: 32 * w + 32])[0]
    return _xor_tree(sums)[0]


@pytest.mark.parametrize("threads", [256, 512, 1024])
@pytest.mark.parametrize("N", [24, 400, 1000])
def test_rs_keeps_the_order_of_256_threads(threads, N):
    """rs = sum (x - z)(z - z_prev) in a block of ``threads`` threads is
    summed by its first 256: thread t chains the columns t, t + 256, ... by
    fma, then the two xor trees, so every block size gives the bits of a
    block of 256, within a few ulps of the plain sum."""
    f = np.float32
    rng = np.random.default_rng(N)
    d, e = rng.standard_normal((2, N)).astype(f)

    def chains(stride, width):
        acc = np.full(width, np.nan, f)  # threads past the first 256
        acc[:stride] = 0
        for n in range(N):
            acc[n % stride] = f(np.float64(d[n]) * np.float64(e[n])
                                + np.float64(acc[n % stride]))
        return acc

    got = _replay_block_sum(chains(256, threads))
    assert got == _replay_block_sum(chains(256, 256))
    np.testing.assert_allclose(got, np.sum(d.astype(np.float64) * e),
                               rtol=0, atol=1e-4)


def test_solve_lasso_batch_blocked_clamps_to_maxit(small):
    z, it, done = tl.solve_lasso_batch_blocked(*map(_t, small), 1e-12,
                                               maxit=13, iter_block=8)
    assert not done.any() and (it.numpy() == 13).all()


@pytest.fixture(scope="module")
def tall():
    """Strongly convex lasso problems (tall A) and the smallest sigma_min^2
    over the lanes as mf, as tests/test_dispatch.py:356-366 makes them."""
    A, b, lam, Lf = _problems(4, 32, 16, 13)
    mf = min(float(np.linalg.svd(a, compute_uv=False)[-1] ** 2) for a in A)
    return (A, b, lam, Lf), mf


def test_mf_beta_pair_bit_equal(tall):
    (A, b, lam, Lf), mf = tall
    gamma = (1.0 / Lf).astype(np.float32)
    ref = jl._mf_beta_pair(jnp.asarray(gamma), mf, jnp.float32)
    port = tl._mf_beta_pair(_t(gamma), mf, torch.float32)
    for p, r in zip(port, ref):
        assert p.dtype == torch.float32
        np.testing.assert_array_equal(p.numpy(), np.asarray(r))


@pytest.mark.parametrize("name", ["solve_lasso_batch",
                                  "solve_lasso_batch_packed"])
def test_mf_solvers_match_jax(tall, name):
    (A, b, lam, Lf), mf = tall
    args = (A, b, lam, Lf)
    ref = getattr(jl, name)(*map(jnp.asarray, args), TOL, maxit=3000,
                            interpret=True, mf=mf)
    port = getattr(tl, name)(*map(_t, args), TOL, maxit=3000, mf=mf)
    _assert_solver_parity(port, ref)
    plain = getattr(tl, name)(*map(_t, args), TOL, maxit=3000, mf=mf,
                              use_kernel=False)
    _assert_solver_parity(plain, ref)
    # the modulus pays: fewer iterations than the t-recursion
    no_mf = getattr(tl, name)(*map(_t, args), TOL, maxit=3000)
    assert port[1].float().mean() < no_mf[1].float().mean()


@pytest.mark.parametrize("kw", [{"restart": True}, {"lam2": 0.3}])
def test_mf_rejects_restart_and_lam2(small, kw):
    with pytest.raises(ValueError):
        tl.solve_lasso_batch(*map(_t, small), TOL, mf=0.1, **kw)


def test_problems_from_numpy_round_trip(small):
    A, b, lam, Lf = small
    out = problems_from_numpy(jnp.asarray(A), b.astype(np.float64), lam,
                              float(Lf[0]), device="cpu")
    for t, ref in zip(out, (A, b, lam, np.full(5, Lf[0], np.float32))):
        assert t.dtype == torch.float32 and t.is_contiguous()
        assert t.device.type == "cpu"
        np.testing.assert_array_equal(t.numpy(), ref)


@pytest.mark.parametrize("bad", ["A2d", "b", "lam"])
def test_problems_from_numpy_rejects_bad_shapes(small, bad):
    A, b, lam, Lf = small
    args = {"A2d": (A[0], b, lam, Lf), "b": (A, b[:, :-1], lam, Lf),
            "lam": (A, b, lam[:-1], Lf)}[bad]
    with pytest.raises(ValueError):
        problems_from_numpy(*args, device="cpu")


def test_port_imports_without_jax_nvcc_or_triton():
    """Importing the port loads no JAX and needs neither nvcc nor triton."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    modules = ["proxtpu_torch", "proxtpu_torch.kernels.lasso",
               "proxtpu_torch.kernels.box_qp", "proxtpu_torch.kernels.dispatch",
               "proxtpu_torch.parallel.batch", "proxtpu_torch.algorithms",
               "proxtpu_torch.prox", "proxtpu_torch.accel",
               "proxtpu_torch.ops", "proxtpu_torch.utils.fb_tools",
               "proxtpu_torch.utils.shared", "proxtpu_torch.convert"]
    code = (f"import sys, importlib; [importlib.import_module(m) for m in "
            f"{modules!r}]; bad = [m for m in ('jax', 'triton') "
            f"if m in sys.modules]; assert not bad, bad")
    env = dict(os.environ, PATH="/usr/bin:/bin", CUDA_HOME="/nonexistent",
               PYTHONPATH=root)
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=root, timeout=120)
