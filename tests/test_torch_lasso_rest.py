"""The rest of the port's lasso family against the JAX reference, on the CPU:
the shared-A solver and its dispatch leg, the two-stage mixed-precision
solver (A stored in bfloat16), the compacting driver and the over-relaxed
solvers (``step_mult``).

The same numpy inputs, made from a seed, go through ``proxtpu`` (its XLA
path, or its Pallas kernels in interpret mode where its own test runs them)
and through ``proxtpu_torch``, whose kernel wrappers run their plain
versions for CPU tensors.  Tolerances are the reference's cross-path
contract: float32 counts within +-1 and solutions within 1e-4
(``tests/test_kernels.py:58-61``); blocked counts are sampled every K and
held as upper bounds with K - 1 of slack; float64 counts are equal.  The
reference's own oracles (``tests/test_kernels.py``, ``test_dispatch.py``,
``test_shared_batch.py``) are repeated on the port at their shapes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import proxtpu as pa
import proxtpu_torch as pt
from proxtpu.kernels import lasso as jl
from proxtpu_torch.kernels import dispatch as td
from proxtpu_torch.kernels import lasso as tl
from proxtpu_torch.prox import ElasticNet, LeastSquaresLoss, NormL1

TOL = 1e-5


def _problems(B, M, N, seed, lam_frac=0.1, dtype=np.float32):
    """tests/test_kernels.py's ``_lasso_problems``, in numpy."""
    rng = np.random.default_rng(seed)
    A = (rng.standard_normal((B, M, N)) / np.sqrt(M)).astype(dtype)
    b = rng.standard_normal((B, M)).astype(dtype)
    lam = (lam_frac * np.max(np.abs(np.einsum("bmn,bm->bn", A, b)), axis=1)
           ).astype(dtype)
    Lf = np.array([np.linalg.norm(a, 2) ** 2 for a in A], dtype)
    return A, b, lam, Lf


def _t(a):
    return torch.tensor(np.asarray(a))


def _j(a):
    return jnp.asarray(np.asarray(a))


def _parity(port, ref, slack=1, atol=1e-4):
    """Both solves finish every lane, counts within ``slack``, solutions
    within ``atol``."""
    z_p, it_p, d_p = (np.asarray(v) for v in port)
    z_r, it_r, d_r = (np.asarray(v) for v in ref)
    assert d_p.all() and d_r.all()
    assert int(np.max(np.abs(it_p.astype(np.int64) - it_r))) <= slack, (
        it_p, it_r)
    np.testing.assert_allclose(z_p, z_r, atol=atol)


def _residual(A, b, lam, Lf, x, lam2=None):
    """The worst lane's FB residual ``||x - prox(x - grad / Lf)|| * Lf`` in
    the inputs' precision (as tests/test_kernels.py's rechecks take it), A
    (B, M, N) per lane or (M, N) shared: the canonical criterion at gamma =
    1 / Lf, whatever step a solver took; ``lam2`` adds the ridge."""
    A, b, x = (np.asarray(v) for v in (A, b, x))
    lam = np.broadcast_to(np.asarray(lam, x.dtype), x.shape[:1])
    gam = np.broadcast_to(1.0 / np.asarray(Lf, x.dtype), x.shape[:1])
    if A.ndim == 2:
        grad = (x @ A.T - b) @ A
    else:
        grad = np.einsum("bmn,bm->bn", A, np.einsum("bmn,bn->bm", A, x) - b)
    y = x - gam[:, None] * grad
    z = np.sign(y) * np.maximum(np.abs(y) - (gam * lam)[:, None], 0.0)
    if lam2 is not None:
        z = z / (1.0 + gam * np.asarray(lam2))[:, None]
    return float(np.max(np.max(np.abs(x - z), axis=1) / gam))


@pytest.fixture(scope="module")
def data():
    """tests/test_kernels.py's ``data``: 5 lanes of 16 x 24, seed 0."""
    return _problems(5, 16, 24, 0)


# ---------------------------------------------------------------------------
# solve_lasso_multirhs: one A, many right-hand sides


_MULTIRHS = {
    "k1": {},
    "k8": {"iter_block": 8},
    "k1_restart": {"restart": True},
    "k8_restart": {"iter_block": 8, "restart": True},
    "lam2": {"lam2": "lam2"},
    "lam2_restart": {"lam2": "lam2", "restart": True},
    "x0": {"x0": "x0"},
    "scalar_lam": {"lam": 0.2},
    "f64": {"dtype": np.float64},
}


@pytest.mark.parametrize("case", list(_MULTIRHS))
def test_multirhs_matches_jax(case):
    kw = dict(_MULTIRHS[case])
    dtype = kw.pop("dtype", np.float32)
    A, b, lam, Lf = _problems(5, 16, 24, 0, dtype=dtype)
    A0, Lf0 = A[0], dtype(Lf[0])
    lam = kw.pop("lam", lam)
    rng = np.random.default_rng(100)
    if kw.get("lam2"):
        kw["lam2"] = (0.05 + 0.1 * rng.random(5)).astype(dtype)
    if kw.get("x0"):
        kw["x0"] = (0.1 * rng.standard_normal((5, 24))).astype(dtype)
    ref = jl.solve_lasso_multirhs(_j(A0), _j(b), _j(lam), Lf0, TOL,
                                  maxit=3000, **{k: (_j(v) if k in (
                                      "lam2", "x0") else v)
                                      for k, v in kw.items()})
    port = tl.solve_lasso_multirhs(_t(A0), _t(b), _t(lam), float(Lf0), TOL,
                                   maxit=3000, **{k: (_t(v) if k in (
                                       "lam2", "x0") else v)
                                       for k, v in kw.items()})
    assert port[0].dtype == _t(A0).dtype
    # float64: the same decisions; a blocked count moves by whole blocks
    slack = 0 if dtype == np.float64 else kw.get("iter_block", 2) - 1
    _parity(port, ref, slack=slack)
    assert _residual(A0, b, lam, Lf0, port[0], kw.get("lam2")) <= 1.1 * TOL


def test_multirhs_matches_per_lane_batch(data):
    """tests/test_kernels.py:152: with every lane on the same A the shared-A
    solver reproduces the distinct-A batch solver; blocking keeps the fixed
    point and gives upper-bound counts."""
    A, b, lam, Lf = data
    A_rep = np.broadcast_to(A[0], A.shape).copy()
    z1, i1, d1 = tl.solve_lasso_multirhs(_t(A[0]), _t(b), _t(lam),
                                         float(Lf[0]), TOL, maxit=3000)
    z2, i2, d2 = tl.solve_lasso_batch(_t(A_rep), _t(b), _t(lam),
                                      float(Lf[0]), TOL, maxit=3000,
                                      use_kernel=False)
    _parity((z1, i1, d1), (z2, i2, d2))
    z3, i3, d3 = tl.solve_lasso_multirhs(_t(A[0]), _t(b), _t(lam),
                                         float(Lf[0]), TOL, maxit=3000,
                                         iter_block=8)
    assert bool(d3.all())
    np.testing.assert_allclose(z3.numpy(), z1.numpy(), atol=5e-4)
    assert bool((i3 >= i1 - 1).all())


@pytest.mark.parametrize("K", [1, 8])
def test_multirhs_restart_cuts_iterations(data, K):
    """tests/test_kernels.py:365-417: restart (checked on a block's last
    step) needs fewer iterations on average and satisfies the residual
    criterion."""
    A, b, lam, _ = data
    A1 = A[0]
    Lf1 = float(np.linalg.norm(A1, 2) ** 2)
    z_r, it_r, d_r = tl.solve_lasso_multirhs(_t(A1), _t(b), _t(lam), Lf1,
                                             TOL, maxit=3000, iter_block=K,
                                             restart=True)
    _, it_p, d_p = tl.solve_lasso_multirhs(_t(A1), _t(b), _t(lam), Lf1, TOL,
                                           maxit=3000, iter_block=K)
    assert bool(d_r.all()) and bool(d_p.all())
    assert _residual(A1, b, lam, Lf1, z_r) <= 1.1 * TOL
    assert it_r.float().mean() < it_p.float().mean()


def test_multirhs_elastic_net_matches_generic_driver():
    """tests/test_kernels.py:722: the shared-A elastic net agrees with
    JAX's generic FISTA driver on the ElasticNet prox."""
    from proxtpu.algorithms import make_fast_forward_backward_iteration
    from proxtpu.parallel import BatchedAlgorithm
    from proxtpu.prox import ElasticNet as JElasticNet
    from proxtpu.prox import LeastSquaresLoss as JLeastSquaresLoss

    A, b, lam1, Lf = _problems(6, 40, 160, 0)
    lam2 = (0.05 + 0.1 * np.random.default_rng(100).random(6)).astype(
        np.float32)
    A1, Lf1 = A[0], float(Lf[0])
    z_m, it_m, d_m = tl.solve_lasso_multirhs(_t(A1), _t(b), _t(lam1), Lf1,
                                             TOL, maxit=3000, lam2=_t(lam2))
    gen = BatchedAlgorithm(make_fast_forward_backward_iteration, maxit=3000,
                           tol=TOL, use_kernels=False)
    xs_g, _, d_g = gen(x0=jnp.zeros((6, 160), jnp.float32),
                       f=JLeastSquaresLoss(_j(A1), _j(b)),
                       g=JElasticNet(mu=_j(lam1), lam=_j(lam2)), Lf=Lf1)
    assert bool(d_m.all()) and bool(np.asarray(d_g).all())
    np.testing.assert_allclose(z_m.numpy(), np.asarray(xs_g), atol=1e-3)


def test_multirhs_refuses_tf32():
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="TF32"):
            tl.solve_lasso_multirhs(torch.eye(3), torch.ones(2, 3), 0.1, 1.0,
                                    TOL)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


# ---------------------------------------------------------------------------
# the shared-A leg of match_kernel_solver


def _shared_kw(A0, b, lam, Lf0, **extra):
    return dict(x0=torch.zeros(b.shape[0], A0.shape[1], dtype=A0.dtype),
                f=LeastSquaresLoss(A0, b), g=NormL1(lam), Lf=Lf0, **extra)


def _routed(monkeypatch):
    """Record the calls of the port's solve_lasso_multirhs."""
    calls = []
    real = tl.solve_lasso_multirhs

    def spy(*args, **kw):
        calls.append(kw)
        return real(*args, **kw)

    monkeypatch.setattr(tl, "solve_lasso_multirhs", spy)
    return calls


def test_multirhs_dispatch(monkeypatch):
    """tests/test_kernels.py:184: ``match_kernel_solver`` routes a shared A
    with ``LeastSquaresLoss`` + ``NormL1`` to the multirhs solver (K = 1),
    and lane 0's fixed point holds in float64."""
    rng = np.random.default_rng(5)
    M, N, B = 16, 24, 5
    A0 = (rng.standard_normal((M, N)) / np.sqrt(M)).astype(np.float32)
    bb = rng.standard_normal((B, M)).astype(np.float32)
    Lf0 = float(np.linalg.norm(A0, 2) ** 2)
    calls = _routed(monkeypatch)
    run = td.match_kernel_solver(
        pt.make_fast_forward_backward_iteration,
        _shared_kw(_t(A0), _t(bb), 0.1, Lf0), tol=TOL, maxit=3000)
    assert run is not None
    z, it, done = run()
    assert bool(done.all()) and [c["iter_block"] for c in calls] == [1]
    assert _residual(A0, bb[:1], 0.1, Lf0, z[:1]) <= 2e-5


def test_restart_sequence_shared_a_routes_multirhs_k1(monkeypatch):
    """tests/test_dispatch.py:312: shared A with adaptive restart takes the
    multirhs solver at K = 1 and matches JAX's generic batched driver."""
    import jax

    from proxtpu.algorithms import make_fast_forward_backward_iteration
    from proxtpu.parallel.batch import batched_run_loop
    from proxtpu.prox import LeastSquaresLoss as JLeastSquaresLoss
    from proxtpu.prox import NormL1 as JNormL1

    rng = np.random.default_rng(11)
    M, N, B = 16, 24, 4
    A0 = (rng.standard_normal((M, N)) / np.sqrt(M)).astype(np.float32)
    bb = rng.standard_normal((B, M)).astype(np.float32)
    Lf0 = float(np.linalg.norm(A0, 2) ** 2)
    lam0 = (0.1 * np.max(np.abs(bb @ A0), axis=1)).astype(np.float32)
    calls = _routed(monkeypatch)
    port = pt.BatchedAlgorithm(pt.make_fast_forward_backward_iteration,
                               maxit=4000, tol=TOL)(
        **_shared_kw(_t(A0), _t(bb), _t(lam0), Lf0,
                     extrapolation_sequence=pt.AdaptiveRestartSequence(
                         pt.FixedNesterovSequence())))
    assert [(c["iter_block"], c["restart"]) for c in calls] == [(1, True)]
    seq = pa.AdaptiveRestartSequence(pa.FixedNesterovSequence())
    iteration = jax.vmap(
        lambda bi, li: make_fast_forward_backward_iteration(
            x0=jnp.zeros(N, jnp.float32), f=JLeastSquaresLoss(_j(A0), bi),
            g=JNormL1(li), gamma=1.0 / Lf0, extrapolation_sequence=seq)
    )(_j(bb), _j(lam0))
    _parity(port, batched_run_loop(iteration, 4000, TOL))


def test_shared_f_routes_to_multirhs(monkeypatch):
    """tests/test_shared_batch.py:263: a ``Shared`` least-squares f (one
    A (M, N) and one b (M,)) with a lam per lane routes to the multirhs
    solver, and its solutions match the generic driver's."""
    rng = np.random.default_rng(7)
    M, N, B = 12, 8, 4
    A = (rng.standard_normal((M, N)) / np.sqrt(M)).astype(np.float32)
    b = rng.standard_normal(M).astype(np.float32)
    lam = (0.05 + 0.25 * rng.random(B)).astype(np.float32)
    Lf = float(np.linalg.norm(A, 2) ** 2)
    kw = dict(x0=torch.zeros(B, N), f=pt.Shared(LeastSquaresLoss(_t(A),
                                                                 _t(b))),
              g=NormL1(_t(lam)), Lf=Lf)
    calls = _routed(monkeypatch)
    run = td.match_kernel_solver(pt.make_fast_forward_backward_iteration, kw,
                                 tol=TOL, maxit=5000)
    assert run is not None
    xs, _, done = run()
    assert bool(done.all()) and len(calls) == 1
    xs_g, _, done_g = pt.BatchedAlgorithm(
        pt.make_fast_forward_backward_iteration, maxit=5000, tol=TOL,
        use_kernels=False)(**kw)
    assert bool(done_g.all())
    np.testing.assert_allclose(xs.numpy(), xs_g.numpy(), atol=2e-4)


@pytest.mark.parametrize("case", ["vector_Lf", "mf", "wrong_x0", "lam2"])
def test_shared_a_leg_rules(case):
    """The leg's ``None`` rules of the reference (``dispatch.py:601-631``):
    a per-lane step, ``mf`` and an x0 of the wrong shape take the generic
    driver; an ``ElasticNet`` g stays on the leg."""
    A, b, lam, Lf = _problems(4, 16, 24, 0)
    kw = _shared_kw(_t(A[0]), _t(b), _t(lam), float(Lf[0]))
    if case == "vector_Lf":
        kw["Lf"] = _t(Lf)
    elif case == "mf":
        kw["mf"] = 0.1
    elif case == "wrong_x0":
        kw["x0"] = torch.zeros(4, 25)
    else:
        kw["g"] = ElasticNet(mu=_t(lam), lam=0.1)
    run = td.match_kernel_solver(pt.make_fast_forward_backward_iteration, kw,
                                 tol=TOL, maxit=100)
    assert (run is not None) == (case == "lam2")


# ---------------------------------------------------------------------------
# solve_lasso_batch_mixed: a bf16 warm stage, then the float32 polish


def test_bf16_rounding_matches_jax(data):
    """``A.to(torch.bfloat16)`` and ``astype(jnp.bfloat16)`` round the mixed
    tests' A to the same bits (both to nearest even)."""
    for A in (data[0], _problems(6, 40, 160, 0)[0]):
        port = _t(A).to(torch.bfloat16).view(torch.int16).numpy()
        ref = np.asarray(jnp.asarray(A).astype(jnp.bfloat16)).view(np.int16)
        np.testing.assert_array_equal(port, ref)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_mixed_reaches_f32_tolerance(data, use_kernel):
    """tests/test_kernels.py:280: the mixed solution satisfies the float32
    criterion and is as close to a tight ground truth as the plain
    solver's; it matches JAX's mixed solver (XLA)."""
    A, b, lam, Lf = data
    port = tl.solve_lasso_batch_mixed(*map(_t, data), TOL, maxit=3000,
                                      use_kernel=use_kernel)
    assert bool(port[2].all())
    assert _residual(A, b, lam, Lf, port[0]) <= 1.1 * TOL
    z_gt, _, d_gt = tl.solve_lasso_batch(*map(_t, data), 1e-7, maxit=30000,
                                         use_kernel=False)
    z_ref, _, _ = tl.solve_lasso_batch(*map(_t, data), TOL, maxit=3000,
                                       use_kernel=False)
    assert bool(d_gt.all())
    err_m = float((port[0] - z_gt).abs().max())
    err_ref = float((z_ref - z_gt).abs().max())
    assert err_m <= 3 * max(err_ref, 1e-6), (err_m, err_ref)
    _parity(port, jl.solve_lasso_batch_mixed(*map(_j, data), TOL, maxit=3000,
                                             use_kernel=False))


def test_mixed_fewer_iterations(data):
    """tests/test_kernels.py:308: bf16 and float32 steps together fewer
    than the plain solver's."""
    _, it_plain, _ = tl.solve_lasso_batch(*map(_t, data), TOL, maxit=3000,
                                          use_kernel=False)
    _, it_mixed, d = tl.solve_lasso_batch_mixed(*map(_t, data), TOL,
                                                maxit=3000, use_kernel=False)
    assert bool(d.all())
    assert it_mixed.float().mean() < it_plain.float().mean()


def test_mixed_restart_matches_jax_kernel(data):
    """tests/test_kernels.py:462: with restart, the port's plain route
    against JAX's kernels in interpret mode, +-1; the criterion holds."""
    port = tl.solve_lasso_batch_mixed(*map(_t, data), TOL, maxit=3000,
                                      use_kernel=False, restart=True)
    ref = jl.solve_lasso_batch_mixed(*map(_j, data), TOL, maxit=3000,
                                     use_kernel=True, interpret=True,
                                     restart=True)
    _parity(port, ref)
    assert _residual(*data, port[0]) <= 1.1 * TOL


@pytest.mark.parametrize("use_kernel", [False, True])
def test_mixed_float32_warm_stage(data, use_kernel):
    """``warm_dtype=float32`` (the two stages without narrow storage)
    matches JAX's on both routes."""
    port = tl.solve_lasso_batch_mixed(*map(_t, data), TOL, maxit=3000,
                                      use_kernel=use_kernel,
                                      warm_dtype=torch.float32, restart=True)
    ref = jl.solve_lasso_batch_mixed(*map(_j, data), TOL, maxit=3000,
                                     use_kernel=False,
                                     warm_dtype=jnp.float32, restart=True)
    _parity(port, ref)


def test_mixed_kernel_route_takes_bf16_or_f32_only(data):
    with pytest.raises(TypeError, match="warm_dtype"):
        tl.solve_lasso_batch_mixed(*map(_t, data), TOL,
                                   warm_dtype=torch.float16)


def test_bf16_steps_are_the_f32_steps_on_the_cast(data):
    """The wrappers take A in bfloat16 (on the CPU their plain versions):
    the result is the float32 step on ``A16.float()``, bit for bit."""
    A, b, lam, Lf = map(_t, data)
    A16 = A.to(torch.bfloat16)
    gamma = 1.0 / Lf
    x = torch.tensor(np.random.default_rng(1).standard_normal((5, 24)),
                     dtype=torch.float32)
    got = tl.fused_fb_prox_grad(A16, b, x, gamma, gamma * lam)
    want = tl.fused_fb_prox_grad(A16.float(), b, x, gamma, gamma * lam)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    state = [(x.clone(), torch.zeros_like(x)) for _ in range(2)]
    beta, done = torch.full((5,), 0.5), torch.tensor([0., 1., 0., 0., 0.])
    got, want = (tl.fused_fista_full_step(a, b, *s, beta, gamma, gamma * lam,
                                          done, restart=True)
                 for a, s in zip((A16, A16.float()), state))
    assert all(torch.equal(g, w) for g, w in zip(got, want))


# ---------------------------------------------------------------------------
# solve_lasso_batch_compacting


@pytest.fixture(scope="module")
def spread(data):
    """``data`` with lam spread as tests/test_kernels.py:428-431 does, so
    that compaction triggers."""
    A, b, lam, Lf = data
    rng = np.random.default_rng(5)
    return A, b, (lam * (0.2 + 0.8 * rng.random(5))).astype(np.float32), Lf


@pytest.mark.parametrize("restart", [False, True])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_compacting_is_bit_identical(spread, use_kernel, restart):
    """tests/test_kernels.py:420: compaction is scheduling only: counts,
    done flags and solutions equal to the port's solve_lasso_batch to the
    last bit, counts equal to JAX's compacting driver."""
    kw = dict(maxit=3000, use_kernel=use_kernel, restart=restart)
    ref = tl.solve_lasso_batch(*map(_t, spread), TOL, **kw)
    port = tl.solve_lasso_batch_compacting(*map(_t, spread), TOL, segment=40,
                                           min_batch=2, **kw)
    assert all(torch.equal(p, r) for p, r in zip(port, ref))
    jax_it = jl.solve_lasso_batch_compacting(
        *map(_j, spread), TOL, maxit=3000, use_kernel=False, restart=restart,
        segment=40, min_batch=2)[1]
    np.testing.assert_array_equal(port[1].numpy(), np.asarray(jax_it))


def test_compacting_maxit_cap(spread):
    """Unconverged lanes report maxit and done = False, as
    solve_lasso_batch does."""
    ref = tl.solve_lasso_batch(*map(_t, spread), 1e-12, maxit=60,
                               use_kernel=False)
    port = tl.solve_lasso_batch_compacting(*map(_t, spread), 1e-12, maxit=60,
                                           use_kernel=False, segment=25,
                                           min_batch=2)
    assert all(torch.equal(p, r) for p, r in zip(port, ref))
    assert (port[1] == 60).all() and not port[2].any()


# ---------------------------------------------------------------------------
# step_mult: over-relaxed restart-FISTA with the stall safeguard


@pytest.mark.parametrize("use_kernel", [False, True])
def test_step_mult_faster_same_certificate(use_kernel):
    """tests/test_kernels.py:594: step_mult = 1.5 takes fewer iterations
    than restart alone and returns solutions that satisfy the canonical
    criterion at gamma = 1 / Lf; it matches JAX's over-relaxed solver."""
    prob = _problems(6, 80, 160, 0)
    z_r, it_r, _ = tl.solve_lasso_batch(*map(_t, prob), TOL, maxit=3000,
                                        restart=True, use_kernel=use_kernel)
    port = tl.solve_lasso_batch(*map(_t, prob), TOL, maxit=3000,
                                restart=True, step_mult=1.5,
                                use_kernel=use_kernel)
    assert bool(port[2].all())
    assert _residual(*prob, port[0]) <= 1.05 * TOL
    np.testing.assert_allclose(port[0].numpy(), z_r.numpy(), atol=5e-3)
    assert port[1].float().mean() < it_r.float().mean()
    _parity(port, jl.solve_lasso_batch(*map(_j, prob), TOL, maxit=3000,
                                       restart=True, step_mult=1.5,
                                       use_kernel=False))


def test_step_mult_packed_matches_onestep():
    """tests/test_kernels.py:621: the packed solver's over-relaxed variant
    (its init the full step at beta = 0) reproduces the one-step solver's
    counts but at knife edges, and matches JAX's packed solver (kernels in
    interpret mode)."""
    prob = _problems(8, 40, 160, 1)
    one = tl.solve_lasso_batch(*map(_t, prob), TOL, maxit=3000, restart=True,
                               step_mult=1.5)
    packed = tl.solve_lasso_batch_packed(*map(_t, prob), TOL, maxit=3000,
                                         restart=True, step_mult=1.5)
    assert bool(one[2].all()) and bool(packed[2].all())
    assert _residual(*prob, packed[0]) <= 1.1 * TOL
    assert (one[1] == packed[1]).float().mean() >= 0.75
    np.testing.assert_allclose(packed[0].numpy(), one[0].numpy(), atol=5e-3)
    _parity(packed, jl.solve_lasso_batch_packed(
        *map(_j, prob), TOL, maxit=3000, restart=True, step_mult=1.5,
        interpret=True))


def test_step_mult_safeguard_rescues_divergence():
    """tests/test_kernels.py:641: at lam = 0.02 lam_max the over-relaxed
    momentum diverges on some lanes; the runaway and stall triggers
    cold-restart them, so every lane converges within 1.3x restart-only's
    worst count.  (Which iteration a trigger fires at is chaotic in f32:
    the counts are held by this oracle, not lane by lane against JAX.)"""
    prob = _problems(8, 40, 160, 3, lam_frac=0.02)
    port = tl.solve_lasso_batch(*map(_t, prob), TOL, maxit=20000,
                                restart=True, step_mult=1.5,
                                use_kernel=False)
    _, it_r, _ = tl.solve_lasso_batch(*map(_t, prob), TOL, maxit=20000,
                                      restart=True, use_kernel=False)
    assert bool(port[2].all())
    assert _residual(*prob, port[0]) <= 1.05 * TOL
    assert port[1].max() <= 1.3 * it_r.max()


@pytest.mark.parametrize("solver", ["solve_lasso_batch",
                                    "solve_lasso_batch_packed"])
def test_step_mult_validation(solver):
    """tests/test_kernels.py:660: the reference's ValueErrors."""
    args = (*map(_t, _problems(4, 16, 128, 0)), TOL)
    fn = getattr(tl, solver)
    with pytest.raises(ValueError, match="outside"):
        fn(*args, restart=True, step_mult=2.5)
    with pytest.raises(ValueError, match="requires restart"):
        fn(*args, step_mult=1.5)
    with pytest.raises(ValueError, match="mf"):
        fn(*args, restart=True, step_mult=1.5, mf=0.5)
    with pytest.raises(ValueError, match="lam2"):
        fn(*args, restart=True, step_mult=1.5, lam2=0.1)


def test_step_mult_one_is_bitexact_default():
    """tests/test_kernels.py:671: step_mult = 1.0 takes the textbook
    path."""
    args = (*map(_t, _problems(5, 24, 128, 2)), TOL)
    plain = tl.solve_lasso_batch(*args, maxit=2000, restart=True,
                                 use_kernel=False)
    same = tl.solve_lasso_batch(*args, maxit=2000, restart=True,
                                use_kernel=False, step_mult=1.0)
    assert all(torch.equal(a, b) for a, b in zip(plain, same))
