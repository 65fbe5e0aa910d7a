"""The port's kernel-route dispatch against the JAX reference, on the CPU.

``match_kernel_solver`` of both packages gets the same problems (the JAX
objects, and the port's made from them by ``prox_from_jax``).  Both return
``None`` or both return a runner, and the solver a runner calls is the one
the JAX matcher calls on a TPU (solvers patched in both modules to record
the call), with the kernel route for every float32 problem in the port.  Then
``BatchedAlgorithm`` is driven through its routes and held to the JAX
package's results: counts within +-1 (+-K blocked) and solutions within
1e-4 in float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import proxtpu as pa
import proxtpu_torch as pt
from proxtpu.algorithms import (
    make_fast_forward_backward_iteration as j_ffb,
    make_forward_backward_iteration as j_fb,
)
from proxtpu.kernels import dispatch as jd
from proxtpu.parallel.batch import BatchedAlgorithm as JBatched
from proxtpu.prox import (
    ElasticNet, IndBox, LeastSquaresLoss, NormL1, Quadratic,
)
from proxtpu_torch.algorithms import (
    make_fast_forward_backward_iteration as t_ffb,
    make_forward_backward_iteration as t_fb,
)
from proxtpu_torch.kernels import box_qp as tbox
from proxtpu_torch.kernels import dispatch as td
from proxtpu_torch.kernels import lasso as tlasso

B, M, N = 4, 16, 24
TOL = 1e-5

_LASSO = ("solve_lasso_batch", "solve_lasso_batch_packed",
          "solve_lasso_batch_blocked", "solve_lasso_multirhs")
_BOX = ("solve_box_qp_batch", "solve_box_qp_batch_blocked")


def _lasso_arrays(B_, M_, N_, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    A = (rng.standard_normal((B_, M_, N_)) / np.sqrt(M_)).astype(dtype)
    b = rng.standard_normal((B_, M_)).astype(dtype)
    lam = (0.1 * np.max(np.abs(np.einsum("bmn,bm->bn", A, b)), axis=1)
           ).astype(dtype)
    Lf = np.array([np.linalg.norm(a, 2) ** 2 for a in A], dtype)
    return A, b, lam, Lf


def _box_arrays(B_, n, seed):
    rng = np.random.default_rng(seed)
    Qs, qs, Lips = [], [], []
    for _ in range(B_):
        U, _ = np.linalg.qr(rng.standard_normal((n, n)))
        ev = 2 * rng.random(n) - 1
        Q0 = (U @ np.diag(ev) @ U.T).astype(np.float32)
        Qs.append(0.5 * (Q0 + Q0.T))
        qs.append(rng.standard_normal(n).astype(np.float32))
        Lips.append(np.max(np.abs(ev)))
    gamma = (0.95 / np.array(Lips)).astype(np.float32)
    return np.stack(Qs), np.stack(qs), gamma


def _lasso_kw(A, b, lam, Lf):
    return dict(x0=jnp.zeros((A.shape[0], A.shape[2]), A.dtype),
                f=LeastSquaresLoss(jnp.asarray(A), jnp.asarray(b)),
                g=NormL1(jnp.asarray(lam)), Lf=jnp.asarray(Lf))


def _box_kw(Q, q, gamma):
    return dict(x0=jnp.zeros(q.shape, jnp.float32),
                f=Quadratic(jnp.asarray(Q), jnp.asarray(q)),
                g=IndBox(-1.0, 1.0), gamma=jnp.asarray(gamma))


def _to_port(v):
    """The port's counterpart of one JAX kwarg value."""
    if isinstance(v, jax.Array) or isinstance(v, np.ndarray):
        return torch.tensor(np.asarray(v))
    if type(v).__name__ in ("AdaptiveRestartSequence",):
        inner = type(v.sequence).__name__
        return pt.AdaptiveRestartSequence(getattr(pt, inner)(
            *([v.sequence.m] if inner == "AdaptiveNesterovSequence" else [])))
    if type(v).__module__.startswith("proxtpu.prox") or \
            type(v).__name__ == "Shared":
        return pt.prox_from_jax(v, device="cpu")
    return v


def _port_kw(kw):
    return {k: _to_port(v) for k, v in kw.items()}


def _cases():
    lasso = _lasso_arrays(B, M, N, 0)
    A, b, lam, Lf = lasso
    base = _lasso_kw(*lasso)
    Q, q, gam = _box_arrays(4, 16, 2)
    box = _box_kw(Q, q, gam)
    f64 = _lasso_kw(*_lasso_arrays(B, M, N, 7, np.float64))
    tall = _lasso_arrays(4, 32, 16, 13)
    mf = min(float(np.linalg.svd(a, compute_uv=False)[-1] ** 2)
             for a in tall[0])
    big_lasso = _lasso_kw(np.zeros((2, 512, 512), np.float32),
                          np.zeros((2, 512), np.float32),
                          np.ones(2, np.float32), np.ones(2, np.float32))
    big_box = dict(x0=jnp.zeros((2, 512), jnp.float32),
                   f=Quadratic(jnp.zeros((2, 512, 512), jnp.float32),
                               jnp.zeros((2, 512), jnp.float32)),
                   g=IndBox(-1.0, 1.0), gamma=jnp.ones(2, jnp.float32))
    packed = _lasso_kw(np.zeros((4, 205, 160), np.float32),
                       np.zeros((4, 205), np.float32),
                       np.ones(4, np.float32), np.ones(4, np.float32))
    restart = pa.AdaptiveRestartSequence(pa.FixedNesterovSequence())
    rng = np.random.default_rng(9)
    lam2 = jnp.asarray(0.05 + 0.1 * rng.random(B), jnp.float32)
    ffb, fb = "ffb", "fb"
    return {
        "lasso": (ffb, base, {}),
        "adaptive": (ffb, dict({k: v for k, v in base.items() if k != "Lf"},
                               adaptive=True), {}),
        "custom_stop": (ffb, base, dict(stop=lambda it, tol, s: True)),
        "restart_seq": (ffb, dict(base, extrapolation_sequence=restart), {}),
        "restart_adaptive_m0": (ffb, dict(
            base, extrapolation_sequence=pa.AdaptiveRestartSequence(
                pa.AdaptiveNesterovSequence(0.0))), {}),
        "other_seq": (ffb, dict(
            base, extrapolation_sequence=pa.AdaptiveRestartSequence(
                pa.SimpleNesterovSequence())), {}),
        "nonzero_x0": (ffb, dict(base, x0=jnp.full((B, N), 0.1,
                                                   jnp.float32)), {}),
        "wrong_x0": (ffb, dict(base, x0=jnp.zeros((B, N + 1),
                                                  jnp.float32)), {}),
        "gamma": (ffb, dict({k: v for k, v in base.items() if k != "Lf"},
                            gamma=1.0 / jnp.asarray(Lf)), {}),
        "no_step": (ffb, {k: v for k, v in base.items() if k != "Lf"}, {}),
        "mf": (ffb, dict(_lasso_kw(*tall), mf=mf), {}),
        "mf_array": (ffb, dict(_lasso_kw(*tall),
                               mf=jnp.full((4,), mf, jnp.float32)), {}),
        "mf_restart": (ffb, dict(_lasso_kw(*tall), mf=mf,
                                 extrapolation_sequence=restart), {}),
        "elastic_net": (ffb, dict(base, g=ElasticNet(mu=jnp.asarray(lam),
                                                     lam=lam2)), {}),
        "elastic_net_mf": (ffb, dict(base, g=ElasticNet(
            mu=jnp.asarray(lam), lam=lam2), mf=0.1), {}),
        "f64": (ffb, f64, {}),
        "packed": (ffb, packed, {}),
        "blocked": (ffb, big_lasso, {}),
        "shared_a": (ffb, dict(base, f=LeastSquaresLoss(jnp.asarray(A[0]),
                                                        jnp.asarray(b)),
                               Lf=float(Lf[0])), {}),
        "box": (fb, box, {}),
        "box_lf": (fb, dict({k: v for k, v in box.items() if k != "gamma"},
                            Lf=0.95 / jnp.asarray(gam)), {}),
        "box_blocked": (fb, big_box, {}),
        "box_vector_bounds": (fb, dict(box, g=IndBox(-jnp.ones(16),
                                                     jnp.ones(16))), {}),
        "box_mf": (fb, dict(box, mf=0.1), {}),
        "box_with_lasso_f": (fb, base, {}),
    }


CASES = _cases()


@pytest.fixture
def recorded(monkeypatch):
    """Record which solver a runner calls, in both packages, on a JAX
    matcher that believes it runs on a TPU."""
    calls = {"jax": [], "port": []}
    from proxtpu.kernels import box_qp as jbox, lasso as jlasso

    def recorder(side, name):
        def fn(*args, **kw):
            calls[side].append((name, kw.get("use_kernel")))
            return None, None, None
        return fn

    for mod, names in ((jlasso, _LASSO), (jbox, _BOX)):
        for name in names:
            monkeypatch.setattr(mod, name, recorder("jax", name))
    for mod, names in ((tlasso, _LASSO), (tbox, _BOX)):
        for name in names:
            monkeypatch.setattr(mod, name, recorder("port", name))
    monkeypatch.setattr(jd, "_is_default_backend_tpu", lambda: True)
    return calls


@pytest.mark.parametrize("case", list(CASES))
def test_match_kernel_solver_decision_table(recorded, case):
    fac, kw, opts = CASES[case]
    j_fac, t_fac = (j_ffb, t_ffb) if fac == "ffb" else (j_fb, t_fb)
    run_j = jd.match_kernel_solver(j_fac, kw, tol=TOL, maxit=100, **opts)
    run_t = td.match_kernel_solver(t_fac, _port_kw(kw), tol=TOL, maxit=100,
                                   **opts)
    assert (run_j is None) == (run_t is None)
    if run_j is None:
        return
    run_j()
    run_t()
    (j_name, _), = recorded["jax"]
    (t_name, use_kernel), = recorded["port"]
    assert t_name == j_name
    if case == "shared_a":
        assert t_name == "solve_lasso_multirhs"
    f32 = np.asarray(kw["x0"]).dtype == np.float32
    # None: the packed, blocked and multirhs solvers, which take no flag
    assert use_kernel in (None, f32)


def test_unknown_kwarg_skips_kernels_and_raises():
    kw = _port_kw(_lasso_kw(*_lasso_arrays(B, M, N, 0)))
    solver = pt.BatchedAlgorithm(t_fb, maxit=50, tol=TOL)
    with pytest.raises(TypeError):
        solver(**kw, mf=0.1)


def _check(port, ref, slack=1, atol=1e-4):
    z_p, it_p, d_p = (np.asarray(v) for v in port)
    z_r, it_r, d_r = (np.asarray(v) for v in ref)
    assert d_p.all() and d_r.all()
    assert int(np.max(np.abs(it_p.astype(np.int64) - it_r))) <= slack
    np.testing.assert_allclose(z_p, z_r, atol=atol)


@pytest.mark.parametrize("case", ["lasso", "restart_seq", "mf", "box"])
def test_batched_algorithm_kernel_routes_match_jax(case):
    fac, kw, _ = CASES[case]
    j_fac, t_fac = (j_ffb, t_ffb) if fac == "ffb" else (j_fb, t_fb)
    maxit = 3000 if fac == "ffb" else 10_000
    tol = TOL if fac == "ffb" else 1e-4
    ref = JBatched(j_fac, maxit=maxit, tol=tol, use_kernels="interpret")(
        **kw)
    port = pt.BatchedAlgorithm(t_fac, maxit=maxit, tol=tol)(**_port_kw(kw))
    _check(port, ref)


def test_batched_algorithm_blocked_routes(monkeypatch):
    """With the 1 MB threshold patched down, ``BatchedAlgorithm`` takes the
    blocked routes at test size and matches JAX's blocked solvers."""
    from proxtpu.kernels.box_qp import solve_box_qp_batch_blocked
    from proxtpu.kernels.lasso import solve_lasso_batch_blocked

    monkeypatch.setattr(td, "BLOCKED_LANE_BYTES", 1)
    K = 8
    lasso = _lasso_arrays(B, M, N, 0)
    before = tlasso.fused_fista_k_steps.launches
    for restart in (False, True):
        kw = _lasso_kw(*lasso)
        if restart:
            kw["extrapolation_sequence"] = pa.AdaptiveRestartSequence(
                pa.FixedNesterovSequence())
        ref = solve_lasso_batch_blocked(*map(jnp.asarray, lasso), TOL,
                                        maxit=3000, iter_block=K,
                                        interpret=True, restart=restart)
        port = pt.BatchedAlgorithm(t_ffb, maxit=3000, tol=TOL)(
            **_port_kw(kw))
        _check(port, ref, slack=K)
    Q, q, gam = _box_arrays(4, 16, 2)
    ref = solve_box_qp_batch_blocked(jnp.asarray(Q), jnp.asarray(q), -1.0,
                                     1.0, jnp.asarray(0.95 / gam), 1e-4,
                                     iter_block=K, interpret=True)
    port = pt.BatchedAlgorithm(t_fb, maxit=10_000, tol=1e-4)(
        **_port_kw(_box_kw(Q, q, gam)))
    _check(port, ref, slack=K)
    # CPU tensors run the plain versions: no launch is counted
    assert tlasso.fused_fista_k_steps.launches == before


def _shared_a_kw():
    A, b, lam, Lf = _lasso_arrays(B, M, N, 5)
    return dict(x0=jnp.zeros((B, N), jnp.float32),
                f=LeastSquaresLoss(jnp.asarray(A[0]), jnp.asarray(b)),
                g=NormL1(jnp.asarray(lam)), Lf=float(Lf[0]))


def test_shared_a_takes_the_generic_driver():
    """With the kernels off, the port's generic driver solves a shared A as
    JAX's does."""
    kw = _shared_a_kw()
    ref = JBatched(j_ffb, maxit=3000, tol=TOL, use_kernels=False)(**kw)
    port = pt.BatchedAlgorithm(t_ffb, maxit=3000, tol=TOL,
                               use_kernels=False)(**_port_kw(kw))
    _check(port, ref)


def test_shared_a_takes_multirhs(monkeypatch):
    """By default the port's ``BatchedAlgorithm`` sends a shared A to
    ``solve_lasso_multirhs`` and matches JAX's generic driver."""
    calls = []
    real = tlasso.solve_lasso_multirhs

    def spy(*args, **kw):
        calls.append(kw["iter_block"])
        return real(*args, **kw)

    monkeypatch.setattr(tlasso, "solve_lasso_multirhs", spy)
    kw = _shared_a_kw()
    ref = JBatched(j_ffb, maxit=3000, tol=TOL, use_kernels=False)(**kw)
    port = pt.BatchedAlgorithm(t_ffb, maxit=3000, tol=TOL)(**_port_kw(kw))
    assert calls == [1]
    _check(port, ref)


def test_prox_from_jax_round_trip():
    """Every carried class, stacked and in Shared, keeps its arrays (dtype
    included) and its oracles' values."""
    from proxtpu.prox import make_least_squares
    from proxtpu.utils.shared import Shared as JShared

    A, b, lam, _ = _lasso_arrays(2, 6, 5, 3, np.float64)
    Q, q, _ = _box_arrays(2, 5, 4)
    objs = [LeastSquaresLoss(jnp.asarray(A), jnp.asarray(b), 0.5),
            make_least_squares(jnp.asarray(A[0]), jnp.asarray(b[0])),
            NormL1(jnp.asarray(lam)), NormL1(0.3),
            ElasticNet(0.2, jnp.asarray(lam)),
            Quadratic(jnp.asarray(Q), jnp.asarray(q)), IndBox(-1.0, 2.0),
            JShared(NormL1(jnp.asarray(lam)))]
    for obj in objs:
        port = pt.prox_from_jax(obj, device="cpu")
        inner_j = obj.value if isinstance(obj, JShared) else obj
        inner_t = port.value if isinstance(port, pt.Shared) else port
        assert type(inner_t).__name__ == type(inner_j).__name__
        for name, v in vars(inner_j).items():
            w = getattr(inner_t, name)
            if isinstance(w, torch.Tensor):
                assert str(w.dtype).split(".")[-1] == str(np.asarray(v).dtype)
                np.testing.assert_array_equal(w.numpy(), np.asarray(v))
            else:
                assert w == v
    ls = objs[1]
    x = np.random.default_rng(0).standard_normal(5)
    vj, gj = ls.value_and_gradient(jnp.asarray(x))
    vt, gt = pt.prox_from_jax(ls, "cpu").value_and_gradient(torch.tensor(x))
    np.testing.assert_allclose(float(vt), float(vj), rtol=1e-12)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), atol=1e-12)
    with pytest.raises(TypeError, match="no port counterpart"):
        pt.prox_from_jax(pa.FixedNesterovSequence(), device="cpu")
