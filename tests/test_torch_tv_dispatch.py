"""The port's TV dispatch against the JAX reference, on the CPU.

``match_tv_solver`` of both packages gets the same problems (the JAX
objects, and the port's made from them by ``prox_from_jax`` and
``linop_from_jax``): the decision table of ``tests/test_tv_dispatch.py`` and
every other rule that returns ``None``; both match or both decline.  Then
``BatchedAlgorithm`` is driven on the TV problem: it reaches
``solve_tv_batch`` and the kernel wrapper, and returns the generic driver's
solution structure, within the reference's contract of the generic driver
and of the JAX package's result.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import proxtpu_torch as pt
from proxtpu.algorithms import primal_dual as jpd
from proxtpu.kernels.dispatch import match_tv_solver as j_match
from proxtpu.ops.linops import Grad2DOperator as JGrad2D
from proxtpu.parallel.batch import BatchedAlgorithm as JBatched
from proxtpu.prox import NormL21 as JNormL21
from proxtpu.prox import SqrDistance as JSqrDistance
from proxtpu.prox import SqrNormL2 as JSqrNormL2
from proxtpu.prox import Zero as JZero
from proxtpu_torch.kernels import tv as ttv
from proxtpu_torch.kernels.dispatch import match_tv_solver as t_match

B, H, W = 4, 16, 24
LAM = 0.12
TOL = 1e-4
MAXIT = 4000


def _noisy(dtype=np.float32):
    rng = np.random.default_rng(0)
    clean = np.zeros((B, H, W), np.float32)
    clean[:, H // 4: 3 * H // 4, W // 4: 3 * W // 4] = 1.0
    return (clean + 0.15 * rng.standard_normal((B, H, W))
            .astype(np.float32)).astype(dtype)


def _kw(lam=LAM, dtype=np.float32, **extra):
    return dict(x0=jnp.zeros((B, H, W), dtype),
                y0=jnp.zeros((B, 2, H, W), dtype),
                g=JSqrDistance(jnp.asarray(_noisy(dtype))),
                h=JNormL21(lam, axis=0), L=JGrad2D((H, W)), **extra)


def _to_port(v):
    """The port's counterpart of one JAX kwarg value."""
    if isinstance(v, tuple):
        return tuple(_to_port(e) for e in v)
    if hasattr(v, "matvec"):
        return pt.linop_from_jax(v, device="cpu")
    if type(v).__module__.startswith("proxtpu.prox"):
        return pt.prox_from_jax(v, device="cpu")
    if hasattr(v, "shape"):
        return torch.tensor(np.asarray(v))
    return v


def _without(kw, key):
    return {k: v for k, v in kw.items() if k != key}


_ones = jnp.ones((B, H, W), jnp.float32)
_lams = jnp.asarray([0.05, 0.1, 0.15, 0.2], jnp.float32)
_stop = lambda it, tol, s: True  # noqa: E731

# name -> (factory, kwargs, matcher options, matches)
_CASES = {
    "chambolle_pock": ("make_chambolle_pock_iteration", _kw(), {}, True),
    "afba_theta2": ("make_afba_iteration", _kw(theta=2.0), {}, True),
    "afba_theta2_defaults_spelt": (
        "make_afba_iteration", _kw(theta=2.0, f=JZero(), beta_f=0.0), {},
        True),
    "afba_theta1": ("make_afba_iteration", _kw(theta=1.0), {}, False),
    "afba_default_theta": ("make_afba_iteration", _kw(), {}, False),
    "afba_theta_not_a_number": ("make_afba_iteration", _kw(theta="two"), {},
                                False),
    "vu_condat": ("make_vu_condat_iteration", _kw(), {}, True),
    "vu_condat_smooth_f": ("make_vu_condat_iteration",
                           _kw(f=JSqrNormL2(1.0), beta_f=1.0), {}, False),
    "vu_condat_l": ("make_vu_condat_iteration",
                    _kw(l=JSqrNormL2(1.0), beta_l=1.0), {}, False),
    "other_factory": ("make_fast_forward_backward_iteration", _kw(), {},
                      False),
    "per_image_lam": ("make_chambolle_pock_iteration", _kw(lam=_lams), {},
                      True),
    "lam_wrong_length": ("make_chambolle_pock_iteration",
                         _kw(lam=_lams[:3]), {}, False),
    "lam_a_plane": ("make_chambolle_pock_iteration",
                    _kw(lam=jnp.ones((B, 1), jnp.float32)), {}, False),
    "float64": ("make_chambolle_pock_iteration", _kw(dtype=np.float64), {},
                True),
    "nonzero_x0": ("make_chambolle_pock_iteration", dict(_kw(), x0=_ones),
                   {}, False),
    "nonzero_y0": ("make_chambolle_pock_iteration",
                   dict(_kw(), y0=jnp.ones((B, 2, H, W), jnp.float32)), {},
                   False),
    "no_y0": ("make_chambolle_pock_iteration", _without(_kw(), "y0"), {},
              False),
    "x0_wrong_shape": ("make_chambolle_pock_iteration",
                       dict(_kw(), x0=jnp.zeros((B, H * W), jnp.float32)),
                       {}, False),
    "axis1": ("make_chambolle_pock_iteration",
              dict(_kw(), h=JNormL21(LAM, axis=1)), {}, False),
    "g_not_sqr_distance": ("make_chambolle_pock_iteration",
                           dict(_kw(), g=JSqrNormL2(1.0)), {}, False),
    "single_image": ("make_chambolle_pock_iteration",
                     dict(_kw(), g=JSqrDistance(jnp.asarray(_noisy()[0]))),
                     {}, False),
    "operator_shape": ("make_chambolle_pock_iteration",
                       dict(_kw(), L=JGrad2D((H, W + 1))), {}, False),
    "no_operator": ("make_chambolle_pock_iteration", _without(_kw(), "L"),
                    {}, False),
    "relaxation": ("make_chambolle_pock_iteration",
                   _kw(lam=LAM) | dict(lam=0.5, gamma1=0.3, gamma2=0.3), {},
                   False),
    "beta_f": ("make_chambolle_pock_iteration", _kw(beta_f=1.0), {}, False),
    "custom_stop": ("make_chambolle_pock_iteration", _kw(),
                    dict(stop=_stop), False),
    "custom_solution": ("make_chambolle_pock_iteration", _kw(),
                        dict(solution=lambda it, s: s.x), False),
    "gamma_pair": ("make_chambolle_pock_iteration", _kw(gamma=(0.3, 0.3)),
                   {}, True),
    "gamma_not_a_pair": ("make_chambolle_pock_iteration", _kw(gamma=0.3),
                         {}, False),
    "gamma1_per_image": ("make_chambolle_pock_iteration",
                         _kw(gamma1=jnp.full((B,), 0.3, jnp.float32)), {},
                         True),
    "gamma2_wrong_length": ("make_chambolle_pock_iteration",
                            _kw(gamma2=jnp.full((B + 1,), 0.3,
                                                jnp.float32)), {}, False),
}


@pytest.mark.parametrize("case", list(_CASES))
def test_match_decisions_equal_jax(case):
    name, kw, opts, matches = _CASES[case]
    j_factory = getattr(jpd, name, None) or (lambda **k: None)
    if not hasattr(jpd, name):
        j_factory.__name__ = name
    t_factory = getattr(pt, name)
    j_run = j_match(j_factory, kw, tol=TOL, maxit=MAXIT, **opts)
    t_run = t_match(t_factory, {k: _to_port(v) for k, v in kw.items()},
                    tol=TOL, maxit=MAXIT, **opts)
    assert (j_run is not None) == matches
    assert (t_run is not None) == matches


@pytest.fixture
def calls(monkeypatch):
    """Record the calls of ``solve_tv_batch`` and of the kernel wrapper."""
    seen = {"solve": [], "steps": 0}
    solve, steps = ttv.solve_tv_batch, ttv.fused_cp_k_steps

    def spy_solve(*args, **kwargs):
        seen["solve"].append(kwargs)
        return solve(*args, **kwargs)

    def spy_steps(*args, **kwargs):
        seen["steps"] += 1
        return steps(*args, **kwargs)

    monkeypatch.setattr(ttv, "solve_tv_batch", spy_solve)
    monkeypatch.setattr(ttv, "fused_cp_k_steps", spy_steps)
    return seen


def _port_solver(**opts):
    return pt.BatchedAlgorithm(pt.make_chambolle_pock_iteration,
                               maxit=MAXIT, tol=TOL, **opts)


@pytest.mark.parametrize("lam", ["uniform", "per_image"])
def test_batched_algorithm_takes_the_tv_route(calls, lam):
    """The TV problem reaches solve_tv_batch and the kernel wrapper, and
    comes back in the generic driver's structure, within the reference's
    contract of the port's generic driver and of JAX's kernel route."""
    kw = _kw(lam=LAM if lam == "uniform" else _lams)
    t_kw = {k: _to_port(v) for k, v in kw.items()}
    (x, y), it, d = _port_solver()(**t_kw)
    assert len(calls["solve"]) == 1 and calls["steps"] > 1
    assert calls["solve"][0]["use_kernel"] and calls["solve"][0]["return_dual"]
    assert x.shape == (B, H, W) and y.shape == (B, 2, H, W)
    assert it.dtype == torch.int32 and bool(d.all())

    calls["steps"] = 0
    (x_g, y_g), it_g, d_g = _port_solver(use_kernels=False)(**t_kw)
    assert len(calls["solve"]) == 1 and calls["steps"] == 0
    assert bool(d_g.all())
    # the dual field is held where the reference's own test holds it: at
    # a uniform lam (it settles more slowly than x)
    held = [(x, x_g)] + ([(y, y_g)] if lam == "uniform" else [])
    for got, want in held:
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=1e-3)
    # sampled every 8 iterations, a count is an upper bound; at a uniform
    # lam it stays within one block, as the reference's test has it
    assert bool((it + 1 >= it_g).all())
    assert lam == "per_image" or bool((it - it_g < 8).all())

    (x_j, y_j), it_j, d_j = JBatched(jpd.make_chambolle_pock_iteration,
                                     maxit=MAXIT, tol=TOL,
                                     use_kernels="interpret")(**kw)
    assert bool(np.asarray(d_j).all())
    np.testing.assert_allclose(x.numpy(), np.asarray(x_j), rtol=0, atol=1e-4)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), rtol=0, atol=1e-3)
    assert int(np.abs(it.numpy() - np.asarray(it_j)).max()) <= 8


def test_float64_takes_the_plain_step(calls):
    kw = {k: _to_port(v) for k, v in _kw(dtype=np.float64).items()}
    (x, y), it, d = _port_solver()(**kw)
    assert len(calls["solve"]) == 1 and calls["steps"] == 0
    assert not calls["solve"][0]["use_kernel"]
    assert x.dtype == y.dtype == torch.float64 and bool(d.all())
    (x_j, _), it_j, _ = JBatched(jpd.make_chambolle_pock_iteration,
                                 maxit=MAXIT, tol=TOL)(**_kw(dtype=np.float64))
    np.testing.assert_array_equal(it.numpy(), np.asarray(it_j))
    np.testing.assert_allclose(x.numpy(), np.asarray(x_j), rtol=0, atol=1e-10)


@pytest.mark.parametrize("opts", [dict(verbose=True, freq=10_000),
                                  dict(halt_nonfinite=True),
                                  dict(stop=lambda it, tol, s:
                                       it.default_stopping_criterion(tol, s))])
def test_generic_only_options_skip_the_tv_route(calls, opts):
    kw = {k: _to_port(v) for k, v in _kw().items()}
    (x, y), it, d = _port_solver(**opts)(**kw)
    assert calls["solve"] == [] and calls["steps"] == 0
    assert bool(d.all()) and y.shape == (B, 2, H, W)


def test_afba_theta2_runs_the_tv_route(calls):
    kw = {k: _to_port(v) for k, v in _kw(theta=2.0).items()}
    (x, _), it, d = pt.BatchedAlgorithm(pt.make_afba_iteration, maxit=MAXIT,
                                        tol=TOL)(**kw)
    assert len(calls["solve"]) == 1 and bool(d.all())
    (x_cp, _), it_cp, _ = _port_solver()(**_without(kw, "theta"))
    assert torch.equal(x, x_cp) and torch.equal(it, it_cp)
