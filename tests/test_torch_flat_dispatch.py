"""``BatchedAlgorithm``'s routes to the flat machines, in the port and in
the JAX package, on the CPU.

With spies on both packages' runners (the flat machines, the generic
driver, the kernel and TV matchers), the same problems and options go
through both ``BatchedAlgorithm``s: the port takes the flat route exactly
where the JAX package does (adaptive FB / FISTA, fixed and adaptive PANOC
and ZeroFPR, PANOCplus, DRLS), with the same trips between host tests
(``check_every``), and keeps every other problem on its earlier route.
Then a few solves on the default route against the JAX package's (counts
exact, solutions within 1e-9 in float64), and the edge options that must
keep the generic driver's semantics (a port of
``tests/test_flat_ls.py::test_dispatch_preserves_driver_semantics_on_edge_kwargs``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import proxtpu as pa
import proxtpu.kernels.dispatch as jd
import proxtpu.parallel as jpar
import proxtpu.parallel.adaptive_batch as jab
import proxtpu.parallel.batch as jbatch
import proxtpu_torch as pt
import proxtpu_torch.kernels.dispatch as td
import proxtpu_torch.parallel as tpar
import proxtpu_torch.parallel.adaptive_batch as tab
import proxtpu_torch.parallel.batch as tbatch
from proxtpu.ops.linops import MatrixOperator as JMatrix
from proxtpu.prox import functions as jf
from proxtpu.utils.shared import Shared as JShared
from proxtpu_torch.prox import functions as tf
from proxtpu_torch.utils.shared import Shared as TShared
from test_torch_flat_ls import B, N, TOL, assert_same, lasso, \
    stacked_least_squares

jax.config.update("jax_enable_x64", True)

FLAT = ("batched_panoc", "batched_zerofpr", "batched_panocplus",
        "batched_drls")
ADAPTIVE = ("batched_adaptive_fb", "batched_adaptive_fista")


class Routed(Exception):
    pass


def _spy(name, record):
    def spy(*args, **kw):
        record.append((name, kw.get("check_every")))
        raise Routed(name)
    return spy


def _matcher_spy(real, name, record):
    def spy(*args, **kw):
        run = real(*args, **kw)
        if run is None:
            return None
        return _spy(name, record)
    return spy


def route(monkeypatch, lib, factory, kw, **opts):
    """``(runner, check_every)`` that ``BatchedAlgorithm(factory,
    **opts)(**kw)`` of ``lib`` ("jax" or "torch") reaches, no solve run:
    a flat runner's name, "generic", "kernel", "tv", or the exception the
    call raised."""
    par, ab, batch, disp = ((jpar, jab, jbatch, jd) if lib == "jax"
                            else (tpar, tab, tbatch, td))
    record = []
    for name in FLAT:
        monkeypatch.setattr(par, name, _spy(name, record))
    for name in ADAPTIVE:
        monkeypatch.setattr(ab, name, _spy(name, record))
    monkeypatch.setattr(batch, "batched_run_loop", _spy("generic", record))
    for name, label in (("match_kernel_solver", "kernel"),
                        ("match_tv_solver", "tv")):
        monkeypatch.setattr(disp, name,
                            _matcher_spy(getattr(disp, name), label, record))
    Batched = jpar.BatchedAlgorithm if lib == "jax" else pt.BatchedAlgorithm
    try:
        Batched(factory, maxit=50, tol=TOL, **opts)(**kw)
    except Routed:
        return record[0]
    except Exception:  # the factory's own error
        return "raises", None
    return "returned", None


def problem(kind, lib, seed=0):
    """Stacked problem kwargs for ``lib``: ``ls`` (SqrDistance + A +
    NormL1, the line-search form), ``fb`` (LeastSquaresLoss + NormL1),
    ``drls`` (stacked least squares with a prox)."""
    A, b, lam, Lf = lasso(seed)
    if lib == "jax":
        c, x0 = jnp.asarray, jnp.zeros((B, N))
        mods = jf
    else:
        c, x0 = torch.tensor, torch.zeros(B, N, dtype=torch.float64)
        mods = tf
    if kind == "ls":
        return dict(x0=x0, f=mods.SqrDistance(c(b)), A=c(A),
                    g=mods.NormL1(c(lam))), Lf
    if kind == "fb":
        # every leaf of a JAX problem carries the batch axis (lam too);
        # the port's lam, a number, is not mapped
        f = (jax.vmap(jf.LeastSquaresLoss)(c(A), c(b)) if lib == "jax"
             else tf.LeastSquaresLoss(c(A), c(b)))
        return dict(x0=x0, f=f, g=mods.NormL1(c(lam))), Lf
    f = (jax.vmap(jf.make_least_squares)(c(A), c(b)) if lib == "jax"
         else stacked_least_squares(A, b))
    return dict(x0=x0, f=f, g=mods.NormL1(c(lam))), Lf


def _lf(lib, Lf):
    return jnp.asarray(Lf) if lib == "jax" else torch.tensor(Lf)


# (factory name, problem kind, extra kwargs, BatchedAlgorithm options)
CASES = {
    "fb_adaptive": ("make_forward_backward_iteration", "fb", {}, {}),
    "fista_adaptive": ("make_fast_forward_backward_iteration", "fb", {}, {}),
    "fb_adaptive_lf": ("make_forward_backward_iteration", "fb",
                       {"adaptive": True, "Lf": "Lf"}, {}),
    "fista_adaptive_k3": ("make_fast_forward_backward_iteration", "fb", {},
                          {"check_every": 3}),
    "fista_sequence": ("make_fast_forward_backward_iteration", "fb",
                       {"extrapolation_sequence": "restart"}, {}),
    "fista_backtrack_limit": ("make_fast_forward_backward_iteration", "fb",
                              {"backtrack_limit": 4}, {}),
    "fista_mf_array": ("make_fast_forward_backward_iteration", "fb",
                       {"mf": "array"}, {}),
    "panoc_lf": ("make_panoc_iteration", "ls", {"Lf": "Lf"}, {}),
    "panoc_adaptive_gamma": ("make_panoc_iteration", "ls",
                             {"adaptive": True, "gamma": "gamma"}, {}),
    "panoc_cold": ("make_panoc_iteration", "ls", {"adaptive": True}, {}),
    "panoc_no_step": ("make_panoc_iteration", "ls", {}, {}),
    "panoc_fixed_no_step": ("make_panoc_iteration", "ls",
                            {"adaptive": False}, {}),
    "panoc_adaptive_limit": ("make_panoc_iteration", "ls",
                             {"adaptive": True, "gamma": "gamma",
                              "backtrack_limit": 2}, {}),
    "panoc_fixed_limit": ("make_panoc_iteration", "ls",
                          {"Lf": "Lf", "backtrack_limit": 2}, {}),
    "panoc_shared_a": ("make_panoc_iteration", "ls",
                       {"Lf": "Lf", "A": "shared"}, {}),
    "panoc_2d_a": ("make_panoc_iteration", "ls", {"Lf": "Lf", "A": "2d"}, {}),
    "panoc_nesterov": ("make_panoc_iteration", "ls",
                       {"Lf": "Lf", "directions": "nesterov"}, {}),
    "panoc_k4": ("make_panoc_iteration", "ls", {"Lf": "Lf"},
                 {"check_every": 4}),
    "panoc_no_kernels": ("make_panoc_iteration", "ls", {"Lf": "Lf"},
                         {"use_kernels": False}),
    "panoc_verbose": ("make_panoc_iteration", "ls", {"Lf": "Lf"},
                      {"verbose": True}),
    "panoc_halt_nonfinite": ("make_panoc_iteration", "ls", {"Lf": "Lf"},
                             {"halt_nonfinite": True}),
    "panoc_stop": ("make_panoc_iteration", "ls", {"Lf": "Lf"},
                   {"stop": "default"}),
    "panoc_solution": ("make_panoc_iteration", "ls", {"Lf": "Lf"},
                       {"solution": "default"}),
    "panoc_unknown_kwarg": ("make_panoc_iteration", "ls",
                            {"Lf": "Lf", "mu": 0.5}, {}),
    "panoc_bad_lane": ("make_panoc_iteration", "ls",
                       {"Lf": "Lf", "g": "short"}, {}),
    "zerofpr_lf": ("make_zerofpr_iteration", "ls", {"Lf": "Lf"}, {}),
    "zerofpr_adaptive": ("make_zerofpr_iteration", "ls",
                         {"adaptive": True}, {}),
    "panocplus_lf": ("make_panocplus_iteration", "ls", {"Lf": "Lf"}, {}),
    "panocplus_adaptive": ("make_panocplus_iteration", "ls",
                           {"adaptive": True, "Lf": "Lf"}, {}),
    "panocplus_no_step": ("make_panocplus_iteration", "ls", {}, {}),
    "drls_lf": ("make_drls_iteration", "drls", {"Lf": "Lf"}, {}),
    "drls_no_step": ("make_drls_iteration", "drls", {}, {}),
    "drls_nesterov": ("make_drls_iteration", "drls",
                      {"Lf": "Lf", "directions": "nesterov"}, {}),
    "drls_mf_array": ("make_drls_iteration", "drls", {"mf": "array"}, {}),
}


def build(lib, case):
    """``(factory, kwargs, options)`` of ``CASES[case]`` for ``lib``."""
    fac_name, kind, extra, opts = CASES[case]
    kw, Lf = problem(kind, lib)
    mod = pa if lib == "jax" else pt
    c = jnp.asarray if lib == "jax" else torch.tensor
    for k, v in extra.items():
        if v == "Lf":
            v = _lf(lib, Lf)
        elif v == "gamma":
            v = c(10 * 0.95 / Lf)
        elif v == "restart":
            v = mod.AdaptiveRestartSequence()
        elif v == "array":
            v = c(np.full(B, 0.1))
        elif v == "nesterov":
            v = mod.NesterovExtrapolation(mod.FixedNesterovSequence())
        elif v == "shared":
            A0 = lasso(0)[0][0]
            v = (JShared(JMatrix(c(A0))) if lib == "jax"
                 else TShared(pt.ops.linops.MatrixOperator(c(A0))))
        elif v == "2d":
            v = c(lasso(0)[0][0])
        elif v == "short":
            v = (jf.NormL1(c(np.full(B - 1, 0.1))) if lib == "jax"
                 else tf.NormL1(c(np.full(B - 1, 0.1))))
        kw[k] = v
    opts = dict(opts)
    for k in ("stop", "solution"):
        if opts.get(k) == "default":
            opts[k] = ((lambda it, tol, s: it.default_stopping_criterion(
                tol, s)) if k == "stop" else
                (lambda it, s: it.default_solution(s)))
    return getattr(mod, fac_name), kw, opts


@pytest.mark.parametrize("case", sorted(CASES))
def test_routes_match_jax(monkeypatch, case):
    j_route = route(monkeypatch, "jax", *build("jax", case)[:2],
                    **build("jax", case)[2])
    fac, kw, opts = build("torch", case)
    t_route = route(monkeypatch, "torch", fac, kw, **opts)
    assert t_route == j_route


# default-route solves against the JAX package's default route
SOLVES = ["panoc_lf", "zerofpr_lf", "panocplus_lf", "drls_lf",
          "fista_adaptive", "panoc_adaptive_gamma"]


@pytest.mark.parametrize("case", SOLVES)
def test_default_route_solves_match_jax(case):
    fac_j, kw_j, opts_j = build("jax", case)
    fac_t, kw_t, opts_t = build("torch", case)
    ref = jpar.BatchedAlgorithm(fac_j, maxit=2000, tol=TOL, **opts_j)(**kw_j)
    port = pt.BatchedAlgorithm(fac_t, maxit=2000, tol=TOL, **opts_t)(**kw_t)
    assert bool(port[2].all())
    assert_same(ref, port)


def test_edge_kwargs_keep_driver_semantics():
    """Explicit adaptive=False with no step runs a FIXED estimated gamma
    (the generic driver), and a caller's backtrack_limit cuts the gamma
    search short: both keep the generic driver, whose answer the default
    route then returns bit for bit; without the limit the flat route
    fires."""
    kw, Lf = problem("ls", "torch", seed=9)
    fixed = dict(kw, adaptive=False)
    assert td.match_flat_linesearch(pt.make_panoc_iteration, fixed,
                                    tol=1e-6, maxit=300) is None
    gamma0 = torch.tensor(100.0 * 0.95 / Lf)
    limited = dict(kw, adaptive=True, gamma=gamma0, backtrack_limit=2)
    assert td.match_flat_linesearch(pt.make_panoc_iteration, limited,
                                    tol=1e-6, maxit=300) is None
    for case in (fixed, limited):
        d = pt.BatchedAlgorithm(pt.make_panoc_iteration, maxit=300,
                                tol=1e-6)(**case)
        g = pt.BatchedAlgorithm(pt.make_panoc_iteration, maxit=300,
                                tol=1e-6, use_kernels=False)(**case)
        assert all(torch.equal(a, b) for a, b in zip(d, g))
    assert td.match_flat_linesearch(
        pt.make_panoc_iteration, dict(kw, adaptive=True, gamma=gamma0),
        tol=1e-6, maxit=300) is not None
