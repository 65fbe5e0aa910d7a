"""The tp layout on the shared-A solver, the flat machines and the
least squares' prox: one ``Shared`` operand in row stripes over a ``tp``
mesh axis, lanes over ``dp``, through ``BatchedAlgorithm``.

In this process, on a module-scoped Gloo group of world size 1 (a (1, 1)
mesh, as ``tests/test_torch_dp_tp.py``): every route placed is
``torch.equal`` to its unplaced run, takes its route (the shared-A core
called with the tp group, or the flat machine's trips, shown by
``spmd_worker.tp_route_seen``) and runs the design's collectives (one
all-reduce at init and one a step on the shared-A leg; two an oracle round
of the line searches, so two a trip of PANOC and ZeroFPR and four of
PANOCplus; one a trip of adaptive FB, two of adaptive FISTA);
``solve_lasso_multirhs`` on DTensors gives the same bits; in float64 the
port gives the JAX package's counts and its solutions within 1e-9; the
refusals that remain name what they refuse.  DRLS and Douglas-Rachford
on the least squares' prox (``LS_ROUTES``) are held so at (1, 1) in
``tests/test_torch_tp_drls.py``.

On 4 Gloo ranks as a (2, 2) mesh (``python -m
proxtpu_torch.tools.spmd_worker --ranks 4 --cases tp``, started once, which
asserts the collectives, tp ranks bit-equal and the bits of the stripes
emulated in one process), rank 0's outputs against the JAX package on its
8-virtual-device mesh with A on ``P("tp", None)``, b on ``P("tp")`` and the
lanes on ``P("dp")``: float64 equal counts and 1e-9; float32 the JAX dp x
tp test's contract (``tests/test_sharding.py:520-535``: 75% of counts
equal, 1e-3, and every lane's float64 recheck within 1.2 tol).

The worker also runs ``LS_ROUTES``: DRLS (a trip) and Douglas-Rachford (a
step of the generic driver) make one prox of ``Shared(make_least_squares(A,
b))``, three all-reduces on the wide problem, one on the tall one (routes
"*_tall", ``spmd_worker.dp_x_tp_data(M=48)``, whose least squares sums
``A^H A`` over the stripes), and ``make_least_squares`` on DTensors gives
the same bits.
"""

import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import NamedSharding, PartitionSpec as P

import proxtpu_torch as pt
import proxtpu_torch.parallel as tpar
from proxtpu_torch.ops.linops import MatrixOperator
from proxtpu_torch.parallel.sharded_ops import (
    COLLECTIVES,
    _place,
    full_tensor,
    shard_rows,
)
from proxtpu_torch.prox import NormL1, SqrDistance
from proxtpu_torch.tools import spmd_worker as w

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL, MAXIT = w.TP_LEGS_TOL, w.TP_LEGS_MAXIT
ROUTES = ("multirhs", "panoc", "zerofpr", "panocplus", "adaptive_fb",
          "adaptive_fista")
# the least squares' prox over tp; at (1, 1) in tests/test_torch_tp_drls.py
LS_ROUTES = ("drls", "douglas_rachford", "drls_tall",
             "douglas_rachford_tall")
# more routes on Shared(make_least_squares(A, b)) (and "*_tall"), at (1, 1)
# in tests/test_torch_tp_drls.py: (factory, Lf given, use_kernels)
LS_MORE_ROUTES = {
    "panoc_ls": ("make_panoc_iteration", True, "auto"),
    "zerofpr_ls": ("make_zerofpr_iteration", True, "auto"),
    "fista_ls": ("make_fast_forward_backward_iteration", True, "auto"),
    "adaptive_fista_ls": ("make_fast_forward_backward_iteration", False,
                          "auto"),
    "drls_generic": ("make_drls_iteration", True, False),
}
DTYPES = (np.float32, np.float64)
TIMEOUT = 240


class _Run:
    """The four-rank worker, started once; ``result()`` waits for it and
    loads rank 0's outputs."""

    def __init__(self, out):
        self.path = os.path.join(out, "spmd.npz")
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (ROOT, env.get("PYTHONPATH")) if p)
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "proxtpu_torch.tools.spmd_worker",
             "--ranks", "4", "--backend", "gloo", "--device", "cpu",
             "--cases", "tp", "--out", out, "--timeout", str(TIMEOUT)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env, cwd=ROOT)
        self._out = None

    def result(self):
        if self._out is None:
            try:
                log, _ = self.proc.communicate(timeout=TIMEOUT + 30)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                log, _ = self.proc.communicate()
                pytest.fail("spmd_worker timed out:\n" + log)
            assert self.proc.returncode == 0, "spmd_worker failed:\n" + log
            with np.load(self.path) as f:
                self._out = {k.split("__", 1)[1]: f[k] for k in f.files}
        return self._out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    r = _Run(str(tmp_path_factory.mktemp("spmd_tp")))
    yield r
    if r.proc.poll() is None:
        r.proc.kill()
        r.proc.communicate()


@pytest.fixture(scope="module")
def group(run):
    # after the worker has started, so that both run at once
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


_JAX = {}


def jax_run(route, dtype):
    """The JAX package's ``BatchedAlgorithm`` on the route's problem
    (``spmd_worker.tp_data``) on its (4, 2) mesh, A in row stripes over tp
    and the lanes over dp; cached.  ``LS_MORE_ROUTES``: on
    ``Shared(make_least_squares(A, b))``."""
    key = (route, np.dtype(dtype).name)
    if key not in _JAX:
        from proxtpu import algorithms as jalg
        from proxtpu.algorithms import (
            make_douglas_rachford_iteration,
            make_drls_iteration,
            make_fast_forward_backward_iteration,
            make_forward_backward_iteration,
            make_panoc_iteration,
            make_panocplus_iteration,
            make_zerofpr_iteration,
        )
        from proxtpu.ops.linops import MatrixOperator as JMatrixOperator
        from proxtpu.parallel import BatchedAlgorithm, Shared, make_mesh
        from proxtpu.prox import LeastSquaresLoss as JLeastSquaresLoss
        from proxtpu.prox import NormL1 as JNormL1
        from proxtpu.prox import SqrDistance as JSqrDistance
        from proxtpu.prox import make_least_squares as jmake_least_squares

        jmesh = make_mesh((4, 2), ("dp", "tp"))
        A, b, lam, Lf = w.tp_data(route, dtype)

        def put(v, *spec):
            return jax.device_put(jnp.asarray(v), NamedSharding(jmesh,
                                                                P(*spec)))

        A, b, lam = put(A, "tp", None), put(b, "tp"), put(lam, "dp")
        kw = dict(x0=put(np.zeros((len(lam), A.shape[1]), dtype), "dp",
                         None), g=JNormL1(lam))
        base, opts = route.removesuffix("_tall"), {}
        if base in LS_MORE_ROUTES:
            name, with_lf, opts["use_kernels"] = LS_MORE_ROUTES[base]
            factory = getattr(jalg, name)
            kw["f"] = Shared(jmake_least_squares(A, b))
            if with_lf:
                kw["Lf"] = Lf
        elif base in ("drls", "douglas_rachford"):
            factory = (make_drls_iteration if base == "drls"
                       else make_douglas_rachford_iteration)
            kw["f"] = Shared(jmake_least_squares(A, b))
            if base == "douglas_rachford":
                kw["gamma"] = w.DR_GAMMA_LF / Lf
            else:
                kw["Lf"] = Lf
        elif route in ("panoc", "zerofpr", "panocplus"):
            factory = {"panoc": make_panoc_iteration,
                       "zerofpr": make_zerofpr_iteration,
                       "panocplus": make_panocplus_iteration}[route]
            kw.update(f=Shared(JSqrDistance(b)),
                      A=Shared(JMatrixOperator(A)), Lf=Lf)
        else:
            factory = (make_forward_backward_iteration
                       if route == "adaptive_fb"
                       else make_fast_forward_backward_iteration)
            kw["f"] = Shared(JLeastSquaresLoss(A, b))
            if route == "multirhs":
                kw["Lf"] = Lf
        _JAX[key] = tuple(np.asarray(v) for v in BatchedAlgorithm(
            factory, maxit=MAXIT, tol=TOL, **opts)(**kw))
    return _JAX[key]


def recheck(route, dtype, z):
    """Every lane's float64 forward-backward residual at the route's
    fixed step: ``1 / Lf`` for FISTA, the line searches' and DRLS's
    ``0.95 / Lf``, Douglas-Rachford's ``DR_GAMMA_LF / Lf``; the adaptive
    machines are held at ``1 / Lf``, the largest step the smoothness
    certifies.  At a step gamma it is the Douglas-Rachford residual
    ``||u - v|| / gamma`` at the point ``x = z + gamma grad f(z)``, whose
    ``u = prox_f(x)`` is ``z``."""
    A, b, lam, Lf = w.tp_data(route, dtype)
    if route.startswith("douglas"):
        gamma = w.DR_GAMMA_LF / Lf
    elif route in ("panoc", "zerofpr", "panocplus") or route.startswith(
            "drls"):
        gamma = 0.95 / Lf
    else:
        gamma = 1.0 / Lf
    A, b, x = (np.asarray(v, np.float64) for v in (A, b, z))
    y = x - gamma * ((x @ A.T - b) @ A)
    zz = np.sign(y) * np.maximum(np.abs(y) - gamma * lam[:, None], 0.0)
    return np.max(np.abs(x - zz), axis=1) / gamma


# ---------------------------------------------------------------------------
# one process: a (1, 1) mesh


def world_one_is_the_unplaced_run(mesh, route, dtype):
    """The route placed on the (1, 1) mesh: ``torch.equal`` to its
    unplaced run, on the same route, with the design's collectives."""
    solve, kwargs = w.tp_problem(route, w.tp_data(route, dtype), "cpu",
                                 MAXIT, TOL)
    with w.tp_route_seen() as seen:
        plain = solve(**kwargs)
    # unplaced, the same route: the core without a group, or the trips or
    # generic steps with no collective
    kind = "steps" if route.startswith("douglas") else "trips"
    if route == "multirhs":
        assert seen["multirhs"] == [None]
    else:
        assert seen[kind] and set(seen[kind]) == {0}
    gathers = COLLECTIVES["all_gather"]
    out, _, reduces, steps = w.tp_leg_solve(mesh, route, solve, kwargs,
                                            MAXIT)
    # the all-gathers: the line searches' SqrDistance b, whole once before
    # the trips, the wide least squares' stripes once at set-up, and the
    # solution gathered over tp by tp_leg_solve
    assert COLLECTIVES["all_gather"] - gathers == 1 + (
        route in ("panoc", "zerofpr", "panocplus", "drls",
                  "douglas_rachford"))
    assert [str(p) for p in out[0].placements] == ["S(0)", "R"]
    assert all(torch.equal(full_tensor(o), p) for o, p in zip(out, plain))
    assert bool(plain[2].all())
    if route == "multirhs":
        assert steps == w.steps_run(plain[1], 16, MAXIT)
    else:
        # as many trips or steps as unplaced, and the init's and the
        # set-up's all-reduces beside
        assert steps == len(seen[kind])
        assert reduces >= w.TP_ROUTES[route] * steps


@pytest.mark.parametrize("dtype", DTYPES, ids=["float32", "float64"])
@pytest.mark.parametrize("route", ROUTES)
def test_world_one_route_is_the_unplaced_run(mesh, route, dtype):
    world_one_is_the_unplaced_run(mesh, route, dtype)


def world_one_matches_jax_float64(mesh, route):
    """The route placed on the (1, 1) mesh in float64: the JAX package's
    counts on its (4, 2) mesh, solutions within 1e-9."""
    solve, kwargs = w.tp_problem(route, w.tp_data(route, np.float64), "cpu",
                                 MAXIT, TOL)
    z, k, d = (full_tensor(v).numpy()
               for v in solve(**w.place_tp(kwargs, mesh)))
    zj, kj, dj = jax_run(route, np.float64)
    assert d.all() and dj.all()
    np.testing.assert_array_equal(k, kj)
    np.testing.assert_allclose(z, zj, atol=1e-9)


@pytest.mark.parametrize("route", ROUTES)
def test_world_one_route_matches_jax_float64(mesh, route):
    world_one_matches_jax_float64(mesh, route)


@pytest.mark.parametrize("cols", [None, "tp"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["float32", "float64"])
def test_world_one_multirhs_on_dtensors(mesh, dtype, cols):
    """``solve_lasso_multirhs`` on placed arrays, as GSPMD takes them: A
    ``Shard(0)`` over tp, Bmat's lanes over dp with its columns replicated
    (narrowed to the stripe's rows) or ``Shard(1)`` over tp: the unplaced
    bits, one all-reduce at init and one a step."""
    from proxtpu_torch.kernels.lasso import solve_lasso_multirhs

    A, b, lam, Lf = (torch.tensor(v) if isinstance(v, np.ndarray) else v
                     for v in w.dp_x_tp_data(dtype))
    Bmat = b.expand(len(lam), -1).contiguous()
    plain = solve_lasso_multirhs(A, Bmat, lam, Lf, TOL, maxit=MAXIT)
    before = COLLECTIVES["all_reduce"]
    out = solve_lasso_multirhs(
        _place(A, mesh, ("tp", None)), _place(Bmat, mesh, ("dp", cols)),
        tpar.shard_batch(lam, mesh, "dp"), Lf, TOL, maxit=MAXIT)
    assert COLLECTIVES["all_reduce"] - before == 1 + w.steps_run(
        plain[1], 16, MAXIT)
    assert [str(p) for p in out[0].placements] == ["S(0)", "R"]
    assert all(torch.equal(full_tensor(o), p) for o, p in zip(out, plain))


def test_entry_runs_on_the_card_unless_asked(monkeypatch):
    """``graft_entry.entry()`` builds on the card, and without one it
    raises (no fallback to the CPU); ``entry("cpu")`` is
    ``__graft_entry__.entry``'s step."""
    import __graft_entry__ as jentry
    from proxtpu_torch.tools import graft_entry

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.entry()
    monkeypatch.undo()
    jfn, (jit, js) = jentry.entry()
    tfn, (tit, ts) = graft_entry.entry("cpu")
    assert tit.x0.device.type == "cpu"
    sj, st = jfn(jit, js), tfn(tit, ts)
    for name in ("x", "z", "res"):
        np.testing.assert_allclose(getattr(st, name).numpy(),
                                   np.asarray(getattr(sj, name)),
                                   atol=1e-5, err_msg=name)


def _rows(value, mesh, axis="tp"):
    return shard_rows(tpar.Shared(value), mesh, axis)


@pytest.mark.parametrize("layout", [
    "column stripes", "b over dp", "no operator beside",
    "multirhs b over dp"])
def test_refusals_name_what_they_refuse(mesh, layout):
    """What still refuses row stripes, by message: a column-sharded
    operator, b in other stripes than A, another class in stripes with no
    row-sharded operator beside it, and ``solve_lasso_multirhs`` with
    Bmat's columns split over another axis than A's rows."""
    import torch.distributed.tensor as dt

    from proxtpu_torch.kernels.lasso import solve_lasso_multirhs

    A, b, lam, Lf = (torch.tensor(v) if isinstance(v, np.ndarray) else v
                     for v in w.dp_x_tp_data(np.float64))
    lanes = tpar.shard_batch(dict(x0=torch.zeros((len(lam), A.shape[1]),
                                                 dtype=A.dtype),
                                  g=NormL1(lam)), mesh, "dp")
    panoc = tpar.BatchedAlgorithm(pt.make_panoc_iteration, maxit=10, tol=TOL)
    if layout == "column stripes":
        cols = dt.DTensor.from_local(A, mesh, [dt.Replicate(), dt.Shard(1)],
                                     run_check=False)
        with pytest.raises(ValueError, match=(
                r"MatrixOperator under a Shared marker: A has placements "
                r"\(Replicate\(\), Shard\(dim=1\)\)")):
            panoc(f=_rows(SqrDistance(b), mesh),
                  A=tpar.Shared(MatrixOperator(cols)), Lf=Lf, **lanes)
    elif layout == "b over dp":
        with pytest.raises(ValueError, match=(
                r"SqrDistance under a Shared marker holds sharded tensors "
                r"\[\(Shard\(dim=0\), Replicate\(\)\)\]")):
            panoc(f=_rows(SqrDistance(b), mesh, "dp"),
                  A=_rows(MatrixOperator(A), mesh), Lf=Lf, **lanes)
    elif layout == "no operator beside":
        with pytest.raises(ValueError, match=(
                r"SqrDistance under a Shared marker holds sharded tensors "
                r".*only in the row stripes of a MatrixOperator beside it")):
            tpar.BatchedAlgorithm(pt.make_fast_forward_backward_iteration,
                                  maxit=10, tol=TOL)(
                f=_rows(SqrDistance(b), mesh), **lanes)
    else:
        Bmat = b.expand(len(lam), -1).contiguous()
        with pytest.raises(ValueError, match=(
                r"solve_lasso_multirhs: A in row stripes .* and Bmat "
                r"\(Shard\(dim=1\), Replicate\(\)\)")):
            solve_lasso_multirhs(_place(A, mesh, ("tp", None)),
                                 _place(Bmat, mesh, (None, "dp")), lam, Lf,
                                 TOL, maxit=10)


# ---------------------------------------------------------------------------
# four ranks: a (2, 2) mesh


@pytest.mark.parametrize("dtype", DTYPES, ids=["float32", "float64"])
@pytest.mark.parametrize("route", ROUTES + LS_ROUTES)
def test_four_ranks_match_jax(run, route, dtype):
    """Float64: equal counts and 1e-9.  Float32: every lane done in both
    packages, 1e-3, every lane of both under 1.2 tol by the float64
    recheck, and on the FISTA routes (the shared-A leg, adaptive FISTA)
    the JAX test's 75% of equal counts.  The flat line searches and
    adaptive FB part from the JAX package by an iteration or a few on
    most lanes in float32 with no tp at all (the port unplaced against
    the JAX package unplaced on this problem: 5 of 16 counts equal for
    PANOC and PANOCplus, 6 for adaptive FB; the L-BFGS directions and the
    step search amplify last bits), so there the lanes apart in count
    are held by the recheck, as ``tests/test_torch_multiprocess.py``'s
    ``_lanes_close`` holds knife-edge lanes.  On the least squares' prox
    (``LS_ROUTES``) only the port's float32 answer is held by the
    recheck: the JAX package factors the Gram matrix in float32 (the port
    in float64), and its prox is only as exact as those factors (its
    Douglas-Rachford answer on the wide problem rechecks at 1.31e-5, its
    DRLS on the tall one at 1.22e-5)."""
    name = np.dtype(dtype).name
    # the JAX package's run first: it overlaps the worker's
    zj, kj, dj = jax_run(route, dtype)
    port = run.result()
    z, k, done = (port[f"{key}_{route}_{name}"]
                  for key in ("z", "it", "done"))
    reduces, steps = port[f"reduces_{route}_{name}"]
    assert steps > 0 and reduces >= w.TP_ROUTES[route] * steps
    assert done.all() and dj.all()
    if dtype == np.float64:
        np.testing.assert_array_equal(k, kj)
        np.testing.assert_allclose(z, zj, atol=1e-9)
    else:
        if route in ("multirhs", "adaptive_fista"):
            assert (k == kj).mean() >= 0.75, (k, kj)
        np.testing.assert_allclose(z, zj, atol=1e-3)
        for x in (z,) if route in LS_ROUTES else (z, zj):
            assert recheck(route, dtype, x).max() <= 1.2 * TOL
