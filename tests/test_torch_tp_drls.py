"""DRLS and Douglas-Rachford on the least squares' prox in row stripes
over tp (``RowShardedLeastSquares``), in this process on a module-scoped
Gloo group of world size 1 (a (1, 1) mesh, as
``tests/test_torch_tp_legs.py``, whose four-rank worker also runs these
routes): ``shard_rows(Shared(make_least_squares(A, b)), mesh, "tp")``
placed is ``torch.equal`` to the unplaced run, through DRLS's flat
machine and Douglas-Rachford's generic driver, with the prox's
all-reduces a trip or step (three on the wide problem, one on the tall
one); in float64 the JAX package's counts on its (4, 2) mesh and
solutions within 1e-9; ``make_least_squares`` on DTensors gives the same
bits; PANOC, ZeroFPR and FISTA (the flat and the shared-A routes) and
DRLS on the generic driver run on the same f with no code of their own.
"""

import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist

import proxtpu_torch as pt
import proxtpu_torch.parallel as tpar
from proxtpu_torch.parallel.sharded_ops import _place, full_tensor, shard_rows
from proxtpu_torch.prox import NormL1, make_least_squares
from proxtpu_torch.tools import spmd_worker as w
from test_torch_tp_legs import (
    DTYPES,
    LS_MORE_ROUTES,
    LS_ROUTES,
    MAXIT,
    TOL,
    jax_run,
    world_one_is_the_unplaced_run,
    world_one_matches_jax_float64,
)


@pytest.fixture(scope="module")
def mesh():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    assert tpar.initialize_distributed(f"localhost:{port}", 1, 0,
                                       device_type="cpu") == 1
    yield tpar.make_mesh((1, 1), ("dp", "tp"), device_type="cpu")
    dist.destroy_process_group()


@pytest.mark.parametrize("dtype", DTYPES, ids=["float32", "float64"])
@pytest.mark.parametrize("route", LS_ROUTES)
def test_world_one_route_is_the_unplaced_run(mesh, route, dtype):
    world_one_is_the_unplaced_run(mesh, route, dtype)


@pytest.mark.parametrize("route", LS_ROUTES)
def test_world_one_route_matches_jax_float64(mesh, route):
    world_one_matches_jax_float64(mesh, route)


@pytest.mark.parametrize("dtype", DTYPES, ids=["float32", "float64"])
@pytest.mark.parametrize("route", ["drls", "drls_tall"])
def test_world_one_least_squares_on_dtensors(mesh, route, dtype):
    """The JAX package's spelling, ``Shared(make_least_squares(A, b))`` on
    DTensors in row stripes, gives the bits of ``shard_rows``' spelling
    (both the unplaced bits at (1, 1)); its factors are placed as a rank
    holds them."""
    solve, kwargs = w.tp_problem(route, w.tp_data(route, dtype), "cpu",
                                 MAXIT, TOL)
    ls = kwargs.pop("f").value
    lanes = w.place_tp(kwargs, mesh)
    A, b = _place(ls.A, mesh, ("tp", None)), _place(ls.b, mesh, ("tp",))
    placed = make_least_squares(A, b)
    assert [str(p) for p in placed.s.placements] == ["R", "R"]
    assert [str(p) for p in placed.U.placements] == (
        ["R", "R"] if route == "drls_tall" else ["R", "S(0)"])
    got = solve(f=tpar.Shared(placed), **lanes)
    want = solve(f=shard_rows(tpar.Shared(ls), mesh, "tp"), **lanes)
    assert all(torch.equal(full_tensor(g), full_tensor(v))
               for g, v in zip(got, want))
    assert all(torch.equal(full_tensor(g), p)
               for g, p in zip(got, solve(f=tpar.Shared(ls), **kwargs)))


@pytest.mark.parametrize("route", [
    r + tall for tall in ("", "_tall") for r in LS_MORE_ROUTES])
def test_world_one_least_squares_routes_match_jax(mesh, route):
    """More routes on ``Shared(make_least_squares(A, b))`` in row stripes,
    with no code of their own: the flat PANOC and ZeroFPR and adaptive
    FISTA reach its value and gradient (one all-reduce of N + 1 entries a
    lane), FISTA with ``Lf`` its stripes on the shared-A leg, DRLS on the
    generic driver its prox under the masked step search.  Placed, the
    unplaced bits; in float64 the JAX package's counts and solutions
    within 1e-9."""
    name, with_lf, use_kernels = LS_MORE_ROUTES[route.removesuffix("_tall")]
    A, b, lam, Lf = (torch.tensor(v) if isinstance(v, np.ndarray) else v
                     for v in w.tp_data(route, np.float64))
    solve = tpar.BatchedAlgorithm(getattr(pt, name), maxit=MAXIT, tol=TOL,
                                  use_kernels=use_kernels)
    kwargs = dict(x0=torch.zeros((len(lam), A.shape[1]), dtype=A.dtype),
                  g=NormL1(lam), **(dict(Lf=Lf) if with_lf else {}))
    f = tpar.Shared(make_least_squares(A, b))
    plain = solve(f=f, **kwargs)
    got = solve(f=shard_rows(f, mesh, "tp"), **w.place_tp(kwargs, mesh))
    assert all(torch.equal(full_tensor(g), p) for g, p in zip(got, plain))
    z, k, d = (v.numpy() for v in plain)
    zj, kj, dj = jax_run(route, np.float64)
    assert d.all() and dj.all()
    np.testing.assert_array_equal(k, kj)
    np.testing.assert_allclose(z, zj, atol=1e-9)


def main():
    """Route (ac)'s problem on the CPU (``spmd_worker.tp_card_data()``'s
    DRLS): the unplaced run against its stripes emulated on a (2, 2) mesh,
    each run's trips (the emulation's by dp block), the lanes apart in
    count, max|dx|, every lane's float64 recheck at 0.95 / Lf, and the
    PyTorch operations a trip of a dp block's run."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        ops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.ops += 1
            return func(*args, **(kwargs or {}))

    A, b, lam, Lf = w.tp_card_data()["drls"]
    runs = {}
    for name, parts, blocks in (("unplaced", None, 1),
                                ("stripes (2, 2)", 2, 2)):
        outs = []
        for i, block in enumerate(np.split(lam, blocks)):
            solve, kw = w.tp_problem("drls", (A, b, block, Lf), "cpu",
                                     w.SHARED_TP_MAXIT, w.SHARED_TP_TOL,
                                     parts=parts)
            Count.ops = 0
            with w.tp_route_seen() as seen, Count():
                outs.append(solve(**kw))
            print(f"{name}, block {i}: {len(seen['trips'])} trips, "
                  f"{Count.ops / len(seen['trips']):.0f} operations a trip")
        runs[name] = [torch.cat(v).numpy() for v in zip(*outs)]
    z0, k0, _ = runs["unplaced"]
    for name, (z, k, d) in runs.items():
        gamma = 0.95 / Lf
        x = z.astype(np.float64)
        y = x - gamma * ((x @ A.T.astype(np.float64) - b) @ A)
        zz = np.sign(y) * np.maximum(np.abs(y) - gamma * lam[:, None], 0.0)
        print(f"{name}: {int(d.sum())} done, iterations {k.mean():.2f} / "
              f"{k.max()}, {int((k != k0).sum())} lanes apart in count, "
              f"max|dx| {np.abs(z - z0).max():.3e}, recheck "
              f"{(np.abs(x - zz).max(axis=1) / gamma).max():.4e}")


if __name__ == "__main__":
    main()
