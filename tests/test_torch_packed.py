"""The lane-packed layout of the port against the JAX package's, on the CPU.

``pack_lasso_batch``, ``_pack_rows`` and ``_unpack_rows`` are permutations
and must give the JAX package's arrays exactly.  One packed step is held to
the JAX packed kernel in interpret mode at the reference's one-step
tolerance, 5e-6 (``tests/test_kernels.py:45-46``).  The packed solvers are
held to the JAX package's by the JAX tests' own oracles
(``tests/test_kernels.py:480``, ``:537``, ``:621``): counts within +-1, or
equal on at least 75% of the lanes where the JAX test allows knife edges;
solutions within 1e-4 (the cross-path bound of ``test_kernels.py:58-61``);
every lane's residual at the float32 operator within 1.1 tol.  On the CPU
the port's packed route runs the plain step on the unpacked operands, so it
is bit-equal to its natural route.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from proxtpu.kernels import common as jc
from proxtpu.kernels import lasso as jl
from proxtpu_torch.kernels import common as tc
from proxtpu_torch.kernels import dispatch
from proxtpu_torch.kernels import lasso as tl

TOL = 1e-5


def _problems(B, M, N, seed, lam_frac=0.1):
    rng = np.random.default_rng(seed)
    A = (rng.standard_normal((B, M, N)) / np.sqrt(M)).astype(np.float32)
    b = rng.standard_normal((B, M)).astype(np.float32)
    lam = (lam_frac * np.max(np.abs(np.einsum("bmn,bm->bn", A, b)), axis=1)
           ).astype(np.float32)
    sv = np.linalg.svd(A.astype(np.float64), compute_uv=False)
    return A, b, lam, (sv[:, 0] ** 2).astype(np.float32), sv


def _residual(A, b, lam, Lf, x):
    """Worst lane's ||x - prox(x - grad / Lf)||_inf * Lf, in numpy."""
    gam = (1.0 / Lf)[:, None]
    y = x - gam * np.einsum("bmn,bm->bn", A,
                            np.einsum("bmn,bn->bm", A, x) - b)
    z = np.sign(y) * np.maximum(np.abs(y) - gam * lam[:, None], 0.0)
    return float(np.max(np.max(np.abs(x - z), axis=1) / gam[:, 0]))


@pytest.mark.parametrize("B, M, N, pack", [
    (8, 16, 160, 4), (32, 16, 200, 16), (64, 8, 130, 64)])
def test_layout_matches_jax(B, M, N, pack):
    A, b = _problems(B, M, N, 0)[:2]
    x = np.random.default_rng(1).standard_normal((B, N)).astype(np.float32)
    nfull = (N // 128) * 128
    assert jl._pack_count(N, B) == tl._pack_count(N, B) == pack
    j_Ap, j_bp = jl.pack_lasso_batch(jnp.asarray(A), jnp.asarray(b), pack)
    t_Ap, t_bp = tl.pack_lasso_batch(torch.tensor(A), torch.tensor(b), pack)
    assert t_Ap.is_contiguous() and t_bp.is_contiguous()
    np.testing.assert_array_equal(t_Ap.numpy(), np.asarray(j_Ap))
    np.testing.assert_array_equal(t_bp.numpy(), np.asarray(j_bp))
    j_xp = jl._pack_rows(jnp.asarray(x), pack, nfull)
    t_xp = tl._pack_rows(torch.tensor(x), pack, nfull)
    np.testing.assert_array_equal(t_xp.numpy(), np.asarray(j_xp))
    np.testing.assert_array_equal(tl._unpack_rows(t_xp, pack, N).numpy(),
                                  np.asarray(jl._unpack_rows(j_xp, pack, N)))
    np.testing.assert_array_equal(tl._unpack_rows(t_xp, pack, N).numpy(), x)
    np.testing.assert_array_equal(tl._unpack_cols(t_Ap, pack, N).numpy(), A)


_GRID = [(N, B) for N in (48, 100, 127, 128, 130, 160, 200, 256, 384, 400,
                          1000) for B in (1, 2, 4, 8, 12, 16, 64, 100, 256)]


@pytest.mark.parametrize("name", ["pack_count", "auto_lanes"])
def test_counts_match_jax(name):
    """``_pack_count`` (also dispatch's) and ``auto_lanes`` on a grid, the
    raises included."""
    if name == "pack_count":
        assert dispatch._pack_count is tl._pack_count
        for N, B in _GRID:
            assert tl._pack_count(N, B) == jl._pack_count(N, B), (N, B)
        return
    for N, B in _GRID:
        for lanes in (None, 1, 2, 3, 4, 8):
            args = (B, N * 4096), dict(lanes=lanes)
            try:
                want = jc.auto_lanes(*args[0], **args[1])
            except ValueError as e:
                with pytest.raises(ValueError, match="must divide"):
                    tc.auto_lanes(*args[0], **args[1])
                assert "must divide" in str(e)
                continue
            assert tc.auto_lanes(*args[0], **args[1]) == want, (N, B, lanes)
            assert tc.auto_lanes(B, N * 4096, lanes, budget=1 << 20) == \
                jc.auto_lanes(B, N * 4096, lanes, budget=1 << 20)


def _packed_step_operands(restart_seed=4):
    B, M, N, pack = 8, 16, 160, 4
    A, b, lam, Lf, _ = _problems(B, M, N, 3)
    rng = np.random.default_rng(restart_seed)
    d = dict(x=rng.standard_normal((B, N)).astype(np.float32),
             z_prev=rng.standard_normal((B, N)).astype(np.float32),
             beta=rng.uniform(0.1, 0.9, B).astype(np.float32),
             gamma=(1.0 / Lf).astype(np.float32),
             done=np.array([0, 0, 1, 0, 0, 0, 1, 0], np.float32))
    d["thr"] = (d["gamma"] * lam).astype(np.float32)
    return A, b, d, N, pack


@pytest.mark.parametrize("restart", [False, True])
def test_packed_step_matches_jax(restart):
    """The plain packed step and the wrapper's CPU route against the JAX
    packed kernel in interpret mode, on packed operands."""
    A, b, d, N, pack = _packed_step_operands()
    B = A.shape[0]
    nfull = (N // 128) * 128
    j_Ap, j_bp = jl.pack_lasso_batch(jnp.asarray(A), jnp.asarray(b), pack)
    rows = lambda v: jl._pack_rows(jnp.asarray(v), pack, nfull)  # noqa: E731
    lanes = lambda v: jnp.asarray(v).reshape(B // pack, pack)  # noqa: E731
    ref = jl.fused_fista_packed_step(
        j_Ap, j_bp, rows(d["x"]), rows(d["z_prev"]),
        *(lanes(d[k]) for k in ("beta", "gamma", "thr", "done")), N=N,
        pack=pack, interpret=True, restart=restart)
    Ap, bp = tl.pack_lasso_batch(torch.tensor(A), torch.tensor(b), pack)
    ops = [torch.tensor(np.asarray(rows(d[k]))) for k in ("x", "z_prev")]
    ops += [torch.tensor(d[k]).reshape(B // pack, pack)
            for k in ("beta", "gamma", "thr", "done")]
    plain = tl.reference_fista_packed_step(Ap, bp, *ops, N, pack,
                                           restart=restart)
    x, zp = ops[0].clone(), ops[1].clone()
    fused = tl.fused_fista_packed_step(Ap, bp, x, zp, *ops[2:], N, pack,
                                       restart=restart)
    assert fused[0] is x and fused[1] is zp
    for p, f, r in zip(plain, fused, ref):
        assert torch.equal(p, f)
        np.testing.assert_allclose(p.numpy(), np.asarray(r), atol=5e-6)
    # frozen problems keep their carries and report 0
    frozen = np.asarray(rows(d["done"][:, None] * np.ones((1, N)))) != 0
    np.testing.assert_array_equal(plain[0].numpy()[frozen],
                                  np.asarray(rows(d["x"]))[frozen])
    with pytest.raises(ValueError, match="separate buffers"):
        tl.fused_fista_packed_step(Ap, bp, x, x, *ops[2:], N, pack)


# name -> (B, M, N, seed, lam_frac, solver kwargs, oracle): the JAX tests'
# cases (tests/test_kernels.py:480, :537, :621) and their count rules
_SOLVE_CASES = {
    "textbook": ((8, 16, 160, 3, 0.1), {}, "75%"),
    "restart": ((8, 16, 160, 3, 0.1), {"restart": True}, "75%"),
    "maxit_cap": ((8, 16, 160, 3, 0.1), {"tol": 1e-12, "maxit": 40},
                  "equal"),
    "mf": ((4, 320, 160, 13, 0.1), {"mf": True, "maxit": 4000}, "+-1"),
    "step_mult": ((8, 40, 160, 1, 0.1),
                  {"restart": True, "step_mult": 1.5}, "75%"),
}


@pytest.mark.parametrize("case", list(_SOLVE_CASES))
def test_packed_solver_matches_jax(case):
    (B, M, N, seed, frac), kw, oracle = _SOLVE_CASES[case]
    A, b, lam, Lf, sv = _problems(B, M, N, seed, frac)
    kw = dict(kw)
    tol, maxit = kw.pop("tol", TOL), kw.pop("maxit", 3000)
    if kw.pop("mf", False):
        kw["mf"] = float(np.min(sv[:, -1] ** 2))
    ref = jl.solve_lasso_batch_packed(*map(jnp.asarray, (A, b, lam, Lf)),
                                      tol, maxit=maxit, interpret=True, **kw)
    port = tl.solve_lasso_batch_packed(*map(torch.tensor, (A, b, lam, Lf)),
                                       tol, maxit=maxit, **kw)
    (z_p, it_p, d_p), (z_r, it_r, d_r) = (
        [np.asarray(v) for v in out] for out in (port, ref))
    np.testing.assert_array_equal(d_p, d_r)
    if oracle == "equal":
        assert not d_p.any()
        np.testing.assert_array_equal(it_p, it_r)
        return
    assert d_p.all()
    if oracle == "+-1":
        assert int(np.max(np.abs(it_p.astype(np.int64) - it_r))) <= 1
    else:
        assert (it_p == it_r).mean() >= 0.75, (it_p, it_r)
    np.testing.assert_allclose(z_p, z_r, atol=1e-4)
    assert _residual(A, b, lam, Lf, z_p) <= 1.1 * tol


@pytest.mark.parametrize("case", list(_SOLVE_CASES))
def test_packed_route_is_the_natural_route(case):
    """On the CPU the packed route (pack 4) gives the natural route's
    (pack 1) bits, on the kernel route and the plain one."""
    (B, M, N, seed, frac), kw, _ = _SOLVE_CASES[case]
    A, b, lam, Lf, sv = _problems(B, M, N, seed, frac)
    kw = dict(kw)
    tol, maxit = kw.pop("tol", TOL), kw.pop("maxit", 3000)
    if kw.pop("mf", False):
        kw["mf"] = float(np.min(sv[:, -1] ** 2))
    args = (*map(torch.tensor, (A, b, lam, Lf)), tol)
    natural = tl.solve_lasso_batch_packed(*args, maxit=maxit, pack=1, **kw)
    for use_kernel in (True, False):
        packed = tl.solve_lasso_batch_packed(*args, maxit=maxit,
                                             use_kernel=use_kernel, **kw)
        assert all(torch.equal(p, n) for p, n in zip(packed, natural))
