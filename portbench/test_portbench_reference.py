"""The plain references and the generator: held to the port's plain routes
in float64, to ``tools/problems.py::lasso_data``'s distribution, and to
importing nothing of the program."""

import ast
import math

import numpy as np
import pytest
import torch

from portbench import harness, reference as ref

lasso = harness.load_module("problems", "lasso")


def batch(M, N, B, seed, count=1):
    return lasso.make_batches(dict(M=M, N=N, lam_ratio=0.1), B, count, seed,
                              "cpu")


def f64(b):
    return tuple(t.double() for t in b)


@pytest.mark.parametrize("M, N, B", [(20, 40, 16), (64, 160, 16)])
def test_fista_is_the_ports_plain_one_step_and_blocked_routes(M, N, B):
    from proxtpu_torch.kernels import lasso as pl

    A, b, lam, Lf = f64(batch(M, N, B, 3)[0])
    for restart in (False, True):
        got = pl.solve_lasso_batch(A, b, lam, Lf, 1e-5, maxit=2000,
                                   restart=restart, use_kernel=False)
        want = ref.fista(A, b, lam, Lf, 1e-5, 2000, restart=restart)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    got = pl.solve_lasso_batch_blocked(A, b, lam, Lf, 1e-5, maxit=3000,
                                       iter_block=8, use_kernel=False)
    want = ref.fista(A, b, lam, Lf, 1e-5, 3000, K=8)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("branch", ["full width", "tail"])
def test_packed_tail_is_the_ports_plain_route_on_both_branches(branch):
    from proxtpu_torch.kernels import lasso as pl

    A, b, lam, Lf = f64(batch(64, 160, 16, 5)[0])
    _, it, _ = ref.fista(A, b, lam, Lf, 1e-5, 2000, restart=True)
    # phase 1 leaves all 16 lanes (full width) or 3 (the tail of 4)
    k1 = 24 if branch == "full width" else int(it.sort().values[-4])
    _, _, dn1 = ref.fista(A, b, lam, Lf, 1e-5, k1, restart=True)
    assert (16 - int(dn1.sum()) > 4) == (branch == "full width")
    got = pl.solve_lasso_batch_packed_tail(A, b, lam, Lf, 1e-5, maxit=2000,
                                           k1=k1, tail=4, use_kernel=False)
    want = ref.packed_tail(A, b, lam, Lf, 1e-5, 2000, k1=k1, tail=4,
                           restart=True)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_the_512x1024_lanes_take_the_blocked_leg():
    """The reference of ``batched_fista`` is the blocked solver's
    semantics because the dispatch sends lanes of this size there."""
    from proxtpu_torch.kernels.dispatch import BLOCKED_LANE_BYTES

    m = harness.load_manifest()
    for w, blocked in (("lasso_512x1024.b64", True),
                       ("lasso_200x400.b4096", False)):
        p = harness.cell(m, w).config["problem"]
        assert (p["M"] * p["N"] * 4 >= BLOCKED_LANE_BYTES) == blocked


def test_recheck_is_chip_smokes_arithmetic_in_float64(monkeypatch):
    A, b, lam, Lf = batch(20, 40, 8, 1)[0]
    x = torch.randn(8, 40, dtype=torch.float64) * 0.1
    As, bs, lams, Lfs, xs = (t.double().numpy() for t in (A, b, lam, Lf, x))
    gam = (1.0 / Lfs)[:, None]
    grad = np.einsum("bmn,bm->bn", As, np.einsum("bmn,bn->bm", As, xs) - bs)
    y = xs - gam * grad
    z = np.sign(y) * np.maximum(np.abs(y) - gam * lams[:, None], 0.0)
    want = np.max(np.abs(xs - z), axis=1) / gam[:, 0]
    # chunks of three lanes
    monkeypatch.setattr(ref, "CHUNK_BYTES", 3 * 8 * 20 * 40)
    assert len(ref.chunks(A)) == 3
    got = ref.recheck(A, b, lam, Lf, x).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_round_tf32():
    x = torch.tensor([1.0, 1 + 2 ** -11, 1 + 3 * 2 ** -11, 1 + 2 ** -10,
                      -(1 + 2 ** -12), 3.0e-3], dtype=torch.float32)
    got = ref.round_tf32(x)
    # ties go to even; 10 mantissa bits are kept
    assert got[:5].tolist() == [1.0, 1.0, 1 + 2 ** -9, 1 + 2 ** -10, -1.0]
    m, _ = math.frexp(got[5].item())
    assert (m * 2 ** 11) == int(m * 2 ** 11)
    assert abs(got[5].item() - 3.0e-3) <= 3.0e-3 * 2 ** -11


@pytest.mark.parametrize("M, N", [(20, 40), (48, 24)])
def test_lipschitz_bound_is_above_and_close(M, N, monkeypatch):
    A = torch.randn(6, M, N, dtype=torch.float64)
    exact = torch.linalg.matrix_norm(A, ord=2) ** 2
    # chunks of four lanes and two
    monkeypatch.setattr(ref, "CHUNK_BYTES", 4 * 8 * M * N)
    up = ref.lipschitz_upper(A)
    n = min(M, N)
    assert bool((up >= exact * (1 - 1e-13)).all())
    assert bool((up <= exact * n ** (1 / 2 ** ref.SQUARINGS) * (1 + 1e-13))
                .all())
    f = ref.f32_at_least(exact)
    assert bool((f.double() >= exact).all())


@pytest.mark.parametrize("shape, per", [((4096, 200, 400), 1677),
                                        ((64, 512, 1024), 256),
                                        ((3, 1, 1), 3)])
def test_chunks_keep_a_float64_copy_under_the_limit(shape, per):
    A = torch.empty(shape, device="meta")
    sl = ref.chunks(A)
    assert [s.start for s in sl] == list(range(0, shape[0], per))
    assert per * 8 * shape[1] * shape[2] <= ref.CHUNK_BYTES


def test_generator_repeats_by_seed_and_differs_across_seeds():
    a = batch(20, 40, 8, 2 ** 31 + 5, count=2)
    b = batch(20, 40, 8, 2 ** 31 + 5, count=2)
    c = batch(20, 40, 8, 2 ** 31 + 6, count=2)
    for x, y in zip(a, b):
        for s, t in zip(x, y):
            assert torch.equal(s, t)
    assert not torch.equal(a[0][0], c[0][0])
    assert not torch.equal(a[0][0], a[1][0])


def test_generator_matches_lasso_data():
    """Means of A's entries, their spread, b, lam and Lf over 400 lanes
    against ``tools/problems.py::lasso_problems`` at the same size, each
    within four standard errors."""
    from proxtpu_torch.tools.problems import lasso_problems

    M, N, B = 16, 32, 400
    mine = [t.double().numpy() for t in batch(M, N, B, 11)[0]]
    theirs = [np.asarray(t, np.float64) for t in lasso_problems(B, M, N)]
    for name, f in (("A mean", lambda t: t[0]),
                    ("A square", lambda t: t[0] ** 2 * M),
                    ("b square", lambda t: t[1] ** 2),
                    ("lam", lambda t: t[2]), ("Lf", lambda t: t[3])):
        u, v = f(mine).ravel(), f(theirs).ravel()
        se = math.sqrt(u.var() / u.size + v.var() / v.size)
        assert abs(u.mean() - v.mean()) <= 4 * se, name
    # Lf is ||A||_2^2 from above for every lane
    A = torch.from_numpy(mine[0])
    exact = torch.linalg.matrix_norm(A, ord=2) ** 2
    assert bool((torch.from_numpy(mine[3]) >= exact).all())
    assert bool((torch.from_numpy(mine[3]) <= exact * (1 + 1e-5)).all())


@pytest.mark.card
def test_generator_repeats_on_the_card(card):
    a = lasso.make_batches(dict(M=20, N=40, lam_ratio=0.1), 8, 2, 9, card)
    b = lasso.make_batches(dict(M=20, N=40, lam_ratio=0.1), 8, 2, 9, card)
    for x, y in zip(a, b):
        for s, t in zip(x, y):
            assert torch.equal(s, t)


def imports(path):
    """Top-level names of the modules a source imports, and whether each
    import is at the module's top level."""
    tree = ast.parse(path.read_text())
    out = []
    top = set(map(id, tree.body))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        out += [(n.split(".")[0], id(node) in top) for n in names]
    return out


PROGRAM = {"proxtpu_torch"} | set(harness.BANNED_MODULES)


@pytest.mark.parametrize("rel", ["reference.py", "problems/lasso.py",
                                 "generators/pool.py"])
def test_references_import_nothing_of_the_program(rel):
    assert not {n for n, _ in imports(harness.HERE / rel)} & PROGRAM


@pytest.mark.parametrize("rel", sorted(
    str(p.relative_to(harness.HERE))
    for p in (harness.HERE / "entries").glob("*.py")
    if p.name != "__init__.py"))
def test_entries_load_the_program_only_when_it_runs(rel):
    """An entry's module imports the program inside ``program()`` only,
    so its ``reference`` runs without it."""
    for name, at_top in imports(harness.HERE / rel):
        assert name not in harness.BANNED_MODULES
        if name == "proxtpu_torch":
            assert not at_top
