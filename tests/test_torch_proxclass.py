"""``proxclass`` in the port against the JAX package's, on the CPU in
float64.

Every class the JAX package makes with ``@proxclass`` (read from its
sources with ``ast``) declares the same ``meta_fields`` in the port, and
the port's own classes are ``proxclass``es too.  A static field that
differs across problems makes ``batch_problems`` raise in both packages;
with equal static fields both batch and solve to the same counts
(solutions within 1e-9).  A plain frozen dataclass still stacks a number
that differs into a lane tensor, whatever its class is named.
"""

import ast
import dataclasses
import importlib
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import proxtpu
import proxtpu_torch
from proxtpu.algorithms import (
    make_forward_backward_iteration as j_make_fb,
)
from proxtpu.parallel import batch_problems as j_batch_problems
from proxtpu.parallel import batched_run_loop as j_batched_run_loop
from proxtpu.prox import LeastSquaresLoss as JLeastSquaresLoss
from proxtpu.prox import proxclass as jproxclass
from proxtpu_torch.algorithms import make_forward_backward_iteration
from proxtpu_torch.parallel import batch_problems, batched_run_loop
from proxtpu_torch.prox import LeastSquaresLoss, proxclass

TOL = 1e-8
MAXIT = 2000
M, N = 10, 16


def _declared(root, package):
    """``{(module, class): meta_fields}`` of every class decorated with
    ``proxclass`` in the sources under ``root``."""
    out = {}
    for path in sorted(pathlib.Path(root).rglob("*.py")):
        rel = path.relative_to(root).with_suffix("")
        module = ".".join((package, *rel.parts)).removesuffix(".__init__")
        for node in ast.walk(ast.parse(path.read_text())):
            if not isinstance(node, ast.ClassDef):
                continue
            for d in node.decorator_list:
                fn = d.func if isinstance(d, ast.Call) else d
                if getattr(fn, "id", None) != "proxclass":
                    continue
                meta = ()
                for kw in getattr(d, "keywords", ()):
                    if kw.arg == "meta_fields":
                        meta = tuple(ast.literal_eval(kw.value))
                out[(module, node.name)] = meta
    return out


JAX_ROOT = pathlib.Path(proxtpu.__file__).parent
PORT_ROOT = pathlib.Path(proxtpu_torch.__file__).parent
JAX_DECLARED = _declared(JAX_ROOT, "proxtpu")


def _port_class(module, name):
    mod = importlib.import_module("proxtpu_torch" + module[len("proxtpu"):])
    return getattr(mod, name)


def test_the_jax_package_declares_what_the_port_mirrors():
    # the JAX package's count: prox (64), algorithms (11), accel (10),
    # ops (5), parallel (2)
    assert len(JAX_DECLARED) == 92


@pytest.mark.parametrize("module, name", sorted(JAX_DECLARED))
def test_meta_fields_are_the_jax_packages(module, name):
    cls = _port_class(module, name)
    assert dataclasses.is_dataclass(cls)
    assert cls.__dataclass_params__.frozen
    assert cls.__dict__["_meta_fields"] == JAX_DECLARED[(module, name)]


def test_the_ports_own_classes_are_proxclasses():
    """No class of the port is a frozen dataclass made otherwise, and the
    port's own classes declare their static fields."""
    for path in PORT_ROOT.rglob("*.py"):
        text = path.read_text()
        assert "@dataclass(frozen=True)" not in text, path
    own = {key: v for key, v in _declared(PORT_ROOT, "proxtpu_torch").items()
           if ("proxtpu" + key[0][len("proxtpu_torch"):], key[1])
           not in JAX_DECLARED}
    assert own == {
        ("proxtpu_torch.parallel.sharded_ops", "RowShardedLeastSquaresLoss"):
            ("group",),
        ("proxtpu_torch.parallel.sharded_ops", "RowShardedLeastSquares"):
            ("group", "wide"),
        ("proxtpu_torch.parallel.sharded_ops", "RowShardedMatrixOperator"):
            ("group", "offset", "rows"),
        ("proxtpu_torch.tools.spmd_worker", "EmulatedStripes"): ("parts",),
        ("proxtpu_torch.tools.spmd_worker", "EmulatedRowOperator"):
            ("parts",),
        ("proxtpu_torch.tools.spmd_worker", "EmulatedLeastSquares"):
            ("parts", "wide"),
        ("proxtpu_torch.tools.families", "MaskedQuadratic"): (),
        ("proxtpu_torch.examples.guides", "MyQuadratic"): (),
        ("proxtpu_torch.examples.guides", "IndBall2"): (),
        ("proxtpu_torch.examples.guides", "ISTAIteration"): (),
        ("proxtpu_torch.examples.robust_pca", "CouplingLoss"): (),
    }
    for (module, name), meta in own.items():
        cls = getattr(importlib.import_module(module), name, None)
        if cls is not None:  # ISTAIteration is made inside its block
            assert cls.__dict__["_meta_fields"] == meta


def test_proxclass_imports_where_the_jax_packages_does():
    from proxtpu_torch.prox import base

    assert base.proxclass is proxclass
    assert "proxclass" in proxtpu_torch.prox.__all__


def test_proxclass_is_the_frozen_dataclass():
    """Equality, hash, repr and immutability of ``@dataclass(frozen=True)``;
    a meta field that is not a field is refused."""

    @proxclass(meta_fields=("k",))
    class P:
        w: object
        k: int = 1

    @dataclasses.dataclass(frozen=True)
    class D:
        w: object
        k: int = 1

    assert P(2.0, 3) == P(2.0, 3) and P(2.0, 3) != P(2.0, 4)
    assert hash(P(2.0, 3)) == hash(D(2.0, 3))
    assert repr(P(2.0, 3)).split("(", 1)[1] == repr(D(2.0, 3)).split("(",
                                                                      1)[1]
    with pytest.raises(dataclasses.FrozenInstanceError):
        P(2.0).k = 2
    assert P._meta_fields == ("k",)
    assert proxclass(type("E", (), {"__annotations__": {"w": object}}))(
        1.0)._meta_fields == ()
    with pytest.raises(ValueError, match="no fields"):
        proxclass(meta_fields=("q",))(type("Q", (), {"__annotations__":
                                                     {"w": object}}))


# ---------------------------------------------------------------------------
# a user's prox with a count: keep the k entries largest in magnitude


@jproxclass(meta_fields=("k",))
class JKeepTopK:
    k: int

    def __call__(self, x):
        return jnp.zeros((), x.real.dtype)

    def prox(self, x, gamma):
        thr = jnp.sort(jnp.abs(x))[-self.k]
        return jnp.where(jnp.abs(x) >= thr, x, 0), self(x)


@proxclass(meta_fields=("k",))
class KeepTopK:
    k: int

    def __call__(self, x):
        return torch.zeros((), dtype=x.real.dtype, device=x.device)

    def prox(self, x, gamma):
        thr = torch.topk(x.abs(), self.k).values[..., -1:]
        return torch.where(x.abs() >= thr, x, 0), self(x)


def _problem(seed, k, jax_side=False):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((M, N)) / np.sqrt(M)
    b = rng.standard_normal(M)
    Lf = float(np.linalg.norm(A, 2) ** 2)
    if jax_side:
        return dict(x0=jnp.zeros(N), f=JLeastSquaresLoss(jnp.asarray(A),
                                                         jnp.asarray(b)),
                    g=JKeepTopK(k), Lf=Lf)
    return dict(x0=torch.zeros(N, dtype=torch.float64),
                f=LeastSquaresLoss(torch.tensor(A), torch.tensor(b)),
                g=KeepTopK(k), Lf=Lf)


def test_a_differing_static_field_raises_in_both_packages():
    with pytest.raises(ValueError):
        j_batch_problems(j_make_fb, [_problem(0, 2, True),
                                     _problem(1, 3, True)])
    with pytest.raises(ValueError, match="static field KeepTopK.k"):
        batch_problems(make_forward_backward_iteration,
                       [_problem(0, 2), _problem(1, 3)])


@pytest.mark.parametrize("k", [2, 5])
def test_equal_static_fields_solve_as_the_jax_package(k):
    lanes = range(4)
    it = batch_problems(make_forward_backward_iteration,
                        [_problem(s, k) for s in lanes])
    assert it.g == KeepTopK(k)  # the count stays a number
    xs, iters, done = batched_run_loop(it, MAXIT, TOL)
    it_j = j_batch_problems(j_make_fb, [_problem(s, k, True) for s in lanes])
    xs_j, iters_j, done_j = j_batched_run_loop(it_j, MAXIT, TOL)
    assert bool(done.all()) and bool(np.asarray(done_j).all())
    np.testing.assert_array_equal(iters.numpy(), np.asarray(iters_j))
    np.testing.assert_allclose(xs.numpy(), np.asarray(xs_j), rtol=0,
                               atol=1e-9)
    assert int((xs != 0).sum(dim=1).max()) <= k


@pytest.mark.parametrize("name", ["KeepTopK", "IndBallL0", "LeastSquares"])
def test_a_plain_dataclass_stacks_a_differing_number(name):
    """A class made by ``@dataclass(frozen=True)`` declares nothing static,
    even where it shares its name with a class of the port that does."""

    def prox(self, x, gamma):
        return x, torch.zeros((), dtype=x.dtype)

    cls = dataclasses.dataclass(frozen=True)(type(
        name, (), {"__annotations__": {"k": int}, "prox": prox}))
    it = batch_problems(make_forward_backward_iteration,
                        [dict(_problem(s, 0), g=cls(k)) for s, k in
                         enumerate((2, 3))])
    assert torch.equal(it.g.k, torch.tensor([2, 3]))
