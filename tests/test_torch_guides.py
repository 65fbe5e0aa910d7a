"""The guides' Python blocks on the port (``proxtpu_torch/examples/guides.py``)
against the same blocks of ``docs/`` executed under JAX as
``tests/test_docs_examples.py`` executes them, on the CPU in float64.

A fragment's block gets the names its port supplies (the lasso of
``getting_started.md``'s first block, ``x0``, ``f``, ``g``, ``Lf``, the
block's ``solver``, ``iteration`` and ``states`` of block 3; the objects of
``custom_objectives.md`` driven by FISTA on that lasso, as
``guides.py`` says).  Tolerance: equal iteration counts, iterates and
recorded residuals within 1e-9; the port's result also meets what the
block claims (``guides.check``).  The counts are also
``proxtpu_torch.examples.GUIDES_JAX_ITERATIONS``, which ``chip_smoke.py``
prints beside the card's.
"""

import contextlib
import io
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest

import proxtpu as pa
from proxtpu.prox import NormL1, make_least_squares, proxclass
from proxtpu_torch.examples import GUIDES_JAX_ITERATIONS
from proxtpu_torch.examples import guides as G

DOCS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "docs")
ATOL = 1e-9


def _block(name, i):
    text = open(os.path.join(DOCS, name)).read()
    return re.findall(r"```python\n(.*?)```", text, re.S)[i - 1]


def _exec(name, i, ns):
    exec(compile(_block(name, i), name, "exec"), ns)
    return ns


def _lasso():
    A = jnp.asarray(G.README_A)
    b = jnp.asarray(G.README_B)
    lam = 0.1 * float(jnp.max(jnp.abs(A.T @ b)))
    Lf = float(np.linalg.norm(np.asarray(A), 2) ** 2)
    return A, b, lam, Lf


def _fista(f, g=None):
    A, b, lam, Lf = _lasso()
    x, it = pa.FastForwardBackward(tol=1e-6)(
        x0=jnp.zeros(5), f=f, g=NormL1(lam) if g is None else g, Lf=Lf)
    return {"x": x, "iterations": it}


def _started(*blocks):
    """getting_started.md's block 1, then ``blocks``, in one namespace with
    the names the fragments use."""
    ns = _exec("getting_started.md", 1, {})
    A, b, lam, Lf = _lasso()
    ns.update(x0=jnp.zeros(5), f=make_least_squares(A, b), g=NormL1(lam),
              Lf=Lf)
    for i in blocks:
        _exec("getting_started.md", i, ns)
    return ns


def _jax_ista():
    ns = _exec("custom_algorithms.md", 1, {})
    A, b, lam, Lf = _lasso()
    problem = dict(x0=jnp.zeros(5), f=make_least_squares(A, b),
                   g=NormL1(lam), gamma=1.0 / Lf)
    x, it = ns["ISTA"](tol=1e-6, maxit=20_000)(**problem)
    x_fb, it_fb = pa.ForwardBackward(tol=1e-6, maxit=20_000)(**problem)
    return {"x": x, "iterations": it, "x_fb": x_fb, "iterations_fb": it_fb}


def _jax_autodiff():
    A, b, _, _ = _lasso()
    ns = _exec("custom_objectives.md", 1, {"jnp": jnp, "A": A, "b": b})
    return _fista(ns["f"])


def _jax_own_gradient():
    A, b, _, _ = _lasso()
    ns = _exec("custom_objectives.md", 2, {"jnp": jnp})
    return _fista(ns["MyQuadratic"](A.T @ A, -(A.T @ b)))


def _jax_custom_prox():
    A, b, _, _ = _lasso()
    ns = _exec("custom_objectives.md", 3, {"jnp": jnp, "proxclass": proxclass})
    return _fista(make_least_squares(A, b), g=ns["IndBall2"](G.BALL_RADIUS))


def _jax_states():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        _started(3)
    rows = [line.split() for line in out.getvalue().splitlines()]
    return {"residuals": np.array([float(r[1]) for r in rows
                                   if len(r) == 2 and r[0].isdigit()])}


def _jax_recorded():
    ns = _started(4)
    return {"x": ns["x"], "iterations": ns["it"],
            "residual_curve": ns["residual_curve"]}


JAX = {
    ("custom_algorithms.md", 1): _jax_ista,
    ("custom_objectives.md", 1): _jax_autodiff,
    ("custom_objectives.md", 2): _jax_own_gradient,
    ("custom_objectives.md", 3): _jax_custom_prox,
    ("getting_started.md", 1): lambda: {
        k: v for k, v in _started().items() if k in ("x", "it")},
    ("getting_started.md", 2): lambda: {
        k: v for k, v in _started(2).items() if k in ("x", "it")},
    ("getting_started.md", 3): _jax_states,
    ("getting_started.md", 4): _jax_recorded,
    ("getting_started.md", 5): lambda: {
        k: v for k, v in _started(3, 5).items() if k in ("x", "it")},
    ("migrating_from_proximalalgorithms.md", 1): lambda: {
        k: v for k, v in _exec("migrating_from_proximalalgorithms.md", 1,
                               {}).items()
        if k in ("solution", "iterations")},
}
NAMES = {"it": "iterations"}


def test_every_block_has_its_port():
    blocks = {(name, i + 1) for name in (
        "custom_algorithms.md", "custom_objectives.md",
        "getting_started.md", "migrating_from_proximalalgorithms.md")
        for i in range(len(re.findall(r"```python\n", open(os.path.join(
            DOCS, name)).read())))}
    assert blocks == set(G.BLOCKS) == set(JAX)
    assert set(GUIDES_JAX_ITERATIONS) == {f"{n}:{i}" for n, i in G.BLOCKS
                                          if n != "getting_started.md"
                                          or i != 3}


@pytest.mark.parametrize("key", sorted(G.BLOCKS),
                         ids=lambda k: f"{k[0]}:{k[1]}")
def test_block_on_the_port_is_the_jax_block(key):
    port = G.BLOCKS[key](device="cpu")
    G.check(key, port)
    ref = {NAMES.get(k, k): v for k, v in JAX[key]().items()}
    assert set(port) == set(ref)
    for k, v in port.items():
        got, want = np.asarray(v), np.asarray(ref[k])
        if k.startswith("iterations"):
            assert int(got) == int(want), (k, got, want)
        else:
            assert got.shape == want.shape, k
            np.testing.assert_allclose(got, want, rtol=0, atol=ATOL,
                                       err_msg=k)
    name = f"{key[0]}:{key[1]}"
    if name in GUIDES_JAX_ITERATIONS:
        assert GUIDES_JAX_ITERATIONS[name] == int(ref["iterations"])
