"""The Python blocks of the JAX package's guides (``docs/``) on the port, one
function per block, each returning what its block makes.

Ten blocks: ``custom_algorithms.md`` (1), ``custom_objectives.md`` (3),
``getting_started.md`` (5) and ``migrating_from_proximalalgorithms.md``
(1).  ``jax.numpy`` becomes ``torch``, ``@proxclass`` a frozen dataclass
and ``jax.debug.print`` ``print``.  Where a block is a fragment, its
function supplies the names it uses as the guide's text describes them:
the lasso of ``getting_started.md``'s first block (``A``, ``b``, ``lam``,
``x0 = zeros(5)``, ``f = make_least_squares(A, b)``, ``g = NormL1(lam)``,
``Lf = ||A||_2^2``, the block's ``solver``); the objects of
``custom_objectives.md`` are driven by FISTA on that lasso (block 2's
quadratic as ``Q = A^T A``, ``q = -A^T b``; block 3's ball of radius 0.5 as
the constraint of the least squares).  Every function runs on the card
unless ``device="cpu"`` is passed, in float64, as the JAX blocks run under
``jax_enable_x64``.  :data:`BLOCKS` names them by file and block.
"""

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from . import device_of

README_A = [[1., -2., 3., -4., 5.],
            [2., -1., 0., -1., 3.],
            [-1., 0., 4., -3., 2.],
            [-1., -1., -1., 1., 3.]]
README_B = [1., 2., 3., 4.]
BALL_RADIUS = 0.5


def lasso(device):
    """``getting_started.md`` block 1's problem: ``(A, b, lam, Lf)``."""
    dev = device_of(device)
    A = torch.tensor(README_A, dtype=torch.float64, device=dev)
    b = torch.tensor(README_B, dtype=torch.float64, device=dev)
    lam = 0.1 * float(torch.max(torch.abs(A.T @ b)))
    Lf = float(np.linalg.norm(np.asarray(README_A), 2) ** 2)
    return A, b, lam, Lf


# ---------------------------------------------------------------------------
# custom_algorithms.md, block 1: ISTA from scratch

def custom_algorithms_ista(device="cuda", tol=1e-6, maxit=20_000):
    """``docs/custom_algorithms.md``, block 1: the ISTA iteration, its
    factory and solver, run on the lasso at gamma = 1 / Lf beside
    ``ForwardBackward`` at the same step (the guide's ISTA is plain FB)."""
    from ..algorithms import ForwardBackward
    from ..algorithms.common import astree, real_dtype, rscalar
    from ..algorithms.core import IterativeAlgorithm
    from ..prox import NormL1, Zero, make_least_squares, prox, \
        value_and_gradient
    from ..utils.tree import tree_inf_norm, tree_map, tree_sub

    class ISTAState(NamedTuple):
        x: object
        z: object
        res: object

    @dataclass(frozen=True)
    class ISTAIteration:
        f: object
        g: object
        x0: object
        gamma: object

        def init(self):
            return self.step(ISTAState(self.x0, self.x0,
                                       tree_sub(self.x0, self.x0)))

        def step(self, s):
            _, grad = value_and_gradient(self.f, s.z)
            y = tree_map(lambda xl, gl: xl - self.gamma * gl, s.z, grad)
            z, _ = prox(self.g, y, self.gamma)
            return ISTAState(s.z, z, tree_sub(s.z, z))

        def default_stopping_criterion(self, tol, s):
            return tree_inf_norm(s.res) / self.gamma <= tol

        def default_solution(self, s):
            return s.z

        def default_display(self, k, s):
            print(f"{k:5d} | {float(tree_inf_norm(s.res) / self.gamma):.3e}")

    def make_ista_iteration(*, x0, f=Zero(), g=Zero(), gamma):
        x0 = astree(x0)
        return ISTAIteration(f=f, g=g, x0=x0,
                             gamma=rscalar(gamma, real_dtype(x0), x0.device))

    def ISTA(*, maxit=10_000, tol=1e-8, **kwargs):
        return IterativeAlgorithm(make_ista_iteration, maxit=maxit, tol=tol,
                                  **kwargs)

    A, b, lam, Lf = lasso(device)
    problem = dict(x0=torch.zeros(5, dtype=A.dtype, device=A.device),
                   f=make_least_squares(A, b), g=NormL1(lam), gamma=1.0 / Lf)
    x, it = ISTA(tol=tol, maxit=maxit)(**problem)
    x_fb, it_fb = ForwardBackward(tol=tol, maxit=maxit)(**problem)
    return {"x": x, "iterations": it, "x_fb": x_fb, "iterations_fb": it_fb}


# ---------------------------------------------------------------------------
# custom_objectives.md, blocks 1-3

def _fista_on_lasso(A, b, lam, Lf, f, g=None, tol=1e-6):
    from ..algorithms import FastForwardBackward
    from ..prox import NormL1

    x, it = FastForwardBackward(tol=tol)(
        x0=torch.zeros(5, dtype=A.dtype, device=A.device), f=f,
        g=NormL1(lam) if g is None else g, Lf=Lf)
    return {"x": x, "iterations": it}


def custom_objectives_autodiff(device="cuda"):
    """``docs/custom_objectives.md``, block 1: a plain callable as the
    smooth term (``AutoDifferentiable``), FISTA on the lasso."""
    from .. import AutoDifferentiable

    A, b, lam, Lf = lasso(device)
    f = AutoDifferentiable(lambda x: 0.5 * torch.sum((A @ x - b) ** 2))
    return _fista_on_lasso(A, b, lam, Lf, f)


@dataclass(frozen=True)
class MyQuadratic:
    """``docs/custom_objectives.md``, block 2: a smooth term with its own
    ``value_and_gradient``."""

    Q: object
    q: object

    is_convex = True
    is_generalized_quadratic = True

    def __call__(self, x):
        return (0.5 * torch.vdot(x, self.Q @ x).real
                + torch.vdot(self.q, x).real)

    def value_and_gradient(self, x):
        Qx = self.Q @ x
        return (0.5 * torch.vdot(x, Qx).real + torch.vdot(self.q, x).real,
                Qx + self.q)


def custom_objectives_own_gradient(device="cuda"):
    """``docs/custom_objectives.md``, block 2: ``MyQuadratic`` with
    ``Q = A^T A``, ``q = -A^T b`` (the lasso's smooth term less a
    constant), FISTA on the lasso."""
    A, b, lam, Lf = lasso(device)
    return _fista_on_lasso(A, b, lam, Lf, MyQuadratic(A.T @ A, -(A.T @ b)))


@dataclass(frozen=True)
class IndBall2:
    """``docs/custom_objectives.md``, block 3: indicator of the l2 ball of
    radius r, with its own prox."""

    r: object = 1.0

    is_convex = True
    is_generalized_quadratic = False

    def __call__(self, x):
        inside = torch.linalg.norm(x) <= self.r
        return torch.where(inside, 0.0, torch.inf).to(x.dtype)

    def prox(self, x, gamma):
        nrm = torch.linalg.norm(x)
        z = x * torch.clamp(self.r / torch.clamp(nrm, min=1e-30), max=1.0)
        return z, torch.zeros((), dtype=nrm.dtype, device=x.device)


def custom_objectives_custom_prox(device="cuda"):
    """``docs/custom_objectives.md``, block 3: ``IndBall2(0.5)`` as the
    nonsmooth term of the least squares, FISTA."""
    from ..prox import make_least_squares

    A, b, lam, Lf = lasso(device)
    return _fista_on_lasso(A, b, lam, Lf, make_least_squares(A, b),
                           g=IndBall2(BALL_RADIUS))


# ---------------------------------------------------------------------------
# getting_started.md, blocks 1-5

def _getting_started(device, verbose):
    from ..algorithms import FastForwardBackward
    from ..prox import NormL1, make_least_squares

    A, b, lam, Lf = lasso(device)
    solver = FastForwardBackward(tol=1e-6, verbose=verbose, freq=50)
    return dict(solver=solver, x0=torch.zeros(5, dtype=A.dtype,
                                              device=A.device),
                f=make_least_squares(A, b), g=NormL1(lam), Lf=Lf)


def getting_started_solve(device="cuda", verbose=True):
    """``docs/getting_started.md``, block 1: FISTA on the lasso, printing
    every 50 iterations (``verbose``, the block's own)."""
    p = _getting_started(device, verbose)
    x, it = p["solver"](x0=p["x0"], f=p["f"], g=p["g"], Lf=p["Lf"])
    return {"x": x, "iterations": it}


def getting_started_adaptive(device="cuda"):
    """``docs/getting_started.md``, block 2: ``ForwardBackward`` with the
    adaptive step, no ``Lf``, on block 1's ``x0``, ``f``, ``g``."""
    from ..algorithms import ForwardBackward

    p = _getting_started(device, False)
    x, it = ForwardBackward(tol=1e-6, adaptive=True)(x0=p["x0"], f=p["f"],
                                                     g=p["g"])
    return {"x": x, "iterations": it}


def getting_started_states(device="cuda", verbose=False):
    """``docs/getting_started.md``, block 3: block 1's solver's iteration
    driven by ``states``, 102 states; returns their ``max|res|`` (printed
    with ``verbose``, as the block prints them)."""
    from ..algorithms.core import states

    p = _getting_started(device, False)
    iteration = p["solver"].make_iteration(x0=p["x0"], f=p["f"], g=p["g"],
                                           Lf=p["Lf"])
    residuals = []
    for k, s in enumerate(states(iteration)):
        residuals.append(float(torch.max(torch.abs(s.res))))
        if verbose:
            print(k, residuals[-1])
        if k > 100:
            break
    return {"residuals": np.asarray(residuals)}


def getting_started_recorded(device="cuda"):
    """``docs/getting_started.md``, block 4: ``run_recorded`` of
    ``max|res| / gamma`` every 10 iterations."""
    p = _getting_started(device, False)
    x, it, tr = p["solver"].run_recorded(
        lambda iteration, k, s: torch.max(torch.abs(s.res)) / s.gamma,
        record_every=10, x0=p["x0"], f=p["f"], g=p["g"], Lf=p["Lf"])
    return {"x": x, "iterations": it, "residual_curve": tr.valid()}


def getting_started_resume(device="cuda"):
    """``docs/getting_started.md``, block 5: the 500th state of block 3's
    iteration as the snapshot, the solve resumed from it."""
    from ..algorithms.core import states

    p = _getting_started(device, False)
    iteration = p["solver"].make_iteration(x0=p["x0"], f=p["f"], g=p["g"],
                                           Lf=p["Lf"])
    snapshot = None
    for s in states(iteration, max_states=500):
        snapshot = s
    x, it = p["solver"](resume_from=snapshot, x0=p["x0"], f=p["f"],
                        g=p["g"], Lf=p["Lf"])
    return {"x": x, "iterations": it}


# ---------------------------------------------------------------------------
# migrating_from_proximalalgorithms.md, block 1

def migrating_five_minutes(device="cuda"):
    """``docs/migrating_from_proximalalgorithms.md``, block 1: FISTA to tol
    1e-5 on the lasso, capped at 1000."""
    from ..algorithms import FastForwardBackward
    from ..prox import NormL1, make_least_squares

    A, b, lam, Lf = lasso(device)
    f = make_least_squares(A, b)
    g = NormL1(lam)
    ffb = FastForwardBackward(maxit=1000, tol=1e-5)
    solution, iterations = ffb(
        x0=torch.zeros(5, dtype=A.dtype, device=A.device), f=f, g=g, Lf=Lf)
    assert iterations < 1000
    return {"solution": solution, "iterations": iterations}


BLOCKS = {
    ("custom_algorithms.md", 1): custom_algorithms_ista,
    ("custom_objectives.md", 1): custom_objectives_autodiff,
    ("custom_objectives.md", 2): custom_objectives_own_gradient,
    ("custom_objectives.md", 3): custom_objectives_custom_prox,
    ("getting_started.md", 1): getting_started_solve,
    ("getting_started.md", 2): getting_started_adaptive,
    ("getting_started.md", 3): getting_started_states,
    ("getting_started.md", 4): getting_started_recorded,
    ("getting_started.md", 5): getting_started_resume,
    ("migrating_from_proximalalgorithms.md", 1): migrating_five_minutes,
}

# tests/problems.py's optimum of the lasso (the reference's x_star)
LASSO_XSTAR = [-3.877278911564627e-01, 0.0, 0.0, 2.174149659863943e-02,
               6.168435374149660e-01]


def check(key, out):
    """Assert what the guide's block claims on its result ``out``: the
    lasso's optimum within 1e-4 (the JAX package's
    ``tests/test_docs_examples.py`` holds the ISTA and migration blocks so);
    ISTA is plain FB (equal counts, iterates within 1e-10); the ball's
    solution inside the ball; residuals recorded as the block records them
    (``count == it // 10`` written, falling); a solve
    resumed from a converged snapshot stops at once."""
    xstar = np.asarray(LASSO_XSTAR)

    def near_xstar(x):
        x = np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)
        assert np.max(np.abs(x - xstar)) <= 1e-4, x

    if key == ("custom_objectives.md", 3):
        assert float(torch.linalg.norm(out["x"])) <= BALL_RADIUS + 1e-9
        return
    if key == ("getting_started.md", 3):
        r = np.asarray(out["residuals"])
        assert r.shape == (102,) and np.isfinite(r).all()
        return
    near_xstar(out["solution"] if "solution" in out else out["x"])
    if key == ("custom_algorithms.md", 1):
        assert out["iterations"] == out["iterations_fb"]
        assert float((out["x"] - out["x_fb"]).abs().max()) <= 1e-10
    elif key == ("getting_started.md", 4):
        curve = out["residual_curve"]
        assert curve.shape[0] == out["iterations"] // 10
        assert bool(torch.isfinite(curve).all()) and curve[-1] < curve[0]
    elif key == ("getting_started.md", 5):
        assert out["iterations"] == 1
    elif key == ("migrating_from_proximalalgorithms.md", 1):
        assert out["iterations"] < 1000
