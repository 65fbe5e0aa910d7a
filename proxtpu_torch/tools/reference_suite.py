"""The reference's benchmark matrix on the port: the ten solver
configurations of ``benchmarks/run_benchmarks.py`` (FB, FISTA, ZeroFPR,
PANOC, PANOCplus, Douglas-Rachford, DRLS, AFBA in two formulations, SFISTA)
on the lasso instances shipped in ``benchmarks/data/*.npz``, with the same
tolerances (1e-6, SFISTA 1e-3) and iteration caps.  The solves run where
the operands live.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .. import algorithms as alg
from ..prox import functions as fns

DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "benchmarks", "data")
WORKLOADS = ("lasso_tiny", "lasso_small", "lasso_medium")
CONFIGS = ("ForwardBackward", "FastForwardBackward", "ZeroFPR", "PANOC",
           "PANOCplus", "DouglasRachford", "DRLS", "AFBA-1", "AFBA-2",
           "SFISTA")
# maxit above the library defaults, so that every solve reaches tol
MAXIT = {"ForwardBackward": 200_000, "DouglasRachford": 100_000}
# the instance each configuration is timed on: lasso_medium, but
# Douglas-Rachford's 54,682 iterations there took 56 s of a 183.5 s phase
# on an H100 (budget 120 s), so it alone runs lasso_small (5,175)
TIMED_ON = {"DouglasRachford": "lasso_small"}
# the float32 line and its tolerances: DRLS's residual ||u - v|| / gamma,
# with gamma = 0.95 / ||A||^2, cannot reach 1e-6 in float32 on
# lasso_medium (it runs to maxit in both packages); it converges at 1e-4
FLOAT32_LINE = {"PANOC": 1e-6, "ZeroFPR": 1e-6, "DRLS": 1e-4}


def load_workload(name):
    """``(A, b, lam)`` of one instance as float64 numpy arrays and a
    float."""
    with np.load(os.path.join(DATA_DIR, f"{name}.npz")) as f:
        return f["A"], f["b"], float(f["lam"])


def solver_configs(A, b, lam):
    """``{name: (solver, kwargs)}`` for the tensors ``A`` (m, n) and ``b``
    (m,), in their dtype and on their device; ``x0 = 0``."""
    m, n = A.shape
    x0 = A.new_zeros(n)
    g = fns.NormL1(lam)
    fls = fns.make_least_squares(A, b)
    fsd = fns.SqrDistance(b)
    opn2 = float(torch.linalg.matrix_norm(A.double(), 2) ** 2)
    return {
        "ForwardBackward": (
            alg.ForwardBackward(tol=1e-6, maxit=MAXIT["ForwardBackward"]),
            dict(x0=x0, f=fls, g=g)),
        "FastForwardBackward": (alg.FastForwardBackward(tol=1e-6),
                                dict(x0=x0, f=fls, g=g)),
        "ZeroFPR": (alg.ZeroFPR(tol=1e-6), dict(x0=x0, f=fsd, A=A, g=g)),
        "PANOC": (alg.PANOC(tol=1e-6), dict(x0=x0, f=fsd, A=A, g=g)),
        "PANOCplus": (alg.PANOCplus(tol=1e-6),
                      dict(x0=x0, f=fsd, A=A, g=g)),
        "DouglasRachford": (
            alg.DouglasRachford(tol=1e-6, maxit=MAXIT["DouglasRachford"]),
            dict(x0=x0, f=fls, g=g, gamma=1.0)),
        "DRLS": (alg.DRLS(tol=1e-6), dict(x0=x0, f=fls, g=g, Lf=opn2)),
        "AFBA-1": (alg.AFBA(theta=1.0, mu=1.0, tol=1e-6),
                   dict(x0=x0, y0=A.new_zeros(n), f=fls, g=g, beta_f=opn2)),
        "AFBA-2": (alg.AFBA(theta=1.0, mu=1.0, tol=1e-6),
                   dict(x0=x0, y0=A.new_zeros(m),
                        h=fns.Translate(fns.SqrNormL2(1.0), -b), L=A, g=g)),
        "SFISTA": (alg.SFISTA(tol=1e-3), dict(x0=x0, f=fls, g=g, Lf=opn2)),
    }


def primal(solution):
    """The x of a solver's solution (AFBA returns (x, y))."""
    return solution[0] if isinstance(solution, tuple) else solution


def fb_recheck(A, b, lam, x):
    """The forward-backward fixed-point residual in float64 on the host,
    ``||x - prox_{gamma g}(x - gamma A^T (A x - b))||_inf / gamma`` at
    ``gamma = 1 / ||A||_2^2``: one certificate for every solver's answer."""
    A, b = np.asarray(A, np.float64), np.asarray(b, np.float64)
    x = np.asarray(x, np.float64)
    gamma = 1.0 / np.linalg.norm(A, 2) ** 2
    y = x - gamma * (A.T @ (A @ x - b))
    z = np.sign(y) * np.maximum(np.abs(y) - gamma * lam, 0.0)
    return float(np.max(np.abs(x - z)) / gamma)
