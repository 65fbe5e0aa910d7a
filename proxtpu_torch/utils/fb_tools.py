"""Forward-backward toolkit: quadratic model, Lipschitz estimate and
backtracking (counterpart of ``proxtpu/utils/fb_tools.py``)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..prox.base import prox, value_and_gradient
from .tree import (
    eps_of,
    real_dtype_of,
    tree_leaves,
    tree_map,
    tree_norm_sq,
    tree_size,
    tree_sub,
    tree_vdot_real,
    tree_where,
)


def f_model(f_x, grad_f_x, res, L):
    """Quadratic upper model f(x) - <grad, res> + L/2 ||res||^2."""
    return f_x - tree_vdot_real(grad_f_x, res) + (L / 2) * tree_norm_sq(res)


def lower_bound_smoothness_constant(f, A, x, grad_f_Ax):
    """Finite-difference lower bound on the Lipschitz constant of
    grad(f o A), which sets gamma when neither Lf nor gamma is given."""
    xeps = tree_map(lambda l: l + 1, x)
    _, grad_f_Axeps = value_and_gradient(f, A.matvec(xeps))
    diff = A.rmatvec(tree_sub(grad_f_Axeps, grad_f_Ax))
    n = torch.tensor(float(tree_size(x)), dtype=real_dtype_of(x),
                     device=tree_leaves(x)[0].device)
    return torch.sqrt(tree_norm_sq(diff)) / torch.sqrt(n)


class BacktrackResult(NamedTuple):
    gamma: torch.Tensor
    y: object
    z: object
    g_z: torch.Tensor
    res: object
    Az: object
    f_Az: torch.Tensor
    grad_f_Az: object
    f_Az_upp: torch.Tensor


def backtrack_stepsize(gamma, f, A, g, x, f_Ax, At_grad_f_Ax, y, z, g_z, res,
                       *, alpha=1.0, minimum_gamma=1e-7, reduce_gamma=0.5,
                       max_backtracks=None):
    """Armijo-style backtracking on the quadratic model: halve ``gamma``
    until ``f(Az) <= f_model(...) + 10 eps (1 + |f(Az)|)`` or ``gamma <
    minimum_gamma``.  ``y``, ``z``, ``g_z`` and ``res`` must belong to the
    incoming gamma.

    ``max_backtracks=None`` loops on the host until the test holds (one
    problem).  ``max_backtracks=T`` runs exactly T masked trials, keeping
    the first accepted one: the same result whenever the search ends
    within T halvings, and the form that runs under ``torch.func.vmap``,
    where a loop may not branch on a tensor."""
    eps = eps_of(x)
    gamma = torch.as_tensor(gamma)

    def accept(c):
        tol = 10 * eps * (1 + torch.abs(c.f_Az))
        return (c.f_Az <= c.f_Az_upp + tol) | (c.gamma < minimum_gamma)

    def trial(c):
        gam = c.gamma * reduce_gamma
        y = tree_map(lambda xl, gl: xl - gam * gl, x, At_grad_f_Ax)
        z, g_z = prox(g, y, gam)
        res = tree_sub(x, z)
        f_Az_upp = f_model(f_Ax, At_grad_f_Ax, res, alpha / gam)
        Az = A.matvec(z)
        f_Az, grad_f_Az = value_and_gradient(f, Az)
        return BacktrackResult(gam, y, z, g_z, res, Az, f_Az, grad_f_Az,
                               f_Az_upp)

    Az0 = A.matvec(z)
    f_Az0, grad_f_Az0 = value_and_gradient(f, Az0)
    c = BacktrackResult(gamma, y, z, g_z, res, Az0, f_Az0, grad_f_Az0,
                        f_model(f_Ax, At_grad_f_Ax, res, alpha / gamma))
    if max_backtracks is None:
        while not bool(accept(c)):
            c = trial(c)
        return c
    for _ in range(int(max_backtracks)):
        c = tree_where(accept(c), c, trial(c))
    return c
