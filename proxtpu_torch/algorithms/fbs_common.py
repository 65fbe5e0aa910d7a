"""Shared machinery of the f(Ax) + g(x) line-search family (ZeroFPR, PANOC,
PANOCplus; counterpart of ``proxtpu/algorithms/fbs_common.py``): the cold
start and the direction-strategy trio."""

from __future__ import annotations

import torch

from ..accel.base import NO_ACCELERATION, QUASI_NEWTON
from ..prox.base import prox, value_and_gradient
from ..utils.fb_tools import lower_bound_smoothness_constant
from ..utils.tree import tree_map, tree_neg, tree_sub, tree_where


def forward_backward_init(f, A, g, x0, gamma, alpha):
    """One matvec and gradient, ``gamma = alpha / L_est`` when unset, one
    prox."""
    x = x0
    Ax = A.matvec(x)
    f_Ax, grad_f_Ax = value_and_gradient(f, Ax)
    if gamma is None:
        gamma = alpha / lower_bound_smoothness_constant(f, A, x, grad_f_Ax)
    At_grad_f_Ax = A.rmatvec(grad_f_Ax)
    y = tree_map(lambda xl, gl: xl - gamma * gl, x, At_grad_f_Ax)
    z, g_z = prox(g, y, gamma)
    res = tree_sub(x, z)
    return (x, Ax, f_Ax, grad_f_Ax, At_grad_f_Ax, torch.as_tensor(gamma), y,
            z, g_z, res)


def next_direction(directions, dstate, v_qn, v_fallback):
    """Quasi-Newton: d = -(H v_qn); no acceleration: d = -v_fallback."""
    if directions.style == QUASI_NEWTON:
        return tree_neg(directions.apply(dstate, v_qn))
    if directions.style == NO_ACCELERATION:
        return tree_neg(v_fallback)
    raise ValueError(f"direction style {directions.style!r} not supported "
                     "by this algorithm")


def update_direction(directions, dstate, s, y):
    if directions.style == QUASI_NEWTON:
        return directions.update(dstate, s, y)
    return dstate


def reset_direction_if(directions, dstate, pred):
    """Reset the metric where ``pred`` (gamma changed in the backtracking)
    holds, by a select."""
    if directions.style == QUASI_NEWTON:
        return tree_where(pred, directions.reset(dstate), dstate)
    return dstate
