"""Direction-strategy protocol (counterpart of ``proxtpu/accel/base.py``).

A strategy is a frozen dataclass with no tensors of its own, exposing:

* ``style``                      -- "quasi_newton" | "nesterov" | "none"
* ``init_state(x)``              -- a fixed-shape tree of tensors
* quasi-Newton: ``apply(state, v) -> H v``, ``update(state, s, y) ->
  state``, ``reset(state) -> state``
* nesterov: ``next_coeff(state, gamma) -> (beta, state)``

Every transition is pure and keeps its shapes, so a strategy state lives in
an algorithm's state and maps lane by lane under ``torch.func.vmap``.
"""

from __future__ import annotations

QUASI_NEWTON = "quasi_newton"
NESTEROV = "nesterov"
NO_ACCELERATION = "none"


def acceleration_style(strategy) -> str:
    return getattr(strategy, "style", NO_ACCELERATION)
