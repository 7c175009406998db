"""Linear-solver protocol (counterpart of ``graphite_tpu/solvers/base.py``).

- ``prepare(problem, lin, params)``: the values that depend only on the
  linearization (structure is fixed at ``Graph.freeze``), refreshed by the
  optimizer whenever the linearization changes;
- ``solve(problem, lin, state, damping, use_identity, params)``: the
  damped solve, returning ``(delta_x, ok)``. ``ok`` is a boolean tensor on
  the problem's device; ``False`` signals a failed factorization, which
  the LM loop treats as a rejected step.
"""

from __future__ import annotations

from typing import Protocol, Tuple

import torch


class Solver(Protocol):
    def prepare(self, problem, lin, params=None): ...

    def solve(self, problem, lin, state, damping, use_identity,
              params=None) -> Tuple[torch.Tensor, torch.Tensor]: ...
