"""Linear-solver protocol (counterpart of ``graphite_tpu/solvers/base.py``).

- ``prepare(problem, lin, params, out=None)``: the values that depend
  only on the linearization (structure is fixed at ``Graph.freeze``),
  refreshed by the optimizer whenever the linearization changes. With
  ``out`` (a state of the same solver on the same problem, which the call
  does not read) they are written into ``out``'s tensors and ``out`` is
  returned: the LM device loop keeps its state in tensors made before the
  captured iteration. A solver that forms its state in place does so; the
  others copy a new state in (``prepared``);
- ``solve(problem, lin, state, damping, use_identity, params)``: the
  damped solve, returning ``(delta_x, ok)``. ``ok`` is a boolean tensor on
  the problem's device; ``False`` signals a failed factorization, which
  the LM loop treats as a rejected step.
"""

from __future__ import annotations

from typing import Protocol, Tuple

import torch

from ..ops.device_loop import copy_into


class Solver(Protocol):
    def prepare(self, problem, lin, params=None, out=None): ...

    def solve(self, problem, lin, state, damping, use_identity,
              params=None) -> Tuple[torch.Tensor, torch.Tensor]: ...


def prepared(state, out=None):
    """``state``, or with ``out`` ``state`` copied into ``out`` (in place)
    and ``out``: ``prepare(out=)`` of a solver that forms a new state."""
    if out is None:
        return state
    copy_into(out, state)
    return out
