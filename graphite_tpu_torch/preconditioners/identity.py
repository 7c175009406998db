"""Identity preconditioner (counterpart of
``graphite_tpu/preconditioners/identity.py``)."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class IdentityPreconditioner:
    def prepare(self, problem, lin, params=None):
        return ()

    def set_damping(self, problem, lin, state, damping, use_identity):
        return state

    def apply(self, problem, lin, state, r: torch.Tensor) -> torch.Tensor:
        return r
