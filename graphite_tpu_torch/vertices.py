"""Vertex (optimizable-variable) traits and host-side batches.

Counterpart of ``graphite_tpu/vertices.py``. A vertex type is a trait with
batched functions on tensors; a batch of vertices is one ``(count,
ambient_dim)`` tensor after ``Graph.freeze``.

- ``retract(x (V, ambient), delta (V, dim)) -> (V, ambient)`` applies a
  local update (additive by default).
- ``save_state(x)`` / ``load_state(x, state)`` give the trust-region
  backup its partial-state semantics (full copy by default).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np


def _additive_retract(x, delta):
    return x + delta


def _full_save(x):
    return x


def _full_load(x, state):
    return state


@dataclasses.dataclass(frozen=True)
class VertexType:
    """Static trait of one type of optimizable variable.

    Attributes:
      name: unique name; the key of this type's parameter tensor.
      dim: tangent (update / Hessian block) dimension.
      ambient_dim: stored parameter dimension (== dim when None).
      retract / save_state / load_state: batched functions, see module doc.
    """

    name: str
    dim: int
    ambient_dim: Optional[int] = None
    retract: Callable = _additive_retract
    save_state: Callable = _full_save
    load_state: Callable = _full_load

    def __post_init__(self):
        if self.ambient_dim is None:
            object.__setattr__(self, "ambient_dim", self.dim)

    def __hash__(self):
        return hash((self.name, self.dim, self.ambient_dim))

    def __eq__(self, other):
        return self is other or (
            isinstance(other, VertexType)
            and (self.name, self.dim, self.ambient_dim)
            == (other.name, other.dim, other.ambient_dim)
        )


def vertex_type(name: str, dim: int, **kw) -> VertexType:
    return VertexType(name=name, dim=dim, **kw)


@dataclasses.dataclass
class VertexSet:
    """Host-side batch of same-typed vertices (graph-construction phase).

    NumPy bookkeeping: ``add_batch``, ``set_fixed``, ``set_eliminate``.
    ``Graph.freeze`` turns it into static structure plus a device tensor.
    The JAX package's per-vertex mutation (``add``, ``remove``,
    ``replace``) is not ported yet.
    """

    vtype: VertexType
    values: list = dataclasses.field(default_factory=list)
    global_ids: list = dataclasses.field(default_factory=list)
    id_to_local: dict = dataclasses.field(default_factory=dict)
    fixed: list = dataclasses.field(default_factory=list)
    eliminate: bool = False

    @property
    def count(self) -> int:
        return len(self.values)

    def add_batch(self, global_ids, values) -> np.ndarray:
        """Bulk add (vectorized bookkeeping)."""
        values = np.asarray(values, dtype=np.float64)
        global_ids = np.asarray(global_ids, dtype=np.int64)
        n = global_ids.shape[0]
        if values.shape != (n, self.vtype.ambient_dim):
            raise ValueError(
                f"values must be ({n}, {self.vtype.ambient_dim}); got "
                f"{values.shape}"
            )
        if len(np.unique(global_ids)) != n:
            raise KeyError("duplicate vertex ids in batch")
        if self.id_to_local:
            clash = set(self.id_to_local).intersection(global_ids.tolist())
            if clash:
                raise KeyError(f"vertex id {next(iter(clash))} already present")
        start = len(self.values)
        self.values.extend(list(values))
        self.global_ids.extend(global_ids.tolist())
        self.id_to_local.update(
            zip(global_ids.tolist(), range(start, start + n))
        )
        self.fixed.extend([False] * n)
        return np.arange(start, start + n)

    def set_fixed(self, global_id: int, fixed: bool = True) -> None:
        self.fixed[self.id_to_local[global_id]] = bool(fixed)

    def set_eliminate(self, eliminate: bool = True) -> None:
        """Mark the whole set for Schur elimination."""
        self.eliminate = bool(eliminate)

    def values_array(self) -> np.ndarray:
        if not self.values:
            return np.zeros((0, self.vtype.ambient_dim))
        return np.stack(self.values, axis=0)

    def fixed_array(self) -> np.ndarray:
        return np.asarray(self.fixed, dtype=bool)
