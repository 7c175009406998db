"""Factor (constraint) traits and host-side batches.

Counterpart of ``graphite_tpu/factors.py``. A factor type is a batched
residual over N vertex parameter blocks, an optional batched analytic
Jacobian, a robust loss and observation/data layouts:

- ``residual_fn(p_0 (F, a_0), ..., p_{N-1}, [obs (F, ...)], [data (F, ...)])
  -> (F, E)``; ``obs``/``data`` are passed only when the batch has them.
  Written with ``[..., i]`` indexing, the same function also evaluates one
  factor, which is what ``torch.func`` transforms need.
- ``jacobian_fn(same arguments) -> tuple of (F, E, dim_i)`` Jacobians with
  respect to each slot's tangent. Without one (``Differentiation.AUTO``),
  ``linearize`` differentiates the residual through each slot's
  ``retract`` at delta = 0 with ``torch.func.jvp``.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Callable, Optional, Sequence, Tuple

import numpy as np

from .loss import DEFAULT_LOSS, Loss
from .vertices import VertexType


class Differentiation(enum.Enum):
    AUTO = "auto"
    MANUAL = "manual"


@dataclasses.dataclass(frozen=True)
class FactorType:
    """Static trait of one type of factor (see module doc)."""

    name: str
    residual_dim: int
    vertex_types: Tuple[VertexType, ...]
    residual_fn: Callable
    jacobian_fn: Optional[Callable] = None
    loss: Loss = DEFAULT_LOSS
    obs_shape: Optional[Tuple[int, ...]] = None
    data_shape: Optional[Tuple[int, ...]] = None

    def __post_init__(self):
        object.__setattr__(self, "vertex_types", tuple(self.vertex_types))

    @property
    def arity(self) -> int:
        return len(self.vertex_types)

    @property
    def differentiation(self) -> Differentiation:
        return Differentiation.MANUAL if self.jacobian_fn else Differentiation.AUTO

    def __hash__(self):
        return hash((self.name, self.residual_dim, self.vertex_types))

    def __eq__(self, other):
        return self is other or (
            isinstance(other, FactorType)
            and (self.name, self.residual_dim, self.vertex_types)
            == (other.name, other.residual_dim, other.vertex_types)
        )


def factor_type(name: str, residual_dim: int,
                vertex_types: Sequence[VertexType], residual_fn: Callable,
                **kw) -> FactorType:
    return FactorType(name=name, residual_dim=residual_dim,
                      vertex_types=tuple(vertex_types),
                      residual_fn=residual_fn, **kw)


# Active byte: bits 0-6 are the optimization level, the MSB disables the
# factor; a factor is active when (byte & 0x7F) <= level and the MSB is 0.
MAX_LEVEL = 0x7F


@dataclasses.dataclass
class FactorSet:
    """Host-side batch of same-typed factors (graph-construction phase):
    columnar chunks appended by ``add_batch`` and concatenated at freeze.
    The JAX package's per-factor mutation (``add``, ``remove``,
    ``set_active``) is not ported yet.
    """

    ftype: FactorType
    _chunks: list = dataclasses.field(default_factory=list)

    @property
    def count(self) -> int:
        return sum(c["ids"].shape[0] for c in self._chunks)

    def add_batch(self, vertex_ids, obs=None, precision=None, data=None,
                  loss_params=None, levels=None) -> None:
        """Append ``n`` factors: ``vertex_ids`` (n, arity) global ids, and
        per-factor observations, data, E x E precisions, loss parameters
        and active bytes (see ``MAX_LEVEL``)."""
        vertex_ids = np.asarray(vertex_ids, dtype=np.int64)
        if vertex_ids.ndim != 2 or vertex_ids.shape[1] != self.ftype.arity:
            raise ValueError(
                f"vertex_ids must be (n, {self.ftype.arity}); got "
                f"{vertex_ids.shape}"
            )
        n = vertex_ids.shape[0]
        chunk = dict(
            ids=vertex_ids,
            obs=None if obs is None else np.asarray(obs, dtype=np.float64),
            data=None if data is None else np.asarray(data, dtype=np.float64),
            precision=(None if precision is None
                       else np.asarray(precision, dtype=np.float64)),
            loss_params=(
                np.full(n, self.ftype.loss.default_param())
                if loss_params is None
                else np.asarray(loss_params, dtype=np.float64)
            ),
            levels=(np.zeros(n, dtype=np.int64) if levels is None
                    else np.asarray(levels, dtype=np.int64)),
        )
        for field in ("obs", "data", "precision", "loss_params", "levels"):
            arr = chunk[field]
            if arr is not None and arr.shape[0] != n:
                raise ValueError(f"{field} first dim must be {n}")
        self._chunks.append(chunk)

    # ---- freeze-time array exports -------------------------------------
    def _concat(self, field) -> Optional[np.ndarray]:
        """``field`` of every chunk, concatenated; None when no chunk has
        it."""
        parts = [c[field] for c in self._chunks]
        if all(p is None for p in parts):
            return None
        if any(p is None for p in parts):
            raise ValueError(f"'{field}' given for some batches only")
        return np.concatenate(parts, axis=0)

    def ids_array(self) -> np.ndarray:
        out = self._concat("ids")
        if out is None:
            return np.zeros((0, self.ftype.arity), dtype=np.int64)
        return out

    def level_array(self) -> np.ndarray:
        out = self._concat("levels")
        return np.zeros(0, dtype=np.int64) if out is None else out

    def obs_array(self) -> Optional[np.ndarray]:
        return self._concat("obs")

    def data_array(self) -> Optional[np.ndarray]:
        return self._concat("data")

    def has_precision(self) -> bool:
        return any(c["precision"] is not None for c in self._chunks)

    def precision_array(self) -> np.ndarray:
        """Per-factor E x E precision; identity where unset."""
        e = self.ftype.residual_dim
        eye = np.eye(e)
        parts = [np.broadcast_to(eye, (c["ids"].shape[0], e, e))
                 if c["precision"] is None
                 else c["precision"].reshape(-1, e, e) for c in self._chunks]
        if not parts:
            return np.zeros((0, e, e))
        return np.concatenate(parts, axis=0)

    def loss_params_array(self) -> np.ndarray:
        out = self._concat("loss_params")
        return np.zeros(0) if out is None else out
