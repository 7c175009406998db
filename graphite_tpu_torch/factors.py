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
    """Host-side batch of same-typed factors (graph-construction phase).

    ``add`` appends one factor and returns its handle; ``add_batch``
    appends a columnar chunk (the fast path for bulk loads: no per-factor
    Python work) and returns its handles, a contiguous range. The chunks
    are moved into the per-factor lists on the first per-factor mutation
    (``add``, ``remove``, ``set_active``). ``remove`` swaps the last factor
    into the removed one's place; handles are recycled. Freeze-time
    exports give the per-factor lists first, then the chunks.
    """

    ftype: FactorType
    ids: list = dataclasses.field(default_factory=list)  # (arity,) tuples
    obs: list = dataclasses.field(default_factory=list)
    data: list = dataclasses.field(default_factory=list)
    precision: list = dataclasses.field(default_factory=list)  # or None
    loss_params: list = dataclasses.field(default_factory=list)
    level: list = dataclasses.field(default_factory=list)
    handles: list = dataclasses.field(default_factory=list)
    _handle_to_index: dict = dataclasses.field(default_factory=dict)
    _next_handle: int = 0
    _free_handles: list = dataclasses.field(default_factory=list)
    _bulk: list = dataclasses.field(default_factory=list)  # columnar chunks
    # False: linearize stores no Jacobian for this set; the matrix-free
    # products recompute it from the parameters (dynamic mode)
    store_jacobians: bool = True

    _FIELDS = ("ids", "obs", "data", "precision", "loss_params", "level",
               "handles")

    @property
    def count(self) -> int:
        return len(self.ids) + sum(c["ids"].shape[0] for c in self._bulk)

    def add(self, vertex_ids: Sequence[int], obs=None, precision=None,
            data=None, loss_param: Optional[float] = None,
            level: int = 0) -> int:
        """Append one factor; returns its handle."""
        if len(vertex_ids) != self.ftype.arity:
            raise ValueError(
                f"factor '{self.ftype.name}' expects {self.ftype.arity} "
                f"vertex ids, got {len(vertex_ids)}")
        if not 0 <= level <= MAX_LEVEL:
            raise ValueError(f"level must be in [0, {MAX_LEVEL}]")
        self._materialize_bulk()
        idx = len(self.ids)
        self.ids.append(tuple(int(i) for i in vertex_ids))
        self.obs.append(None if obs is None
                        else np.asarray(obs, dtype=np.float64))
        self.data.append(None if data is None
                         else np.asarray(data, dtype=np.float64))
        self.precision.append(None if precision is None
                              else np.asarray(precision, dtype=np.float64))
        self.loss_params.append(self.ftype.loss.default_param()
                                if loss_param is None else float(loss_param))
        self.level.append(int(level))
        if self._free_handles:
            handle = self._free_handles.pop()
        else:
            handle = self._next_handle
            self._next_handle += 1
        self.handles.append(handle)
        self._handle_to_index[handle] = idx
        return handle

    def add_batch(self, vertex_ids, obs=None, precision=None, data=None,
                  loss_params=None, levels=None) -> np.ndarray:
        """Append ``n`` factors: ``vertex_ids`` (n, arity) global ids, and
        per-factor observations, data, E x E precisions, loss parameters
        and active bytes (see ``MAX_LEVEL``). Returns their handles."""
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
        chunk["handles"] = np.arange(self._next_handle,
                                     self._next_handle + n)
        self._next_handle += n
        self._bulk.append(chunk)
        return chunk["handles"]

    def _materialize_bulk(self) -> None:
        """Move the columnar chunks into the per-factor lists."""
        for chunk in self._bulk:
            n = chunk["ids"].shape[0]
            start = len(self.ids)
            self.ids.extend(map(tuple, chunk["ids"].tolist()))
            for field in ("obs", "data", "precision"):
                arr = chunk[field]
                getattr(self, field).extend(
                    [None] * n if arr is None else list(arr))
            self.loss_params.extend(chunk["loss_params"].tolist())
            self.level.extend(chunk["levels"].tolist())
            self.handles.extend(chunk["handles"].tolist())
            self._handle_to_index.update(
                zip(chunk["handles"].tolist(), range(start, start + n)))
        self._bulk.clear()

    def remove(self, handle: int) -> None:
        """Remove a factor; the last one takes its place."""
        self._materialize_bulk()
        idx = self._handle_to_index.pop(handle)
        last = len(self.ids) - 1
        lists = [getattr(self, f) for f in self._FIELDS]
        if idx != last:
            for lst in lists:
                lst[idx] = lst[last]
            self._handle_to_index[self.handles[idx]] = idx
        for lst in lists:
            lst.pop()
        self._free_handles.append(handle)

    def set_active(self, handle: int, level_byte: int) -> None:
        """Set a factor's active byte: bits 0-6 the level, the MSB
        disables it."""
        self._materialize_bulk()
        self.level[self._handle_to_index[handle]] = int(level_byte)

    def set_level(self, handle: int, level: int, enabled: bool = True) -> None:
        self.set_active(handle,
                        (int(level) & MAX_LEVEL) | (0 if enabled else 0x80))

    def set_jacobian_storage(self, store: bool) -> None:
        """``False``: dynamic mode, J recomputed in every matvec."""
        self.store_jacobians = bool(store)

    def clear(self) -> None:
        """Drop every factor; handles restart at 0."""
        for f in self._FIELDS:
            getattr(self, f).clear()
        self._bulk.clear()
        self._handle_to_index.clear()
        self._free_handles.clear()
        self._next_handle = 0

    # ---- freeze-time array exports -------------------------------------
    def _concat(self, field, bulk_field=None) -> Optional[np.ndarray]:
        """``field`` of the per-factor lists then of every chunk,
        concatenated; None when no factor has it."""
        items = getattr(self, field)
        parts = []
        if items:
            parts.append(None if items[0] is None else np.stack(
                [np.asarray(o, dtype=np.float64) for o in items]))
        parts += [c[bulk_field or field] for c in self._bulk]
        if all(p is None for p in parts):
            return None
        if any(p is None for p in parts):
            raise ValueError(f"'{field}' given for some factors only")
        return np.concatenate(parts, axis=0)

    def ids_array(self) -> np.ndarray:
        parts = [np.asarray(self.ids, dtype=np.int64).reshape(
            -1, self.ftype.arity)]
        parts += [c["ids"] for c in self._bulk]
        return np.concatenate(parts, axis=0)

    def level_array(self) -> np.ndarray:
        parts = [np.asarray(self.level, dtype=np.int64)]
        parts += [c["levels"] for c in self._bulk]
        return np.concatenate(parts)

    def handle_array(self) -> np.ndarray:
        """The handle of each factor, in storage order."""
        parts = [np.asarray(self.handles, dtype=np.int64)]
        parts += [np.asarray(c["handles"], dtype=np.int64)
                  for c in self._bulk]
        return np.concatenate(parts)

    def obs_array(self) -> Optional[np.ndarray]:
        return self._concat("obs")

    def data_array(self) -> Optional[np.ndarray]:
        return self._concat("data")

    def has_precision(self) -> bool:
        return (any(p is not None for p in self.precision)
                or any(c["precision"] is not None for c in self._bulk))

    def precision_array(self) -> np.ndarray:
        """Per-factor E x E precision; identity where unset."""
        e = self.ftype.residual_dim
        eye = np.eye(e)
        parts = [np.stack([eye if p is None else np.asarray(p).reshape(e, e)
                           for p in self.precision])] if self.precision else []
        parts += [np.broadcast_to(eye, (c["ids"].shape[0], e, e))
                  if c["precision"] is None
                  else c["precision"].reshape(-1, e, e) for c in self._bulk]
        if not parts:
            return np.zeros((0, e, e))
        return np.concatenate(parts, axis=0)

    def loss_params_array(self) -> np.ndarray:
        parts = [np.asarray(self.loss_params, dtype=np.float64)]
        parts += [c["loss_params"] for c in self._bulk]
        return np.concatenate(parts)
