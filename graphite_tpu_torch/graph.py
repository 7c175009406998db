"""Graph container and topology freeze (counterpart of
``graphite_tpu/graph.py``).

All sparsity discovery happens once per topology on the host in NumPy
(``Graph.freeze``); the frozen ``Problem`` carries that static structure
plus tensors on an explicit device.

- Vertices are sorted by (eliminated, type, global id), so eliminated
  types occupy the trailing Hessian columns and every type's active
  columns form one contiguous, uniformly strided segment: a flat vector
  reshapes to ``(n_rows, dim)`` per type (``rows_view`` /
  ``flat_from_rows``).
- Fixed or unreferenced vertices get no column. Their scatter target is a
  trash pad past ``dim_h`` (flat view) or a trash row ``n_rows`` (row
  view), and their Jacobian blocks are masked to zero: masking, not
  compaction, so shapes never depend on activity.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .factors import MAX_LEVEL, FactorSet, FactorType
from .precision import FP32_FP32, Precision
from .vertices import VertexSet, VertexType


def is_factor_active(level_byte: np.ndarray, opt_level: int) -> np.ndarray:
    return ((level_byte & MAX_LEVEL) <= opt_level) & ((level_byte & 0x80) == 0)


@dataclasses.dataclass
class VertexArrays:
    """Per-vertex-type device tensors."""

    col_offset: torch.Tensor  # (V,) int64; dim_h for inactive (trash column)
    active: torch.Tensor  # (V,) bool
    active_row: torch.Tensor  # (V,) int64; trash row n_rows when inactive


@dataclasses.dataclass
class FactorArrays:
    """Per-factor-type device tensors."""

    ids: Tuple[torch.Tensor, ...]  # N x (F,) int64 local vertex indices
    rows: Tuple[torch.Tensor, ...]  # N x (F,) int64 active-row indices
    obs: Optional[torch.Tensor]  # (F, *obs_shape) graph dtype
    data: Optional[torch.Tensor]
    precision: Optional[torch.Tensor]  # (F, E*E) solver dtype; None = identity
    loss_params: torch.Tensor  # (F,) graph dtype
    factor_mask: torch.Tensor  # (F,) bool
    slot_mask: torch.Tensor  # (F, N) bool: factor active and vertex active


@dataclasses.dataclass
class GraphData:
    vertices: Dict[str, VertexArrays]
    factors: Dict[str, FactorArrays]


@dataclasses.dataclass(frozen=True)
class VertexMeta:
    vtype: VertexType
    count: int


@dataclasses.dataclass(frozen=True)
class FactorMeta:
    ftype: FactorType
    count: int


class BlockVertexMap:
    """Block id -> (vertex type, local index), stored as two arrays."""

    def __init__(self, type_names, type_codes: np.ndarray,
                 local_ids: np.ndarray):
        self.type_names: List[str] = list(type_names)
        self.type_codes = np.asarray(type_codes, dtype=np.int64)
        self.local_ids = np.asarray(local_ids, dtype=np.int64)

    def __len__(self) -> int:
        return self.type_codes.shape[0]

    def __getitem__(self, j):
        return (self.type_names[int(self.type_codes[j])],
                int(self.local_ids[j]))

    def type_of(self, ids=None) -> np.ndarray:
        """Type names per block id as a NumPy unicode array."""
        names = np.asarray(self.type_names)
        codes = self.type_codes if ids is None else self.type_codes[ids]
        return names[codes]


@dataclasses.dataclass
class HostStructure:
    """NumPy copies of the freeze products, read by the Hessian / Schur
    structure builders and by tests."""

    vertex_col_offset: Dict[str, np.ndarray]
    vertex_block_id: Dict[str, np.ndarray]
    vertex_active: Dict[str, np.ndarray]
    vertex_active_row: Dict[str, np.ndarray]
    vertex_fixed: Dict[str, np.ndarray]
    factor_ids: Dict[str, np.ndarray]  # (F, N) local indices
    factor_mask: Dict[str, np.ndarray]
    slot_mask: Dict[str, np.ndarray]
    global_ids: Dict[str, np.ndarray]


class Problem:
    """A frozen optimization problem on one device.

    Static attributes (host ints / NumPy): ``dim_h`` (active Hessian
    columns), ``pad`` (trash-pad width; flat vectors have ``dim_x = dim_h
    + pad`` entries), ``block_offsets`` / ``block_dims`` / ``block_vertex``
    per Hessian block, ``elimination_block`` / ``elimination_col`` (first
    eliminated block / column), ``seg_start`` / ``seg_rows`` /
    ``segment_order`` / ``row_vertex`` (the type-major row layout) and
    ``host`` (``HostStructure``).

    Device attributes: ``data`` (``GraphData``) and ``params0`` (name ->
    (V, ambient_dim) tensor).
    """

    def __init__(self, meta_v, meta_f, data, params0, *, device, dim_h, pad,
                 block_offsets, block_vertex, block_dims, elimination_block,
                 elimination_col, precision, host, seg_start,
                 seg_rows, segment_order, row_vertex):
        self.vertex_meta: Dict[str, VertexMeta] = meta_v
        self.factor_meta: Dict[str, FactorMeta] = meta_f
        self.data: GraphData = data
        self.params0: Dict[str, torch.Tensor] = params0
        self.device: torch.device = device
        self.dim_h: int = dim_h
        self.pad: int = pad
        self.block_offsets: np.ndarray = block_offsets
        self.block_vertex: BlockVertexMap = block_vertex
        self.block_dims: np.ndarray = block_dims
        self.elimination_block: int = elimination_block
        self.elimination_col: int = elimination_col
        self.precision: Precision = precision
        self.host: HostStructure = host
        self.seg_start: Dict[str, int] = seg_start
        self.seg_rows: Dict[str, int] = seg_rows
        self.segment_order: List[str] = segment_order
        self.row_vertex: Dict[str, np.ndarray] = row_vertex
        # host-built structure, plans and device index tensors, keyed by
        # the site that uses them (built on first use, then reused)
        self._cache: dict = {}

    # ---- device copies of host index arrays -------------------------------
    def index(self, key, np_array: np.ndarray) -> torch.Tensor:
        """Cached int64 device tensor of a static host index array."""
        store = self._cache.setdefault("index", {})
        if key not in store:
            store[key] = torch.as_tensor(
                np.asarray(np_array, dtype=np.int64), device=self.device)
        return store[key]

    def index32(self, key, np_array: np.ndarray) -> torch.Tensor:
        """Cached int32 device tensor of a static host index array: the
        kernels' C interface takes int32 (``index_select`` and
        ``index_add_`` take it too)."""
        store = self._cache.setdefault("index32", {})
        if key not in store:
            a = np.asarray(np_array, dtype=np.int64)
            if a.size and (a.min() < -(1 << 31) or a.max() >= (1 << 31)):
                raise ValueError(f"index {key} does not fit int32")
            store[key] = torch.as_tensor(a.astype(np.int32),
                                         device=self.device)
        return store[key]

    # ---- row views ---------------------------------------------------------
    def rows_view(self, x: torch.Tensor, vname: str) -> torch.Tensor:
        """Flat (dim_x,) -> (n_rows, dim) view of one type's segment."""
        d = self.vertex_meta[vname].vtype.dim
        n = self.seg_rows[vname]
        s = self.seg_start[vname]
        return x[s:s + n * d].reshape(n, d)

    def rows_view_padded(self, x: torch.Tensor, vname: str) -> torch.Tensor:
        """Row view plus one trailing zero trash row (index n_rows)."""
        rows = self.rows_view(x, vname)
        return torch.cat([rows, rows.new_zeros(1, rows.shape[1])])

    def flat_from_rows(self, rows: Dict[str, torch.Tensor],
                       dtype=None) -> torch.Tensor:
        """Per-type (n_rows, dim) tensors -> flat (dim_x,) vector; missing
        types and the pad contribute zeros."""
        dtype = dtype or self.precision.graph_dtype
        parts = []
        for name in self.segment_order:
            n = self.seg_rows[name] * self.vertex_meta[name].vtype.dim
            r = rows.get(name)
            if r is None:
                parts.append(torch.zeros(n, dtype=dtype, device=self.device))
            else:
                parts.append(r.reshape(n).to(dtype))
        parts.append(torch.zeros(self.pad, dtype=dtype, device=self.device))
        return torch.cat(parts)

    @property
    def dim_x(self) -> int:
        return self.dim_h + self.pad

    @property
    def n_blocks(self) -> int:
        return len(self.block_vertex)


class Graph:
    """Mutable graph-construction container; ``freeze`` returns a
    ``Problem``."""

    def __init__(self, precision: Precision = FP32_FP32):
        self.precision = precision
        self.vertex_sets: Dict[str, VertexSet] = {}
        self.factor_sets: Dict[str, FactorSet] = {}

    def add_vertex_set(self, vtype: VertexType) -> VertexSet:
        if vtype.name in self.vertex_sets:
            raise KeyError(f"vertex set '{vtype.name}' already added")
        vs = VertexSet(vtype)
        self.vertex_sets[vtype.name] = vs
        return vs

    def add_factor_set(self, ftype: FactorType) -> FactorSet:
        if ftype.name in self.factor_sets:
            raise KeyError(f"factor set '{ftype.name}' already added")
        for vt in ftype.vertex_types:
            if vt.name not in self.vertex_sets:
                raise KeyError(
                    f"factor '{ftype.name}' references vertex type "
                    f"'{vt.name}' which has not been added to the graph"
                )
        fs = FactorSet(ftype)
        self.factor_sets[ftype.name] = fs
        return fs

    def freeze(self, opt_level: int = 0,
               precision: Optional[Precision] = None,
               device=None) -> Problem:
        """Discover structure and build the ``Problem`` on ``device``
        (default: the CPU)."""
        precision = precision or self.precision
        device = torch.device("cpu" if device is None else device)
        gdt = precision.graph_dtype
        sdt = precision.solver_dtype

        for name, vs in self.vertex_sets.items():
            if vs.count == 0:
                print(f"Error: Vertex set '{name}' has no entries.",
                      file=sys.stderr)
        factor_sets = {}
        for name, fs in self.factor_sets.items():
            if fs.count == 0:
                print(f"Error: Factor set '{name}' has no entries.",
                      file=sys.stderr)
            else:
                factor_sets[name] = fs

        # 1. active factors + local id resolution
        factor_ids_local: Dict[str, np.ndarray] = {}
        factor_mask: Dict[str, np.ndarray] = {}
        for name, fs in factor_sets.items():
            gids = fs.ids_array()
            local = np.zeros_like(gids)
            for slot, vt in enumerate(fs.ftype.vertex_types):
                local[:, slot] = _resolve_ids(
                    self.vertex_sets[vt.name], gids[:, slot], name, slot)
            factor_ids_local[name] = local
            factor_mask[name] = is_factor_active(fs.level_array(), opt_level)

        # 2. vertex activity: not fixed and referenced by an active factor
        referenced = {name: np.zeros(vs.count, dtype=bool)
                      for name, vs in self.vertex_sets.items()}
        for name, fs in factor_sets.items():
            mask = factor_mask[name]
            local = factor_ids_local[name]
            for slot, vt in enumerate(fs.ftype.vertex_types):
                referenced[vt.name][local[mask, slot]] = True
        vertex_active = {name: referenced[name] & ~vs.fixed_array()
                         for name, vs in self.vertex_sets.items()}

        # 3. sort vertices by (eliminated, type, global id); assign columns
        # to the active ones by an exclusive scan of their dims
        type_names = list(self.vertex_sets)
        elim_cat, torder_cat, gid_cat, local_cat, active_cat, dim_cat = (
            [], [], [], [], [], [])
        for ti, (name, vs) in enumerate(self.vertex_sets.items()):
            n = vs.count
            elim_cat.append(np.full(n, bool(vs.eliminate)))
            torder_cat.append(np.full(n, ti, dtype=np.int64))
            gid_cat.append(np.asarray(vs.global_ids, dtype=np.int64))
            local_cat.append(np.arange(n, dtype=np.int64))
            active_cat.append(vertex_active[name])
            dim_cat.append(np.full(n, vs.vtype.dim, dtype=np.int64))
        elim_cat = np.concatenate(elim_cat)
        torder_cat = np.concatenate(torder_cat)
        gid_cat = np.concatenate(gid_cat)
        local_cat = np.concatenate(local_cat)
        active_cat = np.concatenate(active_cat)
        dim_cat = np.concatenate(dim_cat)

        order = np.lexsort((gid_cat, torder_cat, elim_cat))
        sel = order[active_cat[order]]
        n_blocks = sel.shape[0]
        dims_sel = dim_cat[sel]
        col_sel = np.concatenate([[0], np.cumsum(dims_sel)[:-1]]).astype(
            np.int64)
        dim_h = int(dims_sel.sum())
        elim_sel = elim_cat[sel]
        elimination_block = (int(np.argmax(elim_sel)) if np.any(elim_sel)
                             else n_blocks)
        block_offsets = np.concatenate([col_sel, [dim_h]]).astype(np.int64)
        elimination_col = int(block_offsets[elimination_block])

        torder_sel = torder_cat[sel]
        local_sel = local_cat[sel]
        block_vertex = BlockVertexMap(type_names, torder_sel, local_sel)
        vertex_col_offset, vertex_block_id, vertex_active_row = {}, {}, {}
        seg_start: Dict[str, int] = {}
        seg_rows: Dict[str, int] = {}
        row_vertex: Dict[str, np.ndarray] = {}
        segment_order: List[str] = []
        for ti, name in enumerate(type_names):
            count = self.vertex_sets[name].count
            col_off = np.full(count, -1, dtype=np.int64)
            blk_id = np.full(count, -1, dtype=np.int64)
            act_row = np.full(count, -1, dtype=np.int64)
            m = torder_sel == ti
            locs = local_sel[m]
            if locs.size:
                col_off[locs] = col_sel[m]
                blk_id[locs] = np.nonzero(m)[0]
                act_row[locs] = np.arange(locs.shape[0])
                seg_start[name] = int(col_sel[m][0])
                segment_order.append(name)
            else:
                seg_start[name] = dim_h
            seg_rows[name] = int(locs.shape[0])
            row_vertex[name] = locs.astype(np.int64)
            vertex_col_offset[name] = col_off
            vertex_block_id[name] = blk_id
            vertex_active_row[name] = act_row
        segment_order.sort(key=lambda n: seg_start[n])

        # 4. trash pad: inactive vertices point past dim_h (flat) and at
        # the trash row seg_rows[name] (row view)
        pad = max([vs.vtype.dim for vs in self.vertex_sets.values()] + [1])
        for name in type_names:
            off = vertex_col_offset[name]
            off[off < 0] = dim_h
            ar = vertex_active_row[name]
            ar[ar < 0] = seg_rows[name]

        # 5. device tensors
        def dev(a, dtype):
            return torch.as_tensor(np.asarray(a), device=device).to(dtype)

        vdata: Dict[str, VertexArrays] = {}
        params0: Dict[str, torch.Tensor] = {}
        meta_v: Dict[str, VertexMeta] = {}
        for name, vs in self.vertex_sets.items():
            vdata[name] = VertexArrays(
                col_offset=dev(vertex_col_offset[name], torch.int64),
                active=dev(vertex_active[name], torch.bool),
                active_row=dev(vertex_active_row[name], torch.int64),
            )
            params0[name] = dev(vs.values_array(), gdt)
            meta_v[name] = VertexMeta(vtype=vs.vtype, count=vs.count)

        fdata: Dict[str, FactorArrays] = {}
        meta_f: Dict[str, FactorMeta] = {}
        slot_mask_h: Dict[str, np.ndarray] = {}
        for name, fs in factor_sets.items():
            local = factor_ids_local[name]
            fmask = factor_mask[name]
            n, nslots = local.shape
            rows_arr = np.zeros((n, nslots), dtype=np.int64)
            smask = np.zeros((n, nslots), dtype=bool)
            for slot, vt in enumerate(fs.ftype.vertex_types):
                rows_arr[:, slot] = vertex_active_row[vt.name][local[:, slot]]
                smask[:, slot] = fmask & vertex_active[vt.name][local[:, slot]]
            slot_mask_h[name] = smask
            obs = fs.obs_array()
            data = fs.data_array()
            fdata[name] = FactorArrays(
                ids=tuple(dev(local[:, s], torch.int64) for s in range(nslots)),
                rows=tuple(dev(rows_arr[:, s], torch.int64)
                           for s in range(nslots)),
                obs=None if obs is None else dev(obs, gdt),
                data=None if data is None else dev(data, gdt),
                precision=(dev(fs.precision_array().reshape(n, -1), sdt)
                           if fs.has_precision() else None),
                loss_params=dev(fs.loss_params_array(), gdt),
                factor_mask=dev(fmask, torch.bool),
                slot_mask=dev(smask, torch.bool),
            )
            meta_f[name] = FactorMeta(ftype=fs.ftype, count=n)

        host = HostStructure(
            vertex_col_offset=vertex_col_offset,
            vertex_block_id=vertex_block_id,
            vertex_active=vertex_active,
            vertex_active_row=vertex_active_row,
            vertex_fixed={name: vs.fixed_array()
                          for name, vs in self.vertex_sets.items()},
            factor_ids=factor_ids_local,
            factor_mask=factor_mask,
            slot_mask=slot_mask_h,
            global_ids={name: np.asarray(vs.global_ids, dtype=np.int64)
                        for name, vs in self.vertex_sets.items()},
        )
        return Problem(
            meta_v, meta_f, GraphData(vertices=vdata, factors=fdata), params0,
            device=device, dim_h=dim_h, pad=pad,
            block_offsets=block_offsets, block_vertex=block_vertex,
            block_dims=dims_sel.astype(np.int64),
            elimination_block=elimination_block,
            elimination_col=elimination_col,
            precision=precision, host=host, seg_start=seg_start,
            seg_rows=seg_rows, segment_order=segment_order,
            row_vertex=row_vertex,
        )


def _resolve_ids(vs: VertexSet, g: np.ndarray, fname: str,
                 slot: int) -> np.ndarray:
    """Global vertex ids -> local indices of ``vs`` (raises on unknown)."""
    vs_gids = np.asarray(vs.global_ids, dtype=np.int64)
    n_v = vs_gids.shape[0]
    base = int(vs_gids[0]) if n_v else 0
    if n_v and np.array_equal(vs_gids,
                              np.arange(base, base + n_v, dtype=np.int64)):
        # contiguous ids (every loader adds vertices in order)
        loc = g - base
        ok = (loc >= 0) & (loc < n_v)
    else:
        sorter = np.argsort(vs_gids, kind="stable")
        pos = np.clip(np.searchsorted(vs_gids[sorter], g), 0,
                      max(n_v - 1, 0))
        ok = (n_v > 0) & (vs_gids[sorter][pos] == g)
        loc = sorter[pos]
    if not np.all(ok):
        bad = g[~np.asarray(ok, dtype=bool)][0]
        raise KeyError(
            f"factor set '{fname}' slot {slot} references unknown vertex id "
            f"{bad} of type '{vs.vtype.name}'")
    return loc
