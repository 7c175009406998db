"""Graph container and topology freeze (counterpart of
``graphite_tpu/graph.py``).

All sparsity discovery happens once per topology on the host in NumPy
(``Graph.freeze``); the frozen ``Problem`` carries that static structure
plus tensors on an explicit device. The freeze's section laps
(``perf.SectionTimer``: pad, active_factors, vertex_active,
assign_columns, trash_pad, device_arrays) go to
``problem._cache["setup_laps"]["freeze"]``, beside the Hessian and Schur
structure builders' laps.

- Vertices are sorted by (eliminated, type, global id), so eliminated
  types occupy the trailing Hessian columns and every type's active
  columns form one contiguous, uniformly strided segment: a flat vector
  reshapes to ``(n_rows, dim)`` per type (``rows_view`` /
  ``flat_from_rows``).
- Fixed or unreferenced vertices get no column. Their scatter target is a
  trash pad past ``dim_h`` (flat view) or a trash row ``n_rows`` (row
  view), and their Jacobian blocks are masked to zero: masking, not
  compaction, so shapes never depend on activity.
- ``freeze(remaskable=True)`` gives every vertex a column and discovers
  structure from every factor, so that levels, factor activity and fixed
  flags can change after the freeze (``Problem.remask`` and its
  friends). Only the mask tensors change, in place: a captured CUDA
  graph that reads them stays valid, and no plan is rebuilt.
- ``Problem.shard_replica`` binds a rank's slice of the factors to a
  ``parallel.sharding.Mesh`` (one process per rank): the host structure
  stays global, each per-factor host array is cut to the rank's rows by
  ``shard_slice``, and every cross-factor reduction goes through
  ``allreduce``.
"""

from __future__ import annotations

import copy
import dataclasses
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .factors import MAX_LEVEL, FactorSet, FactorType
from .perf import SectionTimer
from .precision import FP32_FP32, Precision
from .vertices import VertexSet, VertexType


def is_factor_active(level_byte: np.ndarray, opt_level: int) -> np.ndarray:
    return ((level_byte & MAX_LEVEL) <= opt_level) & ((level_byte & 0x80) == 0)


def activity_masks(factor_ids: Dict[str, np.ndarray],
                   factor_levels: Dict[str, np.ndarray], opt_level: int,
                   vertex_fixed: Dict[str, np.ndarray],
                   factor_types: Dict[str, FactorType]):
    """(factor_mask, vertex_active, slot_mask) by set name: a factor is
    active by its level byte at ``opt_level``; a vertex when it is not
    fixed and an active factor references it; a slot when both are."""
    factor_mask = {name: is_factor_active(levels, opt_level)
                   for name, levels in factor_levels.items()}
    referenced = {name: np.zeros(f.shape[0], dtype=bool)
                  for name, f in vertex_fixed.items()}
    for name, local in factor_ids.items():
        for slot, vt in enumerate(factor_types[name].vertex_types):
            referenced[vt.name][local[factor_mask[name], slot]] = True
    vertex_active = {name: referenced[name] & ~vertex_fixed[name]
                     for name in referenced}
    slot_mask = {}
    for name, local in factor_ids.items():
        smask = np.zeros(local.shape, dtype=bool)
        for slot, vt in enumerate(factor_types[name].vertex_types):
            smask[:, slot] = (factor_mask[name]
                              & vertex_active[vt.name][local[:, slot]])
        slot_mask[name] = smask
    return factor_mask, vertex_active, slot_mask


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
    store_jacobians: bool = True


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
    # the slots structure discovery sees: the live masks, or every slot
    # of every factor in a remaskable problem
    slot_mask: Dict[str, np.ndarray]
    global_ids: Dict[str, np.ndarray]
    factor_levels: Dict[str, np.ndarray]  # active bytes (padding: 0x80)
    factor_handles: Dict[str, np.ndarray]


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
                 seg_rows, segment_order, row_vertex, opt_level=0,
                 remaskable=False, scale_jacobians=True):
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
        self.opt_level: int = opt_level
        self.remaskable: bool = remaskable
        # Jacobi column scaling on (Graph.scale_system)
        self.scale_jacobians: bool = scale_jacobians
        # host-built structure, plans and device index tensors, keyed by
        # the site that uses them (built on first use, then reused)
        self._cache: dict = {}
        # set on a rank's replica (shard_replica): the parallel.sharding
        # Mesh its cross-factor reductions and Schur product stage are
        # split over
        self.mesh = None

    # ---- device copies of host index arrays -------------------------------
    def index(self, key, np_array: np.ndarray) -> torch.Tensor:
        """Cached int64 device tensor of a static host index array."""
        store = self._cache.setdefault("index", {})
        if key not in store:
            store[key] = torch.as_tensor(
                np.asarray(np_array, dtype=np.int64), device=self.device)
        return store[key]

    def index32(self, key, np_array: np.ndarray) -> torch.Tensor:
        """Cached int32 device tensor of a static host index array (or of
        a function that makes it, called on the first use only): the
        kernels' C interface takes int32 (``index_select`` and
        ``index_add_`` take it too)."""
        store = self._cache.setdefault("index32", {})
        if key not in store:
            if callable(np_array):
                np_array = np_array()
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
                       dtype=None, out=None) -> torch.Tensor:
        """Per-type (n_rows, dim) tensors -> flat (dim_x,) vector (written
        into ``out`` when given); missing types and the pad contribute
        zeros."""
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
        return torch.cat(parts, out=out)

    @property
    def dim_x(self) -> int:
        return self.dim_h + self.pad

    # ---- factor-parallel sharding (parallel/sharding.py) -------------------
    @property
    def sharded(self) -> bool:
        """Whether the factors are split over more than one rank."""
        return self.mesh is not None and self.mesh.world > 1

    def allreduce(self, x: torch.Tensor,
                  tag: str = "allreduce") -> torch.Tensor:
        """The sum of ``x`` over the ranks (in rank order); ``x`` itself
        when the problem is not sharded. ``tag`` names the site in the
        collective's errors."""
        if self.mesh is None:
            return x
        return self.mesh.allreduce(x, tag)

    def shard_slice(self, arr, n_local: int):
        """A global per-factor host array cut to this rank's contiguous
        ``n_local`` rows (the whole array when not sharded)."""
        if self.mesh is None or arr.shape[0] == n_local:
            return arr
        start = self.mesh.rank * n_local
        return arr[start:start + n_local]

    def shard_replica(self, data: GraphData, mesh) -> "Problem":
        """A shallow copy bound to one rank's data (``shard_data``),
        reducing over ``mesh``. The static metadata and the host structure
        are shared; ``params0`` moves to the data's device. The rank's
        plans are its own, except at world size 1 on this problem's
        device, where the rank's slice is the whole problem and the plans
        built so far are reused (a copy of the cache, so that caching the
        replica on this problem makes no reference cycle)."""
        device = mesh.device
        p = copy.copy(self)
        p.data = data
        p.device = device
        p.params0 = {n: v.to(device) for n, v in self.params0.items()}
        p.mesh = mesh
        if mesh.world == 1 and device == self.device:
            p._cache = dict(self._cache)
        else:
            p._cache = self._host_structures()
        return p

    def to(self, device) -> "Problem":
        """A copy of the problem on ``device``: its tensors moved, its host
        arrays and host-built Hessian and Schur structures shared, its
        device plans left to be rebuilt there on first use."""
        device = torch.device(device)

        def moved(tree):
            if isinstance(tree, torch.Tensor):
                return tree.to(device)
            if isinstance(tree, dict):
                return {k: moved(v) for k, v in tree.items()}
            if isinstance(tree, tuple):
                return tuple(moved(v) for v in tree)
            if dataclasses.is_dataclass(tree):
                return dataclasses.replace(tree, **{
                    f.name: moved(getattr(tree, f.name))
                    for f in dataclasses.fields(tree)})
            return tree

        p = copy.copy(self)
        p.device = device
        p.data = moved(self.data)
        p.params0 = moved(self.params0)
        p.host = dataclasses.replace(self.host)
        p._cache = self._host_structures()
        return p

    def _host_structures(self) -> dict:
        """The cache entries that hold only host-built topology (no device
        tensor, no per-factor slice): safe to share with a copy on another
        device or a rank's replica."""
        return {k: self._cache[k] for k in ("hessian_structure",
                                            "schur_structure")
                if k in self._cache}

    @property
    def n_blocks(self) -> int:
        return len(self.block_vertex)

    # ---- runtime remasking (remaskable freezes) ----------------------------
    def remask(self, opt_level: Optional[int] = None) -> None:
        """Recompute the activity masks (at ``opt_level`` when given) from
        the recorded levels and fixed flags, without refreezing. Each
        mask is written in place (``copy_``) into the tensor it replaces,
        so a captured LM loop reads the new masks; shapes, structure and
        plans stay as they are."""
        if not self.remaskable:
            raise ValueError(
                "runtime remasking requires Graph.freeze(remaskable=True)")
        if opt_level is not None:
            self.opt_level = int(opt_level)
        host = self.host
        factor_mask, vertex_active, slot_mask = activity_masks(
            host.factor_ids, host.factor_levels, self.opt_level,
            host.vertex_fixed,
            {name: fm.ftype for name, fm in self.factor_meta.items()})

        def put(dst: torch.Tensor, src: np.ndarray) -> None:
            dst.copy_(torch.as_tensor(src, dtype=dst.dtype))

        for name, va in self.data.vertices.items():
            put(va.active, vertex_active[name])
        for name, fa in self.data.factors.items():
            put(fa.factor_mask, factor_mask[name])
            put(fa.slot_mask, slot_mask[name])
        host.factor_mask = factor_mask
        host.vertex_active = vertex_active

    def set_opt_level(self, level: int) -> None:
        """Switch the optimization level after the freeze."""
        self.remask(opt_level=level)

    def set_factor_active(self, fname: str, handle: int,
                          level_byte: int) -> None:
        """Set a factor's active byte after the freeze (bits 0-6 the
        level, the MSB disables it)."""
        maps = self._cache.setdefault("handle_maps", {})
        if fname not in maps:
            maps[fname] = {int(h): i for i, h in
                           enumerate(self.host.factor_handles[fname])}
        self.host.factor_levels[fname][maps[fname][int(handle)]] = int(
            level_byte)
        self.remask()

    def set_vertex_fixed(self, vname: str, global_id: int,
                         fixed: bool = True) -> None:
        """Fix or free a vertex after the freeze."""
        local = self.host_local_index(vname, global_id)
        self.host.vertex_fixed[vname][local] = bool(fixed)
        self.remask()

    def get_hessian_dimension(self) -> int:
        return self.dim_h

    def get_variable_dimension(self, block_index: int) -> int:
        return int(self.block_offsets[block_index + 1]
                   - self.block_offsets[block_index])

    def get_num_block_columns(self) -> int:
        return self.n_blocks

    def get_elimination_block_column(self) -> int:
        return self.elimination_block

    def get_vertex(self, params, vtype_name: str, global_id: int):
        """One vertex's parameters in ``params``, by its global id."""
        return params[vtype_name][self.host_local_index(vtype_name,
                                                        global_id)]

    def host_local_index(self, vtype_name: str, global_id: int) -> int:
        maps = self._cache.setdefault("id_maps", {})
        if vtype_name not in maps:
            arr = self.host.global_ids[vtype_name]
            maps[vtype_name] = dict(zip(arr.tolist(), range(arr.shape[0])))
        return maps[vtype_name][global_id]

    def residual_sizes(self) -> Dict[str, int]:
        return {name: fm.count * fm.ftype.residual_dim
                for name, fm in self.factor_meta.items()}


class Graph:
    """Mutable graph-construction container; ``freeze`` returns a
    ``Problem``."""

    def __init__(self, precision: Precision = FP32_FP32):
        self.precision = precision
        self.vertex_sets: Dict[str, VertexSet] = {}
        self.factor_sets: Dict[str, FactorSet] = {}
        self._scale_jacobians = True

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

    def scale_system(self, enable: bool) -> None:
        """Turn Jacobi column scaling on or off (on by default)."""
        self._scale_jacobians = bool(enable)

    @property
    def scale_jacobians(self) -> bool:
        return self._scale_jacobians

    def freeze(self, opt_level: int = 0,
               precision: Optional[Precision] = None,
               device=None, pad_factors_to: int = 1,
               remaskable: bool = False) -> Problem:
        """Discover structure and build the ``Problem`` on ``device``
        (default: the CUDA card; raises when there is none, so a CPU run
        asks for ``device="cpu"``).

        ``pad_factors_to``: pad every factor set to a multiple of it with
        disabled copies of its first factor (active byte 0x80).
        ``remaskable``: give every vertex a column and discover structure
        from every factor, so that ``Problem.remask`` and its friends can
        change levels, factor activity and fixed flags later (see the
        module docstring)."""
        precision = precision or self.precision
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "Graph.freeze: no CUDA device; pass device='cpu' to "
                    "build the problem on the CPU")
            device = "cuda"
        device = torch.device(device)
        gdt = precision.graph_dtype
        sdt = precision.solver_dtype
        timer = SectionTimer("freeze")

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
        timer.lap("pad")

        # 1. active factors + local id resolution; padding factors copy
        # the first factor, disabled
        factor_ids_local: Dict[str, np.ndarray] = {}
        factor_levels: Dict[str, np.ndarray] = {}
        npad = {}
        for name, fs in factor_sets.items():
            gids = fs.ids_array()
            levels = fs.level_array()
            npad[name] = (-gids.shape[0]) % pad_factors_to
            if npad[name]:
                gids = np.concatenate(
                    [gids, np.repeat(gids[:1], npad[name], axis=0)])
                levels = np.concatenate(
                    [levels, np.full(npad[name], 0x80, dtype=levels.dtype)])
            local = np.zeros_like(gids)
            for slot, vt in enumerate(fs.ftype.vertex_types):
                local[:, slot] = _resolve_ids(
                    self.vertex_sets[vt.name], gids[:, slot], name, slot)
            factor_ids_local[name] = local
            factor_levels[name] = levels
        timer.lap("active_factors")

        # 2. factor, vertex and slot activity
        vertex_fixed = {name: vs.fixed_array()
                        for name, vs in self.vertex_sets.items()}
        factor_mask, vertex_active, slot_mask = activity_masks(
            factor_ids_local, factor_levels, opt_level, vertex_fixed,
            {name: fs.ftype for name, fs in factor_sets.items()})
        # the vertices that get a column: every one in a remaskable problem
        col_active = ({name: np.ones(vs.count, dtype=bool)
                       for name, vs in self.vertex_sets.items()}
                      if remaskable else vertex_active)
        timer.lap("vertex_active")

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
            active_cat.append(col_active[name])
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
        timer.lap("assign_columns")

        # 4. trash pad: inactive vertices point past dim_h (flat) and at
        # the trash row seg_rows[name] (row view)
        pad = max([vs.vtype.dim for vs in self.vertex_sets.values()] + [1])
        for name in type_names:
            off = vertex_col_offset[name]
            off[off < 0] = dim_h
            ar = vertex_active_row[name]
            ar[ar < 0] = seg_rows[name]
        timer.lap("trash_pad")

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
            smask = slot_mask[name]
            n, nslots = local.shape
            rows_arr = np.zeros((n, nslots), dtype=np.int64)
            for slot, vt in enumerate(fs.ftype.vertex_types):
                rows_arr[:, slot] = vertex_active_row[vt.name][local[:, slot]]
            slot_mask_h[name] = np.ones_like(smask) if remaskable else smask

            def padded(a, fill=0.0):
                if a is None or not npad[name]:
                    return a
                return np.concatenate(
                    [a, np.full((npad[name],) + a.shape[1:], fill)])

            obs = padded(fs.obs_array())
            data = padded(fs.data_array())
            fdata[name] = FactorArrays(
                ids=tuple(dev(local[:, s], torch.int64) for s in range(nslots)),
                rows=tuple(dev(rows_arr[:, s], torch.int64)
                           for s in range(nslots)),
                obs=None if obs is None else dev(obs, gdt),
                data=None if data is None else dev(data, gdt),
                precision=(dev(padded(fs.precision_array()).reshape(n, -1),
                               sdt) if fs.has_precision() else None),
                # padding factors take the loss default (finite
                # derivatives)
                loss_params=dev(padded(fs.loss_params_array(),
                                       fs.ftype.loss.default_param()), gdt),
                factor_mask=dev(fmask, torch.bool),
                slot_mask=dev(smask, torch.bool),
            )
            meta_f[name] = FactorMeta(ftype=fs.ftype, count=n,
                                      store_jacobians=fs.store_jacobians)

        host = HostStructure(
            vertex_col_offset=vertex_col_offset,
            vertex_block_id=vertex_block_id,
            vertex_active=vertex_active,
            vertex_active_row=vertex_active_row,
            vertex_fixed=vertex_fixed,
            factor_ids=factor_ids_local,
            factor_mask=factor_mask,
            slot_mask=slot_mask_h,
            global_ids={name: np.asarray(vs.global_ids, dtype=np.int64)
                        for name, vs in self.vertex_sets.items()},
            factor_levels=factor_levels,
            factor_handles={name: fs.handle_array()
                            for name, fs in factor_sets.items()},
        )
        problem = Problem(
            meta_v, meta_f, GraphData(vertices=vdata, factors=fdata), params0,
            device=device, dim_h=dim_h, pad=pad,
            block_offsets=block_offsets, block_vertex=block_vertex,
            block_dims=dims_sel.astype(np.int64),
            elimination_block=elimination_block,
            elimination_col=elimination_col,
            precision=precision, host=host, seg_start=seg_start,
            seg_rows=seg_rows, segment_order=segment_order,
            row_vertex=row_vertex, opt_level=opt_level,
            remaskable=remaskable, scale_jacobians=self._scale_jacobians,
        )
        timer.lap("device_arrays")
        timer.done()
        problem._cache["setup_laps"] = {"freeze": timer.laps}
        return problem


def _resolve_ids(vs: VertexSet, g: np.ndarray, fname: str,
                 slot: int) -> np.ndarray:
    """Global vertex ids -> local indices of ``vs`` (raises on unknown)."""
    vs_gids = np.asarray(vs.global_ids, dtype=np.int64)
    n_v = vs_gids.shape[0]
    base = int(vs_gids[0]) if n_v else 0
    if n_v and int(vs_gids[-1]) == base + n_v - 1 and np.array_equal(
            vs_gids, np.arange(base, base + n_v, dtype=np.int64)):
        # contiguous ids (every loader adds vertices in order): a
        # subtraction and a range check, no sort and no binary searches
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
