"""Schur complement S = Hpp - Hpl Hll^{-1} Hpl^T (counterpart of
``graphite_tpu/schur.py``, unchunked single-device path).

Structure (host, once per topology): pose blocks are the Hessian block
columns before ``elimination_block``, landmark blocks the trailing
eliminated ones. For every landmark, every pair of pose blocks it touches
is a fill-in block of S (unioned with the Hpp sparsity), and each pair is
one triple product ``dst -= W_left R_right^T`` with ``W = Hpl Hll^{-1}``;
the products are grouped by (dp_a, dl, dp_b) and sorted by destination.

Values (``schur_values``): Hll^{-1} per landmark dim, the Hpp copy
(unique destinations, an indexed assignment), W, and the triple products
reduced into S by the sorted-segment-sum kernel (``ops/cuda/segsum``).
``SchurOps`` adds ``b_schur``, ``landmark_update`` and ``compose_delta``.
The block-sparse S matvec is not ported: the solver densifies S.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch

from . import hostops
from .hessian import HessianValues, build_hessian_structure
from .ops.batched_linalg import spd_inverse_flat
from .ops.blockfmt import (
    flat_block_mm_nn,
    flat_block_mm_nt,
    flat_block_mv,
    flat_block_mv_t,
)
from .ops.cuda.segsum import sorted_segment_sum
from .ops.streamreduce import reduce_rows, segment_plan, take_rows


@dataclasses.dataclass
class SchurStructure:
    """Static (host) description of the Schur system."""

    dim_p: int  # pose columns
    n_pose_blocks: int
    pose_offsets: np.ndarray  # (n_pose_blocks+1,) column offsets
    pose_dims: np.ndarray
    # landmark diagonal blocks, grouped by dim
    lm_dims: List[int]
    lm_h_idx: Dict[int, np.ndarray]  # dim -> indices into H group (d, d)
    lm_group_index: np.ndarray  # per landmark block -> idx in its dim group
    lm_dim_of: np.ndarray
    # Hpl blocks grouped by (dp, dl)
    hpl_keys: List[Tuple[int, int]]
    hpl_h_idx: Dict[Tuple[int, int], np.ndarray]  # idx into H group (dp, dl)
    hpl_pose: Dict[Tuple[int, int], np.ndarray]  # pose block id
    hpl_lm: Dict[Tuple[int, int], np.ndarray]  # landmark block id - eb
    # S blocks (upper-tri, CSC sorted), grouped by (dr, dc)
    s_keys: List[Tuple[int, int]]
    s_sizes: Dict[Tuple[int, int], int]
    s_rows: Dict[Tuple[int, int], np.ndarray]  # pose block ids
    s_cols: Dict[Tuple[int, int], np.ndarray]
    # Hpp copy: (H group key, h_idx, s_idx)
    hpp_copy: List[Tuple[Tuple[int, int], np.ndarray, np.ndarray]]
    # triple products grouped by (dpa, dl, dpb), dst-sorted
    products: List[dict]
    # S diagonal block of each pose block: (s_keys index, idx)
    s_diag_key: np.ndarray
    s_diag_idx: np.ndarray
    # block -> (vertex type, row in the type's segment)
    block_type: np.ndarray
    block_row: np.ndarray


def _cumcount(group_ids: np.ndarray, n_groups: int) -> np.ndarray:
    """Rank within group, preserving order."""
    counts = np.bincount(group_ids, minlength=n_groups)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    out = np.empty(group_ids.shape[0], dtype=np.int64)
    perm = np.argsort(group_ids, kind="stable")
    out[perm] = np.arange(group_ids.shape[0]) - np.repeat(starts, counts)
    return out


def build_schur_structure(problem) -> SchurStructure:
    if "schur_structure" in problem._cache:
        return problem._cache["schur_structure"]
    hs = build_hessian_structure(problem)
    eb = problem.elimination_block
    nb_total = problem.n_blocks
    if eb >= nb_total:
        raise ValueError(
            "no eliminated vertices: call set_eliminate(True) on the "
            "landmark vertex set before freeze")
    dims = problem.block_dims
    offsets = problem.block_offsets
    n_pose = eb
    n_lm = nb_total - eb
    rows_h, cols_h = hs.block_rows, hs.block_cols
    if np.any((rows_h >= eb) & (cols_h >= eb) & (rows_h != cols_h)):
        raise ValueError(
            "Hll is not block-diagonal: factors connect two eliminated "
            "vertices")

    # landmark diagonal blocks by dim
    lm_j = np.arange(eb, nb_total)
    lm_dim_of = dims[lm_j].astype(np.int64)
    lm_dims = sorted(set(int(d) for d in np.unique(lm_dim_of)))
    dim_rank = {d: i for i, d in enumerate(lm_dims)}
    lm_group_index = _cumcount(
        np.asarray([dim_rank[int(d)] for d in lm_dim_of], dtype=np.int64),
        len(lm_dims))
    lm_h_idx: Dict[int, np.ndarray] = {}
    for d in lm_dims:
        sel = lm_j[lm_dim_of == d]
        if np.any(hs.diag_group[sel] < 0):
            raise ValueError("landmark without a diagonal block")
        lm_h_idx[d] = hs.diag_idx[sel].astype(np.int64)

    # classify H blocks
    is_hpp = cols_h < eb
    hpl_sel = np.nonzero((~is_hpp) & (rows_h < eb))[0]  # sorted by (lm, pose)
    hpl_code = dims[rows_h[hpl_sel]] * 100000 + dims[cols_h[hpl_sel]]
    hpl_keys: List[Tuple[int, int]] = []
    hpl_h_idx, hpl_pose, hpl_lm = {}, {}, {}
    key_id_of = np.zeros(hpl_sel.shape[0], dtype=np.int64)
    idx_in_key = np.zeros(hpl_sel.shape[0], dtype=np.int64)
    for code in np.unique(hpl_code):
        key = (int(code // 100000), int(code % 100000))
        m = hpl_code == code
        sel = hpl_sel[m]
        key_id_of[m] = len(hpl_keys)
        hpl_keys.append(key)
        hpl_h_idx[key] = hs.index_in_group[sel].astype(np.int64)
        hpl_pose[key] = rows_h[sel].astype(np.int64)
        hpl_lm[key] = (cols_h[sel] - eb).astype(np.int64)
        idx_in_key[m] = np.arange(sel.shape[0])

    # per-landmark attach lists + pose-pair fill-in discovery
    att_lm = cols_h[hpl_sel] - eb
    att_pose = rows_h[hpl_sel]
    (att_order, ai, bi, pair_lm, pair_codes, pose_a,
     pose_b) = hostops.attach_pairs(att_lm, att_pose, n_lm, n_pose)
    att_key_s = key_id_of[att_order]
    att_idx_s = idx_in_key[att_order]

    # S sparsity: union of the Hpp coordinates and the fill-in pairs
    hpp_sel = np.nonzero(is_hpp)[0]
    hpp_codes = cols_h[hpp_sel] * n_pose + rows_h[hpp_sel]
    s_codes, s_inverse = np.unique(np.concatenate([hpp_codes, pair_codes]),
                                   return_inverse=True)
    hpp_pos = s_inverse[: hpp_codes.shape[0]]
    pair_pos = s_inverse[hpp_codes.shape[0]:]
    s_rows_all = (s_codes % n_pose).astype(np.int64)
    s_cols_all = (s_codes // n_pose).astype(np.int64)
    s_dim_code = dims[s_rows_all] * 100000 + dims[s_cols_all]
    uniq_sdims, s_group_of = np.unique(s_dim_code, return_inverse=True)
    s_keys = [(int(c // 100000), int(c % 100000)) for c in uniq_sdims]
    s_index_in_group = _cumcount(s_group_of, len(s_keys))
    s_sizes = {key: int(c) for key, c in zip(
        s_keys, np.bincount(s_group_of, minlength=len(s_keys)))}
    s_rows = {key: s_rows_all[s_group_of == gi]
              for gi, key in enumerate(s_keys)}
    s_cols = {key: s_cols_all[s_group_of == gi]
              for gi, key in enumerate(s_keys)}

    # Hpp copy grouped by H group
    hpp_copy = []
    hpp_dims_code = dims[rows_h[hpp_sel]] * 100000 + dims[cols_h[hpp_sel]]
    hpp_s_idx = s_index_in_group[hpp_pos]
    for code in np.unique(hpp_dims_code):
        key = (int(code // 100000), int(code % 100000))
        m = hpp_dims_code == code
        hpp_copy.append((key, hs.index_in_group[hpp_sel[m]].astype(np.int64),
                         hpp_s_idx[m].astype(np.int64)))

    # triple products grouped by (dpa, dl, dpb), sorted by destination
    products = []
    dst_idx_all = s_index_in_group[pair_pos]
    dst_group_all = s_group_of[pair_pos]
    dl_all = lm_dim_of[pair_lm]
    tri_code = (dims[pose_a] * 100000 + dl_all) * 100000 + dims[pose_b]
    for code in np.unique(tri_code):
        m = tri_code == code
        dpa = int(code // (100000 * 100000))
        dl = int((code // 100000) % 100000)
        dpb = int(code % 100000)
        lkeys = att_key_s[ai[m]]
        rkeys = att_key_s[bi[m]]
        dst_g = dst_group_all[m]
        if not (np.all(lkeys == lkeys[0]) and np.all(rkeys == rkeys[0])
                and np.all(dst_g == dst_g[0])):
            raise ValueError("inconsistent Schur product group")
        dst_key = s_keys[int(dst_g[0])]
        dst = dst_idx_all[m].astype(np.int64)
        order = np.argsort(dst, kind="stable")
        products.append(dict(
            dims=(dpa, dl, dpb), left_key=hpl_keys[int(lkeys[0])],
            right_key=hpl_keys[int(rkeys[0])], dst_key=dst_key,
            left=att_idx_s[ai[m]][order].astype(np.int64),
            right=att_idx_s[bi[m]][order].astype(np.int64),
            dst=dst[order]))

    # right operands are read from the (dp, dl) H group, whose rows may
    # also hold diagonal / Hpp blocks when dp == dl: compose the pair's
    # Hpl-local index through hpl_h_idx
    for pg in products:
        pg["right"] = hpl_h_idx[pg["right_key"]][pg["right"]]

    # S diagonal lookup
    diag_codes = np.arange(n_pose) * n_pose + np.arange(n_pose)
    ns_total = s_codes.shape[0]
    pos_c = np.clip(np.searchsorted(s_codes, diag_codes), 0,
                    max(ns_total - 1, 0))
    found = (ns_total > 0) & (s_codes[pos_c] == diag_codes)
    s_diag_key = np.where(found, s_group_of[pos_c], -1).astype(np.int64)
    s_diag_idx = np.where(found, s_index_in_group[pos_c], 0).astype(np.int64)

    # block -> (type, row)
    bv = problem.block_vertex
    block_type = bv.type_of()
    block_row = np.empty(nb_total, dtype=np.int64)
    for ti, tname in enumerate(bv.type_names):
        m = bv.type_codes == ti
        if np.any(m):
            block_row[m] = problem.host.vertex_active_row[tname][
                bv.local_ids[m]]

    ss = SchurStructure(
        dim_p=problem.elimination_col, n_pose_blocks=n_pose,
        pose_offsets=offsets[: n_pose + 1].copy(),
        pose_dims=dims[:n_pose].copy(), lm_dims=lm_dims, lm_h_idx=lm_h_idx,
        lm_group_index=lm_group_index, lm_dim_of=lm_dim_of,
        hpl_keys=hpl_keys, hpl_h_idx=hpl_h_idx, hpl_pose=hpl_pose,
        hpl_lm=hpl_lm, s_keys=s_keys, s_sizes=s_sizes, s_rows=s_rows,
        s_cols=s_cols, hpp_copy=hpp_copy, products=products,
        s_diag_key=s_diag_key, s_diag_idx=s_diag_idx,
        block_type=block_type, block_row=block_row)
    problem._cache["schur_structure"] = ss
    return ss


@dataclasses.dataclass
class SchurValues:
    hll_inv: Dict[int, torch.Tensor]  # dim -> (L_d, d*d) flat
    s_vals: Dict[Tuple[int, int], torch.Tensor]  # key -> (nS_g, dr*dc)


def _hpl_w_counts(problem, ss: SchurStructure, key) -> torch.Tensor:
    """Repeat counts that expand Hll^{-1} (one row per landmark) to the
    Hpl blocks of ``key``. Valid only because the Hpl blocks are sorted by
    landmark (CSC order), which is checked here."""
    cache = problem._cache.setdefault("hpl_w_counts", {})
    if key not in cache:
        dl = key[1]
        gi = ss.lm_group_index[ss.hpl_lm[key]]
        if gi.size and np.any(np.diff(gi) < 0):
            raise ValueError("Hpl blocks are not sorted by landmark")
        cache[key] = torch.as_tensor(
            np.bincount(gi, minlength=ss.lm_h_idx[dl].shape[0]),
            device=problem.device)
    return cache[key]


def schur_values(problem, ss: SchurStructure,
                 hvals: HessianValues) -> SchurValues:
    """S = Hpp - Hpl Hll^{-1} Hpl^T from damped H values."""
    inv_dt = problem.precision.inv_dtype

    hll_inv = {}
    for d in ss.lm_dims:
        hll = take_rows(problem, ("lm_h_idx", d), hvals[(d, d)],
                        ss.lm_h_idx[d])
        hll_inv[d] = spd_inverse_flat(hll.to(inv_dt), d)

    # S storage starts as a copy of Hpp (unique destinations)
    s_vals = {key: torch.zeros((ss.s_sizes[key], key[0] * key[1]),
                               dtype=inv_dt, device=problem.device)
              for key in ss.s_keys}
    for hi, (hkey, h_idx, s_idx) in enumerate(ss.hpp_copy):
        src = hvals[hkey].index_select(0, problem.index(("hpp_h", hi), h_idx))
        s_vals[hkey].index_copy_(0, problem.index(("hpp_s", hi), s_idx),
                                 src.to(inv_dt))

    # W = Hpl Hll^{-1} once per Hpl block; Hll^{-1} is symmetric, so each
    # triple product L M R^T is W_left R_right^T
    hpl_w = {}
    for key in ss.hpl_keys:
        dp, dl = key
        hpl = take_rows(problem, ("hpl_h", key), hvals[key],
                        ss.hpl_h_idx[key])
        inv_exp = torch.repeat_interleave(
            hll_inv[dl], _hpl_w_counts(problem, ss, key), dim=0,
            output_size=hpl.shape[0])
        hpl_w[key] = flat_block_mm_nn(hpl.to(inv_dt), inv_exp, dp, dl, dl,
                                      acc_dtype=inv_dt)

    for gi, pg in enumerate(ss.products):
        dpa, dl, dpb = pg["dims"]
        key = pg["dst_key"]
        left = hpl_w[pg["left_key"]].index_select(
            0, problem.index(("prod_l", gi), pg["left"]))
        right = hvals[pg["right_key"]].index_select(
            0, problem.index(("prod_r", gi), pg["right"]))
        prod = flat_block_mm_nt(left, right.to(inv_dt), dpa, dl, dpb,
                                acc_dtype=inv_dt)
        plan = segment_plan(problem, ("prod_dst", gi), pg["dst"],
                            ss.s_sizes[key])
        s_vals[key] = s_vals[key] - sorted_segment_sum(prod, plan)
    return SchurValues(hll_inv=hll_inv, s_vals=s_vals)


def _partition_blocks_by_type(ss: SchurStructure, block_ids: np.ndarray):
    """Split Hessian-block ids by vertex type: [(type, sel, rows)], with
    ``sel`` indexing ``block_ids`` and ``rows`` the type-segment rows."""
    types = np.asarray(ss.block_type)[block_ids]
    out = []
    for t in np.unique(types):
        sel = np.nonzero(types == t)[0]
        out.append((str(t), sel, ss.block_row[block_ids[sel]]))
    return out


class SchurOps:
    """Static Schur structure bundled with one set of (damped) H values.
    Vector IO is row-shaped per vertex type."""

    def __init__(self, problem, ss: SchurStructure, hvals: HessianValues,
                 sv: SchurValues):
        self.problem = problem
        self.ss = ss
        self.hvals = hvals
        self.sv = sv
        self._gdt = problem.precision.graph_dtype

    def hpl(self, key) -> torch.Tensor:
        return take_rows(self.problem, ("hpl_h", key), self.hvals[key],
                         self.ss.hpl_h_idx[key])

    def _partition(self, tag, block_ids):
        cache = self.problem._cache.setdefault("schur_partitions", {})
        if tag not in cache:
            cache[tag] = _partition_blocks_by_type(self.ss, block_ids)
        return cache[tag]

    def _lm_partition(self):
        p = self.problem
        return self._partition("lm_diag",
                               np.arange(p.elimination_block, p.n_blocks))

    def _hpl_partitions(self, key):
        """[(pose type, lm type, sel, pose rows, lm rows)] of Hpl group
        ``key``; ``sel`` indexes the group's Hpl blocks."""
        ss = self.ss
        lm_abs = ss.hpl_lm[key] + self.problem.elimination_block
        out = []
        for pt, psel, prow in self._partition(f"hpl_pose_{key}",
                                              ss.hpl_pose[key]):
            for lt, lsel, lrow in self._partition(f"hpl_lm_{key}_{pt}",
                                                  lm_abs[psel]):
                out.append((pt, lt, psel[lsel], prow[lsel], lrow))
        return out

    def _hll_solve_rows(self, t_rows: Dict[str, torch.Tensor]
                        ) -> Dict[str, torch.Tensor]:
        """w = Hll^{-1} t per landmark type (rows in type-row order)."""
        out = {}
        for t, sel, rows in self._lm_partition():
            d = self.problem.vertex_meta[t].vtype.dim
            gidx = self.ss.lm_group_index[sel[np.argsort(rows, kind="stable")]]
            inv_flat = take_rows(self.problem, ("hllsolve_gidx", t),
                                 self.sv.hll_inv[d], gidx)
            out[t] = flat_block_mv(inv_flat, t_rows[t], d, d,
                                   acc_dtype=inv_flat.dtype)
        return out

    def b_schur(self, b: torch.Tensor) -> torch.Tensor:
        """b_S = b_p - Hpl Hll^{-1} b_l -> (dim_p,)."""
        problem = self.problem
        gdt = self._gdt
        w = self._hll_solve_rows({t: problem.rows_view(b, t)
                                  for t, _, _ in self._lm_partition()})
        out_rows: Dict[str, torch.Tensor] = {}
        for key in self.ss.hpl_keys:
            dp, dl = key
            Hpl = self.hpl(key)
            for pt, lt, sub, prow, lrow in self._hpl_partitions(key):
                ck = ("bschur", key, pt, lt)
                Hsub = take_rows(problem, ck + ("sub",), Hpl, sub)
                wg = w[lt].index_select(0, problem.index(ck + ("lrow",), lrow))
                y = flat_block_mv(Hsub, wg, dp, dl, acc_dtype=wg.dtype).to(gdt)
                # the pose destinations are unsorted: the plan sorts them
                plan = segment_plan(problem, ck, prow, problem.seg_rows[pt])
                acc = reduce_rows(y, plan)
                prev = out_rows.get(pt)
                out_rows[pt] = acc if prev is None else prev + acc
        flat = problem.flat_from_rows({t: -v for t, v in out_rows.items()},
                                      dtype=gdt)
        return flat[: self.ss.dim_p] + b[: self.ss.dim_p].to(gdt)

    def landmark_update(self, b: torch.Tensor,
                        dx_p: torch.Tensor) -> Dict[str, torch.Tensor]:
        """dx_l = Hll^{-1} (b_l - Hpl^T dx_p), per landmark type rows."""
        problem = self.problem
        gdt = self._gdt
        t_rows = {t: problem.rows_view(b, t).to(gdt)
                  for t, _, _ in self._lm_partition()}
        for key in self.ss.hpl_keys:
            dp, dl = key
            Hpl = self.hpl(key)
            for pt, lt, sub, prow, lrow in self._hpl_partitions(key):
                ck = ("lu", key, pt, lt)
                Hsub = take_rows(problem, ck + ("sub",), Hpl, sub)
                x = problem.rows_view(dx_p, pt).index_select(
                    0, problem.index(ck + ("prow",), prow))
                y = flat_block_mv_t(Hsub, x, dp, dl, acc_dtype=gdt)
                # Hpl is landmark-major: lrow is destination-sorted
                plan = segment_plan(problem, ck, lrow, problem.seg_rows[lt])
                t_rows[lt] = t_rows[lt] - reduce_rows(y, plan)
        return self._hll_solve_rows(t_rows)

    def compose_delta(self, dx_p: torch.Tensor,
                      dx_l_rows: Dict[str, torch.Tensor]) -> torch.Tensor:
        """(dim_p,) pose delta + landmark rows -> full (dim_x,) delta."""
        out = self.problem.flat_from_rows(dx_l_rows, dtype=self._gdt)
        out[: dx_p.shape[0]] = dx_p.to(self._gdt)
        return out
