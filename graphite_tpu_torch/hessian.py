"""Block-sparse Hessian (counterpart of ``graphite_tpu/hessian.py``).

Structure discovery (``build_hessian_structure``) runs once per topology
on the host, as a NumPy copy of the JAX package's: upper-triangular blocks
in CSC order (the diagonal block last in its column), grouped by
(row_dim, col_dim) into flat ``(n_blocks + 1, dr*dc)`` value tensors whose
last row is a trash block, plus per (factor type, slot pair) maps of
where each factor's ``J_s^T dL P J_t`` lands.

``compute_hessian_values`` forms the per-factor block products and reduces
them into the groups with ``reduce_rows``; ``apply_damping`` returns a
copy with damped diagonal-block diagonals: ``d + mu`` or
``d + mu * clamp(d, 1e-6, 1e32)`` from the undamped scaled diagonal.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .linearize import DIAG_MAX, DIAG_MIN, Linearization
from .ops.blockfmt import flat_block_mm_nn, flat_block_mm_tn
from .ops.streamreduce import reduce_rows, segment_plan


@dataclasses.dataclass
class ContribMap:
    """Where one (factor type, slot s, slot t) pair's products go."""

    fname: str
    s: int
    t: int
    # group keys and per-factor block indices (trash = n_blocks of group)
    direct_group: Tuple[int, int]
    direct_idx: Optional[np.ndarray]  # (F,) or None if all-trash
    trans_group: Tuple[int, int]
    trans_idx: Optional[np.ndarray]


@dataclasses.dataclass
class HessianStructure:
    """Static (host) description of the block-sparse Hessian."""

    block_rows: np.ndarray  # (NB,) block-column ids, CSC order
    block_cols: np.ndarray
    n_blocks: int
    group_keys: List[Tuple[int, int]]  # [(dr, dc)]
    group_of_block: np.ndarray  # (NB,) index into group_keys
    index_in_group: np.ndarray  # (NB,)
    group_sizes: Dict[Tuple[int, int], int]
    contribs: List[ContribMap]
    diag_group: np.ndarray  # (n_block_cols,) group index (-1 if absent)
    diag_idx: np.ndarray


# group key -> (n_g + 1, dr*dc) values; the last row is the trash block
HessianValues = Dict[Tuple[int, int], torch.Tensor]


def _block_ids_for(problem, fname: str):
    """Per-factor block ids for each slot ((F,) arrays), -1 when inactive."""
    fm = problem.factor_meta[fname]
    ids = problem.host.factor_ids[fname]
    smask = problem.host.slot_mask[fname]
    out = []
    for s, vt in enumerate(fm.ftype.vertex_types):
        bid = problem.host.vertex_block_id[vt.name][ids[:, s]].copy()
        bid[~smask[:, s]] = -1
        out.append(bid)
    return out


def build_hessian_structure(problem) -> HessianStructure:
    if "hessian_structure" in problem._cache:
        return problem._cache["hessian_structure"]
    block_dims = problem.block_dims
    n_cols = problem.n_blocks

    # 1. upper-triangular block codes c*n_cols + r from every slot pair;
    # sorted unique codes are CSC order with the diagonal block last
    pair_sources = []
    all_codes = [np.zeros(0, dtype=np.int64)]
    for fname, fm in problem.factor_meta.items():
        bids = _block_ids_for(problem, fname)
        n = fm.ftype.arity
        for s in range(n):
            for t in range(s, n):
                bs, bt = bids[s], bids[t]
                valid = (bs >= 0) & (bt >= 0)
                lo = np.minimum(bs, bt)[valid]
                hi = np.maximum(bs, bt)[valid]
                all_codes.append(hi * n_cols + lo)
                pair_sources.append((fname, s, t, bs, bt, valid))

    codes, code_inverse = np.unique(np.concatenate(all_codes),
                                    return_inverse=True)
    block_rows = codes % n_cols
    block_cols = codes // n_cols
    nb = codes.shape[0]

    # 2. group by (dr, dc), preserving CSC order within each group
    dr_all = block_dims[block_rows] if nb else np.zeros(0, dtype=np.int64)
    dc_all = block_dims[block_cols] if nb else np.zeros(0, dtype=np.int64)
    dim_codes = dr_all * 100000 + dc_all
    uniq_dims, group_of_block = np.unique(dim_codes, return_inverse=True)
    group_keys = [(int(d // 100000), int(d % 100000)) for d in uniq_dims]
    counts = np.bincount(group_of_block, minlength=len(group_keys)).astype(
        np.int64)
    group_counts = {key: int(c) for key, c in zip(group_keys, counts)}
    index_in_group = np.empty(nb, dtype=np.int64)
    perm = np.argsort(group_of_block, kind="stable")
    index_in_group[perm] = (
        np.arange(nb) - np.repeat(np.concatenate([[0], np.cumsum(counts)[:-1]]),
                                  counts))

    # 3. contribution maps: direct (bs <= bt) and transposed (bs > bt, plus
    # the self-block transpose when bs == bt and s < t)
    contribs: List[ContribMap] = []
    seg_start = 0
    for fname, s, t, bs, bt, valid in pair_sources:
        fm = problem.factor_meta[fname]
        ds = fm.ftype.vertex_types[s].dim
        dt_ = fm.ftype.vertex_types[t].dim
        dkey, tkey = (ds, dt_), (dt_, ds)
        d_trash = group_counts.get(dkey, 0)
        t_trash = group_counts.get(tkey, 0)
        all_valid = bool(valid.all())
        n_valid = valid.size if all_valid else int(valid.sum())
        inv_seg = code_inverse[seg_start:seg_start + n_valid]
        seg_start += n_valid
        idx_norm = index_in_group[inv_seg]
        vpos = None if all_valid else np.nonzero(valid)[0]
        bs_v = bs if all_valid else bs[vpos]
        bt_v = bt if all_valid else bt[vpos]
        F = bs.shape[0]
        m_d = bs_v <= bt_v
        m_t = (bs_v > bt_v) | ((bs_v == bt_v) & (s < t))
        direct_idx = None
        trans_idx = None
        if m_d.all() and all_valid:
            direct_idx = np.ascontiguousarray(idx_norm, dtype=np.int64)
        elif np.any(m_d):
            direct_idx = np.full(F, d_trash, dtype=np.int64)
            sel = np.nonzero(m_d)[0] if all_valid else vpos[m_d]
            direct_idx[sel] = idx_norm[m_d]
        if np.any(m_t):
            trans_idx = np.full(F, t_trash, dtype=np.int64)
            sel = np.nonzero(m_t)[0] if all_valid else vpos[m_t]
            trans_idx[sel] = idx_norm[m_t]
        contribs.append(
            ContribMap(fname, s, t, dkey, direct_idx, tkey, trans_idx))

    # 4. diagonal-block lookup per block column
    cols_j = np.arange(n_cols)
    diag_codes = cols_j * n_cols + cols_j
    diag_pos_c = np.clip(np.searchsorted(codes, diag_codes), 0,
                         max(nb - 1, 0))
    diag_found = (nb > 0) & (codes[diag_pos_c] == diag_codes)
    diag_group = np.where(diag_found, group_of_block[diag_pos_c], -1)
    diag_idx = np.where(diag_found, index_in_group[diag_pos_c], 0)

    hs = HessianStructure(
        block_rows=block_rows, block_cols=block_cols, n_blocks=nb,
        group_keys=group_keys, group_of_block=group_of_block,
        index_in_group=index_in_group, group_sizes=group_counts,
        contribs=contribs, diag_group=diag_group, diag_idx=diag_idx)
    problem._cache["hessian_structure"] = hs
    return hs


def compute_hessian_values(problem, hs: HessianStructure,
                           lin: Linearization) -> HessianValues:
    """H = J^T dL P J into the grouped block storage (Jacobians already
    scaled and masked)."""
    acc = problem.precision.acc_dtype
    inv_dt = problem.precision.inv_dtype
    values: HessianValues = {
        key: torch.zeros((hs.group_sizes[key] + 1, key[0] * key[1]),
                         dtype=inv_dt, device=problem.device)
        for key in hs.group_keys
    }
    for ci, cm in enumerate(hs.contribs):
        if cm.direct_idx is None and cm.trans_idx is None:
            continue
        fm = problem.factor_meta[cm.fname]
        fa = problem.data.factors[cm.fname]
        J = lin.jacobians[cm.fname]
        E = fm.ftype.residual_dim
        ds = fm.ftype.vertex_types[cm.s].dim
        dt_ = fm.ftype.vertex_types[cm.t].dim
        jt = J[cm.t].to(acc)
        if fa.precision is not None:
            jt = flat_block_mm_nn(fa.precision, jt, E, E, dt_, acc_dtype=acc)
        flat = (flat_block_mm_tn(J[cm.s], jt, ds, E, dt_, acc_dtype=acc)
                * lin.chi2_deriv[cm.fname].to(acc)[:, None]).to(inv_dt)
        if cm.direct_idx is not None:
            plan = segment_plan(problem, ("hess_d", ci), cm.direct_idx,
                                hs.group_sizes[cm.direct_group] + 1,
                                flat.shape[1])
            values[cm.direct_group] = values[cm.direct_group] + reduce_rows(
                flat, plan)
        if cm.trans_idx is not None:
            # row-major (ds, dt) -> (dt, ds) transpose of each flat row
            flat_t = flat.reshape(-1, ds, dt_).transpose(1, 2).reshape(
                -1, ds * dt_)
            plan = segment_plan(problem, ("hess_t", ci), cm.trans_idx,
                                hs.group_sizes[cm.trans_group] + 1,
                                flat_t.shape[1])
            values[cm.trans_group] = values[cm.trans_group] + reduce_rows(
                flat_t, plan)
    return values


def _diag_rows_by_type(problem, hs: HessianStructure):
    """Per vertex type: (group key, diagonal-block index per type row)."""
    if "diag_rows_by_type" in problem._cache:
        return problem._cache["diag_rows_by_type"]
    out = {}
    for name in problem.vertex_meta:
        rv = problem.row_vertex.get(name)
        if rv is None or rv.size == 0:
            continue
        bids = problem.host.vertex_block_id[name][rv]
        gi = hs.diag_group[bids]
        if np.any(gi < 0):
            continue  # some active vertex has no diagonal block
        if not np.all(gi == gi[0]):
            raise ValueError(f"diagonal blocks of '{name}' span groups")
        out[name] = (hs.group_keys[int(gi[0])], hs.diag_idx[bids])
    problem._cache["diag_rows_by_type"] = out
    return out


def apply_damping(problem, hs: HessianStructure, values: HessianValues,
                  diag_backup: torch.Tensor, damping,
                  use_identity: bool) -> HessianValues:
    """Copy of ``values`` with damped diagonal-block diagonals;
    ``diag_backup`` is the undamped scaled diagonal (``lin.diag``)."""
    out = dict(values)
    for name, (key, idxs) in _diag_rows_by_type(problem, hs).items():
        d = key[0]
        store_dt = values[key].dtype
        d0 = problem.rows_view(diag_backup, name).to(store_dt)
        mu = torch.as_tensor(damping, dtype=store_dt, device=problem.device)
        if use_identity:
            dnew = d0 + mu
        else:
            dnew = d0 + mu * d0.clamp(DIAG_MIN, DIAG_MAX)
        diag_pos = problem.index(("damp_pos", d),
                                 np.arange(d) * (d + 1))
        rows = problem.index(("damp_idx", name), idxs)
        sub = out[key].index_select(0, rows)
        sub.index_copy_(1, diag_pos, dnew)
        out[key] = out[key].index_copy(0, rows, sub)
    return out
