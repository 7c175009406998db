"""Block-sparse Hessian (counterpart of ``graphite_tpu/hessian.py``).

Structure discovery (``build_hessian_structure``) runs once per topology
on the host, as the JAX package's, its sorts and uniques on the host
library through ``hostops``: upper-triangular blocks
in CSC order (the diagonal block last in its column), grouped by
(row_dim, col_dim) into flat ``(n_blocks + 1, dr*dc)`` value tensors whose
last row is a trash block, plus per (factor type, slot pair) maps of
where each factor's ``J_s^T dL P J_t`` lands.

``compute_hessian_values`` forms the per-factor block products and reduces
them into the groups with ``reduce_rows``; ``apply_damping`` returns a
copy with damped diagonal-block diagonals: ``d + mu`` or
``d + mu * clamp(d, 1e-6, 1e32)`` from the undamped scaled diagonal.

The direct solvers read the full symmetric matrix: ``csc_values`` (its
scalar CSC values, structure from ``ensure_csc_structure``) and
``dense_hessian_matrix`` (dense on the device). Each position has exactly
one source entry, so both are indexed copies, with no sums and no atomics;
``hessian_to_dense`` is the tests' NumPy oracle.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import hostops
from .linearize import DIAG_MAX, DIAG_MIN, Linearization
from .ops.blockfmt import flat_block_mm_nn, flat_block_mm_tn
from .ops.streamreduce import reduce_rows, segment_plan
from .perf import SectionTimer


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
    # scalar CSC export of the full symmetric matrix, built on first use
    # by ensure_csc_structure (only the sparse direct solvers need it);
    # per group, the CSC position of each block entry and of its
    # transposed copy (nnz for the trash block and for diagonal blocks'
    # transposes)
    csc_indptr: Optional[np.ndarray] = None  # (dim_h + 1,)
    csc_indices: Optional[np.ndarray] = None  # (nnz,)
    nnz: int = 0
    csc_dst: Optional[Dict[Tuple[int, int], np.ndarray]] = None
    csc_dst_t: Optional[Dict[Tuple[int, int], np.ndarray]] = None


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


def _unique_merge_inverse(all_codes, diag_source, n_cols):
    """(sorted unique codes, concatenated inverse) over per-source code
    arrays: each source is uniqued on its own (a self-pair source, whose
    codes b*(n_cols+1) rise with the block id b, by the bounded rank of
    b), the per-source uniques are merged, and each source's inverse is
    remapped through its ranks in the merged array. The same arrays as one
    ``np.unique(return_inverse=True)`` of the concatenation."""
    if not all_codes:
        z = np.zeros(0, dtype=np.int64)
        return z, z
    uniqs, invs = [], []
    for codes_s, is_diag in zip(all_codes, diag_source):
        if is_diag and n_cols < hostops.BOUNDED_UNIQUE_LIMIT:
            ub, inv = hostops.unique_inverse(codes_s // (n_cols + 1),
                                             bound=n_cols)
            uniqs.append(ub * (n_cols + 1))
        else:
            ub, inv = hostops.unique_inverse(codes_s)
            uniqs.append(ub)
        invs.append(inv)
    if len(uniqs) == 1:
        return uniqs[0], invs[0]
    merged = hostops.sorted_unique(np.concatenate(uniqs))
    out = np.empty(sum(c.shape[0] for c in all_codes), dtype=np.int64)
    off = 0
    for u, inv in zip(uniqs, invs):
        out[off:off + inv.shape[0]] = hostops.searchsorted(merged, u)[inv]
        off += inv.shape[0]
    return merged, out


def build_hessian_structure(problem) -> HessianStructure:
    """The problem's Hessian structure (built once, then cached); its
    section laps (``perf.SectionTimer``) go to
    ``problem._cache["setup_laps"]["hessian_structure"]``."""
    if "hessian_structure" in problem._cache:
        return problem._cache["hessian_structure"]
    timer = SectionTimer("hessian_structure")
    block_dims = problem.block_dims
    n_cols = problem.n_blocks

    # 1. upper-triangular block codes c*n_cols + r from every slot pair;
    # sorted unique codes are CSC order with the diagonal block last
    pair_sources = []
    all_codes = []
    diag_source = []  # s == t: codes b*(n_cols+1), ranked by b alone
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
                diag_source.append(s == t)
                pair_sources.append((fname, s, t, bs, bt, valid))
    timer.lap("collect_codes")

    # each source uniqued on its own, then a merge of the per-source
    # uniques and a rank remap (one radix pass per source of n_obs codes,
    # not one of all sources together)
    codes, code_inverse = _unique_merge_inverse(all_codes, diag_source,
                                                n_cols)
    block_rows = codes % n_cols
    block_cols = codes // n_cols
    nb = codes.shape[0]

    # 2. group by (dr, dc), preserving CSC order within each group
    dr_all = block_dims[block_rows] if nb else np.zeros(0, dtype=np.int64)
    dc_all = block_dims[block_cols] if nb else np.zeros(0, dtype=np.int64)
    dim_codes = dr_all * 100000 + dc_all
    max_dim = int(block_dims.max()) if block_dims.size else 1
    uniq_dims, group_of_block = hostops.unique_inverse(
        dim_codes, bound=max_dim * 100000 + max_dim + 1)
    group_keys = [(int(d // 100000), int(d % 100000)) for d in uniq_dims]
    counts = np.bincount(group_of_block, minlength=len(group_keys)).astype(
        np.int64)
    group_counts = {key: int(c) for key, c in zip(group_keys, counts)}
    index_in_group = np.empty(nb, dtype=np.int64)
    perm = hostops.stable_argsort(group_of_block, len(group_keys))
    index_in_group[perm] = (
        np.arange(nb) - np.repeat(np.concatenate([[0], np.cumsum(counts)[:-1]]),
                                  counts))
    timer.lap("unique_and_groups")

    # 3. contribution maps: direct (bs <= bt) and transposed (bs > bt, plus
    # the self-block transpose when bs == bt and s < t); each source's
    # segment of code_inverse is its blocks' positions, in order
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
    timer.lap("contrib_maps")

    # 4. diagonal-block lookup per block column
    cols_j = np.arange(n_cols)
    diag_codes = cols_j * n_cols + cols_j
    diag_pos_c = np.clip(hostops.searchsorted(codes, diag_codes), 0,
                         max(nb - 1, 0))
    diag_found = (nb > 0) & (codes[diag_pos_c] == diag_codes)
    diag_group = np.where(diag_found, group_of_block[diag_pos_c], -1)
    diag_idx = np.where(diag_found, index_in_group[diag_pos_c], 0)

    hs = HessianStructure(
        block_rows=block_rows, block_cols=block_cols, n_blocks=nb,
        group_keys=group_keys, group_of_block=group_of_block,
        index_in_group=index_in_group, group_sizes=group_counts,
        contribs=contribs, diag_group=diag_group, diag_idx=diag_idx)
    timer.lap("diag_lookup")
    timer.done()
    problem._cache.setdefault("setup_laps", {})["hessian_structure"] = (
        timer.laps)
    problem._cache["hessian_structure"] = hs
    return hs


def compute_hessian_values(problem, hs: HessianStructure,
                           lin: Linearization) -> HessianValues:
    """H = J^T dL P J into the grouped block storage (Jacobians already
    scaled and masked). On a rank's replica the block list is the whole
    problem's and the factor rows the rank's slice: each group is summed
    over the ranks."""
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
        if J is None:
            raise ValueError("explicit Hessian requires stored Jacobians "
                             f"('{cm.fname}' is dynamic)")
        E = fm.ftype.residual_dim
        ds = fm.ftype.vertex_types[cm.s].dim
        dt_ = fm.ftype.vertex_types[cm.t].dim
        jt = J[cm.t].to(acc)
        if fa.precision is not None:
            jt = flat_block_mm_nn(fa.precision, jt, E, E, dt_, acc_dtype=acc)
        flat = (flat_block_mm_tn(J[cm.s], jt, ds, E, dt_, acc_dtype=acc)
                * lin.chi2_deriv[cm.fname].to(acc)[:, None]).to(inv_dt)
        if cm.direct_idx is not None:
            plan = segment_plan(problem, ("hess_d", ci),
                                problem.shard_slice(cm.direct_idx,
                                                    flat.shape[0]),
                                hs.group_sizes[cm.direct_group] + 1,
                                flat.shape[1])
            values[cm.direct_group] = values[cm.direct_group] + reduce_rows(
                flat, plan)
        if cm.trans_idx is not None:
            # row-major (ds, dt) -> (dt, ds) transpose of each flat row
            flat_t = flat.reshape(-1, ds, dt_).transpose(1, 2).reshape(
                -1, ds * dt_)
            plan = segment_plan(problem, ("hess_t", ci),
                                problem.shard_slice(cm.trans_idx,
                                                    flat_t.shape[0]),
                                hs.group_sizes[cm.trans_group] + 1,
                                flat_t.shape[1])
            values[cm.trans_group] = values[cm.trans_group] + reduce_rows(
                flat_t, plan)
    return {key: problem.allreduce(v) for key, v in values.items()}


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


def ensure_csc_structure(problem, hs: HessianStructure) -> HessianStructure:
    """Build the scalar CSC export of the full symmetric H on first use:
    per group all direct entries, then the transposed entries of its
    off-diagonal blocks, sorted by (column, row)."""
    if hs.csc_indptr is not None:
        return hs
    dim_h = problem.dim_h
    offsets = problem.block_offsets
    rows_segments: List[np.ndarray] = []
    cols_segments: List[np.ndarray] = []
    seg_layout = []  # (key, transposed, block index in group)
    for gi, key in enumerate(hs.group_keys):
        dr, dc = key
        members = np.nonzero(hs.group_of_block == gi)[0]  # CSC order
        r_ids = hs.block_rows[members]
        c_ids = hs.block_cols[members]
        rr = offsets[r_ids][:, None, None] + np.arange(dr)[None, :, None]
        cc = offsets[c_ids][:, None, None] + np.arange(dc)[None, None, :]
        shape = (len(members), dr, dc)
        rows_segments.append(np.broadcast_to(rr, shape).ravel())
        cols_segments.append(np.broadcast_to(cc, shape).ravel())
        seg_layout.append((key, False, hs.index_in_group[members]))
        off = members[r_ids != c_ids]
        if off.size:
            r_o, c_o = hs.block_rows[off], hs.block_cols[off]
            # transposed copy: entry (i, j) of the block lands at
            # (col offset + j, row offset + i)
            rr_t = offsets[c_o][:, None, None] + np.arange(dc)[None, None, :]
            cc_t = offsets[r_o][:, None, None] + np.arange(dr)[None, :, None]
            shape = (off.size, dr, dc)
            rows_segments.append(np.broadcast_to(rr_t, shape).ravel())
            cols_segments.append(np.broadcast_to(cc_t, shape).ravel())
            seg_layout.append((key, True, hs.index_in_group[off]))

    if rows_segments:
        rows_cat = np.concatenate(rows_segments)
        cols_cat = np.concatenate(cols_segments)
    else:
        rows_cat = cols_cat = np.zeros(0, dtype=np.int64)
    order = np.lexsort((rows_cat, cols_cat))  # by column, then row
    nnz = rows_cat.shape[0]
    csc_indptr = np.zeros(dim_h + 1, dtype=np.int64)
    np.cumsum(np.bincount(cols_cat, minlength=dim_h), out=csc_indptr[1:])
    pos_of = np.empty(nnz, dtype=np.int64)
    pos_of[order] = np.arange(nnz)

    csc_dst = {key: np.full((hs.group_sizes[key] + 1, key[0], key[1]), nnz,
                            dtype=np.int64) for key in hs.group_keys}
    csc_dst_t = {key: np.full((hs.group_sizes[key] + 1, key[0], key[1]), nnz,
                              dtype=np.int64) for key in hs.group_keys}
    cursor = 0
    for key, transposed, in_group in seg_layout:
        n_entries = in_group.size * key[0] * key[1]
        target = csc_dst_t if transposed else csc_dst
        target[key][in_group] = pos_of[cursor:cursor + n_entries].reshape(
            -1, key[0], key[1])
        cursor += n_entries

    hs.csc_indptr = csc_indptr
    hs.csc_indices = rows_cat[order]
    hs.nnz = nnz
    hs.csc_dst = csc_dst
    hs.csc_dst_t = csc_dst_t
    return hs


def csc_values(problem, hs: HessianStructure,
               values: HessianValues) -> torch.Tensor:
    """The full symmetric H's (nnz,) CSC values in ``inv_dtype``. Every
    position has one source entry, so this is an indexed copy, with no
    sums."""
    ensure_csc_structure(problem, hs)
    acc = problem.precision.inv_dtype
    out = torch.zeros(hs.nnz, dtype=acc, device=problem.device)
    for key, (n, dst, src_t, dst_t) in _csc_positions(problem, hs).items():
        flat = values[key].reshape(-1).to(acc)
        out.index_copy_(0, dst, flat[:n])
        if src_t.numel():
            out.index_copy_(0, dst_t, flat.index_select(0, src_t))
    return out


def _csc_positions(problem, hs: HessianStructure):
    """Per group: the count of its real entries, their CSC positions, and
    the entries of the off-diagonal blocks with the positions of their
    transposed copies (host-built once, cached on the problem)."""
    cache = problem._cache
    if "csc_positions" not in cache:
        out = {}
        for key in hs.group_keys:
            n = hs.group_sizes[key] * key[0] * key[1]
            dst_t = hs.csc_dst_t[key].reshape(-1)
            src_t = np.nonzero(dst_t < hs.nnz)[0]
            out[key] = (n,
                        problem.index(("csc_dst", key),
                                      hs.csc_dst[key].reshape(-1)[:n]),
                        problem.index(("csc_src_t", key), src_t),
                        problem.index(("csc_dst_t", key), dst_t[src_t]))
        cache["csc_positions"] = out
    return cache["csc_positions"]


def _dense_h_positions(problem, hs: HessianStructure):
    """Per group: the flat dense positions of its real blocks' entries, its
    off-diagonal blocks and the positions of their transposes (host-built
    once, cached on the problem)."""
    cache = problem._cache
    if "dense_h_idx" not in cache:
        n = problem.dim_h
        offsets = problem.block_offsets
        out = {}
        for gi, key in enumerate(hs.group_keys):
            dr, dc = key
            sel = np.nonzero(hs.group_of_block == gi)[0]
            sel = sel[np.argsort(hs.index_in_group[sel], kind="stable")]
            r0 = offsets[hs.block_rows[sel]]
            c0 = offsets[hs.block_cols[sel]]
            idx = ((r0[:, None, None] + np.arange(dr)[None, :, None]) * n
                   + c0[:, None, None] + np.arange(dc)[None, None, :])
            o = np.nonzero(hs.block_rows[sel] != hs.block_cols[sel])[0]
            idx_t = ((c0[o][:, None, None]
                      + np.arange(dc)[None, None, :]) * n
                     + r0[o][:, None, None] + np.arange(dr)[None, :, None])
            out[key] = (problem.index(("dense_h", key), idx.reshape(-1)),
                        problem.index(("dense_h_o", key), o),
                        problem.index(("dense_h_t", key), idx_t.reshape(-1)))
        cache["dense_h_idx"] = out
    return cache["dense_h_idx"]


def dense_hessian_matrix(problem, hs: HessianStructure,
                         values: HessianValues) -> torch.Tensor:
    """Dense (dim_h, dim_h) H in ``inv_dtype`` from the upper-triangular
    block values, mirrored. Every entry has one source, so this is an
    indexed copy, with no sums."""
    n = problem.dim_h
    acc = problem.precision.inv_dtype
    h = torch.zeros(n * n, dtype=acc, device=problem.device)
    for key, (idx, o, idx_t) in _dense_h_positions(problem, hs).items():
        # value groups carry a trailing trash row: only the real blocks
        v = values[key][: hs.group_sizes[key]].to(acc)
        h.index_copy_(0, idx, v.reshape(-1))
        if o.numel():
            h.index_copy_(0, idx_t, v.index_select(0, o).reshape(-1))
    return h.reshape(n, n)


def hessian_to_dense(problem, hs: HessianStructure,
                     values: HessianValues) -> np.ndarray:
    """Dense float64 NumPy H, block by block (the tests' oracle)."""
    n = problem.dim_h
    H = np.zeros((n, n))
    offsets = problem.block_offsets
    host = {key: v.detach().cpu().numpy().astype(np.float64)
            for key, v in values.items()}
    for i in range(hs.n_blocks):
        r, c = int(hs.block_rows[i]), int(hs.block_cols[i])
        key = hs.group_keys[hs.group_of_block[i]]
        blk = host[key][hs.index_in_group[i]].reshape(key)
        r0, c0 = int(offsets[r]), int(offsets[c])
        H[r0:r0 + key[0], c0:c0 + key[1]] += blk
        if r != c:
            H[c0:c0 + key[1], r0:r0 + key[0]] += blk.T
    return H
