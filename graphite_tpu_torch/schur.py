"""Schur complement S = Hpp - Hpl Hll^{-1} Hpl^T (counterpart of
``graphite_tpu/schur.py``).

Structure (host, once per topology): pose blocks are the Hessian block
columns before ``elimination_block``, landmark blocks the trailing
eliminated ones. For every landmark, every pair of pose blocks it touches
is a fill-in block of S (unioned with the Hpp sparsity), and each pair is
one triple product ``dst -= W_left R_right^T`` with ``W = Hpl Hll^{-1}``;
the products are grouped by (dp_a, dl, dp_b) and sorted by destination.

Values (``schur_values``): Hll^{-1} per landmark dim and W (``landmark_w``:
K10, ``ops/cuda/schur_w``, one launch per Hpl group where the inverses
are float32 and at most 3x3), the Hpp copy (unique destinations, an
indexed assignment), and the triple products.
At most ``_chunk_threshold`` products per group are formed row by row and
reduced by the sorted-segment-sum kernel (K1, ``ops/cuda/segsum``) and
subtracted from the Hpp copy; above it the fused triple-product kernel
(K3) reads W and Hpl by index, with a plan of its own (lanes per S
block), and writes S itself: the Hpp copy minus its sums, read from the
Hessian values by a cached per-block row index (``hpp_base``).

On a rank's replica of a sharded problem (``problem.sharded``,
``parallel/sharding.py``) the triple products are split by destination
range (``sharded_partition``): each rank reduces its pairs from gathered
streams with K3's gathered-stream entry and one gather places the ranks'
disjoint ranges of S.

``SchurOps`` adds ``b_schur``, ``landmark_update``, ``compose_delta`` and
the block-sparse S matvec (``prepare_matvec`` / ``s_matvec``). Sites with
more blocks than ``_smv_chunk_rows`` take the block-matvec kernels (K4
for b_schur and the back-substitution, K5 for S x); smaller ones form
their rows and reduce them with K1. The gates are the JAX package's, so
the port takes its branch at every size and dtype: a site opens its
kernel only where its values are float32 (``kernel_dtype``, the dtype
test of the JAX package's ``use_pallas``) and it is above its size gate.
A float64 site (the Hessian and Schur values of FP64_FP64 and FP64_BF16)
takes the stepwise branch, whose reductions run on K1 in float64. Where
the values are float32 and the vectors float64 (FP64_FP32), a kernel site
takes its vector in float32 (w = Hll^-1 b_l is in the values' dtype;
S x and the back-substitution cast x in) and casts its result out to the
graph dtype. The size gates are module globals that tests lower to force
the large-problem branches at toy size. The JAX package's other gates
(``TABLE_ROWS_LIMIT``, ``slot_geom``, the window plans,
``STREAM_PART_ROWS``) bound TPU VMEM and HBM transients that the GPU
kernels do not have, and are not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import hostops
from .hessian import HessianValues, build_hessian_structure
from .ops.blockfmt import (
    flat_block_mm_nt,
    flat_block_mv,
    flat_block_mv_t,
)
from .ops.cuda import schur_w
from .ops.cuda.segmv import (
    block_matvec_wtbl,
    matvec_sym_stream,
    plan_matvec_sym,
)
from .ops.cuda.segsum import sorted_segment_sum
from .ops.cuda.segsum_stream import (
    streaming_matvec_tbl,
    streaming_segment_product_sum,
    streaming_segment_product_sum_rtbl,
)
from .ops.streamreduce import (
    map_chunk_rows,
    matvec_plan,
    product_plan,
    reduce_rows,
    segment_plan,
    take_rows,
)
from .perf import SectionTimer

# Triple-product groups with more pairs than this take K3. The JAX package
# lowers the bound to 2^19 above dim_h = 1M (a TPU HBM limit); the port
# keeps both numbers so that it takes the same branch at every size.
CHUNK_THRESHOLD = 1 << 22


def _chunk_threshold(problem) -> int:
    """Product-group size above which ``schur_values`` takes K3 (reads
    the module global, so tests can force the branch)."""
    if problem.dim_h > 1_000_000:
        return min(CHUNK_THRESHOLD, 1 << 19)
    return CHUNK_THRESHOLD


def kernel_dtype(dtype: torch.dtype) -> bool:
    """Whether a K3, K4 or K5 site of values in ``dtype`` may take its
    kernel: float32 only, as the JAX package's ``use_pallas``."""
    return dtype == torch.float32


def _smv_chunk_rows(row_bytes: int) -> int:
    """Block count above which a b_schur, back-substitution or S matvec
    site takes K4 / K5 (``map_chunk_rows``; its own symbol so tests can
    force the branch)."""
    return map_chunk_rows(row_bytes)


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
    perm = hostops.stable_argsort(group_ids, n_groups)
    out[perm] = np.arange(group_ids.shape[0]) - np.repeat(starts, counts)
    return out


def build_schur_structure(problem) -> SchurStructure:
    """The problem's Schur structure (built once, then cached); its
    section laps (``perf.SectionTimer``) go to
    ``problem._cache["setup_laps"]["schur_structure"]``."""
    if "schur_structure" in problem._cache:
        return problem._cache["schur_structure"]
    timer = SectionTimer("schur_structure")
    hs = build_hessian_structure(problem)
    timer.lap("hessian_structure")
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
    lm_group_index = _cumcount(
        np.searchsorted(np.asarray(lm_dims, dtype=np.int64), lm_dim_of),
        len(lm_dims))
    lm_h_idx: Dict[int, np.ndarray] = {}
    for d in lm_dims:
        sel = lm_j[lm_dim_of == d]
        if np.any(hs.diag_group[sel] < 0):
            raise ValueError("landmark without a diagonal block")
        lm_h_idx[d] = hs.diag_idx[sel].astype(np.int64)
    timer.lap("lm_groups")

    # classify H blocks
    is_hpp = cols_h < eb
    hpl_sel = np.nonzero((~is_hpp) & (rows_h < eb))[0]  # sorted by (lm, pose)
    hpl_code = dims[rows_h[hpl_sel]] * 100000 + dims[cols_h[hpl_sel]]
    hpl_keys: List[Tuple[int, int]] = []
    hpl_h_idx, hpl_pose, hpl_lm = {}, {}, {}
    key_id_of = np.zeros(hpl_sel.shape[0], dtype=np.int64)
    idx_in_key = np.zeros(hpl_sel.shape[0], dtype=np.int64)
    for code in hostops.sorted_unique(hpl_code):
        key = (int(code // 100000), int(code % 100000))
        m = hpl_code == code
        sel = hpl_sel[m]
        key_id_of[m] = len(hpl_keys)
        hpl_keys.append(key)
        hpl_h_idx[key] = hs.index_in_group[sel].astype(np.int64)
        hpl_pose[key] = rows_h[sel].astype(np.int64)
        hpl_lm[key] = (cols_h[sel] - eb).astype(np.int64)
        idx_in_key[m] = np.arange(sel.shape[0])
    timer.lap("hpl_groups")

    # per-landmark attach lists + pose-pair fill-in discovery. With one
    # (dp, dl) group (uniform dims, as BAL) the fused plan gives the
    # products already sorted by destination, with no pair list; above its
    # gates, the pair fill writes the attach values directly; otherwise
    # the pairs index the sorted attach list
    att_lm = cols_h[hpl_sel] - eb
    att_pose = rows_h[hpl_sel]
    single_pair_group = len(hpl_keys) == 1 and len(lm_dims) == 1
    hpp_sel = np.nonzero(is_hpp)[0]
    hpp_codes = cols_h[hpp_sel] * n_pose + rows_h[hpp_sel]
    plan_sorted = None
    if single_pair_group:
        plan_sorted = hostops.schur_pair_plan(
            att_lm, att_pose, n_lm, n_pose, idx_in_key, hpp_codes)
    if plan_sorted is not None:
        _, left_s, right_s, _, dst_s, s_codes, hpp_pos = plan_sorted
    elif single_pair_group:
        (_, left_v, right_v, pair_lm,
         pair_codes) = hostops.attach_pairs_vals(
            att_lm, att_pose, n_lm, n_pose, idx_in_key)
    else:
        (att_order, _, _, ai, bi, pair_lm, pair_codes, pose_a,
         pose_b) = hostops.attach_pairs(att_lm, att_pose, n_lm, n_pose)
        att_key_s = key_id_of[att_order]
        att_idx_s = idx_in_key[att_order]
    timer.lap("attach_pairs")

    # S sparsity: union of the Hpp coordinates and the fill-in pairs (the
    # fused plan gave it); one bounded rank gives every Hpp block's and
    # every pair's destination
    if plan_sorted is None:
        s_codes, s_inverse = hostops.unique_inverse(
            np.concatenate([hpp_codes, pair_codes]), bound=n_pose * n_pose)
        hpp_pos = s_inverse[: hpp_codes.shape[0]]
        pair_pos = s_inverse[hpp_codes.shape[0]:]
    s_rows_all = (s_codes % n_pose).astype(np.int64)
    s_cols_all = (s_codes // n_pose).astype(np.int64)
    s_dim_code = dims[s_rows_all] * 100000 + dims[s_cols_all]
    max_dim = int(dims.max()) if dims.size else 1
    uniq_sdims, s_group_of = hostops.unique_inverse(
        s_dim_code, bound=max_dim * 100000 + max_dim + 1)
    s_keys = [(int(c // 100000), int(c % 100000)) for c in uniq_sdims]
    s_index_in_group = _cumcount(s_group_of, len(s_keys))
    s_sizes = {key: int(c) for key, c in zip(
        s_keys, np.bincount(s_group_of, minlength=len(s_keys)))}
    s_rows = {key: s_rows_all[s_group_of == gi]
              for gi, key in enumerate(s_keys)}
    s_cols = {key: s_cols_all[s_group_of == gi]
              for gi, key in enumerate(s_keys)}
    timer.lap("s_sparsity")

    # Hpp copy grouped by H group
    hpp_copy = []
    hpp_dims_code = dims[rows_h[hpp_sel]] * 100000 + dims[cols_h[hpp_sel]]
    hpp_s_idx = s_index_in_group[hpp_pos]
    for code in np.unique(hpp_dims_code):
        key = (int(code // 100000), int(code % 100000))
        m = hpp_dims_code == code
        hpp_copy.append((key, hs.index_in_group[hpp_sel[m]].astype(np.int64),
                         hpp_s_idx[m].astype(np.int64)))
    timer.lap("hpp_copy")

    # triple products grouped by (dpa, dl, dpb), sorted by destination
    products = []
    if single_pair_group:
        # one (dp, dl, dp) group: with one S group the in-group index is
        # the S rank, and left / right came from the pair fill
        dp, dl = hpl_keys[0]
        dst_key = (dp, dp)
        if plan_sorted is None:
            dst = (pair_pos if len(s_keys) == 1
                   else s_index_in_group[pair_pos])
            dst_s, left_s, right_s, _ = hostops.sort_apply3(
                dst, s_sizes[dst_key], left_v, right_v, pair_lm)
        elif len(s_keys) > 1:
            # the fused plan gives S ranks; the in-group index is monotone
            # in them within the group, so the order holds
            dst_s = s_index_in_group[dst_s]
        products.append(dict(
            dims=(dp, dl, dp), left_key=hpl_keys[0], right_key=hpl_keys[0],
            dst_key=dst_key, left=left_s, right=right_s, dst=dst_s))
    else:
        dst_idx_all = s_index_in_group[pair_pos]
        dst_group_all = s_group_of[pair_pos]
        dl_all = lm_dim_of[pair_lm]
        tri_code = (dims[pose_a] * 100000 + dl_all) * 100000 + dims[pose_b]
        for code in hostops.sorted_unique(tri_code):
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
            dst = dst_idx_all[m]
            order = hostops.stable_argsort(dst, s_sizes[dst_key])
            products.append(dict(
                dims=(dpa, dl, dpb), left_key=hpl_keys[int(lkeys[0])],
                right_key=hpl_keys[int(rkeys[0])], dst_key=dst_key,
                left=att_idx_s[ai[m]][order], right=att_idx_s[bi[m]][order],
                dst=dst[order]))

    # right operands are read from the (dp, dl) H group, whose rows may
    # also hold diagonal / Hpp blocks when dp == dl: compose the pair's
    # Hpl-local index through hpl_h_idx (the identity where the group
    # holds Hpl blocks only, as BAL's). The builder's arrays become int64
    # here, once
    for pg in products:
        hidx = hpl_h_idx[pg["right_key"]]
        if not np.array_equal(hidx, np.arange(hidx.shape[0])):
            pg["right"] = hidx[pg["right"]]
        for name in ("left", "right", "dst"):
            pg[name] = pg[name].astype(np.int64, copy=False)
    timer.lap("products")

    # S diagonal lookup
    diag_codes = np.arange(n_pose) * n_pose + np.arange(n_pose)
    ns_total = s_codes.shape[0]
    pos_c = np.clip(hostops.searchsorted(s_codes, diag_codes), 0,
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
    timer.lap("diag_and_block_maps")
    timer.done()
    problem._cache.setdefault("setup_laps", {})["schur_structure"] = (
        timer.laps)
    problem._cache["schur_structure"] = ss
    return ss


@dataclasses.dataclass
class SchurValues:
    hll_inv: Dict[int, torch.Tensor]  # dim -> (L_d, d*d) flat
    s_vals: Dict[Tuple[int, int], torch.Tensor]  # key -> (nS_g, dr*dc)


def _w_plan(problem, ss: SchurStructure, key) -> schur_w.WPlan:
    """Where each landmark's blocks are in Hpl group ``key`` (its repeat
    counts and row offsets, built on the host once). Valid only because
    the Hpl blocks are sorted by landmark (CSC order), which is checked
    here."""
    cache = problem._cache.setdefault("hpl_w_plans", {})
    if key not in cache:
        dl = key[1]
        gi = ss.lm_group_index[ss.hpl_lm[key]]
        if gi.size and np.any(np.diff(gi) < 0):
            raise ValueError("Hpl blocks are not sorted by landmark")
        cache[key] = schur_w.plan_w(
            np.bincount(gi, minlength=ss.lm_h_idx[dl].shape[0]),
            problem.device)
    return cache[key]


def landmark_w(problem, ss: SchurStructure, hvals: HessianValues
               ) -> Tuple[Dict[int, torch.Tensor],
                          Dict[Tuple[int, int], torch.Tensor]]:
    """Hll^{-1} per landmark dim and W = Hpl Hll^{-1} once per Hpl block,
    per Hpl group. Hll^{-1} is symmetric, so each triple product L M R^T
    is W_left R_right^T. A landmark dim whose inverses are float32 and
    at most 3x3 (``schur_w.gate``) takes K10, one launch per Hpl group of
    the dim (the first stores the inverses); any other keeps the plain
    versions, on the card as well."""
    inv_dt = problem.precision.inv_dtype
    hll_inv, hpl_w = {}, {}
    for d in ss.lm_dims:
        hll = take_rows(problem, ("lm_h_idx", d), hvals[(d, d)],
                        ss.lm_h_idx[d]).to(inv_dt)
        keys = [key for key in ss.hpl_keys if key[1] == d]
        k10 = schur_w.gate(inv_dt, d)
        if not k10:
            hll_inv[d] = schur_w.hll_inverse_plain(hll, d)
        elif not keys:
            hll_inv[d], _ = schur_w.schur_w(hll, None, None, 0, d)
        for i, key in enumerate(keys):
            hpl = take_rows(problem, ("hpl_h", key), hvals[key],
                            ss.hpl_h_idx[key]).to(inv_dt)
            plan = _w_plan(problem, ss, key)
            if not k10:
                hpl_w[key] = schur_w.hpl_w_plain(hpl, hll_inv[d], plan,
                                                 key[0], d)
                continue
            inv, hpl_w[key] = schur_w.schur_w(hll, hpl, plan, key[0], d,
                                              write_inverse=i == 0)
            if i == 0:
                hll_inv[d] = inv
    return hll_inv, {key: hpl_w[key] for key in ss.hpl_keys}


def _s_start(problem, ss: SchurStructure, hvals: HessianValues,
             key) -> torch.Tensor:
    """S group ``key`` as a copy of its Hpp blocks (unique destinations),
    zero elsewhere: where the stepwise branch, a rank's gathered products
    and an S group with no product group start."""
    inv_dt = problem.precision.inv_dtype
    s = torch.zeros((ss.s_sizes[key], key[0] * key[1]), dtype=inv_dt,
                    device=problem.device)
    for hi, (hkey, h_idx, s_idx) in enumerate(ss.hpp_copy):
        if hkey == key:
            src = hvals[hkey].index_select(0, problem.index(("hpp_h", hi),
                                                            h_idx))
            s.index_copy_(0, problem.index(("hpp_s", hi), s_idx),
                          src.to(inv_dt))
    return s


def hpp_base(problem, ss: SchurStructure, hvals: HessianValues, key
             ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """The base of S group ``key``'s first K3 store (S = Hpp - the
    products, written once): its Hpp values group (None where it has
    none) and, per S block, the row copied into it, -1 where none (int32,
    built on the host once and cached)."""

    def rows():
        idx = np.full(ss.s_sizes[key], -1, dtype=np.int64)
        for hkey, h_idx, s_idx in ss.hpp_copy:
            if hkey == key:
                idx[s_idx] = h_idx
        return idx

    base_idx = problem.index32(("s_base", key), rows)
    if not any(hkey == key for hkey, _, _ in ss.hpp_copy):
        return None, base_idx
    return hvals[key].to(problem.precision.inv_dtype), base_idx


def schur_values(problem, ss: SchurStructure,
                 hvals: HessianValues) -> SchurValues:
    """S = Hpp - Hpl Hll^{-1} Hpl^T from damped H values. Where a
    product group takes K3, K3 writes S itself: the first group into an S
    group stores its Hpp copy minus the sums (``hpp_base``), a later one
    subtracts in place. Elsewhere S starts as the Hpp copy (``_s_start``)
    and each group's sums are subtracted from it."""
    inv_dt = problem.precision.inv_dtype
    hll_inv, hpl_w = landmark_w(problem, ss, hvals)

    if problem.sharded:
        s_vals = {key: _s_start(problem, ss, hvals, key)
                  for key in ss.s_keys}
        _sharded_products(problem, ss, hvals, hpl_w, s_vals)
        return SchurValues(hll_inv=hll_inv, s_vals=s_vals)
    s_vals = {}
    for gi, pg in enumerate(ss.products):
        dpa, dl, dpb = pg["dims"]
        key = pg["dst_key"]
        W = hpl_w[pg["left_key"]]
        R = hvals[pg["right_key"]].to(inv_dt)
        if (pg["dst"].shape[0] > _chunk_threshold(problem)
                and kernel_dtype(inv_dt)):
            # K3 reads the W and Hpl rows by index: no gathered stream and
            # no (K, dpa*dpb) product buffer; its plan gives each S block
            # its own lanes, and its store writes S
            base, base_idx = ((s_vals[key], None) if key in s_vals
                              else hpp_base(problem, ss, hvals, key))
            s_vals[key] = streaming_segment_product_sum_rtbl(
                W, R, product_plan(problem, ("prod_k3", gi), pg["dst"],
                                   ss.s_sizes[key]), dpa, dl, dpb,
                problem.index32(("prod_l", gi), pg["left"]),
                problem.index32(("prod_r", gi), pg["right"]),
                base=base, base_idx=base_idx)
        else:
            left = W.index_select(0, problem.index(("prod_l", gi),
                                                   pg["left"]))
            right = R.index_select(0, problem.index(("prod_r", gi),
                                                    pg["right"]))
            acc = sorted_segment_sum(
                flat_block_mm_nt(left, right, dpa, dl, dpb,
                                 acc_dtype=inv_dt),
                segment_plan(problem, ("prod_dst", gi), pg["dst"],
                             ss.s_sizes[key], dpa * dpb))
            if key not in s_vals:
                s_vals[key] = _s_start(problem, ss, hvals, key)
            s_vals[key] = s_vals[key] - acc
    for key in ss.s_keys:
        if key not in s_vals:
            s_vals[key] = _s_start(problem, ss, hvals, key)
    return SchurValues(hll_inv=hll_inv,
                       s_vals={key: s_vals[key] for key in ss.s_keys})


@dataclasses.dataclass
class ShardedPartition:
    """One product group split by destination over ``n`` ranks: rank r
    takes pairs ``bounds[r]:bounds[r+1]`` (about K/n, cut at segment
    boundaries, so no S block is split), whose destinations are the S
    blocks ``seg0[r]:seg0[r] + ns[r]``: disjoint and in rank order.
    ``plan`` is this rank's: its K3 plan (float32 values) or its K1 plan
    (float64), over destinations counted from ``seg0[rank]``; None when
    no pair falls to the rank."""

    bounds: np.ndarray  # (n + 1,)
    seg0: List[int]
    ns: List[int]
    left: torch.Tensor  # W row of each of this rank's pairs
    right: torch.Tensor  # Hpl row (in its H group) of each
    plan: object


def sharded_partition(problem, gi: int, pg: dict, n: int,
                      use_kernel: bool) -> ShardedPartition:
    """The destination partition of product group ``gi`` over ``n`` ranks
    and this rank's plan, built on the host once (cached on the rank's
    replica). The cut points are the JAX package's
    (``_plan_sharded_partition``)."""
    cache = problem._cache.setdefault("sharded_partitions", {})
    if (gi, n) in cache:
        return cache[(gi, n)]
    dst = pg["dst"]
    K = dst.shape[0]
    bounds = [0]
    for r in range(1, n):
        idx = int(np.searchsorted(dst, dst[min(r * (K // n), max(K - 1, 0))],
                                  side="left")) if K else 0
        bounds.append(max(idx, bounds[-1]))
    bounds.append(K)
    seg0, ns = [], []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        seg0.append(int(dst[lo]) if hi > lo else 0)
        ns.append(int(dst[hi - 1]) - seg0[-1] + 1 if hi > lo else 0)
    r = problem.mesh.rank
    lo, hi = bounds[r], bounds[r + 1]
    local = dst[lo:hi] - seg0[r]
    dpa, _, dpb = pg["dims"]
    tag = ("shard_prod", gi, n)
    if hi == lo:  # no pair falls to this rank
        plan = None
    elif use_kernel:
        plan = product_plan(problem, tag, local, ns[r])
    else:
        plan = segment_plan(problem, tag, local, ns[r], dpa * dpb)
    left = problem.index(tag + ("l",), pg["left"][lo:hi])
    right = problem.index(tag + ("r",), pg["right"][lo:hi])
    cache[(gi, n)] = ShardedPartition(
        bounds=np.asarray(bounds, dtype=np.int64), seg0=seg0, ns=ns,
        left=left, right=right, plan=plan)
    return cache[(gi, n)]


def _sharded_products(problem, ss: SchurStructure, hvals: HessianValues,
                      hpl_w, s_vals) -> None:
    """The triple products on a rank's replica, split by destination
    (``sharded_partition``): each rank reduces its own pairs, gathered
    into streams, with K3 (float32; its plain version on the CPU) or K1
    (float64), and one gather of the ranks' disjoint S ranges updates
    every rank's S. Hll^-1, W and everything after S stay replicated."""
    inv_dt = problem.precision.inv_dtype
    mesh = problem.mesh
    n = mesh.world
    use_kernel = kernel_dtype(inv_dt)
    for gi, pg in enumerate(ss.products):
        dpa, dl, dpb = pg["dims"]
        key = pg["dst_key"]
        part = sharded_partition(problem, gi, pg, n, use_kernel)
        W = hpl_w[pg["left_key"]]
        R = hvals[pg["right_key"]].to(inv_dt)
        padded = W.new_zeros((max(part.ns), dpa * dpb))
        if part.plan is not None:
            # one W row and one Hpl row per pair, gathered into streams
            Wg = W.index_select(0, part.left)
            Rg = R.index_select(0, part.right)
            if use_kernel:  # K3's gathered-stream entry
                local = streaming_segment_product_sum(Wg, Rg, part.plan,
                                                      dpa, dl, dpb)
            else:
                local = sorted_segment_sum(
                    flat_block_mm_nt(Wg, Rg, dpa, dl, dpb, acc_dtype=inv_dt),
                    part.plan)
            del Wg, Rg
            padded[:local.shape[0]] = local
        every = mesh.gather(padded, f"schur products {gi}")
        for r in range(n):
            if part.ns[r]:
                s0 = part.seg0[r]
                s_vals[key][s0:s0 + part.ns[r]] -= every[r, :part.ns[r]]


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
        # S values of the K5 sites, filled by prepare_matvec
        self._smv_prep = None

    def hpl(self, key) -> torch.Tensor:
        return take_rows(self.problem, ("hpl_h", key), self.hvals[key],
                         self.ss.hpl_h_idx[key])

    def _cached(self, name, key, build):
        """Host structure of this problem, built once by ``build()``."""
        cache = self.problem._cache.setdefault(name, {})
        if key not in cache:
            cache[key] = build()
        return cache[key]

    def _lm_partition(self):
        p = self.problem
        return self._cached(
            "lm_partition", None,
            lambda: _partition_blocks_by_type(
                self.ss, np.arange(p.elimination_block, p.n_blocks)))

    def hpl_partitions(self, key):
        """[(pose type, lm type, sel, pose rows, lm rows)] of Hpl group
        ``key``; ``sel`` indexes the group's Hpl blocks."""

        def build():
            ss = self.ss
            lm_abs = ss.hpl_lm[key] + self.problem.elimination_block
            out = []
            for pt, psel, prow in _partition_blocks_by_type(
                    ss, ss.hpl_pose[key]):
                for lt, lsel, lrow in _partition_blocks_by_type(
                        ss, lm_abs[psel]):
                    out.append((pt, lt, psel[lsel], prow[lsel], lrow))
            return out

        return self._cached("hpl_partitions", key, build)

    def s_sites(self, key):
        """[(row type, col type, sel, rows, cols, off-diagonal positions)]
        of S group ``key``: ``sel`` indexes the group's stored blocks,
        ``rows`` / ``cols`` are their rows in the types' segments (``cols``
        ascending: CSC order)."""

        def build():
            rows_b, cols_b = self.ss.s_rows[key], self.ss.s_cols[key]
            out = []
            for rt, rsel, rrow in _partition_blocks_by_type(self.ss, rows_b):
                for ct, csel, crow in _partition_blocks_by_type(
                        self.ss, cols_b[rsel]):
                    sub = rsel[csel]
                    off = np.nonzero(rows_b[sub] != cols_b[sub])[0]
                    out.append((rt, ct, sub, rrow[csel], crow, off))
            return out

        return self._cached("s_sites", key, build)

    def _nondecreasing(self, tag, a: np.ndarray) -> bool:
        return self._cached("nondecreasing", tag, lambda: bool(
            a.size == 0 or np.all(np.diff(a) >= 0)))

    def _hll_solve_rows(self, t_rows: Dict[str, torch.Tensor]
                        ) -> Dict[str, torch.Tensor]:
        """w = Hll^{-1} t per landmark type (rows in type-row order)."""
        out = {}
        for t, sel, rows in self._lm_partition():
            d = self.problem.vertex_meta[t].vtype.dim
            gidx = self._cached(
                "hllsolve_gidx", t, lambda sel=sel, rows=rows:
                self.ss.lm_group_index[sel[np.argsort(rows, kind="stable")]])
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
            for pt, lt, sub, prow, lrow in self.hpl_partitions(key):
                ck = ("bschur", key, pt, lt)
                Hsub = take_rows(problem, ck + ("sub",), Hpl, sub)
                if (sub.shape[0] > _smv_chunk_rows((dp * dl + dp + dl) * 4)
                        and kernel_dtype(Hsub.dtype)
                        and self._nondecreasing(ck, lrow)):
                    # K4: y[prow_i] += Hpl_i w[lrow_i], w read by index
                    plan = matvec_plan(problem, ck, prow,
                                       problem.seg_rows[pt])
                    acc = block_matvec_wtbl(
                        Hsub, w[lt], plan,
                        problem.index32(ck + ("lid",), lrow), dp, dl
                    ).to(gdt)
                else:
                    wg = w[lt].index_select(
                        0, problem.index(ck + ("lrow",), lrow))
                    y = flat_block_mv(Hsub, wg, dp, dl,
                                      acc_dtype=wg.dtype).to(gdt)
                    # the pose destinations are unsorted: the plan sorts
                    acc = reduce_rows(y, segment_plan(
                        problem, ck, prow, problem.seg_rows[pt], dp))
                prev = out_rows.get(pt)
                out_rows[pt] = acc if prev is None else prev + acc
        flat = problem.flat_from_rows({t: -v for t, v in out_rows.items()},
                                      dtype=gdt)
        return flat[: self.ss.dim_p] + b[: self.ss.dim_p].to(gdt)

    def sym_site(self, key, rt, ct):
        """(plan, cid, rxi) of the K5 site (key, rt, ct), built on the
        host once per problem: the row-sorted plan of both halves, the
        column rows as the forward x index, and the row rows as the
        transposed x index with diagonal blocks pointed at a zero row."""
        problem = self.problem

        def build():
            site = next(s for s in self.s_sites(key) if s[:2] == (rt, ct))
            _, _, sub, rrow, crow, off = site
            n_r, n_c = problem.seg_rows[rt], problem.seg_rows[ct]
            rxi = np.full(sub.shape[0], n_r, dtype=np.int64)
            rxi[off] = rrow[off]
            ck = ("smv", key, rt, ct)
            return (plan_matvec_sym(rrow, crow, n_r, n_c, problem.device,
                                    key[0]),
                    problem.index32(ck + ("cid",), crow),
                    problem.index32(ck + ("rxi",), rxi))

        return self._cached("smv_sym_sites", (key, rt, ct), build)

    def prepare_matvec(self):
        """Per solve, before the PCG loop: the S values of every site
        that takes K5 (more blocks than ``_smv_chunk_rows``), gathered
        only when the site is not a whole S group. Their index plans are
        built on the host once per problem (``sym_site``)."""
        prep = {}
        for key in self.ss.s_keys:
            dr, dc = key
            S = self.sv.s_vals[key]
            for rt, ct, sub, _, _, _ in self.s_sites(key):
                if (sub.shape[0] > _smv_chunk_rows((dr * dc + dr + dc + 3) * 4)
                        and kernel_dtype(S.dtype)):
                    ck = ("smv", key, rt, ct)
                    self.sym_site(key, rt, ct)
                    prep[ck] = take_rows(self.problem, ck + ("ysub",), S,
                                         sub)
        self._smv_prep = prep

    def s_matvec(self, x: torch.Tensor) -> torch.Tensor:
        """y = S x on (dim_p,) vectors, from the stored upper triangle:
        y_r += S_b x_c for every block, y_c += S_b^T x_r off the
        diagonal."""
        if self._smv_prep is None:
            self.prepare_matvec()
        problem = self.problem
        gdt = self._gdt
        y_rows: Dict[str, torch.Tensor] = {}

        def add_rows(t, acc):
            prev = y_rows.get(t)
            y_rows[t] = acc if prev is None else prev + acc

        for key in self.ss.s_keys:
            dr, dc = key
            S = self.sv.s_vals[key]
            for rt, ct, sub, rrow, crow, off in self.s_sites(key):
                ck = ("smv", key, rt, ct)
                x_ct = problem.rows_view(x, ct)
                x_rt = problem.rows_view(x, rt)
                S_sub = self._smv_prep.get(ck)
                if S_sub is not None:
                    # K5: both halves in one launch, summed here
                    plan, cid, rxi = self.sym_site(key, rt, ct)
                    yr, yc = matvec_sym_stream(
                        S_sub, x_ct.to(S_sub.dtype), x_rt.to(S_sub.dtype),
                        cid, rxi, plan, dr, dc)
                    add_rows(rt, yr.to(gdt))
                    add_rows(ct, yc.to(gdt))
                    continue
                # stepwise: the forward rows reduced into the (unsorted)
                # block rows, then the transposed rows of the off-diagonal
                # blocks into their (sorted) columns
                S_flat = take_rows(problem, ck + ("sub",), S, sub)
                xc = x_ct.index_select(0, problem.index(ck + ("crow",), crow))
                y = flat_block_mv(S_flat, xc, dr, dc, acc_dtype=gdt)
                add_rows(rt, reduce_rows(y, segment_plan(
                    problem, ck, rrow, problem.seg_rows[rt], dr)))
                if off.size:
                    ckt = ck + ("t",)
                    St = take_rows(problem, ckt + ("sub",), S, sub[off])
                    xr = x_rt.index_select(
                        0, problem.index(ckt + ("rrow",), rrow[off]))
                    y2 = flat_block_mv_t(St, xr, dr, dc, acc_dtype=gdt)
                    add_rows(ct, reduce_rows(y2, segment_plan(
                        problem, ckt, crow[off], problem.seg_rows[ct], dc)))
        return problem.flat_from_rows(y_rows, dtype=gdt)[: self.ss.dim_p]

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
            for pt, lt, sub, prow, lrow in self.hpl_partitions(key):
                ck = ("lu", key, pt, lt)
                Hsub = take_rows(problem, ck + ("sub",), Hpl, sub)
                x_pt = problem.rows_view(dx_p, pt)
                # Hpl is landmark-major: lrow is destination-sorted
                if (sub.shape[0] > _smv_chunk_rows((dp * dl + dp + dl) * 4)
                        and kernel_dtype(Hsub.dtype)
                        and self._nondecreasing(ck, lrow)):
                    # K4: t[lrow_i] -= Hpl_i^T dx_p[prow_i], x read by index
                    plan = matvec_plan(problem, ck, lrow,
                                       problem.seg_rows[lt])
                    acc = streaming_matvec_tbl(
                        Hsub, x_pt.to(Hsub.dtype),
                        problem.index32(ck + ("pidx",), prow), plan, dp, dl,
                        transpose=True).to(gdt)
                else:
                    x = x_pt.index_select(0, problem.index(ck + ("prow",),
                                                           prow))
                    y = flat_block_mv_t(Hsub, x, dp, dl, acc_dtype=gdt)
                    acc = reduce_rows(y, segment_plan(
                        problem, ck, lrow, problem.seg_rows[lt], dl))
                t_rows[lt] = t_rows[lt] - acc
        return self._hll_solve_rows(t_rows)

    def compose_delta(self, dx_p: torch.Tensor,
                      dx_l_rows: Dict[str, torch.Tensor]) -> torch.Tensor:
        """(dim_p,) pose delta + landmark rows -> full (dim_x,) delta."""
        out = self.problem.flat_from_rows(dx_l_rows, dtype=self._gdt)
        out[: dx_p.shape[0]] = dx_p.to(self._gdt)
        return out
