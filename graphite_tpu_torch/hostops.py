"""Host structure discovery: the sorts, uniques and pair enumerations of
the freeze-time builders (counterpart of ``graphite_tpu/hostops.py``).

``build_hessian_structure``, ``build_schur_structure`` and the reduction
plans (``ops/cuda/segsum.host_plan``) call these. Each entry runs the
host library ``native/structure.cpp`` (built with g++ at first use; a
failed build raises) and keeps its plain NumPy version beside it, named
``<entry>_numpy``: the two give the same arrays, values and dtypes, bit
for bit (``tests/test_torch_native_structure.py``). The plain versions are
the oracles of the tests and of ``chip_smoke.py``'s set-up check;
``PLAIN_VERSIONS`` maps each entry to its own. Nothing on the main path
calls them.

The size gates are the JAX package's branches, not fallbacks:
``schur_pair_plan`` returns None (the caller then takes the stepwise
path) above ``MAX_PAIR_CODES`` pair codes or from 2^31 pairs, and
``sort_apply3`` sorts 2^31 keys or more with NumPy. Callers reach every
entry through this module (``hostops.stable_argsort(...)``), never by a
name bound at import.
"""

from __future__ import annotations

import numpy as np

from .native import structure as native

# schur_pair_plan's gate on n_pose^2, the fused plan's table of a count
# and a rank per pair code (a module constant, so a test can lower it)
MAX_PAIR_CODES = 1 << 23
# unique_inverse ranks codes below a bound up to this by a flag array
BOUNDED_UNIQUE_LIMIT = 1 << 26


def _i64(a) -> np.ndarray:
    return np.asarray(a, dtype=np.int64)


def sorted_unique(codes) -> np.ndarray:
    """``np.unique`` of non-negative int64 codes."""
    return native.sort_unique(codes)


def sorted_unique_numpy(codes) -> np.ndarray:
    return np.unique(_i64(codes))


def searchsorted(sorted_arr, queries) -> np.ndarray:
    """``np.searchsorted(sorted_arr, queries, side='left')``."""
    return native.searchsorted(sorted_arr, queries)


def searchsorted_numpy(sorted_arr, queries) -> np.ndarray:
    return np.searchsorted(_i64(sorted_arr), _i64(queries))


def unique_inverse(codes, bound: int = 0):
    """(sorted unique values, inverse indices), as
    ``np.unique(codes, return_inverse=True)``. ``bound``: an exclusive
    upper bound on the codes; up to ``BOUNDED_UNIQUE_LIMIT`` it ranks by a
    flag array, which beats any sort."""
    if 0 < bound <= BOUNDED_UNIQUE_LIMIT:
        return native.unique_inverse_bounded(codes, bound)
    return native.sort_unique_inverse(codes)


def unique_inverse_numpy(codes, bound: int = 0):
    uniq, inverse = np.unique(_i64(codes).reshape(-1), return_inverse=True)
    return uniq, inverse.astype(np.int64, copy=False).reshape(-1)


def stable_argsort(keys, n_buckets: int) -> np.ndarray:
    """``np.argsort(keys, kind='stable')`` of keys in [0, n_buckets): a
    counting sort."""
    return native.counting_sort_perm(keys, n_buckets)


def stable_argsort_numpy(keys, n_buckets: int) -> np.ndarray:
    return np.argsort(np.asarray(keys), kind="stable")


def _sorted_attach(att_lm: np.ndarray, att_pose: np.ndarray,
                   n_pose: int) -> bool:
    """Whether the attach list is already sorted by (lm, pose), as the
    CSC-ordered Hpl blocks give it."""
    return bool(np.all(np.diff(att_lm * n_pose + att_pose) >= 0))


def _pair_total(counts: np.ndarray) -> int:
    return int((counts.astype(np.int64) * (counts + 1) // 2).sum())


def schur_pair_plan(att_lm, att_pose, n_lm: int, n_pose: int, vals,
                    hpp_codes):
    """The fused Schur plan of one (dp, dl) group: attach sort, pair fill,
    S sparsity and the destination-sorted products in one native pass
    pair, no pair list materialised. Returns (att_order, left, right,
    mid, dst, s_codes, hpp_pos), the pair arrays (int32) sorted by
    destination S block; ``att_order`` is None where the attach list came
    sorted (no caller needs it then). None above the gates: more than
    ``MAX_PAIR_CODES`` pair codes, or 2^31 pairs and more (int32
    cursors); the caller then takes the stepwise path."""
    att_lm = _i64(att_lm)
    if not att_lm.size or n_pose * n_pose > MAX_PAIR_CODES:
        return None
    att_pose = _i64(att_pose)
    if _sorted_attach(att_lm, att_pose, n_pose):
        att_order = None
        counts = np.bincount(att_lm, minlength=n_lm)
        total = _pair_total(counts)
        vals_s = np.ascontiguousarray(vals, dtype=np.int32)
        att_pose_s = att_pose
    else:
        att_order, counts, total = native.attach_sort(att_lm, att_pose,
                                                      n_lm)
        vals_s = np.asarray(vals, dtype=np.int32)[att_order]
        att_pose_s = att_pose[att_order]
    if total >= (1 << 31):
        return None
    left, right, mid, dst, s_codes, hpp_pos = native.pair_fill_sorted(
        counts, att_pose_s, vals_s, n_pose, total, hpp_codes)
    return att_order, left, right, mid, dst, s_codes, hpp_pos


def schur_pair_plan_numpy(att_lm, att_pose, n_lm: int, n_pose: int, vals,
                          hpp_codes):
    """The same plan stepwise: ``attach_pairs_numpy``, the unique of the
    Hpp and pair codes and a stable sort by destination."""
    att_lm = _i64(att_lm)
    if not att_lm.size or n_pose * n_pose > MAX_PAIR_CODES:
        return None
    if _pair_total(np.bincount(att_lm, minlength=n_lm)) >= (1 << 31):
        return None
    att_pose = _i64(att_pose)
    hpp_codes = _i64(hpp_codes)
    (att_order, _, _, ai, bi, pair_lm, pair_codes, _,
     _) = attach_pairs_numpy(att_lm, att_pose, n_lm, n_pose)
    s_codes, s_inverse = unique_inverse_numpy(
        np.concatenate([hpp_codes, pair_codes]))
    hpp_pos = s_inverse[:hpp_codes.shape[0]]
    pair_pos = s_inverse[hpp_codes.shape[0]:]
    order = np.argsort(pair_pos, kind="stable")
    vals_s = np.asarray(vals, dtype=np.int32)[att_order]
    if _sorted_attach(att_lm, att_pose, n_pose):
        att_order = None
    return (att_order, vals_s[ai][order], vals_s[bi][order],
            pair_lm[order].astype(np.int32), pair_pos[order].astype(np.int32),
            s_codes, hpp_pos)


def attach_pairs_vals(att_lm, att_pose, n_lm: int, n_pose: int, vals):
    """``attach_pairs`` of one (dp, dl) group, writing each pair's left and
    right attach values (``vals[att_order][ai]``, ``[bi]``) as it
    enumerates them, in place of ai / bi and two gathers. Returns
    (att_order, left, right, pair_lm, pair_codes)."""
    att_lm = _i64(att_lm)
    att_pose = _i64(att_pose)
    att_order, counts, total = native.attach_sort(att_lm, att_pose, n_lm)
    vals_s = np.asarray(vals, dtype=np.int32)[att_order]
    left, right, pair_lm, pair_codes = native.pair_fill_vals(
        counts, att_pose[att_order], n_pose, total, vals_s)
    return att_order, left, right, pair_lm, pair_codes


def attach_pairs_vals_numpy(att_lm, att_pose, n_lm: int, n_pose: int,
                            vals):
    (att_order, _, _, ai, bi, pair_lm, pair_codes, _,
     _) = attach_pairs_numpy(att_lm, att_pose, n_lm, n_pose)
    vals_s = np.asarray(vals, dtype=np.int32)[att_order]
    return (att_order, vals_s[ai], vals_s[bi],
            np.asarray(pair_lm, dtype=np.int32), pair_codes)


def sort_apply3(keys, n_buckets: int, p0, p1, p2):
    """Stable sort of int32 ``keys`` in [0, n_buckets), applied to three
    int32 payloads in one native pass. Returns (keys_sorted, q0, q1,
    q2)."""
    if np.asarray(keys).shape[0] < (1 << 31):
        return native.counting_sort_apply3_i32(keys, n_buckets, p0, p1, p2)
    return sort_apply3_numpy(keys, n_buckets, p0, p1, p2)


def sort_apply3_numpy(keys, n_buckets: int, p0, p1, p2):
    order = np.argsort(np.asarray(keys), kind="stable")
    return tuple(np.asarray(a, dtype=np.int32)[order]
                 for a in (keys, p0, p1, p2))


def attach_pairs(att_lm, att_pose, n_lm: int, n_pose: int):
    """Sort the Hpl attach list by (lm, pose) and enumerate every
    unordered pose pair (a <= b) of each landmark: the Schur fill-in.

    Returns (att_order, counts, seg_off, ai, bi, pair_lm, pair_codes,
    pose_a, pose_b): ``att_order`` sorts the inputs, ``ai`` / ``bi``
    index the sorted attach list, ``pair_codes = pose_b * n_pose +
    pose_a``; the pair arrays but ``pair_codes`` are int32 (the plain
    version's are int64, as the JAX package's)."""
    att_lm = _i64(att_lm)
    att_pose = _i64(att_pose)
    att_order, counts, total = native.attach_sort(att_lm, att_pose, n_lm)
    seg_off = np.concatenate([[0], np.cumsum(counts)[:-1]])
    ai, bi, pair_lm, pair_codes, pose_a, pose_b = native.pair_fill2(
        counts, att_pose[att_order], n_pose, total)
    return (att_order, counts, seg_off, ai, bi, pair_lm, pair_codes,
            pose_a, pose_b)


def attach_pairs_numpy(att_lm, att_pose, n_lm: int, n_pose: int):
    att_lm = _i64(att_lm)
    att_pose = _i64(att_pose)
    att_order = np.lexsort((att_pose, att_lm))
    att_lm_s = att_lm[att_order]
    att_pose_s = att_pose[att_order]
    counts = np.bincount(att_lm_s, minlength=n_lm)
    seg_off = np.concatenate([[0], np.cumsum(counts)[:-1]])
    npairs = counts * (counts + 1) // 2
    total_pairs = int(npairs.sum())
    pair_lm = np.repeat(np.arange(n_lm), npairs)
    pair_off = np.concatenate([[0], np.cumsum(npairs)[:-1]])
    p_local = np.arange(total_pairs) - np.repeat(pair_off, npairs)
    jj = ((np.sqrt(8.0 * p_local + 1.0) - 1.0) // 2).astype(np.int64)
    # guard float roundoff at triangular boundaries
    jj = np.where(jj * (jj + 1) // 2 > p_local, jj - 1, jj)
    jj = np.where((jj + 1) * (jj + 2) // 2 <= p_local, jj + 1, jj)
    ii = p_local - jj * (jj + 1) // 2
    ai = seg_off[pair_lm] + ii
    bi = seg_off[pair_lm] + jj
    pose_a = att_pose_s[ai]
    pose_b = att_pose_s[bi]
    pair_codes = pose_b * n_pose + pose_a
    return (att_order, counts, seg_off, ai, bi, pair_lm, pair_codes,
            pose_a, pose_b)


# each entry -> its plain NumPy version (the tests' and chip_smoke.py's
# oracle: they swap these in to build a problem's structures and plans
# with NumPy alone)
PLAIN_VERSIONS = {
    "sorted_unique": sorted_unique_numpy,
    "searchsorted": searchsorted_numpy,
    "unique_inverse": unique_inverse_numpy,
    "stable_argsort": stable_argsort_numpy,
    "schur_pair_plan": schur_pair_plan_numpy,
    "attach_pairs_vals": attach_pairs_vals_numpy,
    "sort_apply3": sort_apply3_numpy,
    "attach_pairs": attach_pairs_numpy,
}
