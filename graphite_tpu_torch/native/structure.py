"""ctypes wrapper of ``native/structure.cpp``: the sorts, uniques and pair
enumerations of the freeze-time structure builders.

``hostops`` calls these; each one there keeps its plain NumPy version
beside it, and the two give the same arrays bit for bit
(``tests/test_torch_native_structure.py``). ``threads`` is the thread
count of the passes that split their work (default: the CPUs this
process may run on); below about 2^20 elements they run serially, so
the result never depends on it. Inputs are checked here, in Python, before
a pointer reaches C: the C side trusts every index it is given.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

from . import load_library

_I64 = ctypes.c_int64
_I64P = ctypes.POINTER(ctypes.c_int64)
_I32P = ctypes.POINTER(ctypes.c_int32)

# entry point -> (argtypes, restype); every threaded one takes the thread
# count last
_SIGNATURES = {
    "gx_sort_unique": ([_I64P, _I64, _I64P, _I64], _I64),
    "gx_searchsorted": ([_I64P, _I64, _I64P, _I64, _I64P, _I64], None),
    "gx_attach_sort": ([_I64P, _I64P, _I64, _I64, _I64P, _I64P, _I64],
                       _I64),
    "gx_pair_fill": ([_I64P, _I64, _I64P, _I64, _I64P, _I64P, _I64P, _I64P,
                      _I64], None),
    "gx_pair_fill2": ([_I64P, _I64, _I64P, _I64, _I32P, _I32P, _I32P, _I64P,
                       _I32P, _I32P, _I64], None),
    "gx_pair_fill_vals": ([_I64P, _I64, _I64P, _I64, _I32P, _I32P, _I32P,
                           _I32P, _I64P, _I64], None),
    "gx_pair_fill_sorted": ([_I64P, _I64, _I64P, _I32P, _I64, _I64P, _I64,
                             _I32P, _I32P, _I32P, _I32P, _I64P, _I64P, _I64],
                            _I64),
    "gx_sort_unique_inverse": ([_I64P, _I64, _I64P, _I64P], _I64),
    "gx_unique_inverse_bounded": ([_I64P, _I64, _I64, _I64P, _I64P], _I64),
    "gx_counting_sort_perm": ([_I64P, _I64, _I64, _I64P], None),
    "gx_counting_sort_apply3_i32": ([_I32P, _I64, _I64, _I32P, _I32P, _I32P,
                                     _I32P, _I32P, _I32P, _I32P, _I64],
                                    None),
}


def library():
    """The built library (``HostLibrary``), its entry points typed."""
    built = load_library("structure")
    if not hasattr(built.lib, "_gx_typed"):
        for name, (argtypes, restype) in _SIGNATURES.items():
            fn = getattr(built.lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        built.lib._gx_typed = True
    return built


def _lib():
    return library().lib


def default_threads() -> int:
    """The CPUs this process may run on (its affinity mask, which a
    container's CPU set narrows; ``os.cpu_count()`` where there is none)."""
    if hasattr(os, "sched_getaffinity"):
        return len(os.sched_getaffinity(0))
    return os.cpu_count() or 1


def _threads(threads: Optional[int]) -> int:
    nt = default_threads() if threads is None else int(threads)
    if nt < 1:
        raise ValueError(f"threads must be at least 1, got {nt}")
    return nt


def _i64(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.int64).reshape(-1)


def _i32(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.int32).reshape(-1)


def _p64(a: np.ndarray):
    return a.ctypes.data_as(_I64P)


def _p32(a: np.ndarray):
    return a.ctypes.data_as(_I32P)


def _check_range(a: np.ndarray, hi: int, what: str) -> None:
    """Raise unless every entry of ``a`` lies in [0, hi)."""
    if a.size and (int(a.min()) < 0 or int(a.max()) >= hi):
        raise ValueError(f"{what} out of range [0, {hi})")


def _check_nonnegative(a: np.ndarray, what: str) -> None:
    if a.size and int(a.min()) < 0:
        raise ValueError(f"{what} must be non-negative")


def _counts_total(counts: np.ndarray, n_attach: int) -> int:
    if counts.size and int(counts.min()) < 0:
        raise ValueError("negative landmark count")
    if int(counts.sum()) != n_attach:
        raise ValueError("landmark counts do not sum to the attach list")
    return int((counts * (counts + 1) // 2).sum())


def sort_unique(codes, threads: Optional[int] = None) -> np.ndarray:
    """``np.unique`` of non-negative int64 codes (radix sort + dedup)."""
    codes = _i64(codes)
    _check_nonnegative(codes, "codes")
    n = codes.shape[0]
    if n == 0:
        return codes.copy()
    out = np.empty(n, dtype=np.int64)
    ns = _lib().gx_sort_unique(_p64(codes), n, _p64(out), _threads(threads))
    return out[:ns].copy()


def searchsorted(sorted_arr, queries,
                 threads: Optional[int] = None) -> np.ndarray:
    """``np.searchsorted(sorted_arr, queries, side='left')``."""
    sorted_arr = _i64(sorted_arr)
    queries = _i64(queries)
    pos = np.empty(queries.shape[0], dtype=np.int64)
    _lib().gx_searchsorted(_p64(sorted_arr), sorted_arr.shape[0],
                           _p64(queries), queries.shape[0], _p64(pos),
                           _threads(threads))
    return pos


def attach_sort(att_lm, att_pose, n_lm: int,
                threads: Optional[int] = None):
    """``np.lexsort((att_pose, att_lm))``, the landmarks' counts and the
    pair total. Returns (order, counts, total_pairs)."""
    att_lm = _i64(att_lm)
    att_pose = _i64(att_pose)
    K = att_lm.shape[0]
    if att_pose.shape[0] != K:
        raise ValueError("att_lm and att_pose differ in length")
    _check_range(att_lm, n_lm, "landmark ids")
    order = np.empty(K, dtype=np.int64)
    counts = np.empty(n_lm, dtype=np.int64)
    total = _lib().gx_attach_sort(_p64(att_lm), _p64(att_pose), K, n_lm,
                                  _p64(order), _p64(counts),
                                  _threads(threads))
    return order, counts, int(total)


def _pair_inputs(counts, att_pose_s, n_pose: int, total_pairs: int):
    counts = _i64(counts)
    att_pose_s = _i64(att_pose_s)
    if _counts_total(counts, att_pose_s.shape[0]) != total_pairs:
        raise ValueError("total_pairs does not match the counts")
    _check_range(att_pose_s, n_pose, "pose ids")
    return counts, att_pose_s


def pair_fill(counts, att_pose_s, n_pose: int, total_pairs: int,
              threads: Optional[int] = None):
    """Every pose pair (a <= b) of every landmark, in the NumPy decode's
    order, from the (lm, pose)-sorted attach poses. Returns (ai, bi,
    pair_lm, pair_codes), int64."""
    counts, att_pose_s = _pair_inputs(counts, att_pose_s, n_pose,
                                      total_pairs)
    ai, bi, pair_lm, pair_codes = (np.empty(total_pairs, dtype=np.int64)
                                   for _ in range(4))
    _lib().gx_pair_fill(_p64(counts), counts.shape[0], _p64(att_pose_s),
                        n_pose, _p64(ai), _p64(bi), _p64(pair_lm),
                        _p64(pair_codes), _threads(threads))
    return ai, bi, pair_lm, pair_codes


def pair_fill2(counts, att_pose_s, n_pose: int, total_pairs: int,
               threads: Optional[int] = None):
    """``pair_fill`` with int32 indices plus each pair's pose ids.
    Returns (ai, bi, pair_lm, pair_codes, pose_a, pose_b)."""
    counts, att_pose_s = _pair_inputs(counts, att_pose_s, n_pose,
                                      total_pairs)
    ai, bi, pair_lm, pose_a, pose_b = (np.empty(total_pairs, dtype=np.int32)
                                       for _ in range(5))
    pair_codes = np.empty(total_pairs, dtype=np.int64)
    _lib().gx_pair_fill2(_p64(counts), counts.shape[0], _p64(att_pose_s),
                         n_pose, _p32(ai), _p32(bi), _p32(pair_lm),
                         _p64(pair_codes), _p32(pose_a), _p32(pose_b),
                         _threads(threads))
    return ai, bi, pair_lm, pair_codes, pose_a, pose_b


def pair_fill_vals(counts, att_pose_s, n_pose: int, total_pairs: int,
                   att_vals, threads: Optional[int] = None):
    """``pair_fill`` of one (dp, dl) group writing each pair's left and
    right attach values. Returns (left, right, pair_lm, pair_codes)."""
    counts, att_pose_s = _pair_inputs(counts, att_pose_s, n_pose,
                                      total_pairs)
    att_vals = _i32(att_vals)
    if att_vals.shape[0] != att_pose_s.shape[0]:
        raise ValueError("att_vals and att_pose_s differ in length")
    left, right, pair_lm = (np.empty(total_pairs, dtype=np.int32)
                            for _ in range(3))
    pair_codes = np.empty(total_pairs, dtype=np.int64)
    _lib().gx_pair_fill_vals(_p64(counts), counts.shape[0], _p64(att_pose_s),
                             n_pose, _p32(att_vals), _p32(left), _p32(right),
                             _p32(pair_lm), _p64(pair_codes),
                             _threads(threads))
    return left, right, pair_lm, pair_codes


def pair_fill_sorted(counts, att_pose_s, att_vals, n_pose: int,
                     total_pairs: int, hpp_codes,
                     threads: Optional[int] = None):
    """The fused plan: pair fill, bounded unique and destination sort.
    Returns (left, right, mid, dst, s_codes, hpp_pos), the pair arrays
    (int32) sorted by destination S block."""
    counts, att_pose_s = _pair_inputs(counts, att_pose_s, n_pose,
                                      total_pairs)
    att_vals = _i32(att_vals)
    hpp_codes = _i64(hpp_codes)
    if att_vals.shape[0] != att_pose_s.shape[0]:
        raise ValueError("att_vals and att_pose_s differ in length")
    if total_pairs >= (1 << 31):
        raise ValueError("the fused plan's int32 cursors hold < 2^31 pairs")
    _check_range(hpp_codes, n_pose * n_pose, "Hpp codes")
    left, right, mid, dst = (np.empty(total_pairs, dtype=np.int32)
                             for _ in range(4))
    s_codes = np.empty(min(total_pairs + hpp_codes.shape[0],
                           n_pose * n_pose), dtype=np.int64)
    hpp_pos = np.empty(hpp_codes.shape[0], dtype=np.int64)
    ns = _lib().gx_pair_fill_sorted(
        _p64(counts), counts.shape[0], _p64(att_pose_s), _p32(att_vals),
        n_pose, _p64(hpp_codes), hpp_codes.shape[0], _p32(left),
        _p32(right), _p32(mid), _p32(dst), _p64(s_codes), _p64(hpp_pos),
        _threads(threads))
    return left, right, mid, dst, s_codes[:ns].copy(), hpp_pos


def sort_unique_inverse(codes):
    """``np.unique(codes, return_inverse=True)`` of non-negative codes in
    one radix pass."""
    codes = _i64(codes)
    _check_nonnegative(codes, "codes")
    n = codes.shape[0]
    if n == 0:
        return codes.copy(), np.zeros(0, dtype=np.int64)
    uniq = np.empty(n, dtype=np.int64)
    inverse = np.empty(n, dtype=np.int64)
    ns = _lib().gx_sort_unique_inverse(_p64(codes), n, _p64(uniq),
                                       _p64(inverse))
    return uniq[:ns].copy(), inverse


def unique_inverse_bounded(codes, bound: int):
    """``np.unique(codes, return_inverse=True)`` of codes in [0, bound):
    a flag array and a prefix rank."""
    codes = _i64(codes)
    _check_range(codes, bound, "codes")
    n = codes.shape[0]
    if n == 0:
        return codes.copy(), np.zeros(0, dtype=np.int64)
    uniq = np.empty(min(n, bound), dtype=np.int64)
    inverse = np.empty(n, dtype=np.int64)
    ns = _lib().gx_unique_inverse_bounded(_p64(codes), n, bound, _p64(uniq),
                                          _p64(inverse))
    return uniq[:ns].copy(), inverse


def counting_sort_perm(keys, n_buckets: int) -> np.ndarray:
    """``np.argsort(keys, kind='stable')`` of keys in [0, n_buckets)."""
    keys = _i64(keys)
    _check_range(keys, n_buckets, "keys")
    perm = np.empty(keys.shape[0], dtype=np.int64)
    _lib().gx_counting_sort_perm(_p64(keys), keys.shape[0], n_buckets,
                                 _p64(perm))
    return perm


def counting_sort_apply3_i32(keys, n_buckets: int, p0, p1, p2,
                             threads: Optional[int] = None):
    """Stable counting sort of int32 ``keys`` in [0, n_buckets) applied to
    three int32 payloads. Returns (keys_sorted, q0, q1, q2)."""
    keys, p0, p1, p2 = _i32(keys), _i32(p0), _i32(p1), _i32(p2)
    n = keys.shape[0]
    if not p0.shape[0] == p1.shape[0] == p2.shape[0] == n:
        raise ValueError("keys and payloads differ in length")
    _check_range(keys, n_buckets, "keys")
    ks, q0, q1, q2 = (np.empty(n, dtype=np.int32) for _ in range(4))
    _lib().gx_counting_sort_apply3_i32(
        _p32(keys), n, n_buckets, _p32(p0), _p32(p1), _p32(p2), _p32(ks),
        _p32(q0), _p32(q1), _p32(q2), _threads(threads))
    return ks, q0, q1, q2
