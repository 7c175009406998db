"""Host structure discovery (NumPy): the Schur fill-in pair enumeration.

Copy of the NumPy path of ``graphite_tpu/hostops.attach_pairs`` (its
optional native library is not carried over); the JAX package's other
host primitives are thin wrappers of ``np.unique`` / ``np.argsort`` /
``np.searchsorted``, which the port calls directly.
"""

from __future__ import annotations

import numpy as np


def attach_pairs(att_lm: np.ndarray, att_pose: np.ndarray, n_lm: int,
                 n_pose: int):
    """Sort the Hpl attach list by (lm, pose) and enumerate all unordered
    pose pairs (a <= b) per landmark — the Schur fill-in discovery.

    Returns (att_order, ai, bi, pair_lm, pair_codes, pose_a, pose_b):
    ``att_order`` sorts the inputs; ``ai``/``bi`` index the sorted attach
    list; ``pair_codes = pose_b * n_pose + pose_a``.
    """
    att_lm = np.asarray(att_lm, dtype=np.int64)
    att_pose = np.asarray(att_pose, dtype=np.int64)
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
    return att_order, ai, bi, pair_lm, pair_codes, pose_a, pose_b
