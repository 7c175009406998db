"""Dense Schur matrix from block storage (counterpart of
``schur_to_dense`` in ``graphite_tpu/solvers/dense_cholesky_schur.py``;
the dense Cholesky solver itself is not ported)."""

from __future__ import annotations

import numpy as np
import torch


def _dense_positions(problem, ss):
    """Per S key: the flat dense positions of its blocks' entries, the
    off-diagonal blocks, and the positions of their transposes (host-built
    once, cached on the problem)."""
    cache = problem._cache
    if "schur_dense_positions" not in cache:
        n = ss.dim_p
        offsets = problem.block_offsets

        def dev(a):
            return torch.as_tensor(np.ascontiguousarray(a).reshape(-1),
                                   dtype=torch.int64, device=problem.device)

        out = {}
        for key in ss.s_keys:
            dr, dc = key
            rows, cols = ss.s_rows[key], ss.s_cols[key]
            rr = offsets[rows][:, None, None] + np.arange(dr)[None, :, None]
            cc = offsets[cols][:, None, None] + np.arange(dc)[None, None, :]
            off = np.nonzero(rows != cols)[0]
            out[key] = (dev(rr * n + cc), dev(off), dev(cc[off] * n + rr[off]))
        cache["schur_dense_positions"] = out
    return cache["schur_dense_positions"]


def schur_to_dense(problem, ss, sv) -> torch.Tensor:
    """Dense S (dim_p x dim_p) from the upper-triangular block values,
    mirrored: S = T + (T - T_bdiag)^T. Every entry has one source, so this
    is an indexed assignment, with no sums."""
    n = ss.dim_p
    inv_dt = problem.precision.inv_dtype
    S = torch.zeros(n * n, dtype=inv_dt, device=problem.device)
    for key, (pos, off, pos_t) in _dense_positions(problem, ss).items():
        v = sv.s_vals[key].to(inv_dt)
        S.index_copy_(0, pos, v.reshape(-1))
        if off.numel():
            S.index_copy_(0, pos_t, v.index_select(0, off).reshape(-1))
    return S.reshape(n, n)
