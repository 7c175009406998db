"""Direct solve of the Schur (pose) system, then the landmark
back-substitution (counterpart of
``graphite_tpu/solvers/sparse_direct_schur.py``). Two branches:

- ``dim_p <= on_device_dim_p``: S densified on the device
  (``schur_to_dense``) and factored with ``torch.linalg.cholesky_ex``;
- larger pose systems: S's scalar CSC values assembled on the host and
  solved with SciPy's sparse LU (``splu``) on every call.

``on_device_dim_p`` is the JAX package's TPU budget, kept so that both
packages take the same branch at every size; 0 forces the host branch.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np

from ..linearize import Linearization
from ..schur import SchurStructure
from .base import prepared
from .dense_cholesky import cholesky_solve
from .dense_cholesky_schur import (
    SchurSolverState,
    prepare_schur,
    schur_delta,
    schur_system,
    schur_to_dense,
)
from .sparse_direct import host_sparse_solve


def _schur_csc(problem, ss: SchurStructure) -> dict:
    """Scalar CSC structure of the full symmetric S, and per S key the CSC
    position of each block entry (``dst``) and of its transposed copy
    (``dst_t``; nnz for diagonal blocks). Built once per problem."""
    if "schur_csc" in problem._cache:
        return problem._cache["schur_csc"]
    offsets = problem.block_offsets
    rows_all, cols_all, spans = [], [], []  # spans: (key, transposed, k)
    for key in ss.s_keys:
        dr, dc = key
        r, c = ss.s_rows[key], ss.s_cols[key]
        rr = offsets[r][:, None, None] + np.arange(dr)[None, :, None]
        cc = offsets[c][:, None, None] + np.arange(dc)[None, None, :]
        shape = (r.shape[0], dr, dc)
        rows_all.append(np.broadcast_to(rr, shape).ravel())
        cols_all.append(np.broadcast_to(cc, shape).ravel())
        spans.append((key, False, np.arange(r.shape[0])))
        off = np.nonzero(r != c)[0]
        rows_all.append(np.broadcast_to(cc[off], (off.size, dr, dc)).ravel())
        cols_all.append(np.broadcast_to(rr[off], (off.size, dr, dc)).ravel())
        spans.append((key, True, off))
    rows_cat = np.concatenate(rows_all)
    cols_cat = np.concatenate(cols_all)
    order = np.lexsort((rows_cat, cols_cat))
    nnz = rows_cat.shape[0]
    indptr = np.zeros(ss.dim_p + 1, dtype=np.int64)
    np.cumsum(np.bincount(cols_cat, minlength=ss.dim_p), out=indptr[1:])
    pos_of = np.empty(nnz, dtype=np.int64)
    pos_of[order] = np.arange(nnz)

    dst: Dict[Tuple[int, int], np.ndarray] = {
        key: np.zeros((ss.s_sizes[key], key[0], key[1]), dtype=np.int64)
        for key in ss.s_keys}
    dst_t: Dict[Tuple[int, int], np.ndarray] = {
        key: np.full((ss.s_sizes[key], key[0], key[1]), nnz, dtype=np.int64)
        for key in ss.s_keys}
    cursor = 0
    for key, transposed, blocks in spans:
        n = blocks.size * key[0] * key[1]
        target = dst_t if transposed else dst
        target[key][blocks] = pos_of[cursor:cursor + n].reshape(
            -1, key[0], key[1])
        cursor += n
    out = dict(indptr=indptr, indices=rows_cat[order], nnz=nnz, dst=dst,
               dst_t=dst_t)
    problem._cache["schur_csc"] = out
    return out


def schur_csc_values(csc: dict, keys, *values: np.ndarray) -> np.ndarray:
    """S's (nnz,) float64 CSC values on the host from its block values
    (one host array per S key of ``keys``). Each position has one source
    entry, so this is an indexed copy."""
    vals = np.zeros(csc["nnz"])
    for key, v in zip(keys, values):
        v = v.astype(np.float64).reshape(-1)
        vals[csc["dst"][key].reshape(-1)] = v
        dst_t = csc["dst_t"][key].reshape(-1)
        real = dst_t < csc["nnz"]
        vals[dst_t[real]] = v[real]
    return vals


@dataclasses.dataclass(frozen=True)
class SparseDirectSchurSolver:
    # Pose systems at or below this size are factored on the device as a
    # dense Cholesky; 0 forces the host branch.
    on_device_dim_p: int = 20_000

    def prepare(self, problem, lin: Linearization, params=None, out=None):
        return prepared(prepare_schur(problem, lin), out)

    def solve(self, problem, lin: Linearization, state: SchurSolverState,
              damping, use_identity: bool, params=None):
        """Returns (delta_x (dim_x,), ok)."""
        ops, b_s = schur_system(problem, lin, state, damping, use_identity)
        ss = ops.ss
        if ss.dim_p <= self.on_device_dim_p:
            dx_p, ok = cholesky_solve(schur_to_dense(problem, ss, ops.sv),
                                      b_s)
        else:
            csc = _schur_csc(problem, ss)
            keys = list(ops.sv.s_vals)
            dx_p, ok = host_sparse_solve(
                csc["indptr"], csc["indices"], ss.dim_p,
                lambda *v: schur_csc_values(csc, keys, *v),
                [ops.sv.s_vals[k] for k in keys],
                b_s.to(problem.precision.graph_dtype))
        return schur_delta(ops, lin, dx_p, ok), ok
