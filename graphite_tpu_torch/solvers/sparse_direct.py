"""Direct solver on the full system H dx = b (counterpart of
``graphite_tpu/solvers/sparse_direct.py``), with three branches:

- **multifrontal**: the nested-dissection multifrontal Cholesky
  (``ops/nd_multifrontal.py``): batched dense factorizations per tree
  level, at any dim_h;
- **on device**: H densified (``dense_hessian_matrix``) and factored with
  ``torch.linalg.cholesky_ex``, up to ``on_device_limit`` columns;
- **host**: the scalar CSC values copied to the host and solved with
  SciPy's sparse LU (``splu``) on every call, as the reference's CPU
  direct solver does.

The gates are the JAX package's, so both packages take the same branch at
every size: where it asks whether its backend is not the CPU, the port
asks whether the problem lives on a CUDA device. ``on_device_limit`` is
the JAX package's budget for its 16 GB TPU, kept for that parity only.

A failed factorization (``info != 0`` on a Cholesky branch, a singular
matrix for ``splu``) or a non-finite solution gives ``ok = False`` and a
zero delta, which the LM loop rejects. ``ok`` stays on the device, except
on the host branch, which synchronises by nature (``host_sparse_solve``:
inside a captured LM iteration, its one host sync).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

from ..hessian import (
    apply_damping,
    build_hessian_structure,
    compute_hessian_values,
    csc_values,
    dense_hessian_matrix,
    ensure_csc_structure,
)
from ..linearize import Linearization
from ..ops import device_loop
from ..ops.nd_multifrontal import build_nd_plan, nd_factor, nd_ok, nd_solve
from .base import prepared
from .dense_cholesky import cholesky_solve, full_delta


@dataclasses.dataclass
class SparseDirectState:
    hvals: dict  # undamped Hessian block values


def _splu_solve(indptr: np.ndarray, indices: np.ndarray, dim: int,
                values: np.ndarray, b: np.ndarray):
    """(x, ok) with A x = b for the CSC matrix A = (values, indices,
    indptr), by SciPy's sparse LU in float64; ok is False (and x = 0)
    when A is singular or x is not finite."""
    A = sp.csc_matrix((values.astype(np.float64), indices, indptr),
                      shape=(dim, dim))
    try:
        x = spla.splu(A).solve(b.astype(np.float64))
        ok = bool(np.all(np.isfinite(x)))
    except RuntimeError:  # "Factor is exactly singular"
        x, ok = None, False
    if not ok:
        x = np.zeros(dim)
    return x, np.asarray(ok)


def host_sparse_solve(indptr: np.ndarray, indices: np.ndarray, dim: int,
                      values_fn, inputs, b: torch.Tensor):
    """``_splu_solve`` of the CSC values ``values_fn(*arrays)`` builds on
    the host from the device tensors ``inputs``, and ``b``: (x in ``b``'s
    dtype, ok) on ``b``'s device. Goes through ``device_loop.host_call``,
    so a captured LM iteration holds it as its one host sync."""
    def fn(b_h, *arrays):
        return _splu_solve(indptr, indices, dim, values_fn(*arrays), b_h)

    x, ok = device_loop.host_call(
        fn, [b, *inputs], [((dim,), torch.float64), ((), torch.bool)],
        b.device)
    return x.to(b.dtype), ok


@dataclasses.dataclass(frozen=True)
class SparseDirectSolver:
    # Above this dim_h the dense on-device factorization is skipped.
    on_device_limit: int = 24576
    # None: on device when the problem lives on a CUDA device, on the host
    # otherwise; True / False forces it (within on_device_limit).
    on_device: object = None
    # None: the multifrontal branch above on_device_limit on a CUDA
    # device; True / False forces it on / off at any size.
    multifrontal: object = None

    def _on_device(self, problem) -> bool:
        if problem.dim_h > self.on_device_limit:
            return False
        if self.on_device is not None:
            return bool(self.on_device)
        return problem.device.type == "cuda"

    def _use_nd(self, problem) -> bool:
        if self.multifrontal is not None:
            return bool(self.multifrontal)
        return (problem.dim_h > self.on_device_limit
                and problem.device.type == "cuda")

    def prepare(self, problem, lin: Linearization, params=None, out=None):
        hs = build_hessian_structure(problem)
        return prepared(SparseDirectState(
            hvals=compute_hessian_values(problem, hs, lin)), out)

    def solve(self, problem, lin: Linearization, state: SparseDirectState,
              damping, use_identity: bool, params=None):
        """Returns (delta_x (dim_x,), ok)."""
        hs = build_hessian_structure(problem)
        hv = apply_damping(problem, hs, state.hvals, lin.diag, damping,
                           use_identity)
        b = lin.b[: problem.dim_h]

        if self._use_nd(problem):
            if "nd_plan" not in problem._cache:
                problem._cache["nd_plan"] = build_nd_plan(problem, hs)
            plan = problem._cache["nd_plan"]
            dtype = problem.precision.inv_dtype
            factors = nd_factor(problem, plan, hv, dtype=dtype)
            x = nd_solve(problem, plan, factors, b, dtype=dtype)
            ok = nd_ok(factors) & torch.isfinite(x).all()
            return full_delta(problem, torch.where(ok, x, 0.0)), ok

        if self._on_device(problem):
            x, ok = cholesky_solve(dense_hessian_matrix(problem, hs, hv), b)
            return full_delta(problem, x), ok

        ensure_csc_structure(problem, hs)
        x, ok = host_sparse_solve(hs.csc_indptr, hs.csc_indices,
                                  problem.dim_h, lambda v: v,
                                  [csc_values(problem, hs, hv)], b)
        return full_delta(problem, x), ok
