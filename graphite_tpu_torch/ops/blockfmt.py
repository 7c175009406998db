"""Flat 2-D storage of batches of small matrices (counterpart of
``graphite_tpu/ops/blockfmt.py``).

Every batch of small blocks (Jacobians, Hessian / Schur blocks, inverted
diagonal blocks, precision matrices) is stored row-major as ``(N, r*c)``.

The block products are written as a loop over the (small) contraction
index of elementwise multiplies and adds, in ``acc_dtype``, as the JAX
package writes them. Each term is rounded on its own and the terms are
added in index order, so a CPU and a GPU run give bitwise the same
products; a batched matmul would sum in a library-chosen order (and
differently on each device).
"""

from __future__ import annotations

import torch


def _acc(a, b, acc_dtype):
    return acc_dtype or torch.promote_types(a.dtype, b.dtype)


def sum_in_order(terms):
    """Sum an iterable of same-shaped tensors, left to right."""
    out = None
    for t in terms:
        out = t if out is None else out + t
    return out


def flat_block_mm_nn(a_flat, b_flat, m: int, k: int, n: int, acc_dtype=None):
    """Per-row A @ B: (N, m*k) x (N, k*n) -> (N, m*n)."""
    acc = _acc(a_flat, b_flat, acc_dtype)
    a = a_flat.to(acc).reshape(-1, m, k)
    b = b_flat.to(acc).reshape(-1, k, n)
    return sum_in_order(a[:, :, j, None] * b[:, None, j, :]
                        for j in range(k)).reshape(-1, m * n)


def flat_block_mm_nt(a_flat, b_flat, m: int, k: int, n: int, acc_dtype=None):
    """Per-row A @ B^T: (N, m*k) x (N, n*k) -> (N, m*n)."""
    acc = _acc(a_flat, b_flat, acc_dtype)
    a = a_flat.to(acc).reshape(-1, m, k)
    b = b_flat.to(acc).reshape(-1, n, k)
    return sum_in_order(a[:, :, j, None] * b[:, None, :, j]
                        for j in range(k)).reshape(-1, m * n)


def flat_block_mm_tn(a_flat, b_flat, m: int, k: int, n: int, acc_dtype=None):
    """Per-row A^T @ B: (N, k*m) x (N, k*n) -> (N, m*n) (the J^T P J
    shape, contracting over the residual dim k)."""
    acc = _acc(a_flat, b_flat, acc_dtype)
    a = a_flat.to(acc).reshape(-1, k, m)
    b = b_flat.to(acc).reshape(-1, k, n)
    return sum_in_order(a[:, j, :, None] * b[:, j, None, :]
                        for j in range(k)).reshape(-1, m * n)


def flat_block_mv(a_flat, x, m: int, k: int, acc_dtype=None):
    """Per-row A @ x: (N, m*k) x (N, k) -> (N, m)."""
    acc = _acc(a_flat, x, acc_dtype)
    a = a_flat.to(acc).reshape(-1, m, k)
    x = x.to(acc)
    return sum_in_order(a[:, :, j] * x[:, j, None] for j in range(k))


def flat_block_mv_t(a_flat, x, m: int, k: int, acc_dtype=None):
    """Per-row A^T @ x: (N, m*k) x (N, m) -> (N, k)."""
    acc = _acc(a_flat, x, acc_dtype)
    a = a_flat.to(acc).reshape(-1, m, k)
    x = x.to(acc)
    return sum_in_order(a[:, i, :] * x[:, i, None] for i in range(m))
