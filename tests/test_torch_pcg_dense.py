"""Whole-PCG dense solve (kernel K2) of the PyTorch port.

- CPU: the port's plain ``dense_pcg`` vs the JAX package's Pallas
  ``dense_pcg`` in interpret mode, float32, to 1e-4 (the TPU kernel's
  matmuls sum in another order), on the JAX package's three cases plus
  its rejection case; the iteration count vs the port's ``run_pcg``.
- The order K2 splits its dots by over a cluster: whole 32-entry groups
  summed per CTA, then the shared tree (``tree_sum_chunked(..., 32)``),
  is bitwise ``tree_sum`` at every cluster size, on inputs with -0.0 and
  with cancellation; and ``cluster_size``.
- ``tree_matvec`` (the dense-S matvec of ``PCGSchurSolver`` above
  ``fused_pcg_limit``): each row bitwise ``tree_sum`` of its products
  (n = 297, 1,497: groups with a padded tail), within float32 rounding of
  ``A @ x``.

The kernel itself is tested on the card by ``test_torch_gpu.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphite_tpu.ops.pallas.pcg_dense as jax_pcg_dense
from graphite_tpu_torch.ops.cuda import pcg_dense
from graphite_tpu_torch.ops.pcg_loop import (
    run_pcg,
    tree_dot,
    tree_sum,
    tree_matvec,
    tree_sum_chunked,
)
from test_torch_pcg_mf import signed_zeros_and_cancellation

torch.set_num_threads(1)

TOL = 1e-4


@pytest.fixture
def interpret_mode(monkeypatch):
    monkeypatch.setattr(
        jax_pcg_dense.pl, "pallas_call",
        functools.partial(jax.experimental.pallas.pallas_call,
                          interpret=True))
    jax_pcg_dense.dense_pcg.clear_cache()
    yield
    jax_pcg_dense.dense_pcg.clear_cache()


def _random_spd(rng, n, d):
    """SPD S + its exact block-Jacobi inverse M (block size d)."""
    A = rng.standard_normal((n, n)).astype(np.float32)
    S = A @ A.T + n * np.eye(n, dtype=np.float32)
    M = np.zeros_like(S)
    for i in range(0, n, d):
        M[i:i + d, i:i + d] = np.linalg.inv(S[i:i + d, i:i + d])
    return S, M


def _indefinite(rng, n):
    A = rng.standard_normal((n, n)).astype(np.float32)
    return ((A + A.T) / 2 - 1.5 * np.eye(n, dtype=np.float32),
            np.eye(n, dtype=np.float32))


CASES = {
    "bal_like": (90, 9, 10, 1.0),        # converges in a few iterations
    "tiny_tol": (126, 9, 50, 1e-12),     # runs until a step is rejected
    "first_check": (64, 4, 10, 1e30),    # converges on the first check
    "rejection": (64, None, 25, 1e-12),  # indefinite: rejected step
}


def _system(case):
    n, d, max_iter, tol = CASES[case]
    rng = np.random.default_rng(n if d else 7)
    S, M = _random_spd(rng, n, d) if d else _indefinite(rng, n)
    b = rng.standard_normal(n).astype(np.float32)
    return S, M, b, max_iter, tol


def _rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_pallas_dense_pcg(interpret_mode, case):
    S, M, b, max_iter, tol = _system(case)
    ref = np.asarray(jax_pcg_dense.dense_pcg(
        jnp.asarray(S), jnp.asarray(M), jnp.asarray(b), max_iter=max_iter,
        tol=tol, rejection_ratio=5.0))
    x, k = pcg_dense.dense_pcg(
        torch.as_tensor(S), torch.as_tensor(M), torch.as_tensor(b),
        max_iter=max_iter, tol=tol, rejection_ratio=5.0)
    assert _rel(x.numpy(), ref) <= TOL
    _, k_ref = run_pcg(torch.as_tensor(b), lambda p: p @ torch.as_tensor(S),
                       lambda y: y @ torch.as_tensor(M), max_iter, tol, 5.0)
    assert int(k) == k_ref
    if case == "first_check":
        assert k_ref == 1


def test_zero_rhs_takes_no_step():
    S, M, _, _, _ = _system("bal_like")
    x, k = pcg_dense.dense_pcg(torch.as_tensor(S), torch.as_tensor(M),
                               torch.zeros(S.shape[0]), max_iter=10,
                               tol=1.0, rejection_ratio=5.0)
    assert int(k) == 0 and torch.all(x == 0)


def _halve32(w):
    """One level of the warp order in NumPy: zero-pad to rows of 32, then
    add pairs (i, i + 16), (i, i + 8), ... within each row."""
    w = np.concatenate([w, np.zeros(-len(w) % 32, w.dtype)]).reshape(-1, 32)
    for o in (16, 8, 4, 2, 1):
        w = w[:, :o] + w[:, o:2 * o]
    return w[:, 0]


@pytest.mark.parametrize("n", [7, 441, 1024, 16_002])
def test_tree_dot_fixed_order(n):
    """run_pcg's dot: float32 products summed 32 at a time, level by level
    (two levels up to 1,024 entries, K2's order; three at Venice's
    16,002)."""
    rng = np.random.default_rng(n)
    u, v = (rng.standard_normal(n).astype(np.float32) for _ in range(2))
    w = u * v
    for _ in range(2 if n <= 1024 else 3):
        w = _halve32(w)
    assert w.shape == (1,)
    got = tree_dot(torch.as_tensor(u), torch.as_tensor(v))
    assert got.dtype == torch.float32 and float(got) == float(w[0])


@pytest.mark.parametrize("ctas", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("N", [441, 1024, 7_497, 14_994, 23_994])
def test_group_split_sum_is_tree_sum(N, ctas):
    v = signed_zeros_and_cancellation(N, seed=1)
    for w in (v, -v.abs(), torch.full((N,), -0.0)):
        got, ref = tree_sum_chunked(w, ctas, chunk=32), tree_sum(w)
        assert got.view(torch.int32) == ref.view(torch.int32)


@pytest.mark.parametrize("n", [297, 1_497])
def test_tree_matvec_rows_are_tree_sums(n):
    rng = np.random.default_rng(n)
    A = torch.as_tensor(rng.standard_normal((n, n)).astype(np.float32))
    x = torch.as_tensor(rng.standard_normal(n).astype(np.float32))
    y = tree_matvec(A, x)
    assert y.shape == (n,) and y.dtype == torch.float32
    for i in (0, 1, n // 2, n - 1):
        assert y[i].view(torch.int32) == tree_sum(A[i] * x).view(torch.int32)
    ref = A.double() @ x.double()
    assert float((y.double() - ref).abs().max()) <= 1e-5 * float(
        (A.double().abs() @ x.double().abs()).max())


def test_cluster_size():
    """One 32-entry group per CTA up to 16 CTAs, a power of two: Ladybug's
    n = 441 (14 groups) takes 16, n = 90 takes 4."""
    assert [pcg_dense.cluster_size(n) for n in (1, 32, 33, 90, 441, 512,
                                                513, 1024)] == [
        1, 1, 2, 4, 16, 16, 16, 16]
