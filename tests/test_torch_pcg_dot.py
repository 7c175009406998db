"""The PCG's inner products (kernel K9's wrapper ``ops/cuda/dot.tree_dot``,
``ops/pcg_loop.tree_dot``) on the CPU, where the wrapper takes its plain
version ``tree_dot_plain``.

- ``tree_dot`` against the JAX package's ``jnp.dot`` (what its CG loop
  computes, ``graphite_tpu/ops/pcg_loop.py``) on seeded inputs, float32
  and float64, at n from 1 (one group, two levels) to 40,000 (four
  levels: K9's multi-CTA form). The two sum in different orders, so the
  tolerance is the summation bound: |port - JAX| <= 1e-5 sum|u_i v_i| in
  float32 and 1e-13 sum|u_i v_i| in float64.
- ``tree_sum_chunked`` (whole 1,024-entry chunks per CTA, then the rest
  of the tree over the chunk sums: K9's multi-CTA split) bitwise
  ``tree_sum`` at the same n for 1, 7 and 264 CTAs, on inputs with -0.0,
  all -0.0 and cancellation.
- ``run_pcg`` and ``run_pcg_fixed`` with ``dot=tree_dot_plain`` bitwise
  their default (``tree_dot``) on the CPU.
- K2's and K6's plain versions (``dense_pcg_plain``,
  ``solve_pcg_mf_plain``), which ``chip_smoke.py`` runs on the card as
  their kernels' oracles, never call the K9 wrapper: with it patched to
  raise they still run, while ``run_pcg``'s default raises.
- The wrapper raises on a tensor of another device (no fallback).

K9 itself is tested on the card by ``test_torch_gpu.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphite_tpu_torch as gtt
from graphite_tpu_torch.io import g2o, synthetic
from graphite_tpu_torch.linearize import linearize
from graphite_tpu_torch.ops import pcg_loop
from graphite_tpu_torch.ops.cuda import dot as k9
from graphite_tpu_torch.ops.cuda import pcg_dense, pcg_mf
from graphite_tpu_torch.ops.pcg_loop import (
    run_pcg,
    run_pcg_fixed,
    tree_dot,
    tree_dot_plain,
    tree_sum,
    tree_sum_chunked,
)
from test_torch_pcg_mf import signed_zeros_and_cancellation

torch.set_num_threads(1)

SIZES = [1, 31, 32, 33, 1024, 1025, 16_002, 40_000]
# |port - JAX| <= REL[dtype] * sum |u_i v_i|: the products' summation
# bound in either order (log2(40,000) ~ 16 roundings of each partial sum)
REL = {"float32": 1e-5, "float64": 1e-13}


def _operands(n, dtype, seed=0):
    rng = np.random.default_rng(seed + n)
    u = rng.standard_normal(n) * 10.0 ** rng.integers(-2, 3, n)
    v = rng.standard_normal(n)
    return u.astype(dtype), v.astype(dtype)


@pytest.mark.parametrize("dtype", sorted(REL))
@pytest.mark.parametrize("n", SIZES)
def test_tree_dot_matches_jax_dot(n, dtype):
    u, v = _operands(n, dtype)
    got = tree_dot(torch.as_tensor(u), torch.as_tensor(v))
    ref = float(jnp.dot(jnp.asarray(u), jnp.asarray(v)))
    assert got.shape == () and got.dtype == getattr(torch, dtype)
    scale = float(np.abs(u.astype(np.float64) * v).sum())
    assert abs(float(got) - ref) <= REL[dtype] * scale
    # the wrapper's CPU path is the plain version, bit for bit
    assert torch.equal(got, tree_dot_plain(torch.as_tensor(u),
                                           torch.as_tensor(v)))


@pytest.mark.parametrize("ctas", [1, 7, 264])
@pytest.mark.parametrize("n", SIZES)
def test_chunked_tree_sum_is_tree_sum(n, ctas):
    v = signed_zeros_and_cancellation(n, seed=2)
    for w in (v, -v.abs(), torch.full((n,), -0.0)):
        got, ref = tree_sum_chunked(w, ctas), tree_sum(w)
        assert got.view(torch.int32) == ref.view(torch.int32)


def _spd(n, seed, dtype):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n, n))
    A = A @ A.T + 0.05 * n * np.eye(n)
    return (torch.tensor(A, dtype=dtype),
            torch.tensor(rng.normal(size=n), dtype=dtype),
            torch.tensor(1.0 / np.diag(A), dtype=dtype))


@pytest.mark.parametrize("solve", [run_pcg, run_pcg_fixed])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_explicit_plain_dot_is_the_default(solve, dtype):
    A, b, dinv = _spd(50, 4, dtype)
    args = (b, lambda p: A @ p, lambda y: dinv * y, 30, 1e-30, 5.0)
    x, k = solve(*args)
    x_plain, k_plain = solve(*args, dot=tree_dot_plain)
    assert int(k) == int(k_plain) > 0
    assert torch.equal(x, x_plain)


def _k6_plain_args():
    g, *_ = g2o.build_graph(synthetic.make_sphere_se3(40, seed=1),
                            precision=gtt.FP32_FP32)
    problem = g.freeze(device="cpu")
    lin = linearize(problem, problem.params0)
    site = pcg_mf.plan_pcg_mf(problem, lin)
    damp = lin.diag.clamp(1e-6, 1e32) * 1e-3
    return (site, pcg_mf.fold_jacobians(problem, lin, site),
            problem.rows_view(lin.b, site.vt_name).reshape(-1),
            problem.rows_view(damp, site.vt_name).reshape(-1), None)


def test_k2_k6_plain_versions_never_call_k9(monkeypatch):
    A, b, dinv = _spd(64, 5, torch.float32)
    M = torch.diag(dinv)
    k6_args = _k6_plain_args()
    kw = dict(max_iter=10, tol=1e-30, rejection_ratio=5.0)
    x2, k2 = pcg_dense.dense_pcg_plain(A, M, b, **kw)
    x6, k6 = pcg_mf.solve_pcg_mf_plain(*k6_args, **kw)

    def k9_called(u, v):
        raise AssertionError("a plain version called the K9 wrapper")

    monkeypatch.setattr(k9, "tree_dot", k9_called)
    monkeypatch.setattr(pcg_loop, "tree_dot", k9_called)
    with pytest.raises(AssertionError, match="K9 wrapper"):
        run_pcg(b, lambda p: A @ p, lambda y: dinv * y, **kw)
    y2, j2 = pcg_dense.dense_pcg_plain(A, M, b, **kw)
    y6, j6 = pcg_mf.solve_pcg_mf_plain(*k6_args, **kw)
    assert int(j2) == int(k2) > 0 and int(j6) == int(k6) > 0
    assert torch.equal(y2, x2) and torch.equal(y6, x6)


def test_wrapper_raises_off_the_cpu():
    u = torch.empty(10, device="meta")
    with pytest.raises(NotImplementedError, match="no kernel for device"):
        k9.tree_dot(u, u)
