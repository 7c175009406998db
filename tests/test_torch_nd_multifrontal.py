"""The port's nested-dissection multifrontal Cholesky vs the JAX package's
and vs SciPy, float64 on the CPU:

- ``build_nd_tree`` and ``build_nd_plan`` give the JAX package's tree and
  plan integer for integer (every level's assembly, extend-add and solve
  maps and its padding identity) on an SE2 pose graph, a 200-pose SE3
  sphere and BAL ``mini`` without elimination (mixed 9 / 3 block dims);
- ``nd_solve`` after ``nd_factor`` equals SciPy's ``splu`` on the
  exported CSC matrix to 1e-10 (as ``tests/test_nd_multifrontal.py``
  checks the JAX package);
- every extend-add and right-hand-side site summed through ``reduce_rows``
  (``add_sums``) equals a naive float64 scatter-add of the same
  contributions;
- an indefinite system makes a front fail and ``nd_ok`` report it.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

import graphite_tpu as gt
import graphite_tpu_torch as gtt
from graphite_tpu import hessian as jax_hessian
from graphite_tpu.io import bal as jax_bal
from graphite_tpu.io import g2o as jax_g2o
from graphite_tpu.io import synthetic as jax_synth
from graphite_tpu.ops import nd_multifrontal as jax_nd
from graphite_tpu_torch import hessian as torch_hessian
from graphite_tpu_torch.io import bal as torch_bal
from graphite_tpu_torch.io import g2o as torch_g2o
from graphite_tpu_torch.io import synthetic as torch_synth
from graphite_tpu_torch.linearize import linearize
from graphite_tpu_torch.ops import nd_multifrontal as nd

torch.set_num_threads(1)


def _pose2d():
    gj, *_ = jax_g2o.build_graph(jax_synth.make_pose_graph_2d(300, seed=1),
                                 precision=gt.FP64_FP64)
    gp, *_ = torch_g2o.build_graph(torch_synth.make_pose_graph_2d(300, seed=1),
                                   precision=gtt.FP64_FP64)
    return gj, gp


def _sphere():
    gj, *_ = jax_g2o.build_graph(jax_synth.make_sphere_se3(200, seed=0),
                                 precision=gt.FP64_FP64)
    gp, *_ = torch_g2o.build_graph(torch_synth.make_sphere_se3(200, seed=0),
                                   precision=gtt.FP64_FP64)
    return gj, gp


def _bal():
    ds = jax_synth.make_bal("mini", seed=2)
    gj, *_ = jax_bal.build_graph(ds, precision=gt.FP64_FP64,
                                 eliminate_points=False)
    gp, *_ = torch_bal.build_graph(ds, precision=gtt.FP64_FP64,
                                   eliminate_points=False)
    return gj, gp


GRAPHS = {"pose2d": _pose2d, "sphere200": _sphere, "bal_mini": _bal}


def _assert_same(a, b, where):
    if isinstance(b, dict):
        assert a.keys() == b.keys(), where
        for k in b:
            _assert_same(a[k], b[k], f"{where}.{k}")
    elif isinstance(b, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{where}[{i}]")
    elif isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and a.dtype == b.dtype, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert a == b, where


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_plan_matches_jax(graph):
    gj, gp = GRAPHS[graph]()
    pj, pp = gj.freeze(), gp.freeze(device="cpu")
    hsj = jax_hessian.build_hessian_structure(pj)
    hsp = torch_hessian.build_hessian_structure(pp)
    tj = jax_nd.build_nd_tree(pj.n_blocks, hsj.block_rows, hsj.block_cols)
    tp = nd.build_nd_tree(pp.n_blocks, hsp.block_rows, hsp.block_cols)
    assert len(tp) == len(tj)
    for a, b in zip(tp, tj):
        _assert_same([a.own, a.children, a.depth, a.bd],
                     [b.own, b.children, b.depth, b.bd], "tree")
    plj, plp = jax_nd.build_nd_plan(pj, hsj), nd.build_nd_plan(pp, hsp)
    assert (plp.dim_h, plp.n_nodes) == (plj.dim_h, plj.n_nodes)
    _assert_same(plp.levels, plj.levels, "levels")
    # the dissection recursed (BAL: the cameras separate the points)
    assert len(plp.levels) >= (2 if graph == "bal_mini" else 3)


def _system(graph, damping=1e-3, use_identity=False):
    _, gp = GRAPHS[graph]()
    problem = gp.freeze(device="cpu")
    hs = torch_hessian.build_hessian_structure(problem)
    lin = linearize(problem, problem.params0)
    hv = torch_hessian.apply_damping(
        problem, hs, torch_hessian.compute_hessian_values(problem, hs, lin),
        lin.diag, damping, use_identity)
    return problem, hs, hv, lin.b[: problem.dim_h]


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_nd_solve_matches_splu(graph):
    problem, hs, hv, b = _system(graph)
    plan = nd.build_nd_plan(problem, hs)
    factors = nd.nd_factor(problem, plan, hv, dtype=torch.float64)
    x = nd.nd_solve(problem, plan, factors, b, dtype=torch.float64)
    assert bool(nd.nd_ok(factors))
    torch_hessian.ensure_csc_structure(problem, hs)
    A = sp.csc_matrix((torch_hessian.csc_values(problem, hs, hv).numpy(),
                       hs.csc_indices, hs.csc_indptr),
                      shape=(problem.dim_h, problem.dim_h))
    ref = spla.splu(A).solve(b.numpy())
    np.testing.assert_allclose(x.numpy(), ref, rtol=1e-10,
                               atol=1e-10 * np.abs(ref).max())


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_sum_sites_match_naive_scatter(graph):
    problem, hs, _, _ = _system(graph)
    plan = nd.build_nd_plan(problem, hs)
    sites = nd.nd_sites(problem, plan)
    rng = np.random.default_rng(0)
    checked = 0
    for lv, st in zip(plan.levels, sites):
        cases = []
        if lv["ea"]:
            cases.append((st.ea, np.concatenate([e["dst"] for e in lv["ea"]]),
                          None, lv["n_l"] * lv["W"] ** 2))
        if lv["b_max"]:
            bd = lv["bd_g"].reshape(-1)
            cases.append((st.rhs, bd, bd < plan.dim_h, plan.dim_h + 1))
        for site, dst, real, size in cases:
            values = rng.standard_normal(dst.shape[0])
            target = rng.standard_normal(size)
            want = target.copy()
            keep = slice(None) if real is None else real
            np.add.at(want, dst[keep], values[keep])
            got = nd.add_sums(torch.as_tensor(target),
                              torch.as_tensor(values), site)
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-14,
                                       atol=1e-14)
            checked += 1
    assert checked >= 2


def test_indefinite_front_fails():
    problem, hs, hv, b = _system("pose2d", damping=-10.0, use_identity=True)
    plan = nd.build_nd_plan(problem, hs)
    factors = nd.nd_factor(problem, plan, hv, dtype=torch.float64)
    assert not bool(nd.nd_ok(factors))
    assert any(bool((info != 0).any()) for _, _, info in factors)
