"""Graph containers of the port against the JAX package's semantics (the
cases of ``tests/test_graph.py`` and ``test_state_backup.py``'s
``test_get_vertex_by_global_id`` / ``test_clear``): per-vertex and
per-factor mutation with swap-with-last removal and recycled handles, the
freeze's column assignment, elimination order and errors; and, against
the JAX package in float64, ``freeze(pad_factors_to=...)`` (disabled
padding factors) and ``Graph.scale_system(False)``: the same freeze
products, linearization to 1e-12 and LM trajectory to 1e-9."""

import numpy as np
import pytest
import torch

import graphite_tpu as gt
import graphite_tpu_torch as gtt
from graphite_tpu.io import synthetic as jax_synth
from graphite_tpu.io.bal import build_graph as jax_build_graph
from graphite_tpu.linearize import linearize as jax_linearize
from graphite_tpu.optimizers import LevenbergMarquardtOptions as JaxOptions
from graphite_tpu.optimizers import levenberg_marquardt as jax_lm
from graphite_tpu.solvers import DenseCholeskySchurSolver as JaxDenseSchur
from graphite_tpu_torch.examples import circle
from graphite_tpu_torch.io import bal as torch_bal_io
from graphite_tpu_torch.io import synthetic as torch_synth
from graphite_tpu_torch.linearize import linearize
from graphite_tpu_torch.optimizers import (
    LevenbergMarquardtOptions,
    levenberg_marquardt,
)
from graphite_tpu_torch.solvers import DenseCholeskySchurSolver

torch.set_num_threads(1)

POINT2 = circle.POINT2
CIRCLE = circle.circle_factor(auto_diff=True)
BINARY = gtt.factor_type("binary2", 2, [POINT2, POINT2],
                         lambda a, b, obs: a - b - obs, obs_shape=(2,))


def make_vs():
    g = gtt.Graph(precision=gtt.FP64_FP64)
    vs = g.add_vertex_set(POINT2)
    for i in range(5):
        vs.add(100 + i, [float(i), float(-i)])
    return g, vs


def test_add_get_replace():
    g, vs = make_vs()
    np.testing.assert_array_equal(vs.get(102), [2.0, -2.0])
    vs.replace(102, [9.0, 9.0])
    np.testing.assert_array_equal(vs.get(102), [9.0, 9.0])
    with pytest.raises(KeyError):
        vs.add(102, [0.0, 0.0])
    with pytest.raises(ValueError):
        vs.add(200, [0.0, 0.0, 0.0])


@pytest.mark.parametrize("victim", [100, 102, 104])  # start / middle / end
def test_remove_swap_with_last(victim):
    g, vs = make_vs()
    vs.remove(victim)
    assert vs.count == 4
    remaining = sorted(vs.id_to_local)
    assert victim not in remaining
    for gid in remaining:
        i = gid - 100
        np.testing.assert_array_equal(vs.get(gid), [float(i), float(-i)])
    if victim != 104:  # the last vertex took the removed one's index
        assert vs.id_to_local[104] == victim - 100


def test_factor_remove_swap_and_handles():
    g, vs = make_vs()
    fs = g.add_factor_set(CIRCLE)
    handles = [fs.add([100 + i], obs=float(i)) for i in range(5)]
    fs.remove(handles[1])
    assert fs.count == 4
    assert sorted(float(o) for o in fs.obs) == [0.0, 2.0, 3.0, 4.0]
    assert fs.handles[1] == handles[4]  # swapped in from the end
    h_new = fs.add([100], obs=7.0)
    assert h_new == handles[1]  # recycled


def test_factor_batch_then_items():
    """Bulk chunks keep their handles when a per-factor edit moves them
    into the per-factor lists; exports keep storage order."""
    g, vs = make_vs()
    fs = g.add_factor_set(CIRCLE)
    h = fs.add_batch(np.arange(100, 105)[:, None], obs=np.arange(5.0))
    np.testing.assert_array_equal(h, np.arange(5))
    fs.set_level(int(h[3]), 2, enabled=False)
    assert fs.level[3] == 0x82
    fs.remove(int(h[0]))
    np.testing.assert_array_equal(fs.ids_array()[:, 0],
                                  [104, 101, 102, 103])
    np.testing.assert_array_equal(fs.obs_array(), [4.0, 1.0, 2.0, 3.0])
    np.testing.assert_array_equal(fs.handle_array(), [4, 1, 2, 3])
    np.testing.assert_array_equal(fs.level_array(), [0, 0, 0, 0x82])
    assert fs.add([100], obs=9.0) == 0


def test_freeze_column_assignment_sorted_by_global_id():
    g, vs = make_vs()
    fs = g.add_factor_set(CIRCLE)
    for i in range(5):
        fs.add([100 + i], obs=1.0)
    problem = g.freeze(device="cpu")
    assert problem.dim_h == 10
    np.testing.assert_array_equal(problem.host.vertex_col_offset["point2"],
                                  [0, 2, 4, 6, 8])
    assert problem.get_num_block_columns() == 5
    assert problem.get_variable_dimension(0) == 2
    assert problem.get_hessian_dimension() == 10
    assert problem.residual_sizes() == {"circle": 5}


def test_freeze_eliminated_sorted_last():
    g = gtt.Graph(precision=gtt.FP64_FP64)
    a = g.add_vertex_set(gtt.vertex_type("a", 2))
    bset = g.add_vertex_set(gtt.vertex_type("bv", 3))
    a.add(0, [0.0, 0.0])
    a.add(2, [0.0, 0.0])
    bset.add(1, [0.0, 0.0, 0.0])
    bset.add(3, [0.0, 0.0, 0.0])
    bset.set_eliminate(True)
    ft = gtt.factor_type(
        "ab", 2, [gtt.vertex_type("a", 2), gtt.vertex_type("bv", 3)],
        lambda x, y: x - y[..., :2])
    fs = g.add_factor_set(ft)
    for ids in ([0, 1], [2, 3], [0, 3]):
        fs.add(ids)
    problem = g.freeze(device="cpu")
    assert problem.dim_h == 10
    np.testing.assert_array_equal(problem.host.vertex_col_offset["a"], [0, 2])
    np.testing.assert_array_equal(problem.host.vertex_col_offset["bv"],
                                  [4, 7])
    assert problem.elimination_block == 2
    assert problem.elimination_col == 4
    assert problem.get_elimination_block_column() == 2


def test_unreferenced_vertex_inactive():
    g, vs = make_vs()
    fs = g.add_factor_set(CIRCLE)
    for i in range(4):  # vertex 104 unreferenced
        fs.add([100 + i], obs=1.0)
    problem = g.freeze(device="cpu")
    assert problem.dim_h == 8
    assert not problem.host.vertex_active["point2"][4]
    assert problem.host.vertex_col_offset["point2"][4] == problem.dim_h


@pytest.mark.parametrize("bad", ["unknown_id", "arity"])
def test_bad_factor_raises(bad):
    g, vs = make_vs()
    if bad == "unknown_id":
        g.add_factor_set(CIRCLE).add([999], obs=1.0)
        with pytest.raises(KeyError):
            g.freeze(device="cpu")
    else:
        with pytest.raises(ValueError):
            g.add_factor_set(BINARY).add([100], obs=[0.0, 0.0])


def test_empty_sets_warn(capsys):
    g, vs = make_vs()
    fs = g.add_factor_set(CIRCLE)
    for i in range(5):
        fs.add([100 + i], obs=1.0)
    g.add_factor_set(BINARY)  # never populated
    problem = g.freeze(device="cpu")
    assert "has no entries" in capsys.readouterr().err
    assert "binary2" not in problem.factor_meta
    assert float(linearize(problem, problem.params0).chi2) >= 0.0

    g = gtt.Graph(precision=gtt.FP64_FP64)
    g.add_vertex_set(POINT2)
    g.add_factor_set(CIRCLE)
    assert g.freeze(device="cpu").dim_h == 0
    assert "has no entries" in capsys.readouterr().err


def test_get_vertex_by_global_id():
    g = gtt.Graph(precision=gtt.FP64_FP64)
    vs = g.add_vertex_set(POINT2)
    vs.add(42, [1.0, 2.0])
    vs.add(7, [3.0, 4.0])
    fs = g.add_factor_set(CIRCLE)
    fs.add([42], obs=1.0)
    fs.add([7], obs=1.0)
    problem = g.freeze(device="cpu")
    np.testing.assert_array_equal(
        problem.get_vertex(problem.params0, "point2", 7).numpy(), [3.0, 4.0])
    assert problem.host_local_index("point2", 42) == 0


def test_clear():
    g = gtt.Graph(precision=gtt.FP64_FP64)
    vs = g.add_vertex_set(POINT2)
    vs.add(0, [1.0, 2.0])
    fs = g.add_factor_set(CIRCLE)
    fs.add([0], obs=1.0)
    fs.add_batch([[0]], obs=[2.0])
    vs.clear()
    fs.clear()
    assert vs.count == 0 and fs.count == 0
    vs.add(0, [5.0, 6.0])
    assert fs.add([0], obs=2.0) == 0


def _bal_pair():
    """BAL "mini", seed 2: the problem of ``test_torch_direct_solvers``,
    whose dense Schur trajectories agree to 1e-9 over 5 iterations."""
    return (jax_synth.make_bal("mini", seed=2),
            torch_synth.make_bal("mini", seed=2))


def _close(a, b, tol=1e-12):
    a, b = np.asarray(a), np.asarray(b)
    scale = max(1.0, float(np.abs(b).max(initial=0.0)))
    np.testing.assert_allclose(a, b, rtol=tol, atol=tol * scale)


@pytest.mark.parametrize("case", ["pad_factors_to", "scale_system_off"])
def test_freeze_options_match_jax(case):
    dsj, dsp = _bal_pair()
    gj, *_ = jax_build_graph(dsj, precision=gt.FP64_FP64)
    gp, *_ = torch_bal_io.build_graph(dsp, precision=gtt.FP64_FP64)
    kw = {}
    if case == "pad_factors_to":
        kw = dict(pad_factors_to=64)
    else:
        gj.scale_system(False)
        gp.scale_system(False)
        assert not gp.scale_jacobians
    pj, pp = gj.freeze(**kw), gp.freeze(device="cpu", **kw)
    for name, fm in pj.factor_meta.items():
        assert pp.factor_meta[name].count == fm.count
        if case == "pad_factors_to":
            assert fm.count % 64 == 0 and fm.count > 150
        np.testing.assert_array_equal(pp.host.factor_levels[name],
                                      pj.host.factor_levels[name])
        np.testing.assert_array_equal(
            pp.data.factors[name].factor_mask.numpy(),
            np.asarray(pj.data.factors[name].factor_mask))
        np.testing.assert_array_equal(pp.host.slot_mask[name],
                                      pj.host.slot_mask[name])
    lj = jax_linearize(pj, pj.params0)
    lp = linearize(pp, pp.params0)
    if case == "scale_system_off":
        assert bool((lp.scales == 1).all())
    for field in ("scales", "diag", "b"):
        _close(getattr(lp, field).numpy(), getattr(lj, field))
    _close(float(lp.chi2), float(lj.chi2))

    ref = jax_lm(pj, JaxDenseSchur(), options=JaxOptions(iterations=5))
    out = levenberg_marquardt(pp, DenseCholeskySchurSolver(),
                              options=LevenbergMarquardtOptions(iterations=5))
    assert ([h["accepted"] for h in out.history]
            == [h["accepted"] for h in ref.history])
    np.testing.assert_allclose([h["chi2"] for h in out.history],
                               [h["chi2"] for h in ref.history], rtol=1e-9)
