"""Runtime remasking of the port vs the JAX package, float64 on the CPU:
the four cases of ``tests/test_remask.py`` (levels, factor activity and
fixed flags changed after ``freeze(remaskable=True)``), each optimized
under ``jit_loop`` in both packages, chi2 to 1e-9 (of the initial chi2
where the circle's falls to rounding noise) and the points to the JAX
test's own 1e-7. Also, in the port:

- the remasked problem matches its own fresh remaskable freeze bitwise;
- every mask tensor keeps its ``data_ptr`` across a remask (a captured
  CUDA graph reads them in place), and the cached device loop is the same
  object before and after (one entry, never rebuilt);
- a problem frozen without ``remaskable`` refuses to remask.
"""

import numpy as np
import pytest
import torch

import graphite_tpu as gt
import graphite_tpu_torch as gtt
from graphite_tpu.io import synthetic as jax_synth
from graphite_tpu.io.bal import build_graph as jax_build_graph
from graphite_tpu.optimizers import LevenbergMarquardtOptions as JaxOptions
from graphite_tpu.optimizers import levenberg_marquardt as jax_lm
from graphite_tpu.preconditioners import IdentityPreconditioner as JaxIdentity
from graphite_tpu.solvers import PCGSchurSolver as JaxPCGSchur
from graphite_tpu.solvers import PCGSolver as JaxPCG
from graphite_tpu_torch.examples import circle
from graphite_tpu_torch.io import bal as torch_bal_io
from graphite_tpu_torch.io import synthetic as torch_synth
from graphite_tpu_torch.optimizers import (
    LevenbergMarquardtOptions,
    levenberg_marquardt,
)
from graphite_tpu_torch.optimizers.lm import device_loops
from graphite_tpu_torch.preconditioners import IdentityPreconditioner
from graphite_tpu_torch.solvers import PCGSchurSolver, PCGSolver

from common import build_circle_graph

torch.set_num_threads(1)

RNG = np.random.default_rng(7)
ANGLES = RNG.uniform(0, 2 * np.pi, size=5)
PTS = np.stack([4.0 * np.cos(ANGLES) + RNG.normal(0, 0.3, 5),
                4.0 * np.sin(ANGLES) + RNG.normal(0, 0.3, 5)], axis=1)
FNAME = "circle"  # the port's circle factor set (the JAX one: circle_auto)


def torch_circle(fixed_ids=(), disabled=()):
    """The port of ``common.build_circle_graph``."""
    g = gtt.Graph(precision=gtt.FP64_FP64)
    vs = g.add_vertex_set(circle.POINT2)
    for i, p in enumerate(PTS):
        vs.add(10 + i, p)
    for gid in fixed_ids:
        vs.set_fixed(gid, True)
    fs = g.add_factor_set(circle.circle_factor(auto_diff=True))
    handles = [fs.add([10 + i], obs=4.0) for i in range(len(PTS))]
    for i in disabled:
        fs.set_active(handles[i], 0x1)
    return g, vs, fs, handles


def _solvers():
    return (JaxPCG(60, 1e-20, 10.0, JaxIdentity()),
            PCGSolver(60, 1e-20, 10.0, IdentityPreconditioner()))


def _run_jax(problem, solver, iters=60):
    return jax_lm(problem, solver, options=JaxOptions(
        iterations=iters, initial_damping=1e-6, jit_loop=True))


def _run(problem, solver, iters=60):
    return levenberg_marquardt(problem, solver, options=LevenbergMarquardtOptions(
        iterations=iters, initial_damping=1e-6, jit_loop=True))


def _masks(problem):
    out = [va.active for va in problem.data.vertices.values()]
    for fa in problem.data.factors.values():
        out += [fa.factor_mask, fa.slot_mask]
    return out


def _same(a, b):
    assert [h["chi2"] for h in a.history] == [h["chi2"] for h in b.history]
    for n, p in a.params.items():
        assert torch.equal(p, b.params[n])


def _close(out, ref):
    # the circle's chi2 falls to ~1e-30: 1e-9 of the initial chi2 there
    np.testing.assert_allclose(out.chi2, ref.chi2, rtol=1e-9,
                               atol=1e-9 * ref.initial_chi2)
    np.testing.assert_allclose(out.initial_chi2, ref.initial_chi2,
                               rtol=1e-9)
    np.testing.assert_allclose(
        out.params["point2"].numpy(), np.asarray(ref.params["point2"]),
        rtol=1e-7, atol=1e-9)


def test_remaskable_matches_classic_freeze():
    sj, sp = _solvers()
    gj, *_ = build_circle_graph(PTS, fixed_ids=(14,), disabled=(2,))
    ref = _run_jax(gj.freeze(remaskable=True), sj)
    g1, *_ = torch_circle(fixed_ids=(14,), disabled=(2,))
    classic = _run(g1.freeze(device="cpu"), sp)
    g2, *_ = torch_circle(fixed_ids=(14,), disabled=(2,))
    problem = g2.freeze(device="cpu", remaskable=True)
    assert problem.dim_h == 10 and g1.freeze(device="cpu").dim_h == 6
    out = _run(problem, sp)
    _close(out, ref)
    _close(out, classic)
    pts = out.params["point2"].numpy()
    np.testing.assert_array_equal(pts[4], PTS[4])  # fixed
    np.testing.assert_array_equal(pts[2], PTS[2])  # disabled factor


def test_level_flip_reuses_the_loop():
    sj, sp = _solvers()
    g, _, fs, handles = torch_circle()
    fs.set_active(handles[2], 0x1)
    problem = g.freeze(opt_level=0, device="cpu", remaskable=True)
    masks = [(t, t.data_ptr()) for t in _masks(problem)]
    res_l0 = _run(problem, sp)
    loop = device_loops(problem)
    assert len(loop) == 1
    problem.set_opt_level(1)
    res_l1 = _run(problem, sp)
    assert device_loops(problem) == loop
    for t, ptr in masks:
        assert t.data_ptr() == ptr
    assert bool(problem.data.factors[FNAME].factor_mask.all())

    for level, res in ((0, res_l0), (1, res_l1)):
        gj, _, fsj, hj = build_circle_graph(PTS)
        fsj.set_active(hj[2], 0x1)
        _close(res, _run_jax(gj.freeze(opt_level=level, remaskable=True),
                             sj))
        gf, _, fsf, hf = torch_circle()
        fsf.set_active(hf[2], 0x1)
        _same(res, _run(gf.freeze(opt_level=level, device="cpu",
                                  remaskable=True), sp))

    problem.set_opt_level(0)
    _same(_run(problem, sp), res_l0)


def test_set_factor_active_and_fixed_post_freeze():
    sj, sp = _solvers()
    g, _, _, handles = torch_circle()
    problem = g.freeze(device="cpu", remaskable=True)
    masks = [(t, t.data_ptr()) for t in _masks(problem)]
    full = _run(problem, sp)

    problem.set_factor_active(FNAME, handles[2], 0x80)
    problem.set_vertex_fixed("point2", 14, True)
    res = _run(problem, sp)
    gj, *_ = build_circle_graph(PTS, fixed_ids=(14,), disabled=(2,))
    _close(res, _run_jax(gj.freeze(), sj))
    gf, *_ = torch_circle(fixed_ids=(14,), disabled=(2,))
    _same(res, _run(gf.freeze(device="cpu", remaskable=True), sp))
    pts = res.params["point2"].numpy()
    np.testing.assert_array_equal(pts[4], PTS[4])
    np.testing.assert_array_equal(pts[2], PTS[2])

    problem.set_factor_active(FNAME, handles[2], 0x0)
    problem.set_vertex_fixed("point2", 14, False)
    res_full = _run(problem, sp)
    _same(res_full, full)
    gj, *_ = build_circle_graph(PTS)
    _close(res_full, _run_jax(gj.freeze(remaskable=True), sj))
    for t, ptr in masks:
        assert t.data_ptr() == ptr
    assert len(device_loops(problem)) == 1


def test_remask_schur_landmark_deactivation():
    """Deactivating every factor of a landmark leaves it with a
    damping-only diagonal: the Schur solves stay well-posed, match the
    JAX package and a fresh freeze, and the landmark keeps its value."""
    dsj = jax_synth.make_bal("toy", seed=0, noise=0.5)
    dsp = torch_synth.make_bal("toy", seed=0, noise=0.5)
    sj = JaxPCGSchur(max_iter=40, tol=1e-12, rejection_ratio=1e6)
    sp = PCGSchurSolver(max_iter=40, tol=1e-12, rejection_ratio=1e6)
    oj = JaxOptions(iterations=6, initial_damping=1e-4, jit_loop=True)
    op = LevenbergMarquardtOptions(iterations=6, initial_damping=1e-4,
                                   jit_loop=True)

    g, *_ = torch_bal_io.build_graph(dsp, precision=gtt.FP64_FP64)
    problem = g.freeze(device="cpu", remaskable=True)
    masks = [(t, t.data_ptr()) for t in _masks(problem)]
    levenberg_marquardt(problem, sp, options=op)
    fname = next(iter(problem.factor_meta))
    off = np.nonzero(dsp.point_idx == 0)[0].tolist()
    for h in off:
        problem.set_factor_active(fname, h, 0x80)
    res = levenberg_marquardt(problem, sp, options=op)
    assert np.isfinite(res.chi2)
    for t, ptr in masks:
        assert t.data_ptr() == ptr

    gj, *_ = jax_build_graph(dsj, precision=gt.FP64_FP64)
    fsj = gj.factor_sets[next(iter(gj.factor_sets))]
    for h in off:
        fsj.set_active(h, 0x80)
    ref = jax_lm(gj.freeze(remaskable=True), sj, options=oj)
    np.testing.assert_allclose(res.chi2, ref.chi2, rtol=1e-9)

    gf, *_ = torch_bal_io.build_graph(dsp, precision=gtt.FP64_FP64)
    fsf = gf.factor_sets[fname]
    for h in off:
        fsf.set_active(h, 0x80)
    _same(res, levenberg_marquardt(gf.freeze(device="cpu", remaskable=True),
                                   sp, options=op))
    np.testing.assert_array_equal(res.params["bal_point"][0].numpy(),
                                  problem.params0["bal_point"][0].numpy())


def test_remask_needs_a_remaskable_freeze():
    g, *_ = torch_circle()
    problem = g.freeze(device="cpu")
    with pytest.raises(ValueError, match="remaskable"):
        problem.set_opt_level(1)
