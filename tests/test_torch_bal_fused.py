"""Kernel K7's gate and its plain branch (``ops/cuda/bal.py``) on the CPU.

K7 computes, per BAL reprojection factor, what ``linearize``,
``compute_chi2`` and ``compute_hessian_values`` compute per factor on the
generic branch. On the CPU each of its entries runs its plain version,
which follows the generic code op by op. Here:

- On small BAL problems (6 cameras, 60 points, 300 observations) with one
  camera fixed (its slots masked), ten factors disabled, and cameras
  rotated into each Rodrigues branch (theta^2 = 0, below 1e-24, in the
  Taylor range below 0.01, and above it), under FP32_FP32, FP32_BF16,
  FP32_FP16 and the float64 graphs' FP64_FP64, FP64_FP32 and FP64_BF16,
  and the default, Huber and Cauchy losses: the K7 branch is bitwise the
  generic branch (the gate forced shut), signed zeros included, for
  every ``Linearization`` field, every Hessian group and
  ``compute_chi2``, and it was taken (each entry called once, the
  Hessian sum once per site).
- The K7 branch against the JAX package's ``linearize`` and
  ``compute_hessian_values`` at the tolerance ladder of
  ``tests/test_torch_precision.py``: residuals, b, chi2, the scales and
  the diagonal within 1e-6 (float32 graphs) or 1e-12 (float64) of the
  largest entry; the stored Jacobians within one storage ulp beyond
  that; the Hessian values from the JAX package's stored Jacobians and
  dL within 1e-6, or 1e-12 where they are float64 (``inv_dtype``); dL
  within 1e-5 in float32 (``DL_TOL`` says why) and 1e-12 in float64.
- The gate sends ``REPROJECTION_AUTO`` (in a float32 and in a float64
  graph), sets with a precision matrix, dynamic sets and a loss of
  another type to the generic branch: no K7 entry is called.
"""

import dataclasses

import numpy as np
import pytest
import torch

import graphite_tpu as gt
import graphite_tpu_torch as gtt
from graphite_tpu import hessian as jax_hessian
from graphite_tpu.io import synthetic as jax_synth
from graphite_tpu.io.bal import build_graph as jax_build_graph
from graphite_tpu.linearize import linearize as jax_linearize
from graphite_tpu_torch import hessian as torch_hessian
from graphite_tpu_torch.io import bal as torch_bal_io
from graphite_tpu_torch.linearize import compute_chi2, linearize
from graphite_tpu_torch.models import bal as bal_model
from graphite_tpu_torch.ops.cuda import bal as k7
from graphite_tpu_torch.ops.cuda import segsum

torch.set_num_threads(1)

SIZE = (6, 60, 300)
POLICIES = ["FP32_FP32", "FP32_BF16", "FP32_FP16", "FP64_FP64", "FP64_FP32",
            "FP64_BF16"]
# loss name -> (JAX loss, port loss, parameter)
LOSSES = {
    "default": (None, None, None),
    "huber": (gt.HuberLoss(), gtt.HuberLoss(), 2.0),
    "cauchy": (gt.CauchyLoss(), gtt.CauchyLoss(), 1.5),
}
# camera rotations (angle-axis) forcing each Rodrigues branch: theta^2 = 0
# and below 1e-24 (both tiny), in the Jacobian's Taylor range (< 0.01),
# and two above it (exact); camera 5 keeps its own and is fixed
ROTATIONS = [(0.0, 0.0, 0.0), (1e-13, -2e-13, 5e-14), (0.02, -0.03, 0.01),
             (0.2, -0.15, 0.1), (0.5, 0.3, -0.4)]
FIXED_CAMERA = 5
DISABLED = 10  # the first factors, disabled


def _dataset():
    ds = jax_synth.make_bal(SIZE, seed=3, noise=0.5)
    ds.cameras[:len(ROTATIONS), :3] = ROTATIONS
    return ds


def _port_problem(policy, loss):
    _, tloss, param = LOSSES[loss]
    g, cams, _, fs = torch_bal_io.build_graph(
        _dataset(), precision=getattr(gtt, policy), loss=tloss,
        loss_param=param)
    cams.set_fixed(FIXED_CAMERA)
    for h in range(DISABLED):
        fs.set_active(h, 0x80)
    return g.freeze(device="cpu")


def _bits(t):
    ints = {8: torch.int64, 4: torch.int32, 2: torch.int16}
    return t.contiguous().view(ints[t.element_size()])


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(_bits(a), _bits(b))


def _counted(monkeypatch):
    """Count the calls of each K7 entry."""
    calls = {}
    for entry in ("bal_residual", "bal_linearize", "bal_scale_b",
                  "bal_hessian_sum"):
        fn = getattr(k7, entry)

        def wrapped(*args, _fn=fn, _entry=entry):
            calls[_entry] = calls.get(_entry, 0) + 1
            return _fn(*args)

        monkeypatch.setattr(k7, entry, wrapped)
    return calls


def _run(problem):
    params = problem.params0
    moved = {k: v * (1 + 1e-3) for k, v in params.items()}
    lin = linearize(problem, params)
    hs = torch_hessian.build_hessian_structure(problem)
    hv = torch_hessian.compute_hessian_values(problem, hs, lin)
    return lin, hv, compute_chi2(problem, moved)


def test_cameras_cover_every_rodrigues_branch():
    th2 = (np.asarray(ROTATIONS) ** 2).sum(axis=1)
    assert th2[0] == 0 and 0 < th2[1] < 1e-24
    assert 1e-24 < th2[2] < 0.01 and th2[3] > 0.01 and th2[4] > 0.01


@pytest.mark.parametrize("loss", sorted(LOSSES))
@pytest.mark.parametrize("policy", POLICIES)
def test_plain_branch_bitwise_generic(policy, loss, monkeypatch):
    problem = _port_problem(policy, loss)
    assert k7.gate(problem, "bal_reprojection") is not None
    with monkeypatch.context() as m:
        calls = _counted(m)
        lin, hv, chi2 = _run(problem)
    # one Hessian sum per site: the slot pairs (0, 0), (0, 1) and (1, 1)
    assert calls == {"bal_residual": 1, "bal_linearize": 1,
                     "bal_scale_b": 1, "bal_hessian_sum": 3}
    with monkeypatch.context() as m:
        m.setattr(k7, "gate", lambda problem, name: None)
        calls = _counted(m)
        ref_lin, ref_hv, ref_chi2 = _run(problem)
    assert calls == {}

    for field in ("residuals", "chi2_vec", "chi2_deriv"):
        for name, t in getattr(ref_lin, field).items():
            _same(getattr(lin, field)[name], t)
    for name, js in ref_lin.jacobians.items():
        assert len(lin.jacobians[name]) == len(js)
        for a, b in zip(lin.jacobians[name], js):
            _same(a, b)
    for field in ("scales", "diag", "b", "chi2"):
        _same(getattr(lin, field), getattr(ref_lin, field))
    assert hv.keys() == ref_hv.keys()
    for key in ref_hv:
        _same(hv[key], ref_hv[key])
    _same(chi2, ref_chi2)

    # the fixed camera's masked slots carry -0.0, the disabled factors a
    # zero chi2
    jc = lin.jacobians["bal_reprojection"][0].float()
    assert bool(((jc == 0) & torch.signbit(jc)).any())
    assert bool((lin.chi2_vec["bal_reprojection"][:DISABLED] == 0).all())


def _np(a):
    return (a.double().numpy() if torch.is_tensor(a)
            else np.asarray(a, dtype=np.float64))


def _close(out, ref, tol):
    out, ref = _np(out), _np(ref)
    assert out.shape == ref.shape
    assert np.abs(out - ref).max() <= tol * max(np.abs(ref).max(), 1e-300)


def _storage_close(out, ref, dtype, tol):
    """Within one ulp of the storage dtype beyond ``tol`` of the largest
    entry (as ``tests/test_torch_precision.py``)."""
    out, ref = _np(out), _np(ref)
    finfo = torch.finfo(dtype)
    e = np.floor(np.log2(np.maximum(np.maximum(np.abs(out), np.abs(ref)),
                                    finfo.tiny)))
    ulp = np.exp2(e - {torch.float64: 52, torch.float32: 23,
                       torch.bfloat16: 7, torch.float16: 10}[dtype])
    assert np.all(np.abs(out - ref) <= tol * np.abs(ref).max() + ulp)


# relative to each array's largest entry, by the graph dtype
TOL = {torch.float32: 1e-6, torch.float64: 1e-12}
# dL is a function of the squared error x = |r|^2 of each factor, so it
# moves with the relative error of one residual, not of the largest: one
# float32 residual of camera 4 (exact branch) is 1.8e-6 apart between the
# packages (float32 trig there, float64 trig rounded here), and Cauchy's
# dL = 1 / (1 + x / c^2) carries twice that relative change of x. In
# float64 both packages take float64 trig: 1e-12, as every other array
DL_TOL = {torch.float32: 1e-5, torch.float64: 1e-12}


@pytest.mark.parametrize("policy,loss", [
    ("FP32_FP32", "default"), ("FP32_FP32", "huber"),
    ("FP32_FP32", "cauchy"), ("FP32_BF16", "huber"),
    ("FP32_FP16", "cauchy"), ("FP64_FP64", "default"),
    ("FP64_FP64", "huber"), ("FP64_FP64", "cauchy"),
    ("FP64_FP32", "huber"), ("FP64_BF16", "cauchy")])
def test_fused_branch_matches_jax(policy, loss):
    jloss, _, param = LOSSES[loss]
    gj, camsj, _, fsj = jax_build_graph(
        _dataset(), precision=getattr(gt, policy), loss=jloss,
        loss_param=param)
    camsj.set_fixed(FIXED_CAMERA)
    for h in range(DISABLED):
        fsj.set_active(h, 0x80)
    pj = gj.freeze()
    pp = _port_problem(policy, loss)
    prec = getattr(gtt, policy)
    tol = TOL[prec.graph_dtype]
    assert k7.gate(pp, "bal_reprojection") is not None

    lj = jax_linearize(pj, pj.params0)
    lp = linearize(pp, pp.params0)
    for f in lj.residuals:
        assert lp.residuals[f].dtype == prec.graph_dtype
        _close(lp.residuals[f], lj.residuals[f], tol)
        _close(lp.chi2_deriv[f], lj.chi2_deriv[f], DL_TOL[prec.graph_dtype])
    for field in ("b", "chi2", "scales", "diag"):
        _close(getattr(lp, field), getattr(lj, field), tol)
    for f, js in lj.jacobians.items():
        for jt, jj in zip(lp.jacobians[f], js):
            assert jt.dtype == prec.solver_dtype
            _storage_close(jt, jj, prec.solver_dtype, tol)
    _close(compute_chi2(pp, pp.params0), lj.chi2, tol)

    # the Hessian values from the JAX package's stored Jacobians and dL
    lin = dataclasses.replace(
        lp,
        jacobians={f: tuple(torch.as_tensor(np.asarray(j).astype(np.float64)
                                             ).to(prec.solver_dtype)
                            for j in js)
                   for f, js in lj.jacobians.items()},
        chi2_deriv={f: torch.as_tensor(np.array(v))
                    for f, v in lj.chi2_deriv.items()})
    hsj = jax_hessian.build_hessian_structure(pj)
    hsp = torch_hessian.build_hessian_structure(pp)
    hj = jax_hessian.compute_hessian_values(pj, hsj, lj)
    hp = torch_hessian.compute_hessian_values(pp, hsp, lin)
    htol = 1e-12 if prec.inv_dtype == torch.float64 else 1e-6
    assert hp.keys() == hj.keys()
    for key in hj:
        assert hp[key].dtype == prec.inv_dtype
        _close(hp[key], hj[key], htol)


class _OtherLoss(gtt.HuberLoss):
    """A loss of another type: K7 has no case for it."""


def _generic_problem(case):
    ds = _dataset()
    if case == "fp64_auto":
        g, *_ = torch_bal_io.build_graph(ds, precision=gtt.FP64_FP64,
                                         factor=bal_model.REPROJECTION_AUTO)
    elif case == "auto":
        g, *_ = torch_bal_io.build_graph(ds, factor=bal_model.REPROJECTION_AUTO)
    elif case == "other_loss":
        g, *_ = torch_bal_io.build_graph(ds, loss=_OtherLoss(),
                                         loss_param=2.0)
    elif case == "dynamic":
        g, _, _, fs = torch_bal_io.build_graph(ds)
        fs.set_jacobian_storage(False)
    else:  # a precision matrix per factor
        g = gtt.Graph(precision=gtt.FP32_FP32)
        cams = g.add_vertex_set(bal_model.CAMERA)
        pts = g.add_vertex_set(bal_model.POINT)
        cams.add_batch(np.arange(ds.num_cameras), ds.cameras)
        pts.add_batch(ds.num_cameras + np.arange(ds.num_points), ds.points)
        pts.set_eliminate(True)
        fs = g.add_factor_set(bal_model.REPROJECTION)
        n = ds.num_observations
        info = np.tile(np.array([[2.0, 0.5], [0.5, 1.0]]), (n, 1, 1))
        fs.add_batch(np.stack([ds.cam_idx, ds.num_cameras + ds.point_idx],
                              axis=1), obs=ds.observations, precision=info)
    return g.freeze(device="cpu")


@pytest.mark.parametrize("case", ["fp64_auto", "auto", "precision_matrix",
                                  "dynamic", "other_loss"])
def test_gate_sends_other_sets_to_the_generic_branch(case, monkeypatch):
    problem = _generic_problem(case)
    (name,) = problem.factor_meta
    assert k7.gate(problem, name) is None

    def refuse(*args):
        raise AssertionError("a K7 entry was called")

    for entry in ("bal_residual", "bal_linearize", "bal_scale_b",
                  "bal_hessian_sum"):
        monkeypatch.setattr(k7, entry, refuse)
    lin = linearize(problem, problem.params0)
    compute_chi2(problem, problem.params0)
    if problem.factor_meta[name].store_jacobians:
        hs = torch_hessian.build_hessian_structure(problem)
        torch_hessian.compute_hessian_values(problem, hs, lin)
    assert bool(torch.isfinite(lin.b).all())


def test_entries_take_the_plain_version_on_the_cpu(monkeypatch):
    """On CPU tensors each wrapper is its plain version, and counts no
    launch."""
    problem = _port_problem("FP32_BF16", "huber")
    fa = problem.data.factors["bal_reprojection"]
    p = problem.params0
    loss = k7.gate(problem, "bal_reprojection")
    args = (p["bal_camera"], p["bal_point"], *fa.ids, fa.obs)
    stats = (k7.RESIDUAL_STATS, k7.LINEARIZE_STATS, k7.SCALE_B_STATS,
             k7.HESSIAN_SUM_STATS)
    before = [s.launches for s in stats]
    lin = k7.bal_linearize(*args, fa.slot_mask, fa.factor_mask,
                           fa.loss_params, loss)
    for a, b in zip(lin, k7.bal_linearize_plain(
            *args, fa.slot_mask, fa.factor_mask, fa.loss_params, loss)):
        _same(a, b)
    _same(k7.bal_residual(*args, fa.factor_mask, fa.loss_params, loss),
          k7.bal_residual_plain(*args, fa.factor_mask, fa.loss_params, loss))
    r, jc, jp, _, dL, _, _ = lin
    rng = np.random.default_rng(0)
    sc = torch.as_tensor(rng.random((problem.seg_rows["bal_camera"] + 1, 9)),
                         dtype=torch.float32)
    sp = torch.as_tensor(rng.random((problem.seg_rows["bal_point"] + 1, 3)),
                         dtype=torch.float32)
    scaled = k7.bal_scale_b(jc, jp, r, dL, sc, sp, *fa.rows, torch.bfloat16)
    for a, b in zip(scaled, k7.bal_scale_b_plain(jc, jp, r, dL, sc, sp,
                                                 *fa.rows, torch.bfloat16)):
        _same(a, b)
    assert scaled[0].dtype == torch.bfloat16
    hs = torch_hessian.build_hessian_structure(problem)
    for cm in hs.contribs:
        key = cm.direct_group
        plan = segsum.plan_segments(cm.direct_idx, hs.group_sizes[key] + 1,
                                    "cpu", width=key[0] * key[1])
        outs = [torch.full((plan.num_segments, key[0] * key[1]), 0.5)
                for _ in range(2)]
        k7.bal_hessian_sum(*scaled[:2], dL, plan, cm.s, cm.t, False,
                           outs[0], True)
        k7.bal_hessian_sum_plain(*scaled[:2], dL, plan, cm.s, cm.t, False,
                                 outs[1], True)
        _same(*outs)
    assert [s.launches for s in stats] == before


def test_stage_profile_times_k7_beside_k1():
    """``stage_profile`` times K7's entries and the K1 row reductions
    beside them (here their plain versions, on the CPU); the Hessian
    values' sums are K7's own, one call per site."""
    from graphite_tpu_torch import stage_profile

    out = stage_profile.profile_lm((12, 120, 700), 2, 0, "cpu")
    for stage in ("k7.bal_linearize (in linearize)",
                  "k7.bal_scale_b (in linearize)",
                  "k7.bal_residual (in compute_chi2)",
                  "k7.bal_hessian_sum (in hessian_values)",
                  "k1 factor rows (in linearize)"):
        assert out["stages"][stage]["calls"] >= 2, stage
    assert (out["stages"]["k7.bal_hessian_sum (in hessian_values)"]["calls"]
            == 3 * out["stages"]["hessian_values"]["calls"])
    assert "k1 hessian rows (in hessian_values)" not in out["stages"]
    assert (out["stages"]["k7.bal_residual (in compute_chi2)"]["calls"]
            == out["stages"]["compute_chi2"]["calls"])
