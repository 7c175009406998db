"""Kernel K11 (``ops/cuda/pose.py``, ``csrc/pose.cu``): the SE(3)
pose-graph factors' linearization, chi2 and update, on the CPU.

- ``linearize``, ``compute_chi2`` and ``apply_update`` with K11's gates
  open (the CPU runs each entry's plain version) bitwise the generic
  branch (the gates shut by ``monkeypatch``): r, the stored J, chi2, dL,
  the scales, the diagonal, b and chi2; and each entry bitwise the
  generic pieces it stands for (the jvp's masked J, the chi2 block, the
  diagonal's and b's rows, the stored J), on the 120-pose sphere with
  the special cases of ``tests/torch_k11_cases.py`` (a prior set, a
  fixed first pose, disabled factors, negative-w quaternions,
  near-identity errors, errors near and at pi) under the six policies
  (FP32_FP32, FP32_BF16, FP32_FP16, and the float64 instances' FP64_FP64,
  FP64_FP32, FP64_BF16) and the default, Huber and Cauchy losses, and
  on sphere2500 (FP32_FP32, FP64_FP64).
- The kernel's arithmetic (``csrc/se3_dual.cuh``), built for the host
  with g++ (no multiply-add contraction, as nvcc's -fmad=false): each
  factor's residual, its jvp primal and every Jacobian column bitwise
  ``torch.func.jvp`` through the retraction, and the trial chi2's
  residual bitwise the model's, on those problems and on random poses,
  identity rotations, w = 0 and tiny rotations. Its double build against
  the float64 jvp branch: bitwise where the C library's sin, cos and
  atan2 agree with PyTorch's (throughout on identity and tiny rotations,
  most factors elsewhere), else within 16 ulps (``F64_HOST_ULPS``).
- ``linearize(out=)`` writes the same bits as a new call into the same
  tensors.
- Against the JAX package on FP32_FP32 (a fixed first pose, and a prior
  in its place): ``linearize`` and ``compute_chi2`` within 1e-5 of each
  array's largest entry (``test_torch_precision``'s SE3 tolerance), and
  10 LM iterations of PCGSolver(50, 1e-10, 1e6, block-Jacobi): the same
  accept pattern, chi2 within 1e-3 per iteration; on FP64_FP64 (the JAX
  package in float64) within 1e-10, and chi2 within 1e-9.
- The gates shut for SE(2), dynamic Jacobians and a factor with its own
  ``jacobian_fn``; open for the float64 graphs.
"""

import ctypes
import dataclasses
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphite_tpu as gt
import graphite_tpu_torch as gtt
from graphite_tpu.io import g2o as jax_g2o
from graphite_tpu.io import synthetic as jax_synth
from graphite_tpu.linearize import compute_chi2 as jax_compute_chi2
from graphite_tpu.linearize import linearize as jax_linearize
from graphite_tpu.optimizers import LevenbergMarquardtOptions as JaxOptions
from graphite_tpu.optimizers import levenberg_marquardt as jax_lm
from graphite_tpu.preconditioners import (
    BlockJacobiPreconditioner as JaxBlockJacobi,
)
from graphite_tpu.solvers import PCGSolver as JaxPCGSolver
from graphite_tpu_torch.interop import params_from_numpy
from graphite_tpu_torch.io import g2o, synthetic
from graphite_tpu_torch.linearize import (
    _apply_precision,
    _auto_residual_and_jacobians,
    _gather_params,
    _residuals_and_flat_jacobians,
    _scaled_jacobians,
    _weighted_residual,
    apply_update,
    compute_chi2,
    compute_chi2_block,
    compute_residuals_block,
    linearize,
)
from graphite_tpu_torch.models import pose_graph as pg
from graphite_tpu_torch.ops.blockfmt import flat_block_mv_t, sum_in_order
from graphite_tpu_torch.ops.cuda import build
from graphite_tpu_torch.ops.cuda import pose as k11
from graphite_tpu_torch.optimizers import (
    LevenbergMarquardtOptions,
    levenberg_marquardt,
)
from graphite_tpu_torch.preconditioners import BlockJacobiPreconditioner
from graphite_tpu_torch.solvers import PCGSolver
from torch_k11_cases import LOSSES, k11_problem

torch.set_num_threads(1)

POLICIES = ["FP32_FP32", "FP32_BF16", "FP32_FP16", "FP64_FP64", "FP64_FP32",
            "FP64_BF16"]


def _bits(t):
    return t.contiguous().view({4: torch.int32, 2: torch.int16,
                                8: torch.int64}[t.element_size()])


def _same(a, b, what=""):
    assert a.dtype == b.dtype and a.shape == b.shape, what
    assert torch.equal(_bits(a), _bits(b)), what


def _problem(size, loss="default", policy="FP32_FP32"):
    if size == "sphere2500":
        return k11_problem("cpu", 2500, 10, loss, getattr(gtt, policy),
                           special=False, prior=False)
    return k11_problem("cpu", 120, 7, loss, getattr(gtt, policy))


def _shut(monkeypatch):
    monkeypatch.setattr(k11, "gate", lambda problem, name: None)
    monkeypatch.setattr(k11, "update_gate", lambda problem, name: False)


def _step(problem, seed=3):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(0.05 * rng.standard_normal(problem.dim_x),
                           dtype=problem.precision.graph_dtype)


def _passes(problem):
    """linearize at the start, the update by a seeded step, compute_chi2
    at the start and after the step."""
    params = problem.params0
    lin = linearize(problem, params)
    moved = apply_update(problem, params, lin, _step(problem))
    return lin, moved, compute_chi2(problem, params), compute_chi2(
        problem, moved)


CASES = [("special120", loss, policy) for policy in POLICIES
         for loss in sorted(LOSSES)] + [
    ("sphere2500", "default", "FP32_FP32"),
    ("sphere2500", "default", "FP64_FP64")]


@pytest.mark.parametrize("size,loss,policy", CASES)
def test_gated_passes_bitwise_generic(monkeypatch, size, loss, policy):
    problem = _problem(size, loss, policy)
    assert all(k11.gate(problem, n) is not None for n in problem.factor_meta)
    assert k11.update_gate(problem, "se3_pose")
    lin, moved, c0, c1 = _passes(problem)
    with monkeypatch.context() as m:
        _shut(m)
        ref, ref_moved, r0, r1 = _passes(problem)
    for name in problem.factor_meta:
        _same(lin.residuals[name], ref.residuals[name], name)
        _same(lin.chi2_vec[name], ref.chi2_vec[name], name)
        _same(lin.chi2_deriv[name], ref.chi2_deriv[name], name)
        for a, b in zip(lin.jacobians[name], ref.jacobians[name],
                        strict=True):
            _same(a, b, name)
    for field in ("scales", "diag", "b", "chi2"):
        _same(getattr(lin, field), getattr(ref, field), field)
    _same(moved["se3_pose"], ref_moved["se3_pose"], "update")
    _same(c0, r0, "chi2 at the start")
    _same(c1, r1, "chi2 after the step")


@pytest.mark.parametrize("size,loss,policy", CASES)
def test_entries_bitwise_generic_pieces(size, loss, policy):
    """Each entry's arrays against the generic code's pieces of the same
    set: the masked jvp J and the chi2 block, the diagonal's rows
    (J . P J dL), the stored J and b's rows (-J^T dL P r)."""
    problem = _problem(size, loss, policy)
    params = problem.params0
    acc = problem.precision.acc_dtype  # the graph dtype
    rng = np.random.default_rng(9)
    for name, fm in problem.factor_meta.items():
        fa = problem.data.factors[name]
        loss_fn = k11.gate(problem, name)
        args = (params["se3_pose"], fa.ids, fa.obs, fa.precision)
        r, J, chi2, dL, diag = k11.se3_linearize(
            *args, fa.slot_mask, fa.factor_mask, fa.loss_params, loss_fn)
        r_ref, j_ref = _residuals_and_flat_jacobians(problem, params, name)
        c_ref, d_ref = compute_chi2_block(problem, name, r_ref)
        _same(r, r_ref)
        _same(chi2, c_ref)
        _same(dL, d_ref)
        _same(k11.se3_residual(*args, fa.factor_mask, fa.loss_params,
                               loss_fn), compute_chi2_block(
            problem, name, compute_residuals_block(problem, params,
                                                   name))[0])
        for s, vt in enumerate(fm.ftype.vertex_types):
            _same(J[s], j_ref[s], f"{name} J slot {s}")
            Ja = j_ref[s].to(acc)
            PJ = _apply_precision(fa.precision, Ja, 6, 6,
                                  acc).reshape(-1, 6, 6)
            Ja = Ja.reshape(-1, 6, 6)
            _same(diag[s], sum_in_order(Ja[:, e] * PJ[:, e]
                                        for e in range(6))
                  * d_ref.to(acc)[:, None], f"{name} diag slot {s}")
        n = problem.seg_rows["se3_pose"]
        flat_scales = torch.as_tensor(rng.random(problem.dim_x),
                                      dtype=problem.precision.graph_dtype)
        padded = problem.rows_view_padded(flat_scales, "se3_pose")
        stored, b = k11.se3_scale_b(J, r, dL, fa.precision,
                                    (padded,) * len(J), fa.rows,
                                    problem.precision.solver_dtype)
        s_ref = _scaled_jacobians(problem, name, j_ref, flat_scales)
        w = (_weighted_residual(fa.precision, r_ref, acc)
             * d_ref[:, None]).to(acc)
        for s in range(len(J)):
            _same(stored[s], s_ref[s], f"{name} stored slot {s}")
            _same(b[s], -flat_block_mv_t(s_ref[s], w, 6, 6, acc_dtype=acc),
                  f"{name} b slot {s}")
        assert padded.shape == (n + 1, 6)


# ---- the kernel's arithmetic, built for the host --------------------------

SHIM = r"""
#include "se3_dual.cuh"
template <class T>
void rows(const T* xa, const T* xb, const T* z, long long F, int nslot,
          T* r, T* J, T* r_model) {
  const int K = 6 * nslot;
  for (long long f = 0; f < F; ++f) {
    const T* x[2] = {xa + 7 * f, xb + 7 * f};
    for (int k = 0; k < K; ++k) {
      T rr[6], jt[6];
      if (nslot == 2) se3::residual_jvp<2>(x, z + 7 * f, k, rr, jt);
      else se3::residual_jvp<1>(x, z + 7 * f, k, rr, jt);
      for (int e = 0; e < 6; ++e) {
        r[(f * K + k) * 6 + e] = rr[e];
        J[(f * K + k) * 6 + e] = jt[e];
      }
    }
    if (nslot == 2) se3::residual<2>(x, z + 7 * f, r_model + 6 * f);
    else se3::residual<1>(x, z + 7 * f, r_model + 6 * f);
  }
}
extern "C" void jvp_rows(const float* xa, const float* xb, const float* z,
                         long long F, int nslot, float* r, float* J,
                         float* r_model) {
  rows(xa, xb, z, F, nslot, r, J, r_model);
}
extern "C" void jvp_rows_f64(const double* xa, const double* xb,
                             const double* z, long long F, int nslot,
                             double* r, double* J, double* r_model) {
  rows(xa, xb, z, F, nslot, r, J, r_model);
}
"""


@pytest.fixture(scope="module")
def host_shim(tmp_path_factory):
    """The per-factor math of K11 compiled for the host: every direction's
    residual and tangent, and the model's residual, of each factor."""
    d = tmp_path_factory.mktemp("k11_host")
    src, lib = d / "shim.cpp", d / "libshim.so"
    src.write_text(SHIM)
    subprocess.run(["g++", "-O2", "-std=c++17", "-ffp-contract=off",
                    "-shared", "-fPIC", f"-I{build.CSRC_DIR}", "-o",
                    str(lib), str(src)], check=True, capture_output=True)
    shim = ctypes.CDLL(str(lib))
    P = ctypes.c_void_p
    for fn in (shim.jvp_rows, shim.jvp_rows_f64):
        fn.argtypes = [P, P, P, ctypes.c_longlong, ctypes.c_int, P, P, P]
    return shim


def _host_rows(shim, poses, obs):
    F, nslot, dt = obs.shape[0], len(poses), obs.dtype
    x = [p.contiguous() for p in poses]
    x = x + x[:1] if nslot == 1 else x
    r = torch.empty(F, 6 * nslot, 6, dtype=dt)
    J = torch.empty(F, 6 * nslot, 6, dtype=dt)
    r_model = torch.empty(F, 6, dtype=dt)
    fn = shim.jvp_rows_f64 if dt == torch.float64 else shim.jvp_rows
    fn(x[0].data_ptr(), x[1].data_ptr(), obs.contiguous().data_ptr(), F,
       nslot, r.data_ptr(), J.data_ptr(), r_model.data_ptr())
    return r, J, r_model


def _quat_poses(rng, F, rot_scale=None):
    t = rng.standard_normal((F, 3))
    if rot_scale is None:
        q = rng.standard_normal((F, 4))
    else:
        q = np.concatenate([rot_scale * rng.standard_normal((F, 3)),
                            np.ones((F, 1))], axis=1)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return torch.as_tensor(np.concatenate([t, q], axis=1),
                           dtype=torch.float32)


def _random_sets(case):
    """(poses per slot, obs) of random factors for ``case``."""
    rng = np.random.default_rng(21)
    F = 400
    if case == "random":
        a, b, z = (_quat_poses(rng, F) for _ in range(3))
    elif case == "identity":  # identity rotations, exact measurements
        a, b = _quat_poses(rng, F, 0.0), _quat_poses(rng, F, 0.0)
        z = b.clone()
        z[:, :3] = b[:, :3] - a[:, :3]
    elif case == "w_zero":  # rotations by pi exactly
        a, b, z = (_quat_poses(rng, F) for _ in range(3))
        a[:, 3:] = torch.tensor([1.0, 0.0, 0.0, 0.0])
    else:  # tiny rotations, and priors at their pose
        a, b, z = (_quat_poses(rng, F, 1e-9) for _ in range(3))
    return [((a, b), z), ((a,), z), ((a,), a.clone())]


def _check_host(shim, poses, obs):
    ftype = pg.SE3_BETWEEN if len(poses) == 2 else pg.SE3_PRIOR
    r, J, r_model = _host_rows(shim, poses, obs)
    r_ref, j_ref = _auto_residual_and_jacobians(ftype, poses, (obs,))
    for k in range(J.shape[1]):  # every thread's residual is the primal
        _same(r[:, k], r_ref, f"r of direction {k}")
    for s in range(len(poses)):
        _same(J[:, 6 * s:6 * s + 6].transpose(1, 2), j_ref[s],
              f"J slot {s}")
    _same(r_model, ftype.residual_fn(*poses, obs).reshape(-1, 6), "model r")


@pytest.mark.parametrize("case", ["special120", "sphere2500", "random",
                                  "identity", "w_zero", "tiny"])
def test_host_build_bitwise_jvp(host_shim, case):
    if case in ("special120", "sphere2500"):
        problem = _problem(case)
        for name in problem.factor_meta:
            _check_host(host_shim,
                        _gather_params(problem, problem.params0, name),
                        problem.data.factors[name].obs)
        return
    for poses, obs in _random_sets(case):
        _check_host(host_shim, poses, obs)


# The double build against the jvp branch in float64. The host build calls
# the C library's sin, cos and atan2; PyTorch's CPU float64 ops call its
# own vectorised versions, which differ from them by an ulp on ~0.2% (sin,
# cos) and ~2.5% (atan2) of arguments. A factor whose transcendentals
# agree is bitwise; one whose do not is held to F64_HOST_ULPS ulps of the
# larger of 1 and its largest entry (the poses' scale: a residual at its
# measurement is rounding noise of O(1) coordinates). Identity and tiny
# rotations take no transcendental's tangent and are bitwise throughout.
F64_HOST_ULPS = 16
F64_HOST_BITWISE = ("identity", "tiny")


def _check_host_f64(shim, poses, obs, bitwise):
    ftype = pg.SE3_BETWEEN if len(poses) == 2 else pg.SE3_PRIOR
    r, J, r_model = _host_rows(shim, poses, obs)
    r_ref, j_ref = _auto_residual_and_jacobians(ftype, poses, (obs,))
    got = torch.cat([r.flatten(1), r_model,
                     *(J[:, 6 * s:6 * s + 6].transpose(1, 2).flatten(1)
                       for s in range(len(poses)))], 1)
    ref = torch.cat([r_ref.repeat(1, J.shape[1]),
                     ftype.residual_fn(*poses, obs).reshape(-1, 6),
                     *(j.flatten(1) for j in j_ref)], 1)
    same = (_bits(got) == _bits(ref)).all(1)
    scale = ref.abs().amax(1).clamp_min(1.0)
    ulps = (got - ref).abs().amax(1) / (torch.finfo(torch.float64).eps
                                        * scale)
    assert float(ulps.max()) <= F64_HOST_ULPS, float(ulps.max())
    if bitwise:
        assert bool(same.all()), int((~same).sum())
    return int(same.sum()), same.numel()


@pytest.mark.parametrize("case", ["special120", "sphere2500", "random",
                                  "identity", "w_zero", "tiny"])
def test_host_build_f64_against_jvp(host_shim, case):
    """The double instance of the header: each factor bitwise the float64
    jvp branch where the C library's and PyTorch's transcendentals agree,
    else within ``F64_HOST_ULPS``; most factors bitwise."""
    counts = []
    if case in ("special120", "sphere2500"):
        problem = _problem(case, policy="FP64_FP64")
        for name in problem.factor_meta:
            counts.append(_check_host_f64(
                host_shim, _gather_params(problem, problem.params0, name),
                problem.data.factors[name].obs, False))
    else:
        for poses, obs in _random_sets(case):
            counts.append(_check_host_f64(
                host_shim, tuple(p.double() for p in poses), obs.double(),
                case in F64_HOST_BITWISE))
    same, total = map(sum, zip(*counts))
    assert same >= 0.85 * total, (same, total)


# ---- out= ----------------------------------------------------------------

@pytest.mark.parametrize("policy", ["FP32_FP32", "FP32_FP16"])
def test_linearize_out_same_bits(policy):
    problem = _problem("special120", "huber", policy)
    start = linearize(problem, problem.params0)
    moved = apply_update(problem, problem.params0, start, _step(problem))
    fresh = linearize(problem, moved)
    ptrs = {n: [t.data_ptr() for t in (start.residuals[n], start.chi2_vec[n],
                                       start.chi2_deriv[n],
                                       *start.jacobians[n])]
            for n in problem.factor_meta}
    out = linearize(problem, moved, out=start)
    assert out is start
    for n in problem.factor_meta:
        assert [t.data_ptr() for t in (out.residuals[n], out.chi2_vec[n],
                                       out.chi2_deriv[n],
                                       *out.jacobians[n])] == ptrs[n]
        _same(out.residuals[n], fresh.residuals[n])
        _same(out.chi2_vec[n], fresh.chi2_vec[n])
        _same(out.chi2_deriv[n], fresh.chi2_deriv[n])
        for a, b in zip(out.jacobians[n], fresh.jacobians[n], strict=True):
            _same(a, b)
    for field in ("scales", "diag", "b", "chi2"):
        _same(getattr(out, field), getattr(fresh, field), field)


# ---- against the JAX package --------------------------------------------

PRIOR = np.eye(6) * 1e4


def _jax_pair(prior, policy="FP32_FP32"):
    """The 120-pose sphere in both packages under ``policy``: the first
    pose fixed, or (``prior``) a prior on it in its place."""
    kw = {"prior_information": PRIOR} if prior else {}
    gj, *_ = jax_g2o.build_graph(
        jax_synth.make_sphere_se3(120, seed=0, loop_every=7),
        precision=getattr(gt, policy), **kw)
    gp, *_ = g2o.build_graph(
        synthetic.make_sphere_se3(120, seed=0, loop_every=7),
        precision=getattr(gtt, policy), **kw)
    return gj.freeze(), gp.freeze(device="cpu")


def _close(out, ref, tol):
    out = out.double().numpy() if torch.is_tensor(out) else np.asarray(out)
    ref = np.asarray(ref, dtype=np.float64)
    assert out.shape == ref.shape
    assert np.abs(out - ref).max() <= tol * max(np.abs(ref).max(), 1e-300)


def _linearize_and_chi2_vs_jax(prior, policy, tol):
    pj, pp = _jax_pair(prior, policy)
    assert all(k11.gate(pp, n) is not None for n in pp.factor_meta)
    lj = jax_linearize(pj, pj.params0)
    lp = linearize(pp, pp.params0)
    for f in lj.residuals:
        _close(lp.residuals[f], lj.residuals[f], tol)
        for jt, jj in zip(lp.jacobians[f], lj.jacobians[f], strict=True):
            _close(jt, jj, tol)
    for field in ("b", "chi2", "scales", "diag"):
        _close(getattr(lp, field), getattr(lj, field), tol)
    # compute_chi2 at a moved point, the same numbers on both sides
    rng = np.random.default_rng(2)
    poses = np.array(pj.params0["se3_pose"], dtype=np.float64)
    poses[:, :3] += 0.01 * rng.standard_normal((len(poses), 3))
    dt = pp.precision.graph_dtype
    moved = params_from_numpy({"se3_pose": poses}, dtype=dt)
    jdt = jnp.float64 if dt == torch.float64 else jnp.float32
    _close(compute_chi2(pp, moved), jax_compute_chi2(
        pj, {"se3_pose": jnp.asarray(poses, dtype=jdt)}), tol)


@pytest.mark.parametrize("prior", [False, True])
def test_linearize_and_chi2_match_jax(prior):
    _linearize_and_chi2_vs_jax(prior, "FP32_FP32", 1e-5)


@pytest.mark.parametrize("prior", [False, True])
def test_linearize_and_chi2_match_jax_f64(prior):
    """FP64_FP64 (the JAX package in float64): within 1e-10 of each
    array's largest entry."""
    _linearize_and_chi2_vs_jax(prior, "FP64_FP64", 1e-10)


def _lm_vs_jax(prior, policy, rtol):
    pj, pp = _jax_pair(prior, policy)
    ref = jax_lm(pj, JaxPCGSolver(50, 1e-10, 1e6, JaxBlockJacobi()),
                 options=JaxOptions(iterations=10, initial_damping=1e-4))
    out = levenberg_marquardt(
        pp, PCGSolver(50, 1e-10, 1e6, BlockJacobiPreconditioner()),
        options=LevenbergMarquardtOptions(iterations=10,
                                          initial_damping=1e-4))
    assert ([h["accepted"] for h in out.history]
            == [bool(h["accepted"]) for h in ref.history])
    np.testing.assert_allclose([h["chi2"] for h in out.history],
                               [float(h["chi2"]) for h in ref.history],
                               rtol=rtol)


@pytest.mark.parametrize("prior", [False, True])
def test_lm_matches_jax(prior):
    _lm_vs_jax(prior, "FP32_FP32", 1e-3)


@pytest.mark.parametrize("prior", [False, True])
def test_lm_matches_jax_f64(prior):
    """FP64_FP64: K11's and K6's plain versions against the JAX package's
    jacfwd and generic float64 CG, the same accept pattern and chi2
    within 1e-9 per iteration."""
    _lm_vs_jax(prior, "FP64_FP64", 1e-9)


# ---- the gates ------------------------------------------------------------

def _off_gate(case):
    if case in ("FP64_FP64", "FP64_FP32"):
        g, *_ = g2o.build_graph(synthetic.make_sphere_se3(
            30, seed=0, loop_every=7), precision=getattr(gtt, case))
    elif case == "se2":
        g, *_ = g2o.build_graph(synthetic.make_pose_graph_2d(30, seed=0),
                                precision=gtt.FP32_FP32)
    else:
        g, vs, fs, _ = g2o.build_graph(synthetic.make_sphere_se3(
            30, seed=0, loop_every=7), precision=gtt.FP32_FP32)
        if case == "dynamic":
            fs.set_jacobian_storage(False)
        else:  # a factor type with its own (here: the jvp's) Jacobian
            def jac(xa, xb, obs):
                return _auto_residual_and_jacobians(
                    pg.SE3_BETWEEN, (xa, xb), (obs,))[1]
            fs.ftype = dataclasses.replace(fs.ftype, jacobian_fn=jac)
    return g.freeze(device="cpu")


@pytest.mark.parametrize("case", ["FP64_FP64", "FP64_FP32", "se2",
                                  "dynamic", "jacobian_fn"])
def test_gate_shut_off_its_path(case):
    """The gates shut for SE(2), dynamic Jacobians and a factor with its
    own Jacobian (the update gate open for the last two, whose vertices
    are SE3), and open for the float64 graphs of FP64_FP64 and
    FP64_FP32 (K11's float64 instances)."""
    problem = _off_gate(case)
    f64 = case.startswith("FP64")
    for name in problem.factor_meta:
        assert (k11.gate(problem, name) is not None) == f64, name
    for name in problem.vertex_meta:
        assert k11.update_gate(problem, name) == (
            f64 or case in ("dynamic", "jacobian_fn")), name
