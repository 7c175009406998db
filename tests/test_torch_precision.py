"""The six precision policies of the port vs the JAX package, on the CPU.

- The policies' dtypes (graph, solver, ``inv_dtype``, ``acc_dtype``)
  equal the JAX package's, and ``from_names`` returns each policy under
  every spelling; a low-precision graph dtype raises in both.
- ``clamp_to_storage`` equals the JAX version bitwise on seeded values
  that include +-1e6 (fp16 clamps to +-65504).
- Per policy, on ``make_bal("mini")`` and a small SE3 sphere, each
  package on its own frozen problem: residuals, ``b`` and chi2 to 1e-12
  relative in float64 and 1e-6 in float32 (SE3 float32: 1e-5, see
  ``_graph_tol``); the stored Jacobians in the storage dtype, within one
  ulp of it of the JAX package's beyond the graph dtype's own tolerance
  (``_storage_close``); the Hessian values, in ``inv_dtype``, computed by
  the port from the JAX package's stored Jacobians, to 1e-12 (float64)
  or 1e-6 (float32) relative; ``hessian_matvec`` on those Jacobians to
  the graph dtype's tolerance.
- Per policy, 5 LM iterations of ``PCGSchurSolver(10, 1.0, 5.0)`` at the
  LM slice's size (12, 120, 700): the same accept pattern; chi2 per
  iteration within 1e-9 (FP64_FP64), 1e-3 (FP64_FP32, FP32_FP32) or 3e-2
  (the bf16 / fp16 policies, with the final chi2 within 1e-3; see
  ``LM_TOL``). The pose graph (PCGSolver with block-Jacobi, 10
  iterations): 1e-9 (FP64_FP64) and 1e-3.
- Per policy, the JAX test's convergence check (``test_precision_matrix``:
  40 iterations of PCGSchurSolver(30, 1e-10, 1e6) on "mini"): the final
  cost within the JAX test's tolerance of the port's FP64_FP64 cost, and
  for bf16 / fp16 storage its bounded degradation.
- K6's fold under FP32_BF16 is float32 and equals a float32 fold of the
  upcast Jacobians in the JAX package's order; under the FP64 policies
  float64 (FP64_FP64) or float32 (FP64_FP32, FP64_BF16) beside float64
  vectors. The pose-graph LM goes through K11's entries and one
  ``solve_pcg_mf`` a solve under every policy.
- With the Schur gates forced low, every site takes the K3, K4 and K5
  plain versions, which get the values' dtype only: float32 sites
  (under FP64_FP32 the vectors are cast in and the results out to
  float64) within 1e-5 of the stepwise branch, float64 sites (FP64_FP64,
  FP64_BF16: the kernels' float64 instances) within 1e-12.
- ``jit_loop`` (uncaptured on the CPU) is bitwise the host loop.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphite_tpu as gt
import graphite_tpu_torch as gtt
from graphite_tpu import hessian as jax_hessian
from graphite_tpu import precision as jax_precision
from graphite_tpu.io import g2o as jax_g2o
from graphite_tpu.io import synthetic as jax_synth
from graphite_tpu.io.bal import build_graph as jax_build_bal
from graphite_tpu.linearize import hessian_matvec as jax_hessian_matvec
from graphite_tpu.linearize import linearize as jax_linearize
from graphite_tpu.optimizers import LevenbergMarquardtOptions as JaxOptions
from graphite_tpu.optimizers import levenberg_marquardt as jax_lm
from graphite_tpu.preconditioners import (
    BlockJacobiPreconditioner as JaxBlockJacobi,
)
from graphite_tpu.solvers import PCGSchurSolver as JaxPCGSchur
from graphite_tpu.solvers import PCGSolver as JaxPCGSolver
from graphite_tpu_torch import hessian as torch_hessian
from graphite_tpu_torch import precision as torch_precision
from graphite_tpu_torch import schur as torch_schur
from graphite_tpu_torch.io import bal as torch_bal_io
from graphite_tpu_torch.io import g2o as torch_g2o
from graphite_tpu_torch.io import synthetic as torch_synth
from graphite_tpu_torch.linearize import Linearization, hessian_matvec
from graphite_tpu_torch.linearize import linearize as torch_linearize
from graphite_tpu_torch.ops.blockfmt import flat_block_mm_tn
from graphite_tpu_torch.ops.cuda import pcg_mf
from graphite_tpu_torch.optimizers import (
    LevenbergMarquardtOptions,
    levenberg_marquardt,
)
from graphite_tpu_torch.preconditioners import BlockJacobiPreconditioner
from graphite_tpu_torch.solvers import PCGSchurSolver, PCGSolver

torch.set_num_threads(1)

NAMES = ["FP64_FP64", "FP64_FP32", "FP64_BF16", "FP32_FP32", "FP32_BF16",
         "FP32_FP16"]
SPELLINGS = {torch.float64: ("fp64", "float64", "FP64"),
             torch.float32: ("fp32", "float32"),
             torch.bfloat16: ("bf16", "bfloat16"),
             torch.float16: ("fp16", "float16")}
# mantissa bits of each storage dtype (one ulp of x is 2^(e(x) - bits))
MANTISSA = {torch.float64: 52, torch.float32: 23, torch.bfloat16: 7,
            torch.float16: 10}


def _same_dtype(tdt, jdt):
    return str(tdt).split(".")[-1] == jnp.dtype(jdt).name


@pytest.mark.parametrize("name", NAMES)
def test_policies_match_jax(name):
    tp, jp = getattr(gtt, name), getattr(gt, name)
    for attr in ("graph_dtype", "solver_dtype", "inv_dtype", "acc_dtype"):
        assert _same_dtype(getattr(tp, attr), getattr(jp, attr)), attr
    for g in SPELLINGS[tp.graph_dtype]:
        for s in SPELLINGS[tp.solver_dtype]:
            assert gtt.Precision.from_names(g, s) == tp
            assert gt.Precision.from_names(g, s) == jp
    if tp.solver_dtype in (torch.bfloat16, torch.float16):
        for bad in SPELLINGS[tp.solver_dtype]:
            with pytest.raises(ValueError):
                gtt.Precision.from_names(bad, "fp32")
            with pytest.raises(ValueError):
                gt.Precision.from_names(bad, "fp32")


@pytest.mark.parametrize("dtype", ["float16", "bfloat16", "float32"])
def test_clamp_to_storage_matches_jax(dtype):
    rng = np.random.default_rng(3)
    x = np.concatenate([rng.standard_normal(500) * 10.0 ** rng.integers(
        -8, 7, 500), [1e6, -1e6, 65504.0, -65520.0, 7e4, 0.0]])
    out = torch_precision.clamp_to_storage(torch.as_tensor(x),
                                           getattr(torch, dtype))
    ref = jax_precision.clamp_to_storage(jnp.asarray(x),
                                         getattr(jnp, dtype))
    assert str(out.dtype).split(".")[-1] == dtype
    ref = np.asarray(ref).astype(np.float64)
    np.testing.assert_array_equal(out.double().numpy(), ref)
    if dtype == "float16":
        assert np.abs(ref).max() == torch_precision.FP16_MAX


def _mini_bal(name):
    ds = jax_synth.make_bal("mini", seed=0, noise=0.5)
    gj, *_ = jax_build_bal(ds, precision=getattr(gt, name))
    gp, *_ = torch_bal_io.build_graph(
        torch_synth.make_bal("mini", seed=0, noise=0.5),
        precision=getattr(gtt, name))
    return gj.freeze(), gp.freeze(device="cpu")


def _sphere(name, poses=120):
    gj, *_ = jax_g2o.build_graph(
        jax_synth.make_sphere_se3(poses, seed=0, loop_every=7),
        precision=getattr(gt, name))
    gp, *_ = torch_g2o.build_graph(
        torch_synth.make_sphere_se3(poses, seed=0, loop_every=7),
        precision=getattr(gtt, name))
    return gj.freeze(), gp.freeze(device="cpu")


DATASETS = {"bal": _mini_bal, "se3": _sphere}


def _graph_tol(dataset, name):
    """Relative tolerance (to each array's largest entry) of quantities
    in the graph dtype. float32 SE3: a between residual
    log(Z^-1 X_i^-1 X_j) composes translations up to 10 long into
    residuals of at most 1.38, and the two packages round the pose
    products apart (the JAX package in float32 trig, the port through
    float64 trig rounded): ~2e-6 apart, two float32 ulps at 10, which is
    ~1.4e-6 of the largest residual; so 1e-5 there."""
    if getattr(gtt, name).graph_dtype == torch.float64:
        return 1e-12
    return 1e-5 if dataset == "se3" else 1e-6


def _np(a):
    a = a.double().numpy() if torch.is_tensor(a) else np.asarray(a)
    return np.asarray(a, dtype=np.float64)


def _close(out, ref, tol):
    out, ref = _np(out), _np(ref)
    assert out.shape == ref.shape
    assert np.abs(out - ref).max() <= tol * max(np.abs(ref).max(), 1e-300)


def _ulp(x, dtype):
    """One ulp of ``dtype`` at |x| (its smallest normal's below it)."""
    finfo = torch.finfo(dtype)
    e = np.floor(np.log2(np.maximum(np.abs(x), finfo.tiny)))
    return np.exp2(e - MANTISSA[dtype])


def _storage_close(out, ref, dtype, tol):
    """Stored values within one ulp of their storage dtype, beyond the
    graph dtype's tolerance ``tol`` (relative to the largest entry): the
    packages compute J in the graph dtype to that tolerance, and rounding
    to nearest moves two values at most one storage ulp further apart."""
    out, ref = _np(out), _np(ref)
    slack = tol * np.abs(ref).max() + _ulp(np.maximum(np.abs(out),
                                                      np.abs(ref)), dtype)
    assert np.all(np.abs(out - ref) <= slack)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("dataset", sorted(DATASETS))
def test_linearize_and_hessian_match_jax(dataset, name):
    pj, pp = DATASETS[dataset](name)
    policy = getattr(gtt, name)
    tol = _graph_tol(dataset, name)
    lj = jax_linearize(pj, pj.params0)
    lp = torch_linearize(pp, pp.params0)
    for f in lj.residuals:
        assert lp.residuals[f].dtype == policy.graph_dtype
        _close(lp.residuals[f], lj.residuals[f], tol)
    _close(lp.b, lj.b, tol)
    _close(lp.chi2, lj.chi2, tol)
    _close(lp.scales, lj.scales, tol)
    for f, js in lj.jacobians.items():
        for jt, jj in zip(lp.jacobians[f], js):
            assert jt.dtype == policy.solver_dtype
            assert _same_dtype(jt.dtype, jj.dtype)
            _storage_close(jt, jj, policy.solver_dtype, tol)

    # the Hessian from the JAX package's stored Jacobians and dL: the
    # block products of storage values are exact in acc_dtype, so only
    # the summation order differs
    lin = Linearization(
        residuals=lp.residuals,
        jacobians={f: tuple(torch.as_tensor(np.asarray(j).astype(np.float64)
                                             ).to(policy.solver_dtype)
                            for j in js)
                   for f, js in lj.jacobians.items()},
        chi2_vec=lp.chi2_vec,
        chi2_deriv={f: torch.as_tensor(np.array(v))
                    for f, v in lj.chi2_deriv.items()},
        scales=lp.scales, diag=lp.diag, b=lp.b, chi2=lp.chi2)
    hsj = jax_hessian.build_hessian_structure(pj)
    hsp = torch_hessian.build_hessian_structure(pp)
    hj = jax_hessian.compute_hessian_values(pj, hsj, lj)
    hp = torch_hessian.compute_hessian_values(pp, hsp, lin)
    htol = 1e-12 if policy.inv_dtype == torch.float64 else 1e-6
    assert hp.keys() == hj.keys()
    for key in hj:
        assert hp[key].dtype == policy.inv_dtype
        _close(hp[key], hj[key], htol)

    # the matrix-free J^T dL P J x on the same stored J: each package
    # upcasts J to acc_dtype
    assert pp.dim_x == pj.dim_x
    x = np.random.default_rng(4).standard_normal(pp.dim_x)
    gdt = policy.graph_dtype
    yp = hessian_matvec(pp, lin, torch.as_tensor(x, dtype=gdt))
    yj = jax_hessian_matvec(pj, lj, jnp.asarray(
        x, dtype=getattr(gt, name).graph_dtype))
    assert yp.dtype == gdt
    _close(yp, yj, tol)


LM_SIZE = (12, 120, 700)
# chi2 per iteration, port vs JAX. bf16 / fp16: the two packages compute
# J in the graph dtype apart in the last bit (above), so a value near a
# rounding tie of the storage dtype rounds to neighbouring storage values
# (2^-8 or 2^-11 apart, relative) and the truncated PCG (10 steps, tol
# 1.0) carries that into the step: up to 1.5e-2 apart at FP32_FP16's
# second iteration. The trajectories meet again: the final chi2 within
# 1e-3.
LM_TOL = {"FP64_FP64": 1e-9, "FP64_FP32": 1e-3, "FP32_FP32": 1e-3,
          "FP64_BF16": 3e-2, "FP32_BF16": 3e-2, "FP32_FP16": 3e-2}


def _history(result):
    return ([h["accepted"] for h in result.history],
            np.array([h["chi2"] for h in result.history]))


@pytest.mark.parametrize("name", NAMES)
def test_lm_matches_jax(name):
    gj, *_ = jax_build_bal(jax_synth.make_bal(LM_SIZE, seed=0, noise=0.5),
                           precision=getattr(gt, name))
    ref = jax_lm(gj.freeze(), JaxPCGSchur(10, 1.0, 5.0),
                 options=JaxOptions(iterations=5))
    gp, *_ = torch_bal_io.build_graph(
        torch_synth.make_bal(LM_SIZE, seed=0, noise=0.5),
        precision=getattr(gtt, name))
    out = levenberg_marquardt(gp.freeze(device="cpu"),
                              PCGSchurSolver(10, 1.0, 5.0),
                              options=LevenbergMarquardtOptions(iterations=5))
    acc_p, chi_p = _history(out)
    acc_j, chi_j = _history(ref)
    assert acc_p == acc_j and len(acc_p) == 5
    np.testing.assert_allclose(chi_p, chi_j, rtol=LM_TOL[name])
    np.testing.assert_allclose(float(out.chi2), float(ref.chi2),
                               rtol=min(LM_TOL[name], 1e-3))
    assert float(out.chi2) < float(out.initial_chi2)
    for p in out.params.values():
        assert p.dtype == getattr(gtt, name).graph_dtype


@pytest.mark.parametrize("name", NAMES)
def test_pose_lm_matches_jax(name):
    gj, *_ = jax_g2o.build_graph(
        jax_synth.make_sphere_se3(120, seed=0, loop_every=7),
        precision=getattr(gt, name))
    ref = jax_lm(gj.freeze(), JaxPCGSolver(50, 1e-10, 1e6, JaxBlockJacobi()),
                 options=JaxOptions(iterations=10, initial_damping=1e-4))
    gp, *_ = torch_g2o.build_graph(
        torch_synth.make_sphere_se3(120, seed=0, loop_every=7),
        precision=getattr(gtt, name))
    out = levenberg_marquardt(
        gp.freeze(device="cpu"),
        PCGSolver(50, 1e-10, 1e6, BlockJacobiPreconditioner()),
        options=LevenbergMarquardtOptions(iterations=10,
                                          initial_damping=1e-4))
    acc_p, chi_p = _history(out)
    acc_j, chi_j = _history(ref)
    assert acc_p == acc_j
    np.testing.assert_allclose(chi_p, chi_j,
                               rtol=1e-9 if name == "FP64_FP64" else 1e-3)


# the JAX package's test_precision_matrix.py: final-cost tolerance to the
# FP64_FP64 cost, or None for bounded degradation (bf16 / fp16 storage)
CONVERGE_RTOL = {"FP64_FP64": 1e-9, "FP64_FP32": 1e-2, "FP64_BF16": None,
                 "FP32_FP32": 1e-2, "FP32_BF16": None, "FP32_FP16": None}


def _converged(name):
    gp, *_ = torch_bal_io.build_graph(
        torch_synth.make_bal("mini", seed=0, noise=0.5),
        precision=getattr(gtt, name))
    return levenberg_marquardt(
        gp.freeze(device="cpu"), PCGSchurSolver(30, 1e-10, 1e6),
        options=LevenbergMarquardtOptions(iterations=40,
                                          initial_damping=1e-4))


@pytest.mark.parametrize("name", NAMES)
def test_policy_converges_to_same_cost(name):
    res = _converged(name)
    ref = float(_converged("FP64_FP64").chi2)
    chi2 = float(res.chi2)
    if CONVERGE_RTOL[name] is None:
        assert chi2 < 2.0 * ref, (chi2, ref)
        assert chi2 < 0.01 * float(res.initial_chi2)
    else:
        np.testing.assert_allclose(chi2, ref, rtol=CONVERGE_RTOL[name])


def test_fold_jacobians_is_float32_under_bf16():
    _, pp = _sphere("FP32_BF16")
    lin = torch_linearize(pp, pp.params0)
    site = pcg_mf.plan_pcg_mf(pp, lin)
    assert site is not None
    out = pcg_mf.fold_jacobians(pp, lin, site)
    assert out.dtype == torch.float32
    parts = []
    for blk in site.blocks:
        J = lin.jacobians[blk.fname]
        assert J[0].dtype == torch.bfloat16
        C = site.chol[blk.fname]
        assert C is not None and C.dtype == torch.float32
        dl = torch.sqrt(lin.chi2_deriv[blk.fname].float().clamp_min(0.0))
        slots = []
        for s in range(blk.arity):
            # C^T J summed over the residual rows in order, then sqrt(dL)
            Js = flat_block_mm_tn(C, J[s].float(), blk.E, blk.E, site.d,
                                  acc_dtype=torch.float32)
            slots.append(Js * dl[:, None])
        parts.append(torch.cat(slots, dim=1).reshape(-1))
    assert torch.equal(out, torch.cat(parts))


@pytest.mark.parametrize("name", ["FP64_FP64", "FP64_FP32", "FP64_BF16"])
def test_fold_jacobians_under_fp64(name):
    """K6's float64 instance reads J' as ``fold_jacobians`` gives it:
    float64 under FP64_FP64, float32 under FP64_FP32 and FP64_BF16 (the
    stored J upcast to float32, then C^T J and sqrt(dL) in float32, as the
    JAX package folds), beside float64 b and damping."""
    _, pp = _sphere(name)
    lin = torch_linearize(pp, pp.params0)
    site = pcg_mf.plan_pcg_mf(pp, lin)
    assert site is not None
    out = pcg_mf.fold_jacobians(pp, lin, site)
    dt = torch.float64 if name == "FP64_FP64" else torch.float32
    assert out.dtype == dt and lin.b.dtype == torch.float64
    parts = []
    for blk in site.blocks:
        J = lin.jacobians[blk.fname]
        assert J[0].dtype == getattr(gtt, name).solver_dtype
        C = site.chol[blk.fname]
        assert C is not None and C.dtype == dt
        dl = torch.sqrt(lin.chi2_deriv[blk.fname].to(dt).clamp_min(0.0))
        slots = [flat_block_mm_tn(C, J[s].to(dt), blk.E, blk.E, site.d,
                                  acc_dtype=dt) * dl[:, None]
                 for s in range(blk.arity)]
        parts.append(torch.cat(slots, dim=1).reshape(-1))
    assert torch.equal(out, torch.cat(parts))


@pytest.mark.parametrize("name", NAMES)
def test_pose_lm_takes_k11_and_k6(monkeypatch, name):
    """The pose-graph LM (PCGSolver with block-Jacobi) goes through K11's
    entries and one ``solve_pcg_mf`` a solve under every policy: the float64
    instances' gates are open in a float64 graph (on the CPU each wrapper
    runs its plain version)."""
    from graphite_tpu_torch.ops.cuda import pose as k11
    from graphite_tpu_torch.solvers import pcg as pcg_module

    calls = {}

    def counted(module, attr):
        real = getattr(module, attr)

        def wrapper(*args, **kwargs):
            calls[attr] = calls.get(attr, 0) + 1
            return real(*args, **kwargs)
        monkeypatch.setattr(module, attr, wrapper)

    # linearize's second pass calls every fused kernel's ``scale_b``
    for attr in ("se3_residual", "se3_linearize", "scale_b", "se3_update"):
        counted(k11, attr)
    counted(pcg_module, "solve_pcg_mf")
    _, pp = _sphere(name, poses=60)
    out = levenberg_marquardt(
        pp, PCGSolver(50, 1e-10, 1e6, BlockJacobiPreconditioner()),
        options=LevenbergMarquardtOptions(iterations=4,
                                          initial_damping=1e-4))
    n = len(out.history)
    assert calls == {"se3_residual": n, "se3_update": n,
                     "se3_linearize": out.accepted_steps + 1,
                     "scale_b": out.accepted_steps + 1,
                     "solve_pcg_mf": n}, calls
    assert float(out.chi2) < float(out.initial_chi2)


KERNEL_WRAPPERS = ("streaming_segment_product_sum_rtbl", "block_matvec_wtbl",
                   "matvec_sym_stream", "streaming_matvec_tbl")


def _schur_pass(pp, calls=None, monkeypatch=None):
    """S, b_S, S x and the back-substitution of the port on ``pp`` (the
    kernel wrappers spied on when ``calls`` is given)."""
    if calls is not None:
        for wrapper in KERNEL_WRAPPERS:
            real = getattr(torch_schur, wrapper)

            def spy(*args, real=real, wrapper=wrapper, **kw):
                calls.append((wrapper, {a.dtype for a in args
                                        if torch.is_tensor(a)
                                        and a.is_floating_point()}))
                return real(*args, **kw)

            monkeypatch.setattr(torch_schur, wrapper, spy)
    lin = torch_linearize(pp, pp.params0)
    hs = torch_hessian.build_hessian_structure(pp)
    hv = torch_hessian.apply_damping(
        pp, hs, torch_hessian.compute_hessian_values(pp, hs, lin), lin.diag,
        1e-2, False)
    ss = torch_schur.build_schur_structure(pp)
    sv = torch_schur.schur_values(pp, ss, hv)
    ops = torch_schur.SchurOps(pp, ss, hv, sv)
    gdt = pp.precision.graph_dtype
    x = torch.as_tensor(np.random.default_rng(2).standard_normal(ss.dim_p),
                        dtype=gdt)
    ops.prepare_matvec()
    lu = ops.landmark_update(lin.b, x)
    return dict(s_vals=sv.s_vals, b_s=ops.b_schur(lin.b),
                y=ops.s_matvec(x), lu=lu, delta=ops.compose_delta(x, lu))


@pytest.mark.parametrize("name", NAMES)
def test_forced_schur_gates_follow_the_dtype(monkeypatch, name):
    policy = getattr(gtt, name)
    stepwise = _schur_pass(_mini_bal(name)[1])
    monkeypatch.setattr(torch_schur, "CHUNK_THRESHOLD", 0)
    monkeypatch.setattr(torch_schur, "_smv_chunk_rows", lambda rb: 0)
    calls = []
    _, pp = _mini_bal(name)
    forced = _schur_pass(pp, calls, monkeypatch)
    cache = pp._cache
    # every K3, K4 and K5 site took its kernel's branch, on values of
    # inv_dtype only (FP64_FP32: the vectors cast in to float32; float64
    # values take the kernels' float64 instances)
    assert {c[0] for c in calls} == set(KERNEL_WRAPPERS)
    assert all(dts == {policy.inv_dtype} for _, dts in calls)
    assert cache["smv_sym_sites"] and cache["product_plans"]
    assert {t[0] for t in cache["matvec_plans"]} == {"bschur", "lu"}
    tol = 1e-5 if policy.inv_dtype == torch.float32 else 1e-12
    for key, s in forced["s_vals"].items():
        assert s.dtype == policy.inv_dtype
        _close(s, stepwise["s_vals"][key], tol)
    for what in ("b_s", "y", "delta"):
        assert forced[what].dtype == policy.graph_dtype, what
        _close(forced[what], stepwise[what], tol)
    for t, rows in forced["lu"].items():
        # Hll^-1 t in inv_dtype, as the JAX package's _hll_solve_rows
        assert rows.dtype == policy.inv_dtype
        _close(rows, stepwise["lu"][t], tol)


@pytest.mark.parametrize("name", NAMES)
def test_jit_loop_equals_host_loop(name):
    runs = []
    for jit in (False, True):
        gp, *_ = torch_bal_io.build_graph(
            torch_synth.make_bal("mini", seed=0, noise=0.5),
            precision=getattr(gtt, name))
        runs.append(levenberg_marquardt(
            gp.freeze(device="cpu"), PCGSchurSolver(10, 1.0, 5.0),
            options=LevenbergMarquardtOptions(iterations=6, jit_loop=jit)))
    host, loop = runs
    assert _history(host)[0] == _history(loop)[0]
    assert [h["chi2"] for h in host.history] == [
        h["chi2"] for h in loop.history]
    for k, p in host.params.items():
        assert torch.equal(loop.params[k], p)
