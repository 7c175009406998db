"""Linearization and Hessian values of the PyTorch port vs the JAX package
on the same frozen BAL problem, float64, to 1e-12 relative to each
array's largest entry (same algebra; only the summation order of the
reductions differs)."""

import numpy as np
import pytest
import torch

import graphite_tpu as gt
import graphite_tpu_torch as gtt
from graphite_tpu import hessian as jax_hessian
from graphite_tpu.io import synthetic
from graphite_tpu.io.bal import build_graph as jax_build_graph
from graphite_tpu.linearize import linearize as jax_linearize
from graphite_tpu_torch import hessian as torch_hessian
from graphite_tpu_torch.interop import params_from_numpy
from graphite_tpu_torch.io import bal as torch_bal_io
from graphite_tpu_torch.linearize import compute_chi2
from graphite_tpu_torch.linearize import linearize as torch_linearize

torch.set_num_threads(1)

TOL = 1e-12


def _close(a, b, tol=TOL):
    a, b = np.asarray(a), np.asarray(b)
    scale = max(1.0, float(np.abs(b).max(initial=0.0)))
    np.testing.assert_allclose(a, b, rtol=tol, atol=tol * scale)


def _problems(huber=None, fixed_camera=None):
    ds = synthetic.make_bal((12, 120, 700), seed=1, noise=0.5)
    kj = kp = {}
    if huber is not None:
        kj = dict(loss=gt.HuberLoss(), loss_param=huber)
        kp = dict(loss=gtt.HuberLoss(), loss_param=huber)
    gj, camsj, _, _ = jax_build_graph(ds, precision=gt.FP64_FP64, **kj)
    gp, camsp, _, _ = torch_bal_io.build_graph(ds, precision=gtt.FP64_FP64,
                                               **kp)
    if fixed_camera is not None:
        camsj.set_fixed(fixed_camera)
        camsp.set_fixed(fixed_camera)
    pj, pp = gj.freeze(), gp.freeze()
    params = {k: np.asarray(v) for k, v in pj.params0.items()}
    return pj, pp, params


CASES = {
    "plain": dict(),
    "huber_fixed": dict(huber=20.0, fixed_camera=3),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_linearize_matches_jax(case):
    pj, pp, params = _problems(**CASES[case])
    lj = jax_linearize(pj, pj.params0)
    lp = torch_linearize(pp, params_from_numpy(params))
    _close(lp.chi2.item(), float(lj.chi2))
    for field in ("scales", "diag", "b"):
        _close(getattr(lp, field).numpy(), getattr(lj, field))
    for name in lj.jacobians:
        for s, Jj in enumerate(lj.jacobians[name]):
            _close(lp.jacobians[name][s].numpy(), Jj)
        _close(lp.residuals[name].numpy(), lj.residuals[name])
        _close(lp.chi2_deriv[name].numpy(), lj.chi2_deriv[name])
    _close(compute_chi2(pp, params_from_numpy(params)).item(),
           float(lj.chi2))


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("use_identity", [False, True])
def test_hessian_values_and_damping_match_jax(case, use_identity):
    pj, pp, params = _problems(**CASES[case])
    lj = jax_linearize(pj, pj.params0)
    lp = torch_linearize(pp, params_from_numpy(params))
    hsj = jax_hessian.build_hessian_structure(pj)
    hsp = torch_hessian.build_hessian_structure(pp)
    assert hsp.group_keys == hsj.group_keys
    np.testing.assert_array_equal(hsp.block_rows, hsj.block_rows)
    np.testing.assert_array_equal(hsp.block_cols, hsj.block_cols)
    hvj = jax_hessian.compute_hessian_values(pj, hsj, lj)
    hvp = torch_hessian.compute_hessian_values(pp, hsp, lp)
    for key in hsj.group_keys:
        _close(hvp[key].numpy(), hvj[key])
    mu = 1e-2
    dj = jax_hessian.apply_damping(pj, hsj, hvj, lj.diag, mu, use_identity)
    dp = torch_hessian.apply_damping(pp, hsp, hvp, lp.diag, mu, use_identity)
    for key in hsj.group_keys:
        _close(dp[key].numpy(), dj[key])
        # the undamped values are left untouched
        _close(hvp[key].numpy(), hvj[key])
