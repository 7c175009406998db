"""The port's analytic BAL reprojection Jacobian against automatic
differentiation (counterpart of ``tests/test_bal_jacobian.py``).

- The analytic 2x9 / 2x3 blocks (``models/bal.reprojection_jacobian``)
  against the JAX package's ``jacfwd`` oracle across the rotation-angle
  regimes of the small-angle branches, in float64 (1e-9) and, as storage
  precision, in float32 (within 2e-4 of the float64 blocks).
- ``models/bal.REPROJECTION_AUTO`` (the residual without a
  ``jacobian_fn``, differentiated by the port's forward mode): its blocks
  equal the ``jacfwd`` oracle's to 1e-9, a full linearization with it
  equals the analytic one (chi2 1e-12; b, the diagonal and the stored J
  1e-7, where ``test_bal_jacobian.py`` explains the oracle's own
  cancellation) and the JAX package's ``REPROJECTION_AUTO`` linearization
  (1e-12).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphite_tpu as gt
import graphite_tpu_torch as gtt
from graphite_tpu.io import bal as jax_bal
from graphite_tpu.io import synthetic as jax_synth
from graphite_tpu.linearize import linearize as jax_linearize
from graphite_tpu.models import bal as jax_model
from graphite_tpu_torch.io import bal as torch_bal
from graphite_tpu_torch.io import synthetic as torch_synth
from graphite_tpu_torch.linearize import linearize
from graphite_tpu_torch.models import bal as bal_model

torch.set_num_threads(1)

THETAS = [0.0, 1e-13, 1e-7, 1e-3, 0.0999, 0.1001, 0.7, 2.9]


def _inputs(tag, theta):
    rng = np.random.default_rng(hash((tag, theta)) % 2**32)
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    cam = np.concatenate([
        axis * theta, rng.normal(size=3) * 0.3 + [0.0, 0.0, 2.0],
        [500.0 + rng.normal() * 50, -1e-7, 1e-13]])
    return cam, rng.normal(size=3), rng.normal(size=2) * 100


def _jacfwd(cam, pt, obs):
    def g(deltas):
        dc, dp = deltas
        return jax_model.reprojection_residual(
            jnp.asarray(cam) + dc, jnp.asarray(pt) + dp, jnp.asarray(obs))

    Jc, Jp = jax.jacfwd(g)((jnp.zeros(9, jnp.float64),
                            jnp.zeros(3, jnp.float64)))
    return np.asarray(Jc), np.asarray(Jp)


def _torch(*arrays, dtype=torch.float64):
    return [torch.tensor(a, dtype=dtype) for a in arrays]


@pytest.mark.parametrize("theta", THETAS)
def test_analytic_matches_jacfwd_f64(theta):
    cam, pt, obs = _inputs("balj", theta)
    Jc, Jp = bal_model.reprojection_jacobian(*_torch(cam, pt, obs))
    Jc_o, Jp_o = _jacfwd(cam, pt, obs)
    scale = max(1.0, float(np.abs(Jc_o).max()))
    np.testing.assert_allclose(Jc.numpy(), Jc_o, rtol=1e-9,
                               atol=1e-9 * scale)
    np.testing.assert_allclose(Jp.numpy(), Jp_o, rtol=1e-9,
                               atol=1e-9 * scale)


@pytest.mark.parametrize("theta", THETAS)
def test_analytic_f32_near_f64(theta):
    cam, pt, _ = _inputs("balj32", theta)
    cam[6:] = [500.0, -1e-7, 1e-13]
    obs = np.zeros(2)
    truth_c, truth_p = bal_model.reprojection_jacobian(*_torch(cam, pt, obs))
    Jc, Jp = bal_model.reprojection_jacobian(
        *_torch(cam, pt, obs, dtype=torch.float32))
    scale = max(1.0, float(truth_c.abs().max()))
    np.testing.assert_allclose(Jc.double().numpy(), truth_c.numpy(),
                               rtol=2e-4, atol=2e-4 * scale)
    np.testing.assert_allclose(Jp.double().numpy(), truth_p.numpy(),
                               rtol=2e-4, atol=2e-4 * scale)


def _one_factor_problem(cam, pt, obs, factor):
    g = gtt.Graph(precision=gtt.FP64_FP64)
    g.add_vertex_set(bal_model.CAMERA).add(0, cam)
    g.add_vertex_set(bal_model.POINT).add(1, pt)
    g.add_factor_set(factor).add([0, 1], obs=obs)
    g.scale_system(False)
    return g.freeze(device="cpu")


@pytest.mark.parametrize("theta", THETAS)
def test_auto_matches_jacfwd(theta):
    """REPROJECTION_AUTO's blocks, through linearize's forward mode."""
    cam, pt, obs = _inputs("balauto", theta)
    problem = _one_factor_problem(cam, pt, obs, bal_model.REPROJECTION_AUTO)
    Jc, Jp = linearize(problem, problem.params0).jacobians[
        "bal_reprojection_auto"]
    Jc_o, Jp_o = _jacfwd(cam, pt, obs)
    scale = max(1.0, float(np.abs(Jc_o).max()))
    np.testing.assert_allclose(Jc.numpy().reshape(2, 9), Jc_o, rtol=1e-9,
                               atol=1e-9 * scale)
    np.testing.assert_allclose(Jp.numpy().reshape(2, 3), Jp_o, rtol=1e-9,
                               atol=1e-9 * scale)


def _lin_torch(factor):
    g, *_ = torch_bal.build_graph(
        torch_synth.make_bal((4, 30, 150), seed=11, noise=0.5),
        precision=gtt.FP64_FP64, factor=factor)
    p = g.freeze(device="cpu")
    return p, linearize(p, p.params0)


def test_linearize_matches_auto_mode():
    p1, lin1 = _lin_torch(None)
    p2, lin2 = _lin_torch(bal_model.REPROJECTION_AUTO)
    assert set(p1.factor_meta) == {"bal_reprojection"}
    assert set(p2.factor_meta) == {"bal_reprojection_auto"}
    assert p2.factor_meta["bal_reprojection_auto"].ftype.jacobian_fn is None
    np.testing.assert_allclose(float(lin1.chi2), float(lin2.chi2),
                               rtol=1e-12)
    np.testing.assert_allclose(lin1.b.numpy(), lin2.b.numpy(), rtol=1e-7,
                               atol=1e-10)
    np.testing.assert_allclose(lin1.diag.numpy(), lin2.diag.numpy(),
                               rtol=1e-7, atol=1e-10)
    for a, b in zip(lin1.jacobians["bal_reprojection"],
                    lin2.jacobians["bal_reprojection_auto"]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-7,
                                   atol=1e-10)


def test_auto_linearize_matches_jax_auto():
    _, lin = _lin_torch(bal_model.REPROJECTION_AUTO)
    g, *_ = jax_bal.build_graph(
        jax_synth.make_bal((4, 30, 150), seed=11, noise=0.5),
        precision=gt.FP64_FP64, factor=jax_model.REPROJECTION_AUTO)
    pj = g.freeze()
    lj = jax_linearize(pj, pj.params0)
    np.testing.assert_allclose(float(lin.chi2), float(lj.chi2), rtol=1e-12)
    np.testing.assert_allclose(lin.b.numpy(), np.asarray(lj.b), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(lin.diag.numpy(), np.asarray(lj.diag),
                               rtol=1e-12, atol=1e-12)
