"""BAL reprojection model of the PyTorch port vs the JAX package, and the
port's analytic Jacobian vs ``torch.func.jacfwd``, in every rotation-angle
regime (exact form, Taylor branch below theta = 0.1, first-order branch at
theta = 0). float64; tolerance 1e-12 relative to the largest entry for
the cross-package check (same formulas, only rounding differs) and 1e-9
for the autodiff check (the Taylor branch truncates at ~theta^8)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphite_tpu.models import bal as jax_bal
from graphite_tpu_torch.models import bal as torch_bal

torch.set_num_threads(1)

THETAS = [0.0, 1e-3, 0.09, 0.11, 1.0]


def _inputs(theta, n=16):
    rng = np.random.default_rng(int(theta * 1e6) + 7)
    axis = rng.normal(size=(n, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    cams = np.concatenate([
        axis * theta,
        rng.normal(size=(n, 3)) * 0.3 + [0.0, 0.0, -3.0],
        500.0 + rng.normal(size=(n, 1)) * 50,
        rng.normal(size=(n, 1)) * 1e-3,
        rng.normal(size=(n, 1)) * 1e-4,
    ], axis=1)
    pts = rng.normal(size=(n, 3)) * 0.5
    obs = rng.normal(size=(n, 2)) * 100
    return cams, pts, obs


def _close(a, b, tol):
    a, b = np.asarray(a), np.asarray(b)
    scale = max(1.0, float(np.abs(b).max()))
    np.testing.assert_allclose(a, b, rtol=tol, atol=tol * scale)


@pytest.mark.parametrize("theta", THETAS)
def test_residual_matches_jax(theta):
    cams, pts, obs = _inputs(theta)
    ref = np.stack([np.asarray(jax_bal.reprojection_residual(
        jnp.asarray(c), jnp.asarray(p), jnp.asarray(o)))
        for c, p, o in zip(cams, pts, obs)])
    out = torch_bal.reprojection_residual(
        torch.as_tensor(cams), torch.as_tensor(pts), torch.as_tensor(obs))
    _close(out.numpy(), ref, 1e-12)


@pytest.mark.parametrize("theta", THETAS)
def test_jacobian_matches_jax(theta):
    cams, pts, obs = _inputs(theta)
    ref = [jax_bal.reprojection_jacobian(jnp.asarray(c), jnp.asarray(p),
                                         jnp.asarray(o))
           for c, p, o in zip(cams, pts, obs)]
    Jc, Jp = torch_bal.reprojection_jacobian(
        torch.as_tensor(cams), torch.as_tensor(pts), torch.as_tensor(obs))
    _close(Jc.numpy(), np.stack([np.asarray(r[0]) for r in ref]), 1e-12)
    _close(Jp.numpy(), np.stack([np.asarray(r[1]) for r in ref]), 1e-12)


@pytest.mark.parametrize("theta", THETAS)
def test_analytic_jacobian_matches_jacfwd(theta):
    cams, pts, obs = _inputs(theta, n=4)
    for c, p, o in zip(cams, pts, obs):
        c, p, o = (torch.as_tensor(a) for a in (c, p, o))
        Jc_ad, Jp_ad = torch.func.jacfwd(
            torch_bal.reprojection_residual, argnums=(0, 1))(c, p, o)
        Jc, Jp = torch_bal.reprojection_jacobian(c, p, o)
        _close(Jc.numpy(), Jc_ad.numpy(), 1e-9)
        _close(Jp.numpy(), Jp_ad.numpy(), 1e-9)
