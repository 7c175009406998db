"""The port's batched Lie-group ops vs ``graphite_tpu.models.lie`` in
float64: the same seeded NumPy inputs through both, to 1e-12 (the JAX
functions vmapped over the batch). Also the exp / log round trip, the
small-angle branches, compose / inverse, the retraction at zero, and
forward-mode Jacobians of the retraction at delta = 0: finite (float64
and float32) and equal to ``jax.jacfwd``'s."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphite_tpu.models import lie as jlie
from graphite_tpu.models import pose_graph as jpg
from graphite_tpu_torch.models import lie
from graphite_tpu_torch.models import pose_graph as pg

torch.set_num_threads(1)

TOL = 1e-12
N = 64


def _quats(rng, n):
    q = rng.normal(size=(n, 4))
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def _se3(rng, n):
    return np.concatenate([rng.normal(0, 2, (n, 3)), _quats(rng, n)], axis=1)


def _inputs(kind, rng):
    if kind == "tangent":  # angles below pi, where log inverts exp
        xi = rng.normal(0, 1.0, (N, 6))
        theta = np.linalg.norm(xi[:, 3:], axis=1, keepdims=True)
        xi[:, 3:] *= np.minimum(1.0, 3.0 / theta)
        return xi
    if kind == "small":  # every angle below the 1e-8 small-angle cutoff
        return rng.normal(0, 1e-10, (N, 6))
    if kind == "mixed":
        xi = _inputs("tangent", rng)
        xi[::2] *= 1e-10
        return xi
    raise ValueError(kind)


def _close(out, ref):
    ref = np.asarray(ref)
    out = out.numpy() if torch.is_tensor(out) else np.asarray(out)
    np.testing.assert_allclose(out, ref, rtol=TOL,
                               atol=TOL * max(np.abs(ref).max(), 1e-300))


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


@pytest.mark.parametrize("kind", ["tangent", "small", "mixed"])
def test_se3_exp_log_match_jax(kind):
    xi = _inputs(kind, np.random.default_rng(len(kind)))
    _close(lie.se3_exp(_t(xi)), jax.vmap(jlie.se3_exp)(jnp.asarray(xi)))
    _close(lie.so3_exp_quat(_t(xi[:, 3:])),
           jax.vmap(jlie.so3_exp_quat)(jnp.asarray(xi[:, 3:])))
    x = np.asarray(jax.vmap(jlie.se3_exp)(jnp.asarray(xi)))
    _close(lie.se3_log(_t(x)), jax.vmap(jlie.se3_log)(jnp.asarray(x)))
    _close(lie.so3_log(_t(x[:, 3:])),
           jax.vmap(jlie.so3_log)(jnp.asarray(x[:, 3:])))


@pytest.mark.parametrize("kind", ["tangent", "small", "mixed"])
def test_se3_exp_log_roundtrip(kind):
    xi = _inputs(kind, np.random.default_rng(7))
    back = lie.se3_log(lie.se3_exp(_t(xi))).numpy()
    np.testing.assert_allclose(back, xi, rtol=1e-9, atol=1e-10)


def test_compose_inverse_rotate_match_jax():
    rng = np.random.default_rng(3)
    a, b = _se3(rng, N), _se3(rng, N)
    v = rng.normal(size=(N, 3))
    _close(lie.se3_compose(_t(a), _t(b)),
           jax.vmap(jlie.se3_compose)(jnp.asarray(a), jnp.asarray(b)))
    _close(lie.se3_inverse(_t(a)),
           jax.vmap(jlie.se3_inverse)(jnp.asarray(a)))
    _close(lie.quat_mul(_t(a[:, 3:]), _t(b[:, 3:])),
           jax.vmap(jlie.quat_mul)(jnp.asarray(a[:, 3:]),
                                   jnp.asarray(b[:, 3:])))
    _close(lie.quat_rotate(_t(a[:, 3:]), _t(v)),
           jax.vmap(jlie.quat_rotate)(jnp.asarray(a[:, 3:]), jnp.asarray(v)))
    ident = lie.se3_compose(lie.se3_inverse(lie.se3_compose(_t(a), _t(b))),
                            lie.se3_compose(_t(a), _t(b)))
    np.testing.assert_allclose(
        ident.numpy(),
        np.broadcast_to(lie.se3_identity(torch.float64).numpy(), (N, 7)),
        atol=1e-12)


@pytest.mark.parametrize("kind", ["tangent", "small"])
def test_se3_retract_matches_jax(kind):
    rng = np.random.default_rng(11)
    x, xi = _se3(rng, N), _inputs(kind, rng)
    _close(lie.se3_retract(_t(x), _t(xi)),
           jax.vmap(jlie.se3_retract)(jnp.asarray(x), jnp.asarray(xi)))
    np.testing.assert_allclose(
        lie.se3_retract(_t(x), torch.zeros(N, 6, dtype=torch.float64)),
        x, atol=1e-12)


def test_se2_ops_match_jax():
    rng = np.random.default_rng(5)
    a = np.concatenate([rng.normal(0, 3, (N, 2)),
                        rng.uniform(-6, 6, (N, 1))], axis=1)
    b = np.concatenate([rng.normal(0, 3, (N, 2)),
                        rng.uniform(-6, 6, (N, 1))], axis=1)
    _close(lie.se2_retract(_t(a), _t(b)),
           jax.vmap(jlie.se2_retract)(jnp.asarray(a), jnp.asarray(b)))
    _close(lie.se2_relative(_t(a), _t(b)),
           jax.vmap(jlie.se2_relative)(jnp.asarray(a), jnp.asarray(b)))
    _close(lie.angle_wrap(_t(a[:, 2])), jlie.angle_wrap(jnp.asarray(a[:, 2])))
    rel = lie.se2_relative(_t(a), _t(b))
    np.testing.assert_allclose(lie.se2_retract(_t(a), rel).numpy()[:, :2],
                               b[:, :2], atol=1e-12)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_retract_jacobian_at_zero_finite(dtype):
    """Forward mode through the small-angle branch at delta = 0: finite,
    full rank, and (float64) equal to jax.jacfwd's."""
    rng = np.random.default_rng(2)
    x = _se3(rng, 1)[0]
    J = torch.func.jacfwd(
        lambda d: lie.se3_retract(torch.as_tensor(x, dtype=dtype), d))(
        torch.zeros(6, dtype=dtype))
    assert bool(torch.isfinite(J).all())
    assert torch.linalg.matrix_rank(J.double()) == 6
    if dtype == torch.float64:
        ref = jax.jacfwd(lambda d: jlie.se3_retract(jnp.asarray(x), d))(
            jnp.zeros(6))
        _close(J, ref)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_between_jacobian_at_identity_error_finite(dtype):
    """A between factor whose error is exactly the identity (so3_log's
    small branch, w = 1): the AUTO Jacobian is finite."""
    rng = np.random.default_rng(4)
    xa = torch.as_tensor(_se3(rng, 1)[0], dtype=dtype)
    ident = lie.se3_identity(dtype)

    def r(da, db):
        return pg.se3_between_residual(lie.se3_retract(xa, da),
                                       lie.se3_retract(xa, db), ident)

    z = torch.zeros(6, dtype=dtype)
    Ja, Jb = torch.func.jacfwd(r, argnums=(0, 1))(z, z)
    assert bool(torch.isfinite(Ja).all() and torch.isfinite(Jb).all())
    if dtype == torch.float64:
        ref = jax.jacfwd(
            lambda da, db: jpg.se3_between_residual(
                jlie.se3_retract(jnp.asarray(xa.numpy()), da),
                jlie.se3_retract(jnp.asarray(xa.numpy()), db),
                jlie.se3_identity(jnp.float64)), argnums=(0, 1))(
            jnp.zeros(6), jnp.zeros(6))
        _close(Ja, ref[0])
        _close(Jb, ref[1])
