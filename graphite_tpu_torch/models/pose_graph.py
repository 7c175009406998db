"""Pose-graph (SLAM) model families (counterpart of
``graphite_tpu/models/pose_graph.py``).

- SE2 vertex (3 parameters, 3-dim tangent) and SE3 vertex (7 parameters
  [t, quat], 6-dim tangent, right-perturbation retraction with the
  quaternion re-normalized);
- binary relative-pose factors r = Log(Z^{-1} X_a^{-1} X_b) with
  per-edge information matrices (the factor ``precision``);
- unary prior factors, to fix the gauge by a prior instead of a fixed
  pose.

The factors have no ``jacobian_fn``: ``linearize`` differentiates them
through the retraction (``Differentiation.AUTO``), which gives the true
tangent-space Jacobians, as in the JAX package.
"""

from __future__ import annotations

import torch

from ..factors import factor_type
from ..vertices import vertex_type
from . import lie

# ---------------------------------------------------------------------------
# SE2
# ---------------------------------------------------------------------------

SE2 = vertex_type("se2_pose", 3, retract=lie.se2_retract)


def se2_between_residual(xa, xb, obs):
    """r = (a^{-1} b) - z with the angle wrapped; obs = (dx, dy, dtheta)."""
    rel = lie.se2_relative(xa, xb)
    return torch.stack([
        rel[..., 0] - obs[..., 0],
        rel[..., 1] - obs[..., 1],
        lie.angle_wrap(rel[..., 2] - obs[..., 2]),
    ], dim=-1)


SE2_BETWEEN = factor_type("se2_between", 3, [SE2, SE2], se2_between_residual,
                          obs_shape=(3,))


def se2_prior_residual(x, obs):
    return torch.stack([
        x[..., 0] - obs[..., 0], x[..., 1] - obs[..., 1],
        lie.angle_wrap(x[..., 2] - obs[..., 2]),
    ], dim=-1)


SE2_PRIOR = factor_type("se2_prior", 3, [SE2], se2_prior_residual,
                        obs_shape=(3,))

# ---------------------------------------------------------------------------
# SE3
# ---------------------------------------------------------------------------

SE3 = vertex_type("se3_pose", 6, ambient_dim=7, retract=lie.se3_retract)


def se3_between_residual(xa, xb, obs):
    """r = Log(Z^{-1} a^{-1} b); obs = the 7-parameter measured relative
    pose."""
    rel = lie.se3_compose(lie.se3_inverse(xa), xb)
    err = lie.se3_compose(lie.se3_inverse(obs), rel)
    return lie.se3_log(err)


SE3_BETWEEN = factor_type("se3_between", 6, [SE3, SE3], se3_between_residual,
                          obs_shape=(7,))


def se3_prior_residual(x, obs):
    return lie.se3_log(lie.se3_compose(lie.se3_inverse(obs), x))


SE3_PRIOR = factor_type("se3_prior", 6, [SE3], se3_prior_residual,
                        obs_shape=(7,))
