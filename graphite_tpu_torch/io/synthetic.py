"""Synthetic BAL-style problems (NumPy copy of the BAL part of
``graphite_tpu/io/synthetic.py``; the same seed gives identical arrays).

Cameras sit on a ring looking inward at a point cloud; observations come
from the BAL projection plus noise, and the initial parameters are the
ground truth perturbed. Sizes mirror published BAL problems
(Ladybug-49: 49 cameras / 7776 points / 31843 observations).
"""

from __future__ import annotations

import numpy as np

from .bal import BALDataset

# name -> (cameras, points, observations), mirroring BAL problem sizes
BAL_SIZES = {
    "toy": (2, 3, 6),
    "mini": (4, 50, 150),
    "ladybug": (49, 7776, 31843),
    "trafalgar": (21, 11315, 36455),
    "dubrovnik": (16, 22106, 83718),
    "venice": (52, 64053, 347173),
    "venice-big": (1778, 993923, 5001946),
}


def _rodrigues_np(rvec, X):
    theta = np.linalg.norm(rvec, axis=-1, keepdims=True)
    small = theta[..., 0] < 1e-12
    axis = np.where(small[..., None], 0.0, rvec / np.where(theta == 0, 1, theta))
    cth = np.cos(theta)
    sth = np.sin(theta)
    axx = np.cross(axis, X)
    adx = np.sum(axis * X, axis=-1, keepdims=True)
    out = X * cth + axx * sth + axis * adx * (1 - cth)
    return np.where(small[..., None], X + np.cross(rvec, X), out)


def project_np(cameras, X):
    P = _rodrigues_np(cameras[:, :3], X) + cameras[:, 3:6]
    p = -P[:, :2] / P[:, 2:3]
    r2 = np.sum(p * p, axis=-1, keepdims=True)
    d = 1.0 + cameras[:, 7:8] * r2 + cameras[:, 8:9] * r2 * r2
    return cameras[:, 6:7] * d * p


def make_bal(name_or_counts="mini", seed: int = 0, noise: float = 1.0,
             perturb_points: float = 0.05, perturb_cams: float = 0.01
             ) -> BALDataset:
    """Generate a synthetic BAL problem (a size name from ``BAL_SIZES`` or
    a (cameras, points, observations) tuple)."""
    if isinstance(name_or_counts, str):
        n_cam, n_pt, n_obs = BAL_SIZES[name_or_counts]
    else:
        n_cam, n_pt, n_obs = name_or_counts
    rng = np.random.default_rng(seed)

    # ground-truth world: points in a unit ball
    pts = rng.normal(0, 0.5, size=(n_pt, 3))

    # cameras on a ring at radius R; small random rotations, and P_z kept
    # negative (BAL looks down -z: p = -P.xy / P.z) by translating along z
    R = 4.0
    angles = np.linspace(0, 2 * np.pi, n_cam, endpoint=False)
    centers = np.stack(  # noqa: F841  (drawn to keep the random stream)
        [R * np.cos(angles), R * np.sin(angles),
         rng.normal(0.0, 0.2, n_cam)], axis=1
    )
    rvecs = rng.normal(0, 0.05, size=(n_cam, 3))
    t = np.stack(
        [rng.normal(0, 0.1, n_cam), rng.normal(0, 0.1, n_cam),
         -3.0 + rng.normal(0, 0.2, n_cam)], axis=1
    )
    f = rng.uniform(400.0, 600.0, n_cam)
    k1 = rng.normal(0, 1e-3, n_cam)
    k2 = rng.normal(0, 1e-4, n_cam)
    cams_true = np.concatenate(
        [rvecs, t, f[:, None], k1[:, None], k2[:, None]], axis=1
    )

    # observations: random (camera, point) pairs, resampled until every
    # pair has a safe depth (P_z <= -1)
    def depths(ci, pi):
        P = _rodrigues_np(cams_true[ci, :3], pts[pi]) + cams_true[ci, 3:6]
        return P[:, 2]

    cam_idx = rng.integers(0, n_cam, n_obs)
    point_idx = rng.integers(0, n_pt, n_obs)
    pending = np.nonzero(depths(cam_idx, point_idx) > -1.0)[0]
    for _ in range(50):
        if pending.size == 0:
            break
        cam_idx[pending] = rng.integers(0, n_cam, pending.size)
        point_idx[pending] = rng.integers(0, n_pt, pending.size)
        still = depths(cam_idx[pending], point_idx[pending]) > -1.0
        pending = pending[still]
    # every camera and point is observed at least once
    cam_idx[:n_cam] = np.arange(n_cam)
    if n_obs >= n_pt:
        point_idx[:n_pt] = np.arange(n_pt)
    shallow = depths(cam_idx, point_idx) > -1.0
    # forced-coverage rows that ended up shallow: pull the point toward
    # the cloud center instead of resampling the pair
    if np.any(shallow):
        idx = np.nonzero(shallow)[0]
        pts[point_idx[idx]] *= 0.3
    obs = project_np(cams_true[cam_idx], pts[point_idx])
    obs += rng.normal(0, noise, size=obs.shape)

    # perturb initial estimates
    cams0 = cams_true.copy()
    cams0[:, :3] += rng.normal(0, perturb_cams, (n_cam, 3))
    cams0[:, 3:6] += rng.normal(0, perturb_cams * 5, (n_cam, 3))
    pts0 = pts + rng.normal(0, perturb_points, (n_pt, 3))

    return BALDataset(
        cameras=cams0,
        points=pts0,
        cam_idx=cam_idx,
        point_idx=point_idx,
        observations=obs,
    )
