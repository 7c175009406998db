"""Synthetic problems: BAL-style bundle adjustment and pose graphs (NumPy
copy of ``graphite_tpu/io/synthetic.py``; the same seed gives identical
arrays).

Pose graphs: ``make_pose_graph_2d`` (an SE2 circle with odometry and loop
closures) and ``make_sphere_se3`` (a sphere2500-style SE3 spiral); the
initial estimates integrate the noisy odometry.

BAL (``make_bal``): cameras sit on a ring looking inward at a point cloud; observations come
from the BAL projection plus noise, and the initial parameters are the
ground truth perturbed. Sizes mirror published BAL problems
(Ladybug-49: 49 cameras / 7776 points / 31843 observations).
"""

from __future__ import annotations

import numpy as np

from .bal import BALDataset
from .g2o import PoseGraphDataset

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


# ---------------------------------------------------------------------------
# pose graphs
# ---------------------------------------------------------------------------

def _q_mul(q1, q2):
    x1, y1, z1, w1 = q1
    x2, y2, z2, w2 = q2
    return np.array([
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
    ])


def _q_conj(q):
    return np.array([-q[0], -q[1], -q[2], q[3]])


def _q_rot(q, v):
    u, w = q[:3], q[3]
    uv = np.cross(u, v)
    return v + 2.0 * (w * uv + np.cross(u, uv))


def _q_exp(phi):
    theta = np.linalg.norm(phi)
    if theta < 1e-12:
        return np.array([0.5 * phi[0], 0.5 * phi[1], 0.5 * phi[2], 1.0])
    axis = phi / theta
    return np.concatenate([axis * np.sin(theta / 2), [np.cos(theta / 2)]])


def _se3_compose(a, b):
    return np.concatenate(
        [a[:3] + _q_rot(a[3:7], b[:3]), _q_mul(a[3:7], b[3:7])]
    )


def _se3_inverse(a):
    qi = _q_conj(a[3:7])
    return np.concatenate([-_q_rot(qi, a[:3]), qi])


def make_pose_graph_2d(n_poses: int = 100, seed: int = 0,
                       odo_noise=(0.05, 0.05, 0.01),
                       loop_every: int = 10):
    """2D circle trajectory with odometry + loop-closure edges (g2o-style).

    Initial estimate integrates the noisy odometry (classic drift), so LM
    has real loop-closing work to do.
    """
    rng = np.random.default_rng(seed)
    R = 10.0
    angles = np.linspace(0, 2 * np.pi, n_poses, endpoint=False)
    true = np.stack(
        [R * np.cos(angles), R * np.sin(angles), angles + np.pi / 2], axis=1
    )

    def rel(a, b):
        c, s = np.cos(a[2]), np.sin(a[2])
        d = b[:2] - a[:2]
        dth = (b[2] - a[2] + np.pi) % (2 * np.pi) - np.pi
        return np.array([c * d[0] + s * d[1], -s * d[0] + c * d[1], dth])

    edges, meas = [], []
    for i in range(n_poses - 1):
        m = rel(true[i], true[i + 1]) + rng.normal(0, odo_noise, 3)
        edges.append((i, i + 1))
        meas.append(m)
    # loop closures (incl. the big loop n-1 -> 0)
    for i in range(0, n_poses, loop_every):
        j = (i + n_poses // 2) % n_poses
        if abs(i - j) > 1:
            edges.append((i, j))
            meas.append(rel(true[i], true[j]) + rng.normal(0, odo_noise, 3))
    edges.append((n_poses - 1, 0))
    meas.append(rel(true[n_poses - 1], true[0]) + rng.normal(0, odo_noise, 3))

    # initial guess: integrate odometry
    est = np.zeros_like(true)
    est[0] = true[0]
    for i in range(n_poses - 1):
        m = meas[i]
        c, s = np.cos(est[i, 2]), np.sin(est[i, 2])
        est[i + 1, 0] = est[i, 0] + c * m[0] - s * m[1]
        est[i + 1, 1] = est[i, 1] + s * m[0] + c * m[1]
        est[i + 1, 2] = est[i, 2] + m[2]

    info = np.diag(1.0 / np.asarray(odo_noise) ** 2)
    return PoseGraphDataset(
        kind="se2",
        vertex_ids=np.arange(n_poses),
        poses=est,
        edges=np.asarray(edges, dtype=np.int64),
        measurements=np.asarray(meas),
        information=np.tile(info, (len(edges), 1, 1)),
    )


def make_sphere_se3(n_poses: int = 2500, seed: int = 0,
                    odo_noise_t: float = 0.02, odo_noise_r: float = 0.005,
                    loop_every: int = 10):
    """Sphere2500-style SE3 pose graph: a spiral trajectory on a sphere with
    odometry and vertical loop closures; initial estimate integrates noisy
    odometry."""
    rng = np.random.default_rng(seed)
    R = 10.0
    # spiral: theta winds around, z sweeps top to bottom
    turns = max(2, n_poses // 50)
    t = np.linspace(0, 1, n_poses)
    az = 2 * np.pi * turns * t
    el = np.pi * (t - 0.5)
    centers = np.stack(
        [R * np.cos(el) * np.cos(az), R * np.cos(el) * np.sin(az),
         R * np.sin(el)], axis=1
    )
    true = np.zeros((n_poses, 7))
    for i in range(n_poses):
        # orientation: tangent-ish random stable quaternion from the path
        yaw = az[i]
        pitch = el[i] * 0.5
        qz = _q_exp(np.array([0.0, 0.0, yaw]))
        qy = _q_exp(np.array([0.0, pitch, 0.0]))
        q = _q_mul(qz, qy)
        true[i, :3] = centers[i]
        true[i, 3:] = q / np.linalg.norm(q)

    def rel(a, b):
        return _se3_compose(_se3_inverse(a), b)

    def noisy(m):
        n = np.concatenate(
            [rng.normal(0, odo_noise_t, 3), rng.normal(0, odo_noise_r, 3)]
        )
        return _se3_compose(m, np.concatenate([n[:3], _q_exp(n[3:6])]))

    edges, meas = [], []
    for i in range(n_poses - 1):
        edges.append((i, i + 1))
        meas.append(noisy(rel(true[i], true[i + 1])))
    per_turn = max(1, n_poses // turns)
    for i in range(0, n_poses - per_turn, loop_every):
        j = i + per_turn  # same azimuth, next sweep
        edges.append((i, j))
        meas.append(noisy(rel(true[i], true[j])))

    est = np.zeros_like(true)
    est[0] = true[0]
    for i in range(n_poses - 1):
        est[i + 1] = _se3_compose(est[i], meas[i])
        est[i + 1, 3:] /= np.linalg.norm(est[i + 1, 3:])

    info = np.diag(
        [1.0 / odo_noise_t**2] * 3 + [1.0 / odo_noise_r**2] * 3
    )
    return PoseGraphDataset(
        kind="se3",
        vertex_ids=np.arange(n_poses),
        poses=est,
        edges=np.asarray(edges, dtype=np.int64),
        measurements=np.asarray(meas),
        information=np.tile(info, (len(edges), 1, 1)),
    )


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
