"""Custom-factor tutorial: 2D range-bearing SLAM (counterpart of
``examples/range_bearing_slam.py``).

What a user defines for a new problem class:

- a manifold vertex type (the SE2 robot pose, ``models/pose_graph.SE2``);
- a Euclidean vertex type (a 2D landmark);
- custom factors: SE2 odometry (``SE2_BETWEEN``) and range-bearing
  landmark observations, a batched ``(F, 2)`` residual differentiated
  automatically (``torch.func.jvp``); the first pose is fixed for gauge;
- Schur elimination of the landmarks and PCG on the pose system.

    python -m graphite_tpu_torch.examples.range_bearing_slam
    python -m graphite_tpu_torch.examples.range_bearing_slam --poses 500 \\
        --landmarks 200 --device cpu

Runs on the CUDA card unless ``--device cpu``. cos, sin, atan2 and the
square root are taken in float64 and rounded (``models/lie.py``), so the
card and the CPU compute the same float32 residuals.
"""

import argparse
import time

import numpy as np
import torch

import graphite_tpu_torch as gtt
from graphite_tpu_torch.models import lie
from graphite_tpu_torch.models import pose_graph as pg
from graphite_tpu_torch.optimizers import (
    LevenbergMarquardtOptions,
    levenberg_marquardt,
)
from graphite_tpu_torch.precision import sqrt_rn
from graphite_tpu_torch.solvers import PCGSchurSolver

LANDMARK = gtt.vertex_type("rb_landmark", 2)


def range_bearing_residual(pose, lm, obs):
    """(F, 2): measured (range, bearing) of each landmark in its robot's
    frame minus the predicted, the bearing wrapped."""
    c = lie._in_f64(torch.cos, pose[..., 2])
    s = lie._in_f64(torch.sin, pose[..., 2])
    d0 = lm[..., 0] - pose[..., 0]
    d1 = lm[..., 1] - pose[..., 1]
    l0 = c * d0 + s * d1
    l1 = -s * d0 + c * d1
    rng = sqrt_rn(l0 * l0 + l1 * l1 + 1e-12)
    bearing = lie._in_f64(torch.atan2, l1, l0)
    return torch.stack([rng - obs[..., 0],
                        lie.angle_wrap(bearing - obs[..., 1])], dim=-1)


RANGE_BEARING = gtt.factor_type(
    "range_bearing", 2, [pg.SE2, LANDMARK], range_bearing_residual,
    obs_shape=(2,),
)


def simulate(n_poses, n_lms, seed=0):
    rng = np.random.default_rng(seed)
    R = 8.0
    angles = np.linspace(0, 2 * np.pi, n_poses, endpoint=False)
    poses_true = np.stack(
        [R * np.cos(angles), R * np.sin(angles), angles + np.pi / 2], axis=1
    )
    lms_true = rng.uniform(-10, 10, (n_lms, 2))

    def rel(a, b):
        c, s = np.cos(a[2]), np.sin(a[2])
        d = b[:2] - a[:2]
        return np.array([c * d[0] + s * d[1], -s * d[0] + c * d[1],
                         (b[2] - a[2] + np.pi) % (2 * np.pi) - np.pi])

    odo = [rel(poses_true[i], poses_true[i + 1])
           + rng.normal(0, [0.05, 0.05, 0.01])
           for i in range(n_poses - 1)]

    obs = []
    for i, p in enumerate(poses_true):
        d = lms_true - p[:2]
        dist = np.linalg.norm(d, axis=1)
        visible = np.nonzero(dist < 6.0)[0]
        for j in visible:
            bearing = np.arctan2(d[j, 1], d[j, 0]) - p[2]
            bearing = (bearing + np.pi) % (2 * np.pi) - np.pi
            obs.append((i, j, dist[j] + rng.normal(0, 0.05),
                        bearing + rng.normal(0, 0.01)))

    # initial estimates: integrate noisy odometry; landmarks from first
    # sighting
    poses0 = np.zeros_like(poses_true)
    poses0[0] = poses_true[0]
    for i, m in enumerate(odo):
        c, s = np.cos(poses0[i, 2]), np.sin(poses0[i, 2])
        poses0[i + 1] = [poses0[i, 0] + c * m[0] - s * m[1],
                         poses0[i, 1] + s * m[0] + c * m[1],
                         poses0[i, 2] + m[2]]
    lms0 = np.zeros_like(lms_true)
    seen = np.zeros(n_lms, dtype=bool)
    for (i, j, r, b) in obs:
        if not seen[j]:
            th = poses0[i, 2] + b
            lms0[j] = poses0[i, :2] + r * np.array([np.cos(th), np.sin(th)])
            seen[j] = True
    return poses_true, lms_true, poses0, lms0, odo, obs


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="2D range-bearing SLAM")
    ap.add_argument("--poses", type=int, default=100)
    ap.add_argument("--landmarks", type=int, default=40)
    ap.add_argument("--iterations", type=int, default=25)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the CUDA card)")
    return ap.parse_args(argv)


def main(argv=None):
    """Run the example on ``argv`` (default: the command line); returns
    the ``LMResult``."""
    args = parse_args(argv)
    poses_true, lms_true, poses0, lms0, odo, obs = simulate(
        args.poses, args.landmarks
    )
    print(f"{args.poses} poses, {args.landmarks} landmarks, "
          f"{len(obs)} range-bearing observations, {len(odo)} odometry edges")

    g = gtt.Graph(precision=gtt.FP32_FP32)
    pose_set = g.add_vertex_set(pg.SE2)
    lm_set = g.add_vertex_set(LANDMARK)
    for i in range(args.poses):
        pose_set.add(i, poses0[i])
    for j in range(args.landmarks):
        lm_set.add(10000 + j, lms0[j])
    lm_set.set_eliminate(True)
    pose_set.set_fixed(0, True)  # gauge

    odo_set = g.add_factor_set(pg.SE2_BETWEEN)
    info = np.diag([1 / 0.05**2, 1 / 0.05**2, 1 / 0.01**2])
    for i, m in enumerate(odo):
        odo_set.add([i, i + 1], obs=m, precision=info)

    rb_set = g.add_factor_set(RANGE_BEARING)
    rb_info = np.diag([1 / 0.05**2, 1 / 0.01**2])
    for (i, j, r, b) in obs:
        rb_set.add([i, 10000 + j], obs=[r, b], precision=rb_info)

    problem = g.freeze(device=args.device)
    solver = PCGSchurSolver(max_iter=30, tol=1e-8, rejection_ratio=1e6)
    t0 = time.perf_counter()
    res = levenberg_marquardt(
        problem, solver,
        options=LevenbergMarquardtOptions(iterations=args.iterations,
                                          initial_damping=1e-4, verbose=True),
    )
    print(f"optimized in {time.perf_counter() - t0:.2f}s; "
          f"chi2 {res.initial_chi2:.4g} -> {res.chi2:.4g}")

    est_poses = res.params["se2_pose"].detach().cpu().numpy()
    est_lms = res.params["rb_landmark"].detach().cpu().numpy()
    print(f"pose position RMSE: "
          f"{np.sqrt(((est_poses[:, :2] - poses_true[:, :2])**2).mean()):.4f} "
          f"(odometry-only: "
          f"{np.sqrt(((poses0[:, :2] - poses_true[:, :2])**2).mean()):.4f})")
    print(f"landmark RMSE: "
          f"{np.sqrt(((est_lms - lms_true)**2).mean()):.4f}")
    return res


if __name__ == "__main__":
    main()
