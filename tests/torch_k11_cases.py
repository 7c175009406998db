"""Pose graphs for kernel K11's tests (``ops/cuda/pose.py``), on the CPU
(``tests/test_torch_pose_fused.py``) and on the card
(``tests/test_torch_gpu.py``). Imports no JAX.

``k11_problem`` builds a sphere (``make_sphere_se3``) with the cases the
kernel's arithmetic must get right, each at a few factors:

- a fixed first pose (a masked slot) and disabled factors;
- negative-w quaternions, in poses and in measurements;
- near-identity relative poses: between factors whose two poses share a
  rotation and whose measurement has the identity rotation, and priors
  whose measurement is their pose (the error rotation is exactly the
  identity: the small-angle branches of ``so3_log`` and ``se3_log``);
- relative rotations near pi (the error's w near 0) and at pi;
- an ``se3_prior`` set on every sixth pose (the first, fixed, among
  them), with per-factor information matrices;

under the default, Huber or Cauchy loss and any precision policy.
"""

import numpy as np

import graphite_tpu_torch as gtt
from graphite_tpu_torch.factors import factor_type
from graphite_tpu_torch.io import synthetic
from graphite_tpu_torch.models import pose_graph as pg

LOSSES = {"default": (gtt.DefaultLoss(), None),
          "huber": (gtt.HuberLoss(), 0.05),
          "cauchy": (gtt.CauchyLoss(), 0.1)}


def _qmul(p, q):
    """Quaternion products (x, y, z, w), float64, row by row."""
    x1, y1, z1, w1 = np.moveaxis(p, -1, 0)
    x2, y2, z2, w2 = np.moveaxis(q, -1, 0)
    return np.stack([w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                     w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                     w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
                     w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2], axis=-1)


def _axis_angle(axis, angle):
    axis = axis / np.linalg.norm(axis, axis=-1, keepdims=True)
    return np.concatenate([axis * np.sin(angle / 2)[..., None],
                           np.cos(angle / 2)[..., None]], axis=-1)


def k11_dataset(poses: int = 120, loop_every: int = 7, special: bool = True):
    """``make_sphere_se3(poses, seed=0, loop_every=...)`` with the special
    cases above written into its poses and measurements (``special``)."""
    ds = synthetic.make_sphere_se3(poses, seed=0, loop_every=loop_every)
    if not special:
        return ds
    P, Z, edges = ds.poses.copy(), ds.measurements.copy(), ds.edges
    rng = np.random.default_rng(11)
    # near-identity errors: both poses one rotation, an identity measurement
    for e in range(5, len(edges), 37):
        a, b = edges[e]
        P[b, 3:] = P[a, 3:]
        Z[e, 3:] = (0.0, 0.0, 0.0, 1.0)
    # errors near and at pi: the measurement's rotation is the relative
    # pose's times a rotation by ~pi
    for j, e in enumerate(range(11, len(edges), 29)):
        a, b = edges[e]
        rel = _qmul(P[a, 3:] * (-1, -1, -1, 1), P[b, 3:])
        turn = np.pi - (1e-3 if j % 2 else 0.0)
        Z[e, 3:] = _qmul(rel, _axis_angle(rng.standard_normal(3), turn))
    # negative w
    P[1::9, 3:] *= -1.0
    Z[2::11, 3:] *= -1.0
    ds.poses, ds.measurements = P, Z
    return ds


def k11_problem(device, poses: int = 120, loop_every: int = 7,
                loss: str = "default", policy=gtt.FP32_FP32,
                special: bool = True, prior: bool = True):
    """The frozen problem (see the module docstring); ``prior`` adds the
    ``se3_prior`` set."""
    ds = k11_dataset(poses, loop_every, special)
    fn, param = LOSSES[loss]
    g = gtt.Graph(precision=policy)
    vs = g.add_vertex_set(pg.SE3)
    vs.add_batch(ds.vertex_ids, ds.poses)
    between = factor_type("se3_between", 6, [pg.SE3, pg.SE3],
                          pg.se3_between_residual, obs_shape=(7,), loss=fn)
    fs = g.add_factor_set(between)
    n = len(ds.edges)
    fs.add_batch(ds.edges, obs=ds.measurements, precision=ds.information,
                 loss_params=None if param is None else np.full(n, param))
    vs.set_fixed(int(ds.vertex_ids[0]), True)
    if special:
        for h in range(3, n, 17):
            fs.set_active(h, 0x80)
    if prior:
        prior_type = factor_type("se3_prior", 6, [pg.SE3],
                                 pg.se3_prior_residual, obs_shape=(7,),
                                 loss=fn)
        ps = g.add_factor_set(prior_type)
        ids = ds.vertex_ids[::6]
        rng = np.random.default_rng(5)
        obs = ds.poses[::6].copy()
        # every other prior off its pose by a small motion
        obs[1::2, :3] += 0.05 * rng.standard_normal((len(obs[1::2]), 3))
        obs[1::2, 3:] = _qmul(obs[1::2, 3:], _axis_angle(
            rng.standard_normal((len(obs[1::2]), 3)),
            0.02 * rng.random(len(obs[1::2]))))
        info = np.eye(6)[None] * (1.0 + rng.random((len(ids), 1, 1)) * 1e3)
        ps.add_batch(ids[:, None], obs=obs, precision=info,
                     loss_params=(None if param is None
                                  else np.full(len(ids), param)))
        if special:
            ps.set_active(2, 0x80)
    return g.freeze(device=device)
