"""BAL dataset text format: parser and graph builder (counterpart of
``graphite_tpu/io/bal.py``): ``load``, ``save`` and ``build_graph``.
``load`` parses with the host library ``native/bal_loader.cpp`` and takes
the NumPy parser where that one does not take the file (a compressed
one, or one it cannot parse), as the JAX package does. The format
(https://grail.cs.washington.edu/projects/bal/):

    num_cameras num_points num_observations
    cam_idx point_idx x y            (x num_observations)
    <9 camera params, one per line>   (x num_cameras)
    <3 point params, one per line>    (x num_points)
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..graph import Graph
from ..models import bal as bal_model
from ..native import bal_loader
from ..precision import FP32_FP32


@dataclasses.dataclass
class BALDataset:
    cameras: np.ndarray  # (C, 9)
    points: np.ndarray  # (P, 3)
    cam_idx: np.ndarray  # (O,)
    point_idx: np.ndarray  # (O,)
    observations: np.ndarray  # (O, 2)

    @property
    def num_cameras(self):
        return self.cameras.shape[0]

    @property
    def num_points(self):
        return self.points.shape[0]

    @property
    def num_observations(self):
        return self.observations.shape[0]


def _open(path: str):
    if path.endswith(".gz"):
        import gzip

        return gzip.open(path, "rt")
    if path.endswith(".bz2"):
        import bz2

        return bz2.open(path, "rt")
    return open(path, "r")


def load(path: str) -> BALDataset:
    """Parse a BAL problem file (optionally .gz / .bz2)."""
    parsed = bal_loader.load(path)
    if parsed is not None:
        return BALDataset(*parsed)
    return load_numpy(path)


def load_numpy(path: str) -> BALDataset:
    """The NumPy parser: ``load``'s plain version, and its branch for the
    files the native parser does not take."""
    with _open(path) as f:
        header = f.readline().split()
        n_cam, n_pt, n_obs = int(header[0]), int(header[1]), int(header[2])
        obs_rows = np.loadtxt(f, max_rows=n_obs).reshape(n_obs, 4)
        rest = np.loadtxt(f)
    cam_idx = obs_rows[:, 0].astype(np.int64)
    point_idx = obs_rows[:, 1].astype(np.int64)
    observations = obs_rows[:, 2:4].astype(np.float64)
    rest = rest.reshape(-1)
    cameras = rest[: n_cam * 9].reshape(n_cam, 9)
    points = rest[n_cam * 9: n_cam * 9 + n_pt * 3].reshape(n_pt, 3)
    return BALDataset(cameras, points, cam_idx, point_idx, observations)


def save(path: str, ds: BALDataset) -> None:
    """Write ``ds`` in the BAL text format (values to 17 digits, so that
    ``load`` reads them back exactly)."""
    with open(path, "w") as f:
        f.write(f"{ds.num_cameras} {ds.num_points} {ds.num_observations}\n")
        for c, p, (x, y) in zip(ds.cam_idx, ds.point_idx, ds.observations):
            f.write(f"{c} {p} {x:.16e} {y:.16e}\n")
        for v in np.concatenate([ds.cameras.reshape(-1),
                                 ds.points.reshape(-1)]):
            f.write(f"{v:.16e}\n")


def build_graph(ds: BALDataset, precision=None,
                eliminate_points: bool = True, loss=None,
                loss_param: Optional[float] = None, factor=None):
    """Build a Graph for a BAL dataset; returns (graph, cameras, points,
    factors). ``factor``: the reprojection factor type (default
    ``models.bal.REPROJECTION``, analytic; ``REPROJECTION_AUTO`` is
    differentiated automatically).

    Camera ids are [0, C) and point ids [C, C+P); ``eliminate_points``
    marks the points for Schur elimination. Observations are added in
    (point, camera) order, so the per-point reduction destinations (point
    Hessian blocks, Hpl blocks, Schur attach lists) come out sorted; the
    factors then do NOT follow dataset row order: factor ``i`` is dataset
    row ``fs.input_order[i]``.
    """
    g = Graph(precision=precision or FP32_FP32)
    cams = g.add_vertex_set(bal_model.CAMERA)
    pts = g.add_vertex_set(bal_model.POINT)
    cams.add_batch(np.arange(ds.num_cameras), ds.cameras)
    pts.add_batch(ds.num_cameras + np.arange(ds.num_points), ds.points)
    if eliminate_points:
        pts.set_eliminate(True)

    ftype = factor if factor is not None else bal_model.REPROJECTION
    if loss is not None:
        ftype = dataclasses.replace(ftype, loss=loss)
    fs = g.add_factor_set(ftype)
    order = np.lexsort((ds.cam_idx, ds.point_idx))
    ids = np.stack(
        [ds.cam_idx[order], ds.num_cameras + ds.point_idx[order]], axis=1
    )
    fs.add_batch(
        ids, obs=ds.observations[order],
        loss_params=(None if loss_param is None
                     else np.full(ds.num_observations, loss_param)),
    )
    fs.input_order = order
    return g, cams, pts, fs
