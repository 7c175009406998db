"""g2o pose-graph files: ``load``, ``save`` and ``build_graph`` (NumPy copy
of ``graphite_tpu/io/g2o.py``; ``build_graph`` builds this package's
``Graph``).

Tokens: VERTEX_SE2 / EDGE_SE2, VERTEX_SE3:QUAT / EDGE_SE3:QUAT (sphere2500
et al.), the ``FIX`` gauge tag, and the legacy TORO tokens VERTEX2 /
EDGE2. Edge information matrices become per-factor ``precision``
matrices.

Information-matrix orderings:

- g2o EDGE_SE2 / EDGE_SE3:QUAT store the upper triangle row-major:
  ``I00 I01 I02 I11 I12 I22`` (6 values) / 21 values for 6x6, the
  ``numpy.triu_indices`` order.
- TORO EDGE2 stores ``I_xx I_xy I_yy I_tt I_xt I_yt``: the (1,1) / (2,2)
  entries come before the (0,2) / (1,2) entries.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..graph import Graph
from ..models import pose_graph as pg
from ..precision import FP32_FP32


@dataclasses.dataclass
class PoseGraphDataset:
    kind: str  # "se2" | "se3"
    vertex_ids: np.ndarray  # (V,)
    poses: np.ndarray  # (V, 3) or (V, 7)
    edges: np.ndarray  # (E, 2) vertex ids
    measurements: np.ndarray  # (E, 3) or (E, 7)
    information: np.ndarray  # (E, D, D) with D = 3 or 6
    fixed_ids: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, dtype=np.int64)
    )  # vertices pinned by FIX lines

    @property
    def num_vertices(self):
        return self.poses.shape[0]

    @property
    def num_edges(self):
        return self.edges.shape[0]


def _tri_to_full(vals, d):
    info = np.zeros((d, d))
    iu = np.triu_indices(d)
    info[iu] = vals
    info.T[iu] = vals
    return info


def _full_to_tri(info):
    return info[np.triu_indices(info.shape[0])]


def _toro_edge2_info(vals):
    """TORO EDGE2 information: I_xx I_xy I_yy I_tt I_xt I_yt."""
    xx, xy, yy, tt, xt, yt = vals
    return np.array([[xx, xy, xt], [xy, yy, yt], [xt, yt, tt]])


def load(path: str) -> PoseGraphDataset:
    vertex_ids, poses, edges, meas, infos, fixed = [], [], [], [], [], []
    kind = None
    with open(path) as f:
        for line in f:
            tok = line.split()
            if not tok or tok[0].startswith("#"):
                continue
            tag = tok[0]
            if tag in ("VERTEX_SE2", "VERTEX2"):
                kind = kind or "se2"
                vertex_ids.append(int(tok[1]))
                poses.append([float(x) for x in tok[2:5]])
            elif tag == "VERTEX_SE3:QUAT":
                kind = kind or "se3"
                vertex_ids.append(int(tok[1]))
                poses.append([float(x) for x in tok[2:9]])
            elif tag == "EDGE_SE2":
                edges.append((int(tok[1]), int(tok[2])))
                meas.append([float(x) for x in tok[3:6]])
                infos.append(_tri_to_full([float(x) for x in tok[6:12]], 3))
            elif tag == "EDGE2":
                # TORO: the same measurement layout, another information
                # ordering (module docstring)
                edges.append((int(tok[1]), int(tok[2])))
                meas.append([float(x) for x in tok[3:6]])
                infos.append(_toro_edge2_info([float(x) for x in tok[6:12]]))
            elif tag == "EDGE_SE3:QUAT":
                edges.append((int(tok[1]), int(tok[2])))
                meas.append([float(x) for x in tok[3:10]])
                infos.append(_tri_to_full([float(x) for x in tok[10:31]], 6))
            elif tag == "FIX":
                fixed.extend(int(x) for x in tok[1:])
    if kind is None:
        raise ValueError(f"no supported g2o vertices in {path}")
    return PoseGraphDataset(
        kind=kind,
        vertex_ids=np.asarray(vertex_ids, dtype=np.int64),
        poses=np.asarray(poses, dtype=np.float64),
        edges=np.asarray(edges, dtype=np.int64),
        measurements=np.asarray(meas, dtype=np.float64),
        information=np.stack(infos) if infos else np.zeros((0, 3, 3)),
        fixed_ids=np.asarray(sorted(set(fixed)), dtype=np.int64),
    )


def save(path: str, ds: PoseGraphDataset) -> None:
    with open(path, "w") as f:
        for vid in np.asarray(ds.fixed_ids).reshape(-1):
            f.write(f"FIX {int(vid)}\n")
        if ds.kind == "se2":
            for vid, p in zip(ds.vertex_ids, ds.poses):
                f.write(f"VERTEX_SE2 {vid} {p[0]:.12g} {p[1]:.12g} "
                        f"{p[2]:.12g}\n")
            for (i, j), m, info in zip(ds.edges, ds.measurements,
                                       ds.information):
                tri = " ".join(f"{x:.12g}" for x in _full_to_tri(info))
                f.write(f"EDGE_SE2 {i} {j} {m[0]:.12g} {m[1]:.12g} "
                        f"{m[2]:.12g} {tri}\n")
        else:
            for vid, p in zip(ds.vertex_ids, ds.poses):
                vals = " ".join(f"{x:.12g}" for x in p)
                f.write(f"VERTEX_SE3:QUAT {vid} {vals}\n")
            for (i, j), m, info in zip(ds.edges, ds.measurements,
                                       ds.information):
                mv = " ".join(f"{x:.12g}" for x in m)
                tri = " ".join(f"{x:.12g}" for x in _full_to_tri(info))
                f.write(f"EDGE_SE3:QUAT {i} {j} {mv} {tri}\n")


def build_graph(ds: PoseGraphDataset, precision=None, fix_first: bool = True,
                prior_information: Optional[np.ndarray] = None):
    """Build a Graph from a pose-graph dataset; returns (graph, poses,
    between factors, prior factors or None).

    The gauge is fixed by the file's own ``FIX`` lines when present, else
    by fixing the first pose (``fix_first=True``, the usual g2o approach)
    or by a prior factor on it when ``prior_information`` is given.
    """
    g = Graph(precision=precision or FP32_FP32)
    if ds.kind == "se2":
        vtype, between, prior = pg.SE2, pg.SE2_BETWEEN, pg.SE2_PRIOR
    else:
        vtype, between, prior = pg.SE3, pg.SE3_BETWEEN, pg.SE3_PRIOR

    vs = g.add_vertex_set(vtype)
    vs.add_batch(ds.vertex_ids, ds.poses)
    fs = g.add_factor_set(between)
    fs.add_batch(ds.edges, obs=ds.measurements, precision=ds.information)

    prior_set = None
    first_id = int(ds.vertex_ids[0])
    if ds.fixed_ids.size:
        for vid in ds.fixed_ids:
            vs.set_fixed(int(vid), True)
    elif prior_information is not None:
        prior_set = g.add_factor_set(prior)
        prior_set.add_batch([[first_id]], obs=ds.poses[:1],
                            precision=np.asarray(prior_information)[None])
    elif fix_first:
        vs.set_fixed(first_id, True)
    return g, vs, fs, prior_set
