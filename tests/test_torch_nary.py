"""N-ary factors and irregular block sparsity in the port (counterpart of
``tests/test_nary.py``, BASELINE config 5): a 3-ary bundle-adjustment
factor, pose (6, SE3 retraction) + point (3) + one camera-intrinsics
vertex (3) shared by every factor (a dense Hessian row), and a 4-ary
factor. Each problem is built in both packages from the same seeded
NumPy draws, in float64 on the CPU:

- linearize: chi2, b and the diagonal equal the JAX package's to 1e-12;
- the block Hessian equals the JAX package's to 1e-10;
- 15 LM iterations with block-Jacobi PCG and with the dense Cholesky
  solver: the same accept pattern, chi2 per iteration to 1e-9, and the
  JAX test's own checks (chi2 below 5% of the initial; PCG and the direct
  solve agree to 1e-6);
- the 4-ary factor: b to 1e-12 and the direct LM down to chi2 ~ 0.
"""

import jax.numpy as jnp
import numpy as np
import torch

import graphite_tpu as gt
import graphite_tpu_torch as gtt
from graphite_tpu.hessian import build_hessian_structure as jax_hs
from graphite_tpu.hessian import compute_hessian_values as jax_hv
from graphite_tpu.hessian import hessian_to_dense as jax_dense
from graphite_tpu.linearize import linearize as jax_linearize
from graphite_tpu.models import lie as jax_lie
from graphite_tpu.optimizers import LevenbergMarquardtOptions as JaxOptions
from graphite_tpu.optimizers import levenberg_marquardt as jax_lm
from graphite_tpu.preconditioners import (
    BlockJacobiPreconditioner as JaxBlockJacobi,
)
from graphite_tpu.solvers import DenseCholeskySolver as JaxDense
from graphite_tpu.solvers import PCGSolver as JaxPCG
from graphite_tpu_torch.hessian import (
    build_hessian_structure,
    compute_hessian_values,
    hessian_to_dense,
)
from graphite_tpu_torch.linearize import linearize
from graphite_tpu_torch.models import lie
from graphite_tpu_torch.optimizers import (
    LevenbergMarquardtOptions,
    levenberg_marquardt,
)
from graphite_tpu_torch.preconditioners import BlockJacobiPreconditioner
from graphite_tpu_torch.solvers import DenseCholeskySolver, PCGSolver

torch.set_num_threads(1)


def _reproj3_jax(pose, point, intr, obs):
    Pc = jax_lie.quat_rotate(jax_lie.quat_conj(pose[3:7]), point - pose[:3])
    p = Pc[:2] / Pc[2]
    r2 = jnp.dot(p, p)
    d = 1.0 + intr[1] * r2 + intr[2] * r2 * r2
    return intr[0] * d * p - obs


def _reproj3_torch(pose, point, intr, obs):
    Pc = lie.quat_rotate(lie.quat_conj(pose[..., 3:7]),
                         point - pose[..., :3])
    p = Pc[..., :2] / Pc[..., 2:3]
    r2 = p[..., 0:1] * p[..., 0:1] + p[..., 1:2] * p[..., 1:2]
    d = 1.0 + intr[..., 1:2] * r2 + intr[..., 2:3] * r2 * r2
    return intr[..., 0:1] * d * p - obs


def _quad(a, b, c, d):
    return a + b + c + d


def _types(pkg, lie_mod, reproj):
    pose = pkg.vertex_type("nary_pose", 6, ambient_dim=7,
                           retract=lie_mod.se3_retract)
    point = pkg.vertex_type("nary_point", 3)
    intr = pkg.vertex_type("nary_intr", 3)
    return dict(
        pose=pose, point=point, intr=intr,
        reproj3=pkg.factor_type("reproj3", 2, [pose, point, intr], reproj,
                                obs_shape=(2,)),
        quad=pkg.factor_type("quad", 3, [point] * 4, _quad))


JAX_TYPES = _types(gt, jax_lie, _reproj3_jax)
TORCH_TYPES = _types(gtt, lie, _reproj3_torch)


def _make_problem(pkg, types, seed=0, n_poses=4, n_points=30, n_obs=120):
    """tests/test_nary.py's problem, built with ``pkg``."""
    rng = np.random.default_rng(seed)
    g = pkg.Graph(precision=pkg.FP64_FP64)
    poses = g.add_vertex_set(types["pose"])
    pts = g.add_vertex_set(types["point"])
    intr = g.add_vertex_set(types["intr"])
    pts_true = rng.normal(0, 0.5, (n_points, 3))
    intr_true = np.array([500.0, 1e-3, -1e-4])
    pose_params = []
    for i in range(n_poses):
        t = np.array([2 * np.cos(i), 2 * np.sin(i), 5.0])
        pose_params.append(np.concatenate([t, [0.0, 0.0, 0.0, 1.0]]))
        poses.add(i, pose_params[-1])
    for j in range(n_points):
        pts.add(1000 + j, pts_true[j] + rng.normal(0, 0.02, 3))
    intr.add(5000, intr_true * np.array([1.02, 1.0, 1.0]))
    fs = g.add_factor_set(types["reproj3"])
    for _ in range(n_obs):
        i = rng.integers(0, n_poses)
        j = rng.integers(0, n_points)
        Pc = pts_true[j] - pose_params[i][:3]
        p = Pc[:2] / Pc[2]
        r2 = p @ p
        d = 1.0 + intr_true[1] * r2 + intr_true[2] * r2 * r2
        fs.add([i, 1000 + j, 5000],
               obs=intr_true[0] * d * p + rng.normal(0, 0.3, 2))
    poses.set_fixed(0, True)
    return g


def _problems():
    return (_make_problem(gt, JAX_TYPES).freeze(),
            _make_problem(gtt, TORCH_TYPES).freeze(device="cpu"))


def test_nary_linearize_matches_jax():
    pj, pt = _problems()
    lj = jax_linearize(pj, pj.params0)
    lt = linearize(pt, pt.params0)
    np.testing.assert_allclose(float(lt.chi2), float(lj.chi2), rtol=1e-12)
    np.testing.assert_allclose(lt.b.numpy(), np.asarray(lj.b), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(lt.diag.numpy(), np.asarray(lj.diag),
                               rtol=1e-12, atol=1e-12)


def test_nary_hessian_matches_jax():
    pj, pt = _problems()
    lj = jax_linearize(pj, pj.params0)
    lt = linearize(pt, pt.params0)
    hs = build_hessian_structure(pt)
    # three block dims in one problem: 6 (pose), 3 (point and intrinsics)
    assert (6, 6) in hs.group_sizes and (3, 3) in hs.group_sizes
    Ht = hessian_to_dense(pt, hs, compute_hessian_values(pt, hs, lt))
    hsj = jax_hs(pj)
    Hj = jax_dense(pj, hsj, jax_hv(pj, hsj, lj))
    np.testing.assert_allclose(Ht, Hj, rtol=1e-10, atol=1e-11)


def _same_run(out, ref, rtol=1e-9):
    assert ([h["accepted"] for h in out.history]
            == [h["accepted"] for h in ref.history])
    np.testing.assert_allclose([h["chi2"] for h in out.history],
                               [h["chi2"] for h in ref.history], rtol=rtol)


def test_nary_lm_matches_jax():
    pj, pt = _problems()
    runs = {}
    for name, jsolver, tsolver in (
            ("pcg", JaxPCG(max_iter=100, tol=1e-12, rejection_ratio=1e6,
                           preconditioner=JaxBlockJacobi()),
             PCGSolver(max_iter=100, tol=1e-12, rejection_ratio=1e6,
                       preconditioner=BlockJacobiPreconditioner())),
            ("direct", JaxDense(), DenseCholeskySolver())):
        ref = jax_lm(pj, jsolver, options=JaxOptions(iterations=15,
                                                     initial_damping=1e-3))
        out = levenberg_marquardt(pt, tsolver,
                                  options=LevenbergMarquardtOptions(
                                      iterations=15, initial_damping=1e-3))
        _same_run(out, ref)
        runs[name] = out
    assert runs["pcg"].chi2 < 0.05 * runs["pcg"].initial_chi2
    np.testing.assert_allclose(runs["pcg"].chi2, runs["direct"].chi2,
                               rtol=1e-6)


def _quad_problem(pkg, types, device=None):
    rng = np.random.default_rng(1)
    g = pkg.Graph(precision=pkg.FP64_FP64)
    pts = g.add_vertex_set(types["point"])
    vals = rng.normal(0, 1, (8, 3))
    for i in range(8):
        pts.add(i, vals[i])
    fs = g.add_factor_set(types["quad"])
    for ids in ([0, 1, 2, 3], [2, 3, 4, 5], [4, 5, 6, 7]):
        fs.add(ids)
    return g.freeze() if device is None else g.freeze(device=device)


def test_quad_4ary_factor():
    pj = _quad_problem(gt, JAX_TYPES)
    pt = _quad_problem(gtt, TORCH_TYPES, device="cpu")
    lj = jax_linearize(pj, pj.params0)
    lt = linearize(pt, pt.params0)
    np.testing.assert_allclose(lt.b.numpy(), np.asarray(lj.b), rtol=1e-12,
                               atol=1e-13)
    res = levenberg_marquardt(pt, DenseCholeskySolver(),
                              options=LevenbergMarquardtOptions(
                                  iterations=20, initial_damping=1e-6))
    assert res.chi2 < 1e-12 * max(1.0, res.initial_chi2)
