"""Covariance recovery of the port vs the JAX package and vs a NumPy
oracle, on the CPU.

- The oracle (as ``tests/test_covariance.py``): the scaled dense H from
  the port's Hessian values (``hessian_to_dense``, float64), damped as the
  LM step damps it, inverted in NumPy and unscaled by the Jacobi column
  scales. Dense and Schur marginals and joint blocks match it to rtol
  1e-8 (atol 1e-12) under FP64_FP64 on the circle problem (5 points,
  circle + coupled factors) and on the toy and mini BA problems (both
  target types: the Schur path's pose solve and landmark
  back-substitution).
- Against the JAX package's ``joint_covariance`` on the same problems:
  1e-8 relative under FP64_FP64. Under FP32_FP32 the JAX package
  factors in float32 and the port in float64, so they differ by the JAX
  factor's error: 1e-3 of the largest entry (the tolerance ladder's
  float32 rung; measured on mini 1.3e-5 dense, 3.2e-5 Schur).
- ``method="auto"`` takes the Schur path where a type is eliminated; the
  errors and messages are the JAX package's (no targets, unknown type,
  fixed vertex, unknown method, Schur without an eliminated type).
"""

import numpy as np
import pytest
import torch

import graphite_tpu as gt
import graphite_tpu_torch as gtt
from graphite_tpu.covariance import joint_covariance as jax_joint
from graphite_tpu.io import bal as jax_bal
from graphite_tpu.io import synthetic as jax_synth
from graphite_tpu.linearize import linearize as jax_linearize
from graphite_tpu_torch.covariance import (
    joint_covariance,
    marginal_covariances,
)
from graphite_tpu_torch.hessian import (
    apply_damping,
    build_hessian_structure,
    compute_hessian_values,
    hessian_to_dense,
)
from graphite_tpu_torch.io import bal as torch_bal
from graphite_tpu_torch.io import synthetic as torch_synth
from graphite_tpu_torch.linearize import linearize

from common import COUPLED as JAX_COUPLED
from common import CIRCLE_AUTO as JAX_CIRCLE
from common import POINT2 as JAX_POINT2

torch.set_num_threads(1)

MU = 1e-2
POINT2 = gtt.vertex_type("point2", 2)
CIRCLE = gtt.factor_type(
    "circle_auto", 1, [POINT2],
    lambda p, obs: (p[..., 0] ** 2 + p[..., 1] ** 2 - obs ** 2)[..., None],
    obs_shape=())
COUPLED = gtt.factor_type(
    "coupled", 2, [POINT2],
    lambda p: torch.stack([p[..., 0] * p[..., 1],
                           p[..., 0] + 3.0 * p[..., 1]], dim=-1))
POINTS = [(2.0, 1.0), (-1.5, 2.5), (3.0, -0.5), (0.5, 3.5), (-2.0, -2.0)]


def _sigma_oracle(problem, lin, damping=0.0):
    """Dense NumPy Sigma = S inv(H_scaled) S over active columns."""
    hs = build_hessian_structure(problem)
    hv = compute_hessian_values(problem, hs, lin)
    if damping:
        hv = apply_damping(problem, hs, hv, lin.diag, damping, False)
    H = hessian_to_dense(problem, hs, hv)
    s = lin.scales.numpy().astype(np.float64)[: problem.dim_h]
    return s[:, None] * np.linalg.inv(H) * s[None, :]


def _cols(problem, targets):
    out = []
    for vname, gid in targets:
        local = problem.host_local_index(vname, gid)
        c0 = int(problem.host.vertex_col_offset[vname][local])
        out.extend(range(c0, c0 + problem.vertex_meta[vname].vtype.dim))
    return np.asarray(out)


def _circle(graph, point, factors, fixed=()):
    g = graph(precision=gt.FP64_FP64 if graph is gt.Graph
              else gtt.FP64_FP64)
    vs = g.add_vertex_set(point)
    for i, p in enumerate(POINTS):
        vs.add(10 + i, np.asarray(p))
    for gid in fixed:
        vs.set_fixed(gid, True)
    circle, coupled = factors
    fc, fk = g.add_factor_set(circle), g.add_factor_set(coupled)
    for i in range(len(POINTS)):
        fc.add([10 + i], obs=4.0)
        fk.add([10 + i])
    return g


def _circle_problem(fixed=()):
    return _circle(gtt.Graph, POINT2, (CIRCLE, COUPLED), fixed).freeze(
        device="cpu")


def _jax_circle_problem():
    return _circle(gt.Graph, JAX_POINT2, (JAX_CIRCLE, JAX_COUPLED)).freeze()


def _bal_problem(size, policy="FP64_FP64"):
    ds = torch_synth.make_bal(size, seed=0, noise=0.5)
    g, *_ = torch_bal.build_graph(ds, precision=getattr(gtt, policy))
    return g.freeze(device="cpu")


def _jax_bal_problem(size, policy="FP64_FP64"):
    ds = jax_synth.make_bal(size, seed=0, noise=0.5)
    g, *_ = jax_bal.build_graph(ds, precision=getattr(gt, policy))
    return g.freeze()


def _bal_targets(size):
    C = torch_synth.BAL_SIZES[size][0]
    return [("bal_camera", 0), ("bal_camera", 1), ("bal_point", C),
            ("bal_point", C + 2)]


CIRCLE_TARGETS = [("point2", 10), ("point2", 12), ("point2", 14)]


def test_dense_marginals_match_numpy_oracle():
    problem = _circle_problem()
    lin = linearize(problem, problem.params0)
    sig = _sigma_oracle(problem, lin)
    out = marginal_covariances(problem, lin, CIRCLE_TARGETS, method="dense")
    for t in CIRCLE_TARGETS:
        c = _cols(problem, [t])
        assert out[t].dtype == torch.float64 and out[t].shape == (2, 2)
        np.testing.assert_allclose(out[t].numpy(), sig[np.ix_(c, c)],
                                   rtol=1e-9, atol=1e-12)


def test_joint_covariance_cross_blocks():
    problem = _circle_problem()
    lin = linearize(problem, problem.params0)
    sig = _sigma_oracle(problem, lin)
    targets = [("point2", 11), ("point2", 13)]
    joint = joint_covariance(problem, lin, targets, method="dense").numpy()
    c = _cols(problem, targets)
    np.testing.assert_allclose(joint, sig[np.ix_(c, c)], rtol=1e-9,
                               atol=1e-12)
    np.testing.assert_array_equal(joint, joint.T)


@pytest.mark.parametrize("size", ["toy", "mini"])
def test_schur_matches_dense_and_oracle_on_ba(size):
    problem = _bal_problem(size)
    lin = linearize(problem, problem.params0)
    sig = _sigma_oracle(problem, lin, damping=MU)
    targets = _bal_targets(size)
    ref = sig[np.ix_(_cols(problem, targets), _cols(problem, targets))]
    for method in ("dense", "schur"):
        joint = joint_covariance(problem, lin, targets, method=method,
                                 damping=MU).numpy()
        np.testing.assert_allclose(joint, ref, rtol=1e-8, atol=1e-12)
    marg = marginal_covariances(problem, lin, targets, method="schur",
                                damping=MU)
    off = 0
    for t in targets:
        d = problem.vertex_meta[t[0]].vtype.dim
        np.testing.assert_allclose(marg[t].numpy(),
                                   ref[off:off + d, off:off + d],
                                   rtol=1e-8, atol=1e-12)
        off += d


def test_circle_matches_jax():
    problem, jp = _circle_problem(), _jax_circle_problem()
    out = joint_covariance(problem, linearize(problem, problem.params0),
                           CIRCLE_TARGETS, method="dense").numpy()
    ref = np.asarray(jax_joint(jp, jax_linearize(jp, jp.params0),
                               CIRCLE_TARGETS, method="dense"))
    np.testing.assert_allclose(out, ref, rtol=1e-8, atol=1e-12)


@pytest.mark.parametrize("policy,tol", [("FP64_FP64", 1e-8),
                                        ("FP32_FP32", 1e-3)])
@pytest.mark.parametrize("method", ["dense", "schur"])
@pytest.mark.parametrize("size", ["toy", "mini"])
def test_ba_matches_jax(size, method, policy, tol):
    problem = _bal_problem(size, policy)
    jp = _jax_bal_problem(size, policy)
    targets = _bal_targets(size)
    out = joint_covariance(problem, linearize(problem, problem.params0),
                           targets, method=method, damping=MU).numpy()
    ref = np.asarray(jax_joint(jp, jax_linearize(jp, jp.params0), targets,
                               method=method, damping=MU), dtype=np.float64)
    assert out.dtype == np.float64
    if policy == "FP64_FP64":
        np.testing.assert_allclose(out, ref, rtol=tol, atol=1e-12)
    else:
        assert np.abs(out - ref).max() <= tol * np.abs(ref).max()


def test_auto_method_selection():
    ba = _bal_problem("toy")
    lin = linearize(ba, ba.params0)
    a = joint_covariance(ba, lin, [("bal_camera", 0)], damping=MU)
    b = joint_covariance(ba, lin, [("bal_camera", 0)], method="schur",
                         damping=MU)
    assert torch.equal(a, b)

    circle = _circle_problem()
    lin_c = linearize(circle, circle.params0)
    assert torch.equal(
        joint_covariance(circle, lin_c, [("point2", 10)]),
        joint_covariance(circle, lin_c, [("point2", 10)], method="dense"))
    with pytest.raises(ValueError, match="eliminated"):
        joint_covariance(circle, lin_c, [("point2", 10)], method="schur")


def test_errors():
    problem = _circle_problem(fixed=(10,))
    lin = linearize(problem, problem.params0)
    with pytest.raises(ValueError, match="fixed or inactive"):
        marginal_covariances(problem, lin, [("point2", 10)])
    with pytest.raises(KeyError, match="unknown vertex type"):
        joint_covariance(problem, lin, [("nope", 0)])
    with pytest.raises(ValueError, match="unknown method"):
        joint_covariance(problem, lin, [("point2", 11)], method="qr")
    with pytest.raises(ValueError, match="no targets"):
        joint_covariance(problem, lin, [])
    out = marginal_covariances(problem, lin, [("point2", 11)])
    assert out[("point2", 11)].shape == (2, 2)
    assert bool(torch.isfinite(out[("point2", 11)]).all())
