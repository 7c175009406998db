"""The port's pose-graph slice vs the JAX package, on the CPU.

- The synthetic pose generators give bitwise the same arrays for a seed.
- g2o: ``save`` writes the same text, ``load`` parses the same arrays
  (incl. TORO ``VERTEX2`` / ``EDGE2`` and ``FIX``), and a round trip keeps
  the data to 1e-10.
- float64, each package on its own frozen problem: ``linearize`` with AUTO
  Jacobians (residuals, Jacobians, b, diag, scales, chi2), ``Jv`` /
  ``JtPv`` / ``hessian_matvec``, the block-Jacobi blocks, their damped
  inverses and ``apply``, all to 1e-12 relative to the largest entry;
  ``PCGSolver.solve`` on its generic branch against the JAX package's XLA
  branch to 1e-10.
- float64 Levenberg-Marquardt with PCGSolver(50, 1e-10, 1e6, block-Jacobi)
  from the same NumPy parameters (``interop.params_from_numpy``): the same
  accept pattern and chi2 per iteration to 1e-9. SE2 stops at 5
  iterations: by the 6th its gains are at the rounding level of chi2, so
  the accept decision would compare rounding noise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphite_tpu as gt
import graphite_tpu_torch as gtt
from graphite_tpu.linearize import JtPv as jax_JtPv
from graphite_tpu.linearize import Jv as jax_Jv
from graphite_tpu.linearize import hessian_matvec as jax_hessian_matvec
from graphite_tpu.linearize import linearize as jax_linearize
from graphite_tpu.io import g2o as jg2o
from graphite_tpu.io import synthetic as jsyn
from graphite_tpu.optimizers import LevenbergMarquardtOptions as JaxOptions
from graphite_tpu.optimizers import levenberg_marquardt as jax_lm
from graphite_tpu.preconditioners import (
    BlockJacobiPreconditioner as JaxBlockJacobi,
)
from graphite_tpu.preconditioners import IdentityPreconditioner as JaxIdentity
from graphite_tpu.preconditioners.block_jacobi import (
    compute_block_diagonal as jax_block_diagonal,
)
from graphite_tpu.solvers import PCGSolver as JaxPCGSolver
from graphite_tpu_torch.interop import params_from_numpy
from graphite_tpu_torch.linearize import JtPv, Jv, hessian_matvec, linearize
from graphite_tpu_torch.io import g2o as tg2o
from graphite_tpu_torch.io import synthetic as tsyn
from graphite_tpu_torch.optimizers import (
    LevenbergMarquardtOptions,
    levenberg_marquardt,
)
from graphite_tpu_torch.preconditioners import (
    BlockJacobiPreconditioner,
    IdentityPreconditioner,
)
from graphite_tpu_torch.preconditioners.block_jacobi import (
    compute_block_diagonal,
)
from graphite_tpu_torch.solvers import PCGSolver

torch.set_num_threads(1)

DATASETS = {
    "se2": lambda m: m.make_pose_graph_2d(60, seed=0),
    "se3": lambda m: m.make_sphere_se3(120, seed=0, loop_every=7),
    "se2-prior": lambda m: m.make_pose_graph_2d(30, seed=3),
}


def _close(out, ref, tol):
    ref = np.asarray(ref)
    out = out.numpy() if torch.is_tensor(out) else np.asarray(out)
    assert out.shape == ref.shape
    assert np.abs(out - ref).max() <= tol * max(np.abs(ref).max(), 1e-300)


def _problems(kind):
    kw = ({"prior_information": np.eye(3) * 1e6} if kind.endswith("prior")
          else {})
    gj, *_ = jg2o.build_graph(DATASETS[kind](jsyn), precision=gt.FP64_FP64,
                              **kw)
    gp, *_ = tg2o.build_graph(DATASETS[kind](tsyn), precision=gtt.FP64_FP64,
                              **kw)
    return gj.freeze(), gp.freeze(device="cpu")


def _linearized(kind):
    pj, pp = _problems(kind)
    return pj, pp, jax_linearize(pj, pj.params0), linearize(pp, pp.params0)


@pytest.mark.parametrize("make,args", [
    ("make_pose_graph_2d", (60, 0)), ("make_pose_graph_2d", (100, 3, )),
    ("make_sphere_se3", (120, 0)), ("make_sphere_se3", (2500, 0)),
])
def test_generators_identical(make, args):
    a = getattr(jsyn, make)(*args)
    b = getattr(tsyn, make)(*args)
    assert a.kind == b.kind
    for field in ("vertex_ids", "poses", "edges", "measurements",
                  "information", "fixed_ids"):
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field))


@pytest.mark.parametrize("kind", ["se2", "se3"])
def test_g2o_save_load_match_jax(tmp_path, kind):
    ds = DATASETS[kind](jsyn)
    ds.fixed_ids = np.asarray([0, 5])
    pj, pt = tmp_path / "jax.g2o", tmp_path / "torch.g2o"
    jg2o.save(str(pj), ds)
    tg2o.save(str(pt), DATASETS[kind](tsyn).__class__(**vars(ds)))
    assert pj.read_text() == pt.read_text()
    a, b = jg2o.load(str(pj)), tg2o.load(str(pj))
    assert a.kind == b.kind == ds.kind
    for field in ("vertex_ids", "poses", "edges", "measurements",
                  "information", "fixed_ids"):
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field))
        np.testing.assert_allclose(getattr(b, field), getattr(ds, field),
                                   rtol=1e-10)


TORO = """# TORO legacy tokens
VERTEX2 0 0.0 0.0 0.0
VERTEX2 1 1.0 0.1 0.05
VERTEX2 2 2.1 0.0 -0.1
EDGE2 0 1 1.0 0.0 0.0 100.0 1.0 90.0 400.0 2.0 3.0
EDGE2 1 2 1.1 -0.1 -0.15 50.0 0.5 60.0 300.0 1.5 2.5
EDGE2 2 0 -2.0 0.1 0.1 80.0 0.0 80.0 200.0 0.0 0.0
FIX 1
"""


def test_g2o_toro_and_fix_match_jax(tmp_path):
    path = tmp_path / "toro.g2o"
    path.write_text(TORO)
    a, b = jg2o.load(str(path)), tg2o.load(str(path))
    assert a.kind == b.kind == "se2"
    for field in ("vertex_ids", "poses", "edges", "measurements",
                  "information", "fixed_ids"):
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field))
    # I_xx I_xy I_yy I_tt I_xt I_yt
    np.testing.assert_array_equal(
        b.information[0], [[100.0, 1.0, 2.0], [1.0, 90.0, 3.0],
                           [2.0, 3.0, 400.0]])
    gj, *_ = jg2o.build_graph(a)
    gp, vs, _, prior = tg2o.build_graph(b)
    assert prior is None and vs.fixed_array().tolist() == [False, True,
                                                           False]
    pj, pp = gj.freeze(), gp.freeze(device="cpu")
    for name in pp.host.vertex_fixed:
        np.testing.assert_array_equal(pp.host.vertex_fixed[name],
                                      pj.host.vertex_fixed[name])
        np.testing.assert_array_equal(pp.host.vertex_col_offset[name],
                                      pj.host.vertex_col_offset[name])


@pytest.mark.parametrize("kind", sorted(DATASETS))
def test_linearize_auto_matches_jax(kind):
    pj, pp, lj, lp = _linearized(kind)
    assert lp.jacobians.keys() == lj.jacobians.keys()
    for name in lj.jacobians:
        _close(lp.residuals[name], lj.residuals[name], 1e-12)
        for Jp, Jj in zip(lp.jacobians[name], lj.jacobians[name]):
            _close(Jp, Jj, 1e-12)
        _close(lp.chi2_deriv[name], lj.chi2_deriv[name], 1e-12)
    for field in ("b", "diag", "scales", "chi2"):
        _close(getattr(lp, field), getattr(lj, field), 1e-12)


@pytest.mark.parametrize("kind", sorted(DATASETS))
def test_matvecs_match_jax(kind):
    pj, pp, lj, lp = _linearized(kind)
    x = np.random.default_rng(1).normal(size=pp.dim_x)
    x[pp.dim_h:] = 0.0
    xt = torch.tensor(x)
    vj, vp = jax_Jv(pj, lj, jnp.asarray(x)), Jv(pp, lp, xt)
    for name in vj:
        _close(vp[name], vj[name], 1e-12)
    _close(JtPv(pp, lp, {k: torch.tensor(np.asarray(v))
                         for k, v in vj.items()}),
           jax_JtPv(pj, lj, vj), 1e-12)
    _close(hessian_matvec(pp, lp, xt),
           jax_hessian_matvec(pj, lj, jnp.asarray(x)), 1e-12)


@pytest.mark.parametrize("kind", sorted(DATASETS))
@pytest.mark.parametrize("use_identity", [False, True])
def test_block_jacobi_matches_jax(kind, use_identity):
    pj, pp, lj, lp = _linearized(kind)
    bj, bp = jax_block_diagonal(pj, lj), compute_block_diagonal(pp, lp)
    for name in bj:
        _close(bp[name], bj[name], 1e-12)
    mu = 1e-3
    jpre, ppre = JaxBlockJacobi(), BlockJacobiPreconditioner()
    sj = jpre.set_damping(pj, lj, jpre.prepare(pj, lj), jnp.float64(mu),
                          use_identity)
    sp = ppre.set_damping(pp, lp, ppre.prepare(pp, lp),
                          torch.tensor(mu, dtype=torch.float64),
                          use_identity)
    for name in sj.inv_blocks:
        _close(sp.inv_blocks[name], sj.inv_blocks[name], 1e-12)
    r = np.random.default_rng(2).normal(size=pp.dim_x)
    _close(ppre.apply(pp, lp, sp, torch.tensor(r)),
           jpre.apply(pj, lj, sj, jnp.asarray(r)), 1e-12)


@pytest.mark.parametrize("kind,precond", [("se2", "bj"), ("se3", "bj"),
                                          ("se3", "identity"),
                                          ("se2-prior", "bj")])
def test_pcg_solver_generic_matches_jax(kind, precond):
    pj, pp, lj, lp = _linearized(kind)
    sj = JaxPCGSolver(50, 1e-10, 1e6, JaxBlockJacobi() if precond == "bj"
                      else JaxIdentity())
    sp = PCGSolver(50, 1e-10, 1e6, BlockJacobiPreconditioner()
                   if precond == "bj" else IdentityPreconditioner())
    xj, _ = sj.solve(pj, lj, sj.prepare(pj, lj), jnp.float64(1e-3), False)
    xp, ok = sp.solve(pp, lp, sp.prepare(pp, lp), 1e-3, False)
    assert bool(ok)
    _close(xp, xj, 1e-10)


@pytest.mark.parametrize("kind,iterations", [("se2", 5), ("se3", 10)])
def test_lm_matches_jax_f64(kind, iterations):
    pj, pp = _problems(kind)
    ref = jax_lm(pj, JaxPCGSolver(50, 1e-10, 1e6, JaxBlockJacobi()),
                 options=JaxOptions(iterations=iterations,
                                    initial_damping=1e-4))
    out = levenberg_marquardt(
        pp, PCGSolver(50, 1e-10, 1e6, BlockJacobiPreconditioner()),
        params_from_numpy({k: np.asarray(v) for k, v in pj.params0.items()},
                          device="cpu"),
        options=LevenbergMarquardtOptions(iterations=iterations,
                                          initial_damping=1e-4))
    assert len(out.history) == len(ref.history) == iterations
    assert ([h["accepted"] for h in out.history]
            == [h["accepted"] for h in ref.history])
    np.testing.assert_allclose([h["chi2"] for h in out.history],
                               [h["chi2"] for h in ref.history], rtol=1e-9)
    np.testing.assert_allclose(out.initial_chi2, ref.initial_chi2, rtol=1e-9)
    assert out.chi2 < 0.01 * out.initial_chi2
    if kind == "se3":
        q = out.params["se3_pose"][:, 3:].numpy()
        np.testing.assert_allclose(np.linalg.norm(q, axis=1), 1.0,
                                   rtol=1e-12)
