"""Dynamic (storage-free) Jacobian mode of the port, float64 on the CPU,
the cases of ``tests/test_dynamic_jacobians.py``: a factor set with
``set_jacobian_storage(False)`` stores no J; ``Jv``, ``JtPv`` and
``hessian_matvec`` recompute it from ``params`` (to 1e-11 of the stored
products and of the JAX package's dynamic ones), raise a ``ValueError``
naming "dynamic" without ``params``, and LM with PCG converges as the JAX
package's does."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from graphite_tpu.linearize import hessian_matvec as jax_hessian_matvec
from graphite_tpu.linearize import linearize as jax_linearize
from graphite_tpu.optimizers import LevenbergMarquardtOptions as JaxOptions
from graphite_tpu.optimizers import levenberg_marquardt as jax_lm
from graphite_tpu.preconditioners import IdentityPreconditioner as JaxIdentity
from graphite_tpu.solvers import PCGSolver as JaxPCG
import graphite_tpu_torch as gtt
from graphite_tpu_torch.examples import circle
from graphite_tpu_torch.linearize import (
    JtPv,
    Jv,
    hessian_matvec,
    linearize,
)
from graphite_tpu_torch.optimizers import (
    LevenbergMarquardtOptions,
    levenberg_marquardt,
)
from graphite_tpu_torch.preconditioners import (
    BlockJacobiPreconditioner,
    IdentityPreconditioner,
)
from graphite_tpu_torch.solvers import PCGSolver

from common import build_circle_graph

torch.set_num_threads(1)

RNG = np.random.default_rng(42)
ANGLES = RNG.uniform(0, 2 * np.pi, size=5)
PTS = np.stack([4.0 * np.cos(ANGLES) + RNG.normal(0, 0.3, 5),
                4.0 * np.sin(ANGLES) + RNG.normal(0, 0.3, 5)], axis=1)


def _problem(dynamic, manual=False):
    g = gtt.Graph(precision=gtt.FP64_FP64)
    vs = g.add_vertex_set(circle.POINT2)
    for i, p in enumerate(PTS):
        vs.add(10 + i, p)
    vs.set_fixed(14, True)
    fs = g.add_factor_set(circle.circle_factor(auto_diff=not manual))
    for i in range(len(PTS)):
        fs.add([10 + i], obs=4.0)
    fs.set_jacobian_storage(not dynamic)
    problem = g.freeze(device="cpu")
    assert problem.factor_meta["circle"].store_jacobians is (not dynamic)
    return problem


def _jax_problem(dynamic):
    g, _, fs, _ = build_circle_graph(PTS, fixed_ids=(14,))
    fs.set_jacobian_storage(not dynamic)
    return g.freeze()


@pytest.mark.parametrize("manual", [False, True])
def test_dynamic_matvec_matches_stored(manual):
    ps, pd = _problem(False, manual), _problem(True, manual)
    lin_s = linearize(ps, ps.params0)
    lin_d = linearize(pd, pd.params0)
    assert lin_d.jacobians["circle"] is None
    assert torch.equal(lin_d.b, lin_s.b)
    x = torch.tensor(np.random.default_rng(0).normal(size=ps.dim_x))
    y_s = hessian_matvec(ps, lin_s, x)
    y_d = hessian_matvec(pd, lin_d, x, params=pd.params0)
    np.testing.assert_allclose(y_d.numpy(), y_s.numpy(), rtol=1e-11,
                               atol=1e-13)
    v_s, v_d = Jv(ps, lin_s, x), Jv(pd, lin_d, x, params=pd.params0)
    np.testing.assert_allclose(v_d["circle"].numpy(), v_s["circle"].numpy(),
                               rtol=1e-11, atol=1e-13)
    np.testing.assert_allclose(
        JtPv(pd, lin_d, v_d, params=pd.params0).numpy(),
        JtPv(ps, lin_s, v_s).numpy(), rtol=1e-11, atol=1e-13)

    pj = _jax_problem(True)
    lin_j = jax_linearize(pj, pj.params0)
    y_j = jax_hessian_matvec(pj, lin_j, jnp.asarray(x.numpy()),
                             params=pj.params0)
    np.testing.assert_allclose(y_d.numpy(), np.asarray(y_j), rtol=1e-11,
                               atol=1e-13)


def test_dynamic_matvec_requires_params():
    pd = _problem(True)
    lin_d = linearize(pd, pd.params0)
    x = torch.zeros(pd.dim_x, dtype=torch.float64)
    for fn in (lambda: hessian_matvec(pd, lin_d, x),
               lambda: Jv(pd, lin_d, x),
               lambda: JtPv(pd, lin_d, {"circle": torch.zeros(5, 1)})):
        with pytest.raises(ValueError, match="dynamic"):
            fn()
    with pytest.raises(ValueError, match="dynamic"):
        BlockJacobiPreconditioner().prepare(pd, lin_d, pd.params0)


@pytest.mark.parametrize("jit_loop", [False, True])
def test_dynamic_lm_converges(jit_loop):
    pd = _problem(True)
    opts = dict(iterations=60, initial_damping=1e-6, jit_loop=jit_loop)
    res = levenberg_marquardt(
        pd, PCGSolver(50, 1e-20, 10.0, IdentityPreconditioner()),
        options=LevenbergMarquardtOptions(**opts))
    assert res.chi2 < res.initial_chi2
    r = np.sqrt((res.params["point2"][:4].numpy() ** 2).sum(axis=1))
    np.testing.assert_allclose(r, 4.0, rtol=1e-6)
    ref = jax_lm(_jax_problem(True), JaxPCG(50, 1e-20, 10.0, JaxIdentity()),
                 options=JaxOptions(**opts))
    np.testing.assert_allclose(res.initial_chi2, ref.initial_chi2,
                               rtol=1e-9)
    np.testing.assert_allclose(res.chi2, ref.chi2, rtol=1e-9,
                               atol=1e-9 * ref.initial_chi2)
