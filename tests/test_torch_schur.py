"""Schur complement of the PyTorch port vs the JAX package: dense S,
b_schur, landmark_update and compose_delta on the same damped Hessian,
float64, to 1e-12 relative to each array's largest entry.

Fixtures: a BAL problem, the two multi-type fixtures of the JAX
package's ``test_schur_multitype.py`` (two pose types with two landmark
dims; and equal pose / landmark dims, whose mixed (3, 3) Hessian group
makes the triple products' right-operand indices go through
``hpl_h_idx``), and factors with per-factor precision matrices. The JAX side differentiates those factors with jacfwd;
the port gets the same Jacobians written out by hand."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphite_tpu as gt
import graphite_tpu_torch as gtt
from graphite_tpu import hessian as jax_hessian
from graphite_tpu import schur as jax_schur
from graphite_tpu.io import synthetic
from graphite_tpu.io.bal import build_graph as jax_build_graph
from graphite_tpu.linearize import linearize as jax_linearize
from graphite_tpu.solvers.dense_cholesky_schur import (
    schur_to_dense as jax_schur_to_dense,
)
from graphite_tpu_torch import hessian as torch_hessian
from graphite_tpu_torch import schur as torch_schur
from graphite_tpu_torch.interop import params_from_numpy
from graphite_tpu_torch.io import bal as torch_bal_io
from graphite_tpu_torch.linearize import linearize as torch_linearize
from graphite_tpu_torch.solvers.dense_cholesky_schur import (
    schur_to_dense as torch_schur_to_dense,
)

torch.set_num_threads(1)

TOL = 1e-12
MU = 1e-2


def _close(a, b, tol=TOL):
    a, b = np.asarray(a), np.asarray(b)
    scale = max(1.0, float(np.abs(b).max(initial=0.0)))
    np.testing.assert_allclose(a, b, rtol=tol, atol=tol * scale)


# ---- fixtures ---------------------------------------------------------------

def _bal():
    ds = synthetic.make_bal((12, 120, 700), seed=2, noise=0.5)
    gj, *_ = jax_build_graph(ds, precision=gt.FP64_FP64)
    gp, *_ = torch_bal_io.build_graph(ds, precision=gtt.FP64_FP64)
    return gj, gp


def _stack(*cols):
    return torch.stack(cols, dim=-1)


def _rows(*rows):
    return torch.stack(rows, dim=-2)


# (residual for JAX, residual for torch, analytic Jacobians for torch)
FACTORS = {
    "f43": (
        lambda p, l, o: jnp.array([p[0] * l[0] + p[1] - o[0],
                                   p[2] * l[1] + p[3] * l[2] - o[1]]),
        lambda p, l, o: _stack(p[..., 0] * l[..., 0] + p[..., 1] - o[..., 0],
                               p[..., 2] * l[..., 1] + p[..., 3] * l[..., 2]
                               - o[..., 1]),
        lambda p, l, o: (
            _rows(_stack(l[..., 0], torch.ones_like(l[..., 0]),
                         0 * l[..., 0], 0 * l[..., 0]),
                  _stack(0 * l[..., 0], 0 * l[..., 0], l[..., 1], l[..., 2])),
            _rows(_stack(p[..., 0], 0 * p[..., 0], 0 * p[..., 0]),
                  _stack(0 * p[..., 0], p[..., 2], p[..., 3]))),
    ),
    "f41": (
        lambda p, l, o: jnp.array([p[0] + p[3] * l[0] - o[0]]),
        lambda p, l, o: _stack(p[..., 0] + p[..., 3] * l[..., 0] - o[..., 0]),
        lambda p, l, o: (
            _rows(_stack(torch.ones_like(l[..., 0]), 0 * l[..., 0],
                         0 * l[..., 0], l[..., 0])),
            _rows(_stack(p[..., 3]))),
    ),
    "f23": (
        lambda p, l, o: jnp.array([p[0] * l[2] - o[0], p[1] + l[0] - o[1]]),
        lambda p, l, o: _stack(p[..., 0] * l[..., 2] - o[..., 0],
                               p[..., 1] + l[..., 0] - o[..., 1]),
        lambda p, l, o: (
            _rows(_stack(l[..., 2], 0 * l[..., 2]),
                  _stack(0 * l[..., 2], torch.ones_like(l[..., 2]))),
            _rows(_stack(0 * p[..., 0], 0 * p[..., 0], p[..., 0]),
                  _stack(torch.ones_like(p[..., 0]), 0 * p[..., 0],
                         0 * p[..., 0]))),
    ),
    "f33": (
        lambda p, l, o: jnp.array([p[0] * l[0] + p[1] - o[0],
                                   p[2] * l[1] + l[2] - o[1]]),
        lambda p, l, o: _stack(p[..., 0] * l[..., 0] + p[..., 1] - o[..., 0],
                               p[..., 2] * l[..., 1] + l[..., 2] - o[..., 1]),
        lambda p, l, o: (
            _rows(_stack(l[..., 0], torch.ones_like(l[..., 0]), 0 * l[..., 0]),
                  _stack(0 * l[..., 0], 0 * l[..., 0], l[..., 1])),
            _rows(_stack(p[..., 0], 0 * p[..., 0], 0 * p[..., 0]),
                  _stack(0 * p[..., 0], p[..., 2], torch.ones_like(p[..., 0])))),
    ),
    "f33pp": (
        lambda p, q, o: jnp.array([p[0] - q[1] - o[0], p[2] * q[0] - o[1]]),
        lambda p, q, o: _stack(p[..., 0] - q[..., 1] - o[..., 0],
                               p[..., 2] * q[..., 0] - o[..., 1]),
        lambda p, q, o: (
            _rows(_stack(torch.ones_like(p[..., 0]), 0 * p[..., 0],
                         0 * p[..., 0]),
                  _stack(0 * p[..., 0], 0 * p[..., 0], q[..., 0])),
            _rows(_stack(0 * p[..., 0], -torch.ones_like(p[..., 0]),
                         0 * p[..., 0]),
                  _stack(p[..., 2], 0 * p[..., 0], 0 * p[..., 0]))),
    ),
}


def _generic_graphs(vertices, factors, seed, weighted=False,
                    precision="FP64_FP64"):
    """Build the same graph in both packages. ``vertices``: [(name, dim,
    count, id_base, eliminate)]; ``factors``: [(fname, residual dim,
    (vname_a, vname_b), count, obs dim)]. ``weighted`` gives every factor
    a random SPD precision matrix; ``precision`` names the policy."""
    rng = np.random.default_rng(seed)
    vals = {name: rng.normal(1.0 if not elim else 0.5, 0.3, (count, dim))
            for name, dim, count, _, elim in vertices}
    links = {}
    for fname, _, (va, vb), count, odim in factors:
        na = next(v[2] for v in vertices if v[0] == va)
        nb = next(v[2] for v in vertices if v[0] == vb)
        links[fname] = (rng.integers(na, size=count),
                        rng.integers(nb, size=count),
                        rng.normal(0, 1, (count, odim)))
    precisions = {}
    if weighted:
        for fname, edim, _, count, _ in factors:
            a = rng.normal(0, 1, (count, edim, edim))
            precisions[fname] = a @ a.transpose(0, 2, 1) + np.eye(edim)
    graphs = []
    for pkg, is_jax in ((gt, True), (gtt, False)):
        g = pkg.Graph(precision=getattr(pkg, precision))
        vt, base = {}, {}
        for name, dim, count, id_base, elim in vertices:
            vt[name] = pkg.vertex_type(name, dim)
            vs = g.add_vertex_set(vt[name])
            vs.add_batch(id_base + np.arange(count), vals[name])
            if elim:
                vs.set_eliminate(True)
            base[name] = id_base
        for fname, edim, (va, vb), count, odim in factors:
            res_j, res_t, jac_t = FACTORS[fname]
            kw = dict(obs_shape=(odim,))
            if is_jax:
                ft = pkg.factor_type(fname, edim, [vt[va], vt[vb]], res_j, **kw)
            else:
                ft = pkg.factor_type(fname, edim, [vt[va], vt[vb]], res_t,
                                     jacobian_fn=jac_t, **kw)
            a, b, obs = links[fname]
            g.add_factor_set(ft).add_batch(
                np.stack([base[va] + a, base[vb] + b], axis=1), obs=obs,
                precision=precisions.get(fname))
        graphs.append(g)
    return graphs


def _multitype(precision="FP64_FP64"):
    return _generic_graphs(
        [("mt_pose4", 4, 3, 0, False), ("mt_pose2", 2, 2, 100, False),
         ("mt_lm3", 3, 6, 200, True), ("mt_lm1", 1, 4, 300, True)],
        [("f43", 2, ("mt_pose4", "mt_lm3"), 30, 2),
         ("f41", 1, ("mt_pose4", "mt_lm1"), 15, 1),
         ("f23", 2, ("mt_pose2", "mt_lm3"), 20, 2)], seed=0,
        precision=precision)


def _mixed_dims(precision="FP64_FP64"):
    return _generic_graphs(
        [("mt_pose3", 3, 4, 0, False), ("mt_lm3b", 3, 7, 100, True)],
        [("f33", 2, ("mt_pose3", "mt_lm3b"), 40, 2),
         ("f33pp", 2, ("mt_pose3", "mt_pose3"), 6, 2)], seed=4,
        precision=precision)


def _weighted():
    return _generic_graphs(
        [("mt_pose4", 4, 3, 0, False), ("mt_lm3", 3, 6, 200, True)],
        [("f43", 2, ("mt_pose4", "mt_lm3"), 30, 2)], seed=6, weighted=True)


FIXTURES = {"bal": _bal, "multitype": _multitype, "mixed_dims": _mixed_dims,
            "weighted": _weighted}


def _jax_side(pj, dx_p):
    """The JAX package's Schur quantities, traced as one jitted program
    (eager JAX compiles every small op on its own)."""
    hsj = jax_hessian.build_hessian_structure(pj)
    ssj = jax_schur.build_schur_structure(pj)

    def run(params, dx):
        lj = jax_linearize(pj, params)
        hv = jax_hessian.apply_damping(
            pj, hsj, jax_hessian.compute_hessian_values(pj, hsj, lj),
            lj.diag, MU, False)
        sv = jax_schur.schur_values(pj, ssj, hv)
        ops = jax_schur.SchurOps(pj, ssj, hv, sv)
        lu = ops.landmark_update(lj.b, dx)
        return dict(S=jax_schur_to_dense(pj, ssj, sv), hll_inv=sv.hll_inv,
                    b_s=ops.b_schur(lj.b), lu=lu,
                    delta=ops.compose_delta(dx, lu))

    out = pj.jit_with_consts(run)(pj.params0, jnp.asarray(dx_p))
    return ssj, {k: (np.asarray(v) if not isinstance(v, dict)
                     else {kk: np.asarray(vv) for kk, vv in v.items()})
                 for k, v in out.items()}


@pytest.mark.parametrize("fixture", sorted(FIXTURES))
def test_schur_matches_jax(fixture):
    gj, gp = FIXTURES[fixture]()
    pj, pp = gj.freeze(), gp.freeze(device="cpu")
    params = {k: np.asarray(v) for k, v in pj.params0.items()}
    ssp = torch_schur.build_schur_structure(pp)
    dx_p = np.random.default_rng(5).normal(size=ssp.dim_p)
    ssj, ref = _jax_side(pj, dx_p)

    lp = torch_linearize(pp, params_from_numpy(params))
    hsp = torch_hessian.build_hessian_structure(pp)
    hvp = torch_hessian.apply_damping(
        pp, hsp, torch_hessian.compute_hessian_values(pp, hsp, lp), lp.diag,
        MU, False)
    svp = torch_schur.schur_values(pp, ssp, hvp)
    opsp = torch_schur.SchurOps(pp, ssp, hvp, svp)

    if fixture == "mixed_dims":
        (key,) = ssp.hpl_keys
        assert not np.array_equal(ssp.hpl_h_idx[key],
                                  np.arange(ssp.hpl_h_idx[key].shape[0]))
    assert ssp.dim_p == ssj.dim_p and ssp.s_keys == ssj.s_keys
    _close(torch_schur_to_dense(pp, ssp, svp).numpy(), ref["S"])
    for d in ssj.lm_dims:
        _close(svp.hll_inv[d].numpy(), ref["hll_inv"][d])
    _close(opsp.b_schur(lp.b).numpy(), ref["b_s"])
    lu_p = opsp.landmark_update(lp.b, torch.as_tensor(dx_p))
    assert lu_p.keys() == ref["lu"].keys()
    for t in ref["lu"]:
        _close(lu_p[t].numpy(), ref["lu"][t])
    _close(opsp.compose_delta(torch.as_tensor(dx_p), lu_p).numpy(),
           ref["delta"])
