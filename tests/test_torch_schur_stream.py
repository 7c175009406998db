"""The Schur branches for large problems (K3 triple products, K4 b_schur
and back-substitution, K5 S matvec) of the PyTorch port vs the JAX
package, forced at toy size by lowering the port's module-level gates
(``schur.CHUNK_THRESHOLD``, ``schur._smv_chunk_rows``), as the JAX
package's ``test_schur_stream_paths.py`` forces its own.

- float64, port forced vs the JAX package's plain path: S, b_schur,
  s_matvec, landmark_update and compose_delta to 1e-12 relative to each
  array's largest entry, on ``make_bal("mini")`` and the multi-type and
  mixed-(3, 3)-group fixtures of ``test_schur_multitype.py``. The kernels
  take float32 only, so with the size gates forced the float64 sites
  still take the stepwise branch (the dtype gate, as the JAX package's
  ``use_pallas``): no K3, K4 or K5 plan is built.
- float32, port forced vs the JAX package's streaming Pallas path
  (interpret mode, forced the same way) on the same damped Hessian values:
  to 1e-5 relative.
- Below the gate Ladybug-49's product scatter stays a K1 site: its plan
  (``("prod_dst", 0)``, 86,545 rows into 1,225 S blocks) keeps 16 lanes a
  segment, and no K3 plan is built.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphite_tpu as gt
import graphite_tpu.ops.pallas.segmv as jax_segmv
import graphite_tpu.ops.pallas.segsum as jax_segsum
import graphite_tpu.ops.pallas.segsum_stream as jax_segsum_stream
import graphite_tpu.ops.streamreduce as jax_streamreduce
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
from test_torch_schur import _close, _mixed_dims, _multitype

torch.set_num_threads(1)

MU = 1e-2


def _mini(precision="FP64_FP64"):
    ds = synthetic.make_bal("mini", seed=0, noise=0.5)
    gj, *_ = jax_build_graph(ds, precision=getattr(gt, precision))
    gp, *_ = torch_bal_io.build_graph(ds, precision=getattr(gtt, precision))
    return gj, gp


FIXTURES = {"mini": _mini, "multitype": _multitype,
            "mixed_dims": _mixed_dims}


@pytest.fixture
def force_port(monkeypatch):
    monkeypatch.setattr(torch_schur, "CHUNK_THRESHOLD", 0)
    monkeypatch.setattr(torch_schur, "_smv_chunk_rows", lambda rb: 0)


def _port_side(pp, params, dx_p, x, hv=None, b=None, kernels=True):
    """The port's Schur quantities (forced gates), from its own
    linearization or from given damped H values and b; ``kernels``: the
    values are float32, so every large-problem branch must be taken (else
    none may be)."""
    ssp = torch_schur.build_schur_structure(pp)
    if hv is None:
        lp = torch_linearize(pp, params_from_numpy(params))
        hsp = torch_hessian.build_hessian_structure(pp)
        hv = torch_hessian.apply_damping(
            pp, hsp, torch_hessian.compute_hessian_values(pp, hsp, lp),
            lp.diag, MU, False)
        b = lp.b
    sv = torch_schur.schur_values(pp, ssp, hv)
    ops = torch_schur.SchurOps(pp, ssp, hv, sv)
    ops.prepare_matvec()
    lu = ops.landmark_update(b, torch.as_tensor(dx_p))
    out = dict(s_vals={k: v.numpy() for k, v in sv.s_vals.items()},
               b_s=ops.b_schur(b).numpy(),
               y=ops.s_matvec(torch.as_tensor(x)).numpy(),
               lu={t: v.numpy() for t, v in lu.items()},
               delta=ops.compose_delta(torch.as_tensor(dx_p), lu).numpy())
    cache = pp._cache
    if not kernels:
        # the dtype gate keeps every float64 site stepwise
        assert not ops._smv_prep and not cache.get("smv_sym_sites")
        assert "matvec_plans" not in cache
        assert "product_plans" not in cache
        return ssp, sv, out
    # every large-problem branch was taken
    assert ops._smv_prep and cache["smv_sym_sites"]
    assert {t[0] for t in cache["matvec_plans"]} == {"bschur", "lu"}
    assert len([t for t in cache["index32"] if t[0] == "prod_l"]) == len(
        ssp.products)
    # K3 plans its sites under its own tag; no K1 product-scatter plan
    assert sorted(cache["product_plans"]) == [
        ("prod_k3", gi) for gi in range(len(ssp.products))]
    assert not any(t[0] == "prod_dst"
                   for t in cache.get("segment_plans", {}))
    return ssp, sv, out


def _compare(out, ref, tol):
    for key in ref["s_vals"]:
        _close(out["s_vals"][key], ref["s_vals"][key], tol)
    for name in ("b_s", "y", "delta"):
        _close(out[name], ref[name], tol)
    assert out["lu"].keys() == ref["lu"].keys()
    for t in ref["lu"]:
        _close(out["lu"][t], ref["lu"][t], tol)


@pytest.mark.parametrize("fixture", sorted(FIXTURES))
def test_forced_branches_match_jax_f64(force_port, fixture):
    gj, gp = FIXTURES[fixture]()
    pj, pp = gj.freeze(), gp.freeze(device="cpu")
    params = {k: np.asarray(v) for k, v in pj.params0.items()}
    hsj = jax_hessian.build_hessian_structure(pj)
    ssj = jax_schur.build_schur_structure(pj)
    rng = np.random.default_rng(5)
    dx_p = rng.normal(size=ssj.dim_p)
    x = rng.normal(size=ssj.dim_p)

    def run(params, dx, x):
        lj = jax_linearize(pj, params)
        hv = jax_hessian.apply_damping(
            pj, hsj, jax_hessian.compute_hessian_values(pj, hsj, lj),
            lj.diag, MU, False)
        sv = jax_schur.schur_values(pj, ssj, hv)
        ops = jax_schur.SchurOps(pj, ssj, hv, sv)
        lu = ops.landmark_update(lj.b, dx)
        return dict(s_vals=sv.s_vals, b_s=ops.b_schur(lj.b),
                    y=ops.s_matvec(x), lu=lu,
                    delta=ops.compose_delta(dx, lu),
                    S=jax_schur_to_dense(pj, ssj, sv))

    ref = jax.tree_util.tree_map(np.asarray, pj.jit_with_consts(run)(
        pj.params0, jnp.asarray(dx_p), jnp.asarray(x)))
    ssp, sv, out = _port_side(pp, params, dx_p, x, kernels=False)
    assert ssp.s_keys == ssj.s_keys
    _compare(out, ref, 1e-12)
    _close(torch_schur_to_dense(pp, ssp, sv).numpy(), ref["S"])


@pytest.fixture
def force_jax_stream(monkeypatch):
    """The JAX package's streaming Pallas branches in interpret mode, as
    ``test_schur_stream_paths.py`` forces them (float32 streams)."""
    monkeypatch.setenv("GRAPHITE_TPU_STREAM_DTYPE", "f32")
    interp = functools.partial(jax.experimental.pallas.pallas_call,
                               interpret=True)
    for mod in (jax_segsum_stream, jax_segsum, jax_segmv):
        monkeypatch.setattr(mod.pl, "pallas_call", interp)
    orig = jax_streamreduce.get_stream_plan

    def tiny_chunk(problem, tag, seg, num_segments, dtype,
                   chunk=jax_streamreduce.STREAM_CHUNK):
        return orig(problem, tag, seg, num_segments, dtype, chunk=256)

    always = lambda problem, dtype, sharded_ok=False: True  # noqa: E731
    monkeypatch.setattr(jax_streamreduce, "get_stream_plan", tiny_chunk)
    monkeypatch.setattr(jax_streamreduce, "use_pallas", always)
    monkeypatch.setattr(jax_schur, "_get_stream_plan", tiny_chunk)
    monkeypatch.setattr(jax_schur, "_use_pallas", always)
    monkeypatch.setattr(jax_schur, "CHUNK_THRESHOLD", 16)
    monkeypatch.setattr(jax_schur, "STREAM_PART_ROWS", 1 << 10)
    monkeypatch.setattr(jax_schur, "_smv_chunk_rows", lambda rb: 4)


def test_forced_branches_match_jax_stream_f32(force_port, force_jax_stream):
    gj, gp = _mini("FP32_FP32")
    pj, pp = gj.freeze(), gp.freeze(device="cpu")
    lj = jax_linearize(pj, pj.params0)
    hsj = jax_hessian.build_hessian_structure(pj)
    ssj = jax_schur.build_schur_structure(pj)
    hv = jax_hessian.apply_damping(
        pj, hsj, jax_hessian.compute_hessian_values(pj, hsj, lj), lj.diag,
        MU, False)
    sv = jax_schur.schur_values(pj, ssj, hv)
    ops = jax_schur.SchurOps(pj, ssj, hv, sv)
    ops.prepare_matvec()
    rng = np.random.default_rng(7)
    dx_p = rng.normal(size=ssj.dim_p).astype(np.float32)
    x = rng.normal(size=ssj.dim_p).astype(np.float32)
    lu = ops.landmark_update(lj.b, jnp.asarray(dx_p))
    ref = jax.tree_util.tree_map(np.asarray, dict(
        s_vals=sv.s_vals, b_s=ops.b_schur(lj.b),
        y=ops.s_matvec(jnp.asarray(x)), lu=lu,
        delta=ops.compose_delta(jnp.asarray(dx_p), lu)))
    # the JAX package took its streaming kernels
    assert pj._cache.get("smv_sym_sites") and pj._cache.get(
        "bschur_wtbl_sites")

    hv_t = {k: torch.as_tensor(np.array(v)) for k, v in hv.items()}
    _, _, out = _port_side(pp, None, dx_p, x, hv=hv_t,
                           b=torch.as_tensor(np.array(lj.b)))
    _compare(out, ref, 1e-5)


def test_ladybug_product_scatter_keeps_its_k1_plan():
    ds = synthetic.make_bal("ladybug", seed=0)
    gp, *_ = torch_bal_io.build_graph(ds, precision=gtt.FP32_FP32)
    pp = gp.freeze(device="cpu")
    ssp = torch_schur.build_schur_structure(pp)
    hsp = torch_hessian.build_hessian_structure(pp)
    lp = torch_linearize(pp, pp.params0)
    hv = torch_hessian.apply_damping(
        pp, hsp, torch_hessian.compute_hessian_values(pp, hsp, lp), lp.diag,
        MU, False)
    torch_schur.schur_values(pp, ssp, hv)
    plan = pp._cache["segment_plans"][("prod_dst", 0)]
    assert (plan.rows, plan.num_segments, plan.group) == (86_545, 1_225, 16)
    assert "product_plans" not in pp._cache
