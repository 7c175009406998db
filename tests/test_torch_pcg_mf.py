"""K6's plain version (``ops/cuda/pcg_mf.solve_pcg_mf_plain``) and its
plan, on the CPU.

- float32, the same inputs (the JAX package's linearization, damping and
  inverse blocks, handed over as NumPy arrays) through the JAX package's
  Pallas ``solve_pcg_mf``, run in interpret mode as ``tests/test_pcg_mf.py``
  runs it, and through the plain version: x within rtol 2e-4, atol 2e-5
  (that test's own tolerance), block-Jacobi and identity, SE3 and SE2.
- float64 (K6's float64 instance): the same inputs, in float64, through
  the JAX package's generic CG (its ``PCGSolver``, which never takes the
  Pallas kernel in float64) and the plain version, x within 1e-10; the
  plain version against the port's generic branch (``run_pcg`` on
  ``hessian_matvec``, the gate shut by ``J_BYTES_LIMIT = 0``) to 1e-10;
  and ``PCGSolver`` takes the plain version exactly when the gate admits
  the problem, in a float32 and in a float64 graph (FP64_FP64, and
  FP64_FP32's float32 fold and inverse blocks).
- ``plan_pcg_mf``'s gate agrees with the JAX package's: feasible on pose
  graphs, None on BAL (two vertex types), None with ``J_BYTES_LIMIT`` or
  ``TABLE_ROWS_LIMIT`` lowered; the fixed pose's slots point at the trash
  row and scatter nowhere.
- The order K6 splits its dots by over a cluster: whole 1,024-entry
  chunks summed per CTA, then the shared tree (``tree_sum_chunked``), is
  bitwise ``tree_sum`` at sphere2500-like sizes and every cluster size,
  on inputs with -0.0 and with cancellation; and ``cluster_size``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphite_tpu as gt
import graphite_tpu.ops.pallas.pcg_mf as jax_mf
import graphite_tpu_torch as gtt
from graphite_tpu.io import bal as jbal
from graphite_tpu.io import g2o as jg2o
from graphite_tpu.io import synthetic as jsyn
from graphite_tpu.linearize import linearize as jax_linearize
from graphite_tpu.preconditioners import (
    BlockJacobiPreconditioner as JaxBlockJacobi,
)
from graphite_tpu.preconditioners import (
    IdentityPreconditioner as JaxIdentity,
)
from graphite_tpu.solvers import PCGSolver as JaxPCGSolver
from graphite_tpu_torch.io import bal as tbal
from graphite_tpu_torch.io import g2o as tg2o
from graphite_tpu_torch.io import synthetic as tsyn
from graphite_tpu_torch.linearize import Linearization, linearize
from graphite_tpu_torch.ops.cuda import pcg_mf
from graphite_tpu_torch.ops.pcg_loop import tree_sum, tree_sum_chunked
from graphite_tpu_torch.preconditioners import (
    BlockJacobiPreconditioner,
    IdentityPreconditioner,
)
from graphite_tpu_torch.preconditioners.block_jacobi import (
    row_inverse_blocks,
)
from graphite_tpu_torch.solvers import PCGSolver

torch.set_num_threads(1)

DATASETS = {
    "se3": lambda m: m.make_sphere_se3(60, seed=3),
    "se2": lambda m: m.make_pose_graph_2d(60, seed=3),
}


@pytest.fixture
def _interpret(monkeypatch):
    monkeypatch.setattr(jax_mf.pl, "pallas_call", functools.partial(
        jax.experimental.pallas.pallas_call, interpret=True))
    monkeypatch.delenv("GRAPHITE_TPU_NO_PCG_MF", raising=False)


def _problem(kind, precision, device="cpu"):
    g, *_ = tg2o.build_graph(DATASETS[kind](tsyn), precision=precision)
    return g.freeze(device=device)


def _t(a):
    return torch.tensor(np.asarray(a))


def _linearization_from_jax(lj):
    """The port's ``Linearization`` holding the JAX package's arrays."""
    return Linearization(
        residuals={k: _t(v) for k, v in lj.residuals.items()},
        jacobians={k: tuple(_t(a) for a in v)
                   for k, v in lj.jacobians.items()},
        chi2_vec={k: _t(v) for k, v in lj.chi2_vec.items()},
        chi2_deriv={k: _t(v) for k, v in lj.chi2_deriv.items()},
        scales=_t(lj.scales), diag=_t(lj.diag), b=_t(lj.b), chi2=_t(lj.chi2))


@pytest.mark.parametrize("kind", sorted(DATASETS))
@pytest.mark.parametrize("precond", ["bj", "identity"])
def test_plain_matches_jax_kernel_f32(_interpret, kind, precond):
    gj, *_ = jg2o.build_graph(DATASETS[kind](jsyn), precision=gt.FP32_FP32)
    pj = gj.freeze()
    lj = jax_linearize(pj, pj.params0)
    site_j = jax_mf.plan_pcg_mf(pj, lj)
    assert site_j is not None
    name = site_j["vt_name"]
    mu = jnp.float32(1e-3)
    damp = jnp.clip(lj.diag, 1e-6, 1e32) * mu
    inv_rows = None
    if precond == "bj":
        pre = JaxBlockJacobi()
        state = pre.set_damping(pj, lj, pre.prepare(pj, lj), mu, False)
        inv_rows = state.inv_blocks[name][pj.row_vertex[name]]
    kw = dict(max_iter=8, tol=1e-12, rejection_ratio=1e8)
    ref = np.asarray(jax_mf.solve_pcg_mf(pj, lj, site_j, damp, inv_rows,
                                         kw["max_iter"], kw["tol"],
                                         kw["rejection_ratio"]))

    pp = _problem(kind, gtt.FP32_FP32)
    lin = _linearization_from_jax(lj)
    site = pcg_mf.plan_pcg_mf(pp, lin)
    assert (site.vt_name, site.d, site.n) == (name, site_j["d"],
                                               site_j["n"])
    x, k = pcg_mf.solve_pcg_mf_plain(
        site, pcg_mf.fold_jacobians(pp, lin, site),
        pp.rows_view(lin.b, name).reshape(-1),
        pp.rows_view(_t(damp), name).reshape(-1),
        None if inv_rows is None else _t(inv_rows), **kw)
    assert int(k) == kw["max_iter"]
    np.testing.assert_allclose(x.numpy(), ref[:pp.dim_h], rtol=2e-4,
                               atol=2e-5)
    # CPU tensors take the plain version, bitwise
    x2, _ = pcg_mf.solve_pcg_mf(
        site, pcg_mf.fold_jacobians(pp, lin, site),
        pp.rows_view(lin.b, name).reshape(-1),
        pp.rows_view(_t(damp), name).reshape(-1),
        None if inv_rows is None else _t(inv_rows), **kw)
    assert torch.equal(x, x2)


@pytest.mark.parametrize("kind", sorted(DATASETS))
@pytest.mark.parametrize("precond", ["bj", "identity"])
def test_plain_matches_jax_generic_f64(kind, precond):
    gj, *_ = jg2o.build_graph(DATASETS[kind](jsyn), precision=gt.FP64_FP64)
    pj = gj.freeze()
    lj = jax_linearize(pj, pj.params0)
    pre_j = JaxBlockJacobi() if precond == "bj" else JaxIdentity()
    solver_j = JaxPCGSolver(30, 1e-14, 1e8, pre_j)
    mu = 1e-3
    ref, _ = solver_j.solve(pj, lj, solver_j.prepare(pj, lj), mu, False)
    ref = np.asarray(ref)

    pp = _problem(kind, gtt.FP64_FP64)
    lin = _linearization_from_jax(lj)
    site = pcg_mf.plan_pcg_mf(pp, lin)
    name = site.vt_name
    inv_rows = None
    if precond == "bj":
        state = pre_j.set_damping(pj, lj, pre_j.prepare(pj, lj),
                                  jnp.float64(mu), False)
        inv_rows = _t(state.inv_blocks[name][pj.row_vertex[name]])
    damp = _t(jnp.clip(lj.diag, 1e-6, 1e32) * mu)
    x, k = pcg_mf.solve_pcg_mf_plain(
        site, pcg_mf.fold_jacobians(pp, lin, site),
        pp.rows_view(lin.b, name).reshape(-1),
        pp.rows_view(damp, name).reshape(-1), inv_rows, max_iter=30,
        tol=1e-14, rejection_ratio=1e8)
    assert x.dtype == torch.float64 and int(k) > 0
    assert (np.abs(x.numpy() - ref[:pp.dim_h]).max()
            <= 1e-10 * np.abs(ref[:pp.dim_h]).max())


@pytest.mark.parametrize("kind", sorted(DATASETS))
@pytest.mark.parametrize("precond", ["bj", "identity"])
def test_plain_matches_generic_branch_f64(monkeypatch, kind, precond):
    pp = _problem(kind, gtt.FP64_FP64)
    lin = linearize(pp, pp.params0)
    pre = (BlockJacobiPreconditioner() if precond == "bj"
           else IdentityPreconditioner())
    solver = PCGSolver(30, 1e-14, 1e8, pre)
    mu = torch.tensor(1e-3, dtype=torch.float64)
    # the generic branch: the gate shut (a float64 graph now takes K6)
    with monkeypatch.context() as m:
        m.setattr(pcg_mf, "J_BYTES_LIMIT", 0)
        x_gen, _ = solver.solve(pp, lin, solver.prepare(pp, lin), mu, False)
    assert pp._cache.pop("pcg_mf_site") is None
    site = pcg_mf.plan_pcg_mf(pp, lin)
    state = pre.set_damping(pp, lin, pre.prepare(pp, lin), mu, False)
    minv = (row_inverse_blocks(pp, state, site.vt_name) if precond == "bj"
            else None)
    damp = lin.diag.clamp(1e-6, 1e32) * mu
    x, k = pcg_mf.solve_pcg_mf_plain(
        site, pcg_mf.fold_jacobians(pp, lin, site),
        pp.rows_view(lin.b, site.vt_name).reshape(-1),
        pp.rows_view(damp, site.vt_name).reshape(-1), minv, max_iter=30,
        tol=1e-14, rejection_ratio=1e8)
    assert int(k) > 0
    ref = x_gen[:pp.dim_h]
    assert float((x - ref).abs().max() / ref.abs().max()) <= 1e-10
    assert bool((x_gen[pp.dim_h:] == 0).all())


def _solve_with_gate_open_and_shut(monkeypatch, precond, policy):
    """``PCGSolver.solve`` on the SE3 graph under ``policy``, the gate
    open then shut (``J_BYTES_LIMIT = 0``): (the two solutions, the
    ``solve_pcg_mf`` calls, the dtypes of their J', b and inverses)."""
    pre = (BlockJacobiPreconditioner() if precond == "bj"
           else IdentityPreconditioner())
    solver = PCGSolver(20, 1e-12, 1e6, pre)
    calls = []
    real = pcg_mf.solve_pcg_mf
    from graphite_tpu_torch.solvers import pcg as pcg_module

    def counted(site, jf, b, damp, minv, **kwargs):
        calls.append((jf.dtype, b.dtype, None if minv is None
                      else minv.dtype))
        return real(site, jf, b, damp, minv, **kwargs)

    monkeypatch.setattr(pcg_module, "solve_pcg_mf", counted)
    out = []
    for limit in (pcg_mf.J_BYTES_LIMIT, 0):
        monkeypatch.setattr(pcg_mf, "J_BYTES_LIMIT", limit)
        pp = _problem("se3", policy)
        lin = linearize(pp, pp.params0)
        x, _ = solver.solve(pp, lin, solver.prepare(pp, lin), 1e-3, False)
        out.append(x)
    return out, calls


@pytest.mark.parametrize("precond", ["bj", "identity"])
def test_solver_takes_the_mf_branch_in_f32(monkeypatch, precond):
    """A float32 pose graph solves through ``solve_pcg_mf``; with the gate
    closed it takes ``run_pcg`` and lands within float32 rounding."""
    out, calls = _solve_with_gate_open_and_shut(monkeypatch, precond,
                                                gtt.FP32_FP32)
    assert len(calls) == 1
    assert float((out[0] - out[1]).abs().max()
                 / out[1].abs().max()) <= 1e-3


@pytest.mark.parametrize("precond", ["bj", "identity"])
@pytest.mark.parametrize("policy", ["FP64_FP64", "FP64_FP32"])
def test_solver_takes_the_mf_branch_in_f64(monkeypatch, precond, policy):
    """A float64 pose graph solves through ``solve_pcg_mf`` (float64 b;
    J' and the inverse blocks float64 under FP64_FP64, float32 under
    FP64_FP32) exactly when the gate admits it; with the gate closed it
    takes ``run_pcg``, within 1e-10 (FP64_FP64: both in double, one
    order of sums apart) or 1e-6 (FP64_FP32: the generic branch widens
    the float32 J without folding it)."""
    out, calls = _solve_with_gate_open_and_shut(monkeypatch, precond,
                                                getattr(gtt, policy))
    low = torch.float64 if policy == "FP64_FP64" else torch.float32
    assert calls == [(low, torch.float64,
                      low if precond == "bj" else None)]
    assert out[0].dtype == out[1].dtype == torch.float64
    tol = 1e-10 if policy == "FP64_FP64" else 1e-6
    assert float((out[0] - out[1]).abs().max()
                 / out[1].abs().max()) <= tol


def _gate_pair(monkeypatch, attr, value):
    monkeypatch.setattr(jax_mf, attr, value)
    monkeypatch.setattr(pcg_mf, attr, value)
    gj, *_ = jg2o.build_graph(DATASETS["se3"](jsyn), precision=gt.FP32_FP32)
    pj = gj.freeze()
    pp = _problem("se3", gtt.FP32_FP32)
    return (jax_mf.plan_pcg_mf(pj, jax_linearize(pj, pj.params0)),
            pcg_mf.plan_pcg_mf(pp, linearize(pp, pp.params0)))


@pytest.mark.parametrize("attr,value,feasible", [
    ("J_BYTES_LIMIT", 6 << 20, True), ("J_BYTES_LIMIT", 0, False),
    ("J_BYTES_LIMIT", 256 << 10, True), ("J_BYTES_LIMIT", (256 << 10) - 1,
                                         False),
    ("TABLE_ROWS_LIMIT", 4096, True), ("TABLE_ROWS_LIMIT", 256, False),
])
def test_plan_gate_matches_jax(monkeypatch, attr, value, feasible):
    site_j, site = _gate_pair(monkeypatch, attr, value)
    assert (site_j is not None) == (site is not None) == feasible


def test_plan_infeasible_on_bal():
    ds = jsyn.make_bal("mini", seed=0)
    gj, *_ = jbal.build_graph(ds, precision=gt.FP32_FP32)
    pj = gj.freeze()
    assert jax_mf.plan_pcg_mf(pj, jax_linearize(pj, pj.params0)) is None
    gp, *_ = tbal.build_graph(tsyn.make_bal("mini", seed=0),
                              precision=gtt.FP32_FP32)
    pp = gp.freeze(device="cpu")
    assert pcg_mf.plan_pcg_mf(pp, linearize(pp, pp.params0)) is None


def test_site_structure():
    """The fixed first pose: its slots read the zero trash row n and
    scatter nowhere; every other incidence appears once in the CSR."""
    pp = _problem("se3", gtt.FP32_FP32)
    site = pcg_mf.plan_pcg_mf(pp, linearize(pp, pp.params0))
    assert pcg_mf.plan_pcg_mf(pp, None) is site  # cached
    (blk,) = site.blocks
    rows = site.rows.numpy().reshape(blk.arity, blk.F)
    fixed = pp.host.factor_ids["se3_between"] == 0
    assert np.array_equal(rows == site.n, fixed.T)
    off = site.csr_off.numpy()
    assert off[0] == 0 and off[-1] == blk.arity * blk.F - fixed.sum()
    assert np.all(np.diff(off) == np.bincount(rows[rows < site.n],
                                              minlength=site.n))
    # each CSR entry names a (factor, slot) incidence of its own row, in
    # (slot, factor) order within the row
    E, W = blk.E, blk.arity * blk.E * site.d
    f = site.inc_v.numpy() // E
    s = (site.inc_j.numpy() - f * W) // (E * site.d)
    row_of = np.repeat(np.arange(site.n), np.diff(off))
    assert np.array_equal(rows[s, f], row_of)
    key = row_of * (blk.arity * blk.F) + s * blk.F + f
    assert np.all(np.diff(key) > 0)
    assert np.all(site.inc_e.numpy() == E)


def signed_zeros_and_cancellation(N, seed=0):
    """float32 entries of both signs and wide range, every 7th a -0.0, and
    the second half cancelling the first (so partial sums hit +-0)."""
    rng = np.random.default_rng(seed + N)
    v = (rng.standard_normal(N) * 10.0 ** rng.integers(-3, 4, N)).astype(
        np.float32)
    v[N // 2:N // 2 + N // 4] = -v[:N // 4]
    v[::7] = -0.0
    return torch.as_tensor(v)


@pytest.mark.parametrize("ctas", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("N", [441, 1024, 7_497, 14_994, 23_994])
def test_chunked_sum_is_tree_sum(N, ctas):
    v = signed_zeros_and_cancellation(N)
    for w in (v, -v.abs(), torch.full((N,), -0.0)):
        got, ref = tree_sum_chunked(w, ctas), tree_sum(w)
        assert got.view(torch.int32) == ref.view(torch.int32)


def test_cluster_size():
    """One 1,024-entry chunk per CTA up to 16 CTAs, a power of two:
    sphere2500's 14,994 entries take 16, SE2's 7,497 take 8."""
    assert [pcg_mf.cluster_size(N) for N in (1, 1024, 1025, 7_497, 14_994,
                                             23_994, 524_160)] == [
        1, 1, 2, 8, 16, 16, 16]


@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
def test_cta_shape(cluster):
    """The float64 design's shared memory is sized by the most rows and
    incidences a CTA holds: counted entry by entry over each CTA's own
    chunks (a row cut by a chunk boundary belongs to both CTAs)."""
    g, *_ = tg2o.build_graph(tsyn.make_sphere_se3(700, seed=5),
                             precision=gtt.FP64_FP64)
    pp = g.freeze(device="cpu")
    site = pcg_mf.plan_pcg_mf(pp, linearize(pp, pp.params0))
    N, d = site.n * site.d, site.d
    assert N > 3 * pcg_mf.CHUNK
    off = site.csr_off.numpy()
    nch = -(-N // pcg_mf.CHUNK)
    per = -(-nch // cluster)
    shapes = []
    for rank in range(cluster):
        entries = np.arange(rank * per * pcg_mf.CHUNK,
                            min((rank + 1) * per * pcg_mf.CHUNK, N))
        rows = np.unique(entries // d)
        shapes.append((rows.size, int((off[rows + 1] - off[rows]).sum())))
    assert pcg_mf.cta_shape(site, cluster) == (
        max(r for r, _ in shapes), max(i for _, i in shapes))
    assert np.array_equal(site.csr_host, off)
