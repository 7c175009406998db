"""The port's CUDA kernels and main path on a card (marked ``gpu``; skipped
where ``torch.cuda.is_available()`` is false). Imports no JAX, so it runs
on a machine with only PyTorch (``--noconftest`` skips the JAX set-up in
``tests/conftest.py``):

    python -m pytest tests/test_torch_gpu.py -m gpu -q --noconftest

- K1 vs its plain version at the Ladybug-49 shapes: within 1e-5 relative
  on the card, bitwise repeatable, and bitwise equal to the plain version
  on the CPU (both sum each segment in row order).
- K2 bitwise equal to its plain version on the CPU, which takes every
  product, sum and dot in the kernel's order; no step for a zero b.
- The LM slice on CUDA and on the CPU: bitwise the same trajectory, with
  every kernel launched.
- K3, K4 (all three entry points) and K5 vs their plain versions at small
  random shapes, with masked (fill) rows, diagonal blocks and unsorted
  destinations: within 1e-5 relative on the card, bitwise repeatable, and
  bitwise equal to the plain version on the CPU (which sums in the
  kernels' order).
- The LM slice at Ladybug-49 with the large-problem branches forced
  (``dense_matvec_limit=0``, the Schur gates lowered): CUDA and CPU give
  bitwise the same trajectory, and K3, K4 and K5 launch.
- K6 vs its plain version on the first solve of sphere2500 (SE3,
  block-Jacobi and identity) and of the 2500-pose SE2 circle: bitwise
  repeatable, the same number of CG steps, within 1e-5 relative.
- The pose-graph LM (SE3, PCGSolver(50, 1e-10, 1e6, block-Jacobi)) on
  CUDA and on the CPU: the same accept pattern, chi2 within 1e-3, K6
  launched once per solve.
- ``Graph.freeze()`` without a device builds on the card.
"""

import numpy as np
import pytest
import torch

import graphite_tpu_torch as gtt
from graphite_tpu_torch import schur
from graphite_tpu_torch.io import bal, g2o, synthetic
from graphite_tpu_torch.linearize import linearize
from graphite_tpu_torch.ops.cuda import (
    pcg_dense,
    pcg_mf,
    segmv,
    segsum,
    segsum_stream,
)
from graphite_tpu_torch.optimizers import (
    LevenbergMarquardtOptions,
    levenberg_marquardt,
)
from graphite_tpu_torch.preconditioners import (
    BlockJacobiPreconditioner,
    IdentityPreconditioner,
)
from graphite_tpu_torch.preconditioners.block_jacobi import (
    row_inverse_blocks,
)
from graphite_tpu_torch.solvers import PCGSchurSolver, PCGSolver

torch.set_num_threads(1)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


LADYBUG_SHAPES = [(86_545, 1_225, 81, True), (31_843, 7_777, 3, True),
                  (31_843, 7_777, 9, True), (31_843, 30_622, 27, True),
                  (30_621, 7_776, 3, True), (31_843, 50, 81, False),
                  (30_621, 49, 9, False)]


@pytest.mark.parametrize("k,ns,d,sorted_dst", LADYBUG_SHAPES)
def test_k1_matches_plain(cuda_device, k, ns, d, sorted_dst):
    rng = np.random.default_rng(k + d)
    seg = rng.integers(0, ns, k)
    if sorted_dst:
        seg = np.sort(seg)
    vals_np = rng.standard_normal((k, d)).astype(np.float32)
    vals = torch.as_tensor(vals_np, device=cuda_device)
    plan = segsum.plan_segments(seg, ns, cuda_device)
    out = segsum_stream.streaming_segment_sum(vals, plan)
    again = segsum.sorted_segment_sum(vals, plan)
    ref = segsum.segment_sum_plain(vals, plan)
    ref_cpu = segsum.segment_sum_plain(torch.as_tensor(vals_np),
                                       segsum.plan_segments(seg, ns, "cpu"))
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    assert torch.equal(out.cpu(), ref_cpu)
    err = (out - ref).abs().max() / ref.abs().max()
    assert float(err) <= 1e-5
    with pytest.raises(NotImplementedError):
        segsum.sorted_segment_sum(vals.double(), plan)


@pytest.mark.parametrize("n,d,max_iter,tol", [
    (90, 9, 10, 1.0), (441, 9, 10, 1.0), (1024, 8, 10, 1e-12),
])
def test_k2_matches_plain_bitwise(cuda_device, n, d, max_iter, tol):
    rng = np.random.default_rng(n)
    A = rng.standard_normal((n, n))
    S = A @ A.T + n * np.eye(n)
    M = np.zeros_like(S)
    for i in range(0, n, d):
        M[i:i + d, i:i + d] = np.linalg.inv(S[i:i + d, i:i + d])
    args = [a.astype(np.float32) for a in (S, M, rng.standard_normal(n))]
    kw = dict(max_iter=max_iter, tol=tol, rejection_ratio=5.0)
    x, k = pcg_dense.dense_pcg(
        *[torch.as_tensor(a, device=cuda_device) for a in args], **kw)
    x_ref, k_ref = pcg_dense.dense_pcg_plain(
        *[torch.as_tensor(a) for a in args], **kw)
    assert int(k) == int(k_ref)
    assert torch.equal(x.cpu(), x_ref)


def test_k2_zero_rhs_takes_no_step(cuda_device):
    n = 441
    x, k = pcg_dense.dense_pcg(
        torch.eye(n, device=cuda_device), torch.eye(n, device=cuda_device),
        torch.zeros(n, device=cuda_device), max_iter=10, tol=1.0,
        rejection_ratio=5.0)
    assert int(k) == 0 and bool(torch.all(x == 0))


def test_lm_slice_cuda_equals_cpu(cuda_device):
    runs = []
    stats = (segsum.STATS, segsum_stream.STATS, pcg_dense.STATS)
    for device in ("cpu", cuda_device):
        g, *_ = bal.build_graph(
            synthetic.make_bal((12, 120, 700), seed=0, noise=0.5),
            precision=gtt.FP32_FP32)
        problem = g.freeze(device=device)
        for s in stats:
            s.reset()
        runs.append(levenberg_marquardt(
            problem, PCGSchurSolver(10, 1.0, 5.0),
            options=LevenbergMarquardtOptions(iterations=5)))
    cpu, gpu = runs
    assert all(s.launches > 0 for s in stats)
    assert pcg_dense.STATS.launches == len(gpu.history)
    assert ([(h["chi2"], h["accepted"]) for h in gpu.history]
            == [(h["chi2"], h["accepted"]) for h in cpu.history])
    for name, p in gpu.params.items():
        assert torch.equal(p.cpu(), cpu.params[name])


def _on(device, *arrays):
    return [torch.as_tensor(a, device=device) for a in arrays]


def _check_kernel(out, again, ref, ref_cpu):
    torch.cuda.synchronize()
    for o, a, r, c in zip(out, again, ref, ref_cpu):
        assert torch.equal(o, a)
        assert torch.equal(o.cpu(), c)
        assert float((o - r).abs().max() / r.abs().max()) <= 1e-5


@pytest.mark.parametrize("m,k,n", [(9, 3, 9), (4, 3, 2), (9, 9, 9)])
def test_k3_matches_plain(cuda_device, m, k, n):
    rng = np.random.default_rng(m * 100 + k * 10 + n)
    rows, ns, n_l, n_r = 20_000, 1_800, 5_000, 4_000
    seg = np.sort(rng.integers(0, ns, rows))
    ltab = rng.standard_normal((n_l, m * k)).astype(np.float32)
    rtab = rng.standard_normal((n_r, n * k)).astype(np.float32)
    li = rng.integers(0, n_l, rows).astype(np.int32)
    ri = rng.integers(0, n_r, rows).astype(np.int32)
    runs = []
    for device in (cuda_device, "cpu"):
        plan = segsum.plan_segments(seg, ns, device)
        L, R, lt, rt = _on(device, ltab, rtab, li, ri)
        runs.append((L, R, lt, rt, plan))
    L, R, lt, rt, plan = runs[0]

    def tbl():
        return segsum_stream.streaming_segment_product_sum_rtbl(
            L, R, plan, m, k, n, lt, rt)

    out = tbl()
    ref_cpu = segsum_stream.segment_product_sum_plain(*runs[1][:2],
                                                      runs[1][4], m, k, n,
                                                      *runs[1][2:4])
    ref = segsum_stream.segment_product_sum_plain(L, R, plan, m, k, n, lt,
                                                  rt)
    _check_kernel([out], [tbl()], [ref], [ref_cpu])
    stream = segsum_stream.streaming_segment_product_sum(
        L.index_select(0, lt), R.index_select(0, rt), plan, m, k, n)
    torch.cuda.synchronize()
    assert torch.equal(stream, out)
    with pytest.raises(NotImplementedError):
        segsum_stream.streaming_segment_product_sum_rtbl(
            L.double(), R.double(), plan, m, k, n, lt, rt)


@pytest.mark.parametrize("ns,transpose", [(40, False), (40, True),
                                          (15_000, False), (15_000, True)])
def test_k4_matches_plain(cuda_device, ns, transpose):
    """Few destinations (a group of threads per segment) and many (one
    thread per segment), unsorted destinations, ~5% masked rows."""
    m, k = 9, 3
    rng = np.random.default_rng(ns + transpose)
    rows, n_x = 50_000, 3_000
    dst = rng.integers(0, ns, rows)
    left = rng.standard_normal((rows, m * k)).astype(np.float32)
    xd = m if transpose else k
    x = rng.standard_normal((n_x, xd)).astype(np.float32)
    xi = rng.integers(0, n_x, rows)
    xi[rng.random(rows) < 0.05] = n_x
    xi = xi.astype(np.int32)
    gpu = _on(cuda_device, left, x, xi)
    cpu = _on("cpu", left, x, xi)
    plan = segmv.plan_matvec(dst, ns, cuda_device)
    plan_cpu = segmv.plan_matvec(dst, ns, "cpu")
    assert (plan.group > 1) == (ns == 40)

    def tbl(A, X, I, p):
        return segsum_stream.streaming_matvec_tbl(A, X, I, p, m, k,
                                                  transpose)

    out = tbl(*gpu, plan)
    ref = segmv.segmv_plain(*gpu, plan, m, k, transpose)
    _check_kernel([out], [tbl(*gpu, plan)], [ref], [tbl(*cpu, plan_cpu)])
    gathered = torch.cat([gpu[1], gpu[1].new_zeros(1, xd)]).index_select(
        0, gpu[2])
    stream = segmv.block_matvec_stream(gpu[0], gathered, plan, m, k,
                                       transpose)
    torch.cuda.synchronize()
    assert torch.equal(stream, out)
    if not transpose:
        wtbl = segmv.block_matvec_wtbl(gpu[0], gpu[1], plan, gpu[2], m, k)
        torch.cuda.synchronize()
        assert torch.equal(wtbl, out)


def test_k5_matches_plain(cuda_device):
    m = k = 9
    rng = np.random.default_rng(5)
    rows, n_r, n_c = 60_000, 70, 70
    rid = rng.integers(0, n_r, rows)
    cid = np.sort(rng.integers(0, n_c, rows))  # CSC: columns sorted
    diag = rng.random(rows) < 0.05
    rxi = np.where(diag, n_r, rid).astype(np.int32)
    left = rng.standard_normal((rows, m * k)).astype(np.float32)
    xc = rng.standard_normal((n_c, k)).astype(np.float32)
    xr = rng.standard_normal((n_r, m)).astype(np.float32)
    arrays = (left, xc, xr, cid.astype(np.int32), rxi)
    gpu, cpu = _on(cuda_device, *arrays), _on("cpu", *arrays)
    plan = segmv.plan_matvec_sym(rid, cid, n_r, n_c, cuda_device)
    plan_cpu = segmv.plan_matvec_sym(rid, cid, n_r, n_c, "cpu")
    out = segmv.matvec_sym_stream(*gpu, plan, m, k)
    _check_kernel(out, segmv.matvec_sym_stream(*gpu, plan, m, k),
                  segmv.matvec_sym_plain(*gpu, plan, m, k),
                  segmv.matvec_sym_stream(*cpu, plan_cpu, m, k))


def test_forced_branches_lm_cuda_equals_cpu(cuda_device, monkeypatch):
    monkeypatch.setattr(schur, "CHUNK_THRESHOLD", 0)
    monkeypatch.setattr(schur, "_smv_chunk_rows", lambda rb: 0)
    stats = (segsum_stream.PRODUCT_RTBL_STATS, segmv.WTBL_STATS,
             segsum_stream.MATVEC_TBL_STATS, segmv.SYM_STATS)
    runs = []
    for device in ("cpu", cuda_device):
        g, *_ = bal.build_graph(synthetic.make_bal("ladybug", seed=0),
                                precision=gtt.FP32_FP32)
        for s in stats:
            s.reset()
        runs.append(levenberg_marquardt(
            g.freeze(device=device),
            PCGSchurSolver(10, 1.0, 5.0, dense_matvec_limit=0),
            options=LevenbergMarquardtOptions(iterations=10)))
    cpu, gpu = runs
    assert all(s.launches > 0 for s in stats)
    assert ([(h["chi2"], h["accepted"]) for h in gpu.history]
            == [(h["chi2"], h["accepted"]) for h in cpu.history])
    assert gpu.chi2 < gpu.initial_chi2


def _pose_dataset(kind, n):
    if kind == "se3":
        return synthetic.make_sphere_se3(n, seed=0)
    return synthetic.make_pose_graph_2d(n, seed=0)


def _first_pose_solve(device, kind, precond, mu=1e-4):
    """The inputs of K6 on the first LM solve of a pose graph."""
    g, *_ = g2o.build_graph(_pose_dataset(kind, 2500),
                            precision=gtt.FP32_FP32)
    problem = g.freeze(device=device)
    lin = linearize(problem, problem.params0)
    site = pcg_mf.plan_pcg_mf(problem, lin)
    damping = torch.tensor(mu, device=problem.device)
    minv = None
    if precond == "bj":
        pre = BlockJacobiPreconditioner()
        state = pre.set_damping(problem, lin, pre.prepare(problem, lin),
                                damping, False)
        minv = row_inverse_blocks(problem, state, site.vt_name)
    damp = lin.diag.clamp(1e-6, 1e32) * damping
    rows = site.vt_name
    return (site, pcg_mf.fold_jacobians(problem, lin, site),
            problem.rows_view(lin.b, rows).reshape(-1),
            problem.rows_view(damp, rows).reshape(-1), minv)


@pytest.mark.parametrize("kind,precond", [("se3", "bj"), ("se3", "identity"),
                                          ("se2", "bj")])
def test_k6_matches_plain(cuda_device, kind, precond):
    site, jf, b, damp, minv = _first_pose_solve(cuda_device, kind, precond)
    kw = dict(max_iter=50, tol=1e-10, rejection_ratio=1e6)
    x, k = pcg_mf.solve_pcg_mf(site, jf, b, damp, minv, **kw)
    again, k2 = pcg_mf.solve_pcg_mf(site, jf, b, damp, minv, **kw)
    ref, k_ref = pcg_mf.solve_pcg_mf_plain(site, jf, b, damp, minv, **kw)
    torch.cuda.synchronize()
    assert torch.equal(x, again) and int(k) == int(k2)
    assert int(k) == int(k_ref) > 0
    assert float((x - ref).abs().max() / ref.abs().max()) <= 1e-5
    with pytest.raises(NotImplementedError):
        pcg_mf.solve_pcg_mf(site, jf.double(), b.double(), damp.double(),
                            None, **kw)


def test_pose_lm_cuda_vs_cpu(cuda_device):
    runs = []
    for device in ("cpu", cuda_device):
        g, *_ = g2o.build_graph(synthetic.make_sphere_se3(300, seed=0),
                                precision=gtt.FP32_FP32)
        pcg_mf.STATS.reset()
        runs.append(levenberg_marquardt(
            g.freeze(device=device),
            PCGSolver(50, 1e-10, 1e6, BlockJacobiPreconditioner()),
            options=LevenbergMarquardtOptions(iterations=10)))
    cpu, gpu = runs
    assert pcg_mf.STATS.launches == len(gpu.history) == 10
    assert ([h["accepted"] for h in gpu.history]
            == [h["accepted"] for h in cpu.history])
    np.testing.assert_allclose([h["chi2"] for h in gpu.history],
                               [h["chi2"] for h in cpu.history], rtol=1e-3)
    assert gpu.chi2 < gpu.initial_chi2


def test_identity_preconditioner_takes_k6(cuda_device):
    g, *_ = g2o.build_graph(synthetic.make_pose_graph_2d(200, seed=1),
                            precision=gtt.FP32_FP32)
    pcg_mf.STATS.reset()
    out = levenberg_marquardt(
        g.freeze(device=cuda_device),
        PCGSolver(20, 1e-10, 1e6, IdentityPreconditioner()),
        options=LevenbergMarquardtOptions(iterations=3))
    assert pcg_mf.STATS.launches == 3 and out.chi2 < out.initial_chi2


def test_freeze_default_is_cuda(cuda_device):
    g, *_ = g2o.build_graph(synthetic.make_pose_graph_2d(20, seed=0))
    assert g.freeze().device.type == "cuda"
