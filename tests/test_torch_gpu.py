"""The port's CUDA kernels and main path on a card (marked ``gpu``; skipped
where ``torch.cuda.is_available()`` is false). Imports no JAX, so it runs
on a machine with only PyTorch (``--noconftest`` skips the JAX set-up in
``tests/conftest.py``):

    python -m pytest tests/test_torch_gpu.py -m gpu -q --noconftest

- K1 vs its plain version at the Ladybug-49 shapes and at two Venice-like
  permuted sites (1,779 segments of ~2,800 rows, widths 9 and 81): within
  1e-5 relative on the card, bitwise repeatable, and bitwise equal to the
  plain version on the CPU (both sum each segment in the plan's lane
  order: row order at group 1, lanes and a halving tree above). Its
  float64 instance at the same shapes: bitwise equal to the plain version
  on the CPU, within 1e-12 of it on the card (whose ``index_add_`` adds
  in no fixed order), bitwise repeatable, counted apart; bf16 and fp16
  raise.
- K2 bitwise equal to its plain version on the card and on the CPU, which
  take every product, sum and dot in the kernel's order, and bitwise
  repeatable; no step for a zero b.
- The LM slice on CUDA and on the CPU: bitwise the same trajectory, with
  every kernel launched. At Ladybug-49, FP32_BF16 bitwise the CPU's too
  (K1 and K2 launched); FP64_FP64 the CPU's accept pattern and chi2
  within 1e-9 (float64 cos / sin are not correctly rounded on CUDA, so
  not bitwise), with K1 only in float64 and K2 not launched.
- K3, K4 (all three entry points) and K5 vs their plain versions at small
  random shapes, with masked (fill) rows, diagonal blocks and unsorted
  destinations (K3 also on a Venice-like site mixing one-, two- and
  256-lane segments; K4 also in the back-substitution's and b_schur's
  forms and with tiles off the 4-block grid; K5 also at 1, 2 and 128
  lanes per column, 6x6 blocks and a permuted column plan, one launch
  counted per call): within 1e-5 relative on the card, bitwise
  repeatable, and bitwise equal to the plain version on the CPU (which
  sums in the kernels' order).
- The LM slice at Ladybug-49 with the large-problem branches forced
  (``dense_matvec_limit=0``, the Schur gates lowered): CUDA and CPU give
  bitwise the same trajectory, and K3, K4 and K5 launch.
- K6 vs its plain version on the first solve of sphere2500 (SE3,
  block-Jacobi and identity) and of the 2500-pose SE2 circle, of both with
  a prior on the first pose (two factor blocks), and of a 4000-pose sphere
  (23,994 entries: more than 16 chunks of 1,024; also on one CTA): bitwise
  equal to the plain version on the card and on the CPU, bitwise
  repeatable, the same number of CG steps; float64 J' beside float32
  vectors and fp16 vectors raise. Its float64 instance on sphere2500's
  first solve under FP64_FP64, FP64_FP32 and FP64_BF16 (float64 or
  float32 J' and inverse blocks): bitwise the plain version on the card,
  repeatable, counted ``[f64]``, within 1e-12 of the CPU's plain version
  (PyTorch's CPU float64 sqrt is an ulp off on some inputs); a bf16 J'
  raises.
- K6 and K2 on a cluster of 1, 2, 4, 8 and 16 CTAs (each size the card
  can launch): the same bits as the plain version at every size.
- The pose-graph LM (SE3, PCGSolver(50, 1e-10, 1e6, block-Jacobi)) on
  CUDA and on the CPU: the same accept pattern, chi2 within 1e-3, K6
  launched once per solve.
- ``Graph.freeze()`` without a device builds on the card.
- ``jit_loop`` captured as a CUDA graph: bitwise the card's host loop on a
  small BAL (PCG-Schur with K2, dense Schur, the host ``splu`` branch
  split around its one sync) and a small SE3 graph (K6, and the
  multifrontal factorization); a remask reuses
  the captured graph (one cached loop, the mask ``data_ptr``s unchanged)
  and matches a fresh remaskable freeze bitwise; a kernel wrapper raises
  when ``record_events`` is set during a capture; ``profile_dir`` writes
  a trace holding the card's kernels, captured loop or not.
- Conditional regions (``device_loop.cond``, conditional graph nodes): a
  region runs on replay exactly when its predicate is true, nested
  regions too, and an inner region holding K1 and the cluster launches of
  K2 and K6 gives their eager launches' bits; a loop (``while_loop``,
  a "while" node) holding K1 runs 1,500 passes in one replay, and
  PCG-Schur's ``run_pcg_fixed`` at ``max_iter`` 1,100 under ``jit_loop``
  is one loop region, bitwise the host loop, with its CG steps;
  Ladybug-49 under ``jit_loop`` at damping 1e-8 (rejected first steps)
  bitwise the host loop, its accepted branch run on the accepted
  iterations only.
- Gradient descent and Adam on a small BAL, captured as a CUDA graph:
  bitwise the CPU run (history and final parameters), K1 in the graph.
- Covariance's Schur path on the card against the CPU within 1e-9 of the
  largest entry (float64 factors: not bitwise); ``checkpoint.load``
  lands on the card by default; the range-bearing example on the card
  bitwise the CPU run (K2 on its 3x3 SE2 pose blocks, n = 87).
- Factor-parallel sharding: two ranks on one card (the sharded
  Schur stage on K3's gathered-stream entry, K4 and K5 forced; every
  collective a K8 launch) bitwise two gloo ranks on the CPU (K8's plain
  version), both ranks equal; one nccl rank bitwise the unsharded host
  loop on the card, under the host loop and ``jit_loop`` (the collectives
  captured in the graph); two ranks under ``jit_loop`` at mini
  (PCG-Schur, and PCG with block-Jacobi, whose all-reduce sits in the CG
  loop's "while" node) bitwise their host loop.
- K7 (``csrc/bal.cu``): each of its four entries bitwise its plain
  version on the card and on the CPU, and bitwise repeatable, on small
  BAL problems (F = 300: a tail CTA of 44 factors; F = 100, below one
  CTA) with cameras in each Rodrigues branch, a fixed camera and
  disabled factors, under float32, bf16 and fp16 storage and the
  default, Huber and Cauchy losses (Cauchy's chi2 within 1e-6 of the
  CPU's: its float32 log1p is CUDA's on the card and the CPU library's on
  the CPU); the Hessian sum at every site (the camera-point one also
  transposed) on the site's plan, on 32 and 256 lanes and on sorted
  destinations at one lane, stored and then added to; Ladybug-49's LM
  under FP32_FP32 and FP32_FP16 bitwise the CPU run, with every K7 entry
  launched.
- K7's ``bal_scale_b`` at F = 1, a tile of 128 less and more one, and
  1,000,003, under each storage type, scaled and unscaled: bitwise its
  plain version on the card and on the CPU, and repeatable.
- K7's float64 instances (a float64 graph, counted ``[f64]``): each of
  the four entries bitwise its plain version on the card and
  repeatable, on the same problems and sites, under float64, float32,
  bf16 and fp16 storage (the Hessian sums in float64, or in float32
  under float32 storage, as ``inv_dtype``) and the three losses; within
  1e-12 of the CPU's plain version where float64 (the card's float64
  cos / sin are not the CPU library's), 1e-6 where float32, one ulp
  where bf16 or fp16; no float32 K7 launch. ``bal_scale_b``'s float64
  tile of 64 at F = 1, 63, 65 and 100,003: bitwise its plain version on
  the card and the CPU. Ladybug-49 with the Venice branches forced under
  FP64_FP64, FP64_FP32 and FP64_BF16: every K7 entry launches its
  float64 instance only (the trial chi2 once an iteration), ``jit_loop``
  bitwise the host loop, and FP64_FP64 the CPU's accept pattern and
  chi2 within 1e-9.
- K7's Hessian sum in all seven instances (float32, bf16 and fp16 J in a
  float32 graph; float64, float32, bf16 and fp16 J in a float64 graph) on
  random plans of uneven segments (an empty one, some shorter than their
  lanes, one of 100,003 rows beside ~3,000 short ones, and the last block,
  the trash row's, of zero J rows), permuted and sorted, at every forced
  lane count 1 ... 256, at each slot pair and the transposed one, stored
  and added to: bitwise the plain version's composition on the CPU (its
  product rows summed by K1's plain version, which ``segment_sum_ordered``
  equals there bitwise), one launch a call; a J that does not start
  16-byte aligned raises.
- K9 (``csrc/dot.cu``), the PCG's dot: bitwise ``tree_dot_plain`` at n
  from 1 to 10^6 (its cluster and multi-CTA forms, the cluster form's
  edges at 14,994, 16,002, 16,384 and 16,385 entries), float32 and
  float64, on finite inputs, all -0.0 products, +-inf and NaN;
  repeatable, and the same bits in a replayed CUDA graph; the cluster
  form the same bits on 1, 2, 4, 8 and 16 CTAs; other dtypes raise.
  Under ``jit_loop`` the CG "while" node's body launches it three times,
  the step's region twice.
- K10 (``csrc/schur_w.cu``), the landmark inverses and W = Hpl Hll^-1:
  bitwise its plain version on the card and on the CPU at dl 1, 2 and 3
  and dp 3, 6 and 9 (1,000 landmarks, some with no block, one with 700;
  -0.0 entries), with the inverses stored, not stored and alone, bitwise
  repeatable and in a replayed CUDA graph; off its dtypes, at dl 4 and
  on a misaligned start it raises; a float32 ``schur_values`` launches
  it once and gives the CPU's bits (K3's branch forced and not); a
  float64 one launches its float64 instance once, with the CPU's bits.
  At Ladybug-49 under FP32_BF16 it launches once an iteration.
- The float64 instances of K3 (both entries and the base store), K4
  (its three entries, float64 tiles of 96 blocks on a 2-block grid), K5
  (its column lanes capped to 128 at 9x9) and K10, at the shapes of
  their float32 tests: bitwise the CPU's plain version (K10 also the
  card's), repeatable, counted ``[f64]`` and never as float32; mixed
  and bf16 dtypes raise. Ladybug-49 with the Venice branches forced
  under FP64_FP64 and FP64_BF16: K3, K4, K5 and K10 launch their float64
  instances only, ``jit_loop`` bitwise the host loop, and FP64_FP64 the
  CPU's accept pattern and chi2 within 1e-9.
- K3's base store (S = Hpp - the products, written by K3's store): on
  the random and Venice-like sites, from an H group by a per-block row
  index (with -1 rows and -0.0 entries) and in place on S, bitwise its
  plain version (``product_store_plain`` of K3's own sums) on the card,
  the CPU's plain version, and the same bits replayed from a CUDA graph,
  one launch a call. Under ``jit_loop`` with K3's branch forced, the LM
  bitwise the host loop, and the loop's state after a captured accepted
  branch (relinearized in place) bitwise an eager ``linearize`` and
  ``prepare`` at its parameters.
- K11 (``csrc/pose.cu``), the SE(3) pose-graph factors' linearization,
  chi2 and update: each of its four entries bitwise its plain version on
  the card and on the CPU, and bitwise repeatable, on sphere2500 and on a
  120-pose sphere with a prior set, a fixed first pose, disabled factors,
  negative-w quaternions, near-identity errors and errors near and at pi
  (``tests/torch_k11_cases.py``), under FP32_FP32, FP32_BF16 and
  FP32_FP16 and the default, Huber and Cauchy losses (Cauchy's chi2
  within 1e-6 of the CPU's log1p); the same bits replayed from a CUDA
  graph and written into ``out``; the pose-graph LM on K11 bitwise the
  CPU run, under the host loop and ``jit_loop``, with every entry
  launched (the trial chi2 once an iteration). Its float64 instances
  (``[f64]``) on the same problems under FP64_FP64, FP64_FP32 and
  FP64_BF16: bitwise the plain version on the card and repeatable,
  within 1e-12 of the CPU's (CUDA's double sin, cos and atan2 are not
  the CPU's), no float32 launch; a float16 pose table raises. The
  FP64_FP64 pose LM on K11 and K6 ``[f64]`` only (K6 once a solve): the
  CPU's accept pattern and chi2 within 1e-9, ``jit_loop`` bitwise the
  host loop.
- K12 (``csrc/pcg_step.cu``), the CG step's vector work, and K13
  (``csrc/schur_w.cu``'s ``hll_solve``, w = Hll^-1 (t - sub)): each entry
  bitwise its plain version on the card and on the CPU (bjs_apply with and
  without the normalisation, r = 0, a type without inverses, three dtype
  pairs; the advance and commit on accepted, rejected, NaN, zero and tol
  steps at 16,002 and 7 entries; K13 at dl 1-3, float32 and float64 rows,
  identity and permuted inverse rows, with and without ``sub``), bitwise
  repeatable, one launch a call, the same bits replayed from a CUDA graph;
  off their dtypes they raise; ``run_pcg_fixed`` as a "while" node
  bitwise ``run_pcg`` on the card and the CPU; the forced Ladybug's LM
  card = CPU bitwise under the host loop and ``jit_loop``, K12 once per CG
  step and K13 twice per iteration.
- K8 (``csrc/allreduce.cu``) on two ranks of one card: its sum and
  gather bitwise its plain version (gloo on the same CUDA tensors, inputs
  with -0.0 entries; float32, float64, int64, an empty tensor), bitwise
  repeatable, one launch counted per call, the device's epoch equal to
  the eager calls since the arena last grew; a rank whose peer leaves out
  a call raises within the wait's bound, naming the call.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

import graphite_tpu_torch as gtt
from graphite_tpu_torch import schur
from graphite_tpu_torch.io import bal, g2o, synthetic
from graphite_tpu_torch.linearize import linearize
from graphite_tpu_torch.ops import pcg_loop
from graphite_tpu_torch.ops.cuda import bal as k7
from graphite_tpu_torch.ops.cuda import dot as k9
from graphite_tpu_torch.ops.cuda import pose as k11
from graphite_tpu_torch.ops.cuda import schur_w as k10
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
from graphite_tpu_torch.optimizers.lm import cached_device_loop, device_loops
from graphite_tpu_torch.preconditioners import (
    BlockJacobiPreconditioner,
    IdentityPreconditioner,
)
from graphite_tpu_torch.preconditioners.block_jacobi import (
    row_inverse_blocks,
)
from graphite_tpu_torch.solvers import (
    DenseCholeskySchurSolver,
    PCGSchurSolver,
    PCGSolver,
    SparseDirectSchurSolver,
    SparseDirectSolver,
)

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
                  (31_843, 50, 9, False), (30_621, 49, 9, False)]
VENICE_PERMUTED = [(5_001_946, 1_779, 9, False), (5_001_946, 1_779, 81, False)]


@pytest.mark.parametrize("k,ns,d,sorted_dst",
                         LADYBUG_SHAPES + VENICE_PERMUTED)
def test_k1_matches_plain(cuda_device, k, ns, d, sorted_dst):
    rng = np.random.default_rng(k + d)
    seg = rng.integers(0, ns, k)
    if sorted_dst:
        seg = np.sort(seg)
    vals_np = rng.standard_normal((k, d)).astype(np.float32)
    vals = torch.as_tensor(vals_np, device=cuda_device)
    plan = segsum.plan_segments(seg, ns, cuda_device, width=d)
    assert plan.group == segsum.group_size(k, len(np.unique(seg)), d)
    assert (plan.group > 1) == (k / ns > 8)
    out = segsum_stream.streaming_segment_sum(vals, plan)
    again = segsum.sorted_segment_sum(vals, plan)
    ref = segsum.segment_sum_plain(vals, plan)
    ref_cpu = segsum.segment_sum_plain(torch.as_tensor(vals_np),
                                       segsum.plan_segments(seg, ns, "cpu",
                                                            width=d))
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    assert torch.equal(out.cpu(), ref_cpu)
    err = (out - ref).abs().max() / ref.abs().max()
    assert float(err) <= 1e-5

    # the float64 instance: the same order, counted apart
    vals64 = vals.double()
    counts = [s.launches for s in (segsum.STATS, segsum.STATS_F64,
                                   segsum_stream.STATS,
                                   segsum_stream.STATS_F64)]
    out64 = segsum_stream.streaming_segment_sum(vals64, plan)
    again64 = segsum.sorted_segment_sum(vals64, plan)
    assert [s.launches for s in (segsum.STATS, segsum.STATS_F64,
                                 segsum_stream.STATS,
                                 segsum_stream.STATS_F64)] == [
        counts[0], counts[1] + 1, counts[2], counts[3] + 1]
    ref64 = segsum.segment_sum_plain(vals64, plan)
    ref64_cpu = segsum.segment_sum_plain(
        torch.as_tensor(vals_np).double(),
        segsum.plan_segments(seg, ns, "cpu", width=d))
    torch.cuda.synchronize()
    assert out64.dtype == torch.float64
    assert torch.equal(out64, again64)
    assert torch.equal(out64.cpu(), ref64_cpu)
    assert float((out64 - ref64).abs().max() / ref64.abs().max()) <= 1e-12
    for low in (torch.bfloat16, torch.float16):
        with pytest.raises(NotImplementedError):
            segsum.sorted_segment_sum(vals.to(low), plan)


@pytest.mark.parametrize("n,d,max_iter,tol", [
    (90, 9, 10, 1.0), (441, 9, 10, 1.0), (1024, 8, 10, 1e-12),
    (297, 3, 30, 1e-8),
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
    gpu = [torch.as_tensor(a, device=cuda_device) for a in args]
    x, k = pcg_dense.dense_pcg(*gpu, **kw)
    again, k2 = pcg_dense.dense_pcg(*gpu, **kw)
    x_dev, k_dev = pcg_dense.dense_pcg_plain(*gpu, **kw)
    x_ref, k_ref = pcg_dense.dense_pcg_plain(
        *[torch.as_tensor(a) for a in args], **kw)
    torch.cuda.synchronize()
    assert int(k) == int(k2) == int(k_dev) == int(k_ref)
    assert torch.equal(x, again) and torch.equal(x, x_dev)
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


def _ladybug_runs(device, precision, iterations=10):
    """CPU and card LM runs of PCGSchurSolver(10, 1.0, 5.0) at Ladybug-49
    under ``precision``, with every kernel's launches on the card."""
    from graphite_tpu_torch.ops.cuda.launches import REGISTRY

    runs = []
    for dev in ("cpu", device):
        g, *_ = bal.build_graph(synthetic.make_bal("ladybug", seed=0),
                                precision=precision)
        problem = g.freeze(device=dev)
        for s in REGISTRY:
            s.reset()
        runs.append(levenberg_marquardt(
            problem, PCGSchurSolver(10, 1.0, 5.0),
            options=LevenbergMarquardtOptions(iterations=iterations)))
    return (*runs, {s.name: s.launches for s in REGISTRY})


def test_ladybug_fp32_bf16_cuda_equals_cpu(cuda_device):
    cpu, gpu, launches = _ladybug_runs(cuda_device, gtt.FP32_BF16)
    assert ([(h["chi2"], h["accepted"]) for h in gpu.history]
            == [(h["chi2"], h["accepted"]) for h in cpu.history])
    for name, p in gpu.params.items():
        assert torch.equal(p.cpu(), cpu.params[name])
    assert launches["pcg_dense.dense_pcg"] == len(gpu.history)
    assert launches[k10.STATS.name] == len(gpu.history)
    assert launches["segsum_stream.streaming_segment_sum"] > 0
    assert launches["segsum_stream.streaming_segment_sum[f64]"] == 0
    assert gpu.chi2 < gpu.initial_chi2


def test_ladybug_fp64_cuda_matches_cpu(cuda_device):
    cpu, gpu, launches = _ladybug_runs(cuda_device, gtt.FP64_FP64)
    assert ([h["accepted"] for h in gpu.history]
            == [h["accepted"] for h in cpu.history])
    np.testing.assert_allclose([h["chi2"] for h in gpu.history],
                               [h["chi2"] for h in cpu.history], rtol=1e-9)
    # float64 sites: K1's float64 instance only, no float32 kernel
    assert launches["segsum_stream.streaming_segment_sum[f64]"] > 0
    assert launches["segsum.sorted_segment_sum[f64]"] > 0
    assert all(n == 0 for name, n in launches.items()
               if not name.endswith("[f64]"))
    assert gpu.chi2 < gpu.initial_chi2


def _on(device, *arrays):
    return [None if a is None else torch.as_tensor(a, device=device)
            for a in arrays]


def _check_kernel(out, again, ref, ref_cpu):
    torch.cuda.synchronize()
    for o, a, r, c in zip(out, again, ref, ref_cpu):
        assert torch.equal(o, a)
        assert torch.equal(o.cpu(), c)
        assert float((o - r).abs().max() / r.abs().max()) <= 1e-5


def _k3_site(rng, site):
    """Sorted destinations: random (1,800 segments of ~11 rows), or
    Venice-like: 2,000 segments of ~8 rows (one or two lanes) and 20 of
    ~2,800 (256 lanes), in mixed order; "lone-256": one 256-lane segment
    and 65 of 1-8 rows (the float64 design's cluster pair, then a grid
    padded to whole clusters)."""
    if site in ("random", "null-li"):
        return np.sort(rng.integers(0, 1_800, 20_000)), 1_800
    if site == "lone-256":
        lengths = np.concatenate([[2_600], rng.integers(1, 9, 65)])
        return np.repeat(np.arange(lengths.size), lengths), lengths.size
    lengths = np.concatenate([rng.poisson(8, 2_000),
                              rng.integers(2_750, 2_850, 20)])
    lengths = lengths[rng.permutation(lengths.size)]
    return np.repeat(np.arange(lengths.size), lengths), lengths.size


@pytest.mark.parametrize("m,k,n,site", [
    pytest.param(9, 3, 9, "random", id="9-3-9"),
    pytest.param(4, 3, 2, "random", id="4-3-2"),
    pytest.param(9, 9, 9, "random", id="9-9-9"),
    pytest.param(9, 3, 9, "venice", id="9-3-9-venice"),
    # (m + n) * k = 300: three stages fit the opt-in limit only without
    # the static slot table, so the launch takes two
    pytest.param(15, 10, 15, "random", id="15-10-15-two-stages"),
])
def test_k3_matches_plain(cuda_device, m, k, n, site):
    rng = np.random.default_rng(m * 100 + k * 10 + n)
    seg, ns = _k3_site(rng, site)
    rows, n_l, n_r = seg.size, 5_000, 4_000
    ltab = rng.standard_normal((n_l, m * k)).astype(np.float32)
    rtab = rng.standard_normal((n_r, n * k)).astype(np.float32)
    li = rng.integers(0, n_l, rows).astype(np.int32)
    ri = rng.integers(0, n_r, rows).astype(np.int32)
    runs = []
    for device in (cuda_device, "cpu"):
        plan = segsum_stream.plan_products(seg, ns, device)
        L, R, lt, rt = _on(device, ltab, rtab, li, ri)
        runs.append((L, R, lt, rt, plan))
    L, R, lt, rt, plan = runs[0]
    if site == "venice":
        assert {1, 2, 256} <= set(plan.lanes.tolist())

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
            L.bfloat16(), R.bfloat16(), plan, m, k, n, lt, rt)
    with pytest.raises(NotImplementedError):  # one dtype
        segsum_stream.streaming_segment_product_sum_rtbl(
            L, R.double(), plan, m, k, n, lt, rt)


def _k3_bits(t):
    return t.view(torch.int32)


@pytest.mark.parametrize("in_place", [False, True])
@pytest.mark.parametrize("site", ["random", "venice"])
def test_k3_base_store_matches_plain_bitwise(cuda_device, site, in_place):
    """K3 storing base - sums: bitwise ``product_store_plain`` of its own
    sums on the card, bitwise the CPU's plain version, and the same bits
    replayed from a CUDA graph; one launch a call."""
    m, k, n = 9, 3, 9
    rng = np.random.default_rng(17 + in_place)
    seg, ns = _k3_site(rng, site)
    rows, n_l, n_r, n_h = seg.size, 5_000, 4_000, ns + 100
    ltab = rng.standard_normal((n_l, m * k)).astype(np.float32)
    rtab = rng.standard_normal((n_r, n * k)).astype(np.float32)
    li = rng.integers(0, n_l, rows).astype(np.int32)
    ri = rng.integers(0, n_r, rows).astype(np.int32)
    htab = rng.standard_normal((n_h, m * n)).astype(np.float32)
    htab.reshape(-1)[::5] = -0.0
    bidx = np.full(ns, -1, dtype=np.int32)
    has = rng.random(ns) < 0.5
    bidx[has] = rng.permutation(n_h)[:int(has.sum())]
    runs = []
    for device in (cuda_device, "cpu"):
        runs.append((segsum_stream.plan_products(seg, ns, device),
                     *_on(device, ltab, rtab, li, ri, htab, bidx)))

    def store(plan, L, R, lt, rt, H, bi, out=None):
        if in_place:  # a later product group: S itself is the base
            return segsum_stream.streaming_segment_product_sum_rtbl(
                L, R, plan, m, k, n, lt, rt, base=out)
        return segsum_stream.streaming_segment_product_sum_rtbl(
            L, R, plan, m, k, n, lt, rt, base=H, base_idx=bi)

    def start(H):  # the S a later group finds
        return H[:ns].clone()

    plan, L, R, lt, rt, H, bi = runs[0]
    before = segsum_stream.PRODUCT_RTBL_STATS.launches
    s0 = start(H)
    out = store(plan, L, R, lt, rt, H, bi, s0)
    assert segsum_stream.PRODUCT_RTBL_STATS.launches - before == 1
    if in_place:
        assert out.data_ptr() == s0.data_ptr()
    sums = segsum_stream.streaming_segment_product_sum_rtbl(
        L, R, plan, m, k, n, lt, rt)
    ref = (segsum_stream.product_store_plain(sums, start(H), None)
           if in_place else
           segsum_stream.product_store_plain(sums, H, bi))
    again = store(plan, L, R, lt, rt, H, bi, start(H))
    cplan, cL, cR, clt, crt, cH, cbi = runs[1]
    cpu = store(cplan, cL, cR, clt, crt, cH, cbi, start(cH))
    s1 = start(H)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = store(plan, L, R, lt, rt, H, bi, s1)
    s1.copy_(start(H))
    graph.replay()
    torch.cuda.synchronize()
    for got in (out, again, captured):
        assert torch.equal(_k3_bits(got), _k3_bits(ref))
    assert torch.equal(_k3_bits(out.cpu()), _k3_bits(cpu))


@pytest.mark.parametrize("base", ["none", "empty"])
def test_k3_base_store_with_no_hpp_group(cuda_device, base):
    """An S group with no Hpp group: every base index -1 and no base
    rows (None, or an empty group, whose data pointer is null). K3 stores
    +0.0 - sum, bitwise a zero S minus its own sums and the CPU's."""
    m, k, n = 4, 3, 2
    rng = np.random.default_rng(23)
    seg, ns = _k3_site(rng, "random")
    rows, n_l, n_r = seg.size, 5_000, 4_000
    ltab = rng.standard_normal((n_l, m * k)).astype(np.float32)
    rtab = rng.standard_normal((n_r, n * k)).astype(np.float32)
    li = rng.integers(0, n_l, rows).astype(np.int32)
    ri = rng.integers(0, n_r, rows).astype(np.int32)
    bidx = np.full(ns, -1, dtype=np.int32)
    got = []
    for device in (cuda_device, "cpu"):
        plan = segsum_stream.plan_products(seg, ns, device)
        L, R, lt, rt, bi = _on(device, ltab, rtab, li, ri, bidx)
        rows_ = None if base == "none" else torch.empty(
            (0, m * n), device=device)
        out = segsum_stream.streaming_segment_product_sum_rtbl(
            L, R, plan, m, k, n, lt, rt, base=rows_, base_idx=bi)
        sums = segsum_stream.streaming_segment_product_sum_rtbl(
            L, R, plan, m, k, n, lt, rt)
        assert torch.equal(_k3_bits(out), _k3_bits(torch.zeros_like(sums)
                                                   - sums))
        got.append(out.cpu())
    assert torch.equal(_k3_bits(got[0]), _k3_bits(got[1]))
    assert bool(torch.signbit(got[0]).any())


def _two_pose_types(kind):
    """Float32 graphs of ``test_torch_schur.py``'s shapes, without JAX:
    ``multitype`` (a dim-4 and a dim-2 pose joined only through shared
    dim-3 landmarks, so its (4, 2) S group has product pairs
    and no Hpp group; a second landmark type, two product groups into one
    S group) and ``mixed_dims`` (pose-pose factors: Hpp blocks off the
    diagonal; S blocks with no pair). Residuals bilinear in the two
    vertices, Jacobians by autodiff."""
    if kind == "multitype":
        vertices = [("p4", 4, 3, 0, False), ("p2", 2, 2, 100, False),
                    ("l3", 3, 6, 200, True), ("l1", 1, 4, 300, True)]
        factors = [("f43", 2, ("p4", "l3"), 30), ("f41", 1, ("p4", "l1"), 15),
                   ("f23", 2, ("p2", "l3"), 20)]
    else:
        vertices = [("p3", 3, 4, 0, False), ("l3", 3, 7, 100, True)]
        factors = [("f33", 2, ("p3", "l3"), 40), ("f33pp", 2, ("p3", "p3"), 6)]
    rng = np.random.default_rng(5)
    g = gtt.Graph(precision=gtt.FP32_FP32)
    vt, base = {}, {}
    for name, dim, count, id_base, elim in vertices:
        vt[name] = gtt.vertex_type(name, dim)
        vs = g.add_vertex_set(vt[name])
        vs.add_batch(id_base + np.arange(count),
                     rng.normal(1.0 if not elim else 0.5, 0.3, (count, dim)))
        if elim:
            vs.set_eliminate(True)
        base[name] = id_base
    for fname, edim, (va, vb), count in factors:
        da, db = vt[va].dim, vt[vb].dim

        def res(a, b, o, edim=edim, da=da, db=db):
            return torch.stack(
                [a[..., i % da] * b[..., (i + 1) % db] + a[..., (i + 1) % da]
                 - b[..., i % db] - o[..., i] for i in range(edim)], dim=-1)

        ft = gtt.factor_type(fname, edim, [vt[va], vt[vb]], res,
                             obs_shape=(edim,))
        na = next(v[2] for v in vertices if v[0] == va)
        nb = next(v[2] for v in vertices if v[0] == vb)
        pairs = np.stack([base[va] + rng.integers(na, size=count),
                          base[vb] + rng.integers(nb, size=count)], axis=1)
        g.add_factor_set(ft).add_batch(pairs,
                                       obs=rng.normal(0, 1, (count, edim)))
    return g


@pytest.mark.parametrize("kind", ["multitype", "mixed_dims"])
def test_k3_schur_values_without_hpp_cuda_equals_cpu(cuda_device,
                                                     monkeypatch, kind):
    """``schur_values`` with K3's branch forced, on the card, from the
    CPU's damped Hessian values: the CPU's bits in every S group, those
    with no Hpp group (multitype's (4, 2)) and those with Hpp
    blocks and a second product group included; one K3 launch a group."""
    from graphite_tpu_torch import hessian

    monkeypatch.setattr(schur, "CHUNK_THRESHOLD", 0)
    cpu = _two_pose_types(kind).freeze(device="cpu")
    ss = schur.build_schur_structure(cpu)
    hs = hessian.build_hessian_structure(cpu)
    lin = linearize(cpu, cpu.params0)
    hv = hessian.apply_damping(
        cpu, hs, hessian.compute_hessian_values(cpu, hs, lin), lin.diag,
        1e-2, False)
    gpu = cpu.to(cuda_device)
    if kind == "multitype":
        assert any(not any(h == key for h, _, _ in ss.hpp_copy)
                   for key in {pg["dst_key"] for pg in ss.products})
    before = segsum_stream.PRODUCT_RTBL_STATS.launches
    got = schur.schur_values(gpu, ss, {k: v.to(cuda_device)
                                       for k, v in hv.items()})
    torch.cuda.synchronize()
    assert (segsum_stream.PRODUCT_RTBL_STATS.launches - before
            == len(ss.products))
    ref = schur.schur_values(cpu, ss, hv)
    assert list(got.s_vals) == list(ref.s_vals) == ss.s_keys
    for key in ss.s_keys:
        assert torch.equal(_k3_bits(got.s_vals[key].cpu()),
                           _k3_bits(ref.s_vals[key]))


def test_f64_designs_fit(cuda_device):
    """The float64 designs as the card builds them: K3's (9, 3, 9)
    instance with no local memory (no spills) and two CTAs an SM, the
    float32 design's float64 instance only where the padded rows do not
    fit; K6's three float64 instances with no local memory, on 256
    threads."""
    k3 = segsum_stream.product_instance(torch.float64, 9, 3, 9)
    assert k3["design"] == "float64" and k3["local_bytes"] == 0
    assert k3["ctas_per_sm"] >= 2 and k3["threads"] == 576
    assert segsum_stream.product_instance(
        torch.float64, 16, 7, 16)["design"] == "float32"
    assert segsum_stream.product_instance(
        torch.float32, 9, 3, 9)["design"] == "float32"
    for jf, minv in ((torch.float64, torch.float64),
                     (torch.float32, torch.float32),
                     (torch.float32, torch.float64)):
        for d in (6, 3):
            k6 = pcg_mf.instance(True, jf, minv, True, d)
            assert k6["local_bytes"] == 0, (jf, minv, d, k6)
            assert k6["threads"] == pcg_mf.THREADS_F64


@pytest.mark.parametrize("rows,ns,sorted_dst,transpose", [
    pytest.param(50_000, 40, False, False, id="40-False"),
    pytest.param(50_000, 40, False, True, id="40-True"),
    pytest.param(50_000, 15_000, False, False, id="15000-False"),
    pytest.param(50_000, 15_000, False, True, id="15000-True"),
    # the back-substitution's form: ~5 rows a segment, sorted, one lane
    pytest.param(500_000, 100_000, True, True, id="back-substitution"),
    # b_schur's: 1,778 segments of ~2,800 rows through a permutation
    pytest.param(4_978_400, 1_778, False, False, id="b_schur"),
    # long unpermuted segments: tiles that start off the 4-block grid
    pytest.param(50_003, 40, True, False, id="unaligned-tiles"),
])
def test_k4_matches_plain(cuda_device, rows, ns, sorted_dst, transpose):
    """Few destinations (a group of threads per segment) and many (one
    thread per segment), sorted and unsorted destinations, ~5% masked
    rows."""
    m, k = 9, 3
    rng = np.random.default_rng(ns + transpose)
    n_x = 3_000
    dst = rng.integers(0, ns, rows)
    if sorted_dst:
        dst = np.sort(dst)
    left = rng.standard_normal((rows, m * k)).astype(np.float32)
    xd = m if transpose else k
    x = rng.standard_normal((n_x, xd)).astype(np.float32)
    xi = rng.integers(0, n_x, rows)
    xi[rng.random(rows) < 0.05] = n_x
    xi = xi.astype(np.int32)
    gpu = _on(cuda_device, left, x, xi)
    cpu = _on("cpu", left, x, xi)
    plan = segsum.plan_segments(dst, ns, cuda_device)
    plan_cpu = segsum.plan_segments(dst, ns, "cpu")
    assert (plan.group > 1) == (rows / ns > 8)
    assert (plan.perm is None) == sorted_dst
    if sorted_dst and plan.group > 1:
        spc = segmv.K4_THREADS // plan.group
        assert np.any(plan_cpu.offsets.numpy()[:-1:spc] % 4 != 0)

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


@pytest.mark.parametrize("n,m,group,sorted_cols", [
    (70, 9, None, True),    # long columns: 128 lanes, 9x9 blocks
    (6_000, 9, None, True),  # ~10 blocks per column: 2 lanes
    (500, 9, 1, True),      # one lane: 32 columns per CTA
    (70, 6, None, True),    # a block shape the kernel takes at run time
    (70, 9, None, False),   # a column plan with a permutation
])
def test_k5_matches_plain(cuda_device, n, m, group, sorted_cols):
    """Diagonal blocks (5%) read a zero x_r row; both outputs checked."""
    k = m
    rng = np.random.default_rng(n + m)
    rows, n_r, n_c = 60_000, n, n
    rid = rng.integers(0, n_r, rows)
    cid = rng.integers(0, n_c, rows)
    if sorted_cols:
        cid = np.sort(cid)  # CSC: columns sorted
    diag = rng.random(rows) < 0.05
    rxi = np.where(diag, n_r, rid).astype(np.int32)
    left = rng.standard_normal((rows, m * k)).astype(np.float32)
    xc = rng.standard_normal((n_c, k)).astype(np.float32)
    xr = rng.standard_normal((n_r, m)).astype(np.float32)
    arrays = (left, xc, xr, cid.astype(np.int32), rxi)
    gpu, cpu = _on(cuda_device, *arrays), _on("cpu", *arrays)
    plan = segmv.plan_matvec_sym(rid, cid, n_r, n_c, cuda_device, m, group)
    plan_cpu = segmv.plan_matvec_sym(rid, cid, n_r, n_c, "cpu", m, group)
    assert (plan.cols.perm is None) == sorted_cols
    if n == 70 and group is None:
        # K1's row pass: at most 64 lanes at width 9 (128 at width 6); the
        # column pass takes K4's rule
        assert (plan.rows.group, plan.cols.group) == (64 if m == 9 else 128,
                                                      128)
    stats = (segmv.SYM_STATS, segsum.STATS, segsum_stream.STATS)
    before = [s.launches for s in stats]
    out = segmv.matvec_sym_stream(*gpu, plan, m, k)
    # K1, its second pass, is not counted as a K1 launch
    assert [s.launches for s in stats] == [before[0] + 1] + before[1:]
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


def _first_pose_solve(device, kind, precond, mu=1e-4, poses=2500,
                      prior=False, policy=gtt.FP32_FP32):
    """The inputs of K6 on the first LM solve of a pose graph (with a prior
    on the first pose, left free: two factor blocks) under ``policy``."""
    d = 6 if kind == "se3" else 3
    g, *_ = g2o.build_graph(
        _pose_dataset(kind, poses), precision=policy,
        fix_first=not prior,
        prior_information=np.eye(d) * 1e6 if prior else None)
    problem = g.freeze(device=device)
    lin = linearize(problem, problem.params0)
    site = pcg_mf.plan_pcg_mf(problem, lin)
    assert site is not None
    damping = torch.tensor(mu, dtype=policy.graph_dtype,
                           device=problem.device)
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


K6_KW = dict(max_iter=50, tol=1e-10, rejection_ratio=1e6)


def _on_cpu_site(site):
    return dataclasses.replace(
        site, **{f.name: getattr(site, f.name).cpu()
                 for f in dataclasses.fields(site)
                 if isinstance(getattr(site, f.name), torch.Tensor)})


def _k6_plain_both(args):
    """K6's plain version on the card and on the CPU: (x, steps) each."""
    site, jf, b, damp, minv = args
    dev = pcg_mf.solve_pcg_mf_plain(*args, **K6_KW)
    cpu = pcg_mf.solve_pcg_mf_plain(
        _on_cpu_site(site), jf.cpu(), b.cpu(), damp.cpu(),
        None if minv is None else minv.cpu(), **K6_KW)
    return dev, cpu


@pytest.mark.parametrize("kind,precond,poses,prior,cluster", [
    ("se3", "bj", 2500, False, None), ("se3", "identity", 2500, False, None),
    ("se2", "bj", 2500, False, None),
    ("se3", "bj", 4000, False, None),  # 3,999 free rows: 24 chunks on 16
    # one CTA: its incidences' structure no longer fits in shared memory
    ("se3", "bj", 4000, False, 1),
    ("se3", "bj", 2500, True, None),  # two factor blocks: prior, between
    ("se2", "identity", 2500, True, 4),
])
def test_k6_matches_plain(cuda_device, kind, precond, poses, prior,
                          cluster):
    args = _first_pose_solve(cuda_device, kind, precond, poses=poses,
                             prior=prior)
    site, jf, b, damp, minv = args
    assert len(site.blocks) == (2 if prior else 1)
    if poses == 4000:
        assert site.n * site.d > 16 * pcg_mf.CHUNK
    x, k = pcg_mf.solve_pcg_mf(*args, **K6_KW, cluster=cluster)
    again, k2 = pcg_mf.solve_pcg_mf(*args, **K6_KW, cluster=cluster)
    (ref, k_ref), (ref_cpu, k_cpu) = _k6_plain_both(args)
    torch.cuda.synchronize()
    assert int(k) == int(k2) == int(k_ref) == int(k_cpu) > 0
    assert torch.equal(x, again) and torch.equal(x, ref)
    assert torch.equal(x.cpu(), ref_cpu)
    # dtypes with no instance: float64 J' beside float32 vectors, fp16
    # vectors
    for bad in ((site, jf.double(), b, damp, None),
                (site, jf, b.half(), damp.half(), None)):
        with pytest.raises(NotImplementedError):
            pcg_mf.solve_pcg_mf(*bad, **K6_KW)


@pytest.mark.parametrize("policy,precond,prior,cluster", [
    pytest.param(*case, None, id="-".join(map(str, case))) for case in (
        ("FP64_FP64", "bj", False), ("FP64_FP64", "identity", False),
        ("FP64_FP32", "bj", False), ("FP64_FP32", "identity", False),
        ("FP64_BF16", "bj", False), ("FP64_FP64", "bj", True))] + [
    # the float64 design on other cluster sizes: the same bits
    pytest.param("FP64_FP64", precond, False, c,
                 id=f"FP64_FP64-{precond}-False-cluster{c}")
    for precond, c in (("bj", 1), ("bj", 8), ("identity", 16))])
def test_k6_f64_matches_plain(cuda_device, policy, precond, prior, cluster):
    """K6's float64 instance on sphere2500's first solve under the FP64
    policies (J' float64 under FP64_FP64, float32 under FP64_FP32 and
    FP64_BF16; the inverse blocks float32 under FP64_FP32): bitwise its
    plain version on the card, repeatable, the same CG steps as the plain
    version on the card and on the CPU, counted under its ``[f64]`` name;
    a bf16 J', and a float64 J' beside float32 inverse blocks (no policy
    makes it), raise. Against the CPU's plain version within 1e-12 of the
    largest entry, not bitwise: PyTorch's CPU float64 sqrt is an ulp off
    on ~0.7% of inputs (its CUDA sqrt and the kernel's __dsqrt_rn are
    IEEE), and one such ||r|| (FP64_BF16, CG step 41 of 50) moves the
    rest of the solve by ~2e-15."""
    args = _first_pose_solve(cuda_device, "se3", precond, prior=prior,
                             policy=getattr(gtt, policy))
    site, jf, b, damp, minv = args
    assert b.dtype == torch.float64
    assert jf.dtype == (torch.float64 if policy == "FP64_FP64"
                        else torch.float32)
    before = (pcg_mf.STATS.launches, pcg_mf.STATS_F64.launches)
    x, k = _cluster_or_skip(
        lambda: pcg_mf.solve_pcg_mf(*args, **K6_KW, cluster=cluster),
        cluster)
    again, k2 = pcg_mf.solve_pcg_mf(*args, **K6_KW, cluster=cluster)
    assert (pcg_mf.STATS.launches - before[0],
            pcg_mf.STATS_F64.launches - before[1]) == (0, 2)
    (ref, k_ref), (ref_cpu, k_cpu) = _k6_plain_both(args)
    torch.cuda.synchronize()
    assert x.dtype == torch.float64
    assert int(k) == int(k2) == int(k_ref) == int(k_cpu) > 0
    assert torch.equal(x, again) and torch.equal(x, ref)
    assert float((x.cpu() - ref_cpu).abs().max()) <= 1e-12 * float(
        ref_cpu.abs().max())
    bad = [(site, jf.bfloat16(), b, damp, minv)]
    if minv is not None and policy == "FP64_FP64":  # no policy makes it
        bad.append((site, jf, b, damp, minv.float()))
    for args in bad:
        with pytest.raises(NotImplementedError):
            pcg_mf.solve_pcg_mf(*args, **K6_KW)


def _cluster_or_skip(run, cluster):
    try:
        return run()
    except RuntimeError as err:
        if "too many resources" in str(err):
            pytest.skip(f"no cluster of {cluster} CTAs fits on this card")
        raise


@pytest.mark.parametrize("cluster", [1, 2, 4, 8, 16])
def test_k6_same_bits_at_every_cluster_size(cuda_device, cluster):
    args = _first_pose_solve(cuda_device, "se3", "bj")
    x, k = _cluster_or_skip(lambda: pcg_mf.solve_pcg_mf(
        *args, **K6_KW, cluster=cluster), cluster)
    ref, k_ref = pcg_mf.solve_pcg_mf_plain(*args, **K6_KW)
    torch.cuda.synchronize()
    assert int(k) == int(k_ref) > 0 and torch.equal(x, ref)


@pytest.mark.parametrize("cluster", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("n", [441, 1024])
def test_k2_same_bits_at_every_cluster_size(cuda_device, n, cluster):
    """n = 441 keeps S's and M's slices resident at 2 or more CTAs; 1,024
    streams them at every size."""
    rng = np.random.default_rng(n)
    A = rng.standard_normal((n, n))
    S = A @ A.T + n * np.eye(n)
    M = np.zeros_like(S)
    for i in range(0, n, 9):
        M[i:i + 9, i:i + 9] = np.linalg.inv(S[i:i + 9, i:i + 9])
    args = [torch.as_tensor(a.astype(np.float32), device=cuda_device)
            for a in (S, M, rng.standard_normal(n))]
    kw = dict(max_iter=10, tol=1e-12, rejection_ratio=5.0)
    x, k = _cluster_or_skip(lambda: pcg_dense.dense_pcg(
        *args, **kw, cluster=cluster), cluster)
    ref, k_ref = pcg_dense.dense_pcg_plain(*args, **kw)
    torch.cuda.synchronize()
    assert int(k) == int(k_ref) > 0 and torch.equal(x, ref)


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


def _direct_problem(kind, device, precision=gtt.FP32_FP32):
    if kind == "sphere":
        g, *_ = g2o.build_graph(synthetic.make_sphere_se3(300, seed=0),
                                precision=precision)
    else:
        g, *_ = bal.build_graph(
            synthetic.make_bal((12, 120, 700), seed=0, noise=0.5),
            precision=precision, eliminate_points=kind == "schur")
    return g.freeze(device=device)


def _damped_system(problem, solver, mu):
    """The damped matrix and right-hand side the solver factors."""
    from graphite_tpu_torch.hessian import (
        apply_damping,
        build_hessian_structure,
        compute_hessian_values,
        dense_hessian_matrix,
    )
    from graphite_tpu_torch.solvers import dense_cholesky_schur as dcs

    lin = linearize(problem, problem.params0)
    state = solver.prepare(problem, lin)
    if isinstance(state, dcs.SchurSolverState):
        ops, b_s = dcs.schur_system(problem, lin, state, mu, False)
        return dcs.schur_to_dense(problem, ops.ss, ops.sv), b_s
    hs = build_hessian_structure(problem)
    hv = apply_damping(problem, hs, compute_hessian_values(problem, hs, lin),
                       lin.diag, mu, False)
    return dense_hessian_matrix(problem, hs, hv), lin.b[: problem.dim_h]


def _direct_solvers():
    from graphite_tpu_torch.solvers import (
        DenseCholeskySchurSolver,
        DenseCholeskySolver,
        SparseDirectSchurSolver,
        SparseDirectSolver,
    )

    return {
        "dense": (DenseCholeskySolver(), "full"),
        "dense_schur": (DenseCholeskySchurSolver(), "schur"),
        "sparse_on_device": (SparseDirectSolver(), "full"),
        "sparse_nd_bal": (SparseDirectSolver(multifrontal=True), "full"),
        "sparse_nd_sphere": (SparseDirectSolver(multifrontal=True), "sphere"),
        "sparse_schur": (SparseDirectSchurSolver(), "schur"),
    }


DIRECT = ["dense", "dense_schur", "sparse_on_device", "sparse_nd_bal",
          "sparse_nd_sphere", "sparse_schur"]


@pytest.mark.parametrize("name", DIRECT)
def test_direct_first_solve_on_card(cuda_device, name):
    """The card's float32 solve against the float64 system on the CPU
    (relative residual <= 1e-4), two card runs bitwise equal."""
    solver, kind = _direct_solvers()[name]
    problem = _direct_problem(kind, cuda_device)
    lin = linearize(problem, problem.params0)
    state = solver.prepare(problem, lin)
    delta, ok = solver.solve(problem, lin, state, 1e-4, False)
    again, _ = solver.solve(problem, lin, state, 1e-4, False)
    assert bool(ok) and torch.equal(delta, again)
    A, b = _damped_system(_direct_problem(kind, "cpu", gtt.FP64_FP64),
                          solver, 1e-4)
    x = delta[: b.shape[0]].cpu().double()
    assert float((A @ x - b).norm() / b.norm()) <= 1e-4


@pytest.mark.parametrize("name", DIRECT)
def test_direct_indefinite_system_fails_on_card(cuda_device, name):
    solver, kind = _direct_solvers()[name]
    problem = _direct_problem(kind, cuda_device)
    lin = linearize(problem, problem.params0)
    delta, ok = solver.solve(problem, lin, solver.prepare(problem, lin),
                             -10.0, True)
    assert ok.device.type == "cuda"
    assert not bool(ok) and not bool(delta.any())


def test_k1_at_nd_sites_matches_plain(cuda_device):
    """K1 at every extend-add and right-hand-side site of the
    multifrontal plan of a 300-pose sphere, and the sums it feeds."""
    from graphite_tpu_torch.hessian import build_hessian_structure
    from graphite_tpu_torch.ops import nd_multifrontal as nd

    problem = _direct_problem("sphere", cuda_device)
    plan = nd.build_nd_plan(problem, build_hessian_structure(problem))
    rng = np.random.default_rng(7)
    checked = 0
    for st in nd.nd_sites(problem, plan):
        for site in (st.ea, st.rhs):
            if site is None:
                continue
            sp = site.plan
            vals_np = rng.standard_normal((sp.rows, 1)).astype(np.float32)
            (vals,) = _on(cuda_device, vals_np)
            before = segsum_stream.STATS.launches
            out = segsum_stream.streaming_segment_sum(vals, sp)
            assert segsum_stream.STATS.launches == before + 1
            again = segsum_stream.streaming_segment_sum(vals, sp)
            ref = segsum.segment_sum_plain(vals, sp)
            cplan = dataclasses.replace(sp, **{
                f.name: getattr(sp, f.name).cpu()
                for f in dataclasses.fields(sp)
                if torch.is_tensor(getattr(sp, f.name))})
            ref_cpu = segsum.segment_sum_plain(torch.as_tensor(vals_np),
                                               cplan)
            _check_kernel([out], [again], [ref], [ref_cpu])
            checked += 1
    assert checked >= 2


def _bitwise(a, b):
    assert [h["accepted"] for h in a.history] == [
        h["accepted"] for h in b.history]
    assert [h["chi2"] for h in a.history] == [h["chi2"] for h in b.history]
    assert (a.chi2, a.initial_chi2, a.mu) == (b.chi2, b.initial_chi2, b.mu)
    for n, p in b.params.items():
        assert torch.equal(a.params[n], p)


def _small_bal(device, remaskable=False):
    g, *_ = bal.build_graph(
        synthetic.make_bal((12, 120, 700), seed=0, noise=0.5),
        precision=gtt.FP32_FP32)
    return g.freeze(device=device, remaskable=remaskable)


def _small_se3(device):
    g, *_ = g2o.build_graph(synthetic.make_sphere_se3(300, seed=0),
                            precision=gtt.FP32_FP32)
    return g.freeze(device=device)


JIT_CASES = {
    "bal-pcg-schur": (_small_bal, lambda: PCGSchurSolver(10, 1.0, 5.0), 8),
    "bal-dense-schur": (_small_bal, DenseCholeskySchurSolver, 8),
    "bal-splu": (_small_bal,
                 lambda: SparseDirectSchurSolver(on_device_dim_p=0), 4),
    "se3-k6": (_small_se3,
               lambda: PCGSolver(50, 1e-10, 1e6, BlockJacobiPreconditioner()),
               10),
    "se3-multifrontal": (_small_se3,
                         lambda: SparseDirectSolver(multifrontal=True), 4),
}


@pytest.mark.parametrize("case", sorted(JIT_CASES))
def test_jit_loop_captured_equals_host_loop(cuda_device, case):
    make, make_solver, iters = JIT_CASES[case]
    problem, solver = make(cuda_device), make_solver()
    host = levenberg_marquardt(problem, solver,
                               options=LevenbergMarquardtOptions(
                                   iterations=iters))
    opts = LevenbergMarquardtOptions(iterations=iters, jit_loop=True)
    first = levenberg_marquardt(problem, solver, options=opts)
    again = levenberg_marquardt(problem, solver, options=opts)
    loop = cached_device_loop(problem, solver, opts)
    assert loop.capture is not None
    assert loop.capture.host_calls == (1 if case == "bal-splu" else 0)
    _bitwise(first, host)
    _bitwise(again, host)
    if case == "se3-k6":
        assert loop.capture_launches["pcg_mf.solve_pcg_mf"] == 1
    if case == "bal-pcg-schur":
        assert loop.capture_launches["pcg_dense.dense_pcg"] == 1


def test_jit_loop_relinearizes_in_place_bitwise_eager(cuda_device,
                                                     monkeypatch):
    """With K3's branch forced (its base store in every ``schur_values``)
    the captured LM is bitwise the host loop, and after a run that ends
    on an accepted step the loop's linearization and Hessian values,
    written in place by the captured accepted branch, are bitwise an
    eager ``linearize`` and ``prepare`` at its parameters."""
    monkeypatch.setattr(schur, "CHUNK_THRESHOLD", 0)
    problem = _small_bal(cuda_device)
    solver = PCGSchurSolver(10, 1.0, 5.0, dense_matvec_limit=0)
    before = segsum_stream.PRODUCT_RTBL_STATS.launches
    host = levenberg_marquardt(problem, solver,
                               options=LevenbergMarquardtOptions(
                                   iterations=6))
    assert segsum_stream.PRODUCT_RTBL_STATS.launches > before
    accepted = [h["accepted"] for h in host.history]
    last = max(i for i, a in enumerate(accepted) if a) + 1
    opts = LevenbergMarquardtOptions(iterations=last, jit_loop=True)
    out = levenberg_marquardt(problem, solver, options=opts)
    loop = cached_device_loop(problem, solver, opts)
    assert loop.capture.region_runs()["lm_accept"] > 0
    assert loop.capture_launches[
        "segsum_stream.streaming_segment_product_sum_rtbl"] == 1
    assert [h["accepted"] for h in out.history] == accepted[:last]
    assert [h["chi2"] for h in out.history] == [
        h["chi2"] for h in host.history[:last]]
    lin = linearize(problem, loop.params)
    hvals = solver.prepare(problem, lin, loop.params).hvals
    torch.cuda.synchronize()
    for a, b in ((loop.lin.b, lin.b), (loop.lin.diag, lin.diag),
                 (loop.lin.scales, lin.scales), (loop.lin.chi2, lin.chi2)):
        assert torch.equal(a, b)
    for name, js in lin.jacobians.items():
        for a, b in zip(loop.lin.jacobians[name], js, strict=True):
            assert torch.equal(a, b)
        assert torch.equal(loop.lin.residuals[name], lin.residuals[name])
        assert torch.equal(loop.lin.chi2_deriv[name], lin.chi2_deriv[name])
    for key, v in hvals.items():
        assert torch.equal(loop.sstate.hvals[key], v)


def test_jit_loop_graph_takes_each_calls_options(cuda_device):
    """One captured graph serves calls with other iteration counts and
    initial damping, each bitwise its own host loop."""
    problem, solver = _small_bal(cuda_device), PCGSchurSolver(10, 1.0, 5.0)
    for iters, damping in ((4, 1e-4), (4, 1e-1), (7, 1e-4)):
        opts = dict(iterations=iters, initial_damping=damping)
        host = levenberg_marquardt(problem, solver,
                                   options=LevenbergMarquardtOptions(**opts))
        out = levenberg_marquardt(problem, solver,
                                  options=LevenbergMarquardtOptions(
                                      jit_loop=True, **opts))
        _bitwise(out, host)
        assert [h["mu"] for h in out.history] == [
            h["mu"] for h in host.history]
    (loop,) = device_loops(problem)
    assert loop.replays == 15 and len(loop.replay_ms) == 7


def test_remask_reuses_the_captured_graph(cuda_device):
    solver = PCGSchurSolver(10, 1.0, 5.0)
    opts = LevenbergMarquardtOptions(iterations=6, jit_loop=True)
    problem = _small_bal(cuda_device, remaskable=True)
    masks = [(t, t.data_ptr()) for t in
             [va.active for va in problem.data.vertices.values()]
             + [fa.slot_mask for fa in problem.data.factors.values()]]
    full = levenberg_marquardt(problem, solver, options=opts)
    loop = cached_device_loop(problem, solver, opts)
    fname = next(iter(problem.factor_meta))
    for h in range(20):
        problem.set_factor_active(fname, h, 0x80)
    problem.set_vertex_fixed("bal_camera", 1, True)
    edited = levenberg_marquardt(problem, solver, options=opts)
    assert device_loops(problem) == [loop]
    for t, ptr in masks:
        assert t.data_ptr() == ptr
    fresh = _small_bal(cuda_device, remaskable=True)
    for h in range(20):
        fresh.set_factor_active(fname, h, 0x80)
    fresh.set_vertex_fixed("bal_camera", 1, True)
    _bitwise(edited, levenberg_marquardt(fresh, solver, options=opts))
    assert torch.equal(edited.params["bal_camera"][1],
                       problem.params0["bal_camera"][1])
    for h in range(20):
        problem.set_factor_active(fname, h, 0)
    problem.set_vertex_fixed("bal_camera", 1, False)
    _bitwise(levenberg_marquardt(problem, solver, options=opts), full)


def _captured(device, fn, regions):
    """``fn()``, which opens ``regions`` regions, captured
    (``device_loop.Capture``), as the LM's iteration is: returns the
    capture."""
    from graphite_tpu_torch.ops import device_loop

    cap = device_loop.Capture(device)
    cap.record(fn, regions)
    return cap


@pytest.mark.parametrize("value", [True, False])
def test_cond_region_runs_on_its_predicate(cuda_device, value):
    from graphite_tpu_torch.ops import device_loop

    x = torch.zeros(4, device=cuda_device)
    pred = torch.ones((), dtype=torch.bool, device=cuda_device)
    cap = _captured(cuda_device, lambda: (x.add_(1), device_loop.cond(
        pred, lambda: x.mul_(3), "mul")), 1)
    pred.fill_(value)
    for _ in range(2):
        cap.replay()
    torch.cuda.synchronize()
    assert x.tolist() == [12.0 if value else 2.0] * 4
    assert cap.region_runs() == {"mul": 2 if value else 0}


@pytest.mark.parametrize("outer,inner", [(True, True), (True, False),
                                         (False, True)])
def test_cond_nested_region_holds_k1_k2_k6(cuda_device, outer, inner):
    """K1, K2 (a cluster launch) and K6 (a cluster launch) in an inner
    region, a nested one: bitwise their eager launches where both
    predicates are true, untouched otherwise."""
    from graphite_tpu_torch.ops import device_loop

    rng = np.random.default_rng(5)
    seg = np.sort(rng.integers(0, 50, 3000))
    vals, = _on(cuda_device, rng.standard_normal((3000, 9)).astype(
        np.float32))
    plan = segsum.plan_segments(seg, 50, cuda_device, width=9)
    n = 441
    A = rng.standard_normal((n, n))
    S = A @ A.T + n * np.eye(n)
    M = np.zeros_like(S)
    for i in range(0, n, 9):
        M[i:i + 9, i:i + 9] = np.linalg.inv(S[i:i + 9, i:i + 9])
    k2_args = _on(cuda_device, *[a.astype(np.float32) for a in (
        S, M, rng.standard_normal(n))])
    k2_kw = dict(max_iter=10, tol=1.0, rejection_ratio=5.0)
    k6_args = _first_pose_solve(cuda_device, "se3", "bj")

    def launch():
        return (segsum.sorted_segment_sum(vals, plan),
                pcg_dense.dense_pcg(*k2_args, **k2_kw)[0],
                pcg_mf.solve_pcg_mf(*k6_args, **K6_KW)[0])

    refs = launch()
    outs = [torch.zeros_like(r) for r in refs]
    p_out = torch.tensor(outer, device=cuda_device)
    p_in = torch.tensor(inner, device=cuda_device)
    count = torch.zeros((), device=cuda_device)

    def inner_body():
        for o, r in zip(outs, launch()):
            o.copy_(r)

    cap = _captured(cuda_device, lambda: device_loop.cond(
        p_out, lambda: (count.add_(1), device_loop.cond(
            p_in, inner_body, "kernels")), "outer"), 2)
    cap.replay()
    torch.cuda.synchronize()
    assert float(count) == float(outer)
    for o, r in zip(outs, refs):
        if outer and inner:
            assert torch.equal(o, r)
        else:
            assert bool((o == 0).all())
    runs = cap.region_runs()
    assert runs == {"outer": int(outer), "kernels": int(outer and inner)}
    inside = cap.regions[1].launches
    assert inside["segsum.sorted_segment_sum"] == 1
    assert inside["pcg_dense.dense_pcg"] == 1
    assert inside["pcg_mf.solve_pcg_mf"] == 1


def test_while_loop_runs_past_a_thousand_passes(cuda_device):
    """A loop (a "while" graph node) whose body holds K1 runs 1,500 times
    in one replay, more than any fixed count of unrolled regions would
    hold, and no time once its predicate starts false."""
    from graphite_tpu_torch.ops import device_loop

    plan = segsum.plan_segments(np.array([0, 0, 1, 2]), 3, cuda_device)
    vals = torch.ones(4, 2, device=cuda_device)
    segsum.sorted_segment_sum(vals, plan)  # build and warm up
    acc = torch.zeros(3, 2, device=cuda_device)
    k = torch.zeros((), dtype=torch.int64, device=cuda_device)
    limit = torch.tensor(1500, device=cuda_device)

    def body():
        acc.add_(segsum.sorted_segment_sum(vals, plan))
        k.add_(1)

    cap = _captured(cuda_device, lambda: device_loop.while_loop(
        lambda: k < limit, body, "count"), 1)
    cap.replay()
    torch.cuda.synchronize()
    assert int(k) == 1500
    assert acc[:, 0].tolist() == [3000.0, 1500.0, 1500.0]
    assert cap.region_runs() == {"count": 1500}
    assert cap.launches(1)["segsum.sorted_segment_sum"] == 1500
    cap.replay()  # k == limit: the body does not run
    torch.cuda.synchronize()
    assert int(k) == 1500 and cap.region_runs() == {"count": 1500}


def test_jit_loop_pcg_max_iter_above_a_thousand_bitwise_host_loop(
        cuda_device, monkeypatch):
    """PCG-Schur on its block-sparse S matvec (``run_pcg_fixed``) with
    ``max_iter`` 1,100 under jit_loop: one loop region holds the CG step,
    the replays run as many CG steps as the card's host loop, and the run
    is bitwise the host loop's."""
    problem = _small_bal(cuda_device)
    solver = PCGSchurSolver(1100, 1e-6, 5.0, dense_matvec_limit=0)
    matvecs = []
    real = schur.SchurOps.s_matvec

    def s_matvec(self, p):
        matvecs.append(1)
        return real(self, p)

    monkeypatch.setattr(schur.SchurOps, "s_matvec", s_matvec)
    opts = dict(iterations=6)
    host = levenberg_marquardt(problem, solver,
                               options=LevenbergMarquardtOptions(**opts))
    host_steps = len(matvecs)
    out = levenberg_marquardt(problem, solver, options=LevenbergMarquardtOptions(
        jit_loop=True, **opts))
    _bitwise(out, host)
    loop = device_loops(problem)[0]
    runs = loop.capture.region_runs()
    assert [r.name for r in loop.capture.regions].count("cg_step") == 1
    assert runs["cg_step"] == host_steps > 6
    # K9: the solve's two set-up dots in the step's region, three in the
    # CG step's body
    dots = {r.name: r.launches.get(k9.STATS.name, 0)
            for r in loop.capture.regions}
    assert dots["lm_iteration"] == 2 and dots["cg_step"] == 3


def test_ladybug_jit_loop_with_rejects_bitwise_host_loop(cuda_device):
    """Ladybug-49 under jit_loop at damping 1e-8, whose first steps are
    rejected: bitwise the card's host loop, the accepted branch run on
    the accepted iterations only."""
    g, *_ = bal.build_graph(synthetic.make_bal("ladybug", seed=0),
                            precision=gtt.FP32_FP32)
    problem, solver = g.freeze(device=cuda_device), PCGSchurSolver(
        10, 1.0, 5.0)
    opts = dict(iterations=10, initial_damping=1e-8)
    host = levenberg_marquardt(problem, solver,
                               options=LevenbergMarquardtOptions(**opts))
    out = levenberg_marquardt(problem, solver, options=LevenbergMarquardtOptions(
        jit_loop=True, **opts))
    pattern = [h["accepted"] for h in host.history]
    assert not pattern[0] and True in pattern
    _bitwise(out, host)
    loop = device_loops(problem)[0]
    assert loop.capture.region_runs() == {
        "lm_run": 10, "lm_iteration": 10, "lm_accept": sum(pattern),
        "lm_reject": 10 - sum(pattern), "lm_update": 10}


def test_record_events_raises_during_capture(cuda_device):
    plan = segsum.plan_segments(np.array([0, 0, 1, 2]), 3, cuda_device)
    vals = torch.ones(4, 2, device=cuda_device)
    segsum.sorted_segment_sum(vals, plan)  # build and warm up
    segsum.STATS.record_events = True
    graph = torch.cuda.CUDAGraph()
    try:
        with pytest.raises(RuntimeError, match="record_events"):
            with torch.cuda.graph(graph):
                segsum.sorted_segment_sum(vals, plan)
    finally:
        segsum.STATS.record_events = False
        segsum.STATS.events.clear()


@pytest.mark.parametrize("jit_loop", [False, True])
def test_profile_dir_records_the_card(cuda_device, tmp_path, jit_loop):
    import json
    import os

    levenberg_marquardt(
        _small_bal(cuda_device), PCGSchurSolver(10, 1.0, 5.0),
        options=LevenbergMarquardtOptions(iterations=3, jit_loop=jit_loop,
                                          profile_dir=str(tmp_path)))
    (name,) = os.listdir(tmp_path)
    with open(tmp_path / name) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events if e.get("cat") == "kernel"}
    assert any("segsum" in n for n in names), sorted(names)[:20]


@pytest.mark.parametrize("name", ["gd", "adam"])
def test_first_order_captured_equals_cpu(cuda_device, name):
    from graphite_tpu_torch.optimizers import (
        AdamOptions,
        GradientDescentOptions,
        adam,
        gradient_descent,
    )

    if name == "gd":
        run = gradient_descent
        opts = GradientDescentOptions(iterations=12, learning_rate=0.1)
        key = ("gd", 0.1, 12)
    else:
        run = adam
        opts = AdamOptions(iterations=12, learning_rate=0.3)
        key = ("adam", 0.3, 0.9, 0.999, 1e-8, 12)
    problem = _small_bal(cuda_device)
    pf, hist = run(problem, options=opts)
    again, hist2 = run(problem, options=opts)
    loop = problem._cache[key]
    assert loop.capture is not None and loop.replays == 24
    assert loop.capture_launches.get("segsum_stream.streaming_segment_sum")
    cpu_pf, cpu_hist = run(_small_bal("cpu"), options=opts)
    assert torch.equal(hist.cpu(), cpu_hist)
    assert torch.equal(hist2, hist)
    for n, p in cpu_pf.items():
        assert torch.equal(pf[n].cpu(), p)
        assert torch.equal(again[n], pf[n])


def test_covariance_schur_cuda_matches_cpu(cuda_device):
    from graphite_tpu_torch.covariance import joint_covariance

    targets = [("bal_camera", 0), ("bal_camera", 5), ("bal_point", 12),
               ("bal_point", 70)]
    out = {}
    for dev in (cuda_device, "cpu"):
        problem = _small_bal(dev)
        lin = linearize(problem, problem.params0)
        out[str(dev)] = joint_covariance(problem, lin, targets,
                                         method="schur", damping=1e-2)
    gpu, cpu = out[str(cuda_device)].cpu(), out["cpu"]
    assert gpu.dtype == torch.float64 and gpu.shape == (24, 24)
    assert float((gpu - cpu).abs().max()) <= 1e-9 * float(cpu.abs().max())
    assert bool((torch.diagonal(gpu) > 0).all())


def test_checkpoint_load_defaults_to_the_card(cuda_device, tmp_path):
    from graphite_tpu_torch.io import checkpoint

    problem = _small_bal("cpu")
    path = str(tmp_path / "ckpt.npz")
    checkpoint.save(path, problem.params0, iteration=2)
    params, extra = checkpoint.load(path)
    for n, p in problem.params0.items():
        assert params[n].device.type == "cuda"
        assert torch.equal(params[n].cpu(), p)
    assert int(extra["iteration"]) == 2


def test_range_bearing_example_cuda_equals_cpu(cuda_device):
    from graphite_tpu_torch.examples import range_bearing_slam

    argv = ["--poses", "30", "--landmarks", "12", "--iterations", "12"]
    pcg_dense.STATS.reset()
    gpu = range_bearing_slam.main(argv)
    assert pcg_dense.STATS.launches > 0
    cpu = range_bearing_slam.main(argv + ["--device", "cpu"])
    assert [h["accepted"] for h in gpu.history] == [
        h["accepted"] for h in cpu.history]
    assert [h["chi2"] for h in gpu.history] == [
        h["chi2"] for h in cpu.history]
    for n, p in cpu.params.items():
        assert torch.equal(gpu.params[n].cpu(), p)


# ---- factor-parallel sharding (graphite_tpu_torch.parallel) --------------

def _ladybug_cpu(pad):
    g, *_ = bal.build_graph(synthetic.make_bal("ladybug", seed=0),
                            precision=gtt.FP32_FP32)
    return g.freeze(device="cpu", pad_factors_to=pad)


def test_sharded_world2_cuda_equals_cpu(cuda_device):
    """Two ranks on one card (every collective a K8 launch; the sharded
    Schur stage on K3's gathered-stream entry; K4 and K5 forced) against
    two gloo ranks on the CPU (K8's plain version): bitwise the same
    trajectory and parameters, both ranks equal."""
    import torch_sharding_helpers as helpers

    from graphite_tpu_torch.parallel import run_ranks

    problem = _ladybug_cpu(2)
    card = run_ranks(helpers.forced_lm, 2, "gloo", problem, 10,
                     device=torch.device("cuda", 0))
    cpu = run_ranks(helpers.forced_lm, 2, "gloo", problem, 10, device="cpu")
    for c, h in zip(card, cpu):
        assert c["k3_gathered"] > 0 and h["k3_gathered"] == 0
        assert np.array_equal(c["trace"], h["trace"])
        assert c["trace"][-1, 0] < c["trace"][0, 0]
        for name in c["params"]:
            assert np.array_equal(c["params"][name], h["params"][name])
            assert np.array_equal(c["params"][name],
                                  card[0]["params"][name])


def test_sharded_world1_nccl_bitwise_unsharded(cuda_device):
    """One rank over nccl: bitwise the unsharded host loop on the card,
    and its jit_loop run (collectives captured in the graph) bitwise the
    host loop."""
    import torch_sharding_helpers as helpers

    from graphite_tpu_torch.parallel import run_ranks

    problem = _ladybug_cpu(1)
    (out,) = run_ranks(helpers.world1_card, 1, "nccl", problem, 10,
                       device=torch.device("cuda", 0))
    ref = levenberg_marquardt(problem.to(cuda_device),
                              PCGSchurSolver(10, 1.0, 5.0),
                              options=LevenbergMarquardtOptions(
                                  iterations=10))
    for run in (out["host"], out["graph"]):
        assert run["iterations"] == ref.iterations
        assert run["trace"][:, 0].tolist() == [h["chi2"]
                                               for h in ref.history]
        for name, v in ref.params.items():
            assert np.array_equal(run["params"][name], v.cpu().numpy())



def test_k8_matches_plain_bitwise(cuda_device):
    """K8 on two ranks of cuda:0 against its plain version on the same
    CUDA tensors."""
    import torch_sharding_helpers as helpers

    from graphite_tpu_torch.parallel import run_ranks

    out = run_ranks(helpers.k8_vs_plain, 2, "gloo",
                    device=torch.device("cuda", 0))
    for r, o in enumerate(out):
        for case in o["cases"]:
            assert case["bitwise"] and case["repeat"], (r, case["shape"])
        assert o["launches"] == 4 * len(helpers.K8_CASES)
        assert o["epoch"] == o["eager_calls"] > 0
    for a, b in zip(out[0]["cases"], out[1]["cases"]):
        assert np.array_equal(a["sum"], b["sum"])
        assert a["gather_shape"] == (2,) + tuple(a["shape"])


def test_k8_times_out_and_raises(cuda_device):
    """A peer that leaves out a call: the waiting rank's K8 gives up after
    its bound (2 s here) and the wrapper raises, naming the call."""
    import torch_sharding_helpers as helpers

    from graphite_tpu_torch.parallel import run_ranks

    waiting, skipping = run_ranks(helpers.k8_timeout, 2, "gloo", 1,
                                  device=torch.device("cuda", 0))
    assert skipping["error"] is None
    assert "'left out by a peer'" in waiting["error"]
    assert "for rank 1" in waiting["error"]
    assert 2.0 <= waiting["seconds"] < 30.0


def test_sharded_jit_loop_two_ranks_bitwise_host_loop(cuda_device):
    """Two ranks on cuda:0 at mini under ``jit_loop``: every collective a
    K8 launch inside the captured iteration (in the CG loop's "while" node
    for PCGSolver), bitwise the same ranks' host loop, ranks equal; after
    ``Mesh.close()`` the cached loop is captured again on the new arena,
    with the same bits."""
    import torch_sharding_helpers as helpers

    from graphite_tpu_torch.parallel import run_ranks

    g, *_ = bal.build_graph(synthetic.make_bal("mini", seed=0, noise=0.5),
                            precision=gtt.FP32_FP32)
    problem = g.freeze(device="cpu", pad_factors_to=2)
    out = run_ranks(helpers.host_and_graph, 2, "gloo", problem, 10,
                    device=torch.device("cuda", 0))
    for o in out:
        assert o["k8_in_graphs"] > 0
        closed = o["after_close"]
        assert closed["recaptured"]
        assert np.array_equal(closed["first"]["trace"],
                              o["mini"]["host"]["trace"])
        assert np.array_equal(closed["again"]["trace"],
                              o["mini"]["host"]["trace"])
        for case in ("mini", "pcg-block-jacobi"):
            host, graph = o[case]["host"], o[case]["graph"]
            assert graph["iterations"] == host["iterations"] >= 3
            assert np.array_equal(graph["trace"], host["trace"])
            for name in host["params"]:
                assert np.array_equal(graph["params"][name],
                                      host["params"][name])
                assert np.array_equal(graph["params"][name],
                                      out[0][case]["graph"]["params"][name])


# camera rotations (angle-axis) forcing each Rodrigues branch: theta^2 = 0
# and below 1e-24 (tiny), below 0.01 (the Jacobian's Taylor range) and
# above it (exact)
K7_ROTATIONS = [(0.0, 0.0, 0.0), (1e-13, -2e-13, 5e-14),
                (0.02, -0.03, 0.01), (0.2, -0.15, 0.1), (0.5, 0.3, -0.4)]
K7_LOSSES = {"default": (None, None), "huber": (gtt.HuberLoss(), 2.0),
             "cauchy": (gtt.CauchyLoss(), 1.5)}


def _k7_problem(device, loss, size=(6, 60, 300), precision=gtt.FP32_FP32):
    ds = synthetic.make_bal(size, seed=3, noise=0.5)
    ds.cameras[:len(K7_ROTATIONS), :3] = K7_ROTATIONS
    fn, param = K7_LOSSES[loss]
    g, cams, _, fs = bal.build_graph(ds, precision=precision, loss=fn,
                                     loss_param=param)
    cams.set_fixed(5)
    for h in range(10):
        fs.set_active(h, 0x80)
    return g.freeze(device=device)


# the lanes per segment of the Hessian sums' plans: the site's own, 32 and
# 256 (the lane kernel, its largest staging asks for more than 48 KB of
# shared memory), and 1 on the site's destinations sorted (no permutation)
K7_SUM_GROUPS = (None, 32, 256, "sorted")


def _k7_sums(problem, js, dL, fn):
    """``fn`` (``bal_hessian_sum`` or its plain version) at every Hessian
    site of ``problem`` (its camera-point site also as a transposed one),
    on each plan of ``K7_SUM_GROUPS``: stored into an empty group, then
    added to it once more (a second writer)."""
    from graphite_tpu_torch.hessian import build_hessian_structure

    hs = build_hessian_structure(problem)
    out = []
    for cm in hs.contribs:
        key = cm.direct_group
        for tr in ((False, True) if cm.s != cm.t else (False,)):
            width = key[0] * key[1]
            for group in K7_SUM_GROUPS:
                idx = cm.direct_idx
                if group == "sorted":
                    idx, group = np.sort(idx), 1
                plan = segsum.plan_segments(idx, hs.group_sizes[key] + 1,
                                            problem.device, group=group,
                                            width=width)
                assert plan.perm is None or idx is cm.direct_idx
                first = torch.empty(
                    (plan.num_segments, width), device=problem.device,
                    dtype=gtt.Precision(dL.dtype, js[0].dtype).inv_dtype)
                fn(*js, dL, plan, cm.s, cm.t, tr, first, False)
                twice = first.clone()
                fn(*js, dL, plan, cm.s, cm.t, tr, twice, True)
                out += [first, twice]
    return out


def _k7_calls(problem, storage, plain):
    """Every K7 entry on ``problem``'s first linearization point: the
    wrappers, or (``plain``) the plain versions."""
    fa = problem.data.factors["bal_reprojection"]
    p = problem.params0
    loss = k7.gate(problem, "bal_reprojection")
    args = (p["bal_camera"], p["bal_point"], *fa.ids, fa.obs)
    rng = np.random.default_rng(5)
    scales = [torch.as_tensor(rng.random((problem.seg_rows[n] + 1, d)),
                              dtype=problem.precision.graph_dtype,
                              device=problem.device)
              for n, d in (("bal_camera", 9), ("bal_point", 3))]
    fns = [k7.bal_residual, k7.bal_linearize, k7.bal_scale_b,
           k7.bal_hessian_sum]
    if plain:
        fns = [k7.bal_residual_plain, k7.bal_linearize_plain,
               k7.bal_scale_b_plain, k7.bal_hessian_sum_plain]
    chi2 = fns[0](*args, fa.factor_mask, fa.loss_params, loss)
    lin = fns[1](*args, fa.slot_mask, fa.factor_mask, fa.loss_params, loss)
    r, jc, jp, _, dL, _, _ = lin
    scaled = fns[2](jc, jp, r, dL, *scales, *fa.rows, storage)
    unscaled = fns[2](jc, jp, r, dL, None, None, *fa.rows, storage)
    sums = _k7_sums(problem, scaled[:2], dL, fns[3])
    return [chi2, *lin, *scaled, *unscaled, *sums]


def _k7_bits(t):
    ints = {8: torch.int64, 4: torch.int32, 2: torch.int16}
    return t.contiguous().view(ints[t.element_size()])


# F = 300 (two CTAs of 128 and a tail of 44) and F = 100 (one CTA, below
# 128)
@pytest.mark.parametrize("size", [(6, 60, 300), (6, 20, 100)])
@pytest.mark.parametrize("loss", sorted(K7_LOSSES))
@pytest.mark.parametrize("storage", ["float32", "bfloat16", "float16"])
def test_k7_matches_plain_bitwise(cuda_device, storage, loss, size):
    storage = getattr(torch, storage)
    problem = _k7_problem(cuda_device, loss, size)
    cpu = _k7_problem("cpu", loss, size)
    stats = (k7.RESIDUAL_STATS, k7.LINEARIZE_STATS, k7.SCALE_B_STATS,
             k7.HESSIAN_SUM_STATS)
    before = [s.launches for s in stats]
    out = _k7_calls(problem, storage, plain=False)
    again = _k7_calls(problem, storage, plain=False)
    # the sums: 4 sites ((0, 0), (0, 1), its transpose, (1, 1)) x 4 plans
    # x (store, add), per call
    assert [s.launches - b for s, b in zip(stats, before)] == [2, 2, 4, 64]
    ref = _k7_calls(problem, storage, plain=True)
    ref_cpu = _k7_calls(cpu, storage, plain=True)
    torch.cuda.synchronize()
    # the chi2 of bal_residual and of bal_linearize (Cauchy: log1p)
    chi2_at = (0, 4)
    assert len(out) == len(ref_cpu) == 1 + 7 + 4 + 4 + 32
    for i, (o, a, r, c) in enumerate(zip(out, again, ref, ref_cpu)):
        assert o.dtype == r.dtype == c.dtype and o.shape == c.shape
        assert torch.equal(_k7_bits(o), _k7_bits(a)), i
        assert torch.equal(_k7_bits(o), _k7_bits(r)), i
        if loss == "cauchy" and i in chi2_at:
            torch.testing.assert_close(o.cpu(), c, rtol=1e-6, atol=0)
        else:
            assert torch.equal(_k7_bits(o.cpu()), _k7_bits(c)), i


# bal_scale_b's tile of factors (csrc/bal.cu, kThreads): one factor, a
# tile less and more one, and a million and three (a tail of 3)
K7_TILE = 128


@pytest.mark.parametrize("scaled", [True, False])
@pytest.mark.parametrize("storage", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("F", [1, K7_TILE - 1, K7_TILE + 1, 1_000_003])
def test_k7_scale_b_tiles_bitwise(cuda_device, F, storage, scaled):
    """``bal_scale_b`` bitwise its plain version on the card and on the
    CPU, and repeatable, on seeded rows: J over nine decades (fp16's clamp
    at 65,504 taken), -0.0 entries, camera and point rows in any order."""
    rng = np.random.default_rng(F)

    def wide(*shape):
        x = rng.standard_normal(shape) * 10.0 ** rng.integers(-3, 6, shape)
        x.reshape(-1)[::11] = -0.0
        return x.astype(np.float32)

    rows = (rng.integers(0, 40, F), np.sort(rng.integers(0, 900, F)))
    host = [torch.as_tensor(a) for a in (
        wide(F, 18), wide(F, 6), wide(F, 2),
        rng.random(F).astype(np.float32))]
    scales = [torch.as_tensor(rng.random((n + 1, d)).astype(np.float32))
              if scaled else None for n, d in ((40, 9), (900, 3))]
    host += scales + [torch.as_tensor(r) for r in rows]
    card = [None if t is None else t.to(cuda_device) for t in host]
    storage = getattr(torch, storage)
    before = k7.SCALE_B_STATS.launches
    out = k7.bal_scale_b(*card, storage)
    again = k7.bal_scale_b(*card, storage)
    assert k7.SCALE_B_STATS.launches - before == 2
    ref = k7.bal_scale_b_plain(*card, storage)
    ref_cpu = k7.bal_scale_b_plain(*host, storage)
    torch.cuda.synchronize()
    for o, a, r, c in zip(out, again, ref, ref_cpu):
        assert o.dtype == r.dtype == c.dtype and o.shape == c.shape
        assert torch.equal(_k7_bits(o), _k7_bits(a))
        assert torch.equal(_k7_bits(o), _k7_bits(r))
        assert torch.equal(_k7_bits(o.cpu()), _k7_bits(c))


K7_STATS = (k7.RESIDUAL_STATS, k7.LINEARIZE_STATS, k7.SCALE_B_STATS,
            k7.HESSIAN_SUM_STATS)
K7_STATS_F64 = (k7.RESIDUAL_STATS_F64, k7.LINEARIZE_STATS_F64,
                k7.SCALE_B_STATS_F64, k7.HESSIAN_SUM_STATS_F64)


def _k7_near_cpu(card, cpu):
    """A float64-graph K7 output on the card against the CPU's plain
    version: the card's float64 cos / sin are CUDA's, not the CPU
    library's, so within 1e-12 of the largest entry in float64, 1e-6 in
    float32 (a float64 value rounded to float32 may round apart), and
    one ulp in bf16 / fp16 (a stored J entry may round apart)."""
    a, b = card.cpu().double(), cpu.double()
    if card.dtype in (torch.bfloat16, torch.float16):
        mant = {torch.bfloat16: 7, torch.float16: 10}[card.dtype]
        ulp = torch.exp2(torch.floor(torch.log2(
            torch.maximum(a.abs(), b.abs()).clamp_min(1e-30))) - mant)
        assert bool(((a - b).abs() <= ulp).all())
        return
    tol = 1e-12 if card.dtype == torch.float64 else 1e-6
    assert float((a - b).abs().max()) <= tol * max(float(b.abs().max()),
                                                   1e-300)


@pytest.mark.parametrize("size", [(6, 60, 300), (6, 20, 100)])
@pytest.mark.parametrize("loss", sorted(K7_LOSSES))
@pytest.mark.parametrize("storage",
                         ["float64", "float32", "bfloat16", "float16"])
def test_k7_f64_matches_plain_bitwise(cuda_device, storage, loss, size):
    """K7's float64 instances on a float64 graph (the cameras in each
    Rodrigues branch): every entry, and the Hessian sum at every site and
    plan into float64 (or float32, FP64_FP32's inv_dtype) groups, bitwise
    its plain version on the card, repeatable, counted ``[f64]`` only."""
    storage = getattr(torch, storage)
    prec = gtt.Precision(torch.float64, storage)
    problem = _k7_problem(cuda_device, loss, size, prec)
    cpu = _k7_problem("cpu", loss, size, prec)
    assert k7.gate(problem, "bal_reprojection") is not None
    before = [s.launches for s in K7_STATS + K7_STATS_F64]
    out = _k7_calls(problem, storage, plain=False)
    again = _k7_calls(problem, storage, plain=False)
    assert [s.launches - b for s, b in zip(K7_STATS + K7_STATS_F64,
                                           before)] == [0] * 4 + [2, 2, 4, 64]
    ref = _k7_calls(problem, storage, plain=True)
    ref_cpu = _k7_calls(cpu, storage, plain=True)
    torch.cuda.synchronize()
    assert len(out) == len(ref_cpu) == 1 + 7 + 4 + 4 + 32
    sums = prec.inv_dtype
    for i, (o, a, r, c) in enumerate(zip(out, again, ref, ref_cpu)):
        assert o.dtype == r.dtype == c.dtype and o.shape == c.shape
        assert o.dtype == (storage if i in (8, 9, 12, 13) else
                           sums if i >= 16 else torch.float64), i
        assert torch.equal(_k7_bits(o), _k7_bits(a)), i
        assert torch.equal(_k7_bits(o), _k7_bits(r)), i
        _k7_near_cpu(o, c)


@pytest.mark.parametrize("scaled", [True, False])
@pytest.mark.parametrize("storage",
                         ["float64", "float32", "bfloat16", "float16"])
@pytest.mark.parametrize("F", [1, 63, 65, 100_003])
def test_k7_f64_scale_b_tiles_bitwise(cuda_device, F, storage, scaled):
    """The float64 ``bal_scale_b`` (tiles of 64 factors) bitwise its plain
    version on the card and the CPU (no transcendental), and repeatable,
    on seeded float64 rows over nine decades with -0.0 entries."""
    rng = np.random.default_rng(F)

    def wide(*shape):
        x = rng.standard_normal(shape) * 10.0 ** rng.integers(-3, 6, shape)
        x.reshape(-1)[::11] = -0.0
        return x

    rows = (rng.integers(0, 40, F), np.sort(rng.integers(0, 900, F)))
    host = [torch.as_tensor(a) for a in (wide(F, 18), wide(F, 6),
                                         wide(F, 2), rng.random(F))]
    host += [torch.as_tensor(rng.random((n + 1, d))) if scaled else None
             for n, d in ((40, 9), (900, 3))]
    host += [torch.as_tensor(r) for r in rows]
    card = [None if t is None else t.to(cuda_device) for t in host]
    storage = getattr(torch, storage)
    before = k7.SCALE_B_STATS_F64.launches
    out = k7.bal_scale_b(*card, storage)
    again = k7.bal_scale_b(*card, storage)
    assert k7.SCALE_B_STATS_F64.launches - before == 2
    ref = k7.bal_scale_b_plain(*card, storage)
    ref_cpu = k7.bal_scale_b_plain(*host, storage)
    torch.cuda.synchronize()
    for o, a, r, c in zip(out, again, ref, ref_cpu):
        assert o.dtype == r.dtype == c.dtype and o.shape == c.shape
        assert torch.equal(_k7_bits(o), _k7_bits(a))
        assert torch.equal(_k7_bits(o), _k7_bits(r))
        assert torch.equal(_k7_bits(o.cpu()), _k7_bits(c))


# K7's Hessian-sum instances: (graph dtype, storage dtype of the stored J)
K7_SUM_INSTANCES = [("float32", "float32"), ("float32", "bfloat16"),
                    ("float32", "float16"), ("float64", "float64"),
                    ("float64", "float32"), ("float64", "bfloat16"),
                    ("float64", "float16")]
K7_LONG_SEGMENT = 100_003


def _k7_random_segments(rng):
    """(segment of each sorted row, number of segments): ~3,000 short
    segments of 0-12 rows (every 97th empty), one of ``K7_LONG_SEGMENT``
    rows among them, and a last one (the trash row's) of 7 rows."""
    lengths = rng.integers(0, 13, 3_000)
    lengths[::97] = 0
    lengths = np.concatenate([lengths[:1_500], [K7_LONG_SEGMENT],
                              lengths[1_500:], [7]])
    return np.repeat(np.arange(lengths.size), lengths), lengths.size


@pytest.mark.parametrize("graph,storage", K7_SUM_INSTANCES)
def test_k7_sums_random_plans_bitwise(cuda_device, graph, storage):
    """``bal_hessian_sum`` on random uneven plans (``_k7_random_segments``;
    permuted, and sorted) at every forced lane count from 1 to 256, at the
    (0, 0), (0, 1), transposed (0, 1) and (1, 1) sites, stored into an
    empty group and added to a random one: bitwise the CPU's
    ``hessian_rows_plain`` rows, rounded to the sums' dtype, summed by
    ``segsum.segment_sum_plain`` (bitwise ``segment_sum_ordered``, the
    plain version's sum, on the CPU), and added to the group."""
    graph, storage = getattr(torch, graph), getattr(torch, storage)
    sums = gtt.Precision(graph, storage).inv_dtype
    stats = k7.HESSIAN_SUM_STATS_F64 if graph == torch.float64 else (
        k7.HESSIAN_SUM_STATS)
    rng = np.random.default_rng(26)
    seg, n = _k7_random_segments(rng)
    F = seg.size
    order = rng.permutation(F)
    trash = (seg[order] == n - 1, seg == n - 1)

    def wide(w):
        x = rng.standard_normal((F, w)) * 10.0 ** rng.integers(-2, 3, (F, w))
        x.reshape(-1)[::13] = -0.0
        return x

    J = [torch.as_tensor(wide(w)).to(storage) for w in (18, 6)]
    dL = torch.as_tensor(rng.random(F) * 2.0).to(graph)
    dL[::17] = 0.0
    for kind, seg_f, zero in (("permuted", seg[order], trash[0]),
                              ("sorted", seg, trash[1])):
        host = [j.clone() for j in J]
        for j in host:  # the trash row's factors: masked, +-0.0 J
            j[torch.as_tensor(zero)] *= -0.0
        card = [t.to(cuda_device) for t in (*host, dL)]
        for s, t, tr in ((0, 0, False), (0, 1, False), (0, 1, True),
                         (1, 1, False)):
            width = (9, 3)[s] * (9, 3)[t]
            rows = k7.hessian_rows_plain(*host, dL, s, t, tr).to(sums)
            for group in (1, 2, 4, 8, 16, 32, 64, 128, 256):
                plans = [segsum.plan_segments(seg_f, n, dev, group=group)
                         for dev in (cuda_device, "cpu")]
                assert (plans[1].perm is None) == (kind == "sorted")
                ref = segsum.segment_sum_plain(rows, plans[1])
                prev = torch.as_tensor(
                    rng.standard_normal((n, width))).to(sums)
                before = stats.launches
                stored = k7.bal_hessian_sum(
                    *card, plans[0], s, t, tr,
                    torch.empty((n, width), dtype=sums, device=cuda_device),
                    False)
                added = k7.bal_hessian_sum(*card, plans[0], s, t, tr,
                                           prev.to(cuda_device, copy=True),
                                           True)
                assert stats.launches - before == 2
                label = (kind, s, t, tr, group)
                assert torch.equal(_k7_bits(stored.cpu()),
                                   _k7_bits(ref)), label
                assert torch.equal(_k7_bits(added.cpu()),
                                   _k7_bits(prev + ref)), label


@pytest.mark.parametrize("graph,storage", K7_SUM_INSTANCES)
def test_k7_sums_raise_on_misaligned_j(cuda_device, graph, storage):
    """``bal_hessian_sum`` on a J that does not start 16-byte aligned (a
    view one value into its storage), at one lane and at 32, at each slot
    pair: raises, in each instance (the camera sites' kernel reads J's
    rows in vector loads; ``bal_scale_b`` stores J aligned)."""
    graph, storage = getattr(torch, graph), getattr(torch, storage)
    sums = gtt.Precision(graph, storage).inv_dtype
    F, n = 64, 4
    seg = np.repeat(np.arange(n), F // n)
    dL = torch.rand(F, dtype=graph, device=cuda_device)
    J = [torch.randn((F, w), dtype=graph, device=cuda_device).to(storage)
         for w in (18, 6)]
    odd = []
    for j in J:
        v = torch.empty(j.numel() + 1, dtype=storage,
                        device=cuda_device)[1:].view_as(j)
        odd.append(v.copy_(j))
    for group in (1, 32):
        plan = segsum.plan_segments(seg, n, cuda_device, group=group)
        for s, t in ((0, 0), (0, 1), (1, 1)):
            width = (9, 3)[s] * (9, 3)[t]
            out = torch.empty((n, width), dtype=sums, device=cuda_device)
            bad = odd[0] if s == 0 else odd[1]
            args = (bad, J[1]) if s == 0 else (J[0], bad)
            with pytest.raises(RuntimeError, match="misaligned"):
                k7.bal_hessian_sum(*args, dL, plan, s, t, False, out, False)


@pytest.mark.parametrize("policy", ["FP64_FP64", "FP64_FP32", "FP64_BF16"])
def test_forced_fp64_lm_on_k7_f64(cuda_device, monkeypatch, policy):
    """Ladybug-49 with the Venice branches forced under the float64
    graphs' policies, 6 LM iterations: every K7 entry launches its float64
    instance (``[f64]``) and no float32 one, the trial chi2 once an
    iteration; ``jit_loop`` (the accepted branch relinearizing in place)
    bitwise the host loop; FP64_FP64 the CPU's accept pattern and chi2
    within 1e-9."""
    from graphite_tpu_torch.ops.cuda.launches import REGISTRY, snapshot

    monkeypatch.setattr(schur, "CHUNK_THRESHOLD", 0)
    monkeypatch.setattr(schur, "_smv_chunk_rows", lambda rb: 0)
    solver = PCGSchurSolver(10, 1.0, 5.0, dense_matvec_limit=0)
    prec = getattr(gtt, policy)

    def run(device, jit_loop=False):
        g, *_ = bal.build_graph(synthetic.make_bal("ladybug", seed=0),
                                precision=prec)
        return levenberg_marquardt(
            g.freeze(device=device), solver,
            options=LevenbergMarquardtOptions(iterations=6,
                                              jit_loop=jit_loop))

    for s in REGISTRY:
        s.reset()
    gpu = run(cuda_device)
    launches = snapshot()
    for s, s64 in zip(K7_STATS, K7_STATS_F64):
        assert launches[s64.name] > 0, s64.name
        assert launches[s.name] == 0, s.name
    assert launches[k7.RESIDUAL_STATS_F64.name] == len(gpu.history)
    assert gpu.chi2 < gpu.initial_chi2
    _bitwise(run(cuda_device, jit_loop=True), gpu)
    if policy == "FP64_FP64":
        cpu = run("cpu")
        assert ([h["accepted"] for h in gpu.history]
                == [h["accepted"] for h in cpu.history])
        np.testing.assert_allclose([h["chi2"] for h in gpu.history],
                                   [h["chi2"] for h in cpu.history],
                                   rtol=1e-9)


@pytest.mark.parametrize("policy", ["FP32_FP32", "FP32_FP16"])
def test_ladybug_lm_under_k7_cuda_equals_cpu(cuda_device, policy):
    cpu, gpu, launches = _ladybug_runs(cuda_device, getattr(gtt, policy))
    assert ([(h["chi2"], h["accepted"]) for h in gpu.history]
            == [(h["chi2"], h["accepted"]) for h in cpu.history])
    for name, p in gpu.params.items():
        assert torch.equal(p.cpu(), cpu.params[name])
    for s in (k7.RESIDUAL_STATS, k7.LINEARIZE_STATS, k7.SCALE_B_STATS,
              k7.HESSIAN_SUM_STATS):
        assert launches[s.name] > 0, s.name
    # one trial chi2 per iteration
    assert launches[k7.RESIDUAL_STATS.name] == len(gpu.history)


# K9 (csrc/dot.cu): one thread-block cluster up to 32,768 entries (three
# levels; sphere2500's 14,994 and Venice's 16,002 entries, 16 chunks full
# and one entry past), the multi-CTA form above (32,769; 40,000; a
# million: four and five levels)
K9_SIZES = [1, 31, 32, 33, 1024, 1025, 14_994, 16_002, 16_384, 16_385,
            32_768, 32_769, 40_000, 1_000_000]
K9_CASES = ("finite", "negative_zeros", "inf", "nan")


def _k9_operands(n, dtype, case, device):
    """Seeded u and v: finite (every 7th u a -0.0); all products -0.0 (a
    full group of them sums to -0.0, a padded one to +0.0); a +inf and a
    -inf product (a NaN sum); a NaN."""
    rng = np.random.default_rng(n)
    u = rng.standard_normal(n) * 10.0 ** rng.integers(-3, 4, n)
    v = rng.standard_normal(n)
    u[::7] = -0.0
    if case == "negative_zeros":
        u[:], v = -0.0, np.abs(v) + 1.0
    elif case == "inf":
        u[n // 3], u[(2 * n) // 3] = np.inf, -np.inf
        v[n // 3], v[(2 * n) // 3] = 1.0, 1.0
    elif case == "nan":
        u[n // 2] = np.nan
    return (torch.tensor(u, dtype=getattr(torch, dtype), device=device),
            torch.tensor(v, dtype=getattr(torch, dtype), device=device))


def _k9_bits(t):
    return t.view({4: torch.int32, 8: torch.int64}[t.element_size()])


@pytest.mark.parametrize("case", K9_CASES)
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("n", K9_SIZES)
def test_k9_matches_plain_bitwise(cuda_device, n, dtype, case):
    """K9 bitwise ``tree_dot_plain`` on the card (and, on finite inputs,
    on the CPU), one launch a call (float64 counted apart), the same bits on a second call and in
    a captured graph replayed twice, then replayed on new inputs written
    into the captured ones."""
    u, v = _k9_operands(n, dtype, case, cuda_device)
    stats = k9.STATS_F64 if dtype == "float64" else k9.STATS
    before = stats.launches
    out, again = k9.tree_dot(u, v), k9.tree_dot(u, v)
    assert stats.launches - before == 2
    ref = pcg_loop.tree_dot_plain(u, v)
    assert out.shape == () and out.dtype == u.dtype
    assert _k9_bits(out) == _k9_bits(ref) == _k9_bits(again)
    if case in ("finite", "negative_zeros"):
        cpu = pcg_loop.tree_dot_plain(u.cpu(), v.cpu())
        assert _k9_bits(out.cpu()) == _k9_bits(cpu)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = k9.tree_dot(u, v)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert _k9_bits(captured) == _k9_bits(ref)
    v.mul_(-2.0)
    graph.replay()
    torch.cuda.synchronize()
    assert _k9_bits(captured) == _k9_bits(pcg_loop.tree_dot_plain(u, v))


def test_k9_raises_off_its_dtypes(cuda_device):
    """No fallback: bf16, mixed dtypes and 2-D operands raise."""
    x = torch.ones(64, device=cuda_device)
    with pytest.raises(NotImplementedError):
        k9.tree_dot(x.bfloat16(), x.bfloat16())
    with pytest.raises(NotImplementedError):
        k9.tree_dot(x, x.double())
    with pytest.raises(ValueError):
        k9.tree_dot(x.view(8, 8), x.view(8, 8))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("n", [1025, 16_002, 32_768])
def test_k9_same_bits_at_every_cluster_size(cuda_device, n, dtype):
    """The cluster form on 1, 2, 4, 8 and 16 CTAs (a CTA taking up to 32,
    16, 8, 4 or 2 chunks): bitwise ``tree_dot_plain`` at every size, on
    inputs with -0.0 entries."""
    u, v = _k9_operands(n, dtype, "finite", cuda_device)
    ref = pcg_loop.tree_dot_plain(u, v)
    for c in (1, 2, 4, 8, 16):
        assert _k9_bits(k9._launch(u, v, c)) == _k9_bits(ref), c


# K10 (csrc/schur_w.cu): 1,000 landmarks (four CTAs of 256, the last one
# partial), 0 to 9 blocks each, every 17th none and one 700 (its CTA walks
# three chunks of rows), so the spans start at every offset from a 16-byte
# boundary; every 7th Hpl entry -0.0
K10_DIMS = [(3, 1), (9, 1), (3, 2), (6, 2), (9, 2), (3, 3), (6, 3), (9, 3)]


def _k10_inputs(dp, dl, L=1000):
    rng = np.random.default_rng(100 * dp + dl)
    a = rng.standard_normal((L, dl, dl))
    hll = (a @ a.transpose(0, 2, 1) + dl * np.eye(dl)).reshape(L, dl * dl)
    counts = rng.integers(0, 10, L)
    counts[::17] = 0
    counts[300] = 700
    K = int(counts.sum())
    hpl = rng.standard_normal((K, dp * dl)) * 10.0 ** rng.integers(
        -3, 4, (K, 1))
    hpl.reshape(-1)[::7] = -0.0
    return (torch.tensor(hll, dtype=torch.float32),
            torch.tensor(hpl, dtype=torch.float32), counts)


def _k10_bits(t):
    return t.view(torch.int32)


@pytest.mark.parametrize("dp,dl", K10_DIMS)
def test_k10_matches_plain_bitwise(cuda_device, dp, dl):
    """K10 bitwise its plain version on the card and on the CPU, bitwise
    repeatable, with the inverses stored or not and alone, one launch a
    call; the same bits replayed from a CUDA graph, also on new inputs
    written into the captured ones."""
    chll, chpl, counts = _k10_inputs(dp, dl)
    hll, hpl = chll.to(cuda_device), chpl.to(cuda_device)
    plan = k10.plan_w(counts, cuda_device)
    before = k10.STATS.launches
    inv, w = k10.schur_w(hll, hpl, plan, dp, dl)
    inv2, w2 = k10.schur_w(hll, hpl, plan, dp, dl)
    none, w3 = k10.schur_w(hll, hpl, plan, dp, dl, write_inverse=False)
    alone, no_w = k10.schur_w(hll, None, None, 0, dl)
    assert k10.STATS.launches - before == 4
    assert none is None and no_w is None
    ref_inv = k10.hll_inverse_plain(hll, dl)
    ref_w = k10.hpl_w_plain(hpl, ref_inv, plan, dp, dl)
    cpu_inv, cpu_w = k10.schur_w(chll, chpl, k10.plan_w(counts, "cpu"), dp,
                                 dl)
    torch.cuda.synchronize()
    for got in (inv, inv2, alone):
        assert torch.equal(_k10_bits(got), _k10_bits(ref_inv))
        assert torch.equal(_k10_bits(got.cpu()), _k10_bits(cpu_inv))
    for got in (w, w2, w3):
        assert torch.equal(_k10_bits(got), _k10_bits(ref_w))
        assert torch.equal(_k10_bits(got.cpu()), _k10_bits(cpu_w))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        g_inv, g_w = k10.schur_w(hll, hpl, plan, dp, dl)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(_k10_bits(g_inv), _k10_bits(ref_inv))
    assert torch.equal(_k10_bits(g_w), _k10_bits(ref_w))
    hpl.mul_(-2.0)
    hll.add_(1.0)
    graph.replay()
    ref_inv = k10.hll_inverse_plain(hll, dl)
    ref_w = k10.hpl_w_plain(hpl, ref_inv, plan, dp, dl)
    torch.cuda.synchronize()
    assert torch.equal(_k10_bits(g_inv), _k10_bits(ref_inv))
    assert torch.equal(_k10_bits(g_w), _k10_bits(ref_w))


def test_k10_raises_off_its_dtypes(cuda_device):
    """No fallback: bf16 blocks, float32 and float64 mixed, dl 4 and a
    misaligned start raise."""
    chll, chpl, counts = _k10_inputs(9, 3)
    hll, hpl = chll.to(cuda_device), chpl.to(cuda_device)
    plan = k10.plan_w(counts, cuda_device)
    with pytest.raises(NotImplementedError):
        k10.schur_w(hll.bfloat16(), hpl.bfloat16(), plan, 9, 3)
    with pytest.raises(NotImplementedError):
        k10.schur_w(hll, hpl.double(), plan, 9, 3)
    with pytest.raises(NotImplementedError):
        k10.schur_w(hll, hpl.bfloat16(), plan, 9, 3)
    with pytest.raises(NotImplementedError):
        k10.schur_w(torch.ones(8, 16, device=cuda_device), None, None, 0, 4)
    odd = torch.empty(hll.numel() + 1, device=cuda_device)[1:].view_as(hll)
    odd.copy_(hll)
    with pytest.raises(ValueError, match="aligned"):
        k10.schur_w(odd, hpl, plan, 9, 3)


def _schur_values(device, precision):
    """``schur_values`` of a small BAL problem's damped Hessian on
    ``device``, with K10's launches (in the inverses' dtype)."""
    g, *_ = bal.build_graph(synthetic.make_bal((6, 60, 300), seed=3,
                                               noise=0.5),
                            precision=precision)
    problem = g.freeze(device=device)
    from graphite_tpu_torch import hessian

    ss = schur.build_schur_structure(problem)
    hs = hessian.build_hessian_structure(problem)
    lin = linearize(problem, problem.params0)
    hv = hessian.apply_damping(
        problem, hs, hessian.compute_hessian_values(problem, hs, lin),
        lin.diag, 1e-2, False)
    stats = (k10.STATS_F64 if precision.inv_dtype == torch.float64
             else k10.STATS)
    before = stats.launches
    sv = schur.schur_values(problem, ss, hv)
    torch.cuda.synchronize()
    return ss, sv, stats.launches - before


@pytest.mark.parametrize("forced", [False, True])
def test_k10_schur_values_cuda_equals_cpu(cuda_device, monkeypatch, forced):
    """A float32 ``schur_values`` on the card launches K10 once (one Hpl
    group) and gives the CPU's bits, with K3's branch forced or not."""
    if forced:
        monkeypatch.setattr(schur, "CHUNK_THRESHOLD", 0)
    _, cpu, _ = _schur_values("cpu", gtt.FP32_FP32)
    ss, gpu, launches = _schur_values(cuda_device, gtt.FP32_FP32)
    assert launches == len(ss.hpl_keys) == 1
    for d in cpu.hll_inv:
        assert torch.equal(_k10_bits(gpu.hll_inv[d].cpu()),
                           _k10_bits(cpu.hll_inv[d]))
    for key in cpu.s_vals:
        assert torch.equal(_k10_bits(gpu.s_vals[key].cpu()),
                           _k10_bits(cpu.s_vals[key]))


def test_k10_f64_launched_under_fp64(cuda_device):
    """FP64_FP64's float64 inverses launch K10's float64 instance (once:
    one Hpl group), counted apart, and no float32 K10; within 1e-9 of the
    CPU's (each side linearizes on its own, and the card's float64 cos /
    sin are not correctly rounded)."""
    before = k10.STATS.launches
    ss, sv, launches = _schur_values(cuda_device, gtt.FP64_FP64)
    assert launches == len(ss.hpl_keys) == 1
    assert k10.STATS.launches == before
    assert all(t.dtype == torch.float64 for t in sv.hll_inv.values())
    _, cpu, _ = _schur_values("cpu", gtt.FP64_FP64)
    for got, ref in ((sv.hll_inv, cpu.hll_inv), (sv.s_vals, cpu.s_vals)):
        for key in ref:
            np.testing.assert_allclose(got[key].cpu().numpy(),
                                       ref[key].numpy(), rtol=1e-9,
                                       atol=1e-9 * float(ref[key].abs()
                                                         .max()))


# ---- the float64 instances of K3, K4, K5 and K10 (FP64_FP64, FP64_BF16) --

def _f64_bits(t):
    return t.view(torch.int64)


def _check_f64(out, again, ref, ref_cpu):
    """A float64 kernel's outputs: bitwise repeatable, bitwise its plain
    version on the CPU, within 1e-12 of the card's plain version (whose
    ``index_add_`` adds in no fixed order)."""
    torch.cuda.synchronize()
    for o, a, r, c in zip(out, again, ref, ref_cpu):
        assert o.dtype == torch.float64
        assert torch.equal(_f64_bits(o), _f64_bits(a))
        assert torch.equal(_f64_bits(o.cpu()), _f64_bits(c))
        assert float((o - r).abs().max() / r.abs().max()) <= 1e-12


def _counts(*stats):
    return [s.launches for s in stats]


@pytest.mark.parametrize("m,k,n,site", [
    pytest.param(9, 3, 9, "random", id="9-3-9"),
    pytest.param(4, 3, 2, "random", id="4-3-2"),
    pytest.param(9, 9, 9, "random", id="9-9-9"),
    pytest.param(9, 3, 9, "venice", id="9-3-9-venice"),
    # (m + n) * k = 150 in float64: two stages, as 15-10-15 in float32
    pytest.param(15, 5, 15, "random", id="15-5-15-two-stages"),
    # the float64 design's edges: a lone 256-lane segment over a cluster
    # pair and a padded grid; even row widths (every row 16-byte aligned
    # alike); L gathered beforehand (no left index); (m + n) k = 224,
    # whose padded rounds do not fit, on the float32 design in double
    pytest.param(9, 3, 9, "lone-256", id="9-3-9-lone-256"),
    pytest.param(2, 4, 2, "venice", id="2-4-2-even-widths"),
    pytest.param(9, 3, 9, "null-li", id="9-3-9-null-li"),
    pytest.param(16, 7, 16, "random", id="16-7-16-float32-design"),
])
def test_k3_f64_matches_plain(cuda_device, m, k, n, site):
    """K3's float64 instance, both entries and the base store (from a
    base index with -1 rows; at 9x9x9 a second group in place): bitwise
    the CPU's plain version, repeatable, one ``[f64]`` launch a call and
    no float32 one."""
    rng = np.random.default_rng(m * 100 + k * 10 + n + 1)
    seg, ns = _k3_site(rng, site)
    rows, n_l, n_r, n_h = seg.size, 5_000, 4_000, ns + 50
    ltab = rng.standard_normal((n_l, m * k)) * 10.0 ** rng.integers(
        -3, 3, (n_l, 1))
    rtab = rng.standard_normal((n_r, n * k))
    li = rng.integers(0, n_l, rows).astype(np.int32)
    ri = rng.integers(0, n_r, rows).astype(np.int32)
    if site == "null-li":  # one L row per pair, read with no index
        ltab, li = ltab[li], None
    htab = rng.standard_normal((n_h, m * n))
    htab.reshape(-1)[::5] = -0.0
    bidx = np.where(rng.random(ns) < 0.5, -1,
                    rng.integers(0, n_h, ns)).astype(np.int32)
    runs = [(segsum_stream.plan_products(seg, ns, d),
             *_on(d, ltab, rtab, li, ri, htab, bidx))
            for d in (cuda_device, "cpu")]
    plan, L, R, lt, rt, H, bi = runs[0]
    if site == "venice":
        assert {1, 2, 256} <= set(plan.lanes.tolist())
    f64 = (segsum_stream.PRODUCT_RTBL_STATS_F64,
           segsum_stream.PRODUCT_STATS_F64)
    f32 = (segsum_stream.PRODUCT_RTBL_STATS, segsum_stream.PRODUCT_STATS)
    before, before32 = _counts(*f64), _counts(*f32)

    def tbl(plan, L, R, lt, rt, H, bi):
        return segsum_stream.streaming_segment_product_sum_rtbl(
            L, R, plan, m, k, n, lt, rt)

    def stored(plan, L, R, lt, rt, H, bi):
        s = segsum_stream.streaming_segment_product_sum_rtbl(
            L, R, plan, m, k, n, lt, rt, base=H, base_idx=bi)
        return segsum_stream.streaming_segment_product_sum_rtbl(
            L, R, plan, m, k, n, lt, rt, base=s) if m == n == k else s

    def plain(plan, L, R, lt, rt, H, bi):
        sums = segsum_stream.segment_product_sum_plain(L, R, plan, m, k, n,
                                                       lt, rt)
        s = segsum_stream.product_store_plain(sums, H, bi)
        if m == n == k:
            s = segsum_stream.product_store_plain(
                segsum_stream.segment_product_sum_plain(
                    L, R, plan, m, k, n, lt, rt), s, None)
        return sums, s

    out = (tbl(*runs[0]), stored(*runs[0]))
    _check_f64(out, (tbl(*runs[0]), stored(*runs[0])), plain(*runs[0]),
               (tbl(*runs[1]), stored(*runs[1])))
    stream = segsum_stream.streaming_segment_product_sum(
        L if lt is None else L.index_select(0, lt.long()),
        R.index_select(0, rt.long()), plan, m, k, n)
    torch.cuda.synchronize()
    assert torch.equal(_f64_bits(stream), _f64_bits(out[0]))
    calls = 4 + 2 * (m == n == k)
    assert _counts(*f64) == [before[0] + calls, before[1] + 1]
    assert _counts(*f32) == before32


@pytest.mark.parametrize("rows,ns,sorted_dst,transpose", [
    pytest.param(50_000, 40, False, False, id="40-False"),
    pytest.param(50_000, 15_000, False, True, id="15000-True"),
    pytest.param(500_000, 100_000, True, True, id="back-substitution"),
    pytest.param(4_978_400, 1_778, False, False, id="b_schur"),
    pytest.param(50_003, 40, True, False, id="unaligned-tiles"),
    pytest.param(50_001, 40, True, True, id="odd-tiles-transposed"),
])
def test_k4_f64_matches_plain(cuda_device, rows, ns, sorted_dst, transpose):
    """K4's float64 instance (its three entries, tiles of 96 on a 2-block
    grid): bitwise the CPU's plain version, repeatable, the entries equal,
    counted ``[f64]``."""
    m, k = 9, 3
    rng = np.random.default_rng(ns + transpose + 3)
    n_x = 3_000
    dst = rng.integers(0, ns, rows)
    if sorted_dst:
        dst = np.sort(dst)
    left = rng.standard_normal((rows, m * k))
    xd = m if transpose else k
    x = rng.standard_normal((n_x, xd))
    xi = rng.integers(0, n_x, rows)
    xi[rng.random(rows) < 0.05] = n_x
    xi = xi.astype(np.int32)
    gpu, cpu = _on(cuda_device, left, x, xi), _on("cpu", left, x, xi)
    plan = segsum.plan_segments(dst, ns, cuda_device)
    plan_cpu = segsum.plan_segments(dst, ns, "cpu")
    assert segmv.k4_tile_blocks(m, k, 8) == 96
    stats = (segsum_stream.MATVEC_TBL_STATS_F64, segmv.STREAM_STATS_F64,
             segmv.WTBL_STATS_F64)
    before = _counts(*stats)

    def tbl(A, X, I, p):
        return segsum_stream.streaming_matvec_tbl(A, X, I, p, m, k,
                                                  transpose)

    out = tbl(*gpu, plan)
    _check_f64([out], [tbl(*gpu, plan)],
               [segmv.segmv_plain(*gpu, plan, m, k, transpose)],
               [tbl(*cpu, plan_cpu)])
    gathered = torch.cat([gpu[1], gpu[1].new_zeros(1, xd)]).index_select(
        0, gpu[2])
    stream = segmv.block_matvec_stream(gpu[0], gathered, plan, m, k,
                                       transpose)
    torch.cuda.synchronize()
    assert torch.equal(_f64_bits(stream), _f64_bits(out))
    if not transpose:
        wtbl = segmv.block_matvec_wtbl(gpu[0], gpu[1], plan, gpu[2], m, k)
        torch.cuda.synchronize()
        assert torch.equal(_f64_bits(wtbl), _f64_bits(out))
    assert _counts(*stats) == [before[0] + 2, before[1] + 1,
                               before[2] + (not transpose)]
    with pytest.raises(NotImplementedError):
        tbl(gpu[0], gpu[1].float(), gpu[2], plan)
    with pytest.raises(NotImplementedError):
        tbl(gpu[0].bfloat16(), gpu[1].bfloat16(), gpu[2], plan)


@pytest.mark.parametrize("n,m,group,sorted_cols", [
    (70, 9, None, True),    # long columns: 128 lanes, 9x9 blocks
    (20, 9, None, True),    # 3,000 blocks a column: 256 lanes capped to 128
    (6_000, 9, None, True),  # ~10 blocks per column: 2 lanes
    (500, 9, 1, True),      # one lane: 32 columns per CTA
    (70, 6, None, True),    # a block shape the kernel takes at run time
    (70, 9, None, False),   # a column plan with a permutation
])
def test_k5_f64_matches_plain(cuda_device, n, m, group, sorted_cols):
    """K5's float64 instance (pass 2 K1's float64 instance, uncounted):
    both halves bitwise the CPU's plain version, repeatable, one
    ``[f64]`` launch a call; its column lanes capped to fit two tiles."""
    k = m
    rng = np.random.default_rng(n + m + 5)
    rows, n_r, n_c = 60_000, n, n
    rid = rng.integers(0, n_r, rows)
    cid = rng.integers(0, n_c, rows)
    if sorted_cols:
        cid = np.sort(cid)
    rxi = np.where(rng.random(rows) < 0.05, n_r, rid).astype(np.int32)
    arrays = (rng.standard_normal((rows, m * k)),
              rng.standard_normal((n_c, k)), rng.standard_normal((n_r, m)),
              cid.astype(np.int32), rxi)
    gpu, cpu = _on(cuda_device, *arrays), _on("cpu", *arrays)
    plan, plan_cpu = (segmv.plan_matvec_sym(rid, cid, n_r, n_c, d, m, group,
                                            k=k, elem_bytes=8)
                      for d in (cuda_device, "cpu"))
    if group is None:
        assert plan.cols.group <= segmv.sym_group_cap(m, k, 8)
    if n == 20:
        assert plan.cols.group == 128
    stats = (segmv.SYM_STATS_F64, segmv.SYM_STATS, segsum.STATS_F64,
             segsum_stream.STATS_F64)
    before = _counts(*stats)
    out = segmv.matvec_sym_stream(*gpu, plan, m, k)
    assert _counts(*stats) == [before[0] + 1] + before[1:]
    _check_f64(out, segmv.matvec_sym_stream(*gpu, plan, m, k),
               segmv.matvec_sym_plain(*gpu, plan, m, k),
               segmv.matvec_sym_stream(*cpu, plan_cpu, m, k))
    with pytest.raises(NotImplementedError):
        segmv.matvec_sym_stream(gpu[0].float(), *gpu[1:], plan, m, k)


@pytest.mark.parametrize("dp,dl", K10_DIMS)
def test_k10_f64_matches_plain_bitwise(cuda_device, dp, dl):
    """K10's float64 instance bitwise its plain version on the card and
    on the CPU, repeatable, with the inverses stored or not and alone, one
    ``[f64]`` launch a call; the same bits replayed from a CUDA graph."""
    chll, chpl, counts = (t.double() if torch.is_tensor(t) else t
                          for t in _k10_inputs(dp, dl))
    hll, hpl = chll.to(cuda_device), chpl.to(cuda_device)
    plan = k10.plan_w(counts, cuda_device)
    before, before32 = k10.STATS_F64.launches, k10.STATS.launches
    inv, w = k10.schur_w(hll, hpl, plan, dp, dl)
    inv2, w2 = k10.schur_w(hll, hpl, plan, dp, dl)
    none, w3 = k10.schur_w(hll, hpl, plan, dp, dl, write_inverse=False)
    alone, _ = k10.schur_w(hll, None, None, 0, dl)
    assert k10.STATS_F64.launches - before == 4
    assert k10.STATS.launches == before32 and none is None
    ref_inv = k10.hll_inverse_plain(hll, dl)
    ref_w = k10.hpl_w_plain(hpl, ref_inv, plan, dp, dl)
    cpu_inv, cpu_w = k10.schur_w(chll, chpl, k10.plan_w(counts, "cpu"), dp,
                                 dl)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        g_inv, g_w = k10.schur_w(hll, hpl, plan, dp, dl)
    graph.replay()
    torch.cuda.synchronize()
    for got in (inv, inv2, alone, g_inv):
        assert got.dtype == torch.float64
        assert torch.equal(_f64_bits(got), _f64_bits(ref_inv))
        assert torch.equal(_f64_bits(got.cpu()), _f64_bits(cpu_inv))
    for got in (w, w2, w3, g_w):
        assert torch.equal(_f64_bits(got), _f64_bits(ref_w))
        assert torch.equal(_f64_bits(got.cpu()), _f64_bits(cpu_w))


F64_SCHUR = ("segsum_stream.streaming_segment_product_sum_rtbl",
             "segmv.block_matvec_wtbl", "segsum_stream.streaming_matvec_tbl",
             "segmv.matvec_sym_stream", "schur_w.schur_w")


@pytest.mark.parametrize("policy", ["FP64_FP64", "FP64_BF16"])
def test_forced_fp64_lm_on_f64_kernels(cuda_device, monkeypatch, policy):
    """Ladybug-49 with the Venice branches forced under FP64_FP64 and
    FP64_BF16, 6 LM iterations: K3, K4, K5 and K10 launch their float64
    instances only (``[f64]``), K3 and K10 once an iteration, K5 once a
    CG step; ``jit_loop`` bitwise the card's host loop; FP64_FP64 the
    CPU's accept pattern and chi2 within 1e-9 (the card's float64 cos /
    sin are not correctly rounded, so not bitwise)."""
    from graphite_tpu_torch.ops.cuda.launches import REGISTRY, snapshot

    monkeypatch.setattr(schur, "CHUNK_THRESHOLD", 0)
    monkeypatch.setattr(schur, "_smv_chunk_rows", lambda rb: 0)
    solver = PCGSchurSolver(10, 1.0, 5.0, dense_matvec_limit=0)
    prec = getattr(gtt, policy)

    def run(device, jit_loop=False):
        g, *_ = bal.build_graph(synthetic.make_bal("ladybug", seed=0),
                                precision=prec)
        return levenberg_marquardt(
            g.freeze(device=device), solver,
            options=LevenbergMarquardtOptions(iterations=6,
                                              jit_loop=jit_loop))

    for s in REGISTRY:
        s.reset()
    gpu = run(cuda_device)
    launches = snapshot()
    for name in F64_SCHUR:
        assert launches[name + "[f64]"] > 0, name
        assert launches[name] == 0, name
    assert launches[F64_SCHUR[0] + "[f64]"] == len(gpu.history)
    assert launches["schur_w.schur_w[f64]"] == len(gpu.history)
    assert gpu.chi2 < gpu.initial_chi2
    _bitwise(run(cuda_device, jit_loop=True), gpu)
    if policy == "FP64_FP64":
        cpu = run("cpu")
        assert ([h["accepted"] for h in gpu.history]
                == [h["accepted"] for h in cpu.history])
        np.testing.assert_allclose([h["chi2"] for h in gpu.history],
                                   [h["chi2"] for h in cpu.history],
                                   rtol=1e-9)


# K11 (csrc/pose.cu): the SE(3) pose-graph factors
K11_LOSSES = ("default", "huber", "cauchy")


def _k11_problem(device, size, loss, policy):
    from torch_k11_cases import k11_problem

    if size == "sphere2500":
        return k11_problem(device, 2500, 10, loss, policy, special=False,
                           prior=False)
    return k11_problem(device, 120, 7, loss, policy)


def _k11_inputs(problem):
    """Seeded padded scale rows (a slot of each set), and a step and
    scales for the update, in the graph dtype."""
    rng = np.random.default_rng(5)
    dev, n = problem.device, problem.seg_rows["se3_pose"]

    def rand(*shape, scale=1.0):
        return torch.as_tensor(scale * rng.standard_normal(shape),
                               dtype=problem.precision.graph_dtype,
                               device=dev)

    scales = {name: tuple(rand(n + 1, 6).abs() for _ in fa.ids)
              for name, fa in problem.data.factors.items()}
    return scales, rand(problem.dim_x, scale=0.1), rand(problem.dim_x).abs()


def _k11_calls(problem, inputs, plain, out=None):
    """Every K11 entry at ``problem``'s start: per factor set the trial
    chi2, the linearization and the second pass (scaled by ``inputs``'
    rows and not scaled), then the update of the poses by ``inputs``'
    step: the wrappers (into ``out``'s arrays where given: the arrays of
    an earlier call), or the plain versions. Returns ([(tag, tensor)],
    the arrays written into: per set r, chi2 and dL, and the stored J)."""
    fns = (k11.se3_residual, k11.se3_linearize, k11.se3_scale_b,
           k11.se3_update)
    if plain:
        fns = (k11.se3_residual_plain, k11.se3_linearize_plain,
               k11.se3_scale_b_plain, k11.se3_update_plain)
    scales, dx, sc = inputs
    poses = problem.params0["se3_pose"]
    storage = problem.precision.solver_dtype
    res, arrays = [], {}
    for name in problem.factor_meta:
        fa = problem.data.factors[name]
        loss = k11.gate(problem, name)
        assert loss is not None, name
        prev = None if out is None else out[name]
        args = (poses, fa.ids, fa.obs, fa.precision)
        res.append(("chi2", fns[0](*args, fa.factor_mask, fa.loss_params,
                                   loss)))
        kw = {} if plain else {"out": prev and prev["lin"]}
        r, J, chi2, dL, diag = fns[1](*args, fa.slot_mask, fa.factor_mask,
                                      fa.loss_params, loss, **kw)
        res += [("r", r), *(("J", j) for j in J), ("chi2", chi2),
                ("dL", dL), *(("diag", d) for d in diag)]
        arrays[name] = {"lin": (r, chi2, dL)}
        for key, scaled in (("scaled", scales[name]), ("unscaled", None)):
            kw = {} if plain else {"out": prev and prev[key]}
            stored, b = fns[2](J, r, dL, fa.precision, scaled, fa.rows,
                               storage, **kw)
            res += [*(("stored", t) for t in stored),
                    *(("b", t) for t in b)]
            arrays[name][key] = stored
    va = problem.data.vertices["se3_pose"]
    res.append(("update", fns[3](poses, dx, sc,
                                 problem.seg_start["se3_pose"],
                                 problem.seg_rows["se3_pose"],
                                 va.active_row, va.active)))
    return res, arrays


K11_STATS = (k11.RESIDUAL_STATS, k11.LINEARIZE_STATS, k11.SCALE_B_STATS,
             k11.UPDATE_STATS)
K11_STATS_F64 = (k11.RESIDUAL_STATS_F64, k11.LINEARIZE_STATS_F64,
                 k11.SCALE_B_STATS_F64, k11.UPDATE_STATS_F64)


def _k11_same(out, ref, cpu=False, cauchy=False):
    assert [t for t, _ in out] == [t for t, _ in ref]
    for i, ((tag, o), (_, r)) in enumerate(zip(out, ref)):
        o = o.cpu() if cpu else o
        assert o.dtype == r.dtype and o.shape == r.shape, (i, tag)
        if cpu and cauchy and tag == "chi2":
            torch.testing.assert_close(o, r, rtol=1e-6, atol=0)
        else:
            assert torch.equal(_k7_bits(o), _k7_bits(r)), (i, tag)


# the special cases under every policy and loss; sphere2500 under one
K11_CASES = [("special120", policy, loss)
             for policy in ("FP32_FP32", "FP32_BF16", "FP32_FP16")
             for loss in K11_LOSSES] + [("sphere2500", "FP32_FP32", "default")]


@pytest.mark.parametrize("size,policy,loss", K11_CASES)
def test_k11_matches_plain_bitwise(cuda_device, size, policy, loss):
    policy = getattr(gtt, policy)
    problem = _k11_problem(cuda_device, size, loss, policy)
    cpu = _k11_problem("cpu", size, loss, policy)
    inputs = _k11_inputs(problem)
    before = [s.launches for s in K11_STATS]
    out, _ = _k11_calls(problem, inputs, plain=False)
    again, _ = _k11_calls(problem, inputs, plain=False)
    sets = len(problem.factor_meta)
    # per call: a trial chi2, a linearization and two second passes a set,
    # one update
    assert ([s.launches - b for s, b in zip(K11_STATS, before)]
            == [2 * sets, 2 * sets, 4 * sets, 2])
    ref, _ = _k11_calls(problem, inputs, plain=True)
    ref_cpu, _ = _k11_calls(cpu, _k11_on_cpu(inputs), plain=True)
    torch.cuda.synchronize()
    _k11_same(out, again)
    _k11_same(out, ref)
    _k11_same(out, ref_cpu, cpu=True, cauchy=loss == "cauchy")


# the float64 instances: the special cases under the three FP64 policies
# and every loss; sphere2500 under FP64_FP64
K11_F64_CASES = [("special120", policy, loss)
                 for policy in ("FP64_FP64", "FP64_FP32", "FP64_BF16")
                 for loss in K11_LOSSES] + [
    ("sphere2500", "FP64_FP64", "default")]


def _k11_close_f64(out, ref):
    """The card's float64 entries against the CPU's plain versions: the
    card's double sin, cos and atan2 are not the CPU's, so within 1e-12
    of each array's largest entry (and of 1) where float64, and one ulp of
    the storage dtype where the stored J is float32 or bf16."""
    assert [t for t, _ in out] == [t for t, _ in ref]
    for i, ((tag, o), (_, r)) in enumerate(zip(out, ref)):
        o = o.cpu()
        assert o.dtype == r.dtype and o.shape == r.shape, (i, tag)
        scale = max(float(r.double().abs().max()), 1.0)
        tol = {torch.float64: 1e-12, torch.float32: 2.0 ** -23,
               torch.bfloat16: 2.0 ** -7}[r.dtype]
        assert float((o.double() - r.double()).abs().max()) <= tol * scale, (
            i, tag)


@pytest.mark.parametrize("size,policy,loss", K11_F64_CASES)
def test_k11_f64_matches_plain_bitwise(cuda_device, size, policy, loss):
    """K11's float64 instances (a float64 graph, counted ``[f64]``, no
    float32 launch): each entry bitwise its plain version on the card and
    repeatable, within 1e-12 of the CPU's plain version; a float16 pose
    table raises."""
    policy = getattr(gtt, policy)
    problem = _k11_problem(cuda_device, size, loss, policy)
    cpu = _k11_problem("cpu", size, loss, policy)
    inputs = _k11_inputs(problem)
    before = [s.launches for s in K11_STATS + K11_STATS_F64]
    out, _ = _k11_calls(problem, inputs, plain=False)
    again, _ = _k11_calls(problem, inputs, plain=False)
    sets = len(problem.factor_meta)
    assert ([s.launches - b for s, b in zip(K11_STATS + K11_STATS_F64,
                                            before)]
            == [0, 0, 0, 0, 2 * sets, 2 * sets, 4 * sets, 2])
    ref, _ = _k11_calls(problem, inputs, plain=True)
    ref_cpu, _ = _k11_calls(cpu, _k11_on_cpu(inputs), plain=True)
    torch.cuda.synchronize()
    _k11_same(out, again)
    _k11_same(out, ref)
    _k11_close_f64(out, ref_cpu)
    _, dx, sc = inputs
    va = problem.data.vertices["se3_pose"]
    with pytest.raises(NotImplementedError):
        k11.se3_update(problem.params0["se3_pose"].half(), dx.half(),
                       sc.half(), problem.seg_start["se3_pose"],
                       problem.seg_rows["se3_pose"], va.active_row,
                       va.active)


@pytest.mark.parametrize("jit_loop", [False, True])
def test_pose_lm_fp64_on_k11_and_k6(cuda_device, jit_loop):
    """10 LM iterations of PCGSolver(50, 1e-10, 1e6, block-Jacobi) on the
    120-pose sphere with its prior set under FP64_FP64: every K11 entry
    and K6 launch their float64 instances and no float32 one (K6 once a
    solve, the trial chi2 once a set and iteration); the CPU's accept
    pattern and chi2 within 1e-9 (the card's double transcendentals);
    under ``jit_loop`` the replays bitwise the host loop."""
    from graphite_tpu_torch.ops.cuda.launches import REGISTRY, snapshot

    def run(dev, jit=False):
        problem = _k11_problem(dev, "special120", "default", gtt.FP64_FP64)
        return levenberg_marquardt(
            problem, PCGSolver(50, 1e-10, 1e6, BlockJacobiPreconditioner()),
            options=LevenbergMarquardtOptions(iterations=10, jit_loop=jit))

    for s in REGISTRY:
        s.reset()
    gpu = run(cuda_device)
    launches = snapshot()
    for s, s64 in zip(K11_STATS + (pcg_mf.STATS,),
                      K11_STATS_F64 + (pcg_mf.STATS_F64,)):
        assert launches[s64.name] > 0 and launches[s.name] == 0, s.name
    n = len(gpu.history)
    assert launches[pcg_mf.STATS_F64.name] == n
    assert launches[k11.RESIDUAL_STATS_F64.name] == 2 * n
    assert gpu.chi2 < gpu.initial_chi2
    if jit_loop:
        _bitwise(run(cuda_device, jit=True), gpu)
        return
    cpu = run("cpu")
    assert ([h["accepted"] for h in gpu.history]
            == [h["accepted"] for h in cpu.history])
    np.testing.assert_allclose([h["chi2"] for h in gpu.history],
                               [h["chi2"] for h in cpu.history], rtol=1e-9)


def _k11_on_cpu(inputs):
    scales, dx, sc = inputs
    return ({k: tuple(t.cpu() for t in v) for k, v in scales.items()},
            dx.cpu(), sc.cpu())


@pytest.mark.parametrize("policy", ["FP32_FP32", "FP32_BF16"])
def test_k11_in_graph_and_into_out(cuda_device, policy):
    """K11's entries captured in a CUDA graph, the linearization and the
    second pass writing into an earlier call's arrays: the replay's bits
    are the eager calls', in those arrays."""
    problem = _k11_problem(cuda_device, "special120", "huber",
                           getattr(gtt, policy))
    inputs = _k11_inputs(problem)
    first, arrays = _k11_calls(problem, inputs, plain=False)
    eager = [(t, x.clone()) for t, x in first]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up, into the same arrays
        _k11_calls(problem, inputs, plain=False, out=arrays)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured, written = _k11_calls(problem, inputs, plain=False,
                                       out=arrays)
    for name, a in arrays.items():
        for key, ts in a.items():
            assert all(x is y for x, y in zip(ts, written[name][key],
                                              strict=True)), (name, key)
            for t in ts:
                t.fill_(float("nan"))
    graph.replay()
    torch.cuda.synchronize()
    _k11_same(captured, eager)


@pytest.mark.parametrize("jit_loop", [False, True])
def test_pose_lm_under_k11_cuda_equals_cpu(cuda_device, jit_loop):
    """10 LM iterations of PCGSolver(50, 1e-10, 1e6, block-Jacobi) on the
    120-pose sphere with its prior set (FP32_FP32): the card's trajectory
    and parameters bitwise the CPU's, K11 launched (one trial chi2 an
    iteration)."""
    from graphite_tpu_torch.ops.cuda.launches import REGISTRY

    runs = []
    for dev in ("cpu", cuda_device):
        problem = _k11_problem(dev, "special120", "default", gtt.FP32_FP32)
        for s in REGISTRY:
            s.reset()
        opts = LevenbergMarquardtOptions(iterations=10,
                                         jit_loop=jit_loop and dev != "cpu")
        runs.append(levenberg_marquardt(
            problem, PCGSolver(50, 1e-10, 1e6, BlockJacobiPreconditioner()),
            options=opts))
    cpu, gpu = runs
    assert ([(h["chi2"], h["accepted"]) for h in gpu.history]
            == [(h["chi2"], h["accepted"]) for h in cpu.history])
    for name, p in gpu.params.items():
        assert torch.equal(p.cpu(), cpu.params[name])
    assert gpu.chi2 < gpu.initial_chi2
    for s in K11_STATS:
        assert s.launches > 0, s.name
    if not jit_loop:  # a captured run counts its launches at capture
        sets = 2
        assert k11.RESIDUAL_STATS.launches == sets * len(gpu.history)
        assert k11.UPDATE_STATS.launches == len(gpu.history)


# K12 (csrc/pcg_step.cu): the CG step's vector work; K13
# (csrc/schur_w.cu's hll_solve): w = Hll^-1 (t - sub)
K12_PAIRS = [("float32", "float32"), ("float64", "float32"),
             ("float64", "float64"), ("float32", "float64")]


def _k12_bits(t):
    return t.view({1: torch.uint8, 4: torch.int32,
                   8: torch.int64}[t.element_size()])


def _k12_same(a, b):
    """Bitwise, NaNs compared by place (their payload is the device's)."""
    a, b = a.cpu(), b.cpu()
    nan = torch.isnan(a) if a.is_floating_point() else torch.zeros_like(
        a, dtype=torch.bool)
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(nan, torch.isnan(b) if b.is_floating_point()
                            else nan)
            and torch.equal(_k12_bits(a)[~nan], _k12_bits(b)[~nan]))


def _bjs_inputs(vec_dtype, inv_dtype, device):
    """Two pose types (1,778 rows of 9 and 300 of 6, Venice's camera count
    and a second type), seeded inverses with -0.0 entries, r and its r.r;
    the layout the Schur path builds (``graph.PoseSegments``)."""
    from graphite_tpu_torch.graph import PoseSegments

    rng = np.random.default_rng(12)
    segs = PoseSegments((("cams", 0, 1778, 9), ("rigs", 16_002, 300, 6)),
                        16_002 + 1_800)
    inv = {}
    for name, _, n, d in segs.segments:
        a = rng.standard_normal((n, d * d)) * 10.0 ** rng.integers(
            -2, 3, (n, 1))
        a[:, ::5] = -0.0
        inv[name] = torch.tensor(a, dtype=getattr(torch, inv_dtype))
    r = rng.standard_normal(segs.dim_p) * 10.0 ** rng.integers(
        -3, 4, segs.dim_p)
    r[::7] = -0.0
    r = torch.tensor(r, dtype=getattr(torch, vec_dtype))
    if device != "cpu":
        inv = {k: v.to(device) for k, v in inv.items()}
        r = r.to(device)
    return r, inv, segs


@pytest.mark.parametrize("vec,inv_dt", K12_PAIRS)
def test_k12_bjs_apply_matches_plain_bitwise(cuda_device, vec, inv_dt):
    """``bjs_apply`` bitwise its plain version on the card and on the CPU,
    with r.r from K9, on r = 0 (norm 0), with a type's inverses missing
    (its segment 0); bitwise repeatable, one launch a call (float64
    vectors counted apart), the same bits in a replayed CUDA graph and on
    new inputs written into the captured ones."""
    from graphite_tpu_torch.ops.cuda import pcg_step

    r, inv, segs = _bjs_inputs(vec, inv_dt, cuda_device)
    cr, cinv, _ = _bjs_inputs(vec, inv_dt, "cpu")
    stats = (pcg_step.BJS_STATS_F64 if vec == "float64"
             else pcg_step.BJS_STATS)
    for gr, hr in ((r, cr), (torch.zeros_like(r), torch.zeros_like(cr))):
        rr = k9.tree_dot(gr, gr)
        crr = pcg_loop.tree_dot(hr, hr)
        before = stats.launches
        out = pcg_step.bjs_apply(gr, rr, inv, segs)
        again = pcg_step.bjs_apply(gr, rr, inv, segs)
        assert stats.launches - before == 2
        ref = pcg_step.bjs_apply_plain(gr, rr, inv, segs)
        cpu = pcg_step.bjs_apply(hr, crr, cinv, segs)
        assert _k12_same(out, ref) and _k12_same(again, out)
        assert _k12_same(out, cpu)
    part = {"rigs": inv["rigs"]}
    rr = k9.tree_dot(r, r)
    got = pcg_step.bjs_apply(r, rr, part, segs)
    assert _k12_same(got, pcg_step.bjs_apply_plain(r, rr, part, segs))
    assert bool((got[:16_002] == 0).all())
    out = pcg_step.bjs_apply(r, rr, inv, segs)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = pcg_step.bjs_apply(r, k9.tree_dot(r, r), inv, segs)
    graph.replay()
    torch.cuda.synchronize()
    assert _k12_same(captured, out)
    r.mul_(-3.0)
    inv["cams"].add_(1.0)
    graph.replay()
    torch.cuda.synchronize()
    assert _k12_same(captured, pcg_step.bjs_apply_plain(
        r, pcg_loop.tree_dot_plain(r, r), inv, segs))


def _k12_state(n, dtype, device, seed=13):
    """A CG state (x, r, p, z, rz, rz_min, k, done) and a step's inputs
    (v, x_new, r_new, z_new), seeded, with -0.0 entries."""
    rng = np.random.default_rng(seed)

    def vec():
        a = rng.standard_normal(n) * 10.0 ** rng.integers(-2, 3, n)
        a[::9] = -0.0
        return torch.tensor(a, dtype=dtype)

    x, r, p, z, v = vec(), vec(), vec(), vec(), vec()
    rz = pcg_loop.tree_dot_plain(r, z)
    state = [x, r, p, z, rz, torch.tensor(abs(float(rz)) * 2.0,
                                          dtype=dtype),
             torch.tensor(3), torch.zeros((), dtype=torch.bool)]
    return ([t.to(device) for t in state], v.to(device), vec().to(device),
            vec().to(device), vec().to(device))


# (rz_new scale against rz, ratio): an accepted step, a rejected one, a
# NaN rz_new, an rz_new of 0 (the exit on rz == 0), a tol exit
K12_COMMIT_CASES = {"accepted": (0.5, 5.0, 1e-30), "rejected": (20.0, 5.0,
                                                                1e-30),
                    "nan": (float("nan"), 5.0, 1e-30),
                    "zero": (0.0, 5.0, 1e-30), "tol": (0.5, 5.0, 1e30)}


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("case", sorted(K12_COMMIT_CASES))
def test_k12_advance_and_commit_match_plain_bitwise(cuda_device, case,
                                                    dtype):
    """``cg_advance`` and ``cg_commit`` bitwise their plain versions on
    the card and on the CPU (every state tensor; a NaN's place), one launch
    a call, and the same bits replayed from a CUDA graph (the commit
    writes in place: the graph replays it on a fresh copy of the state),
    n = 16,002 (Venice's dim_p, 63 CTAs counting on the commit's ticket,
    back at 0 after each launch) and 7."""
    from graphite_tpu_torch.ops.cuda import pcg_step

    scale, ratio, tol = K12_COMMIT_CASES[case]
    dt = getattr(torch, dtype)
    for n in (7, 16_002):  # the graph below replays the 16,002 case
        runs = []
        for dev, advance, commit in (
                (cuda_device, pcg_step.cg_advance, pcg_step.cg_commit),
                (cuda_device, pcg_step.cg_advance_plain,
                 pcg_step.cg_commit_plain),
                ("cpu", pcg_step.cg_advance, pcg_step.cg_commit)):
            state, v, _, _, z_new = _k12_state(n, dt, dev)
            x, r, p, z, rz, rz_min, k, done = state
            x_new, r_new = torch.empty_like(x), torch.empty_like(x)
            pv = pcg_loop.tree_dot_plain(p, v)
            advance(x, r, p, v, rz, pv, x_new, r_new)
            rz_new = rz * scale
            ticket = torch.zeros((), dtype=torch.int32, device=dev)
            commit(x, r, p, z, x_new, r_new, z_new, rz, rz_new, rz_min, k,
                   done, ticket, ratio, tol)
            assert int(ticket) == 0
            runs.append(state + [x_new, r_new])
        for a, b in zip(runs[0], runs[1]):
            assert _k12_same(a, b)
        for a, b in zip(runs[0], runs[2]):
            assert _k12_same(a, b)
    want_done = case != "accepted"
    assert bool(runs[0][7]) == want_done and int(runs[0][6]) == 4
    # in a graph: replayed on the state copied back in
    state, v, _, _, z_new = _k12_state(16_002, dt, cuda_device)
    start = [t.clone() for t in state]
    x, r, p, z, rz, rz_min, k, done = state
    x_new, r_new = torch.empty_like(x), torch.empty_like(x)
    pv = pcg_loop.tree_dot_plain(p, v)
    rz_new = rz * scale
    ticket = torch.zeros((), dtype=torch.int32, device=cuda_device)
    before = (pcg_step.ADVANCE_STATS.launches, pcg_step.COMMIT_STATS.launches,
              pcg_step.ADVANCE_STATS_F64.launches,
              pcg_step.COMMIT_STATS_F64.launches)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        pcg_step.cg_advance(x, r, p, v, rz, pv, x_new, r_new)
        pcg_step.cg_commit(x, r, p, z, x_new, r_new, z_new, rz, rz_new,
                           rz_min, k, done, ticket, ratio, tol)
    after = (pcg_step.ADVANCE_STATS.launches, pcg_step.COMMIT_STATS.launches,
             pcg_step.ADVANCE_STATS_F64.launches,
             pcg_step.COMMIT_STATS_F64.launches)
    f64 = dtype == "float64"
    assert [a - b for a, b in zip(after, before)] == (
        [0, 0, 1, 1] if f64 else [1, 1, 0, 0])
    for _ in range(2):
        for t, s in zip(state, start):
            t.copy_(s)
        graph.replay()
        torch.cuda.synchronize()
        assert int(ticket) == 0
        for a, b in zip(state + [x_new, r_new], runs[0]):
            assert _k12_same(a, b)


def test_k12_commits_on_two_streams_at_once(cuda_device):
    """Two CG solves' commits launched in turns on two streams, each with
    its own ticket, 200 times: both states bitwise the same commits run
    one after the other on the CPU's plain version (a ticket shared by
    the two would let a CTA of one count toward the other's last CTA)."""
    from graphite_tpu_torch.ops.cuda import pcg_step

    n, rounds = 16_002, 200
    streams = [torch.cuda.Stream(cuda_device) for _ in range(2)]
    runs = []
    for dev in (cuda_device, "cpu"):
        solves = []
        for seed in (21, 22):
            state, v, x_new, r_new, z_new = _k12_state(n, torch.float32,
                                                       dev, seed)
            rz_new = state[4] * 0.5
            ticket = torch.zeros((), dtype=torch.int32, device=dev)
            solves.append((state, x_new, r_new, z_new, rz_new, ticket))
        torch.cuda.synchronize()
        for _ in range(rounds):
            for (state, x_new, r_new, z_new, rz_new, ticket), st in zip(
                    solves, streams):
                x, r, p, z, rz, rz_min, k, done = state
                with torch.cuda.stream(st):
                    pcg_step.cg_commit(x, r, p, z, x_new, r_new, z_new, rz,
                                       rz_new, rz_min, k, done, ticket,
                                       1e30, 1e-30)
        torch.cuda.synchronize()
        runs.append(solves)
    for (a, *_, ta), (b, *_) in zip(*runs):
        assert int(ta) == 0 and int(a[6]) == 3 + rounds
        for u, w in zip(a, b):
            assert _k12_same(u, w)


def test_k12_raises_off_its_dtypes(cuda_device):
    """No fallback: bf16 vectors, mixed dtypes, a non-contiguous vector,
    inverses of two dtypes, too many pose types raise."""
    from graphite_tpu_torch.graph import PoseSegments
    from graphite_tpu_torch.ops.cuda import pcg_step

    x = torch.ones(64, device=cuda_device)
    s = torch.ones((), device=cuda_device)
    with pytest.raises(NotImplementedError):
        pcg_step.cg_advance(*(x.bfloat16(),) * 4, s.bfloat16(),
                            s.bfloat16(), x.bfloat16(), x.bfloat16())
    with pytest.raises(ValueError):
        pcg_step.cg_advance(x, x, x, x.double(), s, s, x, x)
    with pytest.raises(ValueError):
        pcg_step.cg_advance(x, x, torch.ones(128, device=cuda_device)[::2],
                            x, s, s, x, x)
    k = torch.zeros((), dtype=torch.int32, device=cuda_device)
    done = torch.zeros((), dtype=torch.bool, device=cuda_device)
    with pytest.raises(ValueError):
        pcg_step.cg_commit(*(x,) * 7, s, s, s, k, done,
                           torch.zeros((), dtype=torch.int32,
                                       device=cuda_device), 5.0, 1.0)
    segs = PoseSegments((("a", 0, 8, 4), ("b", 32, 8, 4)), 64)
    with pytest.raises(NotImplementedError):
        pcg_step.bjs_apply(x, s, {
            "a": torch.ones(8, 16, dtype=torch.float64, device=cuda_device),
            "b": torch.ones(8, 16, device=cuda_device)}, segs)
    many = PoseSegments(tuple((f"t{i}", i * 4, 4, 1) for i in range(16)), 64)
    with pytest.raises(ValueError):
        pcg_step.bjs_apply(x, s, {}, many)


def test_k12_run_pcg_fixed_in_a_while_node_bitwise_run_pcg(cuda_device):
    """``run_pcg_fixed`` captured as a "while" node (the CG step's body:
    K9 three times, K12's advance, bjs_apply and commit once) bitwise
    ``run_pcg`` run eagerly on the card and on the CPU: x and the step
    count, the body's runs equal to the steps, on a two-type block-Jacobi
    system (diagonal A, elementwise matvec)."""
    from graphite_tpu_torch.ops import device_loop
    from graphite_tpu_torch.ops.cuda import pcg_step
    from graphite_tpu_torch.ops.pcg_loop import SelfNormalizing

    def system(device):
        r, inv, segs = _bjs_inputs("float32", "float32", device)
        rng = np.random.default_rng(14)
        a = torch.tensor(rng.uniform(1.0, 1e3, segs.dim_p),
                         dtype=torch.float32, device=device)
        inv = {k: v.abs() * 1e-3 for k, v in inv.items()}
        precond = SelfNormalizing(
            lambda y, rr: pcg_step.bjs_apply(y, rr, inv, segs))
        return r, (lambda p: a * p), precond

    args = (40, 1e-20, 1e6)
    x_cpu, k_cpu = pcg_loop.run_pcg(*system("cpu")[:3], *args)
    b, matvec, precond = system(cuda_device)
    x_host, k_host = pcg_loop.run_pcg(b, matvec, precond, *args)
    assert k_host == k_cpu > 5 and _k12_same(x_host, x_cpu)
    x, k = pcg_loop.run_pcg_fixed(b, matvec, precond, *args)  # warm up
    cap = device_loop.Capture(cuda_device)
    x, k = cap.record(lambda: pcg_loop.run_pcg_fixed(b, matvec, precond,
                                                     *args), 1)
    cap.replay()
    torch.cuda.synchronize()
    assert int(k) == k_host and _k12_same(x, x_host)
    assert cap.region_runs() == {"cg_step": k_host}
    body = cap.regions[0].launches
    assert (body["pcg_step.cg_advance"], body["pcg_step.cg_commit"],
            body["pcg_step.bjs_apply"], body["dot.tree_dot"]) == (1, 1, 1, 3)


@pytest.mark.parametrize("jit_loop", [False, True])
def test_k12_k13_forced_ladybug_cuda_equals_cpu(cuda_device, monkeypatch,
                                                 jit_loop):
    """Ladybug-49 with the Venice branches forced (K3, K4, K5;
    ``dense_matvec_limit=0``), FP32_FP32, 6 LM iterations: the card's
    trajectory and parameters bitwise the CPU's, under the host loop and
    ``jit_loop``; K12's advance and commit once per CG step and its
    bjs_apply once more per solve, K13 twice per iteration (b_S and the
    back-substitution)."""
    from graphite_tpu_torch.ops.cuda import pcg_step
    from graphite_tpu_torch.ops.cuda.launches import REGISTRY

    monkeypatch.setattr(schur, "CHUNK_THRESHOLD", 0)
    monkeypatch.setattr(schur, "_smv_chunk_rows", lambda rb: 0)
    solver = PCGSchurSolver(10, 1.0, 5.0, dense_matvec_limit=0)
    matvecs = []
    real = schur.SchurOps.s_matvec

    def s_matvec(self, p):
        matvecs.append(1)
        return real(self, p)

    monkeypatch.setattr(schur.SchurOps, "s_matvec", s_matvec)
    runs = []
    for dev in ("cpu", cuda_device):
        g, *_ = bal.build_graph(synthetic.make_bal("ladybug", seed=0),
                                precision=gtt.FP32_FP32)
        problem = g.freeze(device=dev)
        for s in REGISTRY:
            s.reset()
        matvecs.clear()
        runs.append(levenberg_marquardt(
            problem, solver, options=LevenbergMarquardtOptions(
                iterations=6, jit_loop=jit_loop and dev != "cpu")))
        if dev == "cpu":
            steps = len(matvecs)
    cpu, gpu = runs
    _bitwise(gpu, types.SimpleNamespace(
        history=cpu.history, chi2=cpu.chi2, initial_chi2=cpu.initial_chi2,
        mu=cpu.mu, params={n: p.to(cuda_device)
                           for n, p in cpu.params.items()}))
    if not jit_loop:
        assert len(matvecs) == steps
        assert pcg_step.ADVANCE_STATS.launches == steps
        assert pcg_step.COMMIT_STATS.launches == steps
        assert pcg_step.BJS_STATS.launches == steps + 6
        assert k10.HLL_SOLVE_STATS.launches == 2 * 6
    else:
        loop = device_loops(problem)[0]
        runs = loop.capture.region_runs()
        done = loop.capture.launches(loop.replays)
        assert runs["cg_step"] == steps
        assert done["pcg_step.cg_advance"] == done[
            "pcg_step.cg_commit"] == steps
        assert done["pcg_step.bjs_apply"] == steps + runs["lm_iteration"]
        assert done["schur_w.hll_solve"] == 2 * runs["lm_iteration"]


# K13 at 1,000 landmark rows, inverses of 1,001 rows (the trailing trash
# row), t with -0.0 entries
@pytest.mark.parametrize("sub", [False, True])
@pytest.mark.parametrize("permuted", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("dl", [1, 2, 3])
def test_k13_matches_plain_bitwise(cuda_device, dl, dtype, permuted, sub):
    """``hll_solve`` bitwise its plain version on the card and on the CPU,
    bitwise repeatable, one launch a call, and the same bits replayed from
    a CUDA graph and on new rows written into the captured ones."""
    rng = np.random.default_rng(10 * dl + permuted)
    L = 1000
    inv = torch.tensor(rng.standard_normal((L + 1, dl * dl)),
                       dtype=torch.float32)
    t = rng.standard_normal((L, dl)) * 10.0 ** rng.integers(-3, 4, (L, 1))
    t.reshape(-1)[::7] = -0.0
    t = torch.tensor(t, dtype=getattr(torch, dtype))
    s = (torch.tensor(rng.standard_normal((L, dl)), dtype=t.dtype) if sub
         else None)
    gidx = torch.as_tensor(rng.permutation(L)) if permuted else None
    cpu = k10.hll_solve(inv, gidx, t, s)
    dev = [None if a is None else a.to(cuda_device)
           for a in (inv, gidx, t, s)]
    before = k10.HLL_SOLVE_STATS.launches
    out, again = k10.hll_solve(*dev), k10.hll_solve(*dev)
    assert k10.HLL_SOLVE_STATS.launches - before == 2
    ref = k10.hll_solve_plain(*dev)
    assert out.dtype == torch.float32
    assert _k12_same(out, ref) and _k12_same(again, out)
    assert _k12_same(out, cpu)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = k10.hll_solve(*dev)
    graph.replay()
    torch.cuda.synchronize()
    assert _k12_same(captured, ref)
    dev[2].mul_(-2.0)
    graph.replay()
    torch.cuda.synchronize()
    assert _k12_same(captured, k10.hll_solve_plain(*dev))


@pytest.mark.parametrize("dl", [2, 3, 4, 6])
@pytest.mark.parametrize("vec,inv_dt", K12_PAIRS)
def test_k13_any_dtype_and_dim_match_plain_bitwise(cuda_device, vec,
                                                   inv_dt, dl):
    """``hll_solve`` on float64 inverses (FP64_FP64, FP64_BF16) and on
    landmarks wider than 3 (K13's loop over dl): bitwise its plain version
    on the card and on the CPU, w in the inverses' dtype, float64
    inverses' launches counted apart, and the same bits in a graph."""
    rng = np.random.default_rng(30 + dl)
    L = 700
    inv = torch.tensor(rng.standard_normal((L + 1, dl * dl)),
                       dtype=getattr(torch, inv_dt))
    t = rng.standard_normal((L, dl)) * 10.0 ** rng.integers(-3, 4, (L, 1))
    t.reshape(-1)[::5] = -0.0
    t = torch.tensor(t, dtype=getattr(torch, vec))
    s = torch.tensor(rng.standard_normal((L, dl)), dtype=t.dtype)
    gidx = torch.as_tensor(rng.permutation(L))
    cpu = k10.hll_solve(inv, gidx, t, s)
    dev = [a.to(cuda_device) for a in (inv, gidx, t, s)]
    stats = (k10.HLL_SOLVE_STATS_F64 if inv_dt == "float64"
             else k10.HLL_SOLVE_STATS)
    before = stats.launches
    out = k10.hll_solve(*dev)
    assert stats.launches - before == 1 and out.dtype == inv.dtype
    assert _k12_same(out, k10.hll_solve_plain(*dev))
    assert _k12_same(out, cpu)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = k10.hll_solve(*dev)
    graph.replay()
    torch.cuda.synchronize()
    assert _k12_same(captured, out)


def test_k13_raises_off_its_dtypes(cuda_device):
    """No fallback: float16 inverses, rows that do not fit the inverses,
    bf16 rows, a non-contiguous t raise."""
    inv = torch.ones(10, 9, device=cuda_device)
    t = torch.ones(10, 3, device=cuda_device)
    with pytest.raises(NotImplementedError):
        k10.hll_solve(inv.half(), None, t)
    with pytest.raises(ValueError):
        k10.hll_solve(torch.ones(10, 16, device=cuda_device), None, t)
    with pytest.raises(NotImplementedError):
        k10.hll_solve(inv, None, t.bfloat16())
    with pytest.raises(ValueError):
        k10.hll_solve(inv, None, torch.ones(3, 10, device=cuda_device).T)
