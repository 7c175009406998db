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
"""

import numpy as np
import pytest
import torch

import graphite_tpu_torch as gtt
from graphite_tpu_torch.io import bal, synthetic
from graphite_tpu_torch.ops.cuda import pcg_dense, segsum, segsum_stream
from graphite_tpu_torch.optimizers import (
    LevenbergMarquardtOptions,
    levenberg_marquardt,
)
from graphite_tpu_torch.solvers import PCGSchurSolver

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
