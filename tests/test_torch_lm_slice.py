"""The port's main path end to end vs the JAX package: Levenberg-Marquardt
with PCGSchurSolver(10, 1.0, 5.0) on the same synthetic BAL problem for 5
iterations.

- float64: the same accept pattern, chi2 per iteration to 1e-9 and the
  final parameters to 1e-9 (only the reductions' summation order
  differs).
- float32: the same accept pattern and the final chi2 to 1e-3. Here the
  port takes its fused dense-PCG branch (plain version on the CPU) and
  the JAX package its while-loop PCG, as it does on the CPU.
- float64 with ``dense_matvec_limit=0`` in both packages: the PCG runs on
  the block-sparse S matvec. Once with the port's default gates (the
  stepwise matvec) and once with its size gates lowered, where the
  float64 sites take the K3, K4, K5 branches (the plain versions of
  their float64 instances on the CPU; ``test_torch_schur_f64.py`` checks
  which wrappers run): the same accept pattern and chi2 per iteration to
  1e-9.
"""

import pytest

import numpy as np
import torch

import graphite_tpu as gt
import graphite_tpu_torch as gtt
from graphite_tpu.io import synthetic as jax_synth
from graphite_tpu.io.bal import build_graph as jax_build_graph
from graphite_tpu.optimizers import LevenbergMarquardtOptions as JaxOptions
from graphite_tpu.optimizers import levenberg_marquardt as jax_lm
from graphite_tpu.solvers import PCGSchurSolver as JaxPCGSchur
from graphite_tpu_torch import schur as torch_schur
from graphite_tpu_torch.interop import params_to_numpy
from graphite_tpu_torch.io import bal as torch_bal_io
from graphite_tpu_torch.io import synthetic as torch_synth
from graphite_tpu_torch.ops.cuda import pcg_dense
from graphite_tpu_torch.optimizers import LevenbergMarquardtOptions
from graphite_tpu_torch.optimizers import levenberg_marquardt
from graphite_tpu_torch.solvers import PCGSchurSolver

torch.set_num_threads(1)

SIZE = (12, 120, 700)
ITERS = 5


def _runs(jax_prec, torch_prec, **solver_kw):
    ds_j = jax_synth.make_bal(SIZE, seed=0, noise=0.5)
    gj, *_ = jax_build_graph(ds_j, precision=jax_prec)
    ref = jax_lm(gj.freeze(), JaxPCGSchur(10, 1.0, 5.0, **solver_kw),
                 options=JaxOptions(iterations=ITERS))
    ds_t = torch_synth.make_bal(SIZE, seed=0, noise=0.5)
    gp, *_ = torch_bal_io.build_graph(ds_t, precision=torch_prec)
    out = levenberg_marquardt(gp.freeze(device="cpu"),
                              PCGSchurSolver(10, 1.0, 5.0, **solver_kw),
                              options=LevenbergMarquardtOptions(
                                  iterations=ITERS))
    return ref, out


def test_lm_slice_matches_jax_f64():
    ref, out = _runs(gt.FP64_FP64, gtt.FP64_FP64)
    assert len(out.history) == len(ref.history) == ITERS
    assert ([h["accepted"] for h in out.history]
            == [h["accepted"] for h in ref.history])
    np.testing.assert_allclose([h["chi2"] for h in out.history],
                               [h["chi2"] for h in ref.history], rtol=1e-9)
    np.testing.assert_allclose(out.initial_chi2, ref.initial_chi2, rtol=1e-9)
    assert out.chi2 < out.initial_chi2
    final = params_to_numpy(out.params)
    assert final.keys() == ref.params.keys()
    for name, p in final.items():
        ref_p = np.asarray(ref.params[name])
        np.testing.assert_allclose(p, ref_p, rtol=1e-9,
                                   atol=1e-9 * np.abs(ref_p).max())


def test_lm_slice_matches_jax_f32():
    before = pcg_dense.STATS.launches
    ref, out = _runs(gt.FP32_FP32, gtt.FP32_FP32)
    assert ([h["accepted"] for h in out.history]
            == [h["accepted"] for h in ref.history])
    np.testing.assert_allclose(out.chi2, ref.chi2, rtol=1e-3)
    assert out.chi2 < out.initial_chi2
    for name, p in out.params.items():
        assert p.dtype == torch.float32 and torch.all(torch.isfinite(p))
    # CPU tensors never launch a kernel
    assert pcg_dense.STATS.launches == before


@pytest.mark.parametrize("forced", [False, True])
def test_lm_slice_block_sparse_matvec_matches_jax_f64(monkeypatch, forced):
    if forced:
        monkeypatch.setattr(torch_schur, "CHUNK_THRESHOLD", 0)
        monkeypatch.setattr(torch_schur, "_smv_chunk_rows", lambda rb: 0)
    ref, out = _runs(gt.FP64_FP64, gtt.FP64_FP64, dense_matvec_limit=0)
    assert len(out.history) == len(ref.history) == ITERS
    assert ([h["accepted"] for h in out.history]
            == [h["accepted"] for h in ref.history])
    np.testing.assert_allclose([h["chi2"] for h in out.history],
                               [h["chi2"] for h in ref.history], rtol=1e-9)
    assert out.chi2 < out.initial_chi2


@pytest.mark.parametrize("dense_matvec_limit", [8192, 0],
                         ids=["dense-S", "block-sparse-S"])
def test_lm_slice_identity_schur_preconditioner(monkeypatch,
                                                dense_matvec_limit):
    """IdentitySchurPreconditioner in both packages, float64: the same
    accept pattern and chi2 per iteration to 1e-9, on the dense-S branch
    (``tree_matvec``) and the block-sparse one. In float32 the port never
    takes the fused dense PCG (K2): its gate asks for block-Jacobi-Schur."""
    from graphite_tpu.preconditioners.block_jacobi_schur import (
        IdentitySchurPreconditioner as JaxIdentitySchur,
    )
    from graphite_tpu_torch.preconditioners import (
        IdentitySchurPreconditioner,
    )
    from graphite_tpu_torch.solvers import pcg_schur

    ds_j = jax_synth.make_bal(SIZE, seed=0, noise=0.5)
    gj, *_ = jax_build_graph(ds_j, precision=gt.FP64_FP64)
    ref = jax_lm(gj.freeze(), JaxPCGSchur(
        10, 1.0, 5.0, preconditioner=JaxIdentitySchur(),
        dense_matvec_limit=dense_matvec_limit),
        options=JaxOptions(iterations=ITERS))

    def no_k2(*args, **kwargs):
        raise AssertionError("dense_pcg (K2) taken without block-Jacobi-Schur")

    monkeypatch.setattr(pcg_schur, "dense_pcg", no_k2)
    outs = {}
    for prec in (gtt.FP64_FP64, gtt.FP32_FP32):
        gp, *_ = torch_bal_io.build_graph(
            torch_synth.make_bal(SIZE, seed=0, noise=0.5), precision=prec)
        outs[prec] = levenberg_marquardt(
            gp.freeze(device="cpu"), PCGSchurSolver(
                10, 1.0, 5.0, preconditioner=IdentitySchurPreconditioner(),
                dense_matvec_limit=dense_matvec_limit),
            options=LevenbergMarquardtOptions(iterations=ITERS))
    out = outs[gtt.FP64_FP64]
    assert ([h["accepted"] for h in out.history]
            == [h["accepted"] for h in ref.history])
    np.testing.assert_allclose([h["chi2"] for h in out.history],
                               [h["chi2"] for h in ref.history], rtol=1e-9)
    assert outs[gtt.FP32_FP32].chi2 < outs[gtt.FP32_FP32].initial_chi2

