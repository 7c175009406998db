"""``graphite_tpu_torch.perf`` against ``graphite_tpu.perf``: the FLOP and
byte ledgers equal the JAX package's, stage by stage, on the same frozen
problems (BAL ``mini``, BAL (10, 400, 3000), and an SE3 pose graph, which
has no Schur stages); ``device_peak`` gives zeros on the CPU; the section
timer keeps its laps on the host clock."""

import io

import pytest
import torch

import graphite_tpu as gt
import graphite_tpu_torch as gtt
from graphite_tpu import perf as jax_perf
from graphite_tpu.io import bal as jax_bal
from graphite_tpu.io import g2o as jax_g2o
from graphite_tpu.io import synthetic as jax_synth
from graphite_tpu_torch import perf
from graphite_tpu_torch.io import bal as torch_bal
from graphite_tpu_torch.io import g2o as torch_g2o
from graphite_tpu_torch.io import synthetic as torch_synth


def _bal(size):
    gj, *_ = jax_bal.build_graph(jax_synth.make_bal(size, seed=0),
                                 precision=gt.FP32_FP32)
    gp, *_ = torch_bal.build_graph(torch_synth.make_bal(size, seed=0),
                                   precision=gtt.FP32_FP32)
    return gj.freeze(), gp.freeze(device="cpu")


@pytest.mark.parametrize("size", ["mini", (10, 400, 3000)],
                         ids=["mini", "10-400-3000"])
@pytest.mark.parametrize("pcg_iters,dense", [(10, None), (5, False)])
def test_bal_ledgers_match_jax(size, pcg_iters, dense):
    pj, pt = _bal(size)
    flops = perf.flop_ledger(pt, pcg_iters, dense)
    assert flops == jax_perf.flop_ledger(pj, pcg_iters, dense)
    assert set(flops) == {"hessian_values", "hll_inverse", "hpl_w",
                          "triple_products", "b_schur", "pcg_matvec",
                          "precond", "backsub"}
    assert all(v > 0 for v in flops.values())
    assert perf.bytes_ledger(pt, pcg_iters) == jax_perf.bytes_ledger(
        pj, pcg_iters)


def test_pose_graph_ledgers_match_jax():
    gj, *_ = jax_g2o.build_graph(jax_synth.make_sphere_se3(120, seed=0),
                                 precision=gt.FP32_FP32)
    gp, *_ = torch_g2o.build_graph(torch_synth.make_sphere_se3(120, seed=0),
                                   precision=gtt.FP32_FP32)
    pj, pt = gj.freeze(), gp.freeze(device="cpu")
    flops = perf.flop_ledger(pt)
    assert flops == jax_perf.flop_ledger(pj)
    assert list(flops) == ["hessian_values"] and flops["hessian_values"] > 0
    assert perf.bytes_ledger(pt) == jax_perf.bytes_ledger(pj) == {}


def test_device_peak_is_zero_on_the_cpu():
    assert perf.device_peak(torch.device("cpu")) == dict(
        bf16=0.0, fp32=0.0, fp64=0.0, hbm_gbps=0.0)
    assert perf.device_peak("cpu").keys() == perf.H100_SXM.keys()


@pytest.mark.parametrize("name,sxm", [
    ("NVIDIA H100 80GB HBM3", True),
    ("NVIDIA H100 PCIe", False),
    ("NVIDIA H100 NVL", False),
    ("NVIDIA A100-SXM4-80GB", False),
])
def test_device_peak_names_only_the_sxm_card(monkeypatch, name, sxm):
    """Only the H100 SXM gets its peaks: the PCIe and NVL variants have
    lower HBM and float32 rates, so they (and any other card) get zeros."""
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device: name)
    peak = perf.device_peak(torch.device("cuda", 0))
    assert peak == (perf.H100_SXM if sxm else dict(
        bf16=0.0, fp32=0.0, fp64=0.0, hbm_gbps=0.0))


def test_section_timer_laps():
    stream = io.StringIO()
    timer = perf.SectionTimer("setup", stream=stream)
    a = timer.lap("first")
    b = timer.lap("second")
    total = timer.done()
    assert [name for name, _ in timer.laps] == ["first", "second"]
    assert 0.0 <= a and 0.0 <= b and total >= a + b
    lines = stream.getvalue().splitlines()
    assert lines[0].startswith("[setup] first: ")
    assert lines[-1].startswith("[setup] TOTAL: ")
    assert perf.SectionTimer("quiet").lap("x") >= 0.0
