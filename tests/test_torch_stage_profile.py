"""The stage profiler (``graphite_tpu_torch.stage_profile``) on the CPU at
a small size: every stage of the LM run is timed, and the wrapped
functions are restored afterwards."""

import torch

from graphite_tpu_torch import stage_profile
from graphite_tpu_torch.schur import SchurOps
from graphite_tpu_torch.solvers import pcg_schur

torch.set_num_threads(1)


def test_stage_profile_times_every_stage_and_restores():
    before = (pcg_schur.schur_values, SchurOps.b_schur)
    out = stage_profile.profile_lm((12, 120, 700), 3, 2, "cpu")
    assert (pcg_schur.schur_values, SchurOps.b_schur) == before
    assert out["iterations"] == 3 and "busy_share" not in out
    for stage in ("linearize", "hessian_values", "apply_damping",
                  "schur_values", "b_schur", "dense_pcg", "landmark_update",
                  "compute_chi2"):
        s = out["stages"][stage]
        assert s["calls"] >= 1 and s["total_ms"] > 0, stage
    assert out["stages"]["schur_values"]["calls"] == 3


def test_union_of_device_intervals():
    assert stage_profile._union_us([(0, 2), (1, 3), (5, 6)]) == 4
    assert stage_profile._union_us([(0, 10), (2, 3)]) == 10


def test_stage_profile_pose_path():
    """``--size sphere2500``: the pose path's stages (the folding of J and
    the matrix-free PCG) are timed."""
    out = stage_profile.profile_lm("sphere2500", 2, 0, "cpu")
    assert out["iterations"] == 2
    for stage in ("linearize", "preconditioner_prepare",
                  "preconditioner_set_damping", "fold_jacobians",
                  "solve_pcg_mf", "compute_chi2"):
        assert out["stages"][stage]["calls"] >= 1, stage
    assert "run_pcg" not in out["stages"]
