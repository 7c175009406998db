"""Analytic FLOP and byte ledgers, the card's peaks, and a host section
timer (counterpart of ``graphite_tpu/perf.py``).

- ``flop_ledger(problem)`` counts the useful floating-point operations of
  each stage of one PCG-Schur LM iteration from the static host structure
  (one multiply-add = 2 operations; a d x d inverse 2 d^3);
- ``bytes_ledger(problem)`` the bytes each stage must move at the least
  (each operand read once, each output written once, in float32);
- ``device_peak(device)`` the card's published peaks, so a measured time
  converts to a share of the roofline;
- ``SectionTimer`` laps of host set-up phases on the host clock.

The JAX package's ``xla_flops`` and ``compile_and_count`` read XLA's cost
analysis of a compiled program; PyTorch runs eagerly and has no such
analysis, so they have no counterpart here.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import torch

# NVIDIA H100 SXM (NVIDIA's data sheet, at its 700 W limit): dense bf16
# tensor-core rate, float32 and float64 outside the tensor cores, HBM3
# bandwidth
H100_SXM = dict(bf16=989e12, fp32=67e12, fp64=34e12, hbm_gbps=3350.0)
# by the exact name the driver reports: the H100 PCIe and NVL have lower
# rates and are not in the table
_PEAKS = {"NVIDIA H100 80GB HBM3": H100_SXM}
_ZERO = dict(bf16=0.0, fp32=0.0, fp64=0.0, hbm_gbps=0.0)


def device_peak(device=None) -> Dict[str, float]:
    """Peak operation rates (per second) and HBM GB/s of ``device``
    (default: the current CUDA card). A card not in the table, and the
    CPU, give zeros: the caller then reports no roofline share rather
    than divide by a guess."""
    if device is None:
        if not torch.cuda.is_available():
            return dict(_ZERO)
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return dict(_ZERO)
    return dict(_PEAKS.get(torch.cuda.get_device_name(device), _ZERO))


def flop_ledger(problem, pcg_iters: int = 10,
                dense_s_matvec: Optional[bool] = None) -> Dict[str, float]:
    """Useful operations of each stage of one PCG-Schur LM iteration,
    from the static structure (gathers, scatters and masked lanes
    excluded): ``hessian_values``, and with eliminated vertices
    ``hll_inverse``, ``hpl_w``, ``triple_products``, ``b_schur``,
    ``pcg_matvec`` ((pcg_iters + 1) S matvecs, dense or block-sparse),
    ``precond`` and ``backsub``."""
    from .hessian import build_hessian_structure
    from .schur import build_schur_structure

    hs = build_hessian_structure(problem)
    ledger: Dict[str, float] = {}

    hv = 0.0
    pj_done = set()
    for cm in hs.contribs:
        if cm.direct_idx is None and cm.trans_idx is None:
            continue
        fm = problem.factor_meta[cm.fname]
        F = fm.count
        E = fm.ftype.residual_dim
        ds = fm.ftype.vertex_types[cm.s].dim
        dt = fm.ftype.vertex_types[cm.t].dim
        fa = problem.data.factors[cm.fname]
        if fa.precision is not None and (cm.fname, cm.t) not in pj_done:
            pj_done.add((cm.fname, cm.t))
            hv += F * 2.0 * E * E * dt  # P J_t
        hv += F * (2.0 * E * ds * dt + ds * dt)  # J_s^T (P J_t), * dL
    ledger["hessian_values"] = hv

    if problem.elimination_block >= problem.n_blocks:
        return ledger  # no Schur system

    ss = build_schur_structure(problem)
    ledger["hll_inverse"] = sum(
        ss.lm_h_idx[d].shape[0] * 2.0 * d ** 3 for d in ss.lm_dims)
    ledger["hpl_w"] = sum(
        ss.hpl_h_idx[key].shape[0] * 2.0 * key[0] * key[1] * key[1]
        for key in ss.hpl_keys)
    ledger["triple_products"] = sum(
        pg["dst"].shape[0] * (2.0 * pg["dims"][0] * pg["dims"][1]
                              * pg["dims"][2] + pg["dims"][0] * pg["dims"][2])
        for pg in ss.products)
    ledger["b_schur"] = (
        sum(ss.lm_h_idx[d].shape[0] * 2.0 * d * d for d in ss.lm_dims)
        + sum(ss.hpl_h_idx[key].shape[0] * 2.0 * key[0] * key[1]
              for key in ss.hpl_keys))
    if dense_s_matvec is None:
        dense_s_matvec = ss.dim_p <= 8192
    if dense_s_matvec:
        per_mv = 2.0 * ss.dim_p * ss.dim_p
    else:  # each stored block and its transpose
        per_mv = sum((2.0 * key[0] * key[1]) * ss.s_sizes[key] * 2
                     for key in ss.s_keys)
    ledger["pcg_matvec"] = (pcg_iters + 1) * per_mv
    ledger["precond"] = sum(
        2.0 * float(d) ** 3 + (pcg_iters + 1) * 2.0 * float(d) * float(d)
        for d in ss.pose_dims)
    ledger["backsub"] = (
        sum(ss.hpl_h_idx[key].shape[0] * 2.0 * key[0] * key[1]
            for key in ss.hpl_keys)
        + sum(ss.lm_h_idx[d].shape[0] * 2.0 * d * d for d in ss.lm_dims))
    return ledger


def bytes_ledger(problem, pcg_iters: int = 10) -> Dict[str, float]:
    """The least bytes each Schur stage moves, in float32: every operand
    read once and every output written once, at the algorithm's own
    granularity. ``schur_values``: the W build (read Hpl and Hll^-1,
    write W), one W row and one Hpl row per triple product, S read and
    written once; ``pcg_matvec``: (pcg_iters + 1) S matvecs, each reading
    the stored blocks for both directions, the x rows and y twice;
    ``b_schur`` / ``backsub``: Hpl once plus the landmark solve tables."""
    from .hessian import build_hessian_structure
    from .schur import build_schur_structure

    build_hessian_structure(problem)
    B: Dict[str, float] = {}
    if problem.elimination_block >= problem.n_blocks:
        return B
    ss = build_schur_structure(problem)
    f = 4.0

    attach = {k: float(ss.hpl_h_idx[k].shape[0]) for k in ss.hpl_keys}
    n_lm_bytes = sum(
        float(ss.lm_h_idx[d].shape[0]) * d * d * f for d in ss.lm_dims)
    s_bytes = sum(float(ss.s_sizes[k]) * k[0] * k[1] * f for k in ss.s_keys)
    w_build = sum(a * (2.0 * k[0] * k[1] + k[1] * k[1]) * f
                  for k, a in attach.items())
    pair_stream = sum(
        float(pg["dst"].shape[0])
        * (pg["dims"][0] + pg["dims"][2]) * pg["dims"][1] * f
        for pg in ss.products)
    B["schur_values"] = w_build + n_lm_bytes + pair_stream + 2.0 * s_bytes
    B["b_schur"] = (sum(a * k[0] * k[1] * f for k, a in attach.items())
                    + 2.0 * n_lm_bytes + ss.dim_p * f)
    x_bytes = sum(float(ss.s_sizes[k]) * (k[0] + k[1]) * f for k in ss.s_keys)
    B["pcg_matvec"] = (pcg_iters + 1) * (2.0 * s_bytes + x_bytes
                                         + 2.0 * ss.dim_p * f)
    B["s_matvec"] = 2.0 * s_bytes + x_bytes + 2.0 * ss.dim_p * f
    B["backsub"] = (sum(a * k[0] * k[1] * f for k, a in attach.items())
                    + 2.0 * n_lm_bytes)
    return B


class SectionTimer:
    """Laps of host set-up phases on the host clock: ``lap(label)`` ends
    the section since the last lap, ``done()`` the whole run. Each lap is
    kept in ``laps`` as (label, seconds) and, with ``stream`` (e.g.
    ``sys.stderr``), printed as ``[name] label: seconds``."""

    def __init__(self, name: str, stream=None):
        self.name = name
        self.stream = stream
        self.laps: List[Tuple[str, float]] = []
        self._start = self._t0 = time.perf_counter()

    def _emit(self, label: str, seconds: float) -> None:
        if self.stream is not None:
            print(f"[{self.name}] {label}: {seconds:.3f}s", file=self.stream,
                  flush=True)

    def lap(self, label: str) -> float:
        t = time.perf_counter()
        seconds = t - self._t0
        self._t0 = t
        self.laps.append((label, seconds))
        self._emit(label, seconds)
        return seconds

    def done(self) -> float:
        seconds = time.perf_counter() - self._start
        self._emit("TOTAL", seconds)
        return seconds
