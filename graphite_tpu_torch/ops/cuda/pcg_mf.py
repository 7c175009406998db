"""Whole matrix-free PCG in one launch: kernel K6 (``csrc/pcg_mf.cu``).

Counterpart of ``graphite_tpu/ops/pallas/pcg_mf.py`` (``plan_pcg_mf``,
``solve_pcg_mf``). Solves (J'^T J' + diag(damp)) x = b on the rows of the
problem's one vertex type, with J' = sqrt(max(dL, 0)) chol(P)^T J the
folded Jacobian of every factor block (so J'^T J' = J^T dL P J), and the
block-Jacobi inverse blocks (or the identity) as preconditioner.

- ``plan_pcg_mf``: the JAX package's feasibility gate (one vertex type
  with active rows, every factor block on it with arity * E * d <= 128,
  ``tpad(n + 1) <= TABLE_ROWS_LIMIT`` and the padded folded J within
  ``J_BYTES_LIMIT``; both limits are module globals that tests lower),
  then the host structure, built once per problem: the slot rows (a fixed
  vertex's slot points at the zero trash row n), the row CSR of the
  (factor, slot) incidences, and the Cholesky factors of the precision
  matrices (constant problem data: taken once in float64 on the host and
  rounded to P's dtype, at least float32, so the CPU and the card fold
  the same J').
- ``fold_jacobians``: J' of every block, flat, in the kernel's layout, in
  at least float32: bf16 or fp16 J is upcast first, as the JAX package
  folds (float64 J folds in float64, for the plain version's tests).
- ``solve_pcg_mf_plain``: ``run_pcg`` with a matvec and a preconditioner
  that take every product and sum in K6's order (the row scatter as a
  padded CSR walk, no atomics) and the plain dots (``tree_dot_plain``, not
  K9, so it stays plain on the card); the CPU path and the kernel's
  oracle.
- ``solve_pcg_mf``: the plain version for CPU tensors; on a CUDA tensor
  it launches K6 (float32) or raises. K6 runs the whole solve on one
  thread-block cluster of ``cluster_size(n * d)`` CTAs (at most 16;
  ``cluster=`` forces another size, for tests and ``kernel_sweep``). A
  CTA owns whole 1,024-entry chunks of the vectors and computes J' p for
  its rows' incidences, so every sum keeps one order and the bits do not
  depend on the cluster size (``csrc/pcg_mf.cu``).

Both return ``(x, iterations)``: x (n * d,) over the type's rows and the
number of CG steps taken (a 0-d int tensor on the device).
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..blockfmt import flat_block_mm_tn
from ..pcg_loop import run_pcg, tree_dot_plain
from ...precision import sqrt_rn
from . import build
from .launches import LaunchStats, on_device, stream_ptr

STATS = LaunchStats("pcg_mf.solve_pcg_mf")

# The JAX package's gate: the folded J must fit its TPU kernel's VMEM
# budget, the row table its in-kernel gather limit
# (graphite_tpu/ops/pallas/pcg_mf.py, segmv.py). Neither is a limit of K6,
# which reads J' and the vectors from global memory (staging into shared
# memory what fits); its own limits are N = n * d <= 1024 chunks of 1024
# and the shared memory of its chunk sums and block descriptors, which the
# launch checks. The gate is kept so that the port takes the JAX package's
# branch at every size, and tests lower it (ROADMAP Next: replace it with
# K6's own feasibility).
J_BYTES_LIMIT = 6 << 20
TABLE_ROWS_LIMIT = 4096
TB = 512  # row-table padding
CF = 2048  # factor chunk of the padded J

CHUNK = 1024  # vector entries of a dot chunk; a CTA owns whole chunks
MAX_CLUSTER = 16
THREADS = 512  # a CTA's threads (csrc/pcg_mf.cu kThreads)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # jf, rows, desc, nb, csr_off, inc_j, inc_e, b, damp, minv, work, x,
    # iters, n, d, max_iter, tol, rejection_ratio, cluster, stage_j,
    # stream
    "gt_pcg_mf_f32": [_P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                      _I, _I, _I, _F, _F, _I, _I, _P],
    # cluster, threads, reps, stream: microbenchmarks (kernel_sweep)
    "gt_pcg_mf_cluster_barriers": [_I, _I, _I, _P],
    "gt_pcg_mf_cluster_exchanges": [_I, _I, _I, _P],
}


def load_kernel() -> build.KernelLibrary:
    """Build K6 (at first use) and load it."""
    return build.load_library("pcg_mf", _SIGNATURES)


def cluster_size(N: int) -> int:
    """K6's CTAs for N vector entries: one 1,024-entry chunk each where
    there are at most 16 chunks (a power of two, so sphere2500's 15 chunks
    take 16, one of them idle), else 16."""
    chunks = -(-N // CHUNK)
    return min(MAX_CLUSTER, 1 << max(chunks - 1, 0).bit_length())


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def tpad(n: int) -> int:
    return max(_round_up(n, TB), TB)


@dataclasses.dataclass(frozen=True)
class MfBlock:
    """One factor block: its offsets into the flat J', v and slot rows."""

    fname: str
    F: int
    E: int
    arity: int
    jbase: int
    vbase: int
    rbase: int


@dataclasses.dataclass(frozen=True)
class PcgMfSite:
    """Host-built structure of the matrix-free PCG of one problem."""

    vt_name: str
    d: int
    n: int
    blocks: Tuple[MfBlock, ...]
    n_j: int  # floats of the folded J' over all blocks
    rows: torch.Tensor  # (sum arity * F,) int32 slot rows, trash row n
    desc: torch.Tensor  # (nb, 6) int32 block descriptors
    csr_off: torch.Tensor  # (n + 1,) int32
    inc_j: torch.Tensor  # (n_inc,) int32 J' offset of each incidence
    inc_v: torch.Tensor  # (n_inc,) int32 v offset
    inc_e: torch.Tensor  # (n_inc,) int32 residual dim
    chol: Dict[str, Optional[torch.Tensor]]  # (F, E*E) lower factors


def plan_pcg_mf(problem, lin) -> Optional[PcgMfSite]:
    """The matrix-free PCG site of ``problem``, or None when the gate
    refuses it (cached on the problem)."""
    cache = problem._cache
    if "pcg_mf_site" in cache:
        return cache["pcg_mf_site"]
    site = None
    vnames = [n for n, vm in problem.vertex_meta.items() if vm.count]
    if len(vnames) == 1:
        vt_name = vnames[0]
        d = problem.vertex_meta[vt_name].vtype.dim
        n = problem.seg_rows[vt_name]
        ok = n > 0 and tpad(n + 1) <= TABLE_ROWS_LIMIT and d <= 128
        j_bytes = 0
        for fname, fm in problem.factor_meta.items():
            ft = fm.ftype
            if (lin.jacobians.get(fname) is None
                    or ft.arity * ft.residual_dim * d > 128
                    or any(vt.name != vt_name for vt in ft.vertex_types)):
                ok = False
                break
            F = fm.count
            cf = min(CF, max(_round_up(F, 512), 512))
            j_bytes += _round_up(F, cf) * 128 * 4
        if ok and j_bytes <= J_BYTES_LIMIT and problem.factor_meta:
            site = _build_site(problem, vt_name, d, n)
    cache["pcg_mf_site"] = site
    return site


def _build_site(problem, vt_name: str, d: int, n: int) -> PcgMfSite:
    dev = problem.device
    blocks, rows, desc = [], [], []
    inc_row, inc_j, inc_v, inc_e = [], [], [], []
    chol = {}
    jbase = vbase = rbase = 0
    for fname, fm in problem.factor_meta.items():
        F, E, arity = fm.count, fm.ftype.residual_dim, fm.ftype.arity
        W = arity * E * d
        f = np.arange(F, dtype=np.int64)
        for s in range(arity):
            r = problem.host.vertex_active_row[vt_name][
                problem.host.factor_ids[fname][:, s]]
            rows.append(r)
            inc_row.append(r)
            inc_j.append(jbase + f * W + s * E * d)
            inc_v.append(vbase + f * E)
            inc_e.append(np.full(F, E, dtype=np.int64))
        blocks.append(MfBlock(fname, F, E, arity, jbase, vbase, rbase))
        desc.append([jbase, vbase, rbase, F, E, arity])
        jbase += F * W
        vbase += F * E
        rbase += arity * F
        P = problem.data.factors[fname].precision
        if P is None:
            chol[fname] = None
        else:  # float64 on the host; a factor that fails becomes NaN
            L, info = torch.linalg.cholesky_ex(
                P.detach().cpu().to(torch.float64).reshape(F, E, E))
            L = torch.where((info == 0)[:, None, None], L,
                            torch.full_like(L, float("nan")))
            chol[fname] = L.reshape(F, E * E).to(
                torch.promote_types(P.dtype, torch.float32)).to(dev)
    inc_row = np.concatenate(inc_row)
    order = np.argsort(inc_row, kind="stable")
    order = order[inc_row[order] < n]  # fixed vertices scatter nowhere
    deg = np.bincount(inc_row[order], minlength=n)
    csr_off = np.concatenate([[0], np.cumsum(deg)])

    def i32(a):
        return torch.as_tensor(np.asarray(a, dtype=np.int32), device=dev)

    return PcgMfSite(
        vt_name=vt_name, d=d, n=n, blocks=tuple(blocks), n_j=jbase,
        rows=i32(np.concatenate(rows)),
        desc=i32(np.asarray(desc).reshape(-1, 6)),
        csr_off=i32(csr_off),
        inc_j=i32(np.concatenate(inc_j)[order]),
        inc_v=i32(np.concatenate(inc_v)[order]),
        inc_e=i32(np.concatenate(inc_e)[order]), chol=chol)


def fold_jacobians(problem, lin, site: PcgMfSite) -> torch.Tensor:
    """J' = sqrt(max(dL, 0)) chol(P)^T J of every block, flat: block b
    row-major (F, arity * E * d) from ``jbase``, slots side by side. In
    float32 for J stored in float32, bf16 or fp16 (float64 J in float64):
    J, dL and the factors are upcast before the product, in the JAX
    package's order (``graphite_tpu/ops/pallas/pcg_mf.py``: C^T J, then
    times sqrt(dL))."""
    d = site.d
    parts = []
    for blk in site.blocks:
        J = lin.jacobians[blk.fname]
        dt = torch.promote_types(J[0].dtype, torch.float32)
        dl = sqrt_rn(lin.chi2_deriv[blk.fname].to(dt).clamp_min(0.0))
        C = site.chol[blk.fname]
        slots = []
        for s in range(blk.arity):
            Js = J[s].to(dt)
            if C is not None:
                Js = flat_block_mm_tn(C, Js, blk.E, blk.E, d, acc_dtype=dt)
            slots.append(Js * dl[:, None])
        parts.append(torch.cat(slots, dim=1).reshape(-1))
    return torch.cat(parts)


def _incidence_table(site: PcgMfSite) -> torch.Tensor:
    """(n, max_deg) int64: each row's incidences in CSR order, padded with
    the incidence count (a zero row of the plain version's J'^T v)."""
    off = site.csr_off.long()
    deg = off[1:] - off[:-1]
    max_deg = int(deg.max()) if site.n else 0
    k = torch.arange(max_deg, device=off.device)
    return torch.where(k < deg[:, None], off[:-1, None] + k,
                       off[-1]).reshape(site.n, max_deg)


def _matvec_plain(site: PcgMfSite, jf, damp, p, table):
    """damp * p + J'^T (J' p) in K6's order of operations, from the
    kernel's own int32 structure (``table`` from ``_incidence_table``)."""
    d, n = site.d, site.n
    p_pad = torch.cat([p, p.new_zeros(d)]).reshape(n + 1, d)
    v_parts = []
    for blk in site.blocks:
        F, E, arity = blk.F, blk.E, blk.arity
        J = jf[blk.jbase:blk.jbase + F * arity * E * d].reshape(F, arity, E,
                                                                d)
        rows = site.rows[blk.rbase:blk.rbase + arity * F].long().reshape(
            arity, F)
        v = p.new_zeros((F, E))
        for s in range(arity):
            pg = p_pad.index_select(0, rows[s])
            for j in range(d):
                v = v + J[:, s, :, j] * pg[:, j, None]
        v_parts.append(v.reshape(-1))
    v = torch.cat(v_parts)
    # g_t = J'_{f,s}^T v_f of each incidence t, in CSR order
    inc_j, inc_v, inc_e = (site.inc_j.long(), site.inc_v.long(),
                           site.inc_e.long())
    cols = torch.arange(d, device=p.device)
    g = p.new_zeros((inc_j.shape[0], d))
    for e in range(int(inc_e.max()) if inc_e.numel() else 0):
        live = e < inc_e
        jc = jf.index_select(0, (torch.where(live, inc_j, 0)[:, None] + e * d
                                 + cols).reshape(-1)).reshape(-1, d)
        ve = v.index_select(0, torch.where(live, inc_v + e, 0))
        g = torch.where(live[:, None], g + jc * ve[:, None], g)
    g = torch.cat([g, p.new_zeros((1, d))])
    acc = p.new_zeros((n, d))
    for k in range(table.shape[1]):  # each row's incidences in order
        acc = acc + g.index_select(0, table[:, k])
    return damp * p + acc.reshape(-1)


def _precondition_plain(minv, d):
    def apply(y):
        if minv is None:
            return y
        M = minv.reshape(-1, d, d)
        y2 = y.reshape(-1, d)
        z = torch.zeros_like(y2)
        for j in range(d):
            z = z + M[:, :, j] * y2[:, j, None]
        return z.reshape(-1)
    return apply


def solve_pcg_mf_plain(site: PcgMfSite, jf, b, damp, minv, *, max_iter: int,
                       tol: float, rejection_ratio: float):
    """Plain PyTorch version of K6 (see the module docstring)."""
    table = _incidence_table(site)
    x, k = run_pcg(b, lambda p: _matvec_plain(site, jf, damp, p, table),
                   _precondition_plain(minv, site.d), max_iter, tol,
                   rejection_ratio, dot=tree_dot_plain)
    return x, torch.tensor(k, device=b.device)


def work_floats(site: PcgMfSite) -> int:
    """K6's global scratch: eight vectors of n * d (used where they do not
    fit in shared memory), and per incidence its gathered p (largest arity
    x d) and its J' p (largest E)."""
    amax = max(blk.arity for blk in site.blocks)
    emax = max(blk.E for blk in site.blocks)
    return (8 * site.n * site.d
            + int(site.inc_j.numel()) * (amax * site.d + emax))


def solve_pcg_mf(site: PcgMfSite, jf: torch.Tensor, b: torch.Tensor,
                 damp: torch.Tensor, minv: Optional[torch.Tensor], *,
                 max_iter: int, tol: float, rejection_ratio: float,
                 cluster: Optional[int] = None):
    """Solve on the site's rows: ``jf`` from ``fold_jacobians``; ``b`` and
    ``damp`` (n * d,); ``minv`` (n, d * d) row-major inverse blocks or None
    (identity). Returns (x, iterations). ``cluster``: K6's CTAs (1-16),
    ``cluster_size(n * d)`` by default; it changes no bits."""
    if b.device.type == "cpu":
        return solve_pcg_mf_plain(site, jf, b, damp, minv, max_iter=max_iter,
                                  tol=tol, rejection_ratio=rejection_ratio)
    if b.device.type != "cuda":
        raise NotImplementedError(f"no kernel for device {b.device}")
    n, d = site.n, site.d
    shapes = [("jf", jf, (site.n_j,)), ("b", b, (n * d,)),
              ("damp", damp, (n * d,))]
    if minv is not None:
        shapes.append(("minv", minv, (n, d * d)))
    for name, t, shape in shapes:
        if t.dtype != torch.float32:
            raise NotImplementedError(
                f"{STATS.name}: the CUDA kernel takes float32, {name} is "
                f"{t.dtype}")
        if t.device != b.device or tuple(t.shape) != shape:
            raise ValueError(f"{STATS.name}: {name} must be {shape} on "
                             f"{b.device}, got {tuple(t.shape)} on "
                             f"{t.device}")
    if site.rows.device != b.device:
        raise ValueError(f"{STATS.name}: site and b on different devices")
    cluster = cluster_size(n * d) if cluster is None else cluster
    if not 0 < cluster <= MAX_CLUSTER:
        raise ValueError(f"{STATS.name}: cluster = {cluster} outside "
                         f"(0, {MAX_CLUSTER}]")
    jf, b, damp = jf.contiguous(), b.contiguous(), damp.contiguous()
    minv = None if minv is None else minv.contiguous()
    work = torch.empty(work_floats(site), dtype=torch.float32,
                       device=b.device)
    x = torch.empty(n * d, dtype=torch.float32, device=b.device)
    iters = torch.empty(1, dtype=torch.int32, device=b.device)
    lib = load_kernel()
    with on_device(b.device):
        stream = stream_ptr(b.device)
        ev = STATS.start()
        err = lib.lib.gt_pcg_mf_f32(
            jf.data_ptr(), site.rows.data_ptr(), site.desc.data_ptr(),
            len(site.blocks), site.csr_off.data_ptr(), site.inc_j.data_ptr(),
            site.inc_e.data_ptr(), b.data_ptr(), damp.data_ptr(),
            None if minv is None else minv.data_ptr(), work.data_ptr(),
            x.data_ptr(), iters.data_ptr(), n, d, int(max_iter), float(tol),
            float(rejection_ratio), cluster, 1, stream)
        lib.check(err, STATS.name)
        STATS.done(ev)
    return x, iters[0]
