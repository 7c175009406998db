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
  folds; float64 J (FP64_FP64) folds in float64.
- ``solve_pcg_mf_plain``: ``run_pcg`` with a matvec and a preconditioner
  that take every product and sum in K6's order (the row scatter as a
  padded CSR walk, no atomics) and the plain dots (``tree_dot_plain``, not
  K9, so it stays plain on the card); the CPU path and the kernel's
  oracle.
- ``solve_pcg_mf``: the plain version for CPU tensors; on a CUDA tensor
  it launches K6 or raises: the float32 instance on float32 vectors (a
  float32 graph, every input float32), the float64 instance on float64
  b and damp (a float64 graph: the whole solve in double; J' and the
  inverse blocks float64 (FP64_FP64), float32 (FP64_FP32, whose
  ``inv_dtype`` is float32) or float32 and float64 (FP64_BF16), each
  widened to double in its products as PyTorch promotes them), counted as
  ``pcg_mf.solve_pcg_mf[f64]``. K6 runs the whole solve on one
  thread-block cluster of ``cluster_size(n * d)`` CTAs (at most 16;
  ``cluster=`` forces another size, for tests and ``kernel_sweep``). A
  CTA owns whole 1,024-entry chunks of the vectors and computes J' p for
  its rows' incidences, so every sum keeps one order and the bits do not
  depend on the cluster size (``csrc/pcg_mf.cu``). The float64 instance
  has a design of its own (256 threads, J' p once a factor and CTA, J'
  staged by slot block; ``pcg_mf64_kernel``) wherever its pieces fit in
  a CTA's shared memory (``takes_design64``: sphere2500 does), else it
  runs the float32 design in double; both give the same bits.

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
STATS_F64 = LaunchStats("pcg_mf.solve_pcg_mf[f64]")  # a float64 graph's

# The JAX package's gate: the folded J must fit its TPU kernel's VMEM
# budget, the row table its in-kernel gather limit
# (graphite_tpu/ops/pallas/pcg_mf.py, segmv.py). Neither is a limit of K6,
# which reads J' and the vectors from global memory (staging into shared
# memory what fits); its own limits are N = n * d <= 1024 chunks of 1024
# and the shared memory of its chunk sums and block descriptors, which the
# launch checks. The gate is kept so that the port takes the JAX package's
# branch at every size, and tests lower it (ROADMAP Next: replace it with
# K6's own feasibility). It counts the table at 4 bytes an entry, as the
# JAX package reckons its VMEM, in both dtypes: a float64 problem passes
# it exactly when its float32 twin does.
J_BYTES_LIMIT = 6 << 20
TABLE_ROWS_LIMIT = 4096
TB = 512  # row-table padding
CF = 2048  # factor chunk of the padded J

CHUNK = 1024  # vector entries of a dot chunk; a CTA owns whole chunks
MAX_CLUSTER = 16
THREADS = 512  # a CTA's threads (csrc/pcg_mf.cu kThreads)
THREADS_F64 = 256  # the float64 design's (kThreads64)

_P, _I, _F, _D = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                  ctypes.c_double)
_SIGNATURES = {
    # jf, rows, desc, nb, csr_off, inc_j, inc_e, b, damp, minv, work, x,
    # iters, n, d, max_iter, tol, rejection_ratio, cluster, stage_j,
    # stream
    "gt_pcg_mf_f32": [_P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                      _I, _I, _I, _F, _F, _I, _I, _P],
    # jf, jf_f32, rows, desc, nb, csr_off, inc_j, inc_e, b, damp, minv,
    # minv_f32, work, x, iters, n, d, max_iter, tol, rejection_ratio,
    # cluster, stage_j, nr_max, ninc_max, amax, emax, stream
    "gt_pcg_mf_f64": [_P, _I, _P, _P, _I, _P, _P, _P, _P, _P, _P, _I, _P,
                      _P, _P, _I, _I, _I, _D, _D, _I, _I, _I, _I, _I, _I,
                      _P],
    # f64, jf_f32, minv_f32, design64, d, out (4 ints)
    "gt_pcg_mf_instance": [_I] * 5 + [_P],
    # n, d, nb, cluster, nr_max, ninc_max, amax, emax
    "gt_pcg_mf_design64": [_I] * 8,
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
    csr_host: np.ndarray  # (n + 1,) int64: csr_off on the host


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
        inc_e=i32(np.concatenate(inc_e)[order]), chol=chol,
        csr_host=csr_off.astype(np.int64))


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
    """K6's global scratch, in entries of the vectors' dtype (4-byte words
    of the float32 instance, 8-byte of the float64 one): eight vectors of
    n * d (used where they do not fit in shared memory), and per incidence
    its gathered p (largest arity x d) and its J' p (largest E)."""
    amax = max(blk.arity for blk in site.blocks)
    emax = max(blk.E for blk in site.blocks)
    return (8 * site.n * site.d
            + int(site.inc_j.numel()) * (amax * site.d + emax))


def cta_shape(site: PcgMfSite, cluster: int) -> Tuple[int, int]:
    """The most rows and incidences one of ``cluster`` CTAs owns, as the
    kernel splits the chunks (a row across two CTAs' chunks is both's):
    what the float64 design's shared memory is sized by."""
    N = site.n * site.d
    nch = -(-N // CHUNK)
    per = -(-nch // cluster)
    ch0 = np.minimum(np.arange(cluster) * per, nch)
    e0 = np.minimum(ch0 * CHUNK, N)
    e1 = np.minimum(e0 + np.minimum(per, nch - ch0) * CHUNK, N)
    row0, row1 = e0 // site.d, -(-e1 // site.d)
    return (int((row1 - row0).max()),
            int((site.csr_host[row1] - site.csr_host[row0]).max()))


def _f64_shape(site: PcgMfSite, cluster: int) -> Tuple[int, ...]:
    """The float64 instance's shape arguments: ``cta_shape`` and the
    largest arity and E."""
    return (*cta_shape(site, cluster),
            max(blk.arity for blk in site.blocks),
            max(blk.E for blk in site.blocks))


def takes_design64(site: PcgMfSite, cluster: Optional[int] = None) -> bool:
    """Whether a float64 solve of ``site`` on ``cluster`` CTAs (the
    wrapper's rule by default) runs the float64 design (its pieces fit in
    a CTA's shared memory), not the float32 design in double."""
    if cluster is None:
        cluster = cluster_size(site.n * site.d)
    return bool(load_kernel().lib.gt_pcg_mf_design64(
        site.n, site.d, len(site.blocks), cluster,
        *_f64_shape(site, cluster)))


def instance(f64: bool, jf_dtype: torch.dtype = torch.float32,
             minv_dtype: Optional[torch.dtype] = None,
             design64: bool = True, d: int = 6) -> dict:
    """The K6 instance a solve launches, as the card reports it:
    ``registers`` and ``local_bytes`` (spills and stack) a thread,
    ``ctas_per_sm`` resident at the launch's shared memory, ``threads``.
    ``f64`` False: the float32 instance; else the float64 one of the J'
    and inverse-block dtypes, its own design (``design64``) at vertex dim
    ``d`` or the float32 design in double."""
    lib = load_kernel()
    out = (ctypes.c_int * 4)()
    lib.check(lib.lib.gt_pcg_mf_instance(
        int(f64), int(jf_dtype == torch.float32),
        int(minv_dtype == torch.float32), int(design64), d,
        ctypes.addressof(out)), "pcg_mf instance")
    return dict(registers=out[0], local_bytes=out[1], ctas_per_sm=out[2],
                threads=out[3])


# the dtypes each instance takes: vectors -> {J': inverse blocks}, as the
# policies give them (float64 J' comes with float64 blocks only)
_INSTANCES = {
    torch.float32: {torch.float32: (torch.float32,)},
    torch.float64: {torch.float64: (torch.float64,),
                    torch.float32: (torch.float32, torch.float64)},
}


def solve_pcg_mf(site: PcgMfSite, jf: torch.Tensor, b: torch.Tensor,
                 damp: torch.Tensor, minv: Optional[torch.Tensor], *,
                 max_iter: int, tol: float, rejection_ratio: float,
                 cluster: Optional[int] = None):
    """Solve on the site's rows: ``jf`` from ``fold_jacobians``; ``b`` and
    ``damp`` (n * d,); ``minv`` (n, d * d) row-major inverse blocks or None
    (identity). Returns (x, iterations). ``cluster``: K6's CTAs (1-16),
    ``cluster_size(n * d)`` by default; it changes no bits. On the card
    the vectors' dtype picks the instance (see the module docstring); any
    other dtype raises."""
    if b.device.type == "cpu":
        return solve_pcg_mf_plain(site, jf, b, damp, minv, max_iter=max_iter,
                                  tol=tol, rejection_ratio=rejection_ratio)
    if b.device.type != "cuda":
        raise NotImplementedError(f"no kernel for device {b.device}")
    f64 = b.dtype == torch.float64
    stats = STATS_F64 if f64 else STATS
    if b.dtype not in _INSTANCES:
        raise NotImplementedError(
            f"{stats.name}: no kernel for {b.dtype} vectors")
    j_dtypes = _INSTANCES[b.dtype]
    n, d = site.n, site.d
    shapes = [("jf", jf, (site.n_j,), tuple(j_dtypes)),
              ("b", b, (n * d,), (b.dtype,)),
              ("damp", damp, (n * d,), (b.dtype,))]
    if minv is not None:
        shapes.append(("minv", minv, (n, d * d),
                       j_dtypes.get(jf.dtype, ())))
    for name, t, shape, dtypes in shapes:
        if t.dtype not in dtypes:
            raise NotImplementedError(
                f"{stats.name}: {name} is {t.dtype}; the kernel takes "
                f"{', '.join(map(str, dtypes))} with {b.dtype} vectors")
        if t.device != b.device or tuple(t.shape) != shape:
            raise ValueError(f"{stats.name}: {name} must be {shape} on "
                             f"{b.device}, got {tuple(t.shape)} on "
                             f"{t.device}")
    if site.rows.device != b.device:
        raise ValueError(f"{stats.name}: site and b on different devices")
    cluster = cluster_size(n * d) if cluster is None else cluster
    if not 0 < cluster <= MAX_CLUSTER:
        raise ValueError(f"{stats.name}: cluster = {cluster} outside "
                         f"(0, {MAX_CLUSTER}]")
    jf, b, damp = jf.contiguous(), b.contiguous(), damp.contiguous()
    minv = None if minv is None else minv.contiguous()
    work = torch.empty(work_floats(site), dtype=b.dtype, device=b.device)
    x = torch.empty(n * d, dtype=b.dtype, device=b.device)
    iters = torch.empty(1, dtype=torch.int32, device=b.device)
    minv_ptr = None if minv is None else minv.data_ptr()
    structure = (site.rows.data_ptr(), site.desc.data_ptr(),
                 len(site.blocks), site.csr_off.data_ptr(),
                 site.inc_j.data_ptr(), site.inc_e.data_ptr(),
                 b.data_ptr(), damp.data_ptr())
    lib = load_kernel()
    with on_device(b.device):
        stream = stream_ptr(b.device)
        ev = stats.start()
        if f64:
            err = lib.lib.gt_pcg_mf_f64(
                jf.data_ptr(), int(jf.dtype == torch.float32), *structure,
                minv_ptr, int(minv is not None
                              and minv.dtype == torch.float32),
                work.data_ptr(), x.data_ptr(), iters.data_ptr(), n, d,
                int(max_iter), float(tol), float(rejection_ratio), cluster,
                1, *_f64_shape(site, cluster), stream)
        else:
            err = lib.lib.gt_pcg_mf_f32(
                jf.data_ptr(), *structure, minv_ptr, work.data_ptr(),
                x.data_ptr(), iters.data_ptr(), n, d, int(max_iter),
                float(tol), float(rejection_ratio), cluster, 1, stream)
        lib.check(err, stats.name)
        stats.done(ev)
    return x, iters[0]
