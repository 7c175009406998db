"""Whole block-Jacobi PCG on a dense system in one launch: kernel K2
(``csrc/pcg_dense.cu``).

Counterpart of ``graphite_tpu/ops/pallas/pcg_dense.py`` (``dense_pcg``).
Solves S x = b with the dense block-Jacobi preconditioner M; the matvecs
are row-vector products ``p @ S`` and ``y @ M`` as in the TPU kernel.
Returns ``(x, iterations)``, ``iterations`` being the number of CG steps
taken (a 0-d int tensor on the device).

CPU tensors take the plain version (``dense_pcg_plain``: ``run_pcg`` with
the kernel's order of arithmetic); CUDA tensors launch K2 (float32,
n <= 1024) or raise.

K2 runs the whole solve on one thread-block cluster of ``cluster_size(n)``
CTAs (at most 16; ``dense_pcg(..., cluster=)`` forces another size, for
tests and ``kernel_sweep``). A CTA owns whole 32-entry groups, so whole
columns of S and M and whole dot groups: every sum keeps one order, and
the bits do not depend on the cluster size (``csrc/pcg_dense.cu``).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..pcg_loop import run_pcg
from . import build
from .launches import LaunchStats, on_device, stream_ptr

STATS = LaunchStats("pcg_dense.dense_pcg")

MAX_N = 1024
MAX_CLUSTER = 16
GROUP = 32  # entries of a dot group; a CTA owns whole groups
THREADS = 1024  # a CTA's threads (csrc/pcg_dense.cu kThreads)

_SIGNATURES = {
    # S, M, b, x, iters, n, max_iter, tol, rejection_ratio, cluster, stream
    "gt_pcg_dense_f32": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                         ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                         ctypes.c_int, ctypes.c_float, ctypes.c_float,
                         ctypes.c_int, ctypes.c_void_p],
}


def load_kernel() -> build.KernelLibrary:
    """Build K2 (at first use) and load it."""
    return build.load_library("pcg_dense", _SIGNATURES)


def cluster_size(n: int) -> int:
    """K2's CTAs for n entries: one 32-entry group each where there are
    at most 16 groups (a power of two, so n = 441's 14 groups take 16,
    two of them idle), else 16."""
    groups = -(-n // GROUP)
    return min(MAX_CLUSTER, 1 << max(groups - 1, 0).bit_length())


def _row_vec_mat(vec: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """vec @ A summed over rows in order, one rounding per product and per
    add, as K2's threads do."""
    acc = torch.zeros_like(vec)
    for j in range(A.shape[0]):
        acc = acc + vec[j] * A[j]
    return acc


def dense_pcg_plain(S, M, b, *, max_iter: int, tol: float,
                    rejection_ratio: float):
    """Plain PyTorch version of K2 (the CPU path and the kernel's oracle):
    ``run_pcg`` with v = p @ S and z = y @ M, every product, sum and dot
    taken in K2's order (``run_pcg``'s dots are summed in K2's
    ``block_sum`` order), so the two agree bitwise on the same inputs."""
    x, k = run_pcg(b, lambda p: _row_vec_mat(p, S),
                   lambda y: _row_vec_mat(y, M), max_iter, tol,
                   rejection_ratio)
    return x, torch.tensor(k, device=b.device)


def dense_pcg(S: torch.Tensor, M: torch.Tensor, b: torch.Tensor, *,
              max_iter: int, tol: float, rejection_ratio: float,
              cluster: Optional[int] = None):
    """Solve S x = b (S, M: (n, n); b: (n,)); returns (x, iterations).
    ``cluster``: K2's CTAs (1-16), ``cluster_size(n)`` by default; it
    changes no bits."""
    if b.device.type == "cpu":
        return dense_pcg_plain(S, M, b, max_iter=max_iter, tol=tol,
                               rejection_ratio=rejection_ratio)
    if b.device.type != "cuda":
        raise NotImplementedError(f"no kernel for device {b.device}")
    n = b.shape[0]
    for name, t in (("S", S), ("M", M), ("b", b)):
        if t.dtype != torch.float32:
            raise NotImplementedError(
                f"{STATS.name}: the CUDA kernel takes float32, {name} is "
                f"{t.dtype}")
        if t.device != b.device:
            raise ValueError(f"{STATS.name}: {name} is on {t.device}")
    if S.shape != (n, n) or M.shape != (n, n):
        raise ValueError(f"{STATS.name}: S and M must be ({n}, {n})")
    if not 0 < n <= MAX_N:
        raise ValueError(f"{STATS.name}: n = {n} outside (0, {MAX_N}]")
    cluster = cluster_size(n) if cluster is None else cluster
    if not 0 < cluster <= MAX_CLUSTER:
        raise ValueError(f"{STATS.name}: cluster = {cluster} outside "
                         f"(0, {MAX_CLUSTER}]")
    S, M, b = S.contiguous(), M.contiguous(), b.contiguous()
    x = torch.empty(n, dtype=torch.float32, device=b.device)
    iters = torch.empty(1, dtype=torch.int32, device=b.device)
    lib = load_kernel()
    with on_device(b.device):
        stream = stream_ptr(b.device)
        ev = STATS.start()
        err = lib.lib.gt_pcg_dense_f32(
            S.data_ptr(), M.data_ptr(), b.data_ptr(), x.data_ptr(),
            iters.data_ptr(), n, int(max_iter), float(tol),
            float(rejection_ratio), cluster, stream)
        lib.check(err, STATS.name)
        STATS.done(ev)
    return x, iters[0]
