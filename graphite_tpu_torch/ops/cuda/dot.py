"""The PCG's inner products in one launch each: kernel K9
(``csrc/dot.cu``).

No ``pl.pallas_call`` of the JAX package computes them: there each CG dot
is ``jnp.dot`` (``graphite_tpu/ops/pcg_loop.py``), which XLA reduces in
one fusion. The port sums every dot in one fixed order,
``pcg_loop.tree_sum`` over the products, so that the card and the CPU take
the same CG steps; K9 takes that order in one launch, where the plain
PyTorch version (``pcg_loop.tree_dot_plain``) takes 22 at n = 16,002.

``tree_dot(u, v)`` takes the plain version for CPU tensors only; on CUDA
tensors it launches K9 (float32 or float64, both of one dtype) or raises.
It returns a 0-d tensor on the operands' device and reads nothing back to
the host, so it runs inside a captured CUDA graph. Float32 launches count
in ``STATS``, float64 ones in ``STATS_F64``.
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .launches import LaunchStats, on_device, stream_ptr

STATS = LaunchStats("dot.tree_dot")
# float64 launches apart (as K1's ``segsum.STATS_F64``): a float64 path
# launches no float32 kernel
STATS_F64 = LaunchStats("dot.tree_dot[f64]")

CHUNK = 1024  # entries of a chunk: tree_sum's first two levels
ONE_CTA_CHUNKS = 32  # up to 32 chunks (32,768 entries) one CTA, no scratch
_DTYPES = {torch.float32: "f32", torch.float64: "f64"}

_P, _L = ctypes.c_void_p, ctypes.c_longlong
_SIGNATURES = {
    # u, v, n, stride of u, stride of v, out, scratch, stream
    f"gt_tree_dot_{s}": [_P, _P, _L, _L, _L, _P, _P, _P]
    for s in _DTYPES.values()
}


def load_kernel() -> build.KernelLibrary:
    """Build K9 (at first use) and load it."""
    return build.load_library("dot", _SIGNATURES)


def tree_dot(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """u . v (1-D, one dtype): the products summed in ``tree_sum``'s order,
    as a 0-d tensor."""
    if u.device.type == "cpu":
        from ..pcg_loop import tree_dot_plain

        return tree_dot_plain(u, v)
    stats = STATS_F64 if u.dtype == torch.float64 else STATS
    name = stats.name
    if u.device.type != "cuda":
        raise NotImplementedError(f"{name}: no kernel for device {u.device}")
    if u.dtype not in _DTYPES or v.dtype != u.dtype:
        raise NotImplementedError(
            f"{name}: the kernel takes two float32 or two float64 vectors, "
            f"got {u.dtype} and {v.dtype}")
    if u.dim() != 1 or v.shape != u.shape or v.device != u.device:
        raise ValueError(
            f"{name}: u and v must be 1-D of one shape on one device, got "
            f"{tuple(u.shape)} on {u.device} and {tuple(v.shape)} on "
            f"{v.device}")
    n = u.shape[0]
    if n == 0:
        raise ValueError(f"{name}: empty vectors")
    out = torch.empty((), dtype=u.dtype, device=u.device)
    chunks = -(-n // CHUNK)
    scratch = (torch.empty(chunks, dtype=u.dtype, device=u.device)
               if chunks > ONE_CTA_CHUNKS else None)
    lib = load_kernel()
    with on_device(u.device):
        ev = stats.start()
        err = getattr(lib.lib, f"gt_tree_dot_{_DTYPES[u.dtype]}")(
            u.data_ptr(), v.data_ptr(), n, u.stride(0), v.stride(0),
            out.data_ptr(), None if scratch is None else scratch.data_ptr(),
            stream_ptr(u.device))
        lib.check(err, name)
        stats.done(ev)
    return out
