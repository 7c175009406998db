"""Precision policies (counterpart of ``graphite_tpu/precision.py``).

- ``graph_dtype``: vertex state, residuals, ``b``, ``delta_x``.
- ``solver_dtype``: Jacobian / Hessian-block storage.
- ``inv_dtype``: small block inversions and diagonal accumulation; never a
  low-precision type (equals ``graph_dtype`` when ``solver_dtype`` is one).

The six policies are the JAX package's: FP64_FP64, FP64_FP32, FP64_BF16,
FP32_FP32, FP32_BF16 and FP32_FP16. Hessian and Schur values live in
``inv_dtype``, so a bf16 or fp16 value never reaches a kernel but as a
stored Jacobian: K1 and the Schur stage's kernels (K3, K4, K5, K10,
K13) have float32 and float64 instances; K7 (the BAL factor's
linearize, chi2 and Hessian sums) and K11 (the SE3 pose-graph factors'
linearize, chi2 and update) have an instance per graph dtype, each
taking the J stored in float32, bf16 or fp16, or float64 in a float64
graph; K6 (the matrix-free PCG) has one per vector dtype, the float64
one reading a float64 (FP64_FP64) or float32 (FP64_FP32, FP64_BF16)
fold; K2 takes float32 only. The JAX package's
``stream_dtype`` (bf16 gather transport) and ``matmul_precision`` are TPU
levers and are not ported: every transport is in the site's own dtype and
TF32 stays off.
"""

from __future__ import annotations

import dataclasses

import torch

_LOW_PRECISION = (torch.bfloat16, torch.float16)

# fp16 values are clamped to the finite range when Jacobians are stored in
# half precision.
FP16_MAX = 65504.0


def is_low_precision(dtype: torch.dtype) -> bool:
    return dtype in _LOW_PRECISION


def clamp_to_storage(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Cast ``x`` to a (possibly low-precision) storage dtype, clamping to
    +-65504 first for fp16 (bf16 has fp32-like range)."""
    if dtype == torch.float16:
        x = x.clamp(-FP16_MAX, FP16_MAX)
    return x.to(dtype)


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Square root correctly rounded in ``x``'s dtype on any device.

    PyTorch's float32 CUDA sqrt is an ulp off on some inputs (division and
    multiplication are exact); the float64 square root of a float32 value,
    rounded to float32, is the correctly rounded float32 result, so CPU and
    GPU agree. A float64 ``x`` takes ``torch.sqrt``, as the JAX package
    does: IEEE on the card, but PyTorch's CPU float64 sqrt is an ulp off
    on some inputs (~0.7% of random ones), so float64 runs on the two
    devices may part by an ulp there."""
    if x.dtype == torch.float64:
        return torch.sqrt(x)
    return torch.sqrt(x.to(torch.float64)).to(x.dtype)


@dataclasses.dataclass(frozen=True)
class Precision:
    """A (graph, solver) dtype pair."""

    graph_dtype: torch.dtype = torch.float32
    solver_dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if is_low_precision(self.graph_dtype):
            raise ValueError("graph_dtype must be float32 or float64")

    @property
    def inv_dtype(self) -> torch.dtype:
        """Dtype of block inversions and Hessian/Schur values."""
        if is_low_precision(self.solver_dtype):
            return self.graph_dtype
        return self.solver_dtype

    @staticmethod
    def from_names(graph: str, solver: str) -> "Precision":
        """The policy named by two dtype names (``fp64``, ``fp32``,
        ``bf16``, ``fp16`` or their ``float64`` / ``float32`` /
        ``bfloat16`` / ``float16`` spellings); a low-precision graph dtype
        raises ``ValueError``, as in the JAX package."""
        names = {"fp64": torch.float64, "float64": torch.float64,
                 "fp32": torch.float32, "float32": torch.float32,
                 "bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
                 "fp16": torch.float16, "float16": torch.float16}
        for name in (graph, solver):
            if name.lower() not in names:
                raise ValueError(f"unknown precision '{name}'; expected one "
                                 f"of {sorted(names)}")
        return Precision(names[graph.lower()], names[solver.lower()])

    @property
    def acc_dtype(self) -> torch.dtype:
        """Accumulation dtype of block contractions (>= float32)."""
        if self.graph_dtype == torch.float64:
            return torch.float64
        return torch.float32


FP64_FP64 = Precision(torch.float64, torch.float64)
FP64_FP32 = Precision(torch.float64, torch.float32)
FP64_BF16 = Precision(torch.float64, torch.bfloat16)
FP32_FP32 = Precision(torch.float32, torch.float32)
FP32_BF16 = Precision(torch.float32, torch.bfloat16)
FP32_FP16 = Precision(torch.float32, torch.float16)
