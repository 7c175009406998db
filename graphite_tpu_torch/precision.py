"""Precision policies (counterpart of ``graphite_tpu/precision.py``).

- ``graph_dtype``: vertex state, residuals, ``b``, ``delta_x``.
- ``solver_dtype``: Jacobian / Hessian-block storage.
- ``inv_dtype``: small block inversions and diagonal accumulation; never a
  low-precision type (equals ``graph_dtype`` when ``solver_dtype`` is one).

FP64_FP64 is what the CPU parity tests against the JAX package use;
FP32_FP32 is the GPU main path.
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
    GPU agree."""
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

    @property
    def acc_dtype(self) -> torch.dtype:
        """Accumulation dtype of block contractions (>= float32)."""
        if self.graph_dtype == torch.float64:
            return torch.float64
        return torch.float32


FP64_FP64 = Precision(torch.float64, torch.float64)
FP32_FP32 = Precision(torch.float32, torch.float32)
