"""Robust losses (counterpart of ``graphite_tpu/loss.py``).

A loss acts on the squared error ``x = r^T P r`` of each factor; its
derivative ``dL = loss'(x)`` re-weights the factor's H / b contributions.
``params`` is the per-factor loss parameter tensor.
"""

from __future__ import annotations

import dataclasses

import torch

from .precision import sqrt_rn


@dataclasses.dataclass(frozen=True)
class Loss:
    """Base loss: identity."""

    name: str = "default"

    def value(self, x, params):
        return x

    def derivative(self, x, params):
        return torch.ones_like(x)

    def default_param(self) -> float:
        return 0.0


@dataclasses.dataclass(frozen=True)
class DefaultLoss(Loss):
    name: str = "default"


@dataclasses.dataclass(frozen=True)
class HuberLoss(Loss):
    """Huber on the squared error.

    ``loss(x)  = x                        if x <= delta^2
                 2*delta*sqrt(x)-delta^2  otherwise``
    ``loss'(x) = 1                        if x <= delta^2
                 delta/sqrt(x)            otherwise``
    """

    name: str = "huber"

    def value(self, x, params):
        d2 = params * params
        # guard sqrt at x == 0 / delta == 0 (only reachable on unused lanes)
        safe = sqrt_rn(torch.maximum(x, d2.clamp_min(1e-30)))
        return torch.where(x <= d2, x, 2.0 * safe * params - d2)

    def derivative(self, x, params):
        d2 = params * params
        safe = sqrt_rn(torch.maximum(x, d2.clamp_min(1e-30)))
        return torch.where(x <= d2, torch.ones_like(x), params / safe)

    def default_param(self) -> float:
        return 100.0


@dataclasses.dataclass(frozen=True)
class CauchyLoss(Loss):
    """``loss(x) = c^2 * log(1 + x / c^2)``."""

    name: str = "cauchy"

    def value(self, x, params):
        c2 = params * params
        return c2 * torch.log1p(x / c2)

    def derivative(self, x, params):
        c2 = params * params
        return 1.0 / (1.0 + x / c2)

    def default_param(self) -> float:
        return 1.0


DEFAULT_LOSS = DefaultLoss()
