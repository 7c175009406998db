"""Parameter dictionaries between NumPy and this package's tensors.

The tests carry the JAX package's parameters into this package through
NumPy arrays, so both compute on exactly the same inputs.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def params_from_numpy(params: Dict[str, np.ndarray], device=None,
                      dtype: torch.dtype = None) -> Dict[str, torch.Tensor]:
    """name -> (V, ambient_dim) arrays to (copied) tensors on ``device``."""
    return {name: torch.tensor(np.asarray(a), dtype=dtype, device=device)
            for name, a in params.items()}


def params_to_numpy(params: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """name -> tensor to NumPy arrays on the host."""
    return {name: t.detach().cpu().numpy() for name, t in params.items()}
