"""Parameter checkpoints (counterpart of ``graphite_tpu/io/checkpoint.py``).

``save`` writes the parameters (and any extra optimizer state) as a
compressed ``.npz`` with the JAX package's keys (``param:<name>``,
``extra:<name>``), so a checkpoint written by either package loads in the
other. ``load`` puts the parameters on the CUDA card unless the caller
asks for another device.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..interop import params_from_numpy, params_to_numpy


def _host(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def save(path: str, params: Dict[str, torch.Tensor], **extra) -> None:
    arrays = {f"param:{k}": v for k, v in params_to_numpy(params).items()}
    for k, v in extra.items():
        arrays[f"extra:{k}"] = _host(v)
    np.savez_compressed(path, **arrays)


def load(path: str, dtype: torch.dtype = None, device=None):
    """(params dict of tensors on ``device`` (default: the CUDA card) in
    ``dtype`` (default: as stored), extras dict of NumPy arrays)."""
    params, extra = {}, {}
    with np.load(path) as data:
        for k in data.files:
            kind, name = k.split(":", 1)
            if kind == "param":
                params[name] = data[k]
            else:
                extra[name] = data[k]
    device = torch.device("cuda") if device is None else device
    return params_from_numpy(params, device=device, dtype=dtype), extra
