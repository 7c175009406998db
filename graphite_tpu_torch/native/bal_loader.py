"""ctypes wrapper of ``native/bal_loader.cpp``, the BAL text parser."""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np

from . import load_library

_I64P = ctypes.POINTER(ctypes.c_int64)
_I32P = ctypes.POINTER(ctypes.c_int32)
_F64P = ctypes.POINTER(ctypes.c_double)


def library():
    """The built library (``HostLibrary``), its entry points typed."""
    built = load_library("bal_loader")
    lib = built.lib
    if not hasattr(lib, "_gx_typed"):
        lib.bal_header.argtypes = [ctypes.c_char_p, _I64P, _I64P, _I64P]
        lib.bal_header.restype = ctypes.c_int
        lib.bal_parse.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            _I32P, _I32P, _F64P, _F64P, _F64P]
        lib.bal_parse.restype = ctypes.c_int
        lib._gx_typed = True
    return built


def load(path: str) -> Optional[Tuple[np.ndarray, ...]]:
    """Parse an uncompressed BAL file: (cameras, points, cam_idx,
    point_idx, observations), or None where the parser does not take the
    file (compressed, unreadable or malformed): the caller then takes the
    NumPy parser."""
    if str(path).endswith((".gz", ".bz2")):
        return None
    lib = library().lib
    enc = str(path).encode()
    counts = [ctypes.c_int64() for _ in range(3)]
    if lib.bal_header(enc, *(ctypes.byref(c) for c in counts)) != 0:
        return None
    n_cam, n_pt, n_obs = (c.value for c in counts)
    if min(n_cam, n_pt, n_obs) < 0:
        return None
    cam_idx = np.empty(n_obs, dtype=np.int32)
    pt_idx = np.empty(n_obs, dtype=np.int32)
    obs = np.empty((n_obs, 2), dtype=np.float64)
    cams = np.empty((n_cam, 9), dtype=np.float64)
    pts = np.empty((n_pt, 3), dtype=np.float64)
    if lib.bal_parse(enc, n_cam, n_pt, n_obs,
                     cam_idx.ctypes.data_as(_I32P),
                     pt_idx.ctypes.data_as(_I32P),
                     obs.ctypes.data_as(_F64P), cams.ctypes.data_as(_F64P),
                     pts.ctypes.data_as(_F64P)) != 0:
        return None
    return (cams, pts, cam_idx.astype(np.int64), pt_idx.astype(np.int64),
            obs)
