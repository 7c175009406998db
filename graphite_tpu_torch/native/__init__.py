"""Host libraries of the port in C++, built with g++ and loaded with ctypes.

Each ``native/<name>.cpp`` has a plain C interface. It is compiled at
first use (nothing is built when a module is imported) into
``build/graphite_tpu_torch/`` next to the package, the directory of the
CUDA kernels (``ops/cuda/build.py``). The library's file name holds a
hash of its source, the flags and the compiler's identity, so an edited
source is rebuilt and a library built by another compiler is never
loaded; the flags name no host CPU (no ``-march=native``), so a build
directory shared by two hosts holds nothing that only one of them runs.
A build is written to a temporary file and renamed into place, so
processes that build at once do not collide. A failed build raises with
g++'s output: the port has no NumPy fallback on its main path (each entry
point's plain NumPy version lives beside it in ``hostops``, for tests).
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import platform
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

from ..ops.cuda.build import BUILD_DIR

NATIVE_DIR = Path(__file__).resolve().parent
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")


@dataclasses.dataclass
class HostLibrary:
    name: str
    lib: ctypes.CDLL
    path: Path
    build_seconds: float  # 0.0 when an up-to-date library was reused


_LOADED: Dict[str, HostLibrary] = {}
_LOCK = threading.Lock()


def gxx_path() -> str:
    found = shutil.which("g++")
    if not found:
        raise RuntimeError(
            "g++ not found on PATH: it is needed to build "
            "graphite_tpu_torch's host libraries (native/*.cpp)")
    return found


def load_library(name: str) -> HostLibrary:
    """Build (if needed) and load ``native/<name>.cpp``; the caller
    declares each entry point's ctypes types."""
    with _LOCK:
        if name in _LOADED:
            return _LOADED[name]
        src = NATIVE_DIR / f"{name}.cpp"
        gxx = gxx_path()
        version = subprocess.run([gxx, "--version"], capture_output=True,
                                 text=True, check=True).stdout
        digest = hashlib.sha256(b"\0".join([
            src.read_bytes(), " ".join(GXX_FLAGS).encode(),
            version.encode(), platform.machine().encode()])).hexdigest()[:16]
        out = BUILD_DIR / f"lib{name}-{digest}.so"
        seconds = 0.0
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            t0 = time.perf_counter()
            proc = subprocess.run([gxx, *GXX_FLAGS, "-o", str(tmp), str(src)],
                                  capture_output=True, text=True)
            seconds = time.perf_counter() - t0
            if proc.returncode != 0:
                raise RuntimeError(
                    f"g++ failed on {src}:\n{proc.stdout}{proc.stderr}")
            os.replace(tmp, out)
        built = HostLibrary(name, ctypes.CDLL(str(out)), out, seconds)
        _LOADED[name] = built
        return built
