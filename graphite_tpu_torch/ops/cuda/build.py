"""Build and load the package's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled with nvcc into a shared library with a
plain C interface, at first use, under ``build/graphite_tpu_torch/`` next
to the package, and loaded with ``ctypes``. The library's file name holds
a hash of its source, the shared headers (``csrc/*.cuh``) and the flags,
so an edited source or header is rebuilt and a stale library is never
loaded. Nothing is built when a module is
imported: the wrappers call ``load_library`` right before their first
launch.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Sequence

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "graphite_tpu_torch"

# -fmad=false: no multiply-add contraction, so every product and sum is
# rounded on its own, as the plain PyTorch versions round them (and
# division / sqrt stay IEEE: no fast math).
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


@dataclasses.dataclass
class KernelLibrary:
    name: str
    lib: ctypes.CDLL
    path: Path
    build_seconds: float  # 0.0 when an up-to-date library was reused
    log: str  # nvcc's output (register / shared-memory use per kernel)

    def check(self, err: int, what: str) -> None:
        """Raise if a C entry point returned a CUDA error code."""
        if err != 0:
            msg = getattr(self.lib, f"gt_{self.name}_error_string")(err)
            raise RuntimeError(
                f"{what}: CUDA error {err} ({msg.decode()})")


_LOADED: Dict[str, KernelLibrary] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME): the CUDA toolkit is needed to "
        "build graphite_tpu_torch's kernels")


def load_library(name: str,
                 signatures: Dict[str, Sequence]) -> KernelLibrary:
    """Build (if needed) and load ``csrc/<name>.cu``; ``signatures`` maps
    each C entry point to its ctypes argtypes (all return an int error
    code)."""
    if name in _LOADED:
        return _LOADED[name]
    src = CSRC_DIR / f"{name}.cu"
    # the source, every header it may include and the flags
    headers = b"".join(h.read_bytes()
                       for h in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(
        src.read_bytes() + headers
        + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"lib{name}-{digest}.so"
    seconds, log = 0.0, ""
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{log}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    for fn_name, argtypes in signatures.items():
        fn = getattr(lib, fn_name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    err_fn = getattr(lib, f"gt_{name}_error_string")
    err_fn.argtypes = [ctypes.c_int]
    err_fn.restype = ctypes.c_char_p
    built = KernelLibrary(name, lib, out, seconds, log)
    _LOADED[name] = built
    return built
