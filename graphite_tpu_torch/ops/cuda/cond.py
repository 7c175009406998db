"""Conditional regions of a CUDA graph capture (``csrc/cond.cu``): the
device-side branch and loop that ``ops/device_loop.Capture.region``
records.

PyTorch's ``torch.cuda.CUDAGraph`` exposes no conditional nodes, so the
node is added here, through a plain C library built and loaded like the
kernels (``build.load_library``). ``begin`` is called while ``parent`` is
capturing: it captures the one-thread kernel that copies the 0-d bool
``pred`` into the node's handle at replay time, adds the "if" node, and
starts capturing ``body`` into the node's body graph; ``end`` ends that
capture. What runs on ``body`` in between is the region: a replay runs it
once if ``pred`` is true (an "if" node) or, for a loop (a "while" node),
while the handle is true, the body ending with ``set_handle`` on the
loop's next predicate.

Its plain version is ``if bool(pred): body()`` / ``while bool(pred):
body()`` (``device_loop.cond`` / ``while_loop`` on a CPU problem). The
node needs CUDA 12.4 or later, in the toolkit that builds the library and
in the driver; where either is older, ``begin`` raises: there is no path
that captures a region unconditionally.
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .launches import LaunchStats

STATS = LaunchStats("cond.set_conditional")

_SIGNATURES = {
    "gt_cond_stream_create": [ctypes.POINTER(ctypes.c_void_p)],
    "gt_cond_begin": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                      ctypes.c_int, ctypes.POINTER(ctypes.c_void_p),
                      ctypes.POINTER(ctypes.c_ulonglong)],
    "gt_cond_set_handle": [ctypes.c_void_p, ctypes.c_ulonglong,
                           ctypes.c_void_p],
    "gt_cond_end": [ctypes.c_void_p],
    "gt_cond_check": [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)],
}


def load_kernel() -> build.KernelLibrary:
    """Build the library (at first use) and load it."""
    return build.load_library("cond", _SIGNATURES)


def new_stream(device: torch.device) -> torch.cuda.ExternalStream:
    """A stream of the library's own for a region's body (created with
    this thread's capture mode relaxed, so it may be made mid-capture);
    it lives as long as the process."""
    lib = load_kernel()
    ptr = ctypes.c_void_p()
    lib.check(lib.lib.gt_cond_stream_create(ctypes.byref(ptr)),
              "cond: stream create")
    return torch.cuda.ExternalStream(ptr.value, device=device)


def _check_pred(pred: torch.Tensor) -> None:
    if (pred.dtype != torch.bool or pred.dim() != 0
            or pred.device.type != "cuda"):
        raise ValueError("cond: the predicate must be a 0-d bool CUDA tensor,"
                         f" not {pred.dtype}{tuple(pred.shape)} on "
                         f"{pred.device}")


def begin(parent: int, pred: torch.Tensor, body: int,
          loop: bool = False) -> tuple:
    """Open a region on ``pred`` (a loop: while the handle is true) in the
    capture of stream ``parent``; what stream ``body`` captures next is its
    body. Returns (the body graph, a ``cudaGraph_t`` owned by the node;
    the node's handle)."""
    _check_pred(pred)
    lib = load_kernel()
    graph, handle = ctypes.c_void_p(), ctypes.c_ulonglong()
    lib.check(lib.lib.gt_cond_begin(parent, pred.data_ptr(), body, int(loop),
                                    ctypes.byref(graph),
                                    ctypes.byref(handle)),
              "cond: conditional node")
    STATS.launches += 1
    return graph.value, handle.value


def set_handle(stream: int, handle: int, pred: torch.Tensor) -> None:
    """Capture, on ``stream``, the setting of ``handle`` from ``pred``: a
    loop body's last node, which decides whether the body runs again."""
    _check_pred(pred)
    lib = load_kernel()
    lib.check(lib.lib.gt_cond_set_handle(stream, handle, pred.data_ptr()),
              "cond: the loop's next predicate")
    STATS.launches += 1


# cudaGraphNodeType and cudaMemoryType names, for end()'s refusal
_NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host",
               4: "child graph", 5: "empty", 6: "event wait",
               7: "event record", 8: "semaphore signal",
               9: "semaphore wait", 10: "memory alloc", 11: "memory free",
               12: "batch memop", 13: "conditional"}
_MEMORY = {-1: "none", 0: "unregistered host", 1: "host", 2: "device",
           3: "managed"}


def end(body: int, body_graph: int, name: str = "region") -> None:
    """Close the region whose body stream ``body`` is capturing into
    ``body_graph``; raises if the body holds a node that a conditional body
    cannot (the graph would not instantiate)."""
    lib = load_kernel()
    lib.check(lib.lib.gt_cond_end(body), "cond: end of the body's capture")
    refused = (ctypes.c_int * 3)()
    lib.check(lib.lib.gt_cond_check(body_graph, refused),
              "cond: the check of the region's body")
    if refused[0] >= 0:
        raise RuntimeError(
            f"cond: region {name!r} holds a "
            f"{_NODE_TYPES.get(refused[0], refused[0])} node (source "
            f"{_MEMORY.get(refused[1])}, destination "
            f"{_MEMORY.get(refused[2])} memory), which a conditional graph "
            "body cannot hold")
