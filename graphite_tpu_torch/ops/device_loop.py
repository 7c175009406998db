"""The device-controlled LM iteration: its switch, and the host calls and
CUDA-graph capture it is built from.

``levenberg_marquardt(jit_loop=True)`` runs every iteration with no host
read (``optimizers/lm.py``). While it does, ``active()`` is true, and the
code it runs takes the forms that need no host read: the PCG solvers take
``run_pcg_fixed`` instead of ``run_pcg``, and a solve on the host goes
through ``host_call``.

On a CUDA problem the iteration is captured (``Capture``) and replayed.
A host call splits the capture: the graph before it, the call (its
device inputs copied to the host after a synchronize, its outputs copied
back into static device buffers), then the graph after it. A replay
runs the pieces in order, so such an iteration holds one host sync, at
the host solve, and no other.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

# (active, the Capture recording the iteration or None), per thread
_STATE = contextvars.ContextVar("device_loop", default=(False, None))


def active() -> bool:
    """True inside the device-controlled LM iteration."""
    return _STATE.get()[0]


@contextlib.contextmanager
def enabled(capture: Optional["Capture"] = None):
    """Run the enclosed code as the device-controlled iteration
    (recorded by ``capture`` when one is given)."""
    token = _STATE.set((True, capture))
    try:
        yield
    finally:
        _STATE.reset(token)


def host_call(fn: Callable, inputs: Sequence[torch.Tensor],
              outputs: Sequence[tuple], device) -> List[torch.Tensor]:
    """``fn(*arrays) -> tuple of arrays`` on the host, from device tensors
    to device tensors; ``outputs`` gives each output's (shape, dtype) on
    the device. Outside a capture this copies, calls and copies back at
    once; inside one it records the call as a piece of the captured
    iteration (see the module docstring)."""
    cap = _STATE.get()[1]
    if cap is None:
        outs = fn(*[t.detach().cpu().numpy() for t in inputs])
        return [torch.as_tensor(np.asarray(o)).to(device=device, dtype=dt)
                .reshape(shape) for o, (shape, dt) in zip(outs, outputs)]
    return cap.host_call(fn, inputs, outputs, device)


@dataclasses.dataclass
class _HostCall:
    fn: Callable
    inputs: List[torch.Tensor]  # written by the graph before the call
    outputs: List[torch.Tensor]  # static buffers the graph after it reads

    def replay(self) -> None:
        outs = self.fn(*[t.cpu().numpy() for t in self.inputs])
        for buf, o in zip(self.outputs, outs):
            buf.copy_(torch.as_tensor(np.asarray(o)).reshape(buf.shape))


class Capture:
    """An iteration captured as CUDA graphs on one private memory pool,
    split at each host call. ``record(fn)`` captures ``fn()`` (run once,
    at capture time, on a side stream); ``replay()`` runs the pieces on
    the current stream. A capture that fails raises."""

    def __init__(self, device: torch.device):
        self.device = device
        self.pieces: list = []
        self.pool = None
        self._graph = None

    @property
    def host_calls(self) -> int:
        return sum(isinstance(p, _HostCall) for p in self.pieces)

    def _begin(self) -> None:
        graph = torch.cuda.CUDAGraph()
        graph.capture_begin(pool=self.pool)
        self._graph = graph

    def _end(self) -> None:
        graph, self._graph = self._graph, None
        graph.capture_end()
        if self.pool is None:  # the later pieces share the first's pool
            self.pool = graph.pool()
        self.pieces.append(graph)

    def record(self, fn: Callable):
        torch.cuda.synchronize(self.device)
        stream = torch.cuda.Stream(self.device)
        stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.device(self.device), torch.cuda.stream(stream):
            self._begin()
            try:
                with enabled(self):
                    out = fn()
            except BaseException:
                if self._graph is not None:  # leave the stream uncaptured
                    graph, self._graph = self._graph, None
                    try:
                        graph.capture_end()
                    except RuntimeError:
                        pass
                raise
            self._end()
        torch.cuda.current_stream(self.device).wait_stream(stream)
        torch.cuda.synchronize(self.device)
        return out

    def host_call(self, fn, inputs, outputs, device):
        """Ends the graph so far, records the call with zero-filled static
        output buffers, and begins the next graph."""
        self._end()
        bufs = [torch.zeros(shape, dtype=dt, device=device)
                for shape, dt in outputs]
        self.pieces.append(_HostCall(fn, [t.detach() for t in inputs], bufs))
        self._begin()
        return bufs

    def replay(self) -> None:
        for piece in self.pieces:
            if isinstance(piece, _HostCall):
                torch.cuda.current_stream(self.device).synchronize()
            piece.replay()
