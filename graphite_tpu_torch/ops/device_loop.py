"""The device-controlled LM iteration: its switch, its conditional
regions and loops, and the host calls and CUDA-graph capture it is built
from.

``levenberg_marquardt(jit_loop=True)`` runs every iteration with no host
read (``optimizers/lm.py``). While it does, ``active()`` is true, and the
code it runs takes the forms that need no host read: the PCG solvers take
``run_pcg_fixed`` instead of ``run_pcg``, and a solve on the host goes
through ``host_call``.

``cond(pred, body)`` is the iteration's branch, the counterpart of
``jax.lax.cond`` and of a ``lax.while_loop``'s exit, for a 0-d bool
tensor ``pred``; ``while_loop(pred_fn, body)`` is ``lax.while_loop``
itself, the body run while ``pred_fn()`` is true:

- inside a capture (``Capture``) the body is captured once into a
  conditional graph node (``ops/cuda/cond.py``: an "if" node, or a
  "while" node whose body ends by setting its handle from ``pred_fn()``)
  and runs on a replay only when (while) the predicate is true on the
  device; regions nest;
- on a CPU problem it is its plain version, ``if bool(pred): body()`` /
  ``while bool(pred_fn()): body()``;
- during the eager warm-up on the card (``enabled(warmup=True)``) the
  body runs once, unconditionally, on the stream its capture will use, so
  that every host plan and every library's per-stream state it needs
  exist before the capture; the warm-up counts the regions it enters,
  which sizes the capture's run counters (``Capture.record``).

A body writes its results in place (``copy_``) into tensors that exist
before the region: a name rebound inside it is stale when it is skipped.

On a CUDA problem the iteration is captured (``Capture``) and replayed.
A host call splits the capture: the graph before it, the call (its
device inputs copied to the host after a synchronize, its outputs copied
back into static device buffers), then the graph after it. A replay
runs the pieces in order, so such an iteration holds one host sync, at
the host solve, and no other. A region cannot hold a host call: one
that is open at the call is closed before it and opened again after it,
on the same predicate, and the call reads the open regions' predicates
with its inputs and skips itself where one is false. A loop's body cannot
be split so, and a host call inside one raises.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import gc
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from .cuda import cond as cond_node
from .cuda import launches as launch_stats

# (active, the Capture recording the iteration or None, the eager
# warm-up's record or None, the warm-up's region depth), per thread
_STATE = contextvars.ContextVar("device_loop",
                                default=(False, None, None, 0))

# a region body's stream by (device index, nesting depth)
_BODY_STREAMS: Dict[tuple, torch.cuda.ExternalStream] = {}


def active() -> bool:
    """True inside the device-controlled LM iteration."""
    return _STATE.get()[0]


@dataclasses.dataclass
class WarmUp:
    """An eager warm-up's record: the regions it entered, as many as a
    capture of the same code opens."""
    regions: int = 0


@contextlib.contextmanager
def enabled(capture: Optional["Capture"] = None, warmup: bool = False):
    """Run the enclosed code as the device-controlled iteration
    (recorded by ``capture`` when one is given; with every region's body
    run once, unconditionally, when ``warmup``: then it yields the
    ``WarmUp``)."""
    warm = WarmUp() if warmup else None
    token = _STATE.set((True, capture, warm, 0))
    try:
        yield warm
    finally:
        _STATE.reset(token)


def cond(pred: torch.Tensor, body: Callable[[], None],
         name: str = "region") -> None:
    """Run ``body()`` where the 0-d bool ``pred`` is true (see the module
    docstring); ``name`` labels the region's run count in a capture."""
    _, cap, warm, depth = _STATE.get()
    if cap is not None:
        cap.region(pred, body, name)
    elif warm is not None:
        _warm_up(pred.device, warm, depth, body)
    elif bool(pred):
        body()


def while_loop(pred_fn: Callable[[], torch.Tensor], body: Callable[[], None],
               name: str = "loop") -> None:
    """Run ``body()`` while the 0-d bool ``pred_fn()`` is true (see the
    module docstring); ``name`` labels the count of the body's runs in a
    capture."""
    _, cap, warm, depth = _STATE.get()
    if cap is not None:
        cap.region(pred_fn(), body, name, again=pred_fn)
    elif warm is not None:
        _warm_up(pred_fn().device, warm, depth,
                 lambda: (body(), pred_fn()))
    else:
        while bool(pred_fn()):
            body()


def leaves(tree) -> list:
    """The tensors of a state tree (dataclasses, dicts, tuples, lists), in
    a fixed order; other leaves (None, ints) are skipped."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [t for f in dataclasses.fields(tree)
                for t in leaves(getattr(tree, f.name))]
    if isinstance(tree, dict):
        return [t for k in tree for t in leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in leaves(v)]
    return []


def copy_into(dst, src) -> None:
    """dst := src, tensor by tensor, in place (a region body writes into
    tensors made before it); a tensor of ``src`` that is ``dst``'s own,
    written in place already, is left as it is."""
    for d, s in zip(leaves(dst), leaves(src), strict=True):
        if d is not s:
            d.copy_(s)


def _body_stream(device: torch.device, depth: int):
    """The stream a region's body at ``depth`` runs on (created at first
    use; a stream captures into one graph at a time, so nested regions need
    one each)."""
    index = torch.cuda.current_device() if device.index is None else (
        device.index)
    if (index, depth) not in _BODY_STREAMS:
        _BODY_STREAMS[index, depth] = cond_node.new_stream(device)
    return _BODY_STREAMS[index, depth]


def _warm_up(device: torch.device, warm: WarmUp, depth: int,
             body: Callable) -> None:
    """``body()`` eagerly on the stream its capture will use: cuBLAS keeps
    per-stream state (cuSOLVER's triangular solves allocate a counter on a
    stream's first use), and an allocation made during a capture becomes a
    memory node, which a conditional body cannot hold."""
    warm.regions += 1
    stream = _body_stream(device, depth)
    current = torch.cuda.current_stream(device)
    stream.wait_stream(current)
    token = _STATE.set((True, None, warm, depth + 1))
    try:
        with torch.cuda.stream(stream):
            body()
    finally:
        _STATE.reset(token)
    current.wait_stream(stream)


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


def _allocate_to_pool(device_index: int, pool) -> None:
    """Send this thread's allocations to the private pool ``pool`` until
    ``torch._C._cuda_endAllocateToPool``; takes a reference to the pool,
    which ``torch._C._cuda_releasePool`` gives back."""
    torch._C._cuda_beginAllocateCurrentThreadToPool(device_index, pool)


@dataclasses.dataclass
class _HostCall:
    fn: Callable
    inputs: List[torch.Tensor]  # written by the graph before the call
    outputs: List[torch.Tensor]  # static buffers the graph after it reads
    preds: List[torch.Tensor]  # the predicates of the regions around it

    def replay(self) -> None:
        if not all(bool(p) for p in self.preds):
            return
        outs = self.fn(*[t.cpu().numpy() for t in self.inputs])
        for buf, o in zip(self.outputs, outs):
            buf.copy_(torch.as_tensor(np.asarray(o)).reshape(buf.shape))


@dataclasses.dataclass
class Region:
    """A conditional region of a capture: ``runs`` (a 0-d int64 device
    tensor, a slot of the capture's counters) counts the runs of its body
    (a loop's passes), over the capture's life; ``launches`` are the kernel
    launches captured in it and in none of the regions nested in it."""
    name: str
    runs: torch.Tensor
    launches: Dict[str, int] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class _Open:
    region: Region
    pred: torch.Tensor
    stream: torch.cuda.ExternalStream
    body_graph: int  # the cudaGraph_t its node owns
    handle: int  # its node's cudaGraphConditionalHandle
    loop: bool  # a "while" node
    context: object  # the torch.cuda.stream context of the body


class Capture:
    """An iteration captured as CUDA graphs on one private memory pool,
    split at each host call. ``record(fn)`` captures ``fn()`` (run once,
    at capture time, on a side stream); ``replay()`` runs the pieces on
    the current stream. A capture that fails raises.

    A region's body is captured on a stream of its own (one per nesting
    depth) and allocates from a second private pool of the capture's,
    which lives as long as the capture: the outermost open region sends
    this thread's allocations there, those of the regions nested in it
    too (the caching allocator refuses a second recording to a pool it
    records to; it keeps a block for the stream that freed it, so the
    depths share no block)."""

    def __init__(self, device: torch.device):
        self.device = device
        self.pieces: list = []
        self.pool = None
        self.regions: List[Region] = []
        # launches captured outside every region (run on every replay)
        self.top_launches: Dict[str, int] = {}
        self._graph = None
        self._stream = None  # the stream the pieces are captured on
        self._open: List[_Open] = []
        self._body_pool = None
        self._mark: Dict[str, int] = {}
        self._runs = None  # the regions' run counters (record)

    @property
    def host_calls(self) -> int:
        return sum(isinstance(p, _HostCall) for p in self.pieces)

    def _attribute(self) -> None:
        """Add the launches since the last mark to the innermost open
        region (or to the top level) and set a new mark."""
        now = launch_stats.snapshot()
        into = self._open[-1].region.launches if self._open else (
            self.top_launches)
        for n, c in now.items():
            if c != self._mark.get(n, 0):
                into[n] = into.get(n, 0) + c - self._mark.get(n, 0)
        self._mark = now

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

    def record(self, fn: Callable, regions: int = 0):
        """Capture ``fn()``, which opens ``regions`` regions (a warm-up of
        the same code counts them: ``WarmUp.regions``)."""
        # the regions' run counters, made before the capture: a tensor
        # made during it may take the memory of a temporary freed earlier
        # in the capture, which every replay writes again
        self._runs = torch.zeros(regions, dtype=torch.int64,
                                 device=self.device)
        torch.cuda.synchronize(self.device)
        stream = torch.cuda.Stream(self.device)
        stream.wait_stream(torch.cuda.current_stream(self.device))
        self._stream = stream
        self._mark = launch_stats.snapshot()
        # no graph may be destroyed while a stream captures: collect the
        # dead ones now, and no garbage cycle during the capture
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.device(self.device), torch.cuda.stream(stream):
                self._begin()
                try:
                    with enabled(self):
                        out = fn()
                except BaseException:
                    while self._open:  # leave every stream uncaptured
                        try:
                            self._close()
                        except RuntimeError:
                            pass
                    if self._graph is not None:
                        graph, self._graph = self._graph, None
                        try:
                            graph.capture_end()
                        except RuntimeError:
                            pass
                    raise
                self._attribute()
                self._end()
        finally:
            if collecting:
                gc.enable()
        torch.cuda.current_stream(self.device).wait_stream(stream)
        torch.cuda.synchronize(self.device)
        return out

    def _body(self, depth: int):
        """The stream and the pool of a region's body at ``depth``."""
        if self._body_pool is None:
            self._body_pool = torch.cuda.graph_pool_handle()
            # hold the body pool for the capture's life
            _allocate_to_pool(self._device_index(), self._body_pool)
            torch._C._cuda_endAllocateToPool(self._device_index(),
                                             self._body_pool)
        return _body_stream(self.device, depth), self._body_pool

    def _device_index(self) -> int:
        index = self.device.index
        return torch.cuda.current_device() if index is None else index

    def _open_region(self, region: Region, pred: torch.Tensor,
                     loop: bool = False) -> None:
        stream, pool = self._body(len(self._open))
        parent = torch.cuda.current_stream(self.device)
        graph, handle = cond_node.begin(parent.cuda_stream, pred,
                                        stream.cuda_stream, loop)
        self._attribute()  # the launches so far and the begin: the parent's
        context = torch.cuda.stream(stream)
        context.__enter__()
        if not self._open:  # this thread's allocations, at every depth
            _allocate_to_pool(self._device_index(), pool)
        self._open.append(_Open(region, pred, stream, graph, handle, loop,
                                context))

    def _close(self) -> _Open:
        self._attribute()
        top = self._open.pop()
        try:
            if not self._open:
                torch._C._cuda_endAllocateToPool(self._device_index(),
                                                 self._body_pool)
                torch._C._cuda_releasePool(self._device_index(),
                                           self._body_pool)
            top.context.__exit__(None, None, None)
        finally:  # the body's capture ends whatever failed
            cond_node.end(top.stream.cuda_stream, top.body_graph,
                          top.region.name)
        return top

    def region(self, pred: torch.Tensor, body: Callable[[], None], name: str,
               again: Optional[Callable[[], torch.Tensor]] = None) -> None:
        """Record ``body()`` as a region on ``pred`` (see ``cond``), or, with
        ``again``, as a loop whose body runs again while ``again()`` is
        true (see ``while_loop``)."""
        if len(self.regions) == len(self._runs):
            raise RuntimeError(
                f"cond: the capture opens more than the {len(self._runs)} "
                "regions that record() was given (its warm-up's count)")
        runs = self._runs[len(self.regions)]
        region = Region(name, runs)
        self.regions.append(region)
        self._open_region(region, pred, loop=again is not None)
        try:
            runs.add_(1)
            body()
            if again is not None:
                top = self._open[-1]
                cond_node.set_handle(top.stream.cuda_stream, top.handle,
                                     again())
        finally:
            if self._open and self._open[-1].region is region:
                self._close()

    def host_call(self, fn, inputs, outputs, device):
        """Closes the open regions and ends the graph so far, records the
        call with zero-filled static output buffers, then begins the next
        graph and opens the regions again."""
        if any(o.loop for o in self._open):
            raise RuntimeError("host_call: a loop's body (while_loop) cannot "
                               "hold a host call")
        reopen = []
        while self._open:
            top = self._close()
            reopen.insert(0, (top.region, top.pred))
        with torch.cuda.stream(self._stream):
            self._end()
            bufs = [torch.zeros(shape, dtype=dt, device=device)
                    for shape, dt in outputs]
            self.pieces.append(_HostCall(fn, [t.detach() for t in inputs],
                                         bufs, [p for _, p in reopen]))
            self._begin()
        self._mark = launch_stats.snapshot()
        for region, pred in reopen:
            self._open_region(region, pred)
        return bufs

    def replay(self) -> None:
        for piece in self.pieces:
            if isinstance(piece, _HostCall):
                torch.cuda.current_stream(self.device).synchronize()
            piece.replay()

    def _run_counts(self) -> List[int]:
        return self._runs[:len(self.regions)].tolist() if self.regions else []

    def region_runs(self) -> Dict[str, int]:
        """The runs of each region's body (a loop's passes), summed by
        region name, over the capture's life (one readback)."""
        out: Dict[str, int] = {}
        for region, c in zip(self.regions, self._run_counts()):
            out[region.name] = out.get(region.name, 0) + c
        return out

    def launches(self, replays: int) -> Dict[str, int]:
        """Each kernel wrapper's launches over ``replays`` replays: the top
        level's on every replay, a region's on each run of its body (one
        readback)."""
        out = {n: c * replays for n, c in self.top_launches.items()}
        for region, c in zip(self.regions, self._run_counts()):
            for n, k in region.launches.items():
                out[n] = out.get(n, 0) + k * c
        return out

    def __del__(self):
        if self._body_pool is not None:
            try:
                torch._C._cuda_releasePool(self._device_index(),
                                           self._body_pool)
            except Exception:  # interpreter shutdown
                pass
