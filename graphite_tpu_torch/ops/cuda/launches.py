"""Launch counts (and optional CUDA-event timings) of a kernel wrapper,
and the stream a wrapper launches on.

Each wrapper owns one ``LaunchStats`` and adds one to it where it
launches its kernel, and nowhere else, so a run can show that its main
path went through the kernel. With ``record_events`` set, each launch is
bracketed by two CUDA events on the launch stream; ``total_ms`` reads them
(after a synchronize).

Inside a captured CUDA graph (the device-controlled LM iteration) a
wrapper runs once, at capture time: its count is the launches captured
(``snapshot`` takes every wrapper's count, for the difference across a
capture). A replay runs those outside the graph's conditional regions
and those of each region it enters, so a captured path's launches are
``device_loop.Capture.launches(replays)``: the first times the replays,
each region's times the runs of its body. Events cannot be recorded there: ``start`` raises when
``record_events`` is set during a capture.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Tuple

import torch


def on_device(device: torch.device):
    """``torch.cuda.device(device)``, or no context at all when ``device``
    is already the current one (the common case, and the context costs
    host time on every launch)."""
    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def stream_ptr(device: torch.device) -> int:
    """The current CUDA stream of ``device``, as the pointer a kernel's C
    entry takes: ``torch.cuda.current_stream(device).cuda_stream`` without
    building a ``Stream`` object on every launch (host time: the Ladybug
    path launches ~600 kernels per LM iteration;
    ``python -m graphite_tpu_torch.kernel_sweep`` times both)."""
    index = device.index
    return torch._C._cuda_getCurrentRawStream(
        torch.cuda.current_device() if index is None else index)


REGISTRY: List["LaunchStats"] = []


def snapshot() -> Dict[str, int]:
    """Every wrapper's launch count, by name."""
    return {s.name: s.launches for s in REGISTRY}


@dataclasses.dataclass
class LaunchStats:
    name: str
    launches: int = 0
    record_events: bool = False
    events: List[Tuple[torch.cuda.Event, torch.cuda.Event]] = dataclasses.field(
        default_factory=list)

    def __post_init__(self):
        REGISTRY.append(self)

    def reset(self) -> None:
        self.launches = 0
        self.events.clear()

    def start(self):
        """Called right before a launch; returns the start event or None."""
        if not self.record_events:
            return None
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"{self.name}: record_events is set during a CUDA graph "
                "capture; a captured launch cannot be timed by events")
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def done(self, start_event) -> None:
        """Called right after a successful launch."""
        self.launches += 1
        if start_event is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            self.events.append((start_event, end))

    def total_ms(self) -> float:
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.events)
