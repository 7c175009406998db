"""The rank-order all-reduce and gather of a sharded problem: kernel K8
(``csrc/allreduce.cu``), over CUDA IPC.

Counterpart of the JAX package's ``lax.psum`` over the factor axis (every
``problem.allreduce`` of a rank's replica, and the Schur stage's sum of
the ranks' disjoint S ranges). ``parallel/sharding.Mesh`` calls it: on a
CUDA mesh every collective is a K8 launch, which a CUDA graph can hold,
so the captured LM iteration (``jit_loop``) runs above one rank; on a CPU
mesh every collective is the plain version. There is no fallback: a CUDA
tensor launches K8 or raises.

- ``allreduce_plain`` / ``gather_plain``: the plain version, K8's oracle.
  Each rank writes its ``x`` into its own row of a zeroed ``(world, ...)``
  buffer, one ``dist.all_reduce`` sums the buffer (one non-zero term per
  element, so the backend's order changes no bit) and the rows are added
  in rank order. K8 adds in the same order, each row first added to +0
  as the buffer's sum adds it: the two agree bit for bit.
- ``Transport``: one rank's arena (a block from ``cudaMalloc``, its
  header and two halves; ``csrc/allreduce.cu`` says why two are enough)
  and its mappings of the peers' arenas. Each call launches K8's two
  passes on the current stream and allocates its output with
  ``torch.empty`` (inside a conditional region, from the region's pool).
  The device advances the epoch itself, so a captured call takes no host
  argument on a replay.
- ``ArenaBook``: the host's bookkeeping of an arena (its size, the eager
  calls since it was made, the calls' tags), which needs no card.

Sizing. Every rank issues the same calls with the same sizes, so every
rank finds the same call too large for its arena, and grows there: a
synchronize, the old arena released (a barrier, the peers' mappings
closed, a barrier, the free), a new one allocated, and the handles exchanged over the mesh's process group
(``exchange``: every rank's size and tag must agree). Growing is
impossible while a stream captures: a capture that asks for more than the
arena holds raises (the device loop's eager warm-up runs every collective
first, so it sizes the arena). An arena that a capture has used is kept,
mapped, until ``close``: a graph holds its addresses.

The wait for the peers is bounded (``SPIN_SECONDS``). A call that times
out writes its tag into the arena's error word; the wrapper reads the
word after every eager call and ``Transport.check`` after a captured run,
and raises with the rank and the tag.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

from . import build
from .launches import LaunchStats, on_device, stream_ptr

STATS = LaunchStats("allreduce.allreduce")
GATHER_STATS = LaunchStats("allreduce.gather")

MAX_WORLD = 8  # kMaxWorld of csrc/allreduce.cu
HEADER_BYTES = 4096  # kHeaderBytes: the flags, the epoch, the error word
HANDLE_BYTES = 64  # sizeof(cudaIpcMemHandle_t)
ALIGN = 1 << 20  # a half's size is a multiple of this
# how long a call waits for its peers before it gives up (read at each
# launch; a captured call keeps the value it was captured with)
SPIN_SECONDS = 60.0

_DTYPES = {torch.float32: 0, torch.float64: 1, torch.int64: 2}

_SIGNATURES = {
    "gt_allreduce_alloc": [ctypes.c_longlong,
                           ctypes.POINTER(ctypes.c_void_p)],
    "gt_allreduce_free": [ctypes.c_void_p],
    "gt_allreduce_ipc_get": [ctypes.c_void_p, ctypes.c_void_p],
    "gt_allreduce_ipc_open": [ctypes.c_void_p,
                              ctypes.POINTER(ctypes.c_void_p)],
    "gt_allreduce_ipc_close": [ctypes.c_void_p],
    # x, out, arenas, world, rank, n, dtype, gather, half_bytes, tag,
    # spin_ns, stream
    "gt_allreduce_launch": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
        ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
        ctypes.c_void_p],
    "gt_allreduce_status": [ctypes.c_void_p,
                            ctypes.POINTER(ctypes.c_longlong),
                            ctypes.c_void_p],
}


def load_kernel() -> build.KernelLibrary:
    """Build K8 (at first use) and load it."""
    return build.load_library("allreduce", _SIGNATURES)


# ---- the plain version ----------------------------------------------------

def gather_plain(x: torch.Tensor, rank: int, world: int,
                 group=None) -> torch.Tensor:
    """(world, *x.shape): every rank's ``x``, each in its own row of a
    zeroed buffer summed by one ``all_reduce``."""
    buf = x.new_zeros((world,) + tuple(x.shape))
    buf[rank] = x
    dist.all_reduce(buf, group=group)
    return buf


def allreduce_plain(x: torch.Tensor, rank: int, world: int,
                    group=None) -> torch.Tensor:
    """The sum of every rank's ``x``, the rows of ``gather_plain`` added in
    rank order."""
    rows = gather_plain(x, rank, world, group)
    acc = rows[0]
    for r in range(1, world):
        acc = acc + rows[r]
    return acc


# ---- the host's bookkeeping -----------------------------------------------

def half_offset(epoch: int, half_bytes: int) -> int:
    """The byte offset in an arena of the half that the call of ``epoch``
    (1 for the arena's first call) writes: half ``epoch & 1``."""
    return HEADER_BYTES + (epoch & 1) * half_bytes


def arena_bytes(half_bytes: int) -> int:
    """An arena's size: the header and two halves."""
    return HEADER_BYTES + 2 * half_bytes


@dataclasses.dataclass
class ArenaBook:
    """One rank's arena as the host sees it: ``half_bytes`` (0 before the
    first call), ``eager_calls`` (calls launched outside a capture since
    the arena was made: the device's epoch after them, when no captured
    call has run in between) and the tags of the calls (an id each, which
    the kernel writes into the error word)."""

    rank: int
    world: int
    half_bytes: int = 0
    eager_calls: int = 0
    captured: bool = False  # a capture has recorded a call on this arena
    tags: List[str] = dataclasses.field(default_factory=list)

    def __post_init__(self):
        if not 1 <= self.world <= MAX_WORLD:
            raise ValueError(f"allreduce: K8 takes 1 to {MAX_WORLD} ranks, "
                             f"not {self.world}")

    def tag_id(self, tag: str) -> int:
        if tag not in self.tags:
            self.tags.append(tag)
        return self.tags.index(tag)

    def grow_to(self, nbytes: int, capturing: bool, tag: str) -> Optional[int]:
        """The half size to grow to before a call of ``nbytes`` (rounded up
        to ``ALIGN``; the first call makes the arena, whatever its size),
        or None when it fits. Raises while a stream captures: an arena
        cannot grow inside a graph."""
        nbytes = max(nbytes, 1)
        if nbytes <= self.half_bytes:
            return None
        if capturing:
            raise RuntimeError(
                f"allreduce: rank {self.rank}: call {tag!r} needs {nbytes} "
                f"bytes, the arena holds {self.half_bytes} a half, and a "
                "stream is capturing (the arena grows only outside a "
                "capture: run every collective once eagerly first)")
        return -(-nbytes // ALIGN) * ALIGN

    def reset(self, half_bytes: int) -> None:
        """A new arena of ``half_bytes`` a half: its epoch starts at 0."""
        self.half_bytes, self.eager_calls, self.captured = half_bytes, 0, False

    def expected_epoch(self) -> Optional[int]:
        """The device's epoch after the calls launched so far: the eager
        calls, while no capture holds a call on this arena (a replay
        advances the epoch unseen by the host: None)."""
        return None if self.captured else self.eager_calls


def exchange(payload: dict, world: int, group=None) -> List[dict]:
    """Every rank's ``payload``, by rank, over the process group
    (``all_gather_object``; outside a capture only)."""
    out: List[Optional[dict]] = [None] * world
    dist.all_gather_object(out, payload, group=group)
    return out


def check_payloads(payloads: List[dict], rank: int) -> List[bytes]:
    """The handles of an exchange, by rank, after checking that every rank
    grew at the same call: the same half size and tag on every rank (a
    rank whose calls differ would wait for ever in a later call)."""
    first = payloads[0]
    for r, p in enumerate(payloads):
        if p["rank"] != r:
            raise RuntimeError(f"allreduce: payload {r} is rank {p['rank']}'s")
        if len(p["handle"]) != HANDLE_BYTES:
            raise RuntimeError(f"allreduce: rank {r}'s handle has "
                               f"{len(p['handle'])} bytes, not {HANDLE_BYTES}")
        if (p["half_bytes"], p["tag"]) != (first["half_bytes"],
                                           first["tag"]):
            raise RuntimeError(
                f"allreduce: rank {rank}: the ranks disagree on the arena: "
                f"rank 0 grows to {first['half_bytes']} bytes a half at call "
                f"{first['tag']!r}, rank {r} to {p['half_bytes']} at "
                f"{p['tag']!r} (every rank must issue the same collectives)")
    return [p["handle"] for p in payloads]


# ---- the arena on the card -------------------------------------------------

@dataclasses.dataclass
class _Arena:
    own: int  # this rank's block
    mapped: List[int]  # the peers' blocks as mapped here (0 at own rank)
    table: object  # ctypes array: every rank's block, own included


class Transport:
    """One rank's K8 arena and its peers' (see the module docstring)."""

    def __init__(self, rank: int, world: int, device: torch.device,
                 group=None):
        self.rank, self.world, self.group = rank, world, group
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.book = ArenaBook(rank, world)
        self.arena: Optional[_Arena] = None
        self.retired: List[_Arena] = []  # used by a capture: kept mapped

    # -- the calls --
    def allreduce(self, x: torch.Tensor, tag: str = "allreduce"
                  ) -> torch.Tensor:
        """The sum of every rank's ``x``, in rank order."""
        return self._call(x, False, tag, STATS)

    def gather(self, x: torch.Tensor, tag: str = "gather") -> torch.Tensor:
        """(world, *x.shape): every rank's ``x``."""
        return self._call(x, True, tag, GATHER_STATS)

    def _call(self, x, gather, tag, stats) -> torch.Tensor:
        name = stats.name
        code = _DTYPES.get(x.dtype)
        if code is None:
            raise NotImplementedError(f"{name}: K8 takes float32, float64 or "
                                      f"int64, got {x.dtype}")
        if x.device.type != "cuda" or x.device != self.device:
            raise ValueError(f"{name}: x on {x.device}, the mesh on "
                             f"{self.device}")
        x = x.contiguous()
        nbytes = x.numel() * x.element_size()
        capturing = torch.cuda.is_current_stream_capturing()
        grow = self.book.grow_to(nbytes, capturing, tag)
        if grow is not None:
            self._grow(grow, tag)
        out = torch.empty(((self.world,) if gather else ()) + tuple(x.shape),
                          dtype=x.dtype, device=x.device)
        lib = load_kernel()
        arena = self.arena
        with on_device(x.device):
            ev = stats.start()
            lib.check(lib.lib.gt_allreduce_launch(
                x.data_ptr(), out.data_ptr(), arena.table, self.world,
                self.rank, x.numel(), code, int(gather), self.book.half_bytes,
                self.book.tag_id(tag), int(SPIN_SECONDS * 1e9),
                stream_ptr(x.device)), f"{name} ({tag!r})")
            stats.done(ev)
        if capturing:
            self.book.captured = True
        else:
            self.book.eager_calls += 1
            self.check(f"call {tag!r}")
        return out

    # -- the error word --
    def status(self, arena: Optional[_Arena] = None) -> Dict[str, int]:
        """An arena's (by default the current one's) error word, epoch and
        flag, after the work queued on the current stream (a
        synchronize)."""
        lib = load_kernel()
        words = (ctypes.c_longlong * 6)()
        with on_device(self.device):
            lib.check(lib.lib.gt_allreduce_status(
                (arena or self.arena).own, words, stream_ptr(self.device)),
                "allreduce: status")
        return dict(tag=words[0] - 1, peer=words[1], timed_out_epoch=words[2],
                    spin_ns=words[3], epoch=words[4], flag=words[5])

    def check(self, what: str) -> None:
        """Raise if a call on any arena of this transport timed out waiting
        for a peer, or if the current arena's epoch is not the host's count
        of its calls; ``what`` names the run in the message."""
        for arena in self.retired + ([self.arena] if self.arena else []):
            st = self.status(arena)
            if st["tag"] >= 0:
                tag = (self.book.tags[st["tag"]]
                       if st["tag"] < len(self.book.tags) else st["tag"])
                raise RuntimeError(
                    f"allreduce: rank {self.rank} of {self.world}: K8 call "
                    f"{tag!r} waited {st['spin_ns'] / 1e9:.1f} s for rank "
                    f"{st['peer']} at epoch {st['timed_out_epoch']} ({what})"
                    ": the ranks did not issue the same collectives")
        expected = self.book.expected_epoch()
        if self.arena is not None and expected not in (None, st["epoch"]):
            raise RuntimeError(
                f"allreduce: rank {self.rank}: the arena's epoch is "
                f"{st['epoch']} after {expected} calls ({what})")

    # -- the arena's life --
    def _grow(self, half_bytes: int, tag: str) -> None:
        """Collective: every rank reaches this call with the same size."""
        lib = load_kernel()
        torch.cuda.synchronize(self.device)
        if self.arena is not None:
            if self.book.captured:
                self.retired.append(self.arena)
            else:
                self._release([self.arena])
            self.arena = None
        with on_device(self.device):
            own = ctypes.c_void_p()
            lib.check(lib.lib.gt_allreduce_alloc(arena_bytes(half_bytes),
                                                 ctypes.byref(own)),
                      f"allreduce: an arena of {arena_bytes(half_bytes)} "
                      "bytes")
            handle = ctypes.create_string_buffer(HANDLE_BYTES)
            lib.check(lib.lib.gt_allreduce_ipc_get(own, handle),
                      "allreduce: IPC handle")
            handles = check_payloads(exchange(dict(
                rank=self.rank, half_bytes=half_bytes, tag=tag,
                handle=handle.raw), self.world, self.group), self.rank)
            mapped = []
            for r, h in enumerate(handles):
                if r == self.rank:
                    mapped.append(0)
                    continue
                peer = ctypes.c_void_p()
                lib.check(lib.lib.gt_allreduce_ipc_open(h, ctypes.byref(peer)),
                          f"allreduce: rank {self.rank} opening rank {r}'s "
                          "arena")
                mapped.append(peer.value)
        table = (ctypes.c_void_p * self.world)(
            *[own.value if r == self.rank else mapped[r]
              for r in range(self.world)])
        self.arena = _Arena(own.value, mapped, table)
        self.book.reset(half_bytes)

    def _release(self, arenas: List[_Arena]) -> None:
        """Collective: a barrier (every rank's calls have finished), each
        rank closes its mappings of the peers' arenas, a barrier (no rank
        maps another's any more), then each frees its own."""
        if not arenas:
            return
        lib = load_kernel()
        dist.barrier(group=self.group)
        with on_device(self.device):
            for a in arenas:
                for r, m in enumerate(a.mapped):
                    if r != self.rank and m:
                        lib.check(lib.lib.gt_allreduce_ipc_close(m),
                                  "allreduce: closing a peer's arena")
        dist.barrier(group=self.group)
        with on_device(self.device):
            for a in arenas:
                lib.check(lib.lib.gt_allreduce_free(a.own),
                          "allreduce: freeing the arena")

    def close(self) -> None:
        """Collective: free every arena of this transport (after the last
        replay of any graph that holds a call)."""
        arenas = self.retired + ([self.arena] if self.arena else [])
        if arenas:
            torch.cuda.synchronize(self.device)
        self._release(arenas)
        self.arena, self.retired = None, []
        self.book.reset(0)
