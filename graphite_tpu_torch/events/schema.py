"""Per-tile event-stream schema — the frontend/engine contract.

This is the TPU build's analog of the reference's Pin analysis-call feed:
one record per *modeled step* of a tile, covering the union of what the
reference's instrumentation delivers to the timing models —
instruction decode + queue (reference: pin/instruction_modeling.cc:350-410),
lite-mode memory modeling (reference: pin/lite/memory_modeling.cc:13-57),
user messaging / sync / spawn dynamic instructions (reference:
common/tile/core/instruction.h:166-200), and thread lifecycle.

Layout: structure-of-arrays, fixed shape ``[num_tiles, num_events]``,
padded with NOP so every tile's stream has the same length (static shapes
for XLA).  Field meaning depends on the opcode (see ``EventOp``):

===============  =====================  ==============  =======================
op               addr (int64)           arg (int32)     arg2 (int32)
===============  =====================  ==============  =======================
NOP              -                      -               -
COMPUTE          block start pc         cost (cycles)   instruction count
MEM_READ         byte address           size (bytes)    0 / 1 = line-split cont.
MEM_WRITE        byte address           size (bytes)    0 / 1 = line-split cont.
ATOMIC           byte address           size (bytes)    0 / 1 = line-split cont.
BRANCH           pc                     taken (0/1)     0
SEND             -                      size (bytes)    destination tile
RECV             -                      size (bytes)    source tile
BARRIER_WAIT     -                      barrier id      participant count
MUTEX_LOCK       -                      mutex id        0
MUTEX_UNLOCK     -                      mutex id        0
COND_WAIT        -                      cond id         mutex id (held)
COND_SIGNAL      -                      cond id         0
COND_BROADCAST   -                      cond id         0
JOIN             -                      -               child stream
THREAD_START     -                      -               -
YIELD            -                      -               -
SYNC             wake time (ps)         cost (cycles)   0
SPAWN            -                      cost (cycles)   child tile
STALL            until time (ps)        -               0
DVFS_SET         -                      module id       frequency (MHz)
DONE             -                      -               -
===============  =====================  ==============  =======================

Conventions the frontend must uphold (mirroring reference behavior):
  * Memory accesses are split at cache-line boundaries by the *frontend*
    (the reference splits them in Core::initiateMemoryAccess,
    common/tile/core/core.cc:173-245); the engine models one line per
    MEM_* event.
  * COMPUTE collapses a run of non-memory, non-branch instructions into an
    aggregate (cost, icount) pair; cost is the sum of the static per-type
    costs the reference reads from [core/static_instruction_costs]
    (carbon_sim.cfg:189-200).  The engine models instruction fetch for the
    block from `addr` assuming a mean 4-byte encoding.
  * Streams end with one DONE; slots after it are NOP padding.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from graphite_tpu_torch.isa import EventOp, InstructionType

__all__ = ["Trace", "TraceBuilder", "EventOp"]

# Mean instruction encoding length assumed when modeling i-fetch for a
# COMPUTE block (x86 averages ~3.7 bytes; the reference fetches each
# instruction's true bytes via Pin, which a trace no longer carries).
ICACHE_BYTES_PER_INSTRUCTION = 4


@dataclasses.dataclass
class Trace:
    """A complete per-tile event-stream bundle (numpy; device placement is
    the engine's job)."""

    ops: np.ndarray    # [T, N] int32 (EventOp)
    addr: np.ndarray   # [T, N] int64
    arg: np.ndarray    # [T, N] int32
    arg2: np.ndarray   # [T, N] int32

    @property
    def num_tiles(self) -> int:
        return self.ops.shape[0]

    @property
    def num_events(self) -> int:
        return self.ops.shape[1]

    def __post_init__(self):
        shape = self.ops.shape
        for name in ("addr", "arg", "arg2"):
            a = getattr(self, name)
            if a.shape != shape:
                raise ValueError(f"trace field {name} shape {a.shape} != {shape}")
        self.ops = self.ops.astype(np.int32, copy=False)
        self.addr = self.addr.astype(np.int64, copy=False)
        self.arg = self.arg.astype(np.int32, copy=False)
        self.arg2 = self.arg2.astype(np.int32, copy=False)

    # -------------------------------------------------------------- io

    def save(self, path: str) -> None:
        np.savez_compressed(
            path, ops=self.ops, addr=self.addr, arg=self.arg, arg2=self.arg2
        )

    @classmethod
    def load(cls, path: str) -> "Trace":
        with np.load(path) as z:
            return cls(ops=z["ops"], addr=z["addr"], arg=z["arg"], arg2=z["arg2"])

    # ------------------------------------------------------------ utility

    def content_hash(self) -> str:
        """sha256 over the event arrays (values + shapes) — the trace's
        durable identity.  Two traces with equal hashes produce
        bit-identical simulations under equal params, so this keys the
        sweep service's serve-from-cache tier (and matches the disk
        trace cache's content-addressing philosophy)."""
        import hashlib
        h = hashlib.sha256()
        for a in (self.ops, self.addr, self.arg, self.arg2):
            h.update(str(a.shape).encode())
            h.update(np.ascontiguousarray(a).tobytes())
        return h.hexdigest()

    def instruction_count(self) -> int:
        """Total modeled instructions across all tiles (for MIPS math).
        Line-split continuation events (arg2=1 on MEM_*) belong to the
        same instruction as their predecessor and are not re-counted."""
        ops = self.ops
        n = int(np.sum(np.where(ops == EventOp.COMPUTE, self.arg2, 0)))
        mem = np.isin(ops, (EventOp.MEM_READ, EventOp.MEM_WRITE, EventOp.ATOMIC))
        n += int(np.sum(mem & (self.arg2 == 0)))
        n += int(np.sum(ops == EventOp.BRANCH))
        return n

    def pad_to(self, num_events: int) -> "Trace":
        if num_events < self.num_events:
            raise ValueError("pad_to cannot shrink a trace")
        if num_events == self.num_events:
            return self
        T, N = self.ops.shape
        pad = num_events - N

        def _pad(a, dtype):
            return np.concatenate(
                [a, np.zeros((T, pad), dtype=dtype)], axis=1)

        return Trace(
            ops=_pad(self.ops, np.int32),
            addr=_pad(self.addr, np.int64),
            arg=_pad(self.arg, np.int32),
            arg2=_pad(self.arg2, np.int32),
        )


class TraceBuilder:
    """Append-style builder for one trace: per-tile event lists packed into
    the dense [T, N] layout (the software analog of the reference's
    per-thread analysis-call sequence)."""

    def __init__(self, num_tiles: int, line_size: int = 64,
                 static_costs: Optional[Dict[InstructionType, int]] = None):
        self.num_tiles = num_tiles
        self.line_size = line_size
        self.static_costs = static_costs or {}
        self._events: List[List[Tuple[int, int, int, int]]] = [
            [] for _ in range(num_tiles)
        ]
        self._done = [False] * num_tiles

    # ----------------------------------------------------------- emitters

    def _emit(self, tile: int, op: EventOp, addr: int = 0, arg: int = 0,
              arg2: int = 0) -> None:
        if self._done[tile]:
            raise ValueError(f"tile {tile} already DONE")
        self._events[tile].append((int(op), int(addr), int(arg), int(arg2)))

    # Register-operand annotations (IOCOOM scoreboard, reference
    # iocoom_core_model.h:82 Scoreboard _register_scoreboard): events may
    # name one source and one destination register out of NUM_REGISTERS
    # architectural registers; ids are packed into arg2's high bits.  The
    # reference tracks 512 Pin register ids; the trace schema compresses
    # to 32 (frontends map ids mod 32 — a collision only adds a false
    # dependency, which is conservative, never optimistic).
    NUM_REGISTERS = 32
    _REG_SRC_SHIFT = 20    # COMPUTE: bits 20-24 = src reg + 1
    _REG_DST_SHIFT = 25    # COMPUTE: bits 25-29 = dst reg + 1
    _MEM_DST_SHIFT = 8     # MEM_READ: bits 8-12 = dest reg + 1

    def compute(self, tile: int, cost_cycles: int, icount: int,
                pc: int = 0x400000, src_reg: Optional[int] = None,
                dst_reg: Optional[int] = None) -> None:
        assert icount < (1 << self._REG_SRC_SHIFT)
        arg2 = icount
        if src_reg is not None:
            assert 0 <= src_reg < self.NUM_REGISTERS
            arg2 |= (src_reg + 1) << self._REG_SRC_SHIFT
        if dst_reg is not None:
            assert 0 <= dst_reg < self.NUM_REGISTERS
            arg2 |= (dst_reg + 1) << self._REG_DST_SHIFT
        self._emit(tile, EventOp.COMPUTE, pc, cost_cycles, arg2)

    def instructions(self, tile: int, types: Sequence[InstructionType],
                     pc: int = 0x400000) -> None:
        """Convenience: collapse a typed instruction run via the builder's
        static-cost table (what a real frontend does at decode)."""
        cost = sum(self.static_costs[t] for t in types)
        self.compute(tile, cost, len(types), pc)

    def _mem(self, tile: int, op: EventOp, addr: int, size: int,
             dest_reg: Optional[int] = None) -> None:
        # Line-splitting happens here, as in the reference's core entry
        # (core.cc:173-245): one event per touched line.  Continuation
        # events of a straddling access carry arg2 bit 0 = 1 so
        # instruction counting attributes the whole access to one
        # instruction.  ``dest_reg`` (loads) rides arg2 bits 8-12 on the
        # first line's event — the scoreboard destination.
        end = addr + max(1, size)
        line = self.line_size
        a = addr
        first = True
        dbits = 0
        if dest_reg is not None:
            assert 0 <= dest_reg < self.NUM_REGISTERS
            dbits = (dest_reg + 1) << self._MEM_DST_SHIFT
        while a < end:
            line_end = (a // line + 1) * line
            chunk = min(end, line_end) - a
            self._emit(tile, op, a, chunk,
                       (0 | dbits) if first else 1)
            a += chunk
            first = False

    def read(self, tile: int, addr: int, size: int = 8,
             dest_reg: Optional[int] = None) -> None:
        self._mem(tile, EventOp.MEM_READ, addr, size, dest_reg=dest_reg)

    def write(self, tile: int, addr: int, size: int = 8) -> None:
        self._mem(tile, EventOp.MEM_WRITE, addr, size)

    def atomic(self, tile: int, addr: int, size: int = 8) -> None:
        self._mem(tile, EventOp.ATOMIC, addr, size)

    def branch(self, tile: int, taken: bool, pc: int = 0x400000) -> None:
        self._emit(tile, EventOp.BRANCH, pc, int(taken), 0)

    def send(self, tile: int, dst: int, size: int = 8) -> None:
        self._emit(tile, EventOp.SEND, 0, size, dst)

    def recv(self, tile: int, src: int, size: int = 8) -> None:
        self._emit(tile, EventOp.RECV, 0, size, src)

    def syscall(self, tile: int, syscall_class, nbytes: int = 0,
                vm_arg: int = 0) -> None:
        """Marshalled system call served by the MCP's syscall server
        (reference: syscall_model.cc -> syscall_server.cc:43-130);
        ``nbytes`` = marshalled argument/result payload.  ``vm_arg``
        carries the VMManager payload in the addr field (mmap/munmap:
        length; brk: the requested data-segment size, i.e. the delta
        over the initial break — vm_manager.cc, engine/vm.py)."""
        self._emit(tile, EventOp.SYSCALL, vm_arg, int(syscall_class),
                   nbytes)

    def barrier(self, tile: int, barrier_id: int, participants: int) -> None:
        self._emit(tile, EventOp.BARRIER_WAIT, 0, barrier_id, participants)

    def mutex_lock(self, tile: int, mutex_id: int) -> None:
        self._emit(tile, EventOp.MUTEX_LOCK, 0, mutex_id, 0)

    def mutex_unlock(self, tile: int, mutex_id: int) -> None:
        self._emit(tile, EventOp.MUTEX_UNLOCK, 0, mutex_id, 0)

    def cond_wait(self, tile: int, cond_id: int, mutex_id: int) -> None:
        """Release ``mutex_id`` (which the tile must hold), park until a
        signal, then re-acquire it before continuing."""
        self._emit(tile, EventOp.COND_WAIT, 0, cond_id, mutex_id)

    def cond_signal(self, tile: int, cond_id: int) -> None:
        self._emit(tile, EventOp.COND_SIGNAL, 0, cond_id, 0)

    def cond_broadcast(self, tile: int, cond_id: int) -> None:
        self._emit(tile, EventOp.COND_BROADCAST, 0, cond_id, 0)

    def spawn(self, tile: int, child: int, cost_cycles: int = 0) -> None:
        """Start ``child``'s stream (which must begin with THREAD_START)."""
        self._emit(tile, EventOp.SPAWN, 0, cost_cycles, child)

    def join(self, tile: int, child: int) -> None:
        """Block until ``child``'s stream reaches DONE."""
        self._emit(tile, EventOp.JOIN, 0, 0, child)

    def thread_start(self, tile: int) -> None:
        """Gate this tile's stream on being SPAWNed by another tile."""
        self._emit(tile, EventOp.THREAD_START, 0, 0, 0)

    def thread_yield(self, tile: int) -> None:
        """Give up the core so the scheduler can seat the next queued
        stream (CarbonThreadYield; only meaningful when the trace has
        more streams than tiles)."""
        self._emit(tile, EventOp.YIELD, 0, 0, 0)

    def enable_models(self, tile: int) -> None:
        """Region-of-interest start (CarbonEnableModels): timing + counters
        resume globally."""
        self._emit(tile, EventOp.ENABLE_MODELS, 0, 0, 0)

    def disable_models(self, tile: int) -> None:
        """Region-of-interest end (CarbonDisableModels): compute/memory
        events fast-forward at zero cost, uncounted, until re-enabled."""
        self._emit(tile, EventOp.DISABLE_MODELS, 0, 0, 0)

    def stall_until(self, tile: int, time_ps: int) -> None:
        self._emit(tile, EventOp.STALL, time_ps, 0, 0)

    def dvfs_set(self, tile: int, module: int, freq_ghz: float) -> None:
        self._emit(tile, EventOp.DVFS_SET, 0, module, int(round(freq_ghz * 1000)))

    def done(self, tile: int) -> None:
        self._emit(tile, EventOp.DONE)
        self._done[tile] = True

    # ------------------------------------------------------------- finish

    def build(self, min_events: Optional[int] = None) -> Trace:
        for t in range(self.num_tiles):
            if not self._done[t]:
                self.done(t)
        n = max(len(ev) for ev in self._events)
        if min_events is not None:
            n = max(n, min_events)
        T = self.num_tiles
        ops = np.zeros((T, n), dtype=np.int32)
        addr = np.zeros((T, n), dtype=np.int64)
        arg = np.zeros((T, n), dtype=np.int32)
        arg2 = np.zeros((T, n), dtype=np.int32)
        for t, evs in enumerate(self._events):
            if not evs:
                continue
            rec = np.asarray(evs, dtype=np.int64)
            k = len(evs)
            ops[t, :k] = rec[:, 0]
            addr[t, :k] = rec[:, 1]
            arg[t, :k] = rec[:, 2]
            arg2[t, :k] = rec[:, 3]
        return Trace(ops=ops, addr=addr, arg=arg, arg2=arg2)
