"""Simulated address-space management (reference: common/system/
vm_manager.{h,cc}).

The reference's VMManager carves one simulated address space into three
segments and bump-allocates from them when the application's memory
syscalls marshal through the MCP:

  * data      — grows UP from the static break via ``brk`` (vm_manager.cc
                brk(): sets the segment end — shrinking is accepted —
                and must stay below the stack segment);
  * stacks    — one fixed window per tile at
                ``stack_base + tile * stack_size_per_core``
                ([stack] carbon_sim.cfg:113-117, thread spawn glue);
  * dynamic   — ``mmap`` carves DOWN from 0xf000000000
                (vm_manager.cc:37, mmap(): start_dynamic -= length);
                ``munmap`` is accounting-only (vm_manager.cc munmap()
                "Ignore for now").

graphite_tpu_torch runs timing-only (lite mode), so no data lives at these
addresses — but the layout still matters: it is what a Simulator-as-
library user queries for spawn-time stack placement, it makes captured
mmap/brk traffic auditable (peak heap/dynamic footprint per run in the
summary), and segment exhaustion is a loud failure exactly like the
reference's LOG_ASSERT aborts.

Two faces, one layout:

  * ``VMManager`` — the host-side object with the reference's exact
    brk/mmap/munmap API, used by tools and tests (API parity target:
    vm_manager.h:9-30).
  * The engine accumulates per-run totals (max requested break, mmap'd /
    munmap'd bytes) in ``SimState.vm_*`` scalars as SYSCALL events
    retire (engine/core.py complex slot); ``summarize`` folds them into
    this layout for the run summary.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

# Reference constants (vm_manager.cc).
START_DYNAMIC = 0xF0_0000_0000      # mmap segment grows down from here
# [stack] defaults (reference carbon_sim.cfg:113-117).  defaults.cfg
# [stack] mirrors these values for config-driven runs;
# tests/test_vm.py::test_stack_defaults_match_config pins the two
# together.
DEFAULT_STACK_BASE = 2415919104
DEFAULT_STACK_SIZE_PER_CORE = 2097152
# The reference seeds the data segment at the host's sbrk(0); a
# timing-only simulation has no host break, so the simulated data
# segment starts at a fixed canonical address below the default stack
# base (2415919104 = 0x90000000).
START_DATA = 0x1000_0000


class VMError(RuntimeError):
    """Segment exhaustion / layout violation (the reference aborts via
    LOG_ASSERT_ERROR; a library raises)."""


@dataclasses.dataclass
class VMManager:
    """Reference-API simulated address-space allocator (vm_manager.h).

    >>> vm = VMManager(num_tiles=64)
    >>> hex(vm.mmap(length=4096))
    '0xeffffff000'
    >>> vm.brk(0)  # query, like the syscall
    268435456
    """

    num_tiles: int
    stack_base: int = DEFAULT_STACK_BASE
    stack_size_per_core: int = DEFAULT_STACK_SIZE_PER_CORE
    start_data: int = START_DATA

    def __post_init__(self):
        self.end_data = self.start_data
        self.start_stack = self.stack_base
        self.end_stack = self.stack_base \
            + self.num_tiles * self.stack_size_per_core
        self.start_dynamic = START_DYNAMIC
        self.mmap_bytes = 0
        self.munmap_bytes = 0
        if not (self.start_data < self.start_stack < self.end_stack
                < START_DYNAMIC):
            raise VMError(
                f"bad segment layout: data@{self.start_data:#x} "
                f"stack@{self.start_stack:#x}-{self.end_stack:#x} "
                f"dynamic@{START_DYNAMIC:#x}")

    # -- reference API ----------------------------------------------------
    def brk(self, end_data_segment: int) -> int:
        """Set (or query, when 0) the data segment end (vm_manager.cc
        brk()); any end inside (start_data, start_stack) is accepted,
        shrinking included."""
        if end_data_segment == 0:
            return self.end_data
        if end_data_segment <= self.start_data:
            raise VMError(
                f"brk({end_data_segment:#x}) below data segment start "
                f"{self.start_data:#x}")
        if end_data_segment >= self.start_stack:
            raise VMError(
                f"brk({end_data_segment:#x}) runs into the stack segment "
                f"at {self.start_stack:#x}: out of data-segment memory")
        self.end_data = end_data_segment
        return self.end_data

    def mmap(self, length: int) -> int:
        """Anonymous private mapping carved down from the dynamic
        segment (vm_manager.cc mmap(); fd/fixed mappings unsupported
        there too)."""
        if length <= 0:
            raise VMError(f"mmap length {length} must be positive")
        if self.start_dynamic - length <= self.end_stack:
            raise VMError(
                f"mmap({length:#x}): dynamic segment exhausted "
                f"(would cross stacks at {self.end_stack:#x})")
        self.start_dynamic -= length
        self.mmap_bytes += length
        return self.start_dynamic

    def munmap(self, start: int, length: int) -> int:
        """Accounting-only, like the reference ("Ignore for now")."""
        if start < self.start_dynamic:
            raise VMError(
                f"munmap({start:#x}) below the dynamic segment at "
                f"{self.start_dynamic:#x}")
        self.munmap_bytes += max(length, 0)
        return 0

    # -- layout queries ---------------------------------------------------
    def stack_window(self, tile: int) -> tuple:
        """[base, limit) of one tile's simulated stack (thread spawn
        placement; reference vm_manager.cc:26 + thread spawn glue)."""
        if not 0 <= tile < self.num_tiles:
            raise VMError(f"tile {tile} outside 0..{self.num_tiles - 1}")
        base = self.stack_base + tile * self.stack_size_per_core
        return base, base + self.stack_size_per_core

    # -- summary ----------------------------------------------------------
    def describe(self) -> dict:
        return {
            "data_segment_bytes": self.end_data - self.start_data,
            "stack_segment_bytes": self.end_stack - self.start_stack,
            "dynamic_segment_bytes": START_DYNAMIC - self.start_dynamic,
            "mmap_bytes": self.mmap_bytes,
            "munmap_bytes": self.munmap_bytes,
        }


def summarize(num_tiles: int, stack_base: int, stack_size_per_core: int,
              vm_brk_bytes: int, vm_mmap_bytes: int, vm_munmap_bytes: int,
              ) -> Optional[dict]:
    """Fold the engine's per-run VM counters (SimState.vm_*) into the
    segment layout for the run summary.  ``vm_brk_bytes`` is the highest
    requested data-segment SIZE — brk events carry the delta over the
    program's initial break, not a raw host address (a PIE host break
    sits far above any simulated segment; tsan_capture.cc __wrap_brk).
    Returns None when the trace performed no memory-management syscalls
    (section omitted)."""
    if vm_brk_bytes == 0 and vm_mmap_bytes == 0 and vm_munmap_bytes == 0:
        return None
    vm = VMManager(num_tiles=num_tiles, stack_base=stack_base,
                   stack_size_per_core=stack_size_per_core)
    out = vm.describe()
    out["data_segment_bytes"] = int(vm_brk_bytes)
    out["brk_overflow"] = bool(
        vm.start_data + int(vm_brk_bytes) >= vm.start_stack)
    out["mmap_bytes"] = int(vm_mmap_bytes)
    out["munmap_bytes"] = int(vm_munmap_bytes)
    out["dynamic_segment_bytes"] = int(vm_mmap_bytes)
    out["dynamic_overflow"] = bool(
        START_DYNAMIC - int(vm_mmap_bytes) <= vm.end_stack)
    return out
