"""Synthetic trace generators — the first event source.

These play the role of the reference's synthetic test applications
(reference: tests/benchmarks/synthetic_memory/synthetic_memory.cc,
tests/benchmarks/synthetic_network/) and of the unit tests' hand-driven
access sequences (reference: tests/unit/shared_mem_basic/shared_mem_basic.cc:16-44):
deterministic per-tile event streams with controlled compute/memory mixes
and sharing patterns, used for golden-timing tests and benchmarking before
a live (Pin-equivalent) frontend exists.

Address-space convention: each tile's private heap lives at
``PRIVATE_BASE + tile * PRIVATE_SPAN``; shared regions live under
``SHARED_BASE``.  Addresses are synthetic — the engine only hashes them
(timing-only simulation, like the reference's lite mode).
"""

from __future__ import annotations

import numpy as np

from graphite_tpu_torch.events.schema import (
    ICACHE_BYTES_PER_INSTRUCTION, Trace, TraceBuilder)
from graphite_tpu_torch.isa import DVFSModule, EventOp, SyscallClass

PRIVATE_BASE = 0x1000_0000
PRIVATE_SPAN = 0x0100_0000
SHARED_BASE = 0x8000_0000


def gen_compute(num_tiles: int, blocks: int = 100, cost_cycles: int = 50,
                icount_per_block: int = 50) -> Trace:
    """Pure-compute streams: golden total time = blocks * cost (+ i-fetch)."""
    tb = TraceBuilder(num_tiles)
    for t in range(num_tiles):
        pc = 0x400000
        for _ in range(blocks):
            tb.compute(t, cost_cycles, icount_per_block, pc=pc)
            pc += icount_per_block * ICACHE_BYTES_PER_INSTRUCTION
    return tb.build()


def gen_private_mem(num_tiles: int, accesses: int = 1000,
                    working_set_kb: int = 16, read_fraction: float = 0.7,
                    compute_cycles: int = 5, seed: int = 0,
                    line_size: int = 64) -> Trace:
    """Uniform-random accesses within each tile's private working set.

    With working_set <= L1D size this is an all-hit stream; larger working
    sets sweep the L1/L2/DRAM hit-rate curve — the same knob the reference's
    synthetic_memory benchmark exposes.
    """
    rng = np.random.default_rng(seed)
    tb = TraceBuilder(num_tiles, line_size=line_size)
    span = working_set_kb * 1024
    for t in range(num_tiles):
        base = PRIVATE_BASE + t * PRIVATE_SPAN
        offsets = (rng.integers(0, span // 8, size=accesses) * 8)
        reads = rng.random(accesses) < read_fraction
        for i in range(accesses):
            if compute_cycles:
                tb.compute(t, compute_cycles, compute_cycles)
            a = int(base + offsets[i])
            if reads[i]:
                tb.read(t, a, 8)
            else:
                tb.write(t, a, 8)
    return tb.build()


def gen_stream(num_tiles: int, lines: int = 2048, passes: int = 1,
               write: bool = False, line_size: int = 64) -> Trace:
    """Sequential streaming over a private buffer (DRAM-bandwidth shaped)."""
    tb = TraceBuilder(num_tiles, line_size=line_size)
    for t in range(num_tiles):
        base = PRIVATE_BASE + t * PRIVATE_SPAN
        for _ in range(passes):
            for i in range(lines):
                a = base + i * line_size
                if write:
                    tb.write(t, a, 8)
                else:
                    tb.read(t, a, 8)
    return tb.build()


def gen_shared_readers(num_tiles: int, lines: int = 64, passes: int = 4,
                       line_size: int = 64) -> Trace:
    """All tiles read the same shared region: exercises S-state sharing
    (every line ends with all tiles in the sharer bitmap)."""
    tb = TraceBuilder(num_tiles, line_size=line_size)
    for t in range(num_tiles):
        for _ in range(passes):
            for i in range(lines):
                tb.read(t, SHARED_BASE + i * line_size, 8)
    return tb.build()


def gen_migratory(num_tiles: int, lines: int = 16, rounds: int = 8,
                  line_size: int = 64) -> Trace:
    """Migratory sharing: tiles take turns read-modify-writing shared lines
    (exercises M->flush->M ping-pong, the reference's shared_mem_test
    pattern, tests/unit/shared_mem_test*/)."""
    tb = TraceBuilder(num_tiles, line_size=line_size)
    for r in range(rounds):
        for t in range(num_tiles):
            for i in range(lines):
                a = SHARED_BASE + i * line_size
                tb.read(t, a, 8)
                tb.write(t, a, 8)
            tb.compute(t, 20, 20)
    return tb.build()


def gen_ping_pong(num_tiles: int, messages: int = 32,
                  size: int = 64) -> Trace:
    """CAPI ping-pong between tile pairs (reference: tests/apps/ping_pong)."""
    if num_tiles % 2:
        raise ValueError("ping_pong needs an even tile count")
    tb = TraceBuilder(num_tiles)
    for a in range(0, num_tiles, 2):
        b = a + 1
        for _ in range(messages):
            tb.send(a, b, size)
            tb.recv(b, a, size)
            tb.send(b, a, size)
            tb.recv(a, b, size)
    return tb.build()


def gen_barrier_compute(num_tiles: int, phases: int = 8,
                        max_cost: int = 400, seed: int = 0) -> Trace:
    """Unbalanced compute phases separated by global barriers (exercises the
    sync server path, reference: common/system/sync_server.h SimBarrier)."""
    rng = np.random.default_rng(seed)
    tb = TraceBuilder(num_tiles)
    for p in range(phases):
        costs = rng.integers(max_cost // 4, max_cost, size=num_tiles)
        for t in range(num_tiles):
            tb.compute(t, int(costs[t]), int(costs[t]))
            tb.barrier(t, 0, num_tiles)
    return tb.build()


def gen_threads_oversubscribed(num_streams: int, compute_blocks: int = 8,
                               cost_cycles: int = 100,
                               yields: int = 2) -> Trace:
    """More app threads than tiles — the ThreadScheduler workload
    (reference: every PARSEC config runs 64 threads on fewer cores,
    tests/Makefile.parsec:8-26; scheduling per thread_scheduler.h:30-56).

    Streams split in halves: parents (first half) spawn one child each,
    compute with private-memory traffic, join the child, and finish;
    children gate on THREAD_START, compute with explicit YIELDs (so
    rotation exercises both the voluntary and preemptive paths), and
    finish.  Run it with ``general/total_cores < num_streams`` and
    ``max_threads_per_core >= 2``.
    """
    assert num_streams % 2 == 0
    half = num_streams // 2
    tb = TraceBuilder(num_streams)
    for s in range(half):
        child = half + s
        tb.compute(s, cost_cycles, cost_cycles)
        tb.spawn(s, child, cost_cycles=10)
        base = PRIVATE_BASE + s * PRIVATE_SPAN
        for b in range(compute_blocks):
            tb.compute(s, cost_cycles, cost_cycles)
            tb.read(s, base + (b * 64) % 4096)
        tb.join(s, child)
        tb.done(s)
    for s in range(half, num_streams):
        tb.thread_start(s)
        base = PRIVATE_BASE + s * PRIVATE_SPAN
        for b in range(compute_blocks):
            tb.compute(s, cost_cycles, cost_cycles)
            tb.write(s, base + (b * 64) % 4096)
            if yields and b % max(compute_blocks // yields, 1) == 0:
                tb.thread_yield(s)
        tb.done(s)
    return tb.build()


def gen_lock_contention(num_tiles: int, acquisitions: int = 16,
                        critical_cycles: int = 50) -> Trace:
    """All tiles repeatedly take one mutex (reference: tests/unit/many_mutex)."""
    tb = TraceBuilder(num_tiles)
    for k in range(acquisitions):
        for t in range(num_tiles):
            tb.mutex_lock(t, 0)
            tb.compute(t, critical_cycles, critical_cycles)
            tb.mutex_unlock(t, 0)
    return tb.build()


def gen_system_events(num_tiles: int, seed: int = 0,
                      builder=TraceBuilder) -> Trace:
    """Private and shared memory traffic around the system event kinds:
    ATOMICs on a few shared lines, cond-variable producer/consumer pairs,
    a SYSCALL of every class (MMAP, BRK and MUNMAP with their VM
    payloads), a mid-trace DVFS_SET of the core on every eighth tile, a
    DISABLE_MODELS ... ENABLE_MODELS stretch on tile 0, STALLs and SYNC
    rows.

    Tiles pair up: the even tile of a pair parks on COND_WAIT (holding
    and releasing its pair's mutex) early in its stream, the odd tile
    stalls past 40 us, then takes the mutex and signals (even pairs) or
    broadcasts (odd pairs) while it holds it.  ``builder`` is the
    TraceBuilder class that emits the events (SYNC has no builder method
    and goes through ``_emit``), so that another package's builder makes
    the same arrays."""
    if num_tiles % 2 or num_tiles < 4:
        raise ValueError("system_events needs an even tile count >= 4")
    rng = np.random.default_rng(seed)
    tb = builder(num_tiles)
    ncls = len(SyscallClass)

    def private_pass(t, writes):
        base = PRIVATE_BASE + t * PRIVATE_SPAN
        for i in range(8):
            cost = int(rng.integers(20, 120))
            tb.compute(t, cost, cost // 2 + 1)
            if writes and i % 2:
                tb.write(t, base + 64 * i)
            else:
                tb.read(t, base + 64 * i)
        tb.branch(t, bool(rng.integers(0, 2)))

    for t in range(num_tiles):
        pair, consumer = t // 2, t % 2 == 0
        mutex, cond = pair % 64, pair % 64
        private_pass(t, writes=False)
        if consumer:
            tb.mutex_lock(t, mutex)
            tb.cond_wait(t, cond, mutex)
            tb.mutex_unlock(t, mutex)
        if t == 0:
            tb.disable_models(t)
        private_pass(t, writes=True)
        if t == 0:
            tb.enable_models(t)
        if t % 8 == 3:
            tb.dvfs_set(t, int(DVFSModule.CORE), 1.5)
        for k in range(2):
            tb.atomic(t, SHARED_BASE + 64 * int(rng.integers(0, 4)))
        for cls in (t % ncls, (t + 8) % ncls):
            vm_arg = {SyscallClass.MMAP: 4096 * (t + 1),
                      SyscallClass.MUNMAP: 4096,
                      SyscallClass.BRK: (1 << 16) + 4096 * t}.get(
                SyscallClass(cls), 0)
            tb.syscall(t, SyscallClass(cls), nbytes=int(rng.integers(0, 256)),
                       vm_arg=vm_arg)
        private_pass(t, writes=True)
        tb.stall_until(t, 20_000_000 + 50_000 * t)
        tb._emit(t, EventOp.SYNC, 21_000_000 + 40_000 * t,
                 int(rng.integers(1, 200)), 0)
        if not consumer:
            tb.stall_until(t, 40_000_000 + 100_000 * pair)
            tb.mutex_lock(t, mutex)
            if pair % 2:
                tb.cond_broadcast(t, cond)
            else:
                tb.cond_signal(t, cond)
            tb.mutex_unlock(t, mutex)
        private_pass(t, writes=False)
    return tb.build()


def gen_radix(num_tiles: int, keys_per_tile: int = 4096, radix: int = 256,
              seed: int = 0, line_size: int = 64,
              max_events_per_tile: int | None = None) -> Trace:
    """Address-accurate SPLASH-2 radix-sort trace (reference:
    tests/benchmarks/radix/radix.C vendored from SPLASH-2).

    Reproduces the memory behavior of one digit-pass of the parallel radix
    sort: (1) local histogram of each tile's keys (sequential key reads +
    scattered count increments), (2) barrier, (3) parallel prefix over the
    per-tile histograms (reads of other tiles' shared count arrays),
    (4) barrier, (5) permutation writes of keys to their globally-ranked
    positions (scattered writes into the shared output array).  Compute
    events between accesses model the ~10 arithmetic ops per key of the
    original loop bodies.
    """
    rng = np.random.default_rng(seed)
    tb = TraceBuilder(num_tiles, line_size=line_size)
    n_total = keys_per_tile * num_tiles
    keys = rng.integers(0, radix, size=(num_tiles, keys_per_tile))

    key_array = PRIVATE_BASE           # per-tile key input (private span)
    hist_array = SHARED_BASE           # [num_tiles, radix] shared histograms
    out_array = SHARED_BASE + 0x400_0000  # shared sorted output

    # Global ranks for the permutation phase (computed once, host side).
    flat = keys.reshape(-1)
    order = np.argsort(flat, kind="stable")
    rank = np.empty_like(order)
    rank[order] = np.arange(n_total)
    rank = rank.reshape(num_tiles, keys_per_tile)

    for t in range(num_tiles):
        base = key_array + t * PRIVATE_SPAN
        # Phase 1: histogram — read key, bump count.
        for i in range(keys_per_tile):
            tb.compute(t, 4, 4)
            tb.read(t, base + i * 8, 8)
            d = int(keys[t, i])
            tb.write(t, hist_array + (t * radix + d) * 8, 8)
        tb.barrier(t, 0, num_tiles)
        # Phase 3: binary-tree parallel prefix over the per-tile
        # histograms (the reference's prefix_tree of 2P nodes,
        # radix.C:79,507-575: each processor merges its pair's densities
        # up the tree and reads rank offsets back down) — O(radix log P)
        # work per tile, NOT O(radix x P): the all-pairs version this
        # replaces made the 1024-tile trace 16x denser than the
        # algorithm it models.
        stride = max(1, line_size // 8)
        tree_array = SHARED_BASE + 0x200_0000   # [2P, radix] tree nodes
        levels = max(1, (num_tiles - 1).bit_length())
        node_base = 0
        width = num_tiles
        for lvl in range(levels):
            pair = t >> (lvl + 1)
            # ONE representative tile per pair merges (the pair's lowest
            # tile): read both child nodes, write the parent.  The
            # reference lets the later arrival merge; which sibling does
            # it is timing detail — the modeled traffic is one merge per
            # pair per level, O(T) total merges.
            if t % (1 << (lvl + 1)) == 0 and width > 1:
                sib = node_base + (t >> lvl) + 1
                parent = node_base + width + pair
                for d in range(0, radix, stride):
                    tb.compute(t, 2, 2)
                    tb.read(t, tree_array + (sib * radix + d) * 8, 8)
                    tb.write(t, tree_array + (parent * radix + d) * 8, 8)
            node_base += width
            width = max(1, width // 2)
        tb.barrier(t, 1, num_tiles)
        # Down-sweep: read this tile's rank offsets from its ancestor
        # nodes (log P nodes, one cache line of densities each).
        node_base = 0
        width = num_tiles
        for lvl in range(levels):
            node = node_base + (t >> lvl)
            tb.compute(t, 2, 2)
            tb.read(t, tree_array + (node * radix) * 8, 8)
            node_base += width
            width = max(1, width // 2)
        # Phase 5: permutation — read key, write to ranked slot.
        for i in range(keys_per_tile):
            tb.compute(t, 6, 6)
            tb.read(t, base + i * 8, 8)
            tb.write(t, out_array + int(rank[t, i]) * 8, 8)
        tb.barrier(t, 2, num_tiles)
    trace = tb.build()
    if max_events_per_tile is not None and trace.num_events > max_events_per_tile:
        raise ValueError(
            f"radix trace has {trace.num_events} events/tile > cap")
    return trace


def gen_fft(num_tiles: int, points_per_tile: int = 1024,
            line_size: int = 64, writeback: bool = False) -> Trace:
    """Address-accurate SPLASH-2 FFT trace (reference:
    tests/benchmarks/fft/fft.C — the six-step 1D radix-sqrt(n) FFT).

    Each tile owns ``points_per_tile`` complex points (16 B each) of the
    sqrt(n) x sqrt(n) matrix, laid out in a shared array.  The six-step
    structure is: transpose, local 1D FFTs, transpose, local FFTs,
    transpose — the transposes are the all-to-all: each tile reads a
    block from EVERY other tile's partition and writes into its own,
    which is the communication signature FFT stresses at 256 tiles
    (BASELINE config 2).

    ``writeback=True`` alternates the transpose DIRECTION (src -> dst,
    then dst -> src, ...), as fft.C's ping-ponging x/trans arrays do:
    each transpose then WRITES lines the previous one left read-shared
    across up to line_size/16 tiles, so the trace carries the EX-on-
    multi-sharer invalidation fan-outs of the real kernel.  Default
    False preserves the historical one-directional trace bit-exactly
    (the equality-gate fixtures are pinned to it).
    """
    tb = TraceBuilder(num_tiles, line_size=line_size)
    elem = 16                                  # complex double
    part = points_per_tile * elem              # bytes per tile partition
    src = SHARED_BASE                          # shared matrix
    dst = SHARED_BASE + 0x1000_0000            # transpose target
    # points exchanged with each partner per transpose
    blk = max(1, points_per_tile // max(1, num_tiles))
    log_n = max(1, (points_per_tile * num_tiles).bit_length() - 1)

    def transpose(t, phase, a_from=src, a_to=dst):
        for p in range(num_tiles):
            for i in range(blk):
                a_src = a_from + p * part + (t * blk + i) * elem
                a_dst = a_to + t * part + (p * blk + i) * elem
                tb.compute(t, 2, 2)
                tb.read(t, a_src, elem)
                tb.write(t, a_dst, elem)
        tb.barrier(t, phase, num_tiles)

    def local_fft(t, phase, base=dst):
        # 1D FFTs over the tile's own rows: ~5 log2(n) flops per point,
        # sequential read-modify-write sweep.
        for i in range(points_per_tile):
            tb.compute(t, 5 * log_n, 5 * log_n)
            a = base + t * part + i * elem
            tb.read(t, a, elem)
            tb.write(t, a, elem)
        tb.barrier(t, phase, num_tiles)

    for t in range(num_tiles):
        if writeback:
            transpose(t, 0, src, dst)
            local_fft(t, 1, dst)
            transpose(t, 2, dst, src)
            local_fft(t, 3, src)
            transpose(t, 4, src, dst)
        else:
            transpose(t, 0)
            local_fft(t, 1)
            transpose(t, 2)
            local_fft(t, 3)
            transpose(t, 4)
    return tb.build()


def gen_lu(num_tiles: int, matrix_blocks: int = 8, block_lines: int = 4,
           line_size: int = 64) -> Trace:
    """Address-accurate SPLASH-2 LU trace (reference:
    tests/benchmarks/lu/contiguous_blocks/lu.C).

    The B x B block-decomposed factorization: at step k the diagonal
    block's owner factors it; owners of perimeter blocks (row/column k)
    then read the DIAGONAL block and update; owners of interior blocks
    read their two perimeter blocks and update — producer-consumer
    sharing at block granularity, the directory-MSI stress of BASELINE
    config 2.  Blocks are assigned round-robin (2D scatter).
    """
    tb = TraceBuilder(num_tiles, line_size=line_size)
    nb = matrix_blocks
    blk_bytes = block_lines * line_size

    def block_addr(i, j):
        return SHARED_BASE + (i * nb + j) * blk_bytes

    def owner(i, j):
        return (i * nb + j) % num_tiles

    def sweep(t, i, j, reads, writes=True, flops=8):
        """Read the listed source blocks line by line, update own block."""
        for li in range(block_lines):
            for (ri, rj) in reads:
                tb.read(t, block_addr(ri, rj) + li * line_size, 8)
            tb.compute(t, flops * len(reads) + flops, flops)
            if writes:
                tb.write(t, block_addr(i, j) + li * line_size, 8)

    bar = 0
    for k in range(nb):
        # diagonal factorization by its owner
        t = owner(k, k)
        sweep(t, k, k, reads=[(k, k)], flops=12)
        for tt in range(num_tiles):
            tb.barrier(tt, bar % 16, num_tiles)
        bar += 1
        # perimeter updates read the diagonal block
        for j in range(k + 1, nb):
            sweep(owner(k, j), k, j, reads=[(k, k)])
            sweep(owner(j, k), j, k, reads=[(k, k)])
        for tt in range(num_tiles):
            tb.barrier(tt, bar % 16, num_tiles)
        bar += 1
        # interior updates read their row/column perimeter blocks
        for i in range(k + 1, nb):
            for j in range(k + 1, nb):
                sweep(owner(i, j), i, j, reads=[(i, k), (k, j)])
        for tt in range(num_tiles):
            tb.barrier(tt, bar % 16, num_tiles)
        bar += 1
    return tb.build()


def gen_barnes(num_tiles: int, bodies_per_tile: int = 64,
               interactions_per_body: int = 16, iterations: int = 2,
               hot_cells: int = 32, seed: int = 0,
               line_size: int = 64) -> Trace:
    """Address-accurate SPLASH-2 Barnes-Hut trace (reference:
    tests/benchmarks/barnes/).

    Per iteration: (1) tree build — every tile writes its bodies' cell
    links into the shared tree region (scattered shared writes);
    (2) force computation — for each body, walk the tree: reads of the
    HOT top-level cells (read by all tiles — wide sharing) mixed with
    random deeper body records (sparse sharing); (3) position update —
    private writes.  Captures the irregular read-mostly sharing that
    makes barnes a directory stress.
    """
    rng = np.random.default_rng(seed)
    tb = TraceBuilder(num_tiles, line_size=line_size)
    body_bytes = 64                          # one body record = one line
    tree = SHARED_BASE                       # shared cell array
    bodies = SHARED_BASE + 0x1000_0000       # shared body array
    n_bodies = num_tiles * bodies_per_tile

    for it in range(iterations):
        for t in range(num_tiles):
            # (1) tree build: insert own bodies (scattered shared writes)
            for i in range(bodies_per_tile):
                cell = int(rng.integers(0, hot_cells * 8))
                tb.compute(t, 10, 10)
                tb.write(t, tree + cell * body_bytes, 8)
            tb.barrier(t, (3 * it) % 16, num_tiles)
            # (2) force computation: hot-cell reads + random body reads
            for i in range(bodies_per_tile):
                for k in range(interactions_per_body):
                    if k % 4 == 0:      # top-of-tree cell, read by all
                        cell = int(rng.integers(0, hot_cells))
                        tb.read(t, tree + cell * body_bytes, 8)
                    else:               # random remote body
                        b = int(rng.integers(0, n_bodies))
                        tb.read(t, bodies + b * body_bytes, 8)
                    tb.compute(t, 12, 12)
            tb.barrier(t, (3 * it + 1) % 16, num_tiles)
            # (3) update own bodies
            for i in range(bodies_per_tile):
                own = t * bodies_per_tile + i
                tb.compute(t, 8, 8)
                tb.write(t, bodies + own * body_bytes, 8)
            tb.barrier(t, (3 * it + 2) % 16, num_tiles)
    return tb.build()


GENERATORS = {
    "compute": gen_compute,
    "private_mem": gen_private_mem,
    "stream": gen_stream,
    "shared_readers": gen_shared_readers,
    "migratory": gen_migratory,
    "ping_pong": gen_ping_pong,
    "barrier_compute": gen_barrier_compute,
    "lock_contention": gen_lock_contention,
    "radix": gen_radix,
    "fft": gen_fft,
    "lu": gen_lu,
    "barnes": gen_barnes,
}
