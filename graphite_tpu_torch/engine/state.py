"""Simulation state: one NamedTuple of [num_tiles, ...] tensors.

Counterpart of ``graphite_tpu/engine/state.py`` with the SAME field names,
shapes and dtypes, so a state converts one-to-one between the packages
(graphite_tpu_torch/convert.py).  The one dtype that differs is the
directory sharer bitmap: ``uint64`` in JAX, ``int64`` with the same bits
here (torch's uint64 support on CUDA is thin).  The miss-chain bank
(``mq_*``, ``chain_*``) is [P, T] at ``tpu/miss_chain = P`` and zero-size
at P = 0; the CAPI channel leaves are [T, T] and [D, T, T] when the
trace sends or receives, zero-size otherwise.  With more trace streams
than tiles the ThreadScheduler's seat leaves are [T] and its stream
store [S]; at one stream per tile both are zero-size.  The iocoom
register scoreboard is [32, T] under iocoom cores (uniform or mixed)
and [0, T] otherwise; the miss-type filters are [T, MISS_FILTER_SLOTS]
with ``track_miss_types`` on and [1, 1] otherwise.  Leaves that belong
to later slices of the port (telemetry) keep the shapes ``make_state``
gives them at this config, which is zero-size or unused.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from graphite_tpu_torch.engine import cache as cachemod
from graphite_tpu_torch.events.schema import Trace
from graphite_tpu_torch.isa import DVFSModule
from graphite_tpu_torch.params import SimParams

# Pending-request kinds (a tile blocks on at most one at a time — in-order
# cores block inside Core::initiateMemoryAccess, reference core.cc:139).
PEND_NONE = 0
PEND_SH_REQ = 1     # read miss -> directory SH_REQ (shmem_msg.h:14-28)
PEND_EX_REQ = 2     # write/atomic miss or S-upgrade -> EX_REQ
PEND_IFETCH = 3     # instruction-fetch L2 miss (read-only SH_REQ)
PEND_RECV = 4       # blocking user-network receive (CAPI)
PEND_BARRIER = 5    # SimBarrier wait
PEND_MUTEX = 6      # SimMutex acquire
PEND_SEND = 7       # user-network send waiting for channel-buffer space
#   (models the finite receive-side buffering the reference gets from its
#   per-tile net queues; CAPI sends block in Network::netSend when the
#   transport back-pressures)
PEND_COND = 8       # SimCond wait (mutex released; wakes on signal, then
#   transforms into PEND_MUTEX for the re-acquire)
PEND_JOIN = 9       # blocked until the named tile's stream is DONE
PEND_START = 10     # stream gated on being SPAWNed
PEND_CSIG = 11      # posted signal TOKEN: the signaler parks until its
#   signal is consumed by a waiter or provably lost — the parked entry IS
#   the token (exact per-token timestamp, no collapsing), and the
#   signaler's ack completion is timestamp-based so the extra engine
#   passes cost no simulated time
PEND_CBC = 12       # posted broadcast token (same mechanism)

NUM_DVFS_MODULES = len(DVFSModule)

NUM_CONDS = 64      # cond-var id space (like the mutexes; ids clip)

# Directed-link horizons per tile (engine/noc_flight.py NUM_DIRS).
NUM_LINK_DIRS = 4


class Counters(NamedTuple):
    """Per-tile event counters ([T] int64 each) — the data behind the
    end-of-run summary (reference: each component's outputSummary(),
    e.g. cache counters in cache.cc, network_model.h:73)."""

    icount: torch.Tensor
    l1i_access: torch.Tensor
    l1i_miss: torch.Tensor
    l1d_read: torch.Tensor
    l1d_read_miss: torch.Tensor
    l1d_write: torch.Tensor
    l1d_write_miss: torch.Tensor
    l2_access: torch.Tensor
    l2_miss: torch.Tensor
    branches: torch.Tensor
    mispredicts: torch.Tensor
    dir_sh_req: torch.Tensor      # SH_REQ served at this tile's directory slice
    dir_ex_req: torch.Tensor
    dir_invalidations: torch.Tensor   # INV_REQ messages sent from this slice
    dir_writebacks: torch.Tensor      # WB/FLUSH data returns to this slice
    dir_forwards: torch.Tensor        # owner cache-to-cache forwards that
    #   skipped DRAM (MOSI O-state forwards; always 0 under MSI)
    dir_evictions: torch.Tensor       # directory-cache entry evictions
    dir_deferrals: torch.Tensor       # deferral events: one per round a
    #   request is pushed back by the way-slot election or the fan-out
    #   budget, plus one per request still unresolved after a full resolve
    #   pass (visibility into hot-line saturation)
    dram_reads: torch.Tensor          # at this tile's memory controller
    dram_writes: torch.Tensor
    net_mem_pkts: torch.Tensor        # memory-network packets this tile sent
    net_mem_flits: torch.Tensor
    net_link_wait_ps: torch.Tensor    # per-link queueing delay this tile's
    #   requests accumulated en route (emesh_hop_by_hop contention only)
    net_user_pkts: torch.Tensor
    net_user_flits: torch.Tensor
    sends: torch.Tensor
    recvs: torch.Tensor
    barriers: torch.Tensor
    mutex_acquires: torch.Tensor
    cond_waits: torch.Tensor          # COND_WAIT parks
    cond_signals: torch.Tensor        # signals + broadcasts posted
    spawns: torch.Tensor              # SPAWN events issued by this tile
    joins: torch.Tensor               # completed JOINs
    syscalls: torch.Tensor            # SYSCALL events served via the MCP
    syscall_ps: torch.Tensor          # time spent in syscall round trips
    l2_miss_cold: torch.Tensor        # miss-type classification (cache.h:
    l2_miss_capacity: torch.Tensor    #   45-49): first-touch / evicted /
    l2_miss_sharing: torch.Tensor     #   coherence-invalidated
    mem_stall_ps: torch.Tensor        # time blocked on remote memory
    sync_stall_ps: torch.Tensor       # time blocked on sync/recv
    chain_fanout_served: torch.Tensor  # invalidation fan-out heads served
    #   INSIDE the chain replay (round 9's batched INV leg; 0 with
    #   tpu/fanout_replay off or miss_chain 0)
    chain_fallback: torch.Tensor      # chain heads that hard-stopped out
    #   of the replay into the one-element-per-round fallback — the
    #   fallback-occupancy counter PROFILE.md's round-9 table reads


def make_counters(num_tiles: int, device) -> Counters:
    return Counters(**{f: torch.zeros(num_tiles, dtype=torch.int64,
                                      device=device)
                       for f in Counters._fields})


class TraceArrays(NamedTuple):
    """Device-resident trace: int32 (op, arg, arg2) stacked [3, S, N]
    beside the int64 byte addresses [S, N], one row per trace stream
    (S = T at one stream per tile; under the ThreadScheduler each tile
    reads its seated stream's row, ``SimState.seat_stream``).
    ``base``/``n_total`` (the streamed-segment frame of the JAX package)
    stay None: streaming ingest is a later slice."""

    addr: torch.Tensor  # [S, N] int64 byte address
    meta: torch.Tensor  # [3, S, N] int32: (op, arg, arg2)
    base: Optional[torch.Tensor] = None
    n_total: Optional[int] = None

    @property
    def num_events(self):
        if self.n_total is not None:
            return self.n_total
        return self.addr.shape[1]

    @classmethod
    def from_trace(cls, trace: Trace, device) -> "TraceArrays":
        addr = np.asarray(trace.addr, dtype=np.int64)
        if addr.max(initial=0) >= (1 << 37):
            raise ValueError(
                "trace addresses must be < 2^37 (int32 line-id layout)")
        meta = np.stack([
            np.asarray(trace.ops, dtype=np.int32),
            np.asarray(trace.arg, dtype=np.int32),
            np.asarray(trace.arg2, dtype=np.int32),
        ], axis=0)
        return cls(addr=torch.from_numpy(addr).to(device),
                   meta=torch.from_numpy(meta).to(device))


_DIR_OWNER_BITS = 13   # owner+1, supports up to 8191 tiles
_DIR_OWNER_SHIFT = 3

# Packed directory-entry word (int64), ONE array instead of the round-3
# tags/meta/stamp triple — a directory probe is one gather and an entry
# write one scatter (gather/scatter ops on this hardware cost per
# *operation*, so collapsing 3 arrays into 1 cuts the conflict-round cost
# by the same factor):
#
#     bits  0..2    entry state (I/S/O/E/M — directory_state.h roles)
#     bits  3..15   owner tile + 1 (0 = none)
#     bits 16..32   replacement stamp (17-bit wrapping round counter;
#                   a wrap only perturbs LRU victim choice, never
#                   correctness — same argument as cache.py STAMP_BITS)
#     bits 33..63   tag (31-bit line id; frontend asserts addr < 2^37)
#
# Bits 0..15 are exactly the legacy int32 "meta" layout, so
# dir_meta_state/dir_meta_owner keep working on the `dir_meta` view.
DIR_STAMP_BITS = 17
_DIR_STAMP_SHIFT = 16
_DIR_STAMP_FIELD = (1 << DIR_STAMP_BITS) - 1
_DIR_TAG_SHIFT = _DIR_STAMP_SHIFT + DIR_STAMP_BITS  # 33
_DIR_META_MASK = (1 << _DIR_STAMP_SHIFT) - 1


def dword_pack(tag, stamp, state, owner):
    """(tag, stamp, state, owner) -> packed int64 directory word."""
    def i64(x):
        return x.to(torch.int64) if isinstance(x, torch.Tensor) \
            else torch.as_tensor(x, dtype=torch.int64, device=tag.device)
    return (i64(tag) << _DIR_TAG_SHIFT) \
        | ((i64(stamp) & _DIR_STAMP_FIELD) << _DIR_STAMP_SHIFT) \
        | ((i64(owner) + 1) << _DIR_OWNER_SHIFT) \
        | i64(state)


def dword_state(word):
    return (word & 7).to(torch.int32)


def dword_owner(word):
    return (((word >> _DIR_OWNER_SHIFT)
             & ((1 << _DIR_OWNER_BITS) - 1)) - 1).to(torch.int32)


def dword_stamp(word):
    return ((word >> _DIR_STAMP_SHIFT) & _DIR_STAMP_FIELD).to(torch.int32)


def dword_tag(word):
    return (word >> _DIR_TAG_SHIFT).to(torch.int32)


def dword_with_meta(word, state, owner):
    """Replace the (state, owner) fields, keeping tag + stamp."""
    def i64(x):
        return x.to(torch.int64) if isinstance(x, torch.Tensor) \
            else torch.as_tensor(x, dtype=torch.int64, device=word.device)
    return (word & ~_DIR_META_MASK) \
        | ((i64(owner) + 1) << _DIR_OWNER_SHIFT) \
        | i64(state)


class SimState(NamedTuple):
    """All mutable simulation state (same fields as the JAX package)."""

    # -- core (reference: CoreModel per-tile time/queues, core_model.h:19-146)
    clock: torch.Tensor        # [T] int64 ps — the per-tile target clock
    cursor: torch.Tensor       # [T] int32 — next trace event index
    done: torch.Tensor         # [T] bool
    boundary: torch.Tensor     # [] int64 ps — current lax-barrier quantum end

    # -- pending remote operation (at most one per tile)
    pend_kind: torch.Tensor    # [T] int32 PEND_*
    pend_addr: torch.Tensor    # [T] int64 byte address / object id
    pend_issue: torch.Tensor   # [T] int64 ps when the request left the tile
    pend_aux: torch.Tensor     # [T] int32 (recv src / barrier participants)
    pend_extra: torch.Tensor   # [T] int64 ps of local cost to add on top of
    #   the resolved remote latency (e.g. a blocked COMPUTE block's own
    #   cost + fetch time, an atomic's RMW cycle)

    # -- cached block-window trace slice (tpu/window_cache; engine/core.py
    # _block_retire).  The window phase used to re-gather its [T, K] event
    # slice from the full device trace EVERY round; miss-dominated traces
    # retire ~1.4 events/tile/round, so ~90% of that HBM traffic re-read
    # bytes fetched the round before (PROFILE.md lever 2).  Instead a
    # [T, WC] slice (WC = 4K; 2K before round 9's boundary-spanning
    # windows raised per-round consumption) is gathered once and advances with the
    # cursor: rounds read from this small resident cache, and a full
    # re-gather happens only when some ACTIVE tile's next-K events fall
    # outside its cached span (or its seat rotated) — a guarded lax.cond,
    # so cache-hit rounds never touch the trace.  Values are identical to
    # a direct gather by construction (same clamped indices), so timing,
    # counters, and round counts are bit-identical (tests/
    # test_block_equivalence.py round-identity case).  Zero-width when
    # the cache or the window phase is disabled.
    win_meta: torch.Tensor     # [3, T, WC] int32 (op, arg, arg2)
    win_addr: torch.Tensor     # [T, WC] int64
    win_base: torch.Tensor     # [T] int32 cursor at gather time (large
    #   negative = invalid, forces the first refresh)
    win_seat: torch.Tensor     # [T] int32 seat_stream at gather time
    #   (seat rotation invalidates a tile's cached rows; -1 when the
    #   scheduler is off)

    # -- branch predictor (reference: one_bit_branch_predictor.cc)
    bp_table: torch.Tensor     # [T, bp_size] bool — last outcome per slot

    # -- caches (private L1I/L1D/L2 per tile)
    l1i: cachemod.CacheArrays
    l1d: cachemod.CacheArrays
    l2: cachemod.CacheArrays

    # -- DVFS module clock periods (reference: dvfs_manager.h:19-88 keeps
    # per-module frequencies; the engine stores the derived integer period
    # so the hot loops never touch floating point — float64 is emulated on
    # TPU and was the single largest per-slot cost)
    period_ps: torch.Tensor    # [T, NUM_DVFS_MODULES] int32 ps per cycle

    # -- directory slices (home-tile-indexed; reference: directory_cache.cc)
    # The whole entry (tag | stamp | owner | state) is packed into ONE
    # int64 word (see dword_pack): a probe is one gather, a write one
    # scatter.  The (tile, set) axes are stored PRE-FLATTENED — every
    # access indexes by the flat home*ndsets + dset id, and a
    # [.., T, dsets] layout forced XLA to materialize a full-array reshape
    # copy per conflict round (profiled at ~4.5 ms per round on the 512 MB
    # 1024-tile sharer bitmap).
    dir_word: torch.Tensor     # [dassoc, T*dsets] int64 packed entries
    dir_sharers: torch.Tensor  # [W*dassoc, T*dsets] uint64 sharer bitmaps —
    #   plane (w, way) lives at row w*dassoc + way.  Two-dimensional so
    #   every sharer update is a (row, col)-indexed single-word scatter;
    #   3-D layouts made XLA:TPU serialize the scatters into
    #   per-(plane, way) dynamic-update-slice loops (~30 ms/round at
    #   1024 tiles).  See dir_sharers_view for the unpacked view.

    # -- banked miss chains (tpu/miss_chain > 0; engine/core.py window).
    # BLOCKING semantics (round 7): the block window executes past L2
    # misses on a relative clock, banking each request here WITHOUT
    # installing the line — the resolve pass replays the chain
    # sequentially (engine/resolve.chain_fast_pass), pricing element k+1
    # against the post-element-k directory state and installing each
    # line at serve time; stall-on-use hazards in the window keep later
    # events from observing a banked fill early.  Element k+1's issue =
    # element k's completion + its recorded local delta.  Packed fields:
    #   mq_req    int64: kind (PEND_SH/EX/IFETCH) bits 0-2 | atomic bit 3
    #             | line << 8
    #   mq_delta  int64 ps: element 0 — ABSOLUTE issue time; element k>0 —
    #             issue relative to element k-1's continuation point
    #   mq_extra  int64 ps: local cost folded into the completion
    # chain_rel is the local time accumulated since the last banked
    # element's (not yet known) continuation point; chain_base is the
    # continuation time of the last SERVED element (mq_head of them).
    mq_req: torch.Tensor        # [P, T] int64
    mq_delta: torch.Tensor      # [P, T] int64
    mq_extra: torch.Tensor      # [P, T] int64
    mq_count: torch.Tensor      # [T] int32 banked elements
    mq_head: torch.Tensor       # [T] int32 served elements (< count: mid-chain)
    chain_base: torch.Tensor    # [T] int64 ps
    chain_rel: torch.Tensor     # [T] int64 ps

    # -- iocoom load/store queues (reference: iocoom_core_model.cc:78-;
    # completion-time rings — a load/store miss parks the tile only until
    # the resolve phase PRICES it; under iocoom the core then continues
    # from shortly after issue while the completion occupies a queue slot,
    # and drain points (atomics, sync ops, DONE, branches without
    # speculative loads) wait for the queues' max completion)
    lq_ready: torch.Tensor      # [LQE, T] int64 completion times
    sq_ready: torch.Tensor      # [SQE, T] int64
    lq_next: torch.Tensor       # [T] int32 ring cursor
    sq_next: torch.Tensor       # [T] int32
    # Register scoreboard (iocoom; reference iocoom_core_model.h:82,
    # .cc:119-136): per-register ready times.  Trace events carry
    # compressed 5-bit register annotations (events/schema.py
    # NUM_REGISTERS); reads floor the instruction's issue, writes land
    # completion times.  [0, T] when the core model is 'simple'.
    reg_ready: torch.Tensor     # [NREG, T] int64

    # -- memory controllers (reference: dram_cntlr.h + dram_perf_model.h;
    # queueing per queue_model_history_list.cc — a bounded ring of busy
    # intervals per controller, so requests arriving in idle gaps insert
    # into the past instead of queueing behind a farther-future horizon)
    dram_ring_start: torch.Tensor  # [R, T] int64 busy-interval starts
    dram_ring_end: torch.Tensor    # [R, T] int64 busy-interval ends
    dram_ring_ptr: torch.Tensor    # [T] int32 next ring slot
    # Queue-model accumulators per controller, [6, T] float64:
    # rows 0-3 = m_g_1 service moments (sum_s, sum_s_sq, n, newest
    # arrival — reference queue_model_m_g_1.h:14-20), rows 4-5 = the
    # basic model's moving-average state (ema mean, effective sample
    # count — reference queue_model_basic.cc + moving_average.h).  Only
    # the rows of the configured [dram/queue_model] type are consumed.
    dram_qacc: torch.Tensor         # [6, T] float64

    # -- mesh link horizons (emesh_hop_by_hop contention; reference:
    # per-link queue models in network_model_emesh_hop_by_hop.cc)
    link_free_mem: torch.Tensor  # [NUM_DIRS, T] int64 directed-link horizons
    # User-network link horizons (CAPI data traffic under
    # network/user = emesh_hop_by_hop; [NUM_DIRS, 0] otherwise).  MCP
    # control trips stay zero-load: the reference routes those over the
    # SYSTEM network, which has its own (magic by default) model.
    link_free_user: torch.Tensor

    # -- sync objects, global (reference: sync_server.h SimMutex/SimBarrier/
    # SimCond)
    lock_holder: torch.Tensor   # [NL] int32 holder tile + 1, 0 = free
    lock_free_at: torch.Tensor  # [NL] int64 time the lock was/will be released
    bar_count: torch.Tensor     # [NB] int32 arrivals this generation
    bar_time: torch.Tensor      # [NB] int64 max arrival time this generation
    # (cond-var signal/broadcast tokens live as parked PEND_CSIG/PEND_CBC
    # entries — pend_addr = cond id, pend_issue = MCP arrival — so no
    # dedicated arrays are needed and every token keeps its exact time)

    # -- thread lifecycle (reference: thread_manager.cc spawn/join tables).
    # STREAM-indexed ([S] where S = trace streams; S == T unless the
    # ThreadScheduler multiplexes several streams per tile).
    spawned_at: torch.Tensor    # [S] int64 when this stream was spawned
    #   (-1 = not yet; THREAD_START gates on it)
    done_at: torch.Tensor       # [S] int64 when the stream's DONE retired

    # -- ThreadScheduler seats (reference: thread_scheduler.h:30-56 +
    # round_robin_thread_scheduler.cc).  The engine's [T] context arrays
    # (clock/cursor/pend_*/done above) are SEATS — the running stream of
    # each tile; descheduled streams live in the strm_* store and rotate
    # in round-robin at quantum boundaries (engine/quantum.py
    # schedule_rotate).  All [0]-shaped when S == T (scheduler compiled
    # out; streams pin 1:1 to tiles exactly as before).
    seat_stream: torch.Tensor   # [T] int32 stream seated on each tile
    seat_since: torch.Tensor    # [T] int64 sim time the seat last rotated
    seat_yield: torch.Tensor    # [T] bool YIELD retired since last rotate
    strm_cursor: torch.Tensor   # [S] int32 (valid iff not seated)
    strm_clock: torch.Tensor    # [S] int64
    strm_pend_kind: torch.Tensor   # [S] int32
    strm_pend_addr: torch.Tensor   # [S] int64
    strm_pend_issue: torch.Tensor  # [S] int64
    strm_pend_aux: torch.Tensor    # [S] int32
    strm_pend_extra: torch.Tensor  # [S] int64
    strm_done: torch.Tensor     # [S] bool (kept in sync for seated streams
    #   at every rotation; authoritative for completion)
    strm_key: torch.Tensor      # [S] int64 round-robin queue key (unique;
    #   lowest key among a tile's waiting streams is seated next)

    # -- region of interest (reference: Simulator::enableModels +
    # PerformanceCounterManager broadcast) — one global flag; outside the
    # ROI compute/memory events fast-forward uncosted and uncounted
    models_enabled: torch.Tensor   # [] bool

    # -- periodic sampling ring (reference: StatisticsManager's barrier-
    # clocked sampling + progress trace); fixed capacity, sampled at
    # quantum boundaries crossing the configured interval
    stat_filled: torch.Tensor      # [] int32 samples taken
    stat_next: torch.Tensor        # [] int64 next sample time
    stat_time: torch.Tensor        # [S] int64 sample timestamps
    stat_scalars: torch.Tensor     # [13, S] int64 aggregate series:
    #   (icount, net_mem_flits, net_user_flits, dram_reads, dram_writes,
    #    live_l2_or_slice_lines, sharer_bits [replication], link_wait_ps)
    stat_icount: torch.Tensor      # [S, T] int64 per-tile icount snapshots
    #   (the progress trace; [1, T] dummy when disabled)

    # -- [telemetry] engine-health round metrics (graphite_tpu/obs):
    # sampled in the SAME _maybe_sample take as the rings above (shared
    # stat_filled/stat_time/stat_next bookkeeping).  Zero-size when
    # telemetry is off — the disabled path allocates nothing and the
    # compiled step is unchanged.
    tel_gauges: torch.Tensor       # [len(TEL_SERIES), S] int64 gauge rows
    #   (row order: obs/metrics.TEL_SERIES)
    tel_cursor: torch.Tensor       # [S, T] int32 per-tile trace-cursor
    #   snapshots (per-tile progress in events; SEAT-level — under the
    #   ThreadScheduler a tile's row shows whichever stream is seated)
    tel_pend: torch.Tensor         # [S, T] int32 per-tile pend_kind
    #   snapshots (per-tile occupancy / stall attribution)

    # -- user-network channels (CAPI; reference: common/user/capi.cc)
    # [T, T]-shaped, so allocated only when the trace actually uses CAPI
    # (zero-size dummies otherwise — see make_state(has_capi); a 1024-tile
    # radix run must not carry O(T^2) channel state it never touches)
    ch_sent: torch.Tensor       # [T, T] int32 messages sent src->dst
    ch_recvd: torch.Tensor      # [T, T] int32 messages consumed
    ch_time: torch.Tensor       # [D, T, T] int64 arrival-time ring buffer
    #   (slot axis leads — see the directory layout note)

    # -- engine round counter (stamp source for the timestamp-LRU caches;
    # bumped once per local round and per resolve conflict round)
    round_ctr: torch.Tensor     # [] int32
    # Phase execution counters (device-work attribution for bench.py's
    # per-phase breakdown): window retirements, complex slots, resolve
    # conflict rounds, resolve calls, quantum steps.
    ctr_window: torch.Tensor    # [] int64
    ctr_complex: torch.Tensor   # [] int64
    ctr_conflict: torch.Tensor  # [] int64
    ctr_resolve: torch.Tensor   # [] int64
    ctr_quantum: torch.Tensor   # [] int64
    # Round-12 fast-forward attribution: engaged fast-forward rounds
    # (spans actually committed), quanta that committed at least one
    # span, and total events priced analytically — the bench's
    # ff-quanta-fraction numerator/denominator ride on ctr_ffq vs
    # ctr_quantum.
    ctr_ff: torch.Tensor        # [] int64
    ctr_ffq: torch.Tensor       # [] int64
    ff_events: torch.Tensor     # [] int64

    # -- VMManager accounting (reference: vm_manager.cc bump segments).
    # SYSCALL events carry the payload in the event's addr field
    # (mmap/munmap: length; brk: the requested data-segment size — the
    # delta over the program's initial break); the complex slot
    # folds them in and engine/vm.summarize renders the segment layout.
    vm_brk: torch.Tensor          # [] int64 peak requested data-segment size
    vm_mmap_bytes: torch.Tensor   # [] int64 total bytes mmap'd
    vm_munmap_bytes: torch.Tensor  # [] int64 total bytes munmap'd

    # -- miss-type classification filters ([cache]/track_miss_types,
    # reference cache.h:45-49 cold/capacity/sharing counters).  Per-tile
    # direct-mapped line tables (fmix-hashed, last-writer-wins — a
    # collision can misclassify one miss, never mistime anything):
    # ``seen_filter`` records lines this tile has ever fetched,
    # ``inv_filter`` lines taken away by coherence.  [1, 1] dummies when
    # tracking is off.
    seen_filter: torch.Tensor   # [T, HF] int32 line id + 1 (0 = empty)
    inv_filter: torch.Tensor    # [T, HF] int32

    counters: Counters

    @property
    def has_capi(self) -> bool:
        """Were CAPI channel arrays allocated for this run?"""
        return self.ch_sent.numel() > 0

    @property
    def sched_enabled(self) -> bool:
        """Is the ThreadScheduler active (more streams than tiles)?"""
        return self.seat_stream.numel() > 0

    @property
    def num_streams(self) -> int:
        return self.strm_cursor.shape[0] if self.sched_enabled \
            else self.clock.shape[0]

    def all_done(self) -> torch.Tensor:
        """Scalar bool tensor: every stream is done (under the
        ThreadScheduler the seats hold only the scheduled streams, so
        their flags are merged into the store's)."""
        return self.stream_done().all()

    def stream_done(self) -> torch.Tensor:
        """[S] bool: each trace stream's done flag, the seated streams'
        live flags over the store's."""
        if self.sched_enabled:
            return self.strm_done.index_put((self.seat_stream.long(),),
                                            self.done)
        return self.done

    def seated(self) -> torch.Tensor:
        """[S] bool: the streams seated on a tile (ThreadScheduler)."""
        return torch.zeros_like(self.strm_done).index_put(
            (self.seat_stream.long(),), torch.ones_like(self.done))

    def trace_rows(self) -> torch.Tensor:
        """[T] int64: each tile's trace row, its seated stream under the
        ThreadScheduler."""
        if self.sched_enabled:
            return self.seat_stream.long()
        return torch.arange(self.clock.shape[0], device=self.clock.device)


def init_periods(params: SimParams) -> np.ndarray:
    p = np.zeros((params.num_tiles, NUM_DVFS_MODULES), dtype=np.int32)
    for m in DVFSModule:
        p[:, int(m)] = int(round(1000.0 / params.module_freq_ghz(m)))
    return p


WIN_BASE_INVALID = -(1 << 30)   # win_base sentinel: forces a refresh
DRAM_RING_SLOTS = 8  # busy-interval history per memory controller
MISS_FILTER_SLOTS = 1 << 14   # per-tile miss-type filter entries (2x the
#                               T1 L2's 8192 lines: "seen" memory must
#                               outlast the cache for capacity vs cold)


def _win_cache_width(params: SimParams) -> int:
    """Cached block-window width: 4x the [T, K] window (round 9; was 2x),
    so partial window occupancy carries across sub-rounds and quantum
    cuts — with boundary-spanning windows a tile retires up to K slots
    per round instead of ~7, and a 2K cache forced the guarded full-trace
    refresh nearly every round; at 4K a tile consumes its resident span
    over ~3 full windows before a refresh is due, whatever the boundary
    did to the rounds in between.  Values stay bit-identical to direct
    gathers by construction (same clamped indices), so the width is pure
    cache geometry (checkpoint schema v23 carries the wider arrays).
    0 disables (no cache arrays, per-round trace gathers — the pre-cache
    engine shape)."""
    if params.window_cache and params.block_events > 0:
        return 4 * params.block_events
    return 0


def _dummy_cache(num_tiles: int, device) -> cachemod.CacheArrays:
    """The private-L2 placeholder of the shared-L2 protocols (the slice
    lives in the directory arrays): a [1, T, 1] word array and a [T, 1]
    round-robin pointer, as in the JAX package.  Never probed: the engine
    takes its shared-L2 branches on ``params.shared_l2``."""
    return cachemod.CacheArrays(
        word=torch.zeros((1, num_tiles, 1), dtype=torch.int64,
                         device=device),
        rr_ptr=torch.zeros((num_tiles, 1), dtype=torch.int32,
                           device=device))


def make_state(params: SimParams, device,
               max_mutexes: int = 64,
               max_barriers: int = 16,
               channel_depth: int = 0,
               has_capi: bool = True,
               num_streams: int = 0) -> SimState:
    """The initial state, leaf for leaf the JAX package's ``make_state``
    (shapes and dtypes; sharer bitmaps int64).  Configs outside this
    slice are refused earlier, by ``check_slice``.  ``num_streams`` > T
    engages the ThreadScheduler: streams 0..T-1 start seated on their own
    tile, the rest wait in the stream store."""
    T = params.num_tiles
    S = num_streams if num_streams > 0 else T
    if S < T:
        raise ValueError(
            f"trace has {S} streams but params expect {T} tiles; "
            f"fewer streams than tiles is not supported")
    if S > T * params.max_threads_per_core:
        raise ValueError(
            f"trace has {S} streams > {T} tiles x "
            f"{params.max_threads_per_core} general/max_threads_per_core "
            f"(the reference refuses the same overflow, "
            f"thread_scheduler.cc:577)")
    sched = S > T
    TS = T if sched else 0          # the seat leaves
    SS = S if sched else 0          # the stream store
    if T > (1 << _DIR_OWNER_BITS) - 2:
        raise ValueError(
            f"num_tiles {T} exceeds the packed directory owner field "
            f"({(1 << _DIR_OWNER_BITS) - 2} max)")
    if channel_depth <= 0:
        channel_depth = params.channel_depth
    dev = torch.device(device)

    def z(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def full(shape, v, dtype):
        return torch.full(shape, v, dtype=dtype, device=dev)

    def scalar(v, dtype):
        return torch.tensor(v, dtype=dtype, device=dev)

    i32, i64 = torch.int32, torch.int64
    d_shape = (params.directory.associativity,
               T * params.directory.num_sets)
    W = (T + 63) // 64
    WC = _win_cache_width(params)
    nsamp = 1        # the sample ring's dummy row (sampling is refused)
    return SimState(
        clock=z(T, i64),
        cursor=z(T, i32),
        done=z(T, torch.bool),
        boundary=scalar(params.quantum_ps, i64),
        pend_kind=z(T, i32),
        pend_addr=z(T, i64),
        pend_issue=z(T, i64),
        pend_aux=z(T, i32),
        pend_extra=z(T, i64),
        win_meta=z((3, T, WC), i32),
        win_addr=z((T, WC), i64),
        win_base=full((T,), WIN_BASE_INVALID, i32),
        win_seat=full((T,), -1, i32),
        bp_table=z((T, params.core.bp_size), torch.bool),
        l1i=cachemod.make_cache(T, params.l1i, dev),
        l1d=cachemod.make_cache(T, params.l1d, dev),
        l2=(_dummy_cache(T, dev) if params.shared_l2
            else cachemod.make_cache(T, params.l2, dev)),
        period_ps=torch.from_numpy(init_periods(params)).to(dev),
        dir_word=z(d_shape, i64),
        dir_sharers=z((W * d_shape[0], d_shape[1]), i64),
        mq_req=z((params.miss_chain, T), i64),
        mq_delta=z((params.miss_chain, T), i64),
        mq_extra=z((params.miss_chain, T), i64),
        mq_count=z(T, i32),
        mq_head=z(T, i32),
        chain_base=z(T, i64),
        chain_rel=z(T, i64),
        lq_ready=z((params.core.load_queue_entries, T), i64),
        sq_ready=z((params.core.store_queue_entries, T), i64),
        lq_next=z(T, i32),
        sq_next=z(T, i32),
        reg_ready=z((32 if params.core.model == "iocoom" else 0, T), i64),
        dram_ring_start=z((DRAM_RING_SLOTS, T), i64),
        dram_ring_end=z((DRAM_RING_SLOTS, T), i64),
        dram_ring_ptr=z(T, i32),
        dram_qacc=z((6, T), torch.float64),
        link_free_mem=z((NUM_LINK_DIRS, T), i64),
        link_free_user=z((NUM_LINK_DIRS,
                          T if params.net_user.model == "emesh_hop_by_hop"
                          else 0), i64),
        lock_holder=z(max_mutexes, i32),
        lock_free_at=z(max_mutexes, i64),
        bar_count=z(max_barriers, i32),
        bar_time=z(max_barriers, i64),
        spawned_at=full((S,), -1, i64),
        done_at=z(S, i64),
        seat_stream=torch.arange(TS, dtype=i32, device=dev),
        seat_since=z(TS, i64),
        seat_yield=z(TS, torch.bool),
        strm_cursor=z(SS, i32),
        strm_clock=z(SS, i64),
        strm_pend_kind=z(SS, i32),
        strm_pend_addr=z(SS, i64),
        strm_pend_issue=z(SS, i64),
        strm_pend_aux=z(SS, i32),
        strm_pend_extra=z(SS, i64),
        strm_done=z(SS, torch.bool),
        strm_key=torch.arange(SS, dtype=i64, device=dev),
        models_enabled=scalar(params.models_enabled_at_start, torch.bool),
        stat_filled=scalar(0, i32),
        stat_next=scalar(params.stat_interval_ps, i64),
        stat_time=z(nsamp, i64),
        stat_scalars=z((13, 1), i64),
        stat_icount=z((1, T), i64),
        tel_gauges=z((0, 0), i64),
        tel_cursor=z((0, T), i32),
        tel_pend=z((0, T), i32),
        ch_sent=z((T, T) if has_capi else (0, 0), i32),
        ch_recvd=z((T, T) if has_capi else (0, 0), i32),
        ch_time=z((channel_depth, T, T) if has_capi else (0, 0, 0), i64),
        round_ctr=scalar(0, i32),
        ctr_window=scalar(0, i64),
        ctr_complex=scalar(0, i64),
        ctr_conflict=scalar(0, i64),
        ctr_resolve=scalar(0, i64),
        ctr_quantum=scalar(0, i64),
        ctr_ff=scalar(0, i64),
        ctr_ffq=scalar(0, i64),
        ff_events=scalar(0, i64),
        vm_brk=scalar(0, i64),
        vm_mmap_bytes=scalar(0, i64),
        vm_munmap_bytes=scalar(0, i64),
        seen_filter=z((T, MISS_FILTER_SLOTS) if params.track_miss_types
                      else (1, 1), i32),
        inv_filter=z((T, MISS_FILTER_SLOTS) if params.track_miss_types
                     else (1, 1), i32),
        counters=make_counters(T, dev),
    )


def flat_leaves(state: SimState) -> dict:
    """Field name -> tensor for every leaf (cache and counter fields under
    ``l1i.word``-style dotted names, as convert.py and the tests use)."""
    out = {}
    for f, v in zip(SimState._fields, state):
        if isinstance(v, tuple):
            for g, w in zip(v._fields, v):
                out[f"{f}.{g}"] = w
        else:
            out[f] = v
    return out


def leaf_names() -> list:
    """The dotted leaf names :func:`flat_leaves` produces."""
    names = []
    for f in SimState._fields:
        if f in ("l1i", "l1d", "l2"):
            names += [f"{f}.{g}" for g in cachemod.CacheArrays._fields]
        elif f == "counters":
            names += [f"counters.{g}" for g in Counters._fields]
        else:
            names.append(f)
    return names


def from_flat_leaves(leaves: dict) -> SimState:
    """Inverse of :func:`flat_leaves`."""
    kw = {}
    for f, typ in (("l1i", cachemod.CacheArrays),
                   ("l1d", cachemod.CacheArrays),
                   ("l2", cachemod.CacheArrays), ("counters", Counters)):
        kw[f] = typ(**{g: leaves[f"{f}.{g}"] for g in typ._fields})
    for f in SimState._fields:
        if f not in kw:
            kw[f] = leaves[f]
    return SimState(**kw)
