"""Local (intra-tile) event processing — the per-quantum core phase.

Counterpart of ``graphite_tpu/engine/core.py`` on the port's path
(simple and iocoom cores, uniform or mixed per tile, under the four
coherence protocols, ``tpu/miss_chain`` 0 to 256, ``tpu/fast_forward``
on or off):

  * ``_block_retire`` — every round takes the next ``block_events``
    events of every tile as one [T, K] window (from the resident window
    cache) and retires the leading run of simple events through the
    window walk (engine/kernels/window.py: the CUDA kernel on the card,
    the plain form on the CPU).  At P > 0 misses past the local L2 (past
    the L1 under shared L2) bank into the tile's [P, T] chain instead of
    ending the window.  At ``tpu/fast_forward`` > 0 the rounds are wide:
    K = ``_ff_width``.
  * ``_fast_forward_guarded`` — at ``tpu/fast_forward`` > 0 and a
    run-ahead span above 0, analytic rounds through the fast-forward
    walk (the CUDA kernel on the card) before the detailed machinery:
    each prices a candidate tile's hit/compute-only prefix in closed
    form.
  * ``_complex_slot`` — one event per tile, every event kind:
    COMPUTE / BRANCH / MEM / ATOMIC misses park the tile for resolve (or,
    at P > 0, bank as chain element 0), the sync, CAPI and thread kinds
    park on their resolvers, STALL / SYNC / DVFS_SET / SYSCALL / YIELD
    and the ROI markers retire in closed form, DONE retires the stream.
    With more trace streams than tiles each tile reads its seated
    stream's trace row, and a YIELD marks the seat for rotation
    (engine/quantum.schedule_rotate).  On an iocoom tile the drain
    points wait for the load/store queues, a COMPUTE naming a source
    register waits for its scoreboard entry, and register-writing
    COMPUTEs and hitting loads land their completion there.
  * ``local_advance`` — the analytic rounds first (at
    ``tpu/fast_forward`` > 0); then at P = 0, window rounds until they
    stop retiring, then one general slot, repeated while anything moves;
    at P > 0 the chain cadence: a few window rounds to fill the bank,
    then one guarded general slot.  Under iocoom cores both
    fast-forward surfaces are off (register floors disqualify the
    closed form), as in the JAX package.

The JAX package's ``lax.while_loop``/``lax.cond`` become Python loops
whose conditions read one device scalar each; their trip counts are part
of the state (``ctr_window``, ``ctr_complex``, ``ctr_ff``, ``round_ctr``)
and match the JAX loops exactly.
"""

from __future__ import annotations

import functools

import torch

from graphite_tpu_torch.engine import cache as cachemod
from graphite_tpu_torch.engine import dense
from graphite_tpu_torch.engine import noc
from graphite_tpu_torch.engine import noc_flight
from graphite_tpu_torch.engine.kernels import dispatch
from graphite_tpu_torch.engine.kernels import window as kwindow
from graphite_tpu_torch.engine.ops import scatter
from graphite_tpu_torch.engine.state import (
    PEND_BARRIER, PEND_CBC, PEND_COND, PEND_CSIG, PEND_EX_REQ, PEND_IFETCH,
    PEND_JOIN, PEND_MUTEX, PEND_NONE, PEND_RECV, PEND_SEND, PEND_SH_REQ,
    PEND_START, SimState, TraceArrays)
from graphite_tpu_torch.engine.vparams import VariantParams, variant_params
from graphite_tpu_torch.events.schema import ICACHE_BYTES_PER_INSTRUCTION
from graphite_tpu_torch.isa import DVFSModule, EventOp, SyscallClass
from graphite_tpu_torch import params as params_mod
from graphite_tpu_torch.params import SimParams

I, S, E, M = cachemod.I, cachemod.S, cachemod.E, cachemod.M

# Stamp stride per engine round: block events use offsets 0..K-1, the
# complex slot STRIDE-2, resolve fills STRIDE-1.
STAMP_STRIDE = params_mod.STAMP_STRIDE

_lat = kwindow._lat
_spanned_bound = kwindow._spanned_bound
_ff_bound = kwindow._ff_bound


def _period(state: SimState, module: DVFSModule):
    """[T] int32 ps-per-cycle of a DVFS module's current clock."""
    return state.period_ps[:, int(module)]


@functools.lru_cache(maxsize=None)
def _syscall_table(costs: tuple, device) -> torch.Tensor:
    """[len(SyscallClass)] int32 service cycles on ``device``, made once."""
    return torch.tensor(costs, dtype=torch.int32, device=device)


def mcp_tile(params: SimParams) -> int:
    """Sync/control server tile — the highest tile."""
    return params.num_tiles - 1


def _stamp_base(st: SimState):
    return st.round_ctr * STAMP_STRIDE


def _progress(st: SimState) -> int:
    """Cursor sum — the local loops' progress witness (host int)."""
    return int(torch.sum(st.cursor.to(torch.int64)).item())


# ===================================================== block retirement

def _window_slice_gather(st: SimState, trace: TraceArrays, width: int):
    """Gather ``width`` events per tile starting at the cursor, from the
    seated stream's row under the ThreadScheduler; indices clamp at the
    trace end exactly like the JAX gather."""
    N = trace.num_events
    dev = st.cursor.device
    pos = st.cursor[:, None] + torch.arange(width, dtype=torch.int32,
                                            device=dev)[None, :]
    idx = torch.clamp(pos, max=N - 1).to(torch.int64)
    if st.sched_enabled:
        srow = st.trace_rows()[:, None]
        return trace.meta[:, srow, idx], trace.addr[srow, idx]
    T = idx.shape[0]
    meta = torch.gather(trace.meta, 2, idx[None].expand(3, T, width))
    addr = torch.gather(trace.addr, 1, idx)
    return meta, addr


def _window_refresh(params: SimParams, st: SimState, trace: TraceArrays,
                    tile_active: torch.Tensor, width: int) -> SimState:
    """Re-gather the [T, WC] resident window slice only when some active
    tile's next ``width`` events fall outside its cached span, or (under
    the ThreadScheduler) its seat rotated since the slice was taken."""
    WC = st.win_meta.shape[2]
    d = st.cursor - st.win_base
    ok = (d >= 0) & (d + width <= WC)
    if st.sched_enabled:
        ok = ok & (st.win_seat == st.seat_stream)
    if not bool(torch.any(tile_active & ~ok).item()):
        return st
    meta, addr = _window_slice_gather(st, trace, WC)
    seat = st.seat_stream if st.sched_enabled \
        else torch.full_like(st.win_seat, -1)
    return st._replace(win_meta=meta, win_addr=addr, win_base=st.cursor,
                       win_seat=seat)


def _ff_width(params: SimParams) -> int:
    """Fast-forward span width in events (0: the leg is off).

    ``tpu/fast_forward`` counts block_events-sized windows; the width is
    clipped so one round's per-event stamps fit its STAMP_STRIDE
    allocation.  It sizes both surfaces: the wide window rounds and the
    analytic span.  The multiplier floors at 2 (one window cannot beat
    the narrow round), and with K > STRIDE / 2 no width can, so the leg
    is off."""
    K = params.block_events
    if params.fast_forward <= 0 or K <= 0:
        return 0
    cap = STAMP_STRIDE // K
    if cap < 2:
        return 0
    return K * min(max(params.fast_forward, 2), cap)


def window_operands(params: SimParams, st: SimState, trace: TraceArrays,
                    vp: VariantParams = None, width: int = None):
    """Assemble the walk's operands for the next window round: refresh the
    resident window cache if an active tile outran it, then slice each
    tile's next K events (K = ``width``, a wide fast-forward round, else
    ``block_events``).  Returns the (possibly refreshed) state and the
    :class:`~graphite_tpu_torch.engine.kernels.window.WindowIn`."""
    K = params.block_events if width is None else width
    T = params.num_tiles
    N = trace.num_events
    dev = st.clock.device

    P = params.miss_chain
    # Mid-chain tiles run on the relative clock: their boundary check is
    # the walk's per-event prefix.  Empty-chain tiles may span one
    # quantum past the cut (kwindow._spanned_bound).
    in_chain = st.mq_count > 0 if P > 0 else torch.zeros_like(st.done)
    wbound = _spanned_bound(params, vp, st.boundary)
    tile_active = (~st.done) & (st.pend_kind == PEND_NONE) \
        & (in_chain | (st.clock < wbound)) & (st.cursor < N)

    ar = torch.arange(K, dtype=torch.int32, device=dev)
    pos = st.cursor[:, None] + ar[None, :]
    valid_ev = (pos < N) & tile_active[:, None]
    if st.win_meta.shape[2] >= K:
        st = _window_refresh(params, st, trace, tile_active, K)
        WC = st.win_meta.shape[2]
        # Post-refresh every active tile's offset is in bounds; inactive
        # tiles clamp and read junk that valid_ev masks.
        off = torch.clip(st.cursor - st.win_base, 0, WC - K)
        oidx = (off[:, None] + ar[None, :]).to(torch.int64)
        meta = torch.gather(st.win_meta, 2, oidx[None].expand(3, T, K))
        addr = torch.gather(st.win_addr, 1, oidx)
    else:
        meta, addr = _window_slice_gather(st, trace, K)

    wi = kwindow.WindowIn(
        meta=meta.contiguous(), addr=addr.contiguous(), valid_ev=valid_ev,
        tile_active=tile_active,
        tile_ids=torch.arange(T, dtype=torch.int32, device=dev),
        clock=st.clock, period_ps=st.period_ps, bp_table=st.bp_table,
        l1i_word=st.l1i.word, l1i_rr=st.l1i.rr_ptr,
        l1d_word=st.l1d.word, l1d_rr=st.l1d.rr_ptr,
        l2_word=None if params.shared_l2 else st.l2.word,
        l2_rr=None if params.shared_l2 else st.l2.rr_ptr,
        boundary=st.boundary, models_enabled=st.models_enabled,
        stamp_base=_stamp_base(st),
        **({f: getattr(st, f) for f in kwindow.CHAIN_IN_FIELDS}
           if P > 0 else {}),
        **(dict(lq_ready=st.lq_ready, sq_ready=st.sq_ready)
           if params.core.model == "iocoom" else {}),
    )
    return st, wi


def _block_retire(params: SimParams, vp: VariantParams, st: SimState,
                  trace: TraceArrays, width: int = None,
                  group=None) -> SimState:
    """Retire the leading run of simple events in each tile's [K] window:
    assemble the walk's operands, run the walk, land its effects.
    ``width`` widens the window to ``_ff_width`` events (a wide
    fast-forward round: the unchanged walk over a longer slice).  Under
    ``tpu/tile_shards`` > 1 the walk is the sharded one: this rank's
    tiles, gathered back through ``group`` (a parallel.mesh.ShardGroup)
    into whole leaves, which replace the state's as the kernel's
    in-place outputs do at one shard."""
    st, wi = window_operands(params, st, trace, vp, width)
    S_ids = st.spawned_at.shape[0]
    if params.tile_shards > 1:
        out = kwindow.run_window_sharded(params, vp, wi, S_ids, group)
    else:
        out = kwindow.run_window(params, vp, wi, S_ids)

    # SPAWN: the walk's one cross-tile effect, a scatter-max over the
    # returned (mask, child, landing-time) triples.
    spawned_at = scatter(st.spawned_at, out.spawn_child, out.spawn_land,
                         "max", mask=out.spawn_mask)

    c = st.counters
    c = c._replace(**{
        name: getattr(c, name) + out.ctr_inc[i]
        for i, name in enumerate(kwindow.WINDOW_CTRS)})

    st = st._replace(
        clock=out.clock,
        cursor=st.cursor + out.n_ret,
        l1i=st.l1i._replace(word=out.l1i_word, rr_ptr=out.l1i_rr),
        l1d=st.l1d._replace(word=out.l1d_word, rr_ptr=out.l1d_rr),
        l2=st.l2 if params.shared_l2
        else st.l2._replace(word=out.l2_word, rr_ptr=out.l2_rr),
        bp_table=out.bp_table,
        spawned_at=spawned_at,
        round_ctr=st.round_ctr + 1,
        ctr_window=st.ctr_window + 1,
        counters=c,
    )
    if params.miss_chain > 0:
        st = st._replace(**{f: getattr(out, f)
                            for f in kwindow.CHAIN_OUT_FIELDS})
    if width is not None and width > params.block_events:
        # A wide round counts as a fast-forward round when it retires more
        # than one narrow round's per-tile capacity somewhere.
        gain = torch.clamp(out.n_ret - params.block_events, min=0)
        st = st._replace(
            ctr_ff=st.ctr_ff + (gain > 0).any().to(torch.int64),
            ff_events=st.ff_events + torch.sum(gain).to(torch.int64))
    return st


# =================================================== analytic fast-forward

def _fast_forward_retire(params: SimParams, vp: VariantParams,
                         st: SimState, trace: TraceArrays,
                         cand: torch.Tensor, group=None) -> SimState:
    """One analytic round: gather each candidate tile's next
    ``_ff_width`` events straight from the trace (an engaged span sweeps
    about the window cache's whole width, so the cache rarely covers
    it), price the hit/compute-only prefix in closed form through the
    fast-forward walk, and land clock, cursor, cache, predictor and
    counter effects.  ``round_ctr`` and ``ctr_ff`` advance only when
    some tile engages: a declined probe uses no stamps.  Under
    ``tpu/tile_shards`` > 1 the walk is the sharded one (``group``), as in
    :func:`_block_retire`."""
    F = _ff_width(params)
    N = trace.num_events
    meta, addr = _window_slice_gather(st, trace, F)
    pos = st.cursor[:, None] + torch.arange(F, dtype=torch.int32,
                                            device=st.cursor.device)[None, :]
    fi = kwindow.FFIn(
        meta=meta, addr=addr, valid_ev=(pos < N) & cand[:, None],
        tile_active=cand, clock=st.clock, period_ps=st.period_ps,
        bp_table=st.bp_table, l1i_word=st.l1i.word, l1d_word=st.l1d.word,
        boundary=st.boundary, models_enabled=st.models_enabled,
        stamp_base=_stamp_base(st))
    if params.tile_shards > 1:
        out = kwindow.run_fast_forward_sharded(params, vp, fi, group)
    else:
        out = kwindow.run_fast_forward(params, vp, fi)

    any_engage = (out.n_ret > 0).any()
    c = st.counters
    c = c._replace(**{
        name: getattr(c, name) + out.ctr_inc[i]
        for i, name in enumerate(kwindow.WINDOW_CTRS)})
    return st._replace(
        clock=out.clock,
        cursor=st.cursor + out.n_ret,
        l1i=st.l1i._replace(word=out.l1i_word),
        l1d=st.l1d._replace(word=out.l1d_word),
        bp_table=out.bp_table,
        counters=c,
        round_ctr=st.round_ctr + any_engage.to(torch.int32),
        ctr_ff=st.ctr_ff + any_engage.to(torch.int64),
        ff_events=st.ff_events + torch.sum(out.n_ret).to(torch.int64),
    )


def _fast_forward_guarded(params: SimParams, vp: VariantParams,
                          state: SimState, trace: TraceArrays,
                          group=None) -> SimState:
    """The analytic leg's gate: skipped when the leg is off
    (``_ff_width`` 0), under iocoom cores (register floors disqualify
    the closed form), with the ThreadScheduler seated (a seat rotation
    is a thread switch no span may cross), when the run-ahead span is 0
    (the walk's engage rule, commits past the window bound, can then
    never fire), when no tile is a candidate, or when models are
    disabled.  Otherwise analytic rounds while the cursor sum grows, at
    most ``max(1, max_events_per_quantum)``.  At P > 0 tiles with
    pending chain heads are no candidates."""
    if _ff_width(params) == 0 or params.core.model == "iocoom" \
            or state.sched_enabled or vp.fast_forward_span_ps <= 0:
        return state
    N = trace.num_events
    P = params.miss_chain

    def cand_of(s):
        c = (~s.done) & (s.pend_kind == PEND_NONE) & (s.cursor < N) \
            & (s.clock < _ff_bound(params, vp, s.boundary))
        if P > 0:
            c = c & (s.mq_count == 0)
        return c

    if not bool((cand_of(state).any() & state.models_enabled).item()):
        return state
    cap = max(1, params.max_events_per_quantum)
    i, cv = 0, _progress(state)
    while True:
        state = _fast_forward_retire(params, vp, state, trace,
                                     cand_of(state), group)
        i, pv, cv = i + 1, cv, _progress(state)
        dispatch.COUNTS["ff_engaged"] += int(cv > pv)
        if i >= cap or cv <= pv:
            return state


# ======================================================== complex slot

def _complex_slot(params: SimParams, vp: VariantParams, state: SimState,
                  trace: TraceArrays) -> SimState:
    """One event per tile, every event kind: compute, branch and memory
    misses park the tile for resolve (or, at P > 0, bank as chain element
    0), the sync, CAPI and lifecycle kinds park on their resolvers or
    retire in closed form, DONE retires the stream.  Each tile reads its
    seated stream's row under the ThreadScheduler, where DONE lands in
    the stream's ``done_at`` and a YIELD marks the seat for rotation."""
    T = params.num_tiles
    N = trace.num_events
    line_bits = params.line_size.bit_length() - 1
    dev = state.clock.device
    rows = torch.arange(T, device=dev)
    num_locks = state.lock_holder.shape[0]
    num_bars = state.bar_count.shape[0]
    mcp = mcp_tile(params)
    st = state
    c = st.counters

    P = params.miss_chain
    # The slot spans like the window (kwindow._spanned_bound); a tile with
    # banked chain elements needs an absolute clock, so it waits for the
    # resolve pass to drain them.
    cbound = _spanned_bound(params, vp, st.boundary)
    active = (~st.done) & (st.pend_kind == PEND_NONE) \
        & (st.clock < cbound) & (st.cursor < N)
    if P > 0:
        active = active & (st.mq_count == 0)
    cur = torch.clamp(st.cursor, max=N - 1).to(torch.int64)
    srow = st.trace_rows() if st.sched_enabled else rows
    ev = trace.meta[:, srow, cur]          # [3, T]
    addr = trace.addr[srow, cur]
    op = torch.where(active, ev[0], int(EventOp.NOP))
    arg = ev[1]
    arg2 = ev[2]

    # Region of interest: outside it compute, branch and memory events
    # cost nothing and count nothing; sync, network and lifecycle events
    # stay functional.  With core modeling off in the config the markers
    # cannot turn it on.
    en = st.models_enabled
    if params.enable_core_modeling:
        models_enabled = (st.models_enabled
                          | (op == EventOp.ENABLE_MODELS).any()) \
            & ~(op == EventOp.DISABLE_MODELS).any()
    else:
        models_enabled = st.models_enabled

    iocoom = params.core.model == "iocoom"
    iot = kwindow.iocoom_mask(params, dev) if params.core.mixed else None
    if iocoom:
        # Drain points wait for every outstanding load and store: atomics,
        # the sync, thread and message kinds, SYNC, SPAWN, DVFS_SET,
        # SYSCALL, DONE, and branches unless loads are speculative.
        drain_t = torch.maximum(torch.amax(st.lq_ready, dim=0),
                                torch.amax(st.sq_ready, dim=0))
        drain_op = torch.zeros_like(active)
        for k in (EventOp.ATOMIC, EventOp.BARRIER_WAIT, EventOp.MUTEX_LOCK,
                  EventOp.MUTEX_UNLOCK, EventOp.COND_WAIT,
                  EventOp.COND_SIGNAL, EventOp.COND_BROADCAST,
                  EventOp.JOIN, EventOp.RECV, EventOp.SEND, EventOp.SYNC,
                  EventOp.SPAWN, EventOp.DVFS_SET, EventOp.SYSCALL,
                  EventOp.DONE):
            drain_op = drain_op | (op == k)
        if not params.core.speculative_loads:
            drain_op = drain_op | (op == EventOp.BRANCH)
        if iot is not None:
            drain_op = drain_op & iot
        clk = torch.where(drain_op, torch.maximum(st.clock, drain_t),
                          st.clock)
        # The scoreboard's read-after-write floor: a COMPUTE naming a
        # source register waits for that register's ready time.
        sreg = (arg2 >> 20) & 31          # source register + 1, 0 = none
        has_sreg = (op == EventOp.COMPUTE) & (sreg > 0)
        if iot is not None:
            has_sreg = has_sreg & iot
        rr = st.reg_ready[torch.clamp(sreg - 1, min=0).to(torch.int64),
                          rows]
        clk = torch.where(has_sreg, torch.maximum(clk, rr), clk)
    else:
        clk = st.clock

    p_core = _period(st, DVFSModule.CORE)
    p_l1i = _period(st, DVFSModule.L1_ICACHE)
    p_l1d = _period(st, DVFSModule.L1_DCACHE)
    p_l2 = _period(st, DVFSModule.L2_CACHE)
    p_nu = _period(st, DVFSModule.NETWORK_USER)

    l1i_ps = _lat(vp.l1i_access_cycles, p_l1i)
    l1d_ps = _lat(vp.l1d_access_cycles, p_l1d)
    l2_ps = _lat(vp.l2_access_cycles, p_l2)
    l2_tag_ps = _lat(vp.l2_tags_access_cycles, p_l2)
    cycle_ps = _lat(1, p_core)

    shared_l2 = params.shared_l2
    line = addr >> line_bits
    pI = cachemod.probe(st.l1i, line, params.l1i.num_sets)
    pD = cachemod.probe(st.l1d, line, params.l1d.num_sets)
    # Shared L2: no private L2, an L1 miss goes to the home slice.
    pL2 = None if shared_l2 else cachemod.probe(st.l2, line,
                                                params.l2.num_sets)

    stamp = _stamp_base(st) + STAMP_STRIDE - 2

    # ---------------------------------------------------- COMPUTE blocks
    is_comp = op == EventOp.COMPUTE
    icount_ev = torch.clamp(arg2 & ((1 << 20) - 1), min=0).to(torch.int64)
    n_lines = torch.clamp(
        (icount_ev * ICACHE_BYTES_PER_INSTRUCTION + params.line_size - 1)
        // params.line_size, min=1)
    cost_ps = _lat(torch.clamp(arg, min=0), p_core)
    fetch_ps = icount_ev * l1i_ps
    if shared_l2:
        comp_l2path = torch.zeros_like(is_comp)
        comp_block = is_comp & ~pI.hit & en
        dt_comp = cost_ps + fetch_ps
    else:
        comp_l2path = is_comp & ~pI.hit & pL2.hit & en
        comp_block = is_comp & ~pI.hit & ~pL2.hit & en
        dt_comp = cost_ps + fetch_ps \
            + torch.where(~pI.hit, n_lines * l2_ps, 0)
    comp_ok = is_comp & ~comp_block

    # ------------------------------------------------------- BRANCH
    is_br = op == EventOp.BRANCH
    taken = arg != 0
    if params.core.bp_type == "none":
        correct = torch.ones_like(is_br)
        dt_br = cycle_ps + l1i_ps
        bp_table = st.bp_table
    else:
        bidx = (addr % params.core.bp_size).to(torch.int64)
        pred = st.bp_table[rows, bidx]
        correct = pred == taken
        dt_br = torch.where(
            correct, cycle_ps,
            _lat(vp.bp_mispredict_penalty, p_core)) + l1i_ps
        bp_table = scatter(st.bp_table, (rows, bidx), taken, "set",
                           mask=is_br & en)

    # ------------------------------------------------- MEMORY OPERANDS
    is_rd = op == EventOp.MEM_READ
    is_at = op == EventOp.ATOMIC
    is_wr = (op == EventOp.MEM_WRITE) | is_at
    is_mem = is_rd | is_wr
    # Writable states: M, and under shared-L2 MESI also E (the exclusive
    # owner upgrades E->M locally without telling the home slice).
    mesi_local = params.protocol_kind == "sh_l2_mesi"
    writable = pD.state >= (E if mesi_local else M)
    l1_ok = pD.hit & (is_rd | writable)
    mem_l1 = is_mem & l1_ok & en
    if shared_l2:
        mem_l2 = torch.zeros_like(mem_l1)
        mem_rem = is_mem & ~l1_ok & en
    else:
        l2_ok = pL2.hit & (is_rd | (pL2.state == M))
        mem_l2 = is_mem & ~l1_ok & l2_ok & en
        mem_rem = is_mem & ~l1_ok & ~l2_ok & en
    # An atomic pays one read-modify-write cycle past its access.
    at_extra = torch.where(is_at, cycle_ps, 0)
    dt_mem_l1 = l1d_ps + at_extra
    dt_mem_l2 = l1d_ps + l2_ps + at_extra

    # --------------------------------------------- USER NETWORK (CAPI)
    is_send_op = op == EventOp.SEND
    is_recv = op == EventOp.RECV
    flits_send = noc.num_flits(torch.clamp(arg, min=0),
                               vp.net_user.flit_width_bits)
    chan = {}
    if st.has_capi:
        # A send takes the next slot of its [D] channel ring, or parks
        # (PEND_SEND) while the ring is full.  The reused slot holds the
        # completion of the recv that freed it, a floor on the departure.
        chan_depth = st.ch_time.shape[0]
        dst = torch.clip(arg2, 0, T - 1).to(torch.int64)
        sent_row = st.ch_sent[rows, dst]
        recvd_row = st.ch_recvd[rows, dst]
        ch_full = (sent_row - recvd_row) >= chan_depth
        is_send = is_send_op & ~ch_full
        send_block = is_send_op & ch_full
        slot_idx = (sent_row % chan_depth).to(torch.int64)
        slot_freed = st.ch_time[slot_idx, rows, dst]
        depart = torch.maximum(clk + cycle_ps, slot_freed)
        if params.net_user.model == "emesh_hop_by_hop":
            # The data packet contends per link on the user mesh.
            fl = noc_flight.flight(
                params.net_user, params.mesh_width, params.mesh_height,
                rows.to(torch.int32), dst.to(torch.int32), depart,
                flits_send, is_send & active, st.link_free_user, p_nu,
                vnet=vp.net_user)
            chan["link_free_user"] = fl.link_free
            c = c._replace(net_link_wait_ps=c.net_link_wait_ps
                           + torch.where(is_send & active & en,
                                         fl.wait_ps, 0))
            arrival = torch.where(is_send, fl.arrival, depart)
        else:
            arrival = depart + noc.unicast_ps(
                params.net_user, rows, dst, torch.clamp(arg, min=0), p_nu,
                params.mesh_width, vnet=vp.net_user)
        chan["ch_time"] = scatter(st.ch_time, (slot_idx, rows, dst),
                                  arrival, "set", mask=is_send)
        chan["ch_sent"] = scatter(st.ch_sent, (rows, dst), 1, "add",
                                  mask=is_send)
    else:
        is_send = torch.zeros_like(is_send_op)
        send_block = is_send_op          # a CAPI-less state cannot send
    dt_send = cycle_ps

    # ------------------------------------------------------ SYNC OPS
    is_bar = op == EventOp.BARRIER_WAIT
    is_lock = op == EventOp.MUTEX_LOCK
    is_unlock = op == EventOp.MUTEX_UNLOCK
    to_mcp_ps = noc.unicast_ps(
        params.net_user, rows, torch.full((T,), mcp, device=dev), 8, p_nu,
        params.mesh_width, vnet=vp.net_user)
    NEG = -(2**62)
    bar_id = torch.clip(arg, 0, num_bars - 1)
    bar_oh = dense.onehot(bar_id, num_bars)
    bar_count = st.bar_count + dense.binsum(
        bar_oh, is_bar, 1).to(st.bar_count.dtype)
    bar_time = torch.maximum(st.bar_time, dense.binmax(
        bar_oh, is_bar, clk + to_mcp_ps, NEG))
    # Unlock, and COND_WAIT (whose mutex id is in arg2), release the mutex
    # at its MCP arrival; an unlock pays the round trip.
    is_cwait = op == EventOp.COND_WAIT
    is_csig = op == EventOp.COND_SIGNAL
    is_cbc = op == EventOp.COND_BROADCAST
    is_join = op == EventOp.JOIN
    is_tstart = op == EventOp.THREAD_START
    release = is_unlock | is_cwait
    lock_id = torch.clip(torch.where(is_cwait, arg2, arg), 0, num_locks - 1)
    ul_oh = dense.onehot(lock_id, num_locks) & release[:, None]
    lock_holder = torch.where(ul_oh.any(dim=0), 0, st.lock_holder)
    lock_free_at = torch.maximum(st.lock_free_at, dense.binmax(
        ul_oh, release, clk + to_mcp_ps + cycle_ps, NEG))
    dt_unlock = 2 * to_mcp_ps + 2 * cycle_ps

    # SPAWN (from the slot when models are off: the window walk takes it
    # otherwise) lands on the child's tile.
    is_spawn = op == EventOp.SPAWN
    S_ids = st.spawned_at.shape[0]
    child = torch.clip(arg2, 0, S_ids - 1).to(torch.int64)
    spawn_land = clk + _lat(torch.clamp(arg, min=0), p_core) \
        + noc.unicast_ps(params.net_user, rows, child % T, 8, p_nu,
                         params.mesh_width, vnet=vp.net_user)
    spawned_at = scatter(st.spawned_at, child, spawn_land, "max",
                         mask=is_spawn)

    # ------------------------------------------------ SIMPLE/DYNAMIC OPS
    is_stall = op == EventOp.STALL
    is_sync = op == EventOp.SYNC
    is_dvfs = op == EventOp.DVFS_SET
    is_done = op == EventOp.DONE
    # YIELD: an MCP round trip; under the ThreadScheduler the seat then
    # rotates at the next quantum (seat_yield below).
    is_yield = op == EventOp.YIELD
    dt_spawn = _lat(torch.clamp(arg, min=0), p_core)
    dt_dvfs = _lat(vp.dvfs_sync_delay_cycles, p_core)

    # SYSCALL: request leg to the MCP with the marshalled bytes, the
    # class's service cycles, the ack leg and one cycle; no park.
    is_sysc = op == EventOp.SYSCALL
    svc_tbl = _syscall_table(vp.syscall_cost_cycles, dev)
    svc_ps = _lat(svc_tbl[torch.clip(arg, 0, svc_tbl.shape[0] - 1).to(
        torch.int64)], p_core)
    sys_req_ps = noc.unicast_ps(
        params.net_user, rows, torch.full((T,), mcp, device=dev),
        torch.clamp(arg2, min=0), p_nu, params.mesh_width,
        vnet=vp.net_user)
    dt_sysc = sys_req_ps + svc_ps + to_mcp_ps + cycle_ps
    nmod = st.period_ps.shape[1]
    mod_oh = is_dvfs[:, None] & dense.onehot(torch.clip(arg, 0, nmod - 1),
                                             nmod)
    # arg2 is the new frequency in MHz: period_ps = round(1e6 / MHz).
    mhz = torch.clamp(arg2, min=1)
    new_period = ((1_000_000 + mhz // 2) // mhz).to(torch.int32)
    period_ps = torch.where(mod_oh, new_period[:, None], st.period_ps)

    # ------------------------------------------------------ combine dt
    dt = torch.zeros(T, dtype=torch.int64, device=dev)
    dt = torch.where(comp_ok & en, dt_comp, dt)
    dt = torch.where(is_br & en, dt_br, dt)
    dt = torch.where(mem_l1, dt_mem_l1, dt)
    dt = torch.where(mem_l2, dt_mem_l2, dt)
    dt = torch.where(is_send, dt_send, dt)
    dt = torch.where(is_unlock, dt_unlock, dt)
    dt = torch.where(is_spawn, dt_spawn, dt)
    dt = torch.where(is_dvfs, dt_dvfs, dt)
    # ROI-gated: with models off a syscall runs but charges no time.
    dt = torch.where(is_sysc & en, dt_sysc, dt)
    dt = torch.where(is_yield & en, 2 * to_mcp_ps + cycle_ps, dt)

    new_clock = clk + dt
    new_clock = torch.where(is_stall, torch.maximum(clk, addr), new_clock)
    new_clock = torch.where(
        is_sync,
        torch.maximum(clk, addr) + _lat(torch.clamp(arg, min=0), p_core),
        new_clock)

    # ------------------------------------------------- blocking events
    # At P > 0 a memory miss banks as chain element 0 instead of parking
    # (the complex slot runs only on an empty chain, so slot 0 is free);
    # the resolve pass fills the line at serve time.
    bank = (mem_rem | comp_block) if P > 0 else torch.zeros_like(mem_rem)
    blocked = ((comp_block | mem_rem) & ~bank) | is_recv | is_bar \
        | is_lock | send_block | is_cwait | is_csig | is_cbc | is_join \
        | is_tstart
    kind = torch.where(comp_block, PEND_IFETCH, PEND_NONE)
    kind = torch.where(mem_rem & is_rd, PEND_SH_REQ, kind)
    kind = torch.where(mem_rem & is_wr, PEND_EX_REQ, kind)
    kind = torch.where(is_recv, PEND_RECV, kind)
    kind = torch.where(is_bar, PEND_BARRIER, kind)
    kind = torch.where(is_lock, PEND_MUTEX, kind)
    kind = torch.where(send_block, PEND_SEND, kind)
    kind = torch.where(is_cwait, PEND_COND, kind)
    kind = torch.where(is_csig, PEND_CSIG, kind)
    kind = torch.where(is_cbc, PEND_CBC, kind)
    kind = torch.where(is_join, PEND_JOIN, kind)
    kind = torch.where(is_tstart, PEND_START, kind)
    pend_kind = torch.where(blocked, kind, st.pend_kind)
    pend_addr = torch.where(
        is_bar | is_lock | is_cwait | is_csig | is_cbc, arg.to(torch.int64),
        torch.where(send_block, torch.clamp(arg, min=0).to(torch.int64),
                    torch.where(blocked, addr, st.pend_addr)))
    # The miss is found after the local tag checks: L1 only with shared
    # L2 (there is no private L2 tag array to consult).
    miss_tags_ps = cycle_ps if shared_l2 else l2_tag_ps
    issue = clk + torch.where(
        comp_block, l1i_ps + miss_tags_ps,
        torch.where(mem_rem, l1d_ps + miss_tags_ps, cycle_ps))
    # Cond waits and signal/broadcast tokens park with their MCP arrival
    # time; THREAD_START parks at the local clock.
    issue = torch.where(is_cwait | is_csig | is_cbc, clk + to_mcp_ps, issue)
    issue = torch.where(is_tstart, clk, issue)
    pend_issue = torch.where(blocked, issue, st.pend_issue)
    # A memory park's aux: the atomic flag in bit 0 and a load's
    # destination register + 1 in bits 8-12; other parks carry arg2.
    mdreg = torch.where(is_rd, (arg2 >> 8) & 31, 0)
    pend_aux = torch.where(blocked,
                           torch.where(mem_rem,
                                       is_at.to(torch.int32) | (mdreg << 8),
                                       arg2),
                           st.pend_aux)
    # Local cost still owed once the remote part resolves: a blocked
    # COMPUTE block's execution and fetch, an atomic's RMW cycle.
    extra = torch.where(
        comp_block,
        cost_ps + fetch_ps + (0 if shared_l2 else (n_lines - 1) * l2_ps),
        torch.where(mem_rem, at_extra, 0))
    pend_extra = torch.where(blocked, extra, st.pend_extra)

    if P > 0:
        kind_ev = torch.where(comp_block, PEND_IFETCH,
                              torch.where(is_wr, PEND_EX_REQ,
                                          PEND_SH_REQ)).to(torch.int64)
        # The bank word: kind, the atomic flag in bit 3, the line.
        mq_req0 = kind_ev | (is_at.to(torch.int64) << 3) | (line << 8)
        chain = dict(
            mq_req=_set_row0(st.mq_req, bank, mq_req0),
            mq_delta=_set_row0(st.mq_delta, bank, issue),
            mq_extra=_set_row0(st.mq_extra, bank, extra),
            mq_count=torch.where(bank, 1, st.mq_count).to(torch.int32),
            chain_rel=torch.where(bank, 0, st.chain_rel))
    else:
        chain = {}

    # ------------------------------------------------- cache updates
    l1i = cachemod.touch(st.l1i, pI.set_idx, pI.way, is_comp & pI.hit & en,
                         cachemod.row_word(pI.row, pI.way), stamp)
    if shared_l2:
        l2 = st.l2
        d_word = cachemod.row_word(pD.row, pD.way)
        if mesi_local:
            # Silent E->M upgrade on a store hit to an E-granted line.
            d_word = cachemod.with_state(
                d_word, torch.where(mem_l1 & is_wr & (pD.state == E),
                                    M, pD.state))
        l1d = cachemod.touch(st.l1d, pD.set_idx, pD.way, mem_l1, d_word,
                             stamp)
    else:
        fI = cachemod.fill(l1i, line, torch.full((T,), S, dtype=torch.int32,
                                                 device=dev),
                           comp_l2path, params.l1i.num_sets,
                           params.l1i.replacement, stamp)
        l1i = fI.cache
        l2 = cachemod.touch(st.l2, pL2.set_idx, pL2.way,
                            (comp_l2path | mem_l2),
                            cachemod.row_word(pL2.row, pL2.way), stamp)
        l1d = cachemod.touch(st.l1d, pD.set_idx, pD.way, mem_l1,
                             cachemod.row_word(pD.row, pD.way), stamp)
        fD = cachemod.fill(l1d, line,
                           torch.where(is_wr, M, S).to(torch.int32),
                           mem_l2, params.l1d.num_sets,
                           params.l1d.replacement, stamp)
        l1d = fD.cache

    # ------------------------------------------------------- counters
    def add(x, mask, val=1):
        return x + torch.where(mask & en, val, 0)

    c = c._replace(
        icount=c.icount
        + torch.where(is_comp & en, icount_ev, 0)
        + torch.where(((is_mem & ((arg2 & 0xFF) == 0)) | is_br) & en, 1, 0),
        l1i_access=c.l1i_access + torch.where(is_comp & en, icount_ev, 0)
        + torch.where(is_br & en, 1, 0),
        l1i_miss=c.l1i_miss + torch.where(is_comp & ~pI.hit & active & en,
                                          n_lines, 0),
        l1d_read=add(c.l1d_read, is_rd),
        l1d_read_miss=add(c.l1d_read_miss, is_rd & ~l1_ok),
        l1d_write=add(c.l1d_write, is_wr),
        l1d_write_miss=add(c.l1d_write_miss, is_wr & ~l1_ok),
        # Under shared L2 the slice accesses are counted at the home tile
        # by the resolve pass, not here.
        l2_access=c.l2_access if shared_l2 else add(
            c.l2_access, mem_l2 | mem_rem | comp_l2path | comp_block),
        l2_miss=c.l2_miss if shared_l2 else add(
            c.l2_miss, mem_rem | comp_block),
        branches=add(c.branches, is_br),
        mispredicts=add(c.mispredicts, is_br & ~correct),
        net_user_pkts=add(c.net_user_pkts, is_send),
        net_user_flits=c.net_user_flits
        + torch.where(is_send & en, flits_send, 0),
        sends=add(c.sends, is_send),
        barriers=add(c.barriers, is_bar),
        cond_waits=add(c.cond_waits, is_cwait),
        cond_signals=add(c.cond_signals, is_csig | is_cbc),
        spawns=add(c.spawns, is_spawn),
        syscalls=add(c.syscalls, is_sysc),
        syscall_ps=c.syscall_ps + torch.where(is_sysc & en, dt_sysc, 0),
    )

    # The VMManager's accounting: mmap/munmap lengths and the requested
    # break ride the SYSCALL's addr field.  Functional, so not ROI-gated.
    def vm_of(cls):
        return torch.where(is_sysc & (arg == int(cls)), addr, 0)

    if st.sched_enabled:
        # done_at is per stream: the seated stream's row.
        done_at = scatter(st.done_at, srow, clk, "set", mask=is_done)
        st = st._replace(seat_yield=st.seat_yield | is_yield)
    else:
        done_at = torch.where(is_done, clk, st.done_at)
    if iocoom:
        # Scoreboard writes: a register-writing COMPUTE lands its
        # completion, a hitting load its hit completion (a missing load's
        # lands in resolve, from pend_aux bits 8-12).  One row per tile.
        dregc = (arg2 >> 25) & 31
        wreg = torch.where(is_comp & (dregc > 0), dregc,
                           torch.where((mem_l1 | mem_l2) & is_rd
                                       & (mdreg > 0), mdreg, 0))
        sb_write = (wreg > 0) & active
        if iot is not None:
            sb_write = sb_write & iot
        st = st._replace(reg_ready=scatter(
            st.reg_ready, ((wreg - 1).to(torch.int64), rows), new_clock,
            "max", mask=sb_write))
    return st._replace(
        clock=new_clock,
        cursor=st.cursor + torch.where(active & ~blocked, 1, 0).to(
            torch.int32),
        done=st.done | is_done,
        done_at=done_at,
        spawned_at=spawned_at,
        models_enabled=models_enabled,
        pend_kind=pend_kind.to(torch.int32),
        pend_addr=pend_addr,
        pend_issue=pend_issue,
        pend_aux=pend_aux.to(torch.int32),
        pend_extra=pend_extra,
        bp_table=bp_table,
        l1i=l1i, l1d=l1d, l2=l2,
        period_ps=period_ps,
        lock_holder=lock_holder,
        lock_free_at=lock_free_at,
        bar_count=bar_count,
        bar_time=bar_time,
        round_ctr=st.round_ctr + 1,
        ctr_complex=st.ctr_complex + 1,
        counters=c,
        vm_mmap_bytes=st.vm_mmap_bytes + torch.sum(vm_of(SyscallClass.MMAP)),
        vm_munmap_bytes=st.vm_munmap_bytes
        + torch.sum(vm_of(SyscallClass.MUNMAP)),
        vm_brk=torch.maximum(st.vm_brk, torch.amax(vm_of(SyscallClass.BRK))),
        **chan,
        **chain,
    )


def _set_row0(arr: torch.Tensor, mask: torch.Tensor,
              val: torch.Tensor) -> torch.Tensor:
    """``arr.at[0].set(where(mask, val, arr[0]))`` for a [P, T] bank."""
    return torch.cat([torch.where(mask, val, arr[0])[None], arr[1:]])


def _complex_slot_guarded(params: SimParams, vp: VariantParams,
                          state: SimState,
                          trace: TraceArrays) -> SimState:
    """Run the general slot only when some tile can use it (P > 0): an
    eligible tile (empty chain, un-parked, inside the spanned bound)
    whose next event is one the window never takes (every kind but
    COMPUTE, BRANCH, MEM_READ, MEM_WRITE, STALL, SYNC and SPAWN), or any
    eligible tile while models are off or the cores are iocoom.
    Skipping is result-identical; at P == 0 the slot runs
    unconditionally."""
    if params.miss_chain <= 0:
        return _complex_slot(params, vp, state, trace)
    N = trace.num_events
    gbound = _spanned_bound(params, vp, state.boundary)
    eligible = (~state.done) & (state.pend_kind == PEND_NONE) \
        & (state.clock < gbound) & (state.cursor < N) \
        & (state.mq_count == 0)
    # Under iocoom annotated events decline the window, so the op class
    # does not tell whether the slot is needed.
    if params.core.model != "iocoom" and params.block_events > 0:
        cur = torch.clamp(state.cursor, max=N - 1).to(torch.int64)
        op = trace.meta[0, state.trace_rows(), cur]
        window_class = ((op == EventOp.COMPUTE) | (op == EventOp.BRANCH)
                        | (op == EventOp.MEM_READ)
                        | (op == EventOp.MEM_WRITE)
                        | (op == EventOp.STALL) | (op == EventOp.SYNC)
                        | (op == EventOp.SPAWN))
        eligible = eligible & (~window_class | ~state.models_enabled)
    if bool(eligible.any().item()):
        return _complex_slot(params, vp, state, trace)
    return state


def _chain_cadence(params: SimParams, vp: VariantParams, state: SimState,
                   trace: TraceArrays, wide: int = None,
                   group=None) -> SimState:
    """local_advance at P > 0: just enough window rounds to fill the bank
    (``cap_w``, from the round's width: ``wide`` for wide fast-forward
    rounds), skipped outright when no tile can retire, then one guarded
    general slot.  With ``fanout_replay`` the window loop also ends as
    soon as no tile can use another round."""
    if params.block_events > 0:
        P = params.miss_chain
        K = params.block_events if wide is None else wide
        cap_w = max(1, -(-P * 3 // (2 * K)))
        N = trace.num_events
        qps = vp.quantum_ps

        def can_retire(st):
            mid = st.mq_count > 0
            wb = _spanned_bound(params, vp, st.boundary)
            return (~st.done) & (st.pend_kind == PEND_NONE) \
                & (st.cursor < N) \
                & torch.where(mid, (st.chain_rel < qps) & (st.mq_count < P),
                              st.clock < wb)

        if bool(can_retire(state).any().item()):
            j, cv = 0, _progress(state)
            while True:
                state = _block_retire(params, vp, state, trace, wide, group)
                j, pv, cv = j + 1, cv, _progress(state)
                if j >= cap_w or cv <= pv:
                    break
                if params.fanout_replay \
                        and not bool(can_retire(state).any().item()):
                    break
    return _complex_slot_guarded(params, vp, state, trace)


def local_advance(params: SimParams, state: SimState,
                  trace: TraceArrays, vp: VariantParams = None,
                  group=None) -> SimState:
    """Advance every non-blocked tile through events until the quantum
    boundary, stream end, or its first remote-blocking event: window
    rounds until they stop retiring, then one general slot, repeated
    while the cursor sum moves (capped at max_events_per_quantum).  At
    ``tpu/fast_forward`` > 0 the analytic rounds run first and every
    window round is wide, except under the ThreadScheduler, where both
    surfaces of the leg are off as in the JAX package.  ``group`` is the
    rank's ShardGroup under ``tpu/tile_shards`` > 1 (the walks are
    sharded), else None."""
    if vp is None:
        vp = variant_params(params)
    wide = None
    if params.fast_forward > 0:
        state = _fast_forward_guarded(params, vp, state, trace, group)
        if _ff_width(params) > params.block_events \
                and params.core.model != "iocoom" \
                and not state.sched_enabled:
            wide = _ff_width(params)
    if params.miss_chain > 0:
        return _chain_cadence(params, vp, state, trace, wide, group)
    cap = params.max_events_per_quantum
    i = 0
    prev = -1
    cur = _progress(state)
    while i < cap and (i == 0 or cur > prev):
        st = state
        if params.block_events > 0:
            j, pv, cv = 0, -1, cur
            while j < cap and (j == 0 or cv > pv):
                st = _block_retire(params, vp, st, trace, wide, group)
                j, pv, cv = j + 1, cv, _progress(st)
        st = _complex_slot(params, vp, st, trace)
        i, prev, cur = i + 1, cur, _progress(st)
        state = st
    return state
