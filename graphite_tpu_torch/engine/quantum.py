"""The quantum engine: lax-barrier-synchronised stepping of all tiles.

Counterpart of ``graphite_tpu/engine/quantum.py``: the boundary is
recomputed from the min clock over runnable tiles (skipping empty
quanta), and a quantum step is sub-rounds of (local_advance ; resolve)
while the progress witness moves, capped at ``rounds_per_quantum``; at
``tpu/fast_forward`` > 0 the quantum counts in ``ctr_ffq`` when it
fast-forwarded.  With more trace streams than tiles each quantum first
rotates the ThreadScheduler's seats (``schedule_rotate``).
``megarun`` runs quantum steps until every stream is done or a quanta
budget is spent.  The JAX package runs these loops on the device; here
each loop condition is one host read of a device scalar, and the trip
counts (``ctr_quantum`` and everything below it) match exactly.  Under
``tpu/tile_shards`` = S > 1 the loops run on each of S ranks, which hold
the whole state: every host read sees the same values on every rank, so
the ranks take the same trips.
"""

from __future__ import annotations

import torch

from graphite_tpu_torch.engine.core import local_advance
from graphite_tpu_torch.engine.ops import scatter
from graphite_tpu_torch.engine.resolve import resolve
from graphite_tpu_torch.engine.state import (
    PEND_BARRIER, PEND_CBC, PEND_COND, PEND_CSIG, PEND_EX_REQ, PEND_IFETCH,
    PEND_JOIN, PEND_MUTEX, PEND_RECV, PEND_SEND, PEND_SH_REQ, PEND_START,
    SimState, TraceArrays)
from graphite_tpu_torch.engine.vparams import VariantParams, variant_params
from graphite_tpu_torch.parallel.mesh import check_group
from graphite_tpu_torch.params import SimParams
from graphite_tpu_torch.time_base import TIME_MAX


def next_boundary(params: SimParams, state: SimState,
                  vp: VariantParams = None, group=None) -> torch.Tensor:
    """Advance the barrier boundary past the slowest runnable tile,
    skipping empty quanta.  Under ``tpu/tile_shards`` > 1 each rank takes
    the minimum of its own T/S tiles and ``group`` (the rank's
    parallel.mesh.ShardGroup) the minimum over the ranks: the JAX
    package's ``pmin`` barrier, equal to the whole minimum (the slices
    partition the tiles; the clocks are integers)."""
    k = state.pend_kind
    sync_blocked = ((k == PEND_RECV) | (k == PEND_BARRIER)
                    | (k == PEND_MUTEX) | (k == PEND_SEND)
                    | (k == PEND_COND) | (k == PEND_CSIG)
                    | (k == PEND_CBC) | (k == PEND_JOIN)
                    | (k == PEND_START))
    runnable = ~state.done & ~sync_blocked
    clk = state.clock
    if params.miss_chain > 0 and params.fanout_replay:
        # A mid-chain tile's clock is frozen at its pre-bank value until
        # the drain restores it; its served progress lives in chain_base,
        # a sound lower bound on its post-drain clock.
        clk = torch.where(state.mq_head > 0,
                          torch.maximum(clk, state.chain_base), clk)
    masked = torch.where(runnable, clk, int(TIME_MAX))
    if params.tile_shards > 1:
        lo, tl = group.tiles(params.num_tiles)
        min_clock = group.all_min(torch.amin(masked[lo:lo + tl]))
    else:
        min_clock = torch.amin(masked)
    q = vp.quantum_ps if vp is not None else params.quantum_ps
    nb = (min_clock // q + 1) * q
    return torch.where(runnable.any(), nb, state.boundary + q).to(
        torch.int64)


def schedule_rotate(params: SimParams, state: SimState,
                    vp: VariantParams = None) -> SimState:
    """The ThreadScheduler's seat rotation, the JAX ``schedule_rotate``.

    Streams are placed round-robin (stream s on tile s % T) and each
    tile seats one of them: the [T] context leaves are the seats, the
    other streams wait in the ``strm_*`` store.  A seat gives up its
    stream when the stream is done, retired a YIELD, parked on
    THREAD_START before its SPAWN, or has held the seat for
    ``thread_switch_quantum_ps`` of simulated time, but never while the
    tile is mid-memory-transaction (a parked SH / EX / IFETCH request or
    a non-empty miss chain).  It then seats its tile's waiting stream
    with the lowest ``strm_key``; the outgoing stream goes to the back
    of the queue (key ``max_key + 1 + tile``).  The incoming stream's
    clock is at least the outgoing one's (the core is serial).  Runs on
    the device with no host read."""
    T = params.num_tiles
    S = state.strm_cursor.shape[0]
    dev = state.clock.device
    sst = state.seat_stream.to(torch.int64)                # [T]
    tiles = torch.arange(T, dtype=torch.int64, device=dev)
    sids = torch.arange(S, dtype=torch.int64, device=dev)
    strm_tile = sids % T                                   # static placement

    # The store's done flags of the seated streams, brought up to date.
    strm_done = scatter(state.strm_done, sst, state.done, "set")
    state = state._replace(strm_done=strm_done)

    k = state.pend_kind
    mem_park = (k == PEND_SH_REQ) | (k == PEND_EX_REQ) | (k == PEND_IFETCH) \
        | (state.mq_count > 0)
    unspawned_gate = (k == PEND_START) & (state.spawned_at[sst] < 0)
    switch_q = vp.thread_switch_quantum_ps if vp is not None \
        else params.thread_switch_quantum_ps
    expired = (state.boundary - state.seat_since) >= switch_q
    give_up = (state.done | state.seat_yield | unspawned_gate
               | expired) & ~mem_park

    # Waiting streams per tile (not seated, not done), FCFS by strm_key.
    seated = state.seated()
    waiting = ~seated & ~strm_done
    BIG = 2**62
    tbl = scatter(torch.full((T,), BIG, dtype=torch.int64, device=dev),
                  strm_tile, state.strm_key, "min", mask=waiting)
    has_wait = tbl < BIG
    rotate = give_up & has_wait                            # [T]
    winner = waiting & (tbl[strm_tile] == state.strm_key) \
        & rotate[strm_tile]                                # [S]
    in_s = scatter(torch.zeros(T, dtype=torch.int64, device=dev),
                   strm_tile, sids, "max", mask=winner)    # [T]

    # Save the outgoing contexts into the store (rotating tiles only).
    def save(store, seat_val):
        return scatter(store, sst, seat_val, "set", mask=rotate)

    max_key = torch.amax(state.strm_key)
    state = state._replace(
        strm_cursor=save(state.strm_cursor, state.cursor),
        strm_clock=save(state.strm_clock, state.clock),
        strm_pend_kind=save(state.strm_pend_kind, state.pend_kind),
        strm_pend_addr=save(state.strm_pend_addr, state.pend_addr),
        strm_pend_issue=save(state.strm_pend_issue, state.pend_issue),
        strm_pend_aux=save(state.strm_pend_aux, state.pend_aux),
        strm_pend_extra=save(state.strm_pend_extra, state.pend_extra),
        strm_done=save(state.strm_done, state.done),
        # Each rotating tile adds a distinct offset: keys stay unique.
        strm_key=save(state.strm_key, max_key + 1 + tiles),
    )

    # Load the incoming contexts.
    def load(seat_val, store):
        return torch.where(rotate, store[in_s], seat_val)

    state = state._replace(
        cursor=load(state.cursor, state.strm_cursor),
        clock=torch.where(rotate,
                          torch.maximum(state.strm_clock[in_s], state.clock),
                          state.clock),
        done=load(state.done, state.strm_done),
        pend_kind=load(state.pend_kind, state.strm_pend_kind),
        pend_addr=load(state.pend_addr, state.strm_pend_addr),
        pend_issue=load(state.pend_issue, state.strm_pend_issue),
        pend_aux=load(state.pend_aux, state.strm_pend_aux),
        pend_extra=load(state.pend_extra, state.strm_pend_extra),
        seat_stream=torch.where(rotate, in_s, sst).to(torch.int32),
        seat_since=torch.where(rotate, state.boundary, state.seat_since),
        seat_yield=state.seat_yield & ~rotate,
    )
    # A context switch restores the incoming thread's registers: the
    # scoreboard (iocoom only; [0, T] otherwise) starts all-ready.
    if state.reg_ready.shape[0] > 0:
        state = state._replace(reg_ready=torch.where(
            rotate[None, :], 0, state.reg_ready))
    return state


def _progress(st: SimState, chain: bool) -> int:
    """Cursor sum + clock sum, plus at P > 0 the memory-stall sum: a
    mid-chain serve moves neither cursor nor clock until the chain
    drains, but it strictly increases the stall counter."""
    p = torch.sum(st.cursor.to(torch.int64)) + torch.sum(st.clock)
    if chain:
        p = p + torch.sum(st.counters.mem_stall_ps)
    return int(p.item())


def quantum_step(params: SimParams, state: SimState,
                 trace: TraceArrays, vp: VariantParams = None,
                 group=None) -> SimState:
    """One barrier quantum: sub-rounds of (local_advance ; resolve) while
    the progress witness moves, capped at ``rounds_per_quantum`` — at
    P > 0 at max(rounds_per_quantum, max_events_per_quantum), since the
    sub-round loop then alternates banking with resolve passes.
    ``group``: the rank's ShardGroup under ``tpu/tile_shards`` > 1."""
    if vp is None:
        vp = variant_params(params)
    state = state._replace(boundary=next_boundary(params, state, vp=vp,
                                                  group=group),
                           ctr_quantum=state.ctr_quantum + 1)
    if state.sched_enabled:
        state = schedule_rotate(params, state, vp=vp)
    chain = params.miss_chain > 0
    cap = max(params.rounds_per_quantum, params.max_events_per_quantum) \
        if chain else params.rounds_per_quantum
    ff0 = state.ctr_ff
    i, prev, cur = 0, -1, _progress(state, chain)
    while i < cap and (i == 0 or cur > prev):
        state = local_advance(params, state, trace, vp=vp, group=group)
        state = resolve(params, state, vp=vp)
        i, prev, cur = i + 1, cur, _progress(state, chain)
    if params.fast_forward > 0:
        # A quantum counts as fast-forwarded once if some sub-round grew
        # ctr_ff (ctr_ffq / ctr_quantum is the ff-quanta fraction).
        state = state._replace(
            ctr_ffq=state.ctr_ffq + (state.ctr_ff > ff0).to(torch.int64))
    return state


def megarun(params: SimParams, state: SimState, trace: TraceArrays,
            max_quanta: int, vp: VariantParams = None,
            group=None) -> SimState:
    """Run quantum steps until the simulation completes or ``max_quanta``
    quanta elapse (the JAX ``megarun_loop`` with ``masked=False``).  At
    ``tpu/tile_shards`` = S > 1 each of S ranks runs this on the whole
    state with ``group``, its parallel.mesh.ShardGroup of S ranks (the
    JAX ``megarun`` under ``shard_wrap``).  Resident shard state is
    refused, as the JAX ``megarun`` refuses it."""
    if params.shard_state == "resident":
        raise ValueError("tpu/shard_state=resident runs through the "
                         "resident program, not the replicated quantum "
                         "program")
    check_group(params.tile_shards, group)
    if vp is None:
        vp = variant_params(params)
    done = bool(state.all_done().item())
    n = 0
    while not done and n < max_quanta:
        state = quantum_step(params, state, trace, vp=vp, group=group)
        n += 1
        done = bool(state.all_done().item())
    return state
