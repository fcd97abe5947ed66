"""The quantum engine: lax-barrier-synchronised stepping of all tiles.

Counterpart of ``graphite_tpu/engine/quantum.py``: the boundary is
recomputed from the min clock over runnable tiles (skipping empty
quanta), and a quantum step is sub-rounds of (local_advance ; resolve)
while the progress witness moves, capped at ``rounds_per_quantum``; at
``tpu/fast_forward`` > 0 the quantum counts in ``ctr_ffq`` when it
fast-forwarded.
``megarun`` runs quantum steps until every stream is done or a quanta
budget is spent.  The JAX package runs these loops on the device; here
each loop condition is one host read of a device scalar, and the trip
counts (``ctr_quantum`` and everything below it) match exactly.
"""

from __future__ import annotations

import torch

from graphite_tpu_torch.engine.core import local_advance
from graphite_tpu_torch.engine.resolve import resolve
from graphite_tpu_torch.engine.state import (
    PEND_BARRIER, PEND_CBC, PEND_COND, PEND_CSIG, PEND_JOIN, PEND_MUTEX,
    PEND_RECV, PEND_SEND, PEND_START, SimState, TraceArrays)
from graphite_tpu_torch.engine.vparams import VariantParams, variant_params
from graphite_tpu_torch.params import SimParams
from graphite_tpu_torch.time_base import TIME_MAX


def next_boundary(params: SimParams, state: SimState,
                  vp: VariantParams = None) -> torch.Tensor:
    """Advance the barrier boundary past the slowest runnable tile,
    skipping empty quanta."""
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
    min_clock = torch.amin(masked)
    q = vp.quantum_ps if vp is not None else params.quantum_ps
    nb = (min_clock // q + 1) * q
    return torch.where(runnable.any(), nb, state.boundary + q).to(
        torch.int64)


def _progress(st: SimState, chain: bool) -> int:
    """Cursor sum + clock sum, plus at P > 0 the memory-stall sum: a
    mid-chain serve moves neither cursor nor clock until the chain
    drains, but it strictly increases the stall counter."""
    p = torch.sum(st.cursor.to(torch.int64)) + torch.sum(st.clock)
    if chain:
        p = p + torch.sum(st.counters.mem_stall_ps)
    return int(p.item())


def quantum_step(params: SimParams, state: SimState,
                 trace: TraceArrays,
                 vp: VariantParams = None) -> SimState:
    """One barrier quantum: sub-rounds of (local_advance ; resolve) while
    the progress witness moves, capped at ``rounds_per_quantum`` — at
    P > 0 at max(rounds_per_quantum, max_events_per_quantum), since the
    sub-round loop then alternates banking with resolve passes."""
    if vp is None:
        vp = variant_params(params)
    state = state._replace(boundary=next_boundary(params, state, vp=vp),
                           ctr_quantum=state.ctr_quantum + 1)
    chain = params.miss_chain > 0
    cap = max(params.rounds_per_quantum, params.max_events_per_quantum) \
        if chain else params.rounds_per_quantum
    ff0 = state.ctr_ff
    i, prev, cur = 0, -1, _progress(state, chain)
    while i < cap and (i == 0 or cur > prev):
        state = local_advance(params, state, trace, vp=vp)
        state = resolve(params, state, vp=vp)
        i, prev, cur = i + 1, cur, _progress(state, chain)
    if params.fast_forward > 0:
        # A quantum counts as fast-forwarded once if some sub-round grew
        # ctr_ff (ctr_ffq / ctr_quantum is the ff-quanta fraction).
        state = state._replace(
            ctr_ffq=state.ctr_ffq + (state.ctr_ff > ff0).to(torch.int64))
    return state


def megarun(params: SimParams, state: SimState, trace: TraceArrays,
            max_quanta: int, vp: VariantParams = None) -> SimState:
    """Run quantum steps until the simulation completes or ``max_quanta``
    quanta elapse (the JAX ``megarun_loop`` with ``masked=False``)."""
    if vp is None:
        vp = variant_params(params)
    done = bool(state.all_done().item())
    n = 0
    while not done and n < max_quanta:
        state = quantum_step(params, state, trace, vp=vp)
        n += 1
        done = bool(state.all_done().item())
    return state
