"""Cross-tile resolution of pending requests.

Counterpart of ``graphite_tpu/engine/resolve.py`` on this slice's path:
``resolve_memory`` (a directory under MSI or MOSI with private L2, or
the per-tile L2 slices under shared-L2 MSI or MESI, full-map or one of
the four limited schemes; every network model, with the hop-by-hop
mesh's contended link flights; every DRAM queue model, or none) with,
at ``tpu/miss_chain > 0`` under a full-map directory, the blocking
chain replay ``chain_fast_pass`` in front of its conflict rounds, and the sync resolvers (CAPI receives and back-pressured sends,
barriers, condition variables, mutexes, joins and thread starts), with
the ThreadScheduler's stream store where there are more trace streams
than tiles.  Every parked request (or chain head) of
every tile is priced and applied at once; same-line races are serialised
by conflict rounds, in which each line's earliest pending request
transacts and later ones see the post-transaction directory.  The
conflict-round ``while_loop``, the chain pass's ``fori_loop`` and the
pass-level ``cond`` gates become Python loops and ``if``s, running
exactly the JAX trip counts (``ctr_conflict``, ``ctr_resolve`` and
``round_ctr`` are part of the state).  With ``track_miss_types`` both
the chain pass and the conflict rounds classify every served miss as
cold, capacity or sharing (:func:`_classify_misses`).  Under iocoom
cores (uniform or mixed) the chain pass stands down, and a plain load or
store miss releases its tile at issue + 1 cycle, floored by its load or
store queue slot, while the queue keeps its priced completion.

Sharer bitmaps are int64 words with the ``uint64`` bits of the JAX
package; the modular negations and delta adds wrap identically.
"""

from __future__ import annotations

import torch

from graphite_tpu_torch.engine import cache as cachemod
from graphite_tpu_torch.engine import dense
from graphite_tpu_torch.engine import directory as dirmod
from graphite_tpu_torch.engine import noc
from graphite_tpu_torch.engine import noc_flight
from graphite_tpu_torch.engine import queue_models
from graphite_tpu_torch.engine.core import STAMP_STRIDE, _lat, _period, \
    mcp_tile
from graphite_tpu_torch.engine.kernels import chain as kchain
from graphite_tpu_torch.engine.kernels import window as kwindow
from graphite_tpu_torch.engine.ops import (first_true, scatter, scatter_last,
                                           umod64)
from graphite_tpu_torch.engine.state import (
    NUM_CONDS, PEND_BARRIER, PEND_CBC, PEND_COND, PEND_CSIG, PEND_EX_REQ,
    PEND_IFETCH, PEND_JOIN, PEND_MUTEX, PEND_NONE, PEND_RECV, PEND_SEND,
    PEND_SH_REQ, PEND_START, SimState, dword_owner, dword_pack, dword_stamp,
    dword_state, dword_tag, dword_with_meta)
from graphite_tpu_torch.engine.vparams import VariantParams, variant_params
from graphite_tpu_torch.isa import DVFSModule
from graphite_tpu_torch.params import SimParams

I, S, O, E, M = (cachemod.I, cachemod.S, cachemod.O, cachemod.E,
                 cachemod.M)

# Line -> home / DRAM site / directory set live in dense.py (where the
# chain classify kernel's wrapper reaches them); re-exported here.
home_of_line = dense.home_of_line
dram_site_of_line = dense.dram_site_of_line
dir_set_of_line = dense.dir_set_of_line
_BIG = 2**62
_oh = dense.onehot
_sel = dense.sel
_fcfs_keys = dense.fcfs_keys
_elect = dense.elect
_grouped_rank = dense.grouped_rank


def _unblock(state: SimState, mask, completion, sync: bool) -> SimState:
    c = state.counters
    stall = torch.where(mask, completion - state.pend_issue, 0)
    if sync:
        c = c._replace(sync_stall_ps=c.sync_stall_ps + stall)
    else:
        c = c._replace(mem_stall_ps=c.mem_stall_ps + stall)
    return state._replace(
        clock=torch.where(mask, completion, state.clock),
        cursor=state.cursor + torch.where(mask, 1, 0).to(torch.int32),
        pend_kind=torch.where(mask, PEND_NONE, state.pend_kind).to(
            torch.int32),
        counters=c,
    )


def _parked(st: SimState) -> torch.Tensor:
    k = st.pend_kind
    return (k == PEND_SH_REQ) | (k == PEND_EX_REQ) | (k == PEND_IFETCH)


def _classify_misses(state: SimState, rows, line, served, dlv_lines,
                     dlv_valid, dlv_down) -> SimState:
    """Miss-type classification (``[cache]/track_miss_types``): each
    served miss is sharing (its line was taken from this tile by
    coherence), capacity (seen before, evicted since) or cold.  The
    filters are direct-mapped per-tile line tables (keys line + 1, in
    int32, wrapping as in the JAX package); a hash collision can
    misclassify one miss, never mistime anything.  The fill marks the
    line seen and consumes its inv mark; then each delivery down to I
    marks the target tile's inv filter (two deliveries to one tile may
    hash to one slot: the last in row order wins, as in the JAX
    package's scatter)."""
    T = rows.shape[0]
    HF = state.seen_filter.shape[1]
    fslot = umod64(dense.fmix64(line), HF)
    key32 = (line + 1).to(torch.int32)
    seen_hit = torch.gather(state.seen_filter, 1, fslot[:, None])[:, 0] \
        == key32
    inv_hit = torch.gather(state.inv_filter, 1, fslot[:, None])[:, 0] \
        == key32
    m_shar = served & inv_hit
    c = state.counters
    state = state._replace(counters=c._replace(
        l2_miss_cold=c.l2_miss_cold
        + (served & ~inv_hit & ~seen_hit).to(torch.int64),
        l2_miss_capacity=c.l2_miss_capacity
        + (served & ~inv_hit & seen_hit).to(torch.int64),
        l2_miss_sharing=c.l2_miss_sharing + m_shar.to(torch.int64)))
    state = state._replace(
        seen_filter=scatter(state.seen_filter, (rows, fslot), key32, "set",
                            mask=served),
        inv_filter=scatter(state.inv_filter, (rows, fslot), 0, "set",
                           mask=m_shar))
    dslot = umod64(dense.fmix64(dlv_lines), HF)
    return state._replace(inv_filter=scatter_last(
        state.inv_filter, (rows[:, None].expand(T, dslot.shape[1]), dslot),
        (dlv_lines + 1).to(torch.int32), mask=dlv_valid & (dlv_down == I)))


# ===================================================================== memory

def chain_fast_pass(params: SimParams, vp: VariantParams, state: SimState,
                    H: int, ftbl: torch.Tensor):
    """Serve whole banked miss chains in ONE resolve pass with blocking
    semantics (the JAX ``chain_fast_pass``): exactly P iterations, each
    serving every tile's CURRENT chain head with the round loop's math —
    element k+1 probes the directory state element k (and the other
    tiles' served elements) wrote, and installs its line at serve time.
    A chain stops at its first element that needs machinery the replay
    does not carry (``hard_stop``); the conflict rounds serve the rest.
    Each iteration's head gathers, directory-row gathers and classify
    step are ``kernels/chain.run_chain_step`` (one CUDA kernel launch on
    the card); the DRAM queue probe and the apply scatters stay here.
    The P iterations always all run (no host poll ends the pass early),
    so the kernel launches P times per pass."""
    P = params.miss_chain
    T = params.num_tiles
    A = params.directory.associativity
    W = state.dir_sharers.shape[0] // A
    dev = state.clock.device
    rows = torch.arange(T, device=dev)
    head0 = state.mq_head
    stop_hi = state.mq_count
    fanout = params.fanout_replay
    KF = min(params.max_inv_fanout_per_round, T)
    queue_on = params.dram.queue_model_enabled
    shared_l2 = params.shared_l2

    # Per-tile constants of the pass (clock periods change only in a
    # complex slot, never mid-resolve), contiguous for the kernel.  With
    # shared L2 the "directory" access is the slice's cache access,
    # clocked by the L2 domain.
    p_net, p_dir, p_l2, p_l1d, p_l1i, p_core = (
        _period(state, m).contiguous() for m in (
            DVFSModule.NETWORK_MEMORY,
            DVFSModule.L2_CACHE if shared_l2 else DVFSModule.DIRECTORY,
            DVFSModule.L2_CACHE, DVFSModule.L1_DCACHE,
            DVFSModule.L1_ICACHE, DVFSModule.CORE))
    dram_access_ps = vp.dram_latency_ps
    dram_service_ps = vp.dram_processing_ps
    flits_req = noc.num_flits(kchain.CTRL_BYTES, vp.net_memory.flit_width_bits)
    flits_data = noc.num_flits(params.line_size + kchain.CTRL_BYTES,
                               vp.net_memory.flit_width_bits)
    rstamp = state.round_ctr * STAMP_STRIDE + STAMP_STRIDE - 1
    svc = torch.full((T,), dram_service_ps, dtype=torch.int64, device=dev)
    req_word = (rows // 64).to(torch.int64)
    req_bit = torch.ones(T, dtype=torch.int64, device=dev) \
        << (rows % 64).to(torch.int64)

    stopped = torch.zeros(T, dtype=torch.bool, device=dev)
    head = head0
    base = torch.where(head0 == 0, 0, state.chain_base)
    for _ in range(P):
        # Each iteration serves every tile's current head: an election
        # loser retries the same element next iteration while the
        # winner's chain moves on.  The head and directory-row gathers
        # are part of the step (one kernel launch on the card).
        ch, co = kchain.run_chain_step(params, vp, kchain.ChainStepIn(
            mq_req=state.mq_req, mq_delta=state.mq_delta,
            mq_extra=state.mq_extra, head=head, stopped=stopped,
            stop_hi=stop_hi, base=base, dir_word=state.dir_word,
            dir_sharers=state.dir_sharers, p_net=p_net, p_dir=p_dir,
            p_l2=p_l2, p_l1d=p_l1d, p_l1i=p_l1i, p_core=p_core,
            ftbl=None if queue_on else ftbl), H)
        line, is_ex, is_if = ch.line, ch.is_ex, ch.is_if
        issue, extra, home = ch.issue, ch.extra, ch.home
        fidx64 = ch.fidx.to(torch.int64)
        serve, serve_all = co.serve, co.serve_all
        owner_leg, fan_go = co.owner_leg, co.fan_go
        need_read, dram_wb = co.need_read, co.dram_wb
        t_dir, inv_count = co.t_dir, co.inv_count
        stopped = stopped | co.hard_stop

        # ---- DRAM queue + completion (the loop-carried stretch the
        # kernel hands back; with the queue model off the kernel already
        # produced completion / t_data and wrote the floors).  With shared
        # L2 the memory controller need not be the slice's tile.
        dsite = dram_site_of_line(params, line) if shared_l2 else home
        if queue_on:
            # record_split: one batch mixes tiles at very different
            # simulated times; split busy records stop one tile's
            # far-future element from convoying another's chain.
            q_start, _, _, rs_, re_, rp_, mg1_ = queue_models.probe(
                params.dram.queue_model_type,
                dsite, co.dram_arrival, svc,
                need_read, state.dram_ring_start, state.dram_ring_end,
                state.dram_ring_ptr, state.dram_qacc,
                occ_res=dsite, occ_arr=co.dram_arrival,
                occ_svc=svc, occ_valid=dram_wb,
                ma_window=params.dram.basic_ma_window,
                record_split=2 if fanout else 1)
            state = state._replace(dram_ring_start=rs_, dram_ring_end=re_,
                                   dram_ring_ptr=rp_, dram_qacc=mg1_)
            dram_start = torch.where(need_read, q_start, 0)
            dram_ready = dram_start + dram_access_ps + dram_service_ps \
                + co.from_dram_ps
            t_data = torch.maximum(t_dir + co.owner_ps,
                                   torch.where(need_read, dram_ready, 0))
            if fanout:
                # The data grant waits on the last invalidation ack.
                t_data = torch.maximum(t_data, t_dir + co.inv_ps)
            completion = t_data + co.reply_ps + co.l1_fill_ps + extra
            if not shared_l2:
                completion = completion + _lat(vp.l2_access_cycles, p_l2)
        else:
            t_data, completion, ftbl = co.t_data, co.completion, co.ftbl

        # ---- apply: directory entry + sharer-bitmap delta (winners hold
        # distinct (home, dset, way) slots by the election)
        way64 = co.way.to(torch.int64)
        state = state._replace(dir_word=scatter(
            state.dir_word, (way64, fidx64),
            dword_pack(line, state.round_ctr, co.new_state, co.new_owner),
            "set", mask=serve))
        # Representatives land (new - old) per plane; combining members
        # add their own bit on top — one merged scatter-add.
        plane = torch.arange(W, device=dev)[:, None] * A + way64[None, :]
        add_rows = torch.cat([plane.reshape(-1), req_word * A + way64])
        add_cols = torch.cat([fidx64[None, :].expand(W, T).reshape(-1),
                              fidx64])
        add_mask = torch.cat([serve[None, :].expand(W, T).reshape(-1),
                              co.member_add])
        add_vals = torch.cat([co.delta_sh.T.reshape(-1), req_bit])
        state = state._replace(dir_sharers=scatter(
            state.dir_sharers, (add_rows, add_cols), add_vals, "add",
            mask=add_mask))

        # ---- owner-side downgrade deliveries: per-target [T, J_OWN]
        # line lists (ranks < J_OWN are unique per target by the budget
        # election), one invalidate/downgrade sweep per cache
        ow_tgt = co.owner.to(torch.int64)
        ow_slot = co.ow_slot.to(torch.int64)
        own_lines = scatter(torch.zeros((T, kchain.J_OWN), dtype=torch.int64,
                                        device=dev), (ow_tgt, ow_slot), line,
                            "set", mask=owner_leg)
        own_valid = scatter(torch.zeros((T, kchain.J_OWN), dtype=torch.bool,
                                        device=dev), (ow_tgt, ow_slot), True,
                            "set", mask=owner_leg)
        own_down = scatter(torch.zeros((T, kchain.J_OWN), dtype=torch.int32,
                                       device=dev), (ow_tgt, ow_slot),
                           co.down_to, "set", mask=owner_leg)
        if fanout:
            # Fan-out INV deliveries ride the same per-target sweep.
            dlv_lines = torch.cat(
                [own_lines, co.line_fr[None, :].expand(T, KF)], dim=1)
            dlv_valid = torch.cat([own_valid, co.inv_bool.T], dim=1)
            dlv_down = torch.cat(
                [own_down, torch.full((T, KF), I, dtype=torch.int32,
                                      device=dev)], dim=1)
        else:
            dlv_lines, dlv_valid, dlv_down = own_lines, own_valid, own_down
        state = state._replace(
            l2=cachemod.invalidate_by_value(
                state.l2, dlv_lines, dlv_valid, dlv_down),
            l1d=cachemod.invalidate_by_value(
                state.l1d, dlv_lines, dlv_valid, dlv_down))

        # ---- requester-side fills at serve time + victim notify / DRAM
        # writeback occupancy
        if shared_l2:
            state, victim_dirty = _sh_l2_fills(
                params, state, rows, line, is_ex, is_if,
                serve & ~is_ex & (co.new_state == E), serve_all, rstamp)
        else:
            state, victim_dirty, victim_home = _private_fills(
                params, state, rows, line, is_ex, is_if, serve_all, t_dir,
                dram_service_ps, rstamp)
        if params.track_miss_types:
            state = _classify_misses(state, rows, line, serve_all,
                                     dlv_lines, dlv_valid, dlv_down)

        # ---- counters (home-binned tallies via one stacked scatter)
        def b(m):
            return m.to(torch.int64)

        home_cols = [
            b(serve_all & ~is_ex), b(serve & is_ex),  # dir_sh/ex_req
            b(co.evicting),                       # dir_evictions
            b(owner_leg),                         # dir_writebacks
            b(owner_leg & ~co.dram_write),        # dir_forwards
            b(serve_all) + inv_count,             # net_mem_pkts @home
            torch.where(serve_all, flits_data, 0)
            + inv_count * flits_req,              # net_mem_flits @home
            inv_count,                            # dir_invalidations
        ]
        if shared_l2:
            # Slice accesses and misses, at the home tile; the DRAM-site
            # tallies on their own index; a dirty L1 victim flushes into
            # the slice, not DRAM.
            home_cols += [b(serve_all), b(serve_all & ~co.hit)]
            db = _binsum(dsite, torch.stack([b(need_read), b(dram_wb)],
                                            dim=1))
            vic_wr = 0
        else:
            home_cols += [b(need_read), b(dram_wb)]   # dram_reads/writes
            vic_wr = scatter(torch.zeros(T, dtype=torch.int64, device=dev),
                             victim_home, 1, "add", mask=victim_dirty)
        hb = _binsum(home, torch.stack(home_cols, dim=1))
        if not shared_l2:
            db = hb[:, 8:10]
        c = state.counters
        c = c._replace(
            dir_sh_req=c.dir_sh_req + hb[:, 0],
            dir_ex_req=c.dir_ex_req + hb[:, 1],
            dir_evictions=c.dir_evictions + hb[:, 2],
            dir_writebacks=c.dir_writebacks + hb[:, 3],
            dir_forwards=c.dir_forwards + hb[:, 4],
            dir_invalidations=c.dir_invalidations + hb[:, 7],
            dram_reads=c.dram_reads + db[:, 0],
            dram_writes=c.dram_writes + db[:, 1] + vic_wr,
            l2_access=c.l2_access + (hb[:, 8] if shared_l2 else 0),
            l2_miss=c.l2_miss + (hb[:, 9] if shared_l2 else 0),
            net_mem_pkts=c.net_mem_pkts + b(serve_all) + b(victim_dirty)
            + hb[:, 5],
            net_mem_flits=c.net_mem_flits + b(serve_all) * flits_req
            + b(victim_dirty) * flits_data + hb[:, 6],
            mem_stall_ps=c.mem_stall_ps + torch.where(
                serve_all, completion - issue, 0),
            chain_fanout_served=c.chain_fanout_served + b(fan_go),
            chain_fallback=c.chain_fallback + b(co.hard_stop),
        )
        state = state._replace(counters=c)

        # ---- serialization floor for later same-line requests (with
        # the queue model off the kernel already wrote it)
        if queue_on:
            hidx64 = ch.hidx.to(torch.int64)
            tkey = t_data * T + rows
            tmax_t = scatter(torch.full((H,), -1, dtype=torch.int64,
                                        device=dev), hidx64, tkey, "max",
                             mask=serve_all)
            fwin = serve_all & (tmax_t[hidx64] == tkey)
            ftbl = dense.stacked_set_table(
                hidx64, fwin, torch.stack([line, t_data]), ftbl)
        base = torch.where(serve_all, completion, base)
        head = head + serve_all.to(torch.int32)

    # Drained chains restore the absolute clock (last completion + the
    # local time the window accumulated past the final bank); partial
    # chains keep their continuation base for the round loop.
    drained = (state.mq_count > 0) & (head >= state.mq_count)
    state = state._replace(
        mq_head=torch.where(drained, 0, head).to(torch.int32),
        mq_count=torch.where(drained, 0, state.mq_count).to(torch.int32),
        chain_base=torch.where(drained, 0, base),
        clock=torch.where(drained, base + state.chain_rel, state.clock),
        chain_rel=torch.where(drained, 0, state.chain_rel),
        round_ctr=state.round_ctr + 1,
    )
    return state, ftbl


def _binsum(idx: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """[T, n] rows summed into [T, n] bins by a [T] tile index (one
    stacked scatter-add)."""
    n = cols.shape[1]
    return scatter(torch.zeros_like(cols), (idx[:, None], torch.arange(
        n, device=cols.device)[None, :]), cols, "add")


def _private_fills(params: SimParams, state: SimState, rows, line, is_ex,
                   is_if, win, t_dir, dram_service_ps, rstamp):
    """The served requests' fills with private L2, at serve time: the L2
    fill, its victim's L1D copy dropped with it (inclusion), the L1D or
    L1I fill; a dirty L2 victim occupies its controller's queue (off the
    critical path) and every live one notifies its home directory.
    Returns (state, victim_dirty, victim_home)."""
    T = params.num_tiles
    dev = line.device
    f2 = cachemod.fill(state.l2, line,
                       torch.where(is_ex, M, S).to(torch.int32),
                       win, params.l2.num_sets, params.l2.replacement,
                       rstamp)
    state = state._replace(l2=f2.cache)
    vt1, vs1 = f2.victim_tag, f2.victim_state
    state = state._replace(l1d=cachemod.invalidate_by_value(
        state.l1d, vt1[:, None], (win & (vs1 != I))[:, None],
        torch.full((T, 1), I, dtype=torch.int32, device=dev)))
    fd = cachemod.fill(state.l1d, line,
                       torch.where(is_ex, M, S).to(torch.int32),
                       win & ~is_if, params.l1d.num_sets,
                       params.l1d.replacement, rstamp)
    fi = cachemod.fill(state.l1i, line,
                       torch.full((T,), S, dtype=torch.int32, device=dev),
                       win & is_if, params.l1i.num_sets,
                       params.l1i.replacement, rstamp)
    state = state._replace(l1d=fd.cache, l1i=fi.cache)
    victim_dirty = win & ((vs1 == M) | (vs1 == O))
    victim_home = dram_site_of_line(params, vt1)
    if params.dram.queue_model_enabled:
        r3 = queue_models.occupy(
            params.dram.queue_model_type,
            state.dram_ring_start, state.dram_ring_end,
            state.dram_ring_ptr, state.dram_qacc,
            victim_home, t_dir, dram_service_ps, victim_dirty,
            ma_window=params.dram.basic_ma_window)
        state = state._replace(dram_ring_start=r3[0], dram_ring_end=r3[1],
                               dram_ring_ptr=r3[2], dram_qacc=r3[3])
    state = _dir_evict_notify(params, state, rows, vt1, vs1,
                              win & (vs1 != I))
    return state, victim_dirty, victim_home


def _sh_l2_fills(params: SimParams, state: SimState, rows, line, is_ex,
                 is_if, granted_e, win, rstamp):
    """The served requests' fills with shared L2, at serve time: the L1D
    fill (M for a write, E for a MESI first-reader grant, else S) or the
    L1I fill; each live L1 victim reports to its home slice (a dirty
    one flushes its data there: a line-size packet, off the critical
    path).  Returns (state, victim_dirty)."""
    T = params.num_tiles
    dev = line.device
    l1_state = torch.where(is_ex, M, torch.where(granted_e, E, S)).to(
        torch.int32)
    fd = cachemod.fill(state.l1d, line, l1_state, win & ~is_if,
                       params.l1d.num_sets, params.l1d.replacement, rstamp)
    fi = cachemod.fill(state.l1i, line,
                       torch.full((T,), S, dtype=torch.int32, device=dev),
                       win & is_if, params.l1i.num_sets,
                       params.l1i.replacement, rstamp)
    state = state._replace(l1d=fd.cache, l1i=fi.cache)
    vs1 = torch.where(win & ~is_if, fd.victim_state, I)
    vlive1 = win & (vs1 != I)
    state = _sh_l1_evict_notify(params, state, rows, fd.victim_tag, vs1,
                                vlive1)
    state = _sh_l1_evict_notify(
        params, state, rows, fi.victim_tag, fi.victim_state,
        win & is_if & (fi.victim_state != I))
    return state, vlive1 & (vs1 == M)


def _contended(params: SimParams) -> bool:
    """Memory-network legs contend per link: the hop-by-hop mesh with its
    queue model on (with it off, the model prices as the hop counter)."""
    return (params.net_memory.model == "emesh_hop_by_hop"
            and params.net_memory.queue_model_enabled)


def _memory_round(params: SimParams, vp: VariantParams, state: SimState,
                  ftbl: torch.Tensor):
    """One conflict round of resolve_memory (the JAX ``round_body``)."""
    T = params.num_tiles
    A = params.directory.associativity
    W = state.dir_sharers.shape[0] // A
    K = min(params.max_inv_fanout_per_round, T)
    H = max(1024, 16 * T)
    dev = state.clock.device
    rows = torch.arange(T, device=dev)
    line_bits = params.line_size.bit_length() - 1
    ndsets = params.directory.num_sets
    shared_l2 = params.shared_l2

    # With shared L2 the "directory" access is the slice's cache access,
    # clocked by the L2 domain.
    p_net = _period(state, DVFSModule.NETWORK_MEMORY)
    p_dir = _period(state, DVFSModule.L2_CACHE if shared_l2
                    else DVFSModule.DIRECTORY)
    p_l2 = _period(state, DVFSModule.L2_CACHE)
    p_l1 = _period(state, DVFSModule.L1_DCACHE)
    p_core = _period(state, DVFSModule.CORE)
    cycle_ps = _lat(1, p_core)
    ack_ps = _lat(vp.inv_ack_cycles, p_core)

    dram_access_ps = vp.dram_latency_ps
    dram_service_ps = vp.dram_processing_ps
    flits_req = noc.num_flits(kchain.CTRL_BYTES, vp.net_memory.flit_width_bits)
    flits_data = noc.num_flits(params.line_size + kchain.CTRL_BYTES,
                               vp.net_memory.flit_width_bits)

    rstamp = state.round_ctr * STAMP_STRIDE + STAMP_STRIDE - 1
    # The one-hot [T, H] tables while they fit the dense cap (T <= 512),
    # real scatters above it, as in the JAX package.
    dense_tables = T * H <= dense.DENSE_MAX_ELEMS

    P = params.miss_chain
    if P > 0:
        # The active request is each tile's chain head (at P > 0 memory
        # misses always bank, never park).  Element 0's delta is its
        # absolute issue time; later elements chain off the previous
        # element's continuation point.
        slots_p = torch.arange(P, dtype=torch.int32, device=dev)[:, None]
        head_oh = slots_p == state.mq_head[None, :]          # [P, T]

        def hsel(arr):
            return torch.sum(torch.where(head_oh, arr, 0), dim=0)

        req = hsel(state.mq_req)
        cdelta = hsel(state.mq_delta)
        issue = torch.where(state.mq_head == 0, cdelta,
                            state.chain_base + cdelta)
        kind = (req & 7).to(torch.int32)
        line = req >> 8
        extra = hsel(state.mq_extra)
        # Bit 3 of the word is an atomic's flag, which the iocoom
        # unpark reads (an atomic waits its full round trip).
        aux = ((req >> 3) & 1).to(torch.int32)
        unres = state.mq_head < state.mq_count
    else:
        kind = state.pend_kind
        line = state.pend_addr >> line_bits
        issue = state.pend_issue
        extra = state.pend_extra
        aux = state.pend_aux
        unres = _parked(state)
    is_ex = unres & (kind == PEND_EX_REQ)
    is_if = unres & (kind == PEND_IFETCH)
    home = home_of_line(params, line)
    dset = dir_set_of_line(params, line)
    fidx = (home * ndsets + dset).to(torch.int64)
    packed = _fcfs_keys(unres, issue)
    hidx = umod64(dense.fmix64(line), H)
    oh_hidx = _oh(hidx, H) if dense_tables else None
    p_net_home = p_net[home.to(torch.int64)]
    p_dir_home = p_dir[home.to(torch.int64)]
    contended = _contended(params)
    if not contended:
        net_req = noc.unicast_ps(params.net_memory, rows, home,
                                 kchain.CTRL_BYTES, p_net, params.mesh_width,
                                 vnet=vp.net_memory)
        reply_ps = noc.unicast_ps(params.net_memory, home, rows,
                                  params.line_size + kchain.CTRL_BYTES,
                                  p_net_home, params.mesh_width,
                                  vnet=vp.net_memory)
    dir_ps = _lat(vp.dir_access_cycles, p_dir_home)
    ftbl_g = ftbl[:, hidx]                     # [2, T]
    line_floor = torch.where(ftbl_g[0] == line, ftbl_g[1], 0)

    # ---- earliest-per-line election
    if dense_tables:
        tbl = torch.amin(torch.where(oh_hidx & unres[:, None],
                                     packed[:, None], _BIG), dim=0)
        win = unres & (_sel(oh_hidx, tbl) == packed)
    else:
        win = _elect(unres, packed, hidx, H)

    # ---- directory-cache probe at (home, dset)
    drow = state.dir_word[:, fidx].T                     # [T, A]
    dstate = dword_state(drow)
    dstamp = dword_stamp(drow)
    match = (dword_tag(drow) == line[:, None].to(torch.int32)) \
        & (dstate != I)
    hit = match.any(dim=1)
    hway = first_true(match, 1).to(torch.int32)
    invalid = dstate == I

    # ---- victim-way assignment for allocating (miss) winners
    hitwin = win & hit
    misswin = win & ~hit
    grank = _grouped_rank(fidx, packed, misswin)
    fhash = umod64(dense.fmix64(fidx), H)
    used_tbl = scatter(torch.zeros((H, A), dtype=torch.bool, device=dev),
                       (fhash, hway), True, "set", mask=hitwin)
    hway_used = used_tbl[fhash]                           # [T, A]
    NEVER = 2**31 - 1
    vkey = torch.where(hway_used, NEVER,
                       torch.where(invalid, -1, dstamp)).to(torch.int32)
    eligible = ~hway_used
    arA0 = torch.arange(A, dtype=torch.int32, device=dev)
    pos = torch.sum(
        (eligible[:, None, :]
         & ((vkey[:, None, :] < vkey[:, :, None])
            | ((vkey[:, None, :] == vkey[:, :, None])
               & (arA0[None, None, :] < arA0[None, :, None])))),
        dim=2).to(torch.int32)
    n_elig = torch.sum(eligible, dim=1).to(torch.int32)
    miss_way = first_true(eligible & (pos == grank[:, None]), 1).to(
        torch.int32)
    can_alloc = misswin & (grank < n_elig)
    way = torch.where(hit, hway, miss_way)

    # ---- way-slot election safety net
    am = (home.to(torch.int64) * ndsets + dset) * A + way
    aidx = umod64(dense.fmix64(am), H)
    alloc_defer = win & ((misswin & ~can_alloc)
                         | ~_elect(win, packed, aidx, H))
    win = win & ~alloc_defer
    misswin = misswin & ~alloc_defer

    way64 = way.to(torch.int64)
    way_word = torch.gather(drow, 1, way64[:, None])[:, 0]
    way_state = dword_state(way_word)
    way_owner = dword_owner(way_word)
    evicting = misswin & (way_state != I)

    dsharers = state.dir_sharers[:, fidx].reshape(W, A, T).permute(2, 1, 0)
    entry_state = torch.where(hit, way_state, I).to(torch.int32)
    entry_owner = torch.where(hit, way_owner, -1).to(torch.int32)
    vsharers = torch.gather(dsharers, 1,
                            way64[:, None, None].expand(T, 1, W))[:, 0, :]
    entry_sharers = torch.where(hit[:, None], vsharers,
                                torch.zeros((T, W), dtype=torch.int64,
                                            device=dev))

    vtag = dword_tag(way_word).to(torch.int64)
    vstate = torch.where(evicting, way_state, I)
    vowner = way_owner
    # Owner-flush victims: M, and under shared-L2 MESI E too (the
    # exclusive owner may have upgraded silently, so its flush is priced
    # and written back like a dirty one).  O victims (MOSI) carry their
    # owner in the sharer bitmap: one multicast reaches owner and
    # sharers, and the owner's dirty data also reaches DRAM.
    if params.protocol_kind == "sh_l2_mesi":
        evict_m = evicting & ((vstate == M) | (vstate == E)) \
            & (vowner >= 0)
    else:
        evict_m = evicting & (vstate == M) & (vowner >= 0)
    evict_s = evicting & ((vstate == S) | (vstate == O)) \
        & (vsharers != 0).any(dim=1)

    act = dirmod.transition(params.protocol_kind, is_ex, rows,
                            entry_state, entry_owner, entry_sharers, W,
                            is_ifetch=is_if)

    # ---- limited directory schemes (reference directory_schemes/
    # directory_entry_{limited_broadcast,limited_no_broadcast,ackwise,
    # limitless}.cc).  The bitmap stays a full map; each scheme adds its
    # behaviour on top:
    #   limited_no_broadcast — an add past max_hw_sharers first
    #     invalidates the lowest other sharer (pointer eviction);
    #   limitless — an access to an entry past the hardware pointers
    #     traps to software (software_trap_penalty directory cycles);
    #   limited_broadcast — an overflowed entry's invalidation
    #     broadcasts: its latency spans every tile and T-1 INV packets
    #     go out;
    #   ackwise — the T-1 packets, at the true sharers' ack latency.
    # Pointer pressure leaves out the requester's own bit (a tracked
    # sharer asking again takes no new pointer); overflow counts every
    # tracked pointer.
    scheme = params.directory.directory_type
    k_hw = params.directory.max_hw_sharers
    scheme_dir_ps = 0
    bcast_lat = bcast_traffic = None
    if scheme != "full_map":
        others = entry_sharers & ~dirmod.make_tile_bit(rows, W)
        n_sh = dirmod.popcount(others)
        if scheme == "limitless":
            scheme_dir_ps = torch.where(
                hit & (n_sh >= k_hw),
                _lat(vp.limitless_trap_cycles, p_dir_home), 0)
        elif scheme == "limited_no_broadcast":
            overflow_add = ~is_ex & (n_sh >= k_hw) & (others != 0).any(dim=1)
            vbit = dirmod.lowest_bit(others)
            act = act._replace(
                inv_targets=torch.where(overflow_add[:, None],
                                        act.inv_targets | vbit,
                                        act.inv_targets),
                new_sharers=torch.where(overflow_add[:, None],
                                        act.new_sharers & ~vbit,
                                        act.new_sharers))
        else:   # limited_broadcast, ackwise
            bcast_traffic = dirmod.popcount(entry_sharers) > k_hw
            if scheme == "limited_broadcast":
                bcast_lat = bcast_traffic

    has_inv = win & (act.inv_targets != 0).any(dim=1)
    owner = act.owner_tile
    vown_c = torch.clamp(vowner, min=0).to(torch.int64)

    # ---- fan-out budget: at most K multicast deliveries per round, in
    # FCFS key order.
    need_fan = has_inv | evict_s
    fan_rank = torch.sum(
        (packed[None, :] < packed[:, None]) & need_fan[None, :]
        & need_fan[:, None], dim=1, dtype=torch.int32)
    sel0 = need_fan & (fan_rank < K)
    fan_defer = need_fan & ~sel0
    win1 = win & ~fan_defer

    # ---- owner-side delivery slots: at most J_OWN per target tile
    owner_leg1 = act.owner_leg & win1
    evict_m1 = evict_m & ~fan_defer
    tgt2 = torch.cat([owner.to(torch.int64), vown_c])
    val2 = torch.cat([owner_leg1, evict_m1])
    key2 = torch.cat([packed, packed])
    posr = _grouped_rank(tgt2, key2, val2)            # [2T]
    over2 = val2 & (posr >= kchain.J_OWN)
    ow_defer = over2[:T] | over2[T:]
    win = win1 & ~ow_defer
    has_inv = has_inv & ~fan_defer & ~ow_defer
    evict_m = evict_m1 & ~ow_defer
    evict_s = evict_s & ~fan_defer & ~ow_defer
    evicting = evicting & ~fan_defer & ~ow_defer
    evict_o = evicting & (vstate == O)
    owner_leg = owner_leg1 & ~ow_defer
    val2 = torch.cat([owner_leg, evict_m])

    lines2 = torch.cat([line, vtag])
    down2 = torch.cat(
        [act.owner_downgrade_to,
         torch.full((T,), I, dtype=torch.int32, device=dev)])
    put = val2 & (posr < kchain.J_OWN)
    slot2 = torch.clamp(posr, max=kchain.J_OWN - 1).to(torch.int64)
    own_lines = scatter(torch.zeros((T, kchain.J_OWN), dtype=lines2.dtype,
                                    device=dev), (tgt2, slot2), lines2,
                        "set", mask=put)
    own_valid = scatter(torch.zeros((T, kchain.J_OWN), dtype=torch.bool,
                                    device=dev), (tgt2, slot2), True,
                        "set", mask=put)
    own_tgt = scatter(torch.zeros((T, kchain.J_OWN), dtype=torch.int32,
                                  device=dev), (tgt2, slot2), down2,
                      "set", mask=put)

    # ---- shared-read combining: concurrent SH_REQs against an I/S entry
    # all win beside the elected representative.  With shared L2 only
    # against an S entry: the slice fills an uncached line once (and the
    # MESI E grant needs a sole first reader).  Full map only: the
    # limited schemes take per-add pointer actions, which serialise.
    req_word = (rows // 64).to(torch.int64)
    req_bit1 = torch.ones(T, dtype=torch.int64, device=dev) \
        << (rows % 64).to(torch.int64)
    combinable = torch.zeros_like(win)
    if scheme == "full_map":
        sh_entry_ok = (entry_state == I) | (entry_state == S)
        if shared_l2:
            sh_entry_ok = sh_entry_ok & (entry_state != I)
        ex_unres = unres & is_ex
        rep_sh = win & ~is_ex & sh_entry_ok
        if dense_tables:
            any_ex = torch.any(oh_hidx & ex_unres[:, None], dim=0)
            rline = torch.amax(torch.where(oh_hidx & rep_sh[:, None],
                                           line[:, None], -1), dim=0)
            rway = torch.amax(torch.where(oh_hidx & rep_sh[:, None],
                                          way[:, None].to(torch.int64), -1),
                              dim=0)
            m_any_ex = _sel(oh_hidx, any_ex.to(torch.int32)) > 0
            m_rline = _sel(oh_hidx, rline)
            m_rway = _sel(oh_hidx, rway).to(torch.int32)
        else:
            # The three tables over one index in one scatter-max (rep_sh
            # has at most one winner per slot and the exclusive flag is
            # monotone; masked rows write the max identity), one gather
            # back.
            cmb = dense.stacked_max_table(hidx, torch.stack([
                torch.where(ex_unres, 1, -1).to(torch.int64),
                torch.where(rep_sh, line, -1),
                torch.where(rep_sh, way.to(torch.int64), -1)]), H, -1)
            g_cmb = cmb[:, hidx]
            m_any_ex = g_cmb[0] > 0
            m_rline = g_cmb[1]
            m_rway = g_cmb[2].to(torch.int32)
        combinable = unres & ~win & ~is_ex & sh_entry_ok \
            & ~m_any_ex & (m_rline == line)
        win = win | combinable
        way = torch.where(combinable, m_rway, way)
    way64 = way.to(torch.int64)
    own_word = torch.gather(entry_sharers, 1, req_word[:, None])[:, 0]
    sharer_add = combinable & ((own_word & req_bit1) == 0)

    sel = sel0 & ~ow_defer
    rank = queue_models._cumsum_doubling(sel.to(torch.int32)) - 1
    oh_sr = sel[None, :] & (
        torch.arange(K, dtype=torch.int32, device=dev)[:, None]
        == rank[None, :])

    def sr_sel(vals):     # [T] -> [K] values of each slot's requester
        return torch.sum(torch.where(oh_sr, vals[None, :], 0), dim=1,
                         dtype=vals.dtype)

    inv_words = torch.sum(
        torch.where((oh_sr & has_inv[None, :])[:, :, None],
                    act.inv_targets[None, :, :], 0),
        dim=1, dtype=torch.int64)                    # [K, W]
    vic_words = torch.sum(
        torch.where((oh_sr & evict_s[None, :])[:, :, None],
                    vsharers[None, :, :], 0),
        dim=1, dtype=torch.int64)
    inv_bool = dirmod.bitmap_to_bool(inv_words, T)   # [K, T]
    vic_bool = dirmod.bitmap_to_bool(vic_words, T)
    if bcast_lat is not None:
        # limited_broadcast overflow: the broadcast completes on the acks
        # of every tile, not just the true sharers.
        bl_k = torch.any(oh_sr & (bcast_lat & has_inv)[None, :], dim=1)
        inv_bool = inv_bool | bl_k[:, None]

    home_sr = sr_sel(home)
    pnh_sr = sr_sel(p_net_home.to(torch.int64)).to(torch.int32)
    ack_sr = sr_sel(ack_ps)

    inv_ps_k = 2 * noc.max_hop_to_mask_ps(
        params.net_memory, home_sr, inv_bool, kchain.CTRL_BYTES,
        pnh_sr, params.mesh_width, vnet=vp.net_memory) + ack_sr
    vic_ps_k = 2 * noc.max_hop_to_mask_ps(
        params.net_memory, home_sr, vic_bool, kchain.CTRL_BYTES,
        pnh_sr, params.mesh_width, vnet=vp.net_memory) + ack_sr
    inv_ps = torch.where(has_inv, torch.sum(
        torch.where(oh_sr, inv_ps_k[:, None], 0), dim=0), 0)
    evict_ps = torch.where(evict_s, torch.sum(
        torch.where(oh_sr, vic_ps_k[:, None], 0), dim=0), 0)
    p_net_vown = p_net[vown_c]
    # The owner looks the line up in its private L2, or with shared L2 in
    # its L1D.
    if shared_l2:
        l2_vown_ps = _lat(vp.l1d_access_cycles, p_l1[vown_c])
    else:
        l2_vown_ps = _lat(vp.l2_access_cycles, p_l2[vown_c])

    # ---- latency assembly.  Unicast legs are zero-load closed forms,
    # or, when the hop-by-hop mesh's queue model is on, flights that
    # contend per link (engine/noc_flight.py), threading the link
    # horizons through the legs in dependency order: request -> victim
    # flush -> owner leg -> reply.  Invalidation multicasts and the
    # shared-L2 slice->controller legs stay zero-load.
    link_wait = torch.zeros(T, dtype=torch.int64, device=dev)
    lf = state.link_free_mem

    def flight(src, dst, depart, flits, active, lf, period):
        return noc_flight.flight(
            params.net_memory, params.mesh_width, params.mesh_height,
            src, dst, depart, flits, active, lf, period, vnet=vp.net_memory)

    if contended:
        fr = flight(rows, home, issue, flits_req, win, lf, p_net)
        lf = fr.link_free
        link_wait = link_wait + fr.wait_ps
        arrive = torch.maximum(fr.arrival, line_floor)
    else:
        arrive = torch.maximum(issue + net_req, line_floor)
    # Victim flush round trips: M victims always; O victims only under
    # MOSI (the private owner holds the dirty data).
    ev_rt = (evict_m | evict_o) if params.protocol_kind == "mosi" \
        else evict_m
    if contended:
        dep_ev = arrive + dir_ps
        e1 = flight(home, vown_c, dep_ev, flits_req, ev_rt, lf,
                    p_net_home)
        e2 = flight(vown_c, home, e1.arrival + l2_vown_ps, flits_data,
                    ev_rt, e1.link_free, p_net_vown)
        lf = e2.link_free
        link_wait = link_wait + e1.wait_ps + e2.wait_ps
        evict_m_ps = torch.where(ev_rt, e2.arrival - dep_ev, 0)
    else:
        evict_m_ps = noc.unicast_ps(
            params.net_memory, home, vown_c, kchain.CTRL_BYTES,
            p_net_home, params.mesh_width, vnet=vp.net_memory) \
            + l2_vown_ps \
            + noc.unicast_ps(
                params.net_memory, vown_c, home,
                params.line_size + kchain.CTRL_BYTES,
                p_net_vown, params.mesh_width, vnet=vp.net_memory)
    evict_ps = torch.where(evict_m, evict_m_ps, evict_ps)
    if params.protocol_kind == "mosi":
        # An O victim: the sharer multicast and the owner's dirty-data
        # flush, whichever ends later.
        evict_ps = torch.where(evict_o, torch.maximum(evict_ps, evict_m_ps),
                               evict_ps)

    # Replacing a live victim entry completes before the request is
    # served; scheme_dir_ps is limitless's software trap.
    t_dir = arrive + dir_ps + scheme_dir_ps \
        + torch.where(evicting, evict_ps, 0)

    owner64 = owner.to(torch.int64)
    p_net_own = p_net[owner64]
    if shared_l2:
        l2_own_ps = _lat(vp.l1d_access_cycles, p_l1[owner64])
    else:
        l2_own_ps = _lat(vp.l2_access_cycles, p_l2[owner64])
    if contended:
        g1 = flight(home, owner, t_dir, flits_req, owner_leg, lf,
                    p_net_home)
        g2 = flight(owner, home, g1.arrival + l2_own_ps, flits_data,
                    owner_leg, g1.link_free, p_net_own)
        lf = g2.link_free
        link_wait = link_wait + g1.wait_ps + g2.wait_ps
        owner_ps = torch.where(owner_leg, g2.arrival - t_dir, 0)
    else:
        leg_ps = noc.unicast_ps(params.net_memory, home, owner,
                                kchain.CTRL_BYTES, p_net_home,
                                params.mesh_width, vnet=vp.net_memory) \
            + l2_own_ps \
            + noc.unicast_ps(params.net_memory, owner, home,
                             params.line_size + kchain.CTRL_BYTES,
                             p_net_own, params.mesh_width,
                             vnet=vp.net_memory)
        owner_ps = torch.where(owner_leg, leg_ps, 0)

    need_read = win & act.dram_read
    if shared_l2:
        # The slice and the memory controller can be different tiles: a
        # slice miss adds the slice->controller request and data legs.
        dsite, to_dram_ps, from_dram_ps = kchain.slice_dram_legs(
            params, vp, line, home, p_net)
    else:
        dsite = home
        to_dram_ps = from_dram_ps = 0
    dram_arrival = t_dir + owner_ps + to_dram_ps
    dram_wb = (act.dram_write & win) | evict_m | evict_o
    if params.dram.queue_model_enabled:
        svc = torch.full((T,), dram_service_ps, dtype=torch.int64,
                         device=dev)
        q_start, _, _, rs_, re_, rp_, mg1_ = queue_models.probe(
            params.dram.queue_model_type,
            dsite, dram_arrival, svc,
            need_read, state.dram_ring_start, state.dram_ring_end,
            state.dram_ring_ptr, state.dram_qacc,
            occ_res=dsite, occ_arr=dram_arrival,
            occ_svc=svc, occ_valid=dram_wb,
            ma_window=params.dram.basic_ma_window)
        state = state._replace(dram_ring_start=rs_, dram_ring_end=re_,
                               dram_ring_ptr=rp_, dram_qacc=mg1_)
        dram_start = torch.where(need_read, q_start, 0)
    else:
        dram_start = torch.where(need_read, dram_arrival, 0)
    dram_ready = dram_start + dram_access_ps + dram_service_ps \
        + from_dram_ps

    t_data = t_dir + owner_ps
    t_data = torch.maximum(t_data, torch.where(need_read, dram_ready, 0))
    t_data = torch.maximum(t_data, t_dir + inv_ps)

    if contended:
        rr = flight(home, rows, t_data, flits_data, win, lf, p_net_home)
        link_wait = link_wait + rr.wait_ps
        reply_done = rr.arrival
        state = state._replace(link_free_mem=rr.link_free)
    else:
        reply_done = t_data + reply_ps

    l1_fill_ps = torch.where(
        is_if, _lat(vp.l1i_access_cycles,
                    _period(state, DVFSModule.L1_ICACHE)),
        _lat(vp.l1d_access_cycles, p_l1))
    completion = reply_done + l1_fill_ps + extra
    if not shared_l2:
        # The fill through the requester's private L2.
        completion = completion + _lat(vp.l2_access_cycles, p_l2)

    # ---- apply directory entry updates
    state = state._replace(
        dir_word=scatter(state.dir_word, (way64, fidx),
                         dword_pack(line, state.round_ctr, act.new_state,
                                    act.new_owner), "set", mask=win))
    old_row = torch.where(hit[:, None], entry_sharers, vsharers)
    delta = act.new_sharers - old_row          # modular, like uint64
    plane = torch.arange(W, device=dev)[:, None] * A + way64[None, :]
    add_rows = torch.cat([plane.reshape(-1), req_word * A + way64])
    add_cols = torch.cat(
        [fidx[None, :].expand(W, T).reshape(-1), fidx])
    add_mask = torch.cat(
        [(win & ~combinable)[None, :].expand(W, T).reshape(-1), sharer_add])
    add_vals = torch.cat([delta.T.reshape(-1), req_bit1])
    state = state._replace(dir_sharers=scatter(
        state.dir_sharers, (add_rows, add_cols), add_vals, "add",
        mask=add_mask))

    # ---- coherence-driven cache-state changes
    line_sr = sr_sel(line)
    vtag_sr = sr_sel(vtag)
    dlv_lines = torch.cat([
        own_lines,
        line_sr[None, :].expand(T, K),
        vtag_sr[None, :].expand(T, K)], dim=1)
    dlv_valid = torch.cat([own_valid, inv_bool.T, vic_bool.T], dim=1)
    dlv_tgt = torch.cat(
        [own_tgt, torch.full((T, 2 * K), I, dtype=torch.int32, device=dev)],
        dim=1)
    state = state._replace(
        l2=cachemod.invalidate_by_value(
            state.l2, dlv_lines, dlv_valid, dlv_tgt),
        l1d=cachemod.invalidate_by_value(
            state.l1d, dlv_lines, dlv_valid, dlv_tgt))
    if params.track_miss_types:
        state = _classify_misses(state, rows, line, win, dlv_lines,
                                 dlv_valid, dlv_tgt)

    # ---- requester-side fills / victims (install at serve time)
    if shared_l2:
        state, victim_dirty = _sh_l2_fills(
            params, state, rows, line, is_ex, is_if,
            win & ~is_ex & (act.new_state == E), win, rstamp)
    else:
        state, victim_dirty, victim_home = _private_fills(
            params, state, rows, line, is_ex, is_if, win, t_dir,
            dram_service_ps, rstamp)

    # ---- counters (home-binned tallies via one stacked scatter-add)
    kcnt_inv = torch.sum(inv_bool, dim=1).to(torch.int64)  # [K]
    kcnt_inv_flits = kcnt_inv
    if bcast_traffic is not None:
        # An overflowed broadcast puts T-1 INV messages on the wire
        # whatever the true sharer count.  With the hop-by-hop mesh's
        # broadcast tree the source injects one packet that the routers
        # replicate: the packet count drops to 1 and the flits keep the
        # T-1 traversals.
        bt_k = torch.any(oh_sr & (bcast_traffic & has_inv)[None, :], dim=1)
        bcast_pkts = 1 if params.net_memory.broadcast_tree_enabled \
            else T - 1
        kcnt_inv = torch.where(bt_k, bcast_pkts, kcnt_inv)
        kcnt_inv_flits = torch.where(bt_k, T - 1, kcnt_inv_flits)
    kcnt_vic = torch.sum(vic_bool, dim=1).to(torch.int64)
    kcnt = kcnt_inv + kcnt_vic
    kcnt_fl = kcnt_inv_flits + kcnt_vic
    inv_count = torch.sum(torch.where(oh_sr, kcnt[:, None], 0), dim=0)
    inv_flits = torch.sum(torch.where(oh_sr, kcnt_fl[:, None], 0), dim=0)
    c = state.counters

    def b(m):
        return m.to(torch.int64)

    home_cols = [
        b(win & ~is_ex),                          # dir_sh_req
        b(win & is_ex),                           # dir_ex_req
        inv_flits,                                # dir_invalidations
        b(owner_leg | evict_m | evict_o),         # dir_writebacks
        b(owner_leg & ~act.dram_write),           # dir_forwards
        b(evicting),                              # dir_evictions
        b(win) + inv_count,                       # net_mem_pkts @home
        torch.where(win, flits_data, 0)
        + inv_flits * flits_req,                  # net_mem_flits @home
        b(alloc_defer | fan_defer | ow_defer),    # dir_deferrals
    ]
    if shared_l2:
        # Slice accesses and misses at the home tile; the DRAM-site
        # tallies on their own index; a dirty L1 victim flushes into the
        # slice (its packet is counted below), not DRAM.
        home_cols += [b(win), b(win & ~hit)]
        db = _binsum(dsite, torch.stack([b(need_read), b(dram_wb)], dim=1))
        vic_wr = 0
    else:
        home_cols += [b(need_read), b(dram_wb)]   # dram_reads/writes
        vic_wr = scatter(torch.zeros(T, dtype=torch.int64, device=dev),
                         victim_home, b(victim_dirty), "add")
    hb = _binsum(home, torch.stack(home_cols, dim=1))
    if not shared_l2:
        db = hb[:, 9:11]
    c = c._replace(
        dir_sh_req=c.dir_sh_req + hb[:, 0],
        dir_ex_req=c.dir_ex_req + hb[:, 1],
        dir_invalidations=c.dir_invalidations + hb[:, 2],
        dir_writebacks=c.dir_writebacks + hb[:, 3],
        dir_forwards=c.dir_forwards + hb[:, 4],
        dir_evictions=c.dir_evictions + hb[:, 5],
        dram_reads=c.dram_reads + db[:, 0],
        dram_writes=c.dram_writes + db[:, 1] + vic_wr,
        l2_access=c.l2_access + (hb[:, 9] if shared_l2 else 0),
        l2_miss=c.l2_miss + (hb[:, 10] if shared_l2 else 0),
        net_mem_pkts=c.net_mem_pkts
        + torch.where(win, 1, 0)
        + torch.where(victim_dirty, 1, 0)
        + hb[:, 6],
        net_mem_flits=c.net_mem_flits
        + torch.where(win, flits_req, 0)
        + torch.where(victim_dirty, flits_data, 0)
        + hb[:, 7],
        net_link_wait_ps=c.net_link_wait_ps + link_wait,
        dir_deferrals=c.dir_deferrals + hb[:, 8],
    )
    state = state._replace(counters=c)

    if params.core.model == "iocoom":
        state, unpark = _iocoom_unpark(params, state, win, kind, aux, issue,
                                       cycle_ps, completion)
    else:
        unpark = completion
    if P == 0:
        # ---- parked winners unblock (a simple core stalls until the
        # data arrives)
        state = _unblock(state, win, unpark, sync=False)
    else:
        # ---- chain winners advance their chain: the unpark time becomes
        # the base of the next element's issue; a drained chain restores
        # the absolute clock (base + the local time accumulated past the
        # last bank) and frees the bank.
        c4 = state.counters
        new_head = state.mq_head + win.to(torch.int32)
        drained = win & (new_head >= state.mq_count)
        state = state._replace(
            mq_head=torch.where(drained, 0, new_head).to(torch.int32),
            mq_count=torch.where(drained, 0, state.mq_count).to(
                torch.int32),
            chain_base=torch.where(win, unpark, state.chain_base),
            clock=torch.where(drained, unpark + state.chain_rel,
                              state.clock),
            chain_rel=torch.where(drained, 0, state.chain_rel),
            counters=c4._replace(
                mem_stall_ps=c4.mem_stall_ps
                + torch.where(win, unpark - issue, 0)))

    # ---- serialization floor for still-pending same-line requests
    t_free = t_data
    if dense_tables:
        win_oh = oh_hidx & win[:, None]
        new_line = torch.amax(torch.where(win_oh, line[:, None], -1), dim=0)
        new_t = torch.amax(torch.where(win_oh, t_free[:, None], 0), dim=0)
        wrote = win_oh.any(dim=0)
        ftbl = torch.where(wrote[None, :], torch.stack([new_line, new_t]),
                           ftbl)
    else:
        # Combined shared-read winners of one line share its slot, each
        # with its own availability time: where the dense form takes the
        # group max, the JAX package's scatter keeps the LAST row's, and
        # so does stacked_set_table.
        ftbl = dense.stacked_set_table(hidx, win,
                                       torch.stack([line, t_free]), ftbl)
    state = state._replace(round_ctr=state.round_ctr + 1,
                           ctr_conflict=state.ctr_conflict + 1)
    return state, ftbl


def _iocoom_unpark(params: SimParams, state: SimState, win, kind, aux,
                   issue, cycle_ps, completion):
    """The iocoom core's unblock: a plain load or store miss holds the
    core only until issue + 1 cycle, floored at the completion its ring
    slot last held (a full queue back-pressures; with one outstanding
    RFO a store also waits every earlier store), and its priced
    completion takes the slot; atomics (``aux`` bit 0) and i-fetches,
    and every request of a simple tile under a mixed model list, wait in
    full.  A scoreboarded remote load lands its completion in its
    destination register (``aux`` bits 8-12).  Returns (state, unpark
    time)."""
    T = params.num_tiles
    rows = torch.arange(T, device=win.device)
    is_atomic = (aux & 0xFF) != 0
    is_load = win & (kind == PEND_SH_REQ) & ~is_atomic
    is_store = win & (kind == PEND_EX_REQ) & ~is_atomic
    if params.core.mixed:
        iot = kwindow.iocoom_mask(params, win.device)
        is_load = is_load & iot
        is_store = is_store & iot
    LQE = state.lq_ready.shape[0]
    SQE = state.sq_ready.shape[0]
    # [LQE, T] / [SQE, T] slot masks, contiguous: the rings they write
    # are the window kernel's operands.
    lq_oh = (dense.onehot(state.lq_next % LQE, LQE).T
             & is_load[None, :]).contiguous()
    sq_oh = (dense.onehot(state.sq_next % SQE, SQE).T
             & is_store[None, :]).contiguous()
    lq_floor = torch.sum(torch.where(lq_oh, state.lq_ready, 0), dim=0)
    sq_floor = torch.sum(torch.where(sq_oh, state.sq_ready, 0), dim=0)
    if not params.core.multiple_outstanding_rfos:
        sq_floor = torch.maximum(sq_floor, torch.amax(state.sq_ready, dim=0))
    unpark = torch.where(
        is_load, torch.maximum(issue + cycle_ps, lq_floor),
        torch.where(is_store, torch.maximum(issue + cycle_ps, sq_floor),
                    completion))
    dreg = (aux >> 8) & 31
    state = state._replace(
        lq_ready=torch.where(lq_oh, completion[None, :], state.lq_ready),
        sq_ready=torch.where(sq_oh, completion[None, :], state.sq_ready),
        lq_next=state.lq_next + is_load.to(torch.int32),
        sq_next=state.sq_next + is_store.to(torch.int32),
        reg_ready=scatter(state.reg_ready,
                          ((dreg - 1).to(torch.int64), rows), completion,
                          "max", mask=is_load & (dreg > 0)))
    return state, unpark


def resolve_memory(params: SimParams, vp: VariantParams,
                   state: SimState) -> SimState:
    """Serve all parked L2-miss requests through the home directories, in
    conflict rounds while requests remain (capped at
    ``directory_conflict_rounds``)."""
    T = params.num_tiles
    H = max(1024, 16 * T)
    P = params.miss_chain
    dev = state.clock.device
    ftbl = torch.stack([torch.full((H,), -1, dtype=torch.int64, device=dev),
                        torch.zeros((H,), dtype=torch.int64, device=dev)])
    # Chain replay first (P > 0 under a full-map directory with simple
    # cores, unless the hop-by-hop mesh's links contend; iocoom threads
    # its load/store rings through the conflict rounds): whole banked
    # chains served in one pass, the floor table threaded through to the
    # conflict rounds that serve the leftovers.
    if P > 0 and not _contended(params) and params.core.model == "simple" \
            and params.directory.directory_type == "full_map":
        state, ftbl = chain_fast_pass(params, vp, state, H, ftbl)

    def pending(st):
        if P > 0:
            return st.mq_head < st.mq_count
        return _parked(st)

    cap = params.max_resolve_rounds if P > 0 \
        else params.directory_conflict_rounds
    state = state._replace(ctr_resolve=state.ctr_resolve + 1)
    i = 0
    while i < cap and bool(pending(state).any().item()):
        state, ftbl = _memory_round(params, vp, state, ftbl)
        i += 1
    saturated = pending(state)
    c = state.counters
    return state._replace(counters=c._replace(
        dir_deferrals=c.dir_deferrals + saturated.to(torch.int64)))


class _VictimProbe:
    """Directory entry located for a batch of dropped lines."""

    def __init__(self, params: SimParams, state: SimState, tiles, vtag,
                 valid):
        A = params.directory.associativity
        W = state.dir_sharers.shape[0] // A
        self.assoc = A
        ndsets = params.directory.num_sets
        dev = vtag.device
        self.vhome = home_of_line(params, vtag)
        self.vdset = dir_set_of_line(params, vtag)
        self.vfidx = (self.vhome * ndsets + self.vdset).to(torch.int64)
        vfidx = self.vfidx
        drow = state.dir_word[:, vfidx].T                   # [R, A]
        dstate = dword_state(drow)
        match = (dword_tag(drow) == vtag[:, None].to(torch.int32)) \
            & (dstate != I) & valid[:, None]
        self.found = match.any(dim=1)
        self.way = first_true(match, 1)
        self.word_way = torch.gather(drow, 1, self.way[:, None])[:, 0]
        self.est = dword_state(self.word_way)
        self.eowner = dword_owner(self.word_way)
        oh_way = torch.arange(A, device=dev)[:, None] == self.way[None, :]
        self.esharers = torch.sum(
            torch.where(oh_way[None, :, :],
                        state.dir_sharers[:, vfidx].reshape(W, A, -1), 0),
            dim=1, dtype=torch.int64).T                     # [R, W]
        self.word = (tiles // 64).to(torch.int64)
        self.bit = torch.ones_like(tiles, dtype=torch.int64) \
            << (tiles % 64).to(torch.int64)
        self.woh = self.word[:, None] \
            == torch.arange(W, device=dev)[None, :]
        cur = torch.sum(torch.where(self.woh, self.esharers, 0), dim=1,
                        dtype=torch.int64)
        self.has_bit = (cur & self.bit) != 0

    def set_meta2(self, state: SimState, mask_a, state_a, owner_a,
                  mask_b, state_b, owner_b):
        """Two disjoint-mask (state, owner) rewrites in one scatter."""
        new = torch.where(mask_a,
                          dword_with_meta(self.word_way, state_a, owner_a),
                          dword_with_meta(self.word_way, state_b, owner_b))
        return state._replace(dir_word=scatter(
            state.dir_word, (self.way, self.vfidx), new, "set",
            mask=mask_a | mask_b))

    def clear_bit(self, state: SimState, mask):
        """Clear the dropping tile's sharer bit where ``mask`` (a guarded
        modular subtract: distinct sharers of one entry may clear in one
        batch)."""
        return state._replace(dir_sharers=scatter(
            state.dir_sharers, (self.word * self.assoc + self.way,
                                self.vfidx), -self.bit, "add",
            mask=mask & self.has_bit))


def _dir_evict_notify(params: SimParams, state: SimState, tiles, vtag,
                      vstate, valid) -> SimState:
    """Tell the home directory a tile dropped ``vtag`` from its L2: an
    M owner's entry becomes I, a sharer's bit clears (modular subtract,
    so concurrent drops of one entry all land)."""
    A = params.directory.associativity
    W = state.dir_sharers.shape[0] // A
    p = _VictimProbe(params, state, tiles, vtag, valid)

    drop_m = p.found & (p.est == M) & (p.eowner == tiles)
    drop_o = p.found & (p.est == O) & (p.eowner == tiles)
    drop_s = p.found & p.has_bit \
        & ((p.est == S) | ((p.est == O) & (p.eowner != tiles)))
    left = p.esharers & ~torch.where(p.woh, p.bit[:, None], 0)
    empty = (left == 0).all(dim=1)

    state = p.set_meta2(state,
                        drop_m | ((drop_s | drop_o) & empty), I, -1,
                        drop_o & ~empty, S, -1)
    clr = drop_s | drop_o
    R = tiles.shape[0]
    plane = torch.arange(W, device=vtag.device)[:, None] * A \
        + p.way[None, :]
    rows2 = torch.cat([plane.reshape(-1), p.word * A + p.way])
    cols2 = torch.cat([p.vfidx[None, :].expand(W, R).reshape(-1), p.vfidx])
    mask2 = torch.cat([drop_m[None, :].expand(W, R).reshape(-1),
                       clr & p.has_bit])
    vals2 = torch.cat([(-p.esharers.T).reshape(-1), -p.bit])
    return state._replace(dir_sharers=scatter(
        state.dir_sharers, (rows2, cols2), vals2, "add", mask=mask2))


def _sh_l1_evict_notify(params: SimParams, state: SimState, tiles, vtag,
                        vstate, valid) -> SimState:
    """Report an L1 victim to its home L2 slice (shared-L2 protocols): an
    M victim flushes its data into the slice (the entry drops its owner
    and becomes O, slice-dirty), an E victim releases ownership (entry
    S), and the tile's sharer bit clears in every case.  The slice line
    stays resident: entries never drop to I here."""
    p = _VictimProbe(params, state, tiles, vtag, valid)
    own_drop = p.found & (p.eowner == tiles) & ((p.est == M) | (p.est == E))
    state = p.set_meta2(state, own_drop & (vstate == M), O, -1,
                        own_drop & (vstate != M), S, -1)
    return p.clear_bit(state, p.found)


# ====================================================================== sync
#
# The resolvers of the sync pass, each the JAX package's.  Under the
# ThreadScheduler (more trace streams than tiles) the barrier and cond
# resolvers also wake the descheduled streams of the stream store
# (``strm_*``), and join and start read stream-indexed flags through the
# seats.

def _mcp_legs(params: SimParams, vp: VariantParams, state: SimState):
    """(to_mcp, from_mcp): each tile's control-packet legs to and from
    the sync server, [T] int64 ps."""
    T = params.num_tiles
    dev = state.clock.device
    rows = torch.arange(T, device=dev)
    mcp = mcp_tile(params)
    to_mcp_at = torch.full((T,), mcp, device=dev)
    p_nu = _period(state, DVFSModule.NETWORK_USER)
    to_mcp = noc.unicast_ps(params.net_user, rows, to_mcp_at,
                            kchain.CTRL_BYTES, p_nu, params.mesh_width,
                            vnet=vp.net_user)
    from_mcp = noc.unicast_ps(params.net_user, to_mcp_at, rows,
                              kchain.CTRL_BYTES, p_nu[mcp],
                              params.mesh_width, vnet=vp.net_user)
    return to_mcp, from_mcp


def _count(state: SimState, name: str, mask) -> SimState:
    """Add one to counter ``name`` where ``mask`` and models are on."""
    c = state.counters
    return state._replace(counters=c._replace(**{
        name: getattr(c, name)
        + torch.where(mask & state.models_enabled, 1, 0)}))


def resolve_recv(params: SimParams, vp: VariantParams,
                 state: SimState) -> SimState:
    """Complete receives whose channel holds a message; the consumed ring
    slot takes the receive's completion, the floor of the send that
    reuses it."""
    T = params.num_tiles
    rows = torch.arange(T, device=state.clock.device)
    D = state.ch_time.shape[0]
    is_recv = state.pend_kind == PEND_RECV
    src = torch.clip(state.pend_aux, 0, T - 1).to(torch.int64)
    sent = state.ch_sent[src, rows]
    recvd = state.ch_recvd[src, rows]
    slot = (recvd % D).to(torch.int64)
    arr = state.ch_time[slot, src, rows]
    ok = is_recv & (sent > recvd)
    cycle_ps = _lat(1, _period(state, DVFSModule.CORE))
    completion = torch.maximum(state.pend_issue, arr) + cycle_ps
    state = state._replace(
        ch_recvd=scatter(state.ch_recvd, (src, rows), 1, "add", mask=ok),
        ch_time=scatter(state.ch_time, (slot, src, rows), completion, "set",
                        mask=ok))
    return _unblock(_count(state, "recvs", ok), ok, completion, sync=True)


def resolve_send(params: SimParams, vp: VariantParams,
                 state: SimState) -> SimState:
    """Complete sends that a full channel ring back-pressured, no earlier
    than the receive that freed their slot."""
    T = params.num_tiles
    rows = torch.arange(T, device=state.clock.device)
    D = state.ch_time.shape[0]
    is_send = state.pend_kind == PEND_SEND
    dst = torch.clip(state.pend_aux, 0, T - 1).to(torch.int64)
    sent = state.ch_sent[rows, dst]
    ok = is_send & ((sent - state.ch_recvd[rows, dst]) < D)
    p_nu = _period(state, DVFSModule.NETWORK_USER)
    cycle_ps = _lat(1, _period(state, DVFSModule.CORE))
    net_ps = noc.unicast_ps(params.net_user, rows, dst, state.pend_addr,
                            p_nu, params.mesh_width, vnet=vp.net_user)
    slot = (sent % D).to(torch.int64)
    completion = torch.maximum(state.pend_issue,
                               state.ch_time[slot, rows, dst]) + cycle_ps
    c = state.counters
    on = ok & state.models_enabled
    state = state._replace(
        ch_time=scatter(state.ch_time, (slot, rows, dst),
                        completion + net_ps, "set", mask=ok),
        ch_sent=scatter(state.ch_sent, (rows, dst), 1, "add", mask=ok),
        counters=c._replace(
            sends=c.sends + torch.where(on, 1, 0),
            net_user_pkts=c.net_user_pkts + torch.where(on, 1, 0),
            net_user_flits=c.net_user_flits + torch.where(
                on, noc.num_flits(state.pend_addr,
                                  vp.net_user.flit_width_bits), 0)))
    return _unblock(state, ok, completion, sync=True)


def resolve_barrier(params: SimParams, vp: VariantParams,
                    state: SimState) -> SimState:
    T = params.num_tiles
    dev = state.clock.device
    rows = torch.arange(T, device=dev)
    NB = state.bar_count.shape[0]
    is_bar = state.pend_kind == PEND_BARRIER
    bid = torch.clip(state.pend_addr, 0, NB - 1)
    parts = torch.clamp(state.pend_aux, min=1)
    reached = state.bar_count[bid] >= parts
    rel = is_bar & reached
    p_nu = _period(state, DVFSModule.NETWORK_USER)
    cycle_ps = _lat(1, _period(state, DVFSModule.CORE))
    mcp = mcp_tile(params)
    back_ps = noc.unicast_ps(params.net_user,
                             torch.full((T,), mcp, device=dev), rows,
                             kchain.CTRL_BYTES, p_nu[mcp], params.mesh_width,
                             vnet=vp.net_user)
    completion = state.bar_time[bid] + back_ps + cycle_ps
    if state.sched_enabled:
        # Descheduled waiters of a released barrier wake in the store:
        # the release resets bar_count below, so a stream rotated out
        # while parked would otherwise miss its generation.  Their
        # arrivals were counted when they parked.
        S = state.strm_cursor.shape[0]
        s_is = state.strm_pend_kind == PEND_BARRIER
        sbid = torch.clip(state.strm_pend_addr, 0, NB - 1)
        sparts = torch.clamp(state.strm_pend_aux, min=1)
        s_rel = s_is & (state.bar_count[sbid] >= sparts) & ~state.strm_done
        s_tile = torch.arange(S, device=dev) % T
        s_comp = state.bar_time[sbid] + back_ps[s_tile] + cycle_ps[s_tile]
        state = state._replace(
            strm_pend_kind=torch.where(s_rel, PEND_NONE,
                                       state.strm_pend_kind).to(torch.int32),
            strm_clock=torch.where(s_rel, s_comp, state.strm_clock),
            strm_cursor=state.strm_cursor
            + torch.where(s_rel, 1, 0).to(torch.int32))
    state = state._replace(
        bar_count=scatter(state.bar_count, bid, 0, "set", mask=rel),
        bar_time=scatter(state.bar_time, bid, 0, "set", mask=rel))
    return _unblock(state, rel, completion, sync=True)


def resolve_mutex(params: SimParams, vp: VariantParams,
                  state: SimState) -> SimState:
    """FCFS: the earliest waiter on each free lock takes it, granted at
    its MCP arrival or the lock's release, whichever is later."""
    T = params.num_tiles
    rows = torch.arange(T, device=state.clock.device)
    NL = state.lock_holder.shape[0]
    is_mx = state.pend_kind == PEND_MUTEX
    lid = torch.clip(state.pend_addr, 0, NL - 1)
    issue = state.pend_issue
    first = _elect(is_mx, _fcfs_keys(is_mx, issue), lid, NL)
    win = first & (state.lock_holder[lid] == 0)
    to_mcp, from_mcp = _mcp_legs(params, vp, state)
    cycle_ps = _lat(1, _period(state, DVFSModule.CORE))
    grant = torch.maximum(issue + to_mcp, state.lock_free_at[lid])
    completion = grant + from_mcp + cycle_ps
    state = state._replace(lock_holder=scatter(
        state.lock_holder, lid, (rows + 1).to(torch.int32), "set",
        mask=win))
    return _unblock(_count(state, "mutex_acquires", win), win, completion,
                    sync=True)


def resolve_cond(params: SimParams, vp: VariantParams,
                 state: SimState) -> SimState:
    """Match parked cond waiters with parked signal/broadcast tokens (the
    poster parks as the token, PEND_CSIG / PEND_CBC, with its MCP
    arrival time).  Each pass takes, per cond, its one earliest token:

      * a signal wakes the earliest waiter parked at or before it; with
        none it stays until no tile could still park earlier, then it
        is lost;
      * a broadcast wakes every waiter parked at or before it, and is
        consumed under the same no-earlier-park rule.

    With ``cond_replay`` (captured traces) any parked waiter matches,
    waking at the later of its park and the token, and a waiter whose
    cond has no token wakes at its park once every live tile is parked
    on a sync kind.  Posters unblock when their token resolves; a woken
    waiter becomes a PEND_MUTEX park to re-acquire its mutex (its
    pend_issue set so that resolve_mutex's issue + to_mcp is the wake
    time)."""
    NC = NUM_CONDS
    T = params.num_tiles
    kind = state.pend_kind
    is_cw = kind == PEND_COND
    is_sig = kind == PEND_CSIG
    is_bc = kind == PEND_CBC
    is_tok = is_sig | is_bc
    cid = torch.clip(state.pend_addr, 0, NC - 1)
    t = state.pend_issue                       # MCP-arrival timestamps
    oh_c = _oh(cid, NC)

    # One earliest token per cond this pass (FCFS by time, then tile).
    tok_win = _elect(is_tok, _fcfs_keys(is_tok, t), cid, NC)
    tok_time_nc = dense.binmax(oh_c, tok_win, t, 0)            # [NC]
    tok_bc_nc = dense.binsum(oh_c, tok_win & is_bc, 1) > 0     # [NC]
    has_tok_nc = dense.binsum(oh_c, tok_win, 1) > 0

    def per_tile(flags):
        return _sel(oh_c, flags.to(torch.int32)) > 0

    wt = _sel(oh_c, tok_time_nc)
    w_has = per_tile(has_tok_nc)
    w_bc = per_tile(tok_bc_nc)
    if params.cond_replay:
        elig = is_cw & w_has
        wake_at = torch.maximum(t, wt)
    else:
        elig = is_cw & w_has & (t <= wt)
        wake_at = wt
    first = _elect(elig, _fcfs_keys(elig, t), cid, NC)
    wake = torch.where(w_bc, elig, first)
    if params.cond_replay:
        # An orphaned recorded wait (its cond has no token) wakes at its
        # own park once every live tile is parked on a sync kind.
        pure_sync = (kind == PEND_COND) | (kind == PEND_MUTEX) \
            | (kind == PEND_BARRIER) | (kind == PEND_RECV) \
            | (kind == PEND_SEND) | (kind == PEND_JOIN) \
            | (kind == PEND_START) | (kind == PEND_CSIG) | (kind == PEND_CBC)
        quiesce = ~torch.any(~state.done & ~pure_sync)
        orphan = is_cw & ~w_has & quiesce
        wake = wake | orphan
        wake_at = torch.where(orphan, t, wake_at)

    to_mcp, from_mcp = _mcp_legs(params, vp, state)
    # A token resolves once no other tile can still park before it: each
    # tile's next park is no earlier than its clock (runnable), just past
    # its park time (parked), or past issue + to_mcp for a mutex waiter
    # (whose pend_issue a wake rewound by to_mcp).  The token excludes
    # itself through the two smallest bounds.
    INF = 2**62
    lb = torch.where(
        state.done, INF,
        torch.where(kind == PEND_NONE, state.clock,
                    torch.where(kind == PEND_MUTEX,
                                state.pend_issue + to_mcp + 1,
                                state.pend_issue + 1)))
    if state.sched_enabled:
        # A descheduled stream can still park (or holds a park) no
        # earlier than its frozen clock: no token is lost or complete
        # while such a stream could match it.  The seated streams' store
        # rows are stale and left out.
        lb_store = torch.where(
            state.strm_done, INF,
            torch.where(state.strm_pend_kind == PEND_NONE, state.strm_clock,
                        state.strm_pend_issue + 1))
        seated = state.seated()
        store_min = torch.amin(torch.where(seated, INF, lb_store))
    else:
        store_min = INF
    if T >= 2:
        m1, m2 = -torch.topk(-lb, 2).values
        lb_excl = torch.where(lb == m1, m2, m1)
    else:
        lb_excl = torch.full_like(lb, INF)
    lb_excl = torch.clamp(lb_excl, max=store_min)
    woke_seat_nc = dense.binsum(oh_c, wake & ~w_bc, 1) > 0
    if state.sched_enabled:
        # Descheduled waiters wake in the store: a waiter and its
        # signaler on the same tile share one seat and may never be
        # seated together.  A broadcast wakes every eligible stored
        # waiter; a signal the earliest one, only where it woke no
        # seated waiter.
        S = state.strm_cursor.shape[0]
        dev = state.clock.device
        s_tile = torch.arange(S, device=dev) % T
        s_is_cw = (state.strm_pend_kind == PEND_COND) & ~seated \
            & ~state.strm_done
        s_cid = torch.clip(state.strm_pend_addr, 0, NC - 1)
        s_t = state.strm_pend_issue
        s_wt = tok_time_nc[s_cid]
        s_has = has_tok_nc[s_cid]
        s_bc = tok_bc_nc[s_cid]
        if params.cond_replay:
            s_elig = s_is_cw & s_has
            s_wake_at = torch.maximum(s_t, s_wt)
        else:
            s_elig = s_is_cw & s_has & (s_t <= s_wt)
            s_wake_at = s_wt
        skey = torch.clip(s_t, 0, 2**40) * S \
            + torch.arange(S, dtype=torch.int64, device=dev)
        stbl = scatter(torch.full((NC,), INF, dtype=torch.int64,
                                  device=dev), s_cid, skey, "min",
                       mask=s_elig)
        s_first = s_elig & (stbl[s_cid] == skey)
        s_wake = torch.where(s_bc, s_elig, s_first & ~woke_seat_nc[s_cid])
        state = state._replace(
            strm_pend_kind=torch.where(s_wake, PEND_MUTEX,
                                       state.strm_pend_kind).to(torch.int32),
            strm_pend_addr=torch.where(
                s_wake, state.strm_pend_aux.to(torch.int64),
                state.strm_pend_addr),
            strm_pend_issue=torch.where(s_wake, s_wake_at - to_mcp[s_tile],
                                        state.strm_pend_issue))
        woke_store_nc = scatter(torch.zeros(NC, dtype=torch.bool,
                                            device=dev), s_cid, True, "set",
                                mask=s_wake & ~s_bc)
        woke_nc = woke_seat_nc | woke_store_nc
    else:
        woke_nc = woke_seat_nc
    woke_mine = per_tile(woke_nc)
    if params.cond_replay:
        # Lost only when no waiter of its cond is parked and no tile is
        # runnable.
        any_runnable = (~state.done & (kind == PEND_NONE)).any()
        no_waiter = ~per_tile(dense.binsum(oh_c, is_cw, 1) > 0)
        tok_done = tok_win & ((is_sig & woke_mine)
                              | (~any_runnable & no_waiter))
    else:
        tok_done = tok_win & ((t < lb_excl) | (is_sig & woke_mine))

    cycle_ps = _lat(1, _period(state, DVFSModule.CORE))
    c = state.counters
    state = state._replace(
        pend_kind=torch.where(wake, PEND_MUTEX, kind).to(torch.int32),
        pend_addr=torch.where(wake, state.pend_aux.to(torch.int64),
                              state.pend_addr),
        pend_issue=torch.where(wake, wake_at - to_mcp, state.pend_issue),
        counters=c._replace(
            # [park, hand-off to the mutex); the mutex's unblock adds the
            # rest from wake_at - to_mcp.
            sync_stall_ps=c.sync_stall_ps + torch.where(
                wake, torch.clamp(wake_at - to_mcp - t, min=0), 0)))
    return _unblock(state, tok_done, t + from_mcp + cycle_ps, sync=True)


def resolve_join(params: SimParams, vp: VariantParams,
                 state: SimState) -> SimState:
    """Release joiners whose child stream is DONE, no earlier than the
    child's exit reaching the MCP."""
    T = params.num_tiles
    is_j = state.pend_kind == PEND_JOIN
    child = torch.clip(state.pend_aux, 0, state.done_at.shape[0] - 1).to(
        torch.int64)
    # ``child`` is a stream id; a seated child's flag lives in its seat.
    ok = is_j & state.stream_done()[child]
    to_mcp, from_mcp = _mcp_legs(params, vp, state)
    cycle_ps = _lat(1, _period(state, DVFSModule.CORE))
    exit_at_mcp = state.done_at[child] + to_mcp[child % T]
    completion = torch.maximum(state.pend_issue + to_mcp, exit_at_mcp) \
        + from_mcp + cycle_ps
    return _unblock(_count(state, "joins", ok), ok, completion, sync=True)


def resolve_start(params: SimParams, vp: VariantParams,
                  state: SimState) -> SimState:
    """Release THREAD_START gates whose stream has been SPAWNed
    (``spawned_at`` is per stream: each seat reads its stream's)."""
    spawned = state.spawned_at[state.seat_stream.to(torch.int64)] \
        if state.sched_enabled else state.spawned_at
    ok = (state.pend_kind == PEND_START) & (spawned >= 0)
    cycle_ps = _lat(1, _period(state, DVFSModule.CORE))
    completion = torch.maximum(state.pend_issue, spawned) + cycle_ps
    return _unblock(state, ok, completion, sync=True)


def resolve(params: SimParams, state: SimState,
            vp: VariantParams = None) -> SimState:
    """One full cross-tile resolution pass: the memory pass when memory
    requests are parked (or banked), then the sync resolvers in the JAX
    package's order (recv, send — only with CAPI channels —, barrier,
    cond, mutex, join, start), each run only when some tile is parked on
    its kind (cond on a waiter or a token).

    One host read decides every gate: the memory pass changes no sync
    park and each resolver clears only its own kind, except resolve_cond,
    which turns woken waiters into mutex parks, so the mutex gate is read
    again after it.  The gates read the seats' parks, as the JAX
    package's do: under the ThreadScheduler a resolver whose kind only
    descheduled streams hold has nothing to do (a barrier releases in the
    pass in which its last arriver, seated, parks; a stored cond waiter
    wakes only on a seated token; the other resolvers read the seats
    alone)."""
    if vp is None:
        vp = variant_params(params)
    if params.miss_chain > 0:
        any_mem = (state.mq_count > 0).any()
    else:
        any_mem = _parked(state).any()
    kinds = torch.arange(PEND_RECV, PEND_CBC + 1, dtype=torch.int32,
                         device=state.pend_kind.device)
    parked = (state.pend_kind[None, :] == kinds[:, None]).any(dim=1)
    flags = torch.cat([any_mem[None], parked]).tolist()
    has = dict(zip(range(PEND_RECV, PEND_CBC + 1), flags[1:]))
    if flags[0]:
        state = resolve_memory(params, vp, state)
    if state.has_capi:
        # A trace without CAPI events has zero-size channel leaves and no
        # RECV / SEND parks.
        if has[PEND_RECV]:
            state = resolve_recv(params, vp, state)
        if has[PEND_SEND]:
            state = resolve_send(params, vp, state)
    if has[PEND_BARRIER]:
        state = resolve_barrier(params, vp, state)
    if has[PEND_COND] or has[PEND_CSIG] or has[PEND_CBC]:
        state = resolve_cond(params, vp, state)
        has[PEND_MUTEX] = bool((state.pend_kind == PEND_MUTEX).any().item())
    if has[PEND_MUTEX]:
        state = resolve_mutex(params, vp, state)
    if has[PEND_JOIN]:
        state = resolve_join(params, vp, state)
    if has[PEND_START]:
        state = resolve_start(params, vp, state)
    return state
