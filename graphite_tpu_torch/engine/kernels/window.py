"""The block-window walk: its plain PyTorch form and its CUDA kernel.

``window_walk`` is engine/core._block_retire's hot loop — tag probes
against every cache level, hit/stall/hazard classification over the
[T, K] window, within-window branch-predictor read-after-write, the
max-plus clock prefix, chain banking into the [P, T] ``mq_*`` arrays at
``tpu/miss_chain = P > 0`` (with forwarding onto pending fills), LRU
touches and fills, and counter accumulation.  It is the counterpart of
``graphite_tpu/engine/kernels/window.py:163``, transliterated for this
slice's configuration: simple in-order cores, private L1/L2 under MSI,
miss chains off or on, narrow windows (K = ``block_events``) and the
wide windows of ``tpu/fast_forward`` (K = ``core._ff_width``, at most
64).  Shared-L2 protocols and iocoom cores are refused (later slices).

The module also holds the fast-forward walk, ``fast_forward_walk``: the
closed-form pricing of each candidate tile's longest hit/compute-only
event prefix (the counterpart of
``graphite_tpu/engine/kernels/window.py:779``).

Two forms compute each function:

  * :func:`window_walk` / :func:`fast_forward_walk` — plain PyTorch,
    vectorised over the window with the JAX package's [T, K, K] (and
    [T, K, P]) masks.  The CPU tests hold them against the JAX functions
    leaf for leaf.
  * ``csrc/window_walk.cu`` — a CUDA kernel for ``sm_90a``, one block
    per tile and one thread per event: every event classified at once,
    one thread's pass for the retire cut, then the retired events'
    effects applied in place on the state's own cache, predictor and
    chain-bank arrays.  ``csrc/fast_forward_walk.cu`` — the same shape
    for the span: one block per tile, one thread per span event, the
    clock a prefix sum, an engaged tile's touches and predictor writes
    applied in place.

:func:`run_window` and :func:`run_fast_forward` pick between them by the
tensors' device: CPU tensors take the plain form, CUDA tensors launch
the kernel (or raise — there is no fallback on the card).  The wrappers
count their launches in ``dispatch.COUNTS``.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from graphite_tpu_torch.engine import cache as cachemod
from graphite_tpu_torch.engine import noc
from graphite_tpu_torch.engine.kernels import dispatch
from graphite_tpu_torch.engine.ops import first_true, scatter
from graphite_tpu_torch.engine.state import (PEND_EX_REQ, PEND_IFETCH,
                                             PEND_SH_REQ)
from graphite_tpu_torch.engine.vparams import VariantParams
from graphite_tpu_torch.events.schema import ICACHE_BYTES_PER_INSTRUCTION
from graphite_tpu_torch.isa import DVFSModule, EventOp
from graphite_tpu_torch.params import SimParams

I, S, E, M = cachemod.I, cachemod.S, cachemod.E, cachemod.M

# The widest window the kernels take (one thread per event in the window
# walk, a fixed per-tile history in the fast-forward walk); block_events
# is validated <= STAMP_STRIDE - 2 = 62 and the fast-forward width is
# capped at STAMP_STRIDE = 64 anyway.
MAX_WINDOW = 64


def _lat(cycles, period_ps):
    """cycles (int/tensor) at an integer ps clock period -> int64 ps."""
    return torch.as_tensor(cycles).to(torch.int64) \
        * torch.as_tensor(period_ps).to(torch.int64)


class WindowIn(NamedTuple):
    """Window-walk operands (the JAX WindowIn's fields that exist with
    private L2 and simple cores; the chain fields only at P > 0)."""

    meta: torch.Tensor           # [3, T, K] int32 (op, arg, arg2)
    addr: torch.Tensor           # [T, K] int64
    valid_ev: torch.Tensor       # [T, K] bool (pos < N & tile_active)
    tile_active: torch.Tensor    # [T] bool
    tile_ids: torch.Tensor       # [T] int32 global tile index (spawn src)
    clock: torch.Tensor          # [T] int64
    period_ps: torch.Tensor      # [T, NUM_DVFS_MODULES] int32
    bp_table: torch.Tensor       # [T, bp_size] bool
    l1i_word: torch.Tensor       # [A, T, sets] int64
    l1i_rr: torch.Tensor         # [T, sets] int32
    l1d_word: torch.Tensor
    l1d_rr: torch.Tensor
    l2_word: torch.Tensor
    l2_rr: torch.Tensor
    boundary: torch.Tensor       # [] int64
    models_enabled: torch.Tensor  # [] bool
    stamp_base: torch.Tensor     # [] int32 (round_ctr * STAMP_STRIDE)
    # Miss-chain state (None at P == 0).
    chain_rel: Optional[torch.Tensor] = None  # [T] int64
    mq_count: Optional[torch.Tensor] = None   # [T] int32
    mq_head: Optional[torch.Tensor] = None    # [T] int32
    mq_req: Optional[torch.Tensor] = None     # [P, T] int64
    mq_delta: Optional[torch.Tensor] = None   # [P, T] int64
    mq_extra: Optional[torch.Tensor] = None   # [P, T] int64


CHAIN_IN_FIELDS = ("chain_rel", "mq_count", "mq_head", "mq_req",
                   "mq_delta", "mq_extra")
CHAIN_OUT_FIELDS = ("chain_rel", "mq_count", "mq_req", "mq_delta",
                    "mq_extra")
# The WindowIn leaves the CUDA walk updates in place and returns as the
# WindowOut leaves of the same name (the chain bank only at P > 0; the
# round-robin pointers move only under round_robin replacement, L2's
# never).  Every other WindowOut leaf is a fresh tensor.
INPLACE_FIELDS = ("bp_table", "l1i_word", "l1i_rr", "l1d_word", "l1d_rr",
                  "l2_word", "l2_rr", "mq_req", "mq_delta", "mq_extra")


# Counter increments, in the order ``ctr_inc`` rows are stacked.
WINDOW_CTRS = (
    "icount", "l1i_access", "l1i_miss", "l1d_read", "l1d_read_miss",
    "l1d_write", "l1d_write_miss", "l2_access", "l2_miss", "branches",
    "mispredicts", "spawns",
)


class WindowOut(NamedTuple):
    clock: torch.Tensor          # [T] int64
    n_ret: torch.Tensor          # [T] int32 events retired (cursor inc)
    bp_table: torch.Tensor       # [T, bp_size] bool
    l1i_word: torch.Tensor
    l1i_rr: torch.Tensor
    l1d_word: torch.Tensor
    l1d_rr: torch.Tensor
    l2_word: torch.Tensor
    l2_rr: torch.Tensor
    ctr_inc: torch.Tensor        # [len(WINDOW_CTRS), T] int64
    spawn_mask: torch.Tensor     # [T, K] bool (is_spawn & retired)
    spawn_child: torch.Tensor    # [T, K] int32 clipped stream id
    spawn_land: torch.Tensor     # [T, K] int64 landing time
    chain_rel: Optional[torch.Tensor] = None  # (None at P == 0)
    mq_count: Optional[torch.Tensor] = None
    mq_req: Optional[torch.Tensor] = None
    mq_delta: Optional[torch.Tensor] = None
    mq_extra: Optional[torch.Tensor] = None


def _spanned_bound(params: SimParams, vp, boundary):
    """The boundary-spanning bound (``tpu/fanout_replay``, effective only
    at miss_chain > 0): the window, complex-slot and cadence gates admit
    one quantum of overrun past the cut.  Strict at miss_chain == 0 and
    with the replay off.  The one definition — core.py and quantum.py
    use it too, so the walk and those gates cannot drift apart."""
    if params.miss_chain > 0 and params.fanout_replay:
        q = vp.quantum_ps if vp is not None else params.quantum_ps
        return boundary + q
    return boundary


def _ff_bound(params: SimParams, vp, boundary):
    """The fast-forward bound: the analytic span commits events whose
    pre-clock stays under the window's (possibly spanned) bound plus the
    variant run-ahead budget ``tpu/fast_forward_span``.  At span 0 it
    equals the window bound.  The one definition — core.py uses it for
    the cadence gate, so the gate and the walk's commit cut agree."""
    b = _spanned_bound(params, vp, boundary)
    if params.fast_forward > 0:
        span = vp.fast_forward_span_ps if vp is not None \
            else params.fast_forward_span_ps
        return b + span
    return b


def check_window_config(params: SimParams) -> None:
    """The walk's scope in this slice; anything else is a later slice."""
    if params.core.model != "simple":
        raise NotImplementedError(
            "the window walk for iocoom cores is ported in a later slice")
    if params.shared_l2:
        raise NotImplementedError(
            "shared-L2 protocols are ported in a later slice")
    if params.block_events > MAX_WINDOW:
        raise NotImplementedError(
            f"block_events > {MAX_WINDOW} is not supported by the kernel")


def window_walk(params: SimParams, vp: VariantParams, wi: WindowIn,
                s_ids: int) -> WindowOut:
    """Classify + retire one [T, K] window — the plain PyTorch form, a
    transliteration of the JAX walk for private L2 and simple cores, at
    any P (see graphite_tpu/engine/kernels/window.py and engine/core.py
    for the semantics commentary).  Pure: reads only ``wi``, returns
    every effect."""
    check_window_config(params)
    K = wi.addr.shape[1]
    TL = wi.clock.shape[0]
    P = params.miss_chain
    dev = wi.clock.device
    line_bits = params.line_size.bit_length() - 1
    rows = torch.arange(TL, device=dev)
    wbound = _spanned_bound(params, vp, wi.boundary)

    l1i = cachemod.CacheArrays(word=wi.l1i_word, rr_ptr=wi.l1i_rr)
    l1d = cachemod.CacheArrays(word=wi.l1d_word, rr_ptr=wi.l1d_rr)
    l2 = cachemod.CacheArrays(word=wi.l2_word, rr_ptr=wi.l2_rr)

    valid_ev = wi.valid_ev
    meta, addr = wi.meta, wi.addr
    op, arg, arg2 = meta[0], meta[1], meta[2]
    op = torch.where(valid_ev, op, int(EventOp.NOP))
    en = wi.models_enabled

    p_core = wi.period_ps[:, int(DVFSModule.CORE)][:, None]
    p_l1i = wi.period_ps[:, int(DVFSModule.L1_ICACHE)][:, None]
    p_l1d = wi.period_ps[:, int(DVFSModule.L1_DCACHE)][:, None]
    p_l2 = wi.period_ps[:, int(DVFSModule.L2_CACHE)][:, None]
    l1i_ps = _lat(vp.l1i_access_cycles, p_l1i)
    l1d_ps = _lat(vp.l1d_access_cycles, p_l1d)
    l2_ps = _lat(vp.l2_access_cycles, p_l2)
    cycle_ps = _lat(1, p_core)

    line = addr >> line_bits
    is_comp = op == EventOp.COMPUTE
    is_br = op == EventOp.BRANCH
    is_rd = op == EventOp.MEM_READ
    is_wr = op == EventOp.MEM_WRITE
    is_mem = is_rd | is_wr
    is_stall = op == EventOp.STALL
    is_sync = op == EventOp.SYNC
    is_spawn = op == EventOp.SPAWN

    # ---- probes against window-start state
    pI = cachemod.probe(l1i, line, params.l1i.num_sets)
    pD = cachemod.probe(l1d, line, params.l1d.num_sets)
    pL2 = cachemod.probe(l2, line, params.l2.num_sets)

    writable = pD.state >= M
    l1_ok = pD.hit & (is_rd | writable)
    mem_l2 = is_mem & ~l1_ok & pL2.hit & (is_rd | (pL2.state == M))
    comp_l2 = is_comp & ~pI.hit & pL2.hit
    mem_simple = is_mem & (l1_ok | mem_l2)
    comp_simple = is_comp & (pI.hit | comp_l2)
    fill_d = mem_l2                           # L1D fill from local L2 hit
    fill_i = comp_l2                          # L1I fill from local L2 hit
    none = torch.zeros_like(l1_ok)

    # Bankable misses (P > 0): a miss past the local L2 banks as a chain
    # element instead of ending the window.
    if P > 0:
        mem_bank0 = is_mem & ~l1_ok & ~mem_l2
        comp_bank0 = is_comp & ~pI.hit & ~comp_l2
    else:
        mem_bank0 = comp_bank0 = none

    ar = torch.arange(K, device=dev)
    earlier = ar[None, :, None] > ar[None, None, :]           # [1, Kj, Ki]

    # ---- chain forwarding (hit-on-pending-fill): a bankable miss to a
    # line an earlier element (in this window, or banked in an earlier
    # round) already requests is served by that element's fill.
    wfwd = P > 0 and params.fanout_replay
    if P > 0:
        same_line_w = line[:, :, None] == line[:, None, :]    # [T, Kj, Ki]
        fwd_win_d = (earlier & same_line_w & mem_bank0[:, None, :]
                     & is_rd[:, :, None]).any(dim=2)
        fwd_win_i = (earlier & same_line_w
                     & comp_bank0[:, None, :]).any(dim=2)
        slots_pc = torch.arange(P, dtype=torch.int32, device=dev)[:, None]
        pvalid = (slots_pc >= wi.mq_head[None, :]) \
            & (slots_pc < wi.mq_count[None, :])               # [P, T]
        pline = wi.mq_req >> 8
        pkind = (wi.mq_req & 7).to(torch.int32)
        p_is_if = pkind == PEND_IFETCH
        pend_memT = (pvalid & ~p_is_if).T[:, None, :]         # [T, 1, P]
        pend_ifT = (pvalid & p_is_if).T[:, None, :]
        linematch_p = line[:, :, None] == pline.T[:, None, :]  # [T, K, P]
        cover_pd = linematch_p & pend_memT & is_rd[:, :, None]
        cover_pi = linematch_p & pend_ifT
        if wfwd:
            # In-window write-over-EX-bank forwarding.
            fwd_win_w = (earlier & same_line_w
                         & (mem_bank0 & is_wr)[:, None, :]
                         & is_wr[:, :, None]).any(dim=2)
            fwd_win_d = fwd_win_d | fwd_win_w
        fwd_pend_d = torch.any(cover_pd, dim=2)
        fwd_pend_i = torch.any(cover_pi, dim=2)
        mem_fwd = mem_bank0 & (fwd_win_d | fwd_pend_d)
        comp_fwd = comp_bank0 & (fwd_win_i | fwd_pend_i)
    else:
        mem_fwd = comp_fwd = none
    mem_bank = mem_bank0 & ~mem_fwd
    comp_bank = comp_bank0 & ~comp_fwd
    mem_simple = mem_simple | mem_fwd
    comp_simple = comp_simple | comp_fwd

    def _hazard(fills, accesses, set_idx):
        """accesses[j] unsafe if exists i<j with fills[i] & same set."""
        same = set_idx[:, :, None] == set_idx[:, None, :]
        return accesses & (earlier & same & fills[:, None, :]).any(dim=2)

    touch_d = is_mem & l1_ok
    touch_i = is_comp & pI.hit
    haz_d = _hazard(fill_d, is_mem, pD.set_idx) \
        | _hazard(touch_d | fill_d, fill_d, pD.set_idx)
    haz_i = _hazard(fill_i, is_comp, pI.set_idx) \
        | _hazard(touch_i | fill_i, fill_i, pI.set_idx)
    if P > 0:
        # Same-line accesses behind a bank its forwarding does not cover.
        bank_w_uncov = (mem_bank0 & ~is_wr) if wfwd else mem_bank0
        uncov_w = earlier & same_line_w & (
            (is_mem[:, :, None] & comp_bank0[:, None, :])
            | (is_wr[:, :, None] & bank_w_uncov[:, None, :])
            | (is_comp[:, :, None] & mem_bank0[:, None, :]))
        hazard_uncov = uncov_w.any(dim=2)
        haz_d = haz_d | (is_mem & hazard_uncov)
        haz_i = haz_i | (is_comp & hazard_uncov)
    hazard = haz_d | haz_i

    # Banked-miss L2 hazards: an access to the L2 set a banked element
    # will fill (other than the line it covers) waits.
    l2_fill_cand = mem_bank | comp_bank
    if P > 0:
        l2ss = pL2.set_idx[:, :, None] == pL2.set_idx[:, None, :]
        l2_cover = same_line_w & (
            (is_mem[:, :, None] & mem_bank0[:, None, :]
             & is_rd[:, :, None])
            | (is_comp[:, :, None] & comp_bank0[:, None, :]))
        if wfwd:
            l2_cover = l2_cover | (
                same_line_w & is_wr[:, :, None]
                & (mem_bank0 & is_wr)[:, None, :])
        hazard = hazard | ((is_mem | is_comp) & (
            earlier & l2ss & ~l2_cover
            & l2_fill_cand[:, None, :]).any(dim=2))

    # Pending-chain hazards (stall-on-use across rounds) against the
    # elements banked in earlier rounds.
    if P > 0:
        pvT = pvalid.T[:, None, :]
        haz_pend = (is_mem & torch.any(
            linematch_p & pvT & ~cover_pd, dim=2)) \
            | (is_comp & torch.any(linematch_p & pvT & ~cover_pi, dim=2))
        p2_set = cachemod.set_index(pline, params.l2.num_sets).T
        haz_pend = haz_pend | ((is_mem | is_comp) & torch.any(
            pvT & ~(cover_pd | cover_pi)
            & (pL2.set_idx[:, :, None] == p2_set[:, None, :]), dim=2))
        hazard = hazard | haz_pend

    base_ok = valid_ev & ~hazard & en
    ok_rel = (comp_simple | mem_simple | is_br) & base_ok
    ok_abs = (is_stall | is_sync | is_spawn) & base_ok
    ok_bank = (mem_bank | comp_bank) & base_ok
    ok = ok_rel | ok_abs | ok_bank

    # ---- branch predictor: within-window read-after-write on table slots
    taken = arg != 0
    if params.core.bp_type == "none":
        correct = torch.ones_like(is_br)
        bidx = None
    else:
        bidx = (addr % params.core.bp_size).to(torch.int32)
        tbl_pred = torch.gather(wi.bp_table, 1, bidx.to(torch.int64))
        same_slot = bidx[:, :, None] == bidx[:, None, :]
        w_mask = earlier & same_slot & (is_br & ok)[:, None, :]
        has_w = w_mask.any(dim=2)
        last_w = torch.argmax(torch.where(w_mask, ar[None, None, :], -1),
                              dim=2)
        pred_blk = torch.gather(taken, 1, last_w)
        pred = torch.where(has_w, pred_blk, tbl_pred)
        correct = pred == taken

    # ---- per-event dt (int64 ps) and clock floors
    icount_ev = torch.clamp(arg2 & ((1 << 20) - 1), min=0).to(torch.int64)
    n_lines = torch.clamp(
        (icount_ev * ICACHE_BYTES_PER_INSTRUCTION + params.line_size - 1)
        // params.line_size, min=1)
    cost_ps = _lat(torch.clamp(arg, min=0), p_core)
    fetch_ps = icount_ev * l1i_ps
    dt_comp = cost_ps + fetch_ps + torch.where(comp_l2, n_lines * l2_ps, 0)
    dt_br = torch.where(correct, cycle_ps,
                        _lat(vp.bp_mispredict_penalty, p_core)) + l1i_ps
    dt_mem = torch.where(mem_l2, l1d_ps + l2_ps, l1d_ps)
    dt_spawn = _lat(torch.clamp(arg, min=0), p_core)
    dt = torch.zeros((TL, K), dtype=torch.int64, device=dev)
    dt = torch.where(is_comp, dt_comp, dt)
    dt = torch.where(is_br, dt_br, dt)
    dt = torch.where(is_mem, dt_mem, dt)
    dt = torch.where(is_sync, cost_ps, dt)
    dt = torch.where(en, dt, torch.where(is_sync, cost_ps, 0))
    dt = torch.where(is_spawn, dt_spawn, dt)
    NEGF = -(2**62)
    floor = torch.where(is_stall | is_sync, addr, NEGF)

    # ---- max-plus prefix.  At P > 0 a banked miss records its issue
    # point (absolute for the chain's first element, else relative to the
    # previous element's still-unknown completion) and the tile runs on
    # a relative clock ``rel`` until the resolve pass drains the chain.
    qps = vp.quantum_ps
    issue_off = torch.where(is_comp, l1i_ps, l1d_ps) \
        + _lat(vp.l2_tags_access_cycles, p_l2)
    clk = wi.clock
    rel = wi.chain_rel if P > 0 else None
    nm = wi.mq_count if P > 0 else None
    n_ret = torch.zeros(TL, dtype=torch.int32, device=dev)
    run = wi.tile_active
    clks = []
    bank_marks, bank_slots, bank_deltas = [], [], []
    for j in range(K):
        clks.append(clk)                     # clock BEFORE event j
        if P > 0:
            bank_j = ok_bank[:, j] & (nm < P)
            okj = ok_rel[:, j] | (ok_abs[:, j] & (nm == 0)) | bank_j
            in_b = torch.where(nm == 0, clk < wbound,
                               (rel < qps) & (nm < P))
            can = run & okj & in_b
            bankc = can & bank_j
            bank_marks.append(bankc)
            bank_slots.append(nm)
            bank_deltas.append(torch.where(nm == 0, clk, rel)
                               + issue_off[:, j])
            abs_step = can & (nm == 0) & ~bankc
            rel_step = can & (nm > 0) & ~bankc
            rel = torch.where(bankc, 0,
                              torch.where(rel_step, rel + dt[:, j], rel))
            nm = nm + bankc.to(torch.int32)
        else:
            can = run & (ok_rel[:, j] | ok_abs[:, j]) & (clk < wi.boundary)
            abs_step = can
        clk = torch.where(abs_step,
                          torch.maximum(clk, floor[:, j]) + dt[:, j], clk)
        n_ret = n_ret + can.to(torch.int32)
        run = can
    clk_before = torch.stack(clks, dim=1)                     # [T, K]
    retired = ar[None, :] < n_ret[:, None]                    # [T, K]

    # ---- SPAWN landing times (the cross-tile scatter is the caller's)
    child = torch.clip(arg2, 0, s_ids - 1)
    spawn_land = clk_before + dt_spawn + noc.unicast_ps(
        params.net_user,
        torch.broadcast_to(wi.tile_ids[:, None], (TL, K)),
        child % params.num_tiles, 8,
        wi.period_ps[:, int(DVFSModule.NETWORK_USER)][:, None],
        params.mesh_width, vnet=vp.net_user)
    spawn_mask = is_spawn & retired

    # ---- apply cache effects (stamps encode within-window order)
    stamp = (wi.stamp_base + ar)[None, :]
    enb = torch.broadcast_to(en, (TL, K))
    l1i = cachemod.touch(l1i, pI.set_idx, pI.way,
                         touch_i & retired & enb,
                         cachemod.row_word(pI.row, pI.way), stamp)
    l1d = cachemod.touch(l1d, pD.set_idx, pD.way,
                         touch_d & retired & enb,
                         cachemod.row_word(pD.row, pD.way), stamp)
    l2 = cachemod.touch(l2, pL2.set_idx, pL2.way,
                        (mem_l2 | comp_l2) & retired & enb,
                        cachemod.row_word(pL2.row, pL2.way), stamp)

    def _apply_fills(cache, fills, probe, fill_state, cp):
        act = fills & retired & enb
        st_row = cachemod.word_state(probe.row)       # [A, T, K]
        invalid = st_row == cachemod.I
        has_inv = invalid.any(dim=0)
        first_inv = first_true(invalid, 0)
        lru_way = torch.argmin(cachemod.word_stamp(probe.row), dim=0)
        vic_way = torch.where(has_inv, first_inv, lru_way)
        fway = torch.where(probe.hit, probe.way.to(torch.int64), vic_way)
        new_word = cachemod.pack_word(line.to(torch.int32), stamp,
                                      fill_state)
        if cp.replacement == "round_robin":
            adv = act & ~probe.hit
            rr = torch.gather(cache.rr_ptr, 1, probe.set_idx.to(torch.int64))
            A = cache.word.shape[0]
            fway = torch.where(probe.hit, probe.way.to(torch.int64),
                               torch.where(has_inv, first_inv,
                                           (rr % A).to(torch.int64)))
            cache = cache._replace(rr_ptr=scatter(
                cache.rr_ptr, (rows[:, None], probe.set_idx), (rr + 1) % A,
                "set", mask=adv))
        cache = cache._replace(word=scatter(
            cache.word, (fway, rows[:, None], probe.set_idx), new_word,
            "set", mask=act))
        return cache

    l1d = _apply_fills(l1d, fill_d, pD,
                       torch.where(is_wr, M, S).to(torch.int32), params.l1d)
    l1i = _apply_fills(l1i, fill_i, pI,
                       torch.full((TL, K), S, dtype=torch.int32, device=dev),
                       params.l1i)

    # ---- branch-predictor table: last retired write per slot wins
    bp_table = wi.bp_table
    if bidx is not None:
        wr_ev = is_br & retired & enb
        later_same = (earlier.transpose(1, 2) & same_slot
                      & wr_ev[:, None, :]).any(dim=2)
        winner = wr_ev & ~later_same
        bp_table = scatter(bp_table, (rows[:, None], bidx), taken, "set",
                           mask=winner)

    # ---- counters
    def msum(mask, val=1):
        v = torch.as_tensor(val, device=dev)
        v = torch.broadcast_to(v, (TL, K)) if v.ndim < 2 else v
        return torch.sum(torch.where(mask & retired & enb,
                                     v.to(torch.int64), 0), dim=1)

    zero = torch.zeros(TL, dtype=torch.int64, device=dev)
    ctr_inc = torch.stack([
        msum(is_comp, icount_ev)
        + msum((is_mem & ((arg2 & 0xFF) == 0)) | is_br),     # icount
        msum(is_comp, icount_ev) + msum(is_br),              # l1i_access
        msum(is_comp & ~pI.hit & ~comp_fwd, n_lines),        # l1i_miss
        msum(is_rd),                                         # l1d_read
        msum(is_rd & ~l1_ok & ~mem_fwd),                     # l1d_read_miss
        msum(is_wr),                                         # l1d_write
        msum(is_wr & ~l1_ok & ~mem_fwd),                     # l1d_write_miss
        msum(mem_l2 | comp_l2 | l2_fill_cand),               # l2_access
        msum(l2_fill_cand) if P > 0 else zero,               # l2_miss
        msum(is_br),                                         # branches
        msum(is_br & ~correct),                              # mispredicts
        msum(is_spawn),                                      # spawns
    ])

    # ---- record banked chain elements ([T, K] window results -> the
    # [P, T] chain arrays, via a dense slot one-hot)
    chain = {}
    if P > 0:
        bank_mark = torch.stack(bank_marks, dim=1)    # [T, K]
        bank_slot = torch.stack(bank_slots, dim=1)
        bank_delta = torch.stack(bank_deltas, dim=1)
        kind_ev = torch.where(is_comp, PEND_IFETCH,
                              torch.where(is_wr, PEND_EX_REQ, PEND_SH_REQ))
        req_val = kind_ev.to(torch.int64) | (line << 8)
        extra_val = torch.where(is_comp,
                                cost_ps + fetch_ps + (n_lines - 1) * l2_ps,
                                0)
        slot_oh = (bank_slot[None] == torch.arange(
            P, device=dev)[:, None, None]) & bank_mark[None]   # [P, T, K]
        anyb = slot_oh.any(dim=2)

        def put(dst, val):
            v = torch.sum(torch.where(slot_oh, val[None], 0),
                          dim=2).to(dst.dtype)
            return torch.where(anyb, v, dst)

        chain = dict(mq_req=put(wi.mq_req, req_val),
                     mq_delta=put(wi.mq_delta, bank_delta),
                     mq_extra=put(wi.mq_extra, extra_val),
                     mq_count=nm, chain_rel=torch.where(nm > 0, rel, 0))

    return WindowOut(
        clock=clk, n_ret=n_ret, bp_table=bp_table,
        l1i_word=l1i.word, l1i_rr=l1i.rr_ptr,
        l1d_word=l1d.word, l1d_rr=l1d.rr_ptr,
        l2_word=l2.word, l2_rr=l2.rr_ptr,
        ctr_inc=ctr_inc,
        spawn_mask=spawn_mask, spawn_child=child.to(torch.int32),
        spawn_land=spawn_land, **chain,
    )


# ------------------------------------------------------- the CUDA kernel

class _WalkArgs(ctypes.Structure):
    """Mirror of ``struct WalkArgs`` in csrc/window_walk.cu: pointers,
    then int64 scalars only, so the layout has no padding."""

    _fields_ = [(n, ctypes.c_void_p) for n in (
        "meta", "addr", "valid_ev", "tile_active", "tile_ids", "clock",
        "period_ps", "boundary", "models_enabled", "stamp_base",
        "bp", "l1i", "l1i_rr", "l1d", "l1d_rr", "l2",
        "clock_out", "n_ret", "ctr_inc", "spawn_mask", "spawn_child",
        "spawn_land", "chain_rel", "mq_count", "mq_head", "mq_req",
        "mq_delta", "mq_extra", "chain_rel_out", "mq_count_out")] + [
        (n, ctypes.c_int64) for n in (
        "T", "K", "NM", "l1i_assoc", "l1i_sets", "l1i_round_robin",
        "l1d_assoc", "l1d_sets", "l1d_round_robin", "l2_assoc", "l2_sets",
        "bp_size", "line_bits", "line_size", "l1i_cycles", "l1d_cycles",
        "l2_cycles", "bp_penalty", "col_core", "col_l1i", "col_l1d",
        "col_l2", "col_nu", "s_ids", "num_tiles", "mesh_width", "nu_magic",
        "nu_hop_cycles", "nu_ser_cycles", "P", "wfwd", "qps", "wbound_add",
        "l2_tags_cycles")]


def _check(name, t, dtype, shape, dev):
    if t.device != dev:
        raise ValueError(f"window_walk: {name} is on {t.device}, not {dev}")
    if t.dtype != dtype:
        raise ValueError(f"window_walk: {name} is {t.dtype}, not {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"window_walk: {name} has shape {tuple(t.shape)}, "
            f"not {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"window_walk: {name} is not contiguous")


def _check_inputs(params: SimParams, wi: WindowIn) -> None:
    """Device, dtype, shape and contiguity of every operand, and no
    storage shared with a leaf the walk updates in place."""
    dev = wi.clock.device
    T, K = wi.addr.shape
    if K > MAX_WINDOW:
        raise ValueError(f"window_walk: K = {K} > {MAX_WINDOW}")
    NM = wi.period_ps.shape[1]
    i32, i64, b = torch.int32, torch.int64, torch.bool
    Ai, Si = params.l1i.associativity, params.l1i.num_sets
    Ad, Sd = params.l1d.associativity, params.l1d.num_sets
    A2, S2 = params.l2.associativity, params.l2.num_sets
    BP = wi.bp_table.shape[1]
    for name, t, dt, shape in (
            ("meta", wi.meta, i32, (3, T, K)), ("addr", wi.addr, i64, (T, K)),
            ("valid_ev", wi.valid_ev, b, (T, K)),
            ("tile_active", wi.tile_active, b, (T,)),
            ("tile_ids", wi.tile_ids, i32, (T,)),
            ("clock", wi.clock, i64, (T,)),
            ("period_ps", wi.period_ps, i32, (T, NM)),
            ("bp_table", wi.bp_table, b, (T, BP)),
            ("l1i_word", wi.l1i_word, i64, (Ai, T, Si)),
            ("l1i_rr", wi.l1i_rr, i32, (T, Si)),
            ("l1d_word", wi.l1d_word, i64, (Ad, T, Sd)),
            ("l1d_rr", wi.l1d_rr, i32, (T, Sd)),
            ("l2_word", wi.l2_word, i64, (A2, T, S2)),
            ("l2_rr", wi.l2_rr, i32, (T, S2)),
            ("boundary", wi.boundary, i64, ()),
            ("models_enabled", wi.models_enabled, b, ()),
            ("stamp_base", wi.stamp_base, i32, ())):
        _check(name, t, dt, shape, dev)
    P = params.miss_chain
    for name in CHAIN_IN_FIELDS:
        if (getattr(wi, name) is None) != (P == 0):
            raise ValueError(f"window_walk: {name} is given iff "
                             f"tpu/miss_chain > 0")
    if P > 0:
        for name, dt, shape in (
                ("chain_rel", i64, (T,)), ("mq_count", i32, (T,)),
                ("mq_head", i32, (T,)), ("mq_req", i64, (P, T)),
                ("mq_delta", i64, (P, T)), ("mq_extra", i64, (P, T))):
            _check(name, getattr(wi, name), dt, shape, dev)
    dispatch.check_no_alias("window_walk", wi, INPLACE_FIELDS)


def _alloc_out(params: SimParams, wi: WindowIn) -> WindowOut:
    """Outputs: the operands the kernel updates in place (INPLACE_FIELDS:
    caches, round-robin pointers, predictor table, chain bank) and fresh
    tensors for the rest."""
    dev = wi.clock.device
    T, K = wi.addr.shape
    i32, i64, b = torch.int32, torch.int64, torch.bool
    return WindowOut(
        clock=torch.empty(T, dtype=i64, device=dev),
        n_ret=torch.empty(T, dtype=i32, device=dev),
        ctr_inc=torch.empty((len(WINDOW_CTRS), T), dtype=i64, device=dev),
        spawn_mask=torch.empty((T, K), dtype=b, device=dev),
        spawn_child=torch.empty((T, K), dtype=i32, device=dev),
        spawn_land=torch.empty((T, K), dtype=i64, device=dev),
        **{f: getattr(wi, f) for f in INPLACE_FIELDS},
        **({} if params.miss_chain == 0 else dict(
            chain_rel=torch.empty(T, dtype=i64, device=dev),
            mq_count=torch.empty(T, dtype=i32, device=dev))),
    )


def _walk_args(params: SimParams, vp: VariantParams, wi: WindowIn,
               s_ids: int, out: WindowOut) -> _WalkArgs:
    """Pack pointers and scalars into the kernel's argument struct."""
    T, K = wi.addr.shape
    nu = params.net_user
    noc._zero_load_only(nu)
    flits = noc.num_flits(8, vp.net_user.flit_width_bits)
    P = params.miss_chain

    def ptr(t):
        return t.data_ptr() if t is not None else None

    return _WalkArgs(
        chain_rel=ptr(wi.chain_rel), mq_count=ptr(wi.mq_count),
        mq_head=ptr(wi.mq_head), mq_req=ptr(wi.mq_req),
        mq_delta=ptr(wi.mq_delta), mq_extra=ptr(wi.mq_extra),
        chain_rel_out=ptr(out.chain_rel), mq_count_out=ptr(out.mq_count),
        P=P, wfwd=int(P > 0 and params.fanout_replay), qps=vp.quantum_ps,
        wbound_add=vp.quantum_ps if P > 0 and params.fanout_replay else 0,
        l2_tags_cycles=vp.l2_tags_access_cycles,
        meta=wi.meta.data_ptr(), addr=wi.addr.data_ptr(),
        valid_ev=wi.valid_ev.data_ptr(),
        tile_active=wi.tile_active.data_ptr(),
        tile_ids=wi.tile_ids.data_ptr(), clock=wi.clock.data_ptr(),
        period_ps=wi.period_ps.data_ptr(), boundary=wi.boundary.data_ptr(),
        models_enabled=wi.models_enabled.data_ptr(),
        stamp_base=wi.stamp_base.data_ptr(),
        bp=wi.bp_table.data_ptr(), l1i=wi.l1i_word.data_ptr(),
        l1i_rr=wi.l1i_rr.data_ptr(), l1d=wi.l1d_word.data_ptr(),
        l1d_rr=wi.l1d_rr.data_ptr(), l2=wi.l2_word.data_ptr(),
        clock_out=out.clock.data_ptr(), n_ret=out.n_ret.data_ptr(),
        ctr_inc=out.ctr_inc.data_ptr(), spawn_mask=out.spawn_mask.data_ptr(),
        spawn_child=out.spawn_child.data_ptr(),
        spawn_land=out.spawn_land.data_ptr(),
        T=T, K=K, NM=wi.period_ps.shape[1],
        l1i_assoc=params.l1i.associativity, l1i_sets=params.l1i.num_sets,
        l1i_round_robin=int(params.l1i.replacement == "round_robin"),
        l1d_assoc=params.l1d.associativity, l1d_sets=params.l1d.num_sets,
        l1d_round_robin=int(params.l1d.replacement == "round_robin"),
        l2_assoc=params.l2.associativity, l2_sets=params.l2.num_sets,
        bp_size=0 if params.core.bp_type == "none" else wi.bp_table.shape[1],
        line_bits=params.line_size.bit_length() - 1,
        line_size=params.line_size,
        l1i_cycles=vp.l1i_access_cycles, l1d_cycles=vp.l1d_access_cycles,
        l2_cycles=vp.l2_access_cycles, bp_penalty=vp.bp_mispredict_penalty,
        col_core=int(DVFSModule.CORE), col_l1i=int(DVFSModule.L1_ICACHE),
        col_l1d=int(DVFSModule.L1_DCACHE), col_l2=int(DVFSModule.L2_CACHE),
        col_nu=int(DVFSModule.NETWORK_USER), s_ids=s_ids,
        num_tiles=params.num_tiles, mesh_width=params.mesh_width,
        nu_magic=int(nu.model == "magic"),
        nu_hop_cycles=vp.net_user.router_delay_cycles
        + vp.net_user.link_delay_cycles,
        nu_ser_cycles=max(flits - 1, 0))


def window_walk_cuda(params: SimParams, vp: VariantParams, wi: WindowIn,
                     s_ids: int) -> WindowOut:
    """Launch csrc/window_walk.cu on CUDA tensors.  In place: the kernel
    updates the operands' cache word arrays, L1 round-robin pointers
    (under round_robin), predictor table and, at P > 0, [P, T] chain bank,
    and the returned WindowOut holds those operand tensors
    (INPLACE_FIELDS); its other leaves are fresh.  A caller that needs
    the operands unchanged clones them first."""
    check_window_config(params)
    if wi.clock.device.type != "cuda":
        raise ValueError("window_walk_cuda takes CUDA tensors")
    _check_inputs(params, wi)
    from graphite_tpu_torch.engine.kernels import build
    lib = build.load("window_walk")
    out = _alloc_out(params, wi)
    a = _walk_args(params, vp, wi, s_ids, out)
    stream = torch.cuda.current_stream(wi.clock.device).cuda_stream
    err = lib.window_walk_launch(ctypes.addressof(a), stream)
    if err != 0:
        raise RuntimeError(f"window_walk kernel launch failed: CUDA error "
                           f"{err} ({build.error_string(lib, err)})")
    dispatch.COUNTS["window_walk"] += 1
    return out


def run_window(params: SimParams, vp: VariantParams, wi: WindowIn,
               s_ids: int) -> WindowOut:
    """The walk, dispatched by device: the CUDA kernel for CUDA tensors,
    the plain PyTorch form for CPU tensors."""
    if dispatch.use_kernel(wi.clock):
        return window_walk_cuda(params, vp, wi, s_ids)
    return window_walk(params, vp, wi, s_ids)



# ------------------------------------------------- the fast-forward walk

class FFIn(NamedTuple):
    """Fast-forward-walk operands: the hit/compute-only subset of the
    window operands over a [T, F] span (F = core._ff_width).  No chain
    state, no L2, no round-robin pointers: the leg excludes every event
    class that could need them."""

    meta: torch.Tensor           # [3, T, F] int32 (op, arg, arg2)
    addr: torch.Tensor           # [T, F] int64
    valid_ev: torch.Tensor       # [T, F] bool (pos < N & candidate)
    tile_active: torch.Tensor    # [T] bool fast-forward candidates
    clock: torch.Tensor          # [T] int64
    period_ps: torch.Tensor      # [T, NUM_DVFS_MODULES] int32
    bp_table: torch.Tensor       # [T, bp_size] bool
    l1i_word: torch.Tensor       # [A, T, sets] int64
    l1d_word: torch.Tensor       # [A, T, sets] int64
    boundary: torch.Tensor       # [] int64
    models_enabled: torch.Tensor  # [] bool
    stamp_base: torch.Tensor     # [] int32


class FFOut(NamedTuple):
    clock: torch.Tensor          # [T] int64
    n_ret: torch.Tensor          # [T] int32 (0 on every declined tile)
    bp_table: torch.Tensor       # [T, bp_size] bool
    l1i_word: torch.Tensor       # [A, T, sets] int64 (touch stamps only)
    l1d_word: torch.Tensor       # [A, T, sets] int64
    ctr_inc: torch.Tensor        # [len(WINDOW_CTRS), T] int64


# The tile axis of each operand and output (None: a replicated scalar),
# as the JAX package declares them for its tile-sharded walk; the
# multi-device slice slices by them.
FF_IN_AXES = dict(
    meta=1, addr=0, valid_ev=0, tile_active=0, clock=0, period_ps=0,
    bp_table=0, l1i_word=1, l1d_word=1, boundary=None,
    models_enabled=None, stamp_base=None,
)
FF_OUT_AXES = dict(clock=0, n_ret=0, bp_table=0, l1i_word=1, l1d_word=1,
                   ctr_inc=1)

# The operands the CUDA fast-forward walk updates in place and returns as
# the FFOut leaves of the same names.
FF_INPLACE_FIELDS = ("bp_table", "l1i_word", "l1d_word")


def check_ff_config(params: SimParams) -> None:
    """The fast-forward walk's scope: simple cores under MSI.  The sticky
    E->M upgrade of ``sh_l2_mesi`` is not ported; refusing it keeps a
    span from being mispriced."""
    if params.core.model != "simple":
        raise NotImplementedError(
            "the fast-forward leg is disabled under iocoom cores")
    if params.protocol_kind == "sh_l2_mesi":
        raise NotImplementedError(
            "the fast-forward walk under sh_l2_mesi (sticky E->M upgrades) "
            "is ported in a later slice")


class FFPrice(NamedTuple):
    """The walk's per-event pricing before any effect lands ([T, F]
    unless noted): what the span commits and whether the tile engages."""

    line: torch.Tensor
    is_comp: torch.Tensor
    is_br: torch.Tensor
    is_rd: torch.Tensor
    is_wr: torch.Tensor
    pI: cachemod.ProbeResult
    pD: cachemod.ProbeResult
    taken: torch.Tensor
    bidx: Optional[torch.Tensor]   # None without a branch predictor
    correct: torch.Tensor
    icount_ev: torch.Tensor
    dt: torch.Tensor
    lead: torch.Tensor             # leading eligible run
    commit0: torch.Tensor          # lead & pre-clock under _ff_bound
    engage: torch.Tensor           # [T]


def ff_price(params: SimParams, vp: VariantParams, fi: FFIn) -> FFPrice:
    """Classify and price every event of the span against span-start
    state (the first half of :func:`fast_forward_walk`).  Eligible
    events are COMPUTE with an L1I hit, BRANCH, and MEM reads / writes
    with a readable / writable L1D hit: pure hits install no lines, so
    span-start probes give the hits the window rounds would see event by
    event, and the clock prefix is a cumulative sum."""
    check_ff_config(params)
    TL, F = fi.addr.shape
    dev = fi.clock.device
    line_bits = params.line_size.bit_length() - 1

    l1i = cachemod.CacheArrays(word=fi.l1i_word, rr_ptr=None)
    l1d = cachemod.CacheArrays(word=fi.l1d_word, rr_ptr=None)
    valid_ev = fi.valid_ev
    op, arg, arg2 = fi.meta[0], fi.meta[1], fi.meta[2]
    op = torch.where(valid_ev, op, int(EventOp.NOP))
    en = fi.models_enabled

    p_core = fi.period_ps[:, int(DVFSModule.CORE)][:, None]
    p_l1i = fi.period_ps[:, int(DVFSModule.L1_ICACHE)][:, None]
    p_l1d = fi.period_ps[:, int(DVFSModule.L1_DCACHE)][:, None]
    l1i_ps = _lat(vp.l1i_access_cycles, p_l1i)
    l1d_ps = _lat(vp.l1d_access_cycles, p_l1d)
    cycle_ps = _lat(1, p_core)

    line = fi.addr >> line_bits
    is_comp = op == EventOp.COMPUTE
    is_br = op == EventOp.BRANCH
    is_rd = op == EventOp.MEM_READ
    is_wr = op == EventOp.MEM_WRITE
    is_mem = is_rd | is_wr

    pI = cachemod.probe(l1i, line, params.l1i.num_sets)
    pD = cachemod.probe(l1d, line, params.l1d.num_sets)
    l1_ok = pD.hit & (is_rd | (pD.state >= M))
    elig = ((is_comp & pI.hit) | is_br | (is_mem & l1_ok)) \
        & valid_ev & fi.tile_active[:, None] & en
    lead = torch.cumsum((~elig).to(torch.int32), dim=1) == 0

    ar = torch.arange(F, device=dev)
    earlier = ar[None, :, None] > ar[None, None, :]           # [1, Fj, Fi]

    # Branch predictor: the last earlier in-lead write to the slot, else
    # the table (commits are a prefix of the lead, so this is exact).
    taken = arg != 0
    if params.core.bp_type == "none":
        correct = torch.ones_like(is_br)
        bidx = None
    else:
        bidx = (fi.addr % params.core.bp_size).to(torch.int32)
        tbl_pred = torch.gather(fi.bp_table, 1, bidx.to(torch.int64))
        same_slot = bidx[:, :, None] == bidx[:, None, :]
        w_mask = earlier & same_slot & (is_br & lead)[:, None, :]
        has_w = w_mask.any(dim=2)
        last_w = torch.argmax(torch.where(w_mask, ar[None, None, :], -1),
                              dim=2)
        pred = torch.where(has_w, torch.gather(taken, 1, last_w), tbl_pred)
        correct = pred == taken

    icount_ev = torch.clamp(arg2 & ((1 << 20) - 1), min=0).to(torch.int64)
    cost_ps = _lat(torch.clamp(arg, min=0), p_core)
    dt = torch.zeros((TL, F), dtype=torch.int64, device=dev)
    dt = torch.where(is_comp, cost_ps + icount_ev * l1i_ps, dt)
    dt = torch.where(is_br,
                     torch.where(correct, cycle_ps,
                                 _lat(vp.bp_mispredict_penalty, p_core))
                     + l1i_ps, dt)
    dt = torch.where(is_mem, l1d_ps, dt)

    # Commit: the clock BEFORE event j under the bound (dt >= 0, so the
    # committed events are a prefix of the lead).  A tile engages only
    # when the span beats one window round (n_commit > K) and commits
    # past the window's own bound: at span 0 it never does.
    bound = _ff_bound(params, vp, fi.boundary)
    dtm = torch.where(lead, dt, 0)
    pre = fi.clock[:, None] + torch.cumsum(dtm, dim=1) - dtm
    commit0 = lead & (pre < bound)
    n_commit = torch.sum(commit0, dim=1)
    wb = _spanned_bound(params, vp, fi.boundary)
    engage = fi.tile_active & (n_commit > params.block_events) \
        & (commit0 & (pre >= wb)).any(dim=1)
    return FFPrice(line=line, is_comp=is_comp, is_br=is_br, is_rd=is_rd,
                   is_wr=is_wr, pI=pI, pD=pD, taken=taken, bidx=bidx,
                   correct=correct, icount_ev=icount_ev, dt=dt, lead=lead,
                   commit0=commit0, engage=engage)


def fast_forward_walk(params: SimParams, vp: VariantParams,
                      fi: FFIn) -> FFOut:
    """Price each candidate tile's longest hit/compute-only prefix in
    closed form — the plain PyTorch form, a transliteration of the JAX
    walk (graphite_tpu/engine/kernels/window.py:779).  An engaged tile
    commits its prefix: clock, cursor increment, LRU-touch scatter-max
    (stamps ``stamp_base + j``), the predictor table's last committed
    write per slot, and the window's counters with every miss, L2 and
    spawn row zero.  A declined tile is returned untouched.  Pure."""
    fp = ff_price(params, vp, fi)
    TL, F = fi.addr.shape
    dev = fi.clock.device
    rows = torch.arange(TL, device=dev)
    ar = torch.arange(F, device=dev)
    is_mem = fp.is_rd | fp.is_wr

    commit = fp.commit0 & fp.engage[:, None]
    n_ret = torch.where(fp.engage, torch.sum(fp.commit0, dim=1), 0).to(
        torch.int32)
    clock = fi.clock + torch.sum(torch.where(commit, fp.dt, 0), dim=1)

    stamp = (fi.stamp_base + ar)[None, :]
    l1i = cachemod.touch(
        cachemod.CacheArrays(word=fi.l1i_word, rr_ptr=None),
        fp.pI.set_idx, fp.pI.way, fp.is_comp & commit,
        cachemod.row_word(fp.pI.row, fp.pI.way), stamp)
    l1d = cachemod.touch(
        cachemod.CacheArrays(word=fi.l1d_word, rr_ptr=None),
        fp.pD.set_idx, fp.pD.way, is_mem & commit,
        cachemod.row_word(fp.pD.row, fp.pD.way), stamp)

    bp_table = fi.bp_table
    if fp.bidx is not None:
        earlier = ar[None, :, None] > ar[None, None, :]
        same_slot = fp.bidx[:, :, None] == fp.bidx[:, None, :]
        wr_ev = fp.is_br & commit
        later_same = (earlier.transpose(1, 2) & same_slot
                      & wr_ev[:, None, :]).any(dim=2)
        winner = wr_ev & ~later_same
        bp_table = scatter(bp_table, (rows[:, None], fp.bidx), fp.taken,
                           "set", mask=winner)

    def msum(mask, val=1):
        v = torch.as_tensor(val, device=dev)
        v = torch.broadcast_to(v, (TL, F)) if v.ndim < 2 else v
        return torch.sum(torch.where(mask & commit, v.to(torch.int64), 0),
                         dim=1)

    arg2 = fi.meta[2]
    zero = torch.zeros(TL, dtype=torch.int64, device=dev)
    ctr_inc = torch.stack([
        msum(fp.is_comp, fp.icount_ev)
        + msum((is_mem & ((arg2 & 0xFF) == 0)) | fp.is_br),  # icount
        msum(fp.is_comp, fp.icount_ev) + msum(fp.is_br),     # l1i_access
        zero,                                                # l1i_miss
        msum(fp.is_rd),                                      # l1d_read
        zero,                                                # l1d_read_miss
        msum(fp.is_wr),                                      # l1d_write
        zero,                                                # l1d_write_miss
        zero,                                                # l2_access
        zero,                                                # l2_miss
        msum(fp.is_br),                                      # branches
        msum(fp.is_br & ~fp.correct),                        # mispredicts
        zero,                                                # spawns
    ])
    return FFOut(clock=clock, n_ret=n_ret, bp_table=bp_table,
                 l1i_word=l1i.word, l1d_word=l1d.word, ctr_inc=ctr_inc)


class _FFArgs(ctypes.Structure):
    """Mirror of ``struct FFArgs`` in csrc/fast_forward_walk.cu: pointers,
    then int64 scalars only, so the layout has no padding."""

    _fields_ = [(n, ctypes.c_void_p) for n in (
        "meta", "addr", "valid_ev", "tile_active", "clock", "period_ps",
        "boundary", "models_enabled", "stamp_base", "bp", "l1i", "l1d",
        "clock_out", "n_ret", "ctr_inc")] + [(n, ctypes.c_int64) for n in (
        "T", "F", "NM", "K", "l1i_assoc", "l1i_sets", "l1d_assoc",
        "l1d_sets", "bp_size", "line_bits", "l1i_cycles", "l1d_cycles",
        "bp_penalty", "col_core", "col_l1i", "col_l1d", "wbound_add",
        "span_add")]


def _check_ff_inputs(params: SimParams, fi: FFIn) -> None:
    """Device, dtype, shape and contiguity of every operand, and no
    storage shared with a leaf the walk updates in place."""
    dev = fi.clock.device
    T, F = fi.addr.shape
    if F > MAX_WINDOW:
        raise ValueError(f"fast_forward_walk: F = {F} > {MAX_WINDOW}")
    i32, i64, b = torch.int32, torch.int64, torch.bool
    shapes = dict(
        meta=(i32, (3, T, F)), addr=(i64, (T, F)), valid_ev=(b, (T, F)),
        tile_active=(b, (T,)), clock=(i64, (T,)),
        period_ps=(i32, (T, fi.period_ps.shape[1])),
        bp_table=(b, (T, fi.bp_table.shape[1])),
        l1i_word=(i64, (params.l1i.associativity, T, params.l1i.num_sets)),
        l1d_word=(i64, (params.l1d.associativity, T, params.l1d.num_sets)),
        boundary=(i64, ()), models_enabled=(b, ()), stamp_base=(i32, ()))
    for name in FFIn._fields:
        dt, shape = shapes[name]
        t = getattr(fi, name)
        if t.device != dev or t.dtype != dt or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(
                f"fast_forward_walk: {name} is {t.dtype}{tuple(t.shape)} on "
                f"{t.device} (contiguous: {t.is_contiguous()}), not "
                f"{dt}{shape} on {dev}, contiguous")
    dispatch.check_no_alias("fast_forward_walk", fi, FF_INPLACE_FIELDS)


def _ff_alloc_out(fi: FFIn) -> FFOut:
    """Outputs: the operands the kernel updates in place
    (FF_INPLACE_FIELDS: the predictor table and both L1 word arrays) and
    fresh tensors for the rest."""
    T = fi.addr.shape[0]
    dev = fi.clock.device
    return FFOut(
        clock=torch.empty(T, dtype=torch.int64, device=dev),
        n_ret=torch.empty(T, dtype=torch.int32, device=dev),
        ctr_inc=torch.empty((len(WINDOW_CTRS), T), dtype=torch.int64,
                            device=dev),
        **{f: getattr(fi, f) for f in FF_INPLACE_FIELDS})


def _ff_args(params: SimParams, vp: VariantParams, fi: FFIn,
             out: FFOut) -> _FFArgs:
    """Pack pointers and scalars into the kernel's argument struct."""
    T, F = fi.addr.shape
    wbound_add = int(_spanned_bound(params, vp, 0))
    return _FFArgs(
        meta=fi.meta.data_ptr(), addr=fi.addr.data_ptr(),
        valid_ev=fi.valid_ev.data_ptr(),
        tile_active=fi.tile_active.data_ptr(), clock=fi.clock.data_ptr(),
        period_ps=fi.period_ps.data_ptr(), boundary=fi.boundary.data_ptr(),
        models_enabled=fi.models_enabled.data_ptr(),
        stamp_base=fi.stamp_base.data_ptr(), bp=fi.bp_table.data_ptr(),
        l1i=fi.l1i_word.data_ptr(), l1d=fi.l1d_word.data_ptr(),
        clock_out=out.clock.data_ptr(), n_ret=out.n_ret.data_ptr(),
        ctr_inc=out.ctr_inc.data_ptr(),
        T=T, F=F, NM=fi.period_ps.shape[1], K=params.block_events,
        l1i_assoc=params.l1i.associativity, l1i_sets=params.l1i.num_sets,
        l1d_assoc=params.l1d.associativity, l1d_sets=params.l1d.num_sets,
        bp_size=0 if params.core.bp_type == "none" else fi.bp_table.shape[1],
        line_bits=params.line_size.bit_length() - 1,
        l1i_cycles=vp.l1i_access_cycles, l1d_cycles=vp.l1d_access_cycles,
        bp_penalty=vp.bp_mispredict_penalty,
        col_core=int(DVFSModule.CORE), col_l1i=int(DVFSModule.L1_ICACHE),
        col_l1d=int(DVFSModule.L1_DCACHE), wbound_add=wbound_add,
        span_add=int(_ff_bound(params, vp, 0)) - wbound_add)


def fast_forward_walk_cuda(params: SimParams, vp: VariantParams,
                           fi: FFIn) -> FFOut:
    """Launch csrc/fast_forward_walk.cu on CUDA tensors.  In place: the
    kernel updates the operands' predictor table and L1I / L1D word
    arrays (an engaged tile's touched words and written slots), and the
    returned FFOut holds those operand tensors (FF_INPLACE_FIELDS); its
    other leaves are fresh.  A caller that needs the operands unchanged
    clones them first."""
    check_ff_config(params)
    if fi.clock.device.type != "cuda":
        raise ValueError("fast_forward_walk_cuda takes CUDA tensors")
    _check_ff_inputs(params, fi)
    from graphite_tpu_torch.engine.kernels import build
    lib = build.load("fast_forward_walk")
    out = _ff_alloc_out(fi)
    a = _ff_args(params, vp, fi, out)
    stream = torch.cuda.current_stream(fi.clock.device).cuda_stream
    err = lib.fast_forward_walk_launch(ctypes.addressof(a), stream)
    if err != 0:
        raise RuntimeError(
            f"fast_forward_walk kernel launch failed: CUDA error {err} "
            f"({build.error_string(lib, err)})")
    dispatch.COUNTS["fast_forward_walk"] += 1
    return out


def run_fast_forward(params: SimParams, vp: VariantParams,
                     fi: FFIn) -> FFOut:
    """The fast-forward walk, dispatched by device: the CUDA kernel for
    CUDA tensors, the plain PyTorch form for CPU tensors."""
    if dispatch.use_kernel(fi.clock):
        return fast_forward_walk_cuda(params, vp, fi)
    return fast_forward_walk(params, vp, fi)
