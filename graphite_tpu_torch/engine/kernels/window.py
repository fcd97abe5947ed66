"""The block-window walk: its plain PyTorch form and its CUDA kernel.

``window_walk`` is engine/core._block_retire's hot loop — tag probes
against every cache level, hit/stall/hazard classification over the
[T, K] window, within-window branch-predictor read-after-write, the
max-plus clock prefix, LRU touches and fills, and counter accumulation.
It is the counterpart of ``graphite_tpu/engine/kernels/window.py:163``,
transliterated for this slice's configuration: simple in-order cores,
private L1/L2 under MSI, no miss chains (``tpu/miss_chain = 0``).

Two forms compute the same function:

  * :func:`window_walk` — plain PyTorch, vectorised over the window with
    the JAX package's [T, K, K] masks.  The CPU tests hold it against the
    JAX walk leaf for leaf.
  * ``csrc/window_walk.cu`` — a CUDA kernel for ``sm_90a`` that walks
    each tile's K events in order, one thread per tile.

:func:`run_window` picks between them by the tensors' device: CPU
tensors take the plain form, CUDA tensors launch the kernel (or raise —
there is no fallback on the card).  ``run_window.launches`` counts kernel
launches, so a run can show that its path went through the kernel.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from graphite_tpu_torch.engine import cache as cachemod
from graphite_tpu_torch.engine import noc
from graphite_tpu_torch.engine.kernels import dispatch
from graphite_tpu_torch.engine.ops import first_true, scatter
from graphite_tpu_torch.engine.vparams import VariantParams
from graphite_tpu_torch.events.schema import ICACHE_BYTES_PER_INSTRUCTION
from graphite_tpu_torch.isa import DVFSModule, EventOp
from graphite_tpu_torch.params import SimParams

I, S, E, M = cachemod.I, cachemod.S, cachemod.E, cachemod.M

# The kernel keeps each tile's per-event set indices in fixed local
# arrays; block_events is validated <= STAMP_STRIDE - 2 = 62 anyway.
MAX_WINDOW = 64


def _lat(cycles, period_ps):
    """cycles (int/tensor) at an integer ps clock period -> int64 ps."""
    return torch.as_tensor(cycles).to(torch.int64) \
        * torch.as_tensor(period_ps).to(torch.int64)


class WindowIn(NamedTuple):
    """Window-walk operands (the JAX WindowIn's fields that exist at
    P = 0 with private L2 and simple cores)."""

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


def check_window_config(params: SimParams) -> None:
    """The walk's scope in this slice; anything else is a later slice."""
    if params.core.model != "simple":
        raise NotImplementedError(
            "the window walk for iocoom cores is ported in a later slice")
    if params.miss_chain > 0:
        raise NotImplementedError(
            "miss chains (tpu/miss_chain > 0) are ported in slice 2")
    if params.shared_l2:
        raise NotImplementedError(
            "shared-L2 protocols are ported in a later slice")
    if params.block_events > MAX_WINDOW:
        raise NotImplementedError(
            f"block_events > {MAX_WINDOW} is not supported by the kernel")


def window_walk(params: SimParams, vp: VariantParams, wi: WindowIn,
                s_ids: int) -> WindowOut:
    """Classify + retire one [T, K] window — the plain PyTorch form, a
    transliteration of the JAX walk at P = 0, private L2, simple cores
    (see graphite_tpu/engine/kernels/window.py for the semantics
    commentary).  Pure: reads only ``wi``, returns every effect."""
    check_window_config(params)
    K = wi.addr.shape[1]
    TL = wi.clock.shape[0]
    dev = wi.clock.device
    line_bits = params.line_size.bit_length() - 1
    rows = torch.arange(TL, device=dev)

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

    ar = torch.arange(K, device=dev)
    earlier = ar[None, :, None] > ar[None, None, :]           # [1, Kj, Ki]

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
    hazard = haz_d | haz_i

    base_ok = valid_ev & ~hazard & en
    ok_rel = (comp_simple | mem_simple | is_br) & base_ok
    ok_abs = (is_stall | is_sync | is_spawn) & base_ok
    ok = ok_rel | ok_abs

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

    # ---- max-plus prefix
    clk = wi.clock
    n_ret = torch.zeros(TL, dtype=torch.int32, device=dev)
    run = wi.tile_active
    clks = []
    for j in range(K):
        clks.append(clk)                     # clock BEFORE event j
        okj = ok_rel[:, j] | ok_abs[:, j]
        in_b = clk < wi.boundary
        can = run & okj & in_b
        clk = torch.where(can, torch.maximum(clk, floor[:, j]) + dt[:, j],
                          clk)
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
        msum(is_comp & ~pI.hit, n_lines),                    # l1i_miss
        msum(is_rd),                                         # l1d_read
        msum(is_rd & ~l1_ok),                                # l1d_read_miss
        msum(is_wr),                                         # l1d_write
        msum(is_wr & ~l1_ok),                                # l1d_write_miss
        msum(mem_l2 | comp_l2),                              # l2_access
        zero,                                                # l2_miss
        msum(is_br),                                         # branches
        msum(is_br & ~correct),                              # mispredicts
        msum(is_spawn),                                      # spawns
    ])

    return WindowOut(
        clock=clk, n_ret=n_ret, bp_table=bp_table,
        l1i_word=l1i.word, l1i_rr=l1i.rr_ptr,
        l1d_word=l1d.word, l1d_rr=l1d.rr_ptr,
        l2_word=l2.word, l2_rr=l2.rr_ptr,
        ctr_inc=ctr_inc,
        spawn_mask=spawn_mask, spawn_child=child.to(torch.int32),
        spawn_land=spawn_land,
    )


# ------------------------------------------------------- the CUDA kernel

class _WalkArgs(ctypes.Structure):
    """Mirror of ``struct WalkArgs`` in csrc/window_walk.cu: pointers,
    then int64 scalars only, so the layout has no padding."""

    _fields_ = [(n, ctypes.c_void_p) for n in (
        "meta", "addr", "valid_ev", "tile_active", "tile_ids", "clock",
        "period_ps", "bp_in", "l1i_in", "l1i_rr_in", "l1d_in", "l1d_rr_in",
        "l2_in", "boundary", "models_enabled", "stamp_base",
        "clock_out", "n_ret", "bp_out", "l1i_out", "l1i_rr_out", "l1d_out",
        "l1d_rr_out", "l2_out", "ctr_inc", "spawn_mask", "spawn_child",
        "spawn_land")] + [(n, ctypes.c_int64) for n in (
        "T", "K", "NM", "l1i_assoc", "l1i_sets", "l1i_round_robin",
        "l1d_assoc", "l1d_sets", "l1d_round_robin", "l2_assoc", "l2_sets",
        "bp_size", "line_bits", "line_size", "l1i_cycles", "l1d_cycles",
        "l2_cycles", "bp_penalty", "col_core", "col_l1i", "col_l1d",
        "col_l2", "col_nu", "s_ids", "num_tiles", "mesh_width", "nu_magic",
        "nu_hop_cycles", "nu_ser_cycles")]


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
    """Device, dtype, shape and contiguity of every operand."""
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


def _alloc_out(params: SimParams, wi: WindowIn) -> WindowOut:
    """Outputs: fresh tensors, and clones of the arrays the kernel
    updates in place (caches, predictor table, and the L1 round-robin
    pointers under round_robin replacement).  The other pointers, L2's
    always, pass through untouched, as in the plain form."""
    dev = wi.clock.device
    T, K = wi.addr.shape
    i32, i64, b = torch.int32, torch.int64, torch.bool

    def rr(cp, t):
        return t.clone() if cp.replacement == "round_robin" else t

    return WindowOut(
        clock=torch.empty(T, dtype=i64, device=dev),
        n_ret=torch.empty(T, dtype=i32, device=dev),
        bp_table=wi.bp_table.clone(),
        l1i_word=wi.l1i_word.clone(), l1i_rr=rr(params.l1i, wi.l1i_rr),
        l1d_word=wi.l1d_word.clone(), l1d_rr=rr(params.l1d, wi.l1d_rr),
        l2_word=wi.l2_word.clone(), l2_rr=wi.l2_rr,
        ctr_inc=torch.empty((len(WINDOW_CTRS), T), dtype=i64, device=dev),
        spawn_mask=torch.empty((T, K), dtype=b, device=dev),
        spawn_child=torch.empty((T, K), dtype=i32, device=dev),
        spawn_land=torch.empty((T, K), dtype=i64, device=dev),
    )


def _walk_args(params: SimParams, vp: VariantParams, wi: WindowIn,
               s_ids: int, out: WindowOut) -> _WalkArgs:
    """Pack pointers and scalars into the kernel's argument struct."""
    T, K = wi.addr.shape
    nu = params.net_user
    noc._zero_load_only(nu)
    flits = noc.num_flits(8, vp.net_user.flit_width_bits)
    return _WalkArgs(
        meta=wi.meta.data_ptr(), addr=wi.addr.data_ptr(),
        valid_ev=wi.valid_ev.data_ptr(),
        tile_active=wi.tile_active.data_ptr(),
        tile_ids=wi.tile_ids.data_ptr(), clock=wi.clock.data_ptr(),
        period_ps=wi.period_ps.data_ptr(), bp_in=wi.bp_table.data_ptr(),
        l1i_in=wi.l1i_word.data_ptr(), l1i_rr_in=wi.l1i_rr.data_ptr(),
        l1d_in=wi.l1d_word.data_ptr(), l1d_rr_in=wi.l1d_rr.data_ptr(),
        l2_in=wi.l2_word.data_ptr(), boundary=wi.boundary.data_ptr(),
        models_enabled=wi.models_enabled.data_ptr(),
        stamp_base=wi.stamp_base.data_ptr(),
        clock_out=out.clock.data_ptr(), n_ret=out.n_ret.data_ptr(),
        bp_out=out.bp_table.data_ptr(), l1i_out=out.l1i_word.data_ptr(),
        l1i_rr_out=out.l1i_rr.data_ptr(), l1d_out=out.l1d_word.data_ptr(),
        l1d_rr_out=out.l1d_rr.data_ptr(), l2_out=out.l2_word.data_ptr(),
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
    """Launch csrc/window_walk.cu on CUDA tensors.  Out of place: the
    cache and predictor arrays (and round-robin pointers the walk moves)
    are cloned and the kernel updates the clones' touched rows."""
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
    run_window.launches += 1
    return out


def run_window(params: SimParams, vp: VariantParams, wi: WindowIn,
               s_ids: int) -> WindowOut:
    """The walk, dispatched by device: the CUDA kernel for CUDA tensors,
    the plain PyTorch form for CPU tensors."""
    if dispatch.use_kernel(wi.clock):
        return window_walk_cuda(params, vp, wi, s_ids)
    return window_walk(params, vp, wi, s_ids)


run_window.launches = 0


# ------------------------------------------------------ test operands

def random_window_arrays(params: SimParams, K: int, seed: int) -> dict:
    """Random walk operands as numpy arrays (field name -> array), for
    holding the kernel, the plain form and the JAX walk against each
    other.  Cache words are valid packed words whose tags come from the
    same small line pool as the window's addresses, so probes hit, miss,
    alias sets and collide on predictor slots; every event kind the walk
    classifies appears."""
    import numpy as np
    rng = np.random.default_rng(seed)
    T = params.num_tiles
    lb = params.line_size.bit_length() - 1
    pool = rng.integers(0, 1 << 20, size=max(8, K * 2)) \
        * rng.choice([1, params.l1d.num_sets, params.l2.num_sets],
                     size=max(8, K * 2))
    pool = pool % (1 << 30)
    ops = np.array([int(EventOp.COMPUTE), int(EventOp.MEM_READ),
                    int(EventOp.MEM_WRITE), int(EventOp.BRANCH),
                    int(EventOp.STALL), int(EventOp.SYNC),
                    int(EventOp.SPAWN), int(EventOp.BARRIER_WAIT),
                    int(EventOp.NOP)])
    opw = np.array([30, 25, 15, 12, 3, 3, 3, 2, 2], dtype=np.float64)
    op = rng.choice(ops, size=(T, K), p=opw / opw.sum()).astype(np.int32)
    line = rng.choice(pool, size=(T, K))
    addr = (line << lb) + rng.integers(0, params.line_size, size=(T, K))
    clock = rng.integers(0, 5_000_000, size=T).astype(np.int64)
    is_time = (op == int(EventOp.STALL)) | (op == int(EventOp.SYNC))
    addr = np.where(is_time, clock[:, None]
                    + rng.integers(-20_000, 200_000, size=(T, K)), addr)
    arg = np.where(op == int(EventOp.BRANCH), rng.integers(0, 2, (T, K)),
                   rng.integers(-2, 40, (T, K))).astype(np.int32)
    arg2 = np.where(op == int(EventOp.COMPUTE),
                    rng.integers(0, 200, (T, K)),
                    np.where(rng.random((T, K)) < 0.8, 0,
                             rng.integers(-3, 3 * T, (T, K)))
                    ).astype(np.int32)

    def words(cp, A, S):
        tags = rng.choice(pool, size=(A, T, S)) % (1 << 31)
        stamps = rng.integers(0, 1 << 29, size=(A, T, S))
        st = rng.choice([0, 1, 1, 4, 4, 3, 2], size=(A, T, S))
        return ((tags.astype(np.int64) << 32) | (stamps << 3) | st
                ).astype(np.int64)

    def place(w, S):
        # Plant the window's lines in their sets so probes hit.
        A = w.shape[0]
        for t in range(T):
            for j in range(K):
                if rng.random() < 0.5:
                    ln = int(line[t, j])
                    w[rng.integers(0, A), t, ln % S] = \
                        (ln << 32) | (int(rng.integers(0, 1 << 29)) << 3) \
                        | int(rng.choice([1, 4, 4]))
        return w

    A1, S1 = params.l1i.associativity, params.l1i.num_sets
    Ad, Sd = params.l1d.associativity, params.l1d.num_sets
    A2, S2 = params.l2.associativity, params.l2.num_sets
    nm = len(DVFSModule)
    return dict(
        meta=np.stack([op, arg, arg2]).astype(np.int32),
        addr=addr.astype(np.int64),
        valid_ev=rng.random((T, K)) < 0.95,
        tile_active=rng.random(T) < 0.9,
        tile_ids=np.arange(T, dtype=np.int32),
        clock=clock,
        period_ps=rng.integers(250, 1200, size=(T, nm)).astype(np.int32),
        bp_table=rng.random((T, params.core.bp_size)) < 0.5,
        l1i_word=place(words(params.l1i, A1, S1), S1),
        l1i_rr=rng.integers(0, A1, size=(T, S1)).astype(np.int32),
        l1d_word=place(words(params.l1d, Ad, Sd), Sd),
        l1d_rr=rng.integers(0, Ad, size=(T, Sd)).astype(np.int32),
        l2_word=place(words(params.l2, A2, S2), S2),
        l2_rr=rng.integers(0, A2, size=(T, S2)).astype(np.int32),
        boundary=np.int64(5_000_000 + int(rng.integers(0, 3_000_000))),
        models_enabled=np.bool_(rng.random() < 0.9),
        stamp_base=np.int32(64 * int(rng.integers(0, 100_000))),
    )


def window_in_from_numpy(arrays: dict, device) -> WindowIn:
    """A :class:`WindowIn` on ``device`` from numpy operands."""
    import numpy as np
    dev = torch.device(device)
    return WindowIn(**{
        f: torch.from_numpy(np.array(arrays[f])).to(dev)
        for f in WindowIn._fields})
