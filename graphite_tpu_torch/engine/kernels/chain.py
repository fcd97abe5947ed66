"""One chain-replay iteration's classify step: its plain PyTorch form and
its CUDA kernel.

``chain_classify`` is the sub-chain that every iteration of
``resolve.chain_fast_pass`` runs for every tile's current chain head:
the directory probe and victim way, the (home, dset, way) FCFS election,
the fan-out and owner delivery budgets, shared-read combining over a
hash table of size H, the MSI transition, the zero-load NoC and DRAM
timing legs and, with the DRAM queue model off, the completion time and
the per-line floor write.  It is the counterpart of
``graphite_tpu/engine/kernels/chain.py:134``, transliterated for this
slice's configuration: simple cores, private L1/L2 under MSI, a
full-map directory, zero-load networks.

Two forms compute the same function:

  * :func:`chain_classify` — plain PyTorch, with the JAX package's
    [T, T] rank masks and H-slot scatter tables.  The CPU tests hold it
    against the JAX function field for field.
  * ``csrc/chain_classify.cu`` — a CUDA kernel for ``sm_90a``: one block,
    one thread per tile, the H-sized tables in shared memory.

:func:`run_chain` picks between them by the tensors' device, like
``window.run_window``; the wrapper counts its launches in
``dispatch.COUNTS``.

What stays outside, in ``resolve.chain_fast_pass``: the chain-head and
directory-row gathers, the DRAM queue probe (its ring is loop-carried)
and the apply scatters.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from graphite_tpu_torch.engine import cache as cachemod
from graphite_tpu_torch.engine import dense
from graphite_tpu_torch.engine import directory as dirmod
from graphite_tpu_torch.engine import noc
from graphite_tpu_torch.engine.kernels import dispatch
from graphite_tpu_torch.engine.ops import first_true, scatter, umod64
from graphite_tpu_torch.engine.state import (dword_owner, dword_stamp,
                                             dword_state, dword_tag)
from graphite_tpu_torch.engine.vparams import VariantParams
from graphite_tpu_torch.params import SimParams

I, S, O, E, M = (cachemod.I, cachemod.S, cachemod.O, cachemod.E,
                 cachemod.M)

# Control-message payload bytes (request/inv/ack packets).
CTRL_BYTES = 8

# Per-target budget of point-to-point owner flush/downgrade deliveries
# per conflict round / replay iteration.
J_OWN = 8


def _lat(cycles, period_ps):
    return torch.as_tensor(cycles).to(torch.int64) \
        * torch.as_tensor(period_ps).to(torch.int64)


class ChainIn(NamedTuple):
    """One replay iteration's classify operands (all [T] unless noted)."""

    active: torch.Tensor      # bool
    is_ex: torch.Tensor       # bool
    is_if: torch.Tensor       # bool
    line: torch.Tensor        # int64
    issue: torch.Tensor       # int64
    extra: torch.Tensor       # int64 (local cost owed at completion)
    home: torch.Tensor        # int32
    dset: torch.Tensor        # int32
    fidx: torch.Tensor        # int32 flat (home * ndsets + dset)
    hidx: torch.Tensor        # int32 hash slot of the line
    drow: torch.Tensor        # [T, A] int64 gathered directory words
    dsharers: torch.Tensor    # [T, A, W] int64 (uint64 bits) sharer words
    p_net: torch.Tensor       # int32 periods
    p_dir: torch.Tensor
    p_l2: torch.Tensor
    p_l1d: torch.Tensor
    p_l1i: torch.Tensor
    p_core: torch.Tensor
    ftbl: Optional[torch.Tensor]  # [2, H] int64 — present iff the
    #   classify owns the floor write (DRAM queue model off)


class ChainOut(NamedTuple):
    way: torch.Tensor            # [T] int32 (post-combining)
    hit: torch.Tensor            # bool — directory-entry hit
    serve: torch.Tensor          # bool — election winners
    serve_all: torch.Tensor      # bool — winners + combining members
    member: torch.Tensor         # bool
    member_add: torch.Tensor     # bool — member bit-add guard
    hard_stop: torch.Tensor      # bool — chain demotes to the round loop
    fan_go: torch.Tensor         # bool — in-pass fan-out serves
    owner_leg: torch.Tensor      # bool — served owner flush/downgrade
    evicting: torch.Tensor       # bool
    owner: torch.Tensor          # [T] int32 owner tile
    ow_slot: torch.Tensor        # [T] int32 min(posr, J_OWN - 1)
    down_to: torch.Tensor        # [T] int32 owner downgrade state
    new_state: torch.Tensor      # [T] int32 directory entry after
    new_owner: torch.Tensor      # [T] int32
    delta_sh: torch.Tensor       # [T, W] int64 sharer-bitmap delta
    dram_read: torch.Tensor      # bool — act.dram_read (pre-serve mask)
    dram_write: torch.Tensor     # bool — act.dram_write
    need_read: torch.Tensor      # bool — serve_all & dram_read
    dram_wb: torch.Tensor        # bool — dram_write & serve_all
    t_dir: torch.Tensor          # [T] int64
    owner_ps: torch.Tensor       # [T] int64
    inv_ps: torch.Tensor         # [T] int64 (zeros with fanout off)
    reply_ps: torch.Tensor       # [T] int64
    from_dram_ps: torch.Tensor   # [T] int64
    dram_arrival: torch.Tensor   # [T] int64
    l1_fill_ps: torch.Tensor     # [T] int64
    inv_bool: Optional[torch.Tensor]   # [KF, T] bool (fanout only)
    line_fr: Optional[torch.Tensor]    # [KF] int64 (fanout only)
    inv_count: torch.Tensor      # [T] int64
    completion: Optional[torch.Tensor]  # [T] int64 (queue off only)
    t_data: Optional[torch.Tensor]      # [T] int64 (queue off only)
    ftbl: Optional[torch.Tensor]        # [2, H] int64 (queue off only)


def check_chain_config(params: SimParams) -> None:
    """The classify step's scope in this slice."""
    if params.shared_l2:
        raise NotImplementedError(
            "the chain classify under shared-L2 protocols is ported in a "
            "later slice (model breadth)")
    if params.protocol_kind != "msi":
        raise NotImplementedError(
            f"the chain classify under {params.protocol!r} is ported in a "
            f"later slice (model breadth)")


def chain_classify(params: SimParams, vp: VariantParams, ci: ChainIn,
                   H: int) -> ChainOut:
    """One replay iteration's classification — the plain PyTorch form, a
    transliteration of the JAX function (see
    graphite_tpu/engine/kernels/chain.py and resolve.chain_fast_pass for
    the semantics commentary)."""
    check_chain_config(params)
    T = params.num_tiles
    A = params.directory.associativity
    W = ci.dsharers.shape[2]
    ndsets = params.directory.num_sets
    dev = ci.line.device
    rows = torch.arange(T, device=dev)
    fanout = params.fanout_replay
    KF = min(params.max_inv_fanout_per_round, T)

    active, is_ex, is_if = ci.active, ci.is_ex, ci.is_if
    line, issue = ci.line, ci.issue
    home, dset, fidx, hidx = ci.home, ci.dset, ci.fidx, ci.hidx
    home64 = home.to(torch.int64)
    p_net, p_dir = ci.p_net, ci.p_dir
    ack_ps = _lat(vp.inv_ack_cycles, ci.p_core)

    # ---- directory probe at (home, dset) — post-predecessor state
    drow = ci.drow                                        # [T, A]
    dstate = dword_state(drow)
    dstamp = dword_stamp(drow)
    match = (dword_tag(drow) == line[:, None].to(torch.int32)) \
        & (dstate != I)
    hit = match.any(dim=1) & active
    hway = first_true(match, 1)
    invalid = dstate == I

    # ---- victim way for allocs: invalid first, then stamp-LRU, ways
    # held by this slot's hit elements excluded
    fhash = umod64(dense.fmix64(fidx.to(torch.int64)), H)
    used_tbl = scatter(torch.zeros((H, A), dtype=torch.bool, device=dev),
                       (fhash, hway), True, "set", mask=hit)
    hway_used = used_tbl[fhash]                            # [T, A]
    NEVER = 2**31 - 1
    vkey = torch.where(hway_used, NEVER,
                       torch.where(invalid, -1, dstamp)).to(torch.int32)
    miss_way = torch.argmin(vkey, dim=1)
    can_alloc = active & ~hit & (torch.gather(
        vkey, 1, miss_way[:, None])[:, 0] != NEVER)
    way = torch.where(hit, hway, miss_way)                 # int64

    # ---- way-slot election
    am = (home64 * ndsets + dset) * A + way
    aidx = umod64(dense.fmix64(am), H)
    packed = dense.fcfs_keys(active, issue)
    wslot = dense.elect(active, packed, aidx, H)

    # ---- transition against the replayed entry
    way_word = torch.gather(drow, 1, way[:, None])[:, 0]
    way_state = dword_state(way_word)
    way_owner = dword_owner(way_word)
    dsharers = ci.dsharers                                # [T, A, W]
    entry_row = torch.gather(
        dsharers, 1, way[:, None, None].expand(T, 1, W))[:, 0, :]
    entry_state = torch.where(hit, way_state, I).to(torch.int32)
    entry_owner = torch.where(hit, way_owner, -1).to(torch.int32)
    entry_sharers = torch.where(hit[:, None], entry_row, 0)
    act = dirmod.transition(params.protocol_kind, is_ex, rows,
                            entry_state, entry_owner, entry_sharers,
                            W, is_ifetch=is_if)
    has_inv = (act.inv_targets != 0).any(dim=1)
    vic_dead = (way_state == I) \
        | (((way_state == S) | (way_state == O))
           & (entry_row == 0).all(dim=1))
    cand0 = active & wslot & (hit | (can_alloc & vic_dead))
    if fanout:
        need_fan = cand0 & has_inv
        fan_rank = torch.sum(
            (packed[None, :] < packed[:, None]) & need_fan[None, :]
            & need_fan[:, None], dim=1, dtype=torch.int32)
        fan_sel = need_fan & (fan_rank < KF)
        cand = cand0 & (~has_inv | fan_sel)
    else:
        fan_rank = torch.zeros(T, dtype=torch.int32, device=dev)
        cand = cand0 & ~has_inv
    owner = act.owner_tile
    posr = dense.grouped_rank(owner, packed, cand & act.owner_leg)
    serve = cand & ~(act.owner_leg & (posr >= J_OWN))
    owner_leg = act.owner_leg & serve
    fan_go = serve & has_inv          # in-pass fan-out serves
    evicting = serve & ~hit & (way_state != I)

    # ---- SH combining within the slot.  Two served representatives of
    # DIFFERENT lines can share a hash slot; the JAX package's CPU
    # scatter applies updates in row order, so the LAST such row's line
    # and way survive — a scatter-max of row indices picks that row.
    sh_ok_e = (entry_state == I) | (entry_state == S)
    hidx64 = hidx.to(torch.int64)
    ex_any_t = scatter(torch.zeros(H, dtype=torch.bool, device=dev),
                       hidx64, True, "set", mask=active & is_ex)
    rep_sh = serve & ~is_ex & sh_ok_e
    rep_row = scatter(torch.full((H,), -1, dtype=torch.int64, device=dev),
                      hidx64, rows, "max", mask=rep_sh)
    r = rep_row[hidx64]
    rc = torch.clamp(r, min=0)
    rep_line = torch.where(r >= 0, line[rc], -1)
    rep_way = torch.where(r >= 0, way[rc], 0)
    member = active & ~serve & ~is_ex & sh_ok_e & ~ex_any_t[hidx64] \
        & (rep_line == line)
    way = torch.where(member, rep_way, way)
    serve_all = serve | member
    stop_inv = has_inv if not fanout else torch.zeros_like(has_inv)
    hard_stop = active & ~serve_all \
        & (stop_inv | (can_alloc & ~vic_dead) | (~hit & ~can_alloc)
           | (act.owner_leg & (posr >= J_OWN)))

    # ---- timing: the round loop's zero-load path for a fast element
    net_req = noc.unicast_ps(params.net_memory, rows, home,
                             CTRL_BYTES, p_net, params.mesh_width,
                             vnet=vp.net_memory)
    p_net_home = p_net[home64]
    reply_ps = noc.unicast_ps(params.net_memory, home, rows,
                              params.line_size + CTRL_BYTES,
                              p_net_home, params.mesh_width,
                              vnet=vp.net_memory)
    dir_ps = _lat(vp.dir_access_cycles, p_dir[home64])
    arrive = issue + net_req
    t_dir = arrive + dir_ps
    owner64 = owner.to(torch.int64)
    p_net_own = p_net[owner64]
    l2_own_ps = _lat(vp.l2_access_cycles, ci.p_l2[owner64])
    leg_ps = noc.unicast_ps(params.net_memory, home, owner,
                            CTRL_BYTES, p_net_home,
                            params.mesh_width, vnet=vp.net_memory) \
        + l2_own_ps \
        + noc.unicast_ps(params.net_memory, owner, home,
                         params.line_size + CTRL_BYTES, p_net_own,
                         params.mesh_width, vnet=vp.net_memory)
    owner_ps = torch.where(owner_leg, leg_ps, 0)
    if fanout:
        oh_fr = fan_go[None, :] & (
            torch.arange(KF, dtype=torch.int32, device=dev)[:, None]
            == torch.clamp(fan_rank, max=KF - 1)[None, :])

        def fr_sel(vals):
            return torch.sum(torch.where(oh_fr, vals[None, :], 0), dim=1,
                             dtype=vals.dtype)

        inv_words = torch.sum(
            torch.where(oh_fr[:, :, None], act.inv_targets[None, :, :], 0),
            dim=1, dtype=torch.int64)
        inv_bool = dirmod.bitmap_to_bool(inv_words, T)      # [KF, T]
        home_fr = fr_sel(home)
        pnh_fr = fr_sel(p_net_home.to(torch.int64)).to(torch.int32)
        inv_ps_k = 2 * noc.max_hop_to_mask_ps(
            params.net_memory, home_fr, inv_bool, CTRL_BYTES,
            pnh_fr, params.mesh_width, vnet=vp.net_memory) \
            + fr_sel(ack_ps)
        inv_ps = torch.where(fan_go, torch.sum(
            torch.where(oh_fr, inv_ps_k[:, None], 0), dim=0), 0)
        line_fr = fr_sel(line)
        kcnt = torch.sum(inv_bool, dim=1).to(torch.int64)   # [KF]
        inv_count = torch.where(fan_go, torch.sum(
            torch.where(oh_fr, kcnt[:, None], 0), dim=0), 0)
    else:
        inv_bool = line_fr = None
        inv_ps = torch.zeros(T, dtype=torch.int64, device=dev)
        inv_count = torch.zeros(T, dtype=torch.int64, device=dev)
    need_read = serve_all & act.dram_read
    from_dram_ps = torch.zeros(T, dtype=torch.int64, device=dev)
    dram_arrival = t_dir + owner_ps
    dram_wb = act.dram_write & serve_all
    l1_fill_ps = torch.where(
        is_if, _lat(vp.l1i_access_cycles, ci.p_l1i),
        _lat(vp.l1d_access_cycles, ci.p_l1d))

    # ---- sharer-bitmap delta + member bit-add guard (apply operands)
    delta_sh = act.new_sharers - entry_row       # wraps like uint64
    req_word = (rows // 64).to(torch.int64)
    req_bit = torch.ones(T, dtype=torch.int64, device=dev) \
        << (rows % 64).to(torch.int64)
    row_f = torch.gather(
        dsharers, 1, way[:, None, None].expand(T, 1, W))[:, 0, :]
    own_w = torch.gather(row_f, 1, req_word[:, None])[:, 0]
    member_add = member & (~hit | ((own_w & req_bit) == 0))

    # ---- queue-model-off tail: completion + the per-line floor write
    if not params.dram.queue_model_enabled:
        dram_start = torch.where(need_read, dram_arrival, 0)
        dram_ready = dram_start + vp.dram_latency_ps \
            + vp.dram_processing_ps + from_dram_ps
        t_data = torch.maximum(t_dir + owner_ps,
                               torch.where(need_read, dram_ready, 0))
        if fanout:
            t_data = torch.maximum(t_data, t_dir + inv_ps)
        reply_done = t_data + reply_ps
        completion = reply_done \
            + _lat(vp.l2_access_cycles, ci.p_l2) + l1_fill_ps + ci.extra
        tkey = t_data * T + rows
        tmax_t = scatter(torch.full((H,), -1, dtype=torch.int64,
                                    device=dev), hidx64, tkey, "max",
                         mask=serve_all)
        fwin = serve_all & (tmax_t[hidx64] == tkey)
        ftbl = dense.stacked_set_table(hidx64, fwin,
                                       torch.stack([line, t_data]), ci.ftbl)
    else:
        completion = t_data = ftbl = None

    return ChainOut(
        way=way.to(torch.int32), hit=hit, serve=serve, serve_all=serve_all,
        member=member, member_add=member_add, hard_stop=hard_stop,
        fan_go=fan_go, owner_leg=owner_leg, evicting=evicting, owner=owner,
        ow_slot=torch.clamp(posr, max=J_OWN - 1).to(torch.int32),
        down_to=act.owner_downgrade_to,
        new_state=act.new_state, new_owner=act.new_owner,
        delta_sh=delta_sh, dram_read=act.dram_read,
        dram_write=act.dram_write, need_read=need_read, dram_wb=dram_wb,
        t_dir=t_dir, owner_ps=owner_ps, inv_ps=inv_ps, reply_ps=reply_ps,
        from_dram_ps=from_dram_ps, dram_arrival=dram_arrival,
        l1_fill_ps=l1_fill_ps, inv_bool=inv_bool, line_fr=line_fr,
        inv_count=inv_count, completion=completion, t_data=t_data,
        ftbl=ftbl,
    )


# ------------------------------------------------------- the CUDA kernel

# Dynamic shared memory one block may use on an H100 (227 KB).
MAX_SMEM_BYTES = 232_448

# Sharer-bitmap words a thread holds in registers (kMaxWords in the .cu):
# one block of one thread per tile serves T <= 512.
MAX_WORDS = 8

_IN_PTRS = ("active", "is_ex", "is_if", "line", "issue", "extra", "home",
            "dset", "fidx", "hidx", "drow", "dsharers", "p_net", "p_dir",
            "p_l2", "p_l1d", "p_l1i", "p_core", "ftbl_in")
_OUT_PTRS = ("way", "hit", "serve", "serve_all", "member", "member_add",
             "hard_stop", "fan_go", "owner_leg", "evicting", "owner",
             "ow_slot", "down_to", "new_state", "new_owner", "delta_sh",
             "dram_read", "dram_write", "need_read", "dram_wb", "t_dir",
             "owner_ps", "inv_ps", "reply_ps", "from_dram_ps",
             "dram_arrival", "l1_fill_ps", "inv_bool", "line_fr",
             "inv_count", "completion", "t_data", "ftbl_out")
_SCALARS = ("T", "A", "W", "H", "KF", "fanout", "queue_on", "ndsets",
            "mesh_width", "net_magic", "hop_cycles", "ser_req", "ser_data",
            "inv_ack_cycles", "dir_cycles", "l2_cycles", "l1d_cycles",
            "l1i_cycles", "dram_latency_ps", "dram_processing_ps")


class _ChainArgs(ctypes.Structure):
    """Mirror of ``struct ChainArgs`` in csrc/chain_classify.cu: pointers,
    then int64 scalars only, so the layout has no padding."""

    _fields_ = [(n, ctypes.c_void_p) for n in _IN_PTRS + _OUT_PTRS] \
        + [(n, ctypes.c_int64) for n in _SCALARS]


def _check(name, t, dtype, shape, dev):
    if t.device != dev:
        raise ValueError(f"chain_classify: {name} is on {t.device}, not {dev}")
    if t.dtype != dtype:
        raise ValueError(f"chain_classify: {name} is {t.dtype}, not {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"chain_classify: {name} has shape "
                         f"{tuple(t.shape)}, not {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"chain_classify: {name} is not contiguous")


def _check_inputs(params: SimParams, ci: ChainIn, H: int) -> None:
    """Device, dtype, shape and contiguity of every operand."""
    dev = ci.line.device
    T = params.num_tiles
    A = params.directory.associativity
    W = ci.dsharers.shape[2]
    i32, i64, b = torch.int32, torch.int64, torch.bool
    for name, t, dt, shape in (
            ("active", ci.active, b, (T,)), ("is_ex", ci.is_ex, b, (T,)),
            ("is_if", ci.is_if, b, (T,)), ("line", ci.line, i64, (T,)),
            ("issue", ci.issue, i64, (T,)), ("extra", ci.extra, i64, (T,)),
            ("home", ci.home, i32, (T,)), ("dset", ci.dset, i32, (T,)),
            ("fidx", ci.fidx, i32, (T,)), ("hidx", ci.hidx, i32, (T,)),
            ("drow", ci.drow, i64, (T, A)),
            ("dsharers", ci.dsharers, i64, (T, A, W)),
            ("p_net", ci.p_net, i32, (T,)), ("p_dir", ci.p_dir, i32, (T,)),
            ("p_l2", ci.p_l2, i32, (T,)), ("p_l1d", ci.p_l1d, i32, (T,)),
            ("p_l1i", ci.p_l1i, i32, (T,)),
            ("p_core", ci.p_core, i32, (T,))):
        _check(name, t, dt, shape, dev)
    queue_on = params.dram.queue_model_enabled
    if queue_on != (ci.ftbl is None):
        raise ValueError("chain_classify: ftbl is given iff the DRAM queue "
                         "model is off")
    if ci.ftbl is not None:
        _check("ftbl", ci.ftbl, i64, (2, H), dev)
    if T > 64 * MAX_WORDS or W > MAX_WORDS or A > 32:
        raise ValueError(
            f"chain_classify: T = {T}, W = {W}, A = {A} exceed the "
            f"kernel's limits (T <= {64 * MAX_WORDS}, at most {MAX_WORDS} "
            f"sharer words per row, A <= 32 ways)")


def _alloc_out(params: SimParams, ci: ChainIn, H: int) -> ChainOut:
    """Fresh output tensors; fields a configuration leaves None stay
    None (the kernel skips them by its flags)."""
    dev = ci.line.device
    T = params.num_tiles
    W = ci.dsharers.shape[2]
    KF = min(params.max_inv_fanout_per_round, T)
    fanout = params.fanout_replay
    queue_on = params.dram.queue_model_enabled

    def e(dtype, shape=(T,)):
        return torch.empty(shape, dtype=dtype, device=dev)

    i32, i64, b = torch.int32, torch.int64, torch.bool
    return ChainOut(
        way=e(i32), hit=e(b), serve=e(b), serve_all=e(b), member=e(b),
        member_add=e(b), hard_stop=e(b), fan_go=e(b), owner_leg=e(b),
        evicting=e(b), owner=e(i32), ow_slot=e(i32), down_to=e(i32),
        new_state=e(i32), new_owner=e(i32), delta_sh=e(i64, (T, W)),
        dram_read=e(b), dram_write=e(b), need_read=e(b), dram_wb=e(b),
        t_dir=e(i64), owner_ps=e(i64), inv_ps=e(i64), reply_ps=e(i64),
        from_dram_ps=e(i64), dram_arrival=e(i64), l1_fill_ps=e(i64),
        inv_bool=e(b, (KF, T)) if fanout else None,
        line_fr=e(i64, (KF,)) if fanout else None,
        inv_count=e(i64),
        completion=None if queue_on else e(i64),
        t_data=None if queue_on else e(i64),
        ftbl=None if queue_on else e(i64, (2, H)))


def _chain_args(params: SimParams, vp: VariantParams, ci: ChainIn, H: int,
                out: ChainOut) -> _ChainArgs:
    """Pack pointers and scalars into the kernel's argument struct."""
    net = params.net_memory
    noc._zero_load_only(net)
    T = params.num_tiles
    ptr = {f: getattr(ci, f).data_ptr() for f in ChainIn._fields
           if f != "ftbl"}
    ptr["ftbl_in"] = ci.ftbl.data_ptr() if ci.ftbl is not None else None
    for f in ChainOut._fields:
        t = getattr(out, f)
        ptr["ftbl_out" if f == "ftbl" else f] = \
            t.data_ptr() if t is not None else None
    fw = vp.net_memory.flit_width_bits
    return _ChainArgs(
        **ptr, T=T, A=params.directory.associativity,
        W=ci.dsharers.shape[2], H=H,
        KF=min(params.max_inv_fanout_per_round, T),
        fanout=int(params.fanout_replay),
        queue_on=int(params.dram.queue_model_enabled),
        ndsets=params.directory.num_sets, mesh_width=params.mesh_width,
        net_magic=int(net.model == "magic"),
        hop_cycles=vp.net_memory.router_delay_cycles
        + vp.net_memory.link_delay_cycles,
        ser_req=max(noc.num_flits(CTRL_BYTES, fw) - 1, 0),
        ser_data=max(noc.num_flits(params.line_size + CTRL_BYTES, fw) - 1,
                     0),
        inv_ack_cycles=vp.inv_ack_cycles, dir_cycles=vp.dir_access_cycles,
        l2_cycles=vp.l2_access_cycles, l1d_cycles=vp.l1d_access_cycles,
        l1i_cycles=vp.l1i_access_cycles,
        dram_latency_ps=vp.dram_latency_ps,
        dram_processing_ps=vp.dram_processing_ps)


def smem_bytes(lib, params: SimParams, W: int, H: int) -> int:
    """Dynamic shared memory the kernel asks for at these shapes."""
    T = params.num_tiles
    KF = min(params.max_inv_fanout_per_round, T)
    fn = lib.chain_classify_smem_bytes
    fn.argtypes = [ctypes.c_int64] * 4
    fn.restype = ctypes.c_size_t
    return int(fn(T, W, H, KF))


def chain_classify_cuda(params: SimParams, vp: VariantParams, ci: ChainIn,
                        H: int) -> ChainOut:
    """Launch csrc/chain_classify.cu on CUDA tensors: one block, one
    thread per tile, outputs into fresh tensors."""
    check_chain_config(params)
    if ci.line.device.type != "cuda":
        raise ValueError("chain_classify_cuda takes CUDA tensors")
    _check_inputs(params, ci, H)
    from graphite_tpu_torch.engine.kernels import build
    lib = build.load("chain_classify")
    need = smem_bytes(lib, params, ci.dsharers.shape[2], H)
    if need > MAX_SMEM_BYTES:
        raise ValueError(f"chain_classify: tables need {need} bytes of "
                         f"shared memory, more than {MAX_SMEM_BYTES}")
    out = _alloc_out(params, ci, H)
    a = _chain_args(params, vp, ci, H, out)
    stream = torch.cuda.current_stream(ci.line.device).cuda_stream
    err = lib.chain_classify_launch(ctypes.addressof(a), stream)
    if err != 0:
        raise RuntimeError(f"chain_classify kernel launch failed: CUDA "
                           f"error {err} ({build.error_string(lib, err)})")
    dispatch.COUNTS["chain_classify"] += 1
    return out


def run_chain(params: SimParams, vp: VariantParams, ci: ChainIn,
              H: int) -> ChainOut:
    """The classify step, dispatched by device: the CUDA kernel for CUDA
    tensors, the plain PyTorch form for CPU tensors."""
    if dispatch.use_kernel(ci.line):
        return chain_classify_cuda(params, vp, ci, H)
    return chain_classify(params, vp, ci, H)

