"""One chain-replay iteration: the chain-head and directory-row gathers
and the classify step, in plain PyTorch and as one CUDA kernel.

``chain_classify`` is the sub-chain that every iteration of
``resolve.chain_fast_pass`` runs for every tile's current chain head:
the directory probe and victim way, the (home, dset, way) FCFS election,
the fan-out and owner delivery budgets, shared-read combining over a
hash table of size H, the MSI transition, the zero-load NoC and DRAM
timing legs and, with the DRAM queue model off, the completion time and
the per-line floor write.  It is the counterpart of
``graphite_tpu/engine/kernels/chain.py:134``, transliterated for this
slice's configuration: simple cores, private L1/L2 under MSI, a
full-map directory, zero-load networks.  The JAX package gathers each
iteration's heads and directory rows outside its Pallas kernel
(``graphite_tpu/engine/resolve.py:264-285``); here they are part of the
step (:func:`chain_head`, :func:`chain_rows`).

Two forms compute one iteration from the state's own arrays
(:class:`ChainStepIn`):

  * :func:`chain_step` — plain PyTorch: :func:`chain_head`,
    :func:`chain_rows` and :func:`chain_classify`, the last with the JAX
    package's [T, T] rank masks and H-slot scatter tables.  The CPU
    tests hold :func:`chain_classify` against the JAX function field for
    field, and :func:`chain_step` against it on state-level operands.
  * ``csrc/chain_classify.cu`` — ONE CUDA launch for ``sm_90a`` per
    iteration: one block, one thread per tile for the per-tile work and
    the whole block for the tables, the directory-row staging and the
    invalidation masks; every output leaf a view of one device buffer
    (:class:`StepLayout`), the floor table updated in place.

:func:`run_chain_step` picks between them by the tensors' device, like
``window.run_window``; the wrapper counts its launches in
``dispatch.COUNTS``.  What stays in ``resolve.chain_fast_pass``: the
DRAM queue probe (its ring is loop-carried) and the apply scatters.
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
from graphite_tpu_torch.engine.state import (PEND_EX_REQ, PEND_IFETCH,
                                             dword_owner, dword_stamp,
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


class ChainHead(NamedTuple):
    """Each tile's current chain head, as the apply code of
    ``resolve.chain_fast_pass`` reads it (all [T]): the first ten fields
    of :class:`ChainIn`."""

    active: torch.Tensor      # bool
    is_ex: torch.Tensor       # bool
    is_if: torch.Tensor       # bool
    line: torch.Tensor        # int64
    issue: torch.Tensor       # int64
    extra: torch.Tensor       # int64
    home: torch.Tensor        # int32
    dset: torch.Tensor        # int32
    fidx: torch.Tensor        # int32
    hidx: torch.Tensor        # int32


class ChainStepIn(NamedTuple):
    """One replay iteration's operands as the state holds them: the
    [P, T] chain bank, the pass's head / stop / base carry, the directory
    arrays and the pass's periods."""

    mq_req: torch.Tensor       # [P, T] int64 banked elements
    mq_delta: torch.Tensor     # [P, T] int64
    mq_extra: torch.Tensor     # [P, T] int64
    head: torch.Tensor         # [T] int32 served elements (the head index)
    stopped: torch.Tensor      # [T] bool chains demoted this pass
    stop_hi: torch.Tensor      # [T] int32 banked elements (mq_count)
    base: torch.Tensor         # [T] int64 last served completion
    dir_word: torch.Tensor     # [A, T * ndsets] int64
    dir_sharers: torch.Tensor  # [W * A, T * ndsets] int64 (uint64 bits)
    p_net: torch.Tensor        # [T] int32 periods
    p_dir: torch.Tensor
    p_l2: torch.Tensor
    p_l1d: torch.Tensor
    p_l1i: torch.Tensor
    p_core: torch.Tensor
    ftbl: Optional[torch.Tensor]  # [2, H] int64 (DRAM queue model off)


def chain_head(params: SimParams, mq_req, mq_delta, mq_extra, head,
               stopped, stop_hi, base, H: int) -> ChainHead:
    """Each tile's current chain head and its directory coordinates (the
    JAX ``slot_body``'s head gathers, graphite_tpu/engine/resolve.py).
    An election loser retries the same element next iteration while the
    winner's chain moves on; element p's issue point is the previous
    element's completion (the carried base) plus its recorded delta."""
    P = params.miss_chain
    ndsets = params.directory.num_sets
    hsel = torch.clamp(head, 0, P - 1).to(torch.int64)[None, :]
    req = torch.gather(mq_req, 0, hsel)[0]
    delta = torch.gather(mq_delta, 0, hsel)[0]
    extra = torch.gather(mq_extra, 0, hsel)[0]
    active = (~stopped) & (head < stop_hi)
    kind = (req & 7).to(torch.int32)
    line = torch.where(active, req >> 8, 0)
    is_ex = active & (kind == PEND_EX_REQ)
    is_if = active & (kind == PEND_IFETCH)
    home = dense.home_of_line(params, line)
    dset = dense.dir_set_of_line(params, line)
    fidx = (home * ndsets + dset).to(torch.int32)
    issue = base + delta
    hidx = umod64(dense.fmix64(line), H).to(torch.int32)
    return ChainHead(active=active, is_ex=is_ex, is_if=is_if, line=line,
                     issue=issue, extra=extra, home=home, dset=dset,
                     fidx=fidx, hidx=hidx)


def chain_rows(dir_word: torch.Tensor, dir_sharers: torch.Tensor,
               fidx: torch.Tensor):
    """The directory entry rows at each head's (home, dset): drow [T, A]
    and dsharers [T, A, W], one gather each."""
    A = dir_word.shape[0]
    W = dir_sharers.shape[0] // A
    T = fidx.shape[0]
    f = fidx.to(torch.int64)
    drow = dir_word[:, f].T.contiguous()
    dsharers = dir_sharers[:, f].reshape(W, A, T).permute(2, 1, 0) \
        .contiguous()
    return drow, dsharers


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

# Sharer-bitmap words per directory entry the kernel takes (T <= 512).
MAX_WORDS = 8

# One fused launch writes every ChainHead and ChainOut leaf into ONE
# device buffer: the [T] int64 leaves, then the other int64 leaves, the
# [T] int32 leaves and the bool leaves, so each leaf is aligned to its
# element size.  _LEAVES is the order of the kernel's off_* offsets.
_ROWS_I64 = ("line", "issue", "extra", "t_dir", "owner_ps", "inv_ps",
             "reply_ps", "from_dram_ps", "dram_arrival", "l1_fill_ps",
             "inv_count", "completion", "t_data")
_ROWS_I32 = ("home", "dset", "fidx", "hidx", "way", "owner", "ow_slot",
             "down_to", "new_state", "new_owner")
_ROWS_B = ("active", "is_ex", "is_if", "hit", "serve", "serve_all",
           "member", "member_add", "hard_stop", "fan_go", "owner_leg",
           "evicting", "dram_read", "dram_write", "need_read", "dram_wb")
_LEAVES = _ROWS_I64 + ("delta_sh", "line_fr") + _ROWS_I32 + _ROWS_B \
    + ("inv_bool",)
_QUEUE_OFF = ("completion", "t_data")
_FANOUT = ("line_fr", "inv_bool")


class StepLayout:
    """Where each output leaf of one fused launch lies in its buffer
    (``offsets``: byte offset, -1 for a leaf the configuration leaves
    None), and the carving of such a buffer into the ChainHead and
    ChainOut views (ChainOut.ftbl is the caller's, updated in place)."""

    def __init__(self, params: SimParams, W: int):
        T = params.num_tiles
        KF = min(params.max_inv_fanout_per_round, T)
        absent = set()
        if params.dram.queue_model_enabled:
            absent.update(_QUEUE_OFF)
        if not params.fanout_replay:
            absent.update(_FANOUT)
        i64, i32, b = torch.int64, torch.int32, torch.bool
        size = {i64: 8, i32: 4, b: 1}
        # (dtype, names, leaf shape, a group of [T] rows?)
        groups = [
            (i64, [n for n in _ROWS_I64 if n not in absent], (T,), True),
            (i64, ["delta_sh"], (T, W), False),
            (i64, [n for n in ("line_fr",) if n not in absent], (KF,),
             False),
            (i32, list(_ROWS_I32), (T,), True),
            (b, list(_ROWS_B), (T,), True),
            (b, [n for n in ("inv_bool",) if n not in absent], (KF, T),
             False),
        ]
        self.offsets = {n: -1 for n in _LEAVES}
        # (start, stop, dtype, view shape, unbind): a group of [T] rows is
        # one [n, T] view unbound into its rows.
        self._plan = []
        carved = []
        off = 0
        for dtype, names, shape, rows in groups:
            if not names:
                continue
            per = size[dtype] * int(torch.Size(shape).numel())
            for k, n in enumerate(names):
                self.offsets[n] = off + k * per
            stop = off + per * len(names)
            self._plan.append((off, stop, dtype,
                               (len(names), T) if rows else shape, rows))
            carved += names
            off = (stop + 7) & ~7
        self.nbytes = off
        # Where each ChainHead / ChainOut field lies in the carved leaves
        # (then None, then the caller's floor table).
        where = {n: k for k, n in enumerate(carved)}
        self._head = [where[f] for f in ChainHead._fields]
        self._out = [where.get(f, len(carved) + (f == "ftbl"))
                     for f in ChainOut._fields]

    def carve(self, buf: torch.Tensor, ftbl: Optional[torch.Tensor]):
        """(ChainHead, ChainOut) views of ``buf`` (uint8, ``nbytes``)."""
        leaves = []
        for start, stop, dtype, shape, rows in self._plan:
            v = buf[start:stop].view(dtype).view(shape)
            if rows:
                leaves += v.unbind(0)
            else:
                leaves.append(v)
        leaves += (None, ftbl)
        return (ChainHead._make([leaves[k] for k in self._head]),
                ChainOut._make([leaves[k] for k in self._out]))


def fast_divisor(d: int):
    """(d, magic, shift) for the kernel's exact uint64 division by d
    without a divide instruction (the branch-free round-up method):
    q = (((x - hi) >> 1) + hi) >> shift with hi = mulhi(magic, x); a
    power of two has magic 0, and d = 1 is the kernel's identity."""
    d = int(d)
    if d < 1:
        raise ValueError(f"divisor {d} < 1")
    if d == 1:
        return (1, 0, 0)
    fl = d.bit_length() - 1
    if d & (d - 1) == 0:
        return (d, 0, fl - 1)
    return (d, ((1 << (65 + fl)) // d + 1) & ((1 << 64) - 1), fl)


class _FastDiv(ctypes.Structure):
    """Mirror of ``struct FastDiv`` in csrc/chain_classify.cu."""

    _fields_ = [("d", ctypes.c_uint64), ("magic", ctypes.c_uint64),
                ("shift", ctypes.c_int64)]


_IN_PTRS = ChainStepIn._fields + ("out",)
# The operands one chain pass holds fixed: checked, and their pointers
# set, when they are new tensors.
_PASS_FIELDS = ("mq_req", "mq_delta", "mq_extra", "stop_hi", "p_net",
                "p_dir", "p_l2", "p_l1d", "p_l1i", "p_core", "ftbl")
_SCALARS = ("T", "P", "A", "W", "D", "H", "KF", "fanout", "queue_on",
            "ndsets", "home_stride", "fold_bits", "dset_bits", "mesh_width",
            "net_magic", "hop_cycles", "ser_req", "ser_data",
            "inv_ack_cycles", "dir_cycles", "l2_cycles", "l1d_cycles",
            "l1i_cycles", "dram_latency_ps", "dram_processing_ps")
_DIVS = ("div_h", "div_ctrl", "div_dsets")


class _StepArgs(ctypes.Structure):
    """Mirror of ``struct StepArgs`` in csrc/chain_classify.cu: pointers,
    the output offsets, int64 scalars, then the divisors — every field 8
    bytes, so the layout has no padding."""

    _fields_ = [(n, ctypes.c_void_p) for n in _IN_PTRS] \
        + [("off_" + n, ctypes.c_int64) for n in _LEAVES] \
        + [(n, ctypes.c_int64) for n in _SCALARS] \
        + [(n, _FastDiv) for n in _DIVS]


def _check(name, t, dtype, shape, dev):
    if t.device != dev or t.dtype != dtype or t.shape != shape \
            or not t.is_contiguous():
        raise ValueError(
            f"chain_classify: {name} is {t.dtype}{tuple(t.shape)} on "
            f"{t.device} (contiguous: {t.is_contiguous()}), not "
            f"{dtype}{tuple(shape)} on {dev}, contiguous")


class _Step:
    """The fused launch at one (params, vp, H, W): the loaded library,
    the argument struct with every scalar and output offset filled, the
    output layout and the shared-memory size.  Per call only the
    pointers are set."""

    def __init__(self, params: SimParams, vp: VariantParams, H: int,
                 W: int):
        check_chain_config(params)
        net = params.net_memory
        noc._zero_load_only(net)
        T = params.num_tiles
        A = params.directory.associativity
        KF = min(params.max_inv_fanout_per_round, T)
        if T > 64 * MAX_WORDS or W != (T + 63) // 64 or A > 32:
            raise ValueError(
                f"chain_classify: T = {T}, W = {W}, A = {A} outside the "
                f"kernel's limits (T <= {64 * MAX_WORDS}, W = ceil(T / "
                f"64) sharer words per entry, A <= 32 ways)")
        from graphite_tpu_torch.engine.kernels import build
        self.lib = build.load("chain_classify")
        fn = self.lib.chain_classify_smem_bytes
        fn.argtypes = [ctypes.c_int64] * 5
        fn.restype = ctypes.c_size_t
        self.smem = int(fn(T, A, W, H, KF))
        if self.smem > MAX_SMEM_BYTES:
            raise ValueError(
                f"chain_classify: tables and directory rows need "
                f"{self.smem} bytes of shared memory, more than "
                f"{MAX_SMEM_BYTES}")
        self.params, self.vp, self.H, self.W = params, vp, H, W
        self.layout = StepLayout(params, W)
        self.pass_ops = None      # the pass operands last checked
        nctrl = params.dram.num_controllers
        ndsets = params.directory.num_sets
        fw = vp.net_memory.flit_width_bits
        a = _StepArgs(
            **{"off_" + n: o for n, o in self.layout.offsets.items()},
            T=T, P=params.miss_chain, A=A, W=W, D=T * ndsets, H=H, KF=KF,
            fanout=int(params.fanout_replay),
            queue_on=int(params.dram.queue_model_enabled),
            ndsets=ndsets, home_stride=params.dram.controller_home_stride,
            fold_bits=max(nctrl.bit_length() - 1, 1),
            dset_bits=ndsets.bit_length() - 1,
            mesh_width=params.mesh_width,
            net_magic=int(net.model == "magic"),
            hop_cycles=vp.net_memory.router_delay_cycles
            + vp.net_memory.link_delay_cycles,
            ser_req=max(noc.num_flits(CTRL_BYTES, fw) - 1, 0),
            ser_data=max(noc.num_flits(params.line_size + CTRL_BYTES, fw)
                         - 1, 0),
            inv_ack_cycles=vp.inv_ack_cycles,
            dir_cycles=vp.dir_access_cycles, l2_cycles=vp.l2_access_cycles,
            l1d_cycles=vp.l1d_access_cycles,
            l1i_cycles=vp.l1i_access_cycles,
            dram_latency_ps=vp.dram_latency_ps,
            dram_processing_ps=vp.dram_processing_ps,
            div_h=_FastDiv(*fast_divisor(H)),
            div_ctrl=_FastDiv(*fast_divisor(nctrl)),
            div_dsets=_FastDiv(*fast_divisor(ndsets)))
        self.args, self.addr = a, ctypes.addressof(a)

    def bind_pass(self, si: ChainStepIn) -> None:
        """Check the operands a pass holds fixed (bank, stop count,
        periods, floor table: device, dtype, shape, contiguity) and set
        their pointers, when they are other tensors than last call's:
        once per pass."""
        fixed = tuple(getattr(si, n) for n in _PASS_FIELDS)
        if self.pass_ops is not None and all(
                x is y for x, y in zip(fixed, self.pass_ops)):
            return
        p = self.params
        T, P = p.num_tiles, p.miss_chain
        dev = si.base.device
        for n in ("mq_req", "mq_delta", "mq_extra"):
            _check(n, getattr(si, n), torch.int64, (P, T), dev)
        for n in ("stop_hi", "p_net", "p_dir", "p_l2", "p_l1d", "p_l1i",
                  "p_core"):
            _check(n, getattr(si, n), torch.int32, (T,), dev)
        if p.dram.queue_model_enabled != (si.ftbl is None):
            raise ValueError("chain_classify: ftbl is given iff the DRAM "
                             "queue model is off")
        if si.ftbl is not None:
            _check("ftbl", si.ftbl, torch.int64, (2, self.H), dev)
        for n, t in zip(_PASS_FIELDS, fixed):
            setattr(self.args, n, t.data_ptr() if t is not None else None)
        self.pass_ops = fixed

    def check(self, si: ChainStepIn) -> None:
        """The per-iteration operands (the head / stop / base carry and
        the directory arrays): device, dtype, shape and contiguity; and
        no storage shared with the floor table, which the kernel updates
        in place."""
        p = self.params
        T = p.num_tiles
        A = p.directory.associativity
        D = T * p.directory.num_sets
        dev = si.base.device
        _check("head", si.head, torch.int32, (T,), dev)
        _check("stopped", si.stopped, torch.bool, (T,), dev)
        _check("base", si.base, torch.int64, (T,), dev)
        _check("dir_word", si.dir_word, torch.int64, (A, D), dev)
        _check("dir_sharers", si.dir_sharers, torch.int64,
               (self.W * A, D), dev)
        if si.ftbl is not None:
            dispatch.check_no_alias("chain_classify", si, ("ftbl",))

    def __call__(self, si: ChainStepIn):
        self.bind_pass(si)
        self.check(si)
        buf = torch.empty(self.layout.nbytes, dtype=torch.uint8,
                          device=si.base.device)
        a = self.args
        a.head, a.stopped, a.base = (si.head.data_ptr(),
                                     si.stopped.data_ptr(),
                                     si.base.data_ptr())
        a.dir_word, a.dir_sharers = (si.dir_word.data_ptr(),
                                     si.dir_sharers.data_ptr())
        a.out = buf.data_ptr()
        stream = torch.cuda.current_stream(si.base.device).cuda_stream
        err = self.lib.chain_classify_launch(self.addr, stream)
        if err != 0:
            from graphite_tpu_torch.engine.kernels import build
            raise RuntimeError(
                f"chain_classify kernel launch failed: CUDA error {err} "
                f"({build.error_string(self.lib, err)})")
        dispatch.COUNTS["chain_classify"] += 1
        return self.layout.carve(buf, si.ftbl)


# (id(params), id(vp), H, W) -> _Step; the entry holds params and vp, so
# their ids stay theirs while it lives.  A run uses one entry; the cache
# is emptied when it outgrows a handful.
_STEPS = {}
_MAX_STEPS = 16


def chain_step_entry(params: SimParams, vp: VariantParams, H: int,
                     W: int) -> _Step:
    """The cached fused launch at (params, vp, H, W)."""
    key = (id(params), id(vp), H, W)
    step = _STEPS.get(key)
    if step is None:
        if len(_STEPS) >= _MAX_STEPS:
            _STEPS.clear()
        step = _STEPS[key] = _Step(params, vp, H, W)
    return step


def chain_step_cuda(params: SimParams, vp: VariantParams, si: ChainStepIn,
                    H: int):
    """One replay iteration on CUDA tensors, ONE launch of
    csrc/chain_classify.cu: the head gathers, the directory-row gathers
    and the classify step.  Returns (ChainHead, ChainOut), every leaf a
    view of one fresh buffer; with the DRAM queue model off the kernel
    writes the floors into ``si.ftbl`` in place and ChainOut.ftbl is that
    tensor."""
    if si.base.device.type != "cuda":
        raise ValueError("chain_step_cuda takes CUDA tensors")
    W = si.dir_sharers.shape[0] // params.directory.associativity
    return chain_step_entry(params, vp, H, W)(si)


def chain_step(params: SimParams, vp: VariantParams, si: ChainStepIn,
               H: int):
    """One replay iteration in plain PyTorch: :func:`chain_head`,
    :func:`chain_rows` and :func:`chain_classify`, out of place (the
    floor table comes back as a new ChainOut.ftbl).  Returns (ChainHead,
    ChainOut)."""
    head = chain_head(params, si.mq_req, si.mq_delta, si.mq_extra, si.head,
                      si.stopped, si.stop_hi, si.base, H)
    drow, dsharers = chain_rows(si.dir_word, si.dir_sharers, head.fidx)
    ci = ChainIn(*head, drow=drow, dsharers=dsharers, p_net=si.p_net,
                 p_dir=si.p_dir, p_l2=si.p_l2, p_l1d=si.p_l1d,
                 p_l1i=si.p_l1i, p_core=si.p_core, ftbl=si.ftbl)
    return head, chain_classify(params, vp, ci, H)


def run_chain_step(params: SimParams, vp: VariantParams, si: ChainStepIn,
                   H: int):
    """One replay iteration, dispatched by device: one launch of the
    fused kernel for CUDA tensors (floor table in place), the plain
    :func:`chain_step` for CPU tensors.  Returns (ChainHead, ChainOut)."""
    if dispatch.use_kernel(si.base):
        return chain_step_cuda(params, vp, si, H)
    return chain_step(params, vp, si, H)
