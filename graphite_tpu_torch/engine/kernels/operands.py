"""Seeded operands for the kernels of this package, for holding each
kernel, its plain form and the JAX reference against each other.

Each ``random_*_arrays`` returns numpy arrays (field name -> array) made
from a numpy seed; each ``*_in_from_numpy`` turns them into the kernel's
operand tuple on a device.  The CPU tests and ``chip_smoke.py`` use them;
nothing on the simulator's path does.
"""

from __future__ import annotations

import numpy as np
import torch

from graphite_tpu_torch.engine import cache as cachemod
from graphite_tpu_torch.engine import dense
from graphite_tpu_torch.engine.kernels.chain import ChainIn, ChainStepIn
from graphite_tpu_torch.engine.kernels.window import FFIn, WindowIn
from graphite_tpu_torch.engine.ops import umod64
from graphite_tpu_torch.engine.dense import dir_set_of_line, home_of_line
from graphite_tpu_torch.engine.state import (PEND_EX_REQ, PEND_IFETCH,
                                             PEND_SH_REQ)
from graphite_tpu_torch.isa import DVFSModule, EventOp
from graphite_tpu_torch.params import SimParams

I, S, M = cachemod.I, cachemod.S, cachemod.M



def random_window_arrays(params: SimParams, K: int, seed: int) -> dict:
    """Random walk operands as numpy arrays (field name -> array), for
    holding the kernel, the plain form and the JAX walk against each
    other.  Cache words are valid packed words whose tags come from the
    same small line pool as the window's addresses, so probes hit, miss,
    alias sets and collide on predictor slots; every event kind the walk
    classifies appears."""
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
    out = dict(
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
    P = params.miss_chain
    if P > 0:
        # A bank from earlier rounds: some tiles empty, some mid-chain
        # (served head < count), some full; pending lines from the
        # window's pool so forwarding and stall-on-use both fire.
        count = rng.integers(0, P + 1, size=T)
        count[rng.random(T) < 0.3] = 0
        head = (rng.random(T) * (count + 1)).astype(np.int64)
        head = np.minimum(head, np.maximum(count - 1, 0))
        kinds = rng.choice([PEND_SH_REQ, PEND_EX_REQ, PEND_IFETCH],
                           size=(P, T))
        plines = rng.choice(pool, size=(P, T))
        qps = params.quantum_ps
        out.update(
            chain_rel=np.where(count > 0,
                               rng.integers(0, 2 * qps, size=T),
                               0).astype(np.int64),
            mq_count=count.astype(np.int32), mq_head=head.astype(np.int32),
            mq_req=(kinds | (plines << 8)).astype(np.int64),
            mq_delta=rng.integers(0, 400_000, size=(P, T)).astype(np.int64),
            mq_extra=rng.integers(0, 60_000, size=(P, T)).astype(np.int64))
    return out


# The per-tile cases of :func:`seeded_window_arrays`, in the order tile t
# of seed s draws them ((t + s) % len).
WINDOW_CASES = ("touch", "branch", "cut0", "cutlast", "inactive",
                "fullbank", "pending", "fill", "random")


def seeded_window_arrays(params: SimParams, K: int, seed: int) -> dict:
    """Walk operands (as :func:`random_window_arrays`) in which each tile
    draws one of ``WINDOW_CASES``, to force what an event-parallel walk
    that writes in place could get wrong:

      * touch — reads and writes of two L1D-resident lines, all retiring:
        several touches of one (set, way), some with stamps below the
        resident word's;
      * branch — branches on two predictor slots between hits, all
        retiring: several retired writers of one slot;
      * cut0 — an event the walk never takes first: the cut at event 0;
      * cutlast — K - 1 hits, then an event the walk never takes: the cut
        at event K - 1;
      * inactive — a tile that is not active, beside active ones;
      * fullbank — at P > 0 a bank two slots short of full and misses to
        fresh lines between hits: the bank reaches P and stops the walk;
      * pending — at P > 0 a pending bank (shared, ifetch and exclusive
        requests) and a window that reads and fetches its lines (hits on
        pending fills), then a write to a pending shared line or an
        access to another line of a pending line's L2 set;
      * fill — L2 hits that fill L1I and L1D (one line fetched and then
        read: two touches of its L2 word), then an access to a filled
        L1D set;
      * random — the tile as :func:`random_window_arrays` draws it.

    The lines the cases use lie above every line of the random pool, so
    they are resident exactly where a case puts them.  Models are
    enabled and the boundary is far, so a cut is the case's own."""
    a = random_window_arrays(params, K, seed)
    rng = np.random.default_rng(1_000_003 + seed)
    T = params.num_tiles
    P = params.miss_chain
    lb = params.line_size.bit_length() - 1
    BP = params.core.bp_size
    Si, Sd, S2 = (params.l1i.num_sets, params.l1d.num_sets,
                  params.l2.num_sets)
    RD, WR = int(EventOp.MEM_READ), int(EventOp.MEM_WRITE)
    COMP, BR = int(EventOp.COMPUTE), int(EventOp.BRANCH)
    NEVER = int(EventOp.BARRIER_WAIT)        # an event the walk never takes
    op, arg, arg2 = a["meta"]
    addr = a["addr"]
    a["boundary"] = np.int64(50_000_000)
    a["models_enabled"] = np.bool_(True)
    used = {}

    def put(name, t, ln, state):
        # Resident in a way no other case line of this set holds.
        w = a[name]
        A, S = w.shape[0], w.shape[2]
        k = (name, t, ln % S)
        way = used.get(k, int(rng.integers(0, A)))
        used[k] = (way + 1) % A
        # Half the stamps lie below the window's, half (most likely) above.
        hi = (1 << 29) if rng.random() < 0.5 else int(a["stamp_base"]) + 1
        w[way, t, ln % S] = (ln << 32) \
            | (int(rng.integers(0, hi)) << 3) | state

    def event(t, j, o, ln=0, pc=None):
        op[t, j] = o
        addr[t, j] = (ln << lb) + int(rng.integers(0, params.line_size)) \
            if pc is None else pc
        arg[t, j] = int(rng.integers(0, 2)) if o == BR \
            else int(rng.integers(0, 8))
        arg2[t, j] = int(rng.integers(0, 4)) if o == COMP \
            else int(rng.choice([0, 0, 1]))

    for t in range(T):
        case = WINDOW_CASES[(t + seed) % len(WINDOW_CASES)]
        if case == "random":
            continue
        base = (1 << 30) + 4096 * t          # this tile's case lines
        la, lb_ = base, base + 1
        put("l1d_word", t, la, M)
        put("l1d_word", t, lb_, M)
        a["clock"][t] = int(rng.integers(0, 1_000_000))
        a["valid_ev"][t] = case != "inactive"
        a["tile_active"][t] = case != "inactive"
        hits = [(RD, la), (WR, la), (RD, lb_), (WR, lb_)]

        def hit(t, j):
            o, ln = hits[int(rng.integers(0, len(hits)))]
            event(t, j, o, ln)

        for j in range(K):
            hit(t, j)
        if case == "branch":
            slots = rng.choice(BP, size=2, replace=False)
            for j in range(K):
                if rng.random() < 0.6:
                    event(t, j, BR, pc=int(rng.choice(slots))
                          + BP * int(rng.integers(0, 1 << 10)))
        elif case == "cut0":
            op[t, 0] = NEVER
        elif case == "cutlast":
            op[t, K - 1] = NEVER
        elif case == "fullbank" and P > 0:
            a["mq_count"][t] = a["mq_head"][t] = max(P - 2, 0)
            a["chain_rel"][t] = 0
            for j in range(0, K, 2):
                event(t, j, RD, base + 16 + j)   # fresh lines, fresh sets
        elif case == "pending" and P > 0:
            n = min(P, 4)
            plines = [base + 8 + i for i in range(n)]
            kinds = [PEND_SH_REQ, PEND_IFETCH, PEND_EX_REQ, PEND_SH_REQ][:n]
            a["mq_head"][t], a["mq_count"][t] = 0, n
            a["chain_rel"][t] = int(rng.integers(0, 1000))
            for s in range(n):
                a["mq_req"][s, t] = kinds[s] | (plines[s] << 8)
            sh = [ln for ln, k in zip(plines, kinds) if k != PEND_IFETCH]
            ifl = [ln for ln, k in zip(plines, kinds) if k == PEND_IFETCH]
            cut = int(rng.integers(2, K))
            for j in range(cut):
                r = rng.random()
                if r < 0.3:
                    event(t, j, RD, int(rng.choice(sh)))
                elif r < 0.45 and ifl:
                    event(t, j, COMP, ifl[0])
            if (t // len(WINDOW_CASES) + seed) % 2 == 0:
                event(t, cut, WR, sh[-1])        # write on a pending SH
            else:                                # same L2 set, other line
                event(t, cut, RD, plines[0] + S2 * (1 + t))
        elif case == "fill":
            lc, le = base + 2, base + 3
            for ln in (lc, le, le + Sd):
                put("l2_word", t, ln, M)
            event(t, 0, COMP, lc)                # L2 hit: fills L1I
            event(t, 1, RD, lc)                  # L2 hit: fills L1D
            event(t, 2, WR, le)                  # L2 hit (M): fills L1D
            event(t, min(3 + int(rng.integers(0, K - 3)), K - 1), RD,
                  le + Sd)                       # the filled L1D set
    a["meta"] = np.stack([op, arg, arg2]).astype(np.int32)
    a["addr"] = addr.astype(np.int64)
    return a


def window_in_from_numpy(arrays: dict, device) -> WindowIn:
    """A :class:`WindowIn` on ``device`` from numpy operands."""
    dev = torch.device(device)
    return WindowIn(**{
        f: torch.from_numpy(np.array(arrays[f])).to(dev)
        for f in WindowIn._fields if arrays.get(f) is not None})



def random_ff_arrays(params: SimParams, F: int, seed: int) -> dict:
    """Random fast-forward operands as numpy arrays (field name -> array).

    Spans are mostly eligible hits, so prefixes longer than one window
    round occur and tiles engage; each tile draws its own case: an
    ineligible event (a miss, a write to a read-only line, a STALL) early
    or late in its span or none, a clock below, across or past the
    bounds, the trace end inside the span, or not a candidate at all.
    Lines come from a small pool (repeated touches of one way), branch
    addresses from a few predictor slots (in-span slot collisions), and
    cache stamps are random up to 2^29 (touches that must not lower a
    word).  About one seed in eight has models disabled."""
    rng = np.random.default_rng(seed)
    T = params.num_tiles
    lb = params.line_size.bit_length() - 1
    BP = params.core.bp_size
    pool = rng.integers(0, 1 << 22, size=12)
    ro_pool = rng.integers(0, 1 << 22, size=3)      # resident read-only
    miss_pool = rng.integers(1 << 22, 1 << 23, size=3)   # never resident

    ops = np.array([int(EventOp.COMPUTE), int(EventOp.MEM_READ),
                    int(EventOp.MEM_WRITE), int(EventOp.BRANCH)])
    op = rng.choice(ops, size=(T, F), p=[0.4, 0.25, 0.15, 0.2])
    line = rng.choice(pool, size=(T, F))
    # Reads may also hit the read-only lines.
    ro = (op == int(EventOp.MEM_READ)) & (rng.random((T, F)) < 0.3)
    line = np.where(ro, rng.choice(ro_pool, size=(T, F)), line)
    # Per-tile stop: an ineligible event at a random position, or none.
    stop = np.where(rng.random(T) < 0.5, F,
                    rng.integers(0, F, size=T))
    kinds = rng.integers(0, 4, size=T)
    for t in range(T):
        j = int(stop[t])
        if j >= F:
            continue
        if kinds[t] == 0:                 # L1D miss
            op[t, j], line[t, j] = int(EventOp.MEM_READ), miss_pool[0]
        elif kinds[t] == 1:               # write to a read-only line
            op[t, j], line[t, j] = int(EventOp.MEM_WRITE), ro_pool[0]
        elif kinds[t] == 2:               # L1I miss
            op[t, j], line[t, j] = int(EventOp.COMPUTE), miss_pool[1]
        else:                             # an event the leg never takes
            op[t, j] = int(EventOp.STALL)
    slots = rng.integers(0, BP, size=4)
    br_addr = rng.choice(slots, size=(T, F)) \
        + BP * rng.integers(0, 1 << 10, size=(T, F))
    addr = (line << lb) + rng.integers(0, params.line_size, size=(T, F))
    addr = np.where(op == int(EventOp.BRANCH), br_addr, addr)
    arg = np.where(op == int(EventOp.BRANCH), rng.integers(0, 2, (T, F)),
                   rng.integers(-2, 40, (T, F))).astype(np.int32)
    arg2 = np.where(op == int(EventOp.COMPUTE), rng.integers(0, 200, (T, F)),
                    np.where(rng.random((T, F)) < 0.7, 0,
                             rng.integers(1, 300, (T, F)))).astype(np.int32)

    def words(A, S, resident, ro_lines, states):
        tags = rng.choice(miss_pool[2:], size=(A, T, S))
        stamps = rng.integers(0, 1 << 29, size=(A, T, S))
        st = rng.choice([0, 1, 4], size=(A, T, S))
        w = (tags.astype(np.int64) << 32) | (stamps << 3) | st
        for t in range(T):
            placed = set()
            for ln in list(resident) + list(ro_lines):
                if ln in placed:
                    continue
                placed.add(ln)
                state = 1 if ln in ro_lines else int(rng.choice(states))
                way = int(rng.integers(0, A))
                w[way, t, int(ln) % S] = (int(ln) << 32) \
                    | (int(rng.integers(0, 1 << 29)) << 3) | state
        return w.astype(np.int64)

    Ai, Si = params.l1i.associativity, params.l1i.num_sets
    Ad, Sd = params.l1d.associativity, params.l1d.num_sets
    l1i = words(Ai, Si, pool, [], [1, 4])
    l1d = words(Ad, Sd, pool, ro_pool, [4, 4, 4, 3])

    nm = len(DVFSModule)
    period = rng.integers(250, 1200, size=(T, nm)).astype(np.int32)
    boundary = 50_000_000 + int(rng.integers(0, 10_000_000))
    # Clocks from well below the window bound to past the run-ahead bound.
    clock = boundary - rng.choice(
        [0, 200_000, 1_000_000, 3_000_000, 20_000_000], size=T) \
        + rng.integers(-100_000, 100_000, size=T)
    clock = np.where(rng.random(T) < 0.1, boundary + 5_000_000, clock)
    valid = np.ones((T, F), dtype=bool)
    end = rng.random(T) < 0.2                      # trace end in the span
    valid &= ~(end[:, None] & (np.arange(F)[None, :]
                               >= rng.integers(0, F, size=T)[:, None]))
    cand = rng.random(T) < 0.85
    return dict(
        meta=np.stack([op, arg, arg2]).astype(np.int32),
        addr=addr.astype(np.int64), valid_ev=valid & cand[:, None],
        tile_active=cand, clock=clock.astype(np.int64), period_ps=period,
        bp_table=rng.random((T, BP)) < 0.5, l1i_word=l1i, l1d_word=l1d,
        boundary=np.int64(boundary),
        models_enabled=np.bool_(seed % 8 != 7),
        stamp_base=np.int32(64 * int(rng.integers(0, 8_000_000))))


def ff_in_from_numpy(arrays: dict, device) -> FFIn:
    """An :class:`FFIn` on ``device`` from numpy operands."""
    dev = torch.device(device)
    return FFIn(**{f: torch.from_numpy(np.array(arrays[f])).to(dev)
                   for f in FFIn._fields})


def random_chain_arrays(params: SimParams, H: int, seed: int) -> dict:
    """Random classify operands as numpy arrays (field name -> array), for
    holding the kernel, the plain form and the JAX function against each
    other.  Lines come from a small pool, so heads share lines, directory
    sets and hash slots; directory rows hold I / S / M entries whose tags
    come from the same pool (hits, misses, live and dead victims, owners
    other than the requester), and sharer words are random tile bits."""
    rng = np.random.default_rng(seed)
    T = params.num_tiles
    A = params.directory.associativity
    W = (T + 63) // 64
    ndsets = params.directory.num_sets
    pool = rng.integers(0, 1 << 24, size=max(3, T // 2))
    active = rng.random(T) < 0.85
    kind = rng.choice([PEND_SH_REQ, PEND_EX_REQ, PEND_IFETCH], size=T,
                      p=[0.45, 0.4, 0.15])
    line = np.where(active, rng.choice(pool, size=T), 0).astype(np.int64)
    lt = torch.from_numpy(line)
    home = home_of_line(params, lt).numpy()
    dset = dir_set_of_line(params, lt).numpy()
    fidx = (home.astype(np.int64) * ndsets + dset).astype(np.int32)
    hidx = umod64(dense.fmix64(lt), H).to(torch.int32).numpy()

    # One directory row per distinct flat set, gathered per head.
    sets = {int(f) for f in fidx}
    word_t, sh_t = {}, {}
    tilebits = (1 << T) - 1 if T < 64 else -1
    for f in sorted(sets):
        st = rng.choice([I, S, S, S, M], size=A)
        st[rng.random(A) < 0.2] = I
        tags = rng.choice(pool, size=A)
        # Plant most of this set's requested lines, so heads hit.
        for ln in sorted({int(x) for x, g in zip(line, fidx) if g == f}):
            if rng.random() < 0.7:
                w = int(rng.integers(0, A))
                tags[w] = ln
                if st[w] == I:
                    st[w] = S
        owner = np.where(st == M, rng.integers(0, T, size=A), -1)
        stamp = rng.integers(0, 1 << 17, size=A)
        word_t[f] = ((tags.astype(np.int64) << 33) | (stamp << 16)
                     | ((owner + 1) << 3) | st).astype(np.int64)
        sh = np.zeros((A, W), dtype=np.uint64)
        for w in range(A):
            for k in range(W):
                bits = int(rng.integers(0, 1 << 62)) \
                    | (int(rng.integers(0, 4)) << 62)
                if W == 1:
                    bits &= tilebits & ((1 << 64) - 1)
                if st[w] == I or rng.random() < 0.2:
                    bits = 0
                if st[w] == M:
                    o = int(owner[w])
                    bits = (1 << (o % 64)) if o // 64 == k else 0
                sh[w, k] = np.uint64(bits)
        sh_t[f] = sh
    drow = np.stack([word_t[int(f)] for f in fidx])           # [T, A]
    dsharers = np.stack([sh_t[int(f)] for f in fidx])         # [T, A, W]

    def periods():
        return rng.integers(250, 1200, size=T).astype(np.int32)

    ftbl = None
    if not params.dram.queue_model_enabled:
        ftbl = np.stack([np.where(rng.random(H) < 0.5, -1,
                                  rng.choice(pool, size=H)),
                         rng.integers(0, 3_000_000, size=H)]).astype(np.int64)
    return dict(
        active=active, is_ex=active & (kind == PEND_EX_REQ),
        is_if=active & (kind == PEND_IFETCH), line=line,
        issue=rng.integers(0, 2_000_000, size=T).astype(np.int64),
        extra=rng.integers(0, 60_000, size=T).astype(np.int64),
        home=home.astype(np.int32), dset=dset.astype(np.int32), fidx=fidx,
        hidx=hidx.astype(np.int32), drow=drow,
        dsharers=dsharers.view(np.int64), p_net=periods(), p_dir=periods(),
        p_l2=periods(), p_l1d=periods(), p_l1i=periods(), p_core=periods(),
        ftbl=ftbl)


def chain_in_from_numpy(arrays: dict, device) -> ChainIn:
    """A :class:`ChainIn` on ``device`` from numpy operands (the sharer
    words as int64 bits)."""
    dev = torch.device(device)

    def conv(a):
        if a is None:
            return None
        a = np.asarray(a)
        if a.dtype == np.uint64:
            a = a.view(np.int64)
        return torch.from_numpy(np.array(a)).to(dev)

    return ChainIn(**{f: conv(arrays.get(f)) for f in ChainIn._fields})


def _flat_sets(params: SimParams, lines: np.ndarray) -> np.ndarray:
    """Flat directory set (home * ndsets + dset) of each line."""
    lt = torch.from_numpy(np.asarray(lines, dtype=np.int64))
    home = home_of_line(params, lt).to(torch.int64)
    return (home * params.directory.num_sets
            + dir_set_of_line(params, lt)).numpy()


def random_chain_step_arrays(params: SimParams, H: int, seed: int) -> dict:
    """Random operands of one replay iteration as the state holds them
    (field name -> numpy array, :class:`ChainStepIn`'s fields), for
    holding the fused kernel, the plain head / rows / classify and the
    JAX function against each other.

    The [P, T] bank holds shared, exclusive and ifetch requests to lines
    from a small pool, part of which shares flat directory sets, so heads
    share lines, sets and hash slots; heads lie anywhere in [0, mq_count]
    (drained chains are inactive) and some chains are stopped.
    ``dir_word [A, D]`` and ``dir_sharers [W * A, D]`` are one directory:
    every set's ways hold I / S / M entries with pool tags (M with an
    owner, sharer words empty, random or the owner's bit alone), and most
    lines are resident in their sets.  On top, tiles drawn by the seed
    carry the cases a classify step must get right (T >= 8): three
    shared reads of one line (an election winner, then combining members
    or losers), a hit on a shared set's least recently used line beside a
    miss to that set (a victim way the hit excludes), an exclusive
    request on a line other tiles share (a fan-out, or a hard stop
    without the fan-out replay), a read of a line another tile holds in
    M (an owner leg) and a miss to a set with an invalid way (an
    allocation)."""
    rng = np.random.default_rng(seed)
    T, P = params.num_tiles, params.miss_chain
    A = params.directory.associativity
    W = (T + 63) // 64
    D = T * params.directory.num_sets

    # The pool: the lines of two or three shared sets (three lines each)
    # and as many random lines.
    cand = rng.integers(0, 1 << 24, size=max(20_000, 8 * D))
    cf = _flat_sets(params, cand)
    order = np.argsort(cf, kind="stable")
    cs, cl = cf[order], cand[order]
    starts = np.flatnonzero(np.r_[True, cs[1:] != cs[:-1]])
    sizes = np.diff(np.r_[starts, len(cs)])
    multi = starts[sizes >= 3]
    groups = [[int(x) for x in cl[g:g + 3]] for g in rng.choice(
        multi, size=min(len(multi), 2 + seed % 2), replace=False)]
    others = [int(x) for x in rng.integers(0, 1 << 24, size=max(6, T // 2))]
    pool = np.array([x for g in groups for x in g] + others, dtype=np.int64)

    kind = rng.choice([PEND_SH_REQ, PEND_EX_REQ, PEND_IFETCH], size=(P, T),
                      p=[0.45, 0.4, 0.15])
    lines = rng.choice(pool, size=(P, T))
    count = rng.integers(0, P + 1, size=T)
    count[rng.random(T) < 0.15] = 0
    head = (rng.random(T) * (count + 1)).astype(np.int64)
    stopped = rng.random(T) < 0.1

    st = rng.choice([I, S, S, S, M], size=(A, D))
    st[rng.random((A, D)) < 0.2] = I
    tags = rng.choice(others, size=(A, D))
    stamp = rng.integers(1, 1 << 17, size=(A, D))
    owner = np.where(st == M, rng.integers(0, T, size=(A, D)), -1)
    bits = rng.integers(0, 1 << 64, size=(W, A, D), dtype=np.uint64)
    if W == 1 and T < 64:
        bits &= np.uint64((1 << T) - 1)
    bits[rng.random((W, A, D)) < 0.25] = 0

    def flat(ln):
        return int(_flat_sets(params, [ln])[0])

    def resident(ln, state, w=None):
        f = flat(ln)
        w = int(rng.integers(0, A)) if w is None else w
        tags[w, f], st[w, f] = ln, state
        return w, f

    for ln in others[4:]:
        if rng.random() < 0.75:
            resident(ln, S)
    # A shared set has no invalid way; its first line is resident in the
    # least recently used way, its second line in another way half the
    # time, and its third line never.
    for g in groups:
        f = flat(g[0])
        st[:, f] = rng.choice([S, S, M], size=A)
        tags[:, f] = rng.choice(others, size=A)
        w0, w1 = rng.choice(A, size=2, replace=False)
        resident(g[0], S, w0)
        stamp[w0, f] = 0
        if rng.random() < 0.5:
            resident(g[1], S, w1)

    def put_head(t, ln, k):
        count[t] = max(count[t], 1)
        head[t] = min(head[t], count[t] - 1)
        stopped[t] = False
        lines[head[t], t], kind[head[t], t] = ln, k

    if T >= 8:
        tl = [int(x) for x in rng.permutation(T)]
        shared_rd, own_rd, excl_rd, alloc_rd = others[:4]
        if rng.random() < 0.5:
            resident(shared_rd, S)
        for t in tl[:3]:                      # one line, three readers
            put_head(t, shared_rd, PEND_SH_REQ)
        g = groups[0]                         # hit beside a miss
        put_head(tl[3], g[0], PEND_SH_REQ)
        put_head(tl[4], g[2], PEND_SH_REQ)
        w, f = resident(own_rd, M)            # another tile's M line
        owner[w, f] = (tl[5] + 1 + int(rng.integers(0, T - 1))) % T
        put_head(tl[5], own_rd, PEND_SH_REQ)
        w, f = resident(excl_rd, S)           # others share the line
        bits[(tl[6] + 1) % T // 64, w, f] |= np.uint64(
            1 << ((tl[6] + 1) % T % 64))
        put_head(tl[6], excl_rd, PEND_EX_REQ)
        f = flat(alloc_rd)                    # a miss, an invalid way
        tags[tags[:, f] == alloc_rd, f] = others[4]
        st[int(rng.integers(0, A)), f] = I
        put_head(tl[7], alloc_rd, PEND_SH_REQ)

    owner = np.where(st == M, np.where(owner < 0, 0, owner), -1)
    word = (tags.astype(np.int64) << 33) | (stamp << 16) \
        | ((owner + 1) << 3) | st
    bits[np.broadcast_to((st == I)[None], bits.shape)] = 0
    k = np.arange(W)[:, None, None]
    own_bit = np.left_shift(np.uint64(1),
                            np.maximum(owner, 0).astype(np.uint64) % 64)
    bits = np.where((st == M)[None], np.where(
        k == np.maximum(owner, 0)[None] // 64, own_bit[None], 0),
        bits).astype(np.uint64)

    def periods():
        return rng.integers(250, 1200, size=T).astype(np.int32)

    ftbl = None
    if not params.dram.queue_model_enabled:
        ftbl = np.stack([np.where(rng.random(H) < 0.5, -1,
                                  rng.choice(pool, size=H)),
                         rng.integers(0, 3_000_000, size=H)]).astype(np.int64)
    return dict(
        mq_req=(kind | (lines << 8)).astype(np.int64),
        mq_delta=rng.integers(0, 400_000, size=(P, T)).astype(np.int64),
        mq_extra=rng.integers(0, 60_000, size=(P, T)).astype(np.int64),
        head=head.astype(np.int32), stopped=stopped,
        stop_hi=count.astype(np.int32),
        base=rng.integers(0, 2_000_000, size=T).astype(np.int64),
        dir_word=word.astype(np.int64),
        dir_sharers=bits.reshape(W * A, D).view(np.int64),
        p_net=periods(), p_dir=periods(), p_l2=periods(), p_l1d=periods(),
        p_l1i=periods(), p_core=periods(), ftbl=ftbl)


def chain_step_in_from_numpy(arrays: dict, device) -> ChainStepIn:
    """A :class:`ChainStepIn` on ``device`` from numpy operands."""
    dev = torch.device(device)
    return ChainStepIn(**{
        f: (torch.from_numpy(np.array(arrays[f])).to(dev)
            if arrays.get(f) is not None else None)
        for f in ChainStepIn._fields})
