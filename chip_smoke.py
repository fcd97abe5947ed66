#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is caught):

  1. The card (nvidia-smi name and power limit), torch and CUDA versions.
  2. Build every CUDA source of the port from this checkout (one nvcc per
     source, started together); print the seconds and the ptxas
     register/spill lines; no kernel may have a stack frame.
  3. Every kernel against its plain PyTorch form ON THE CARD at the main
     paths' shapes (T = 64, default geometry), every output element
     equal; times from CUDA events over many launches after warm-up,
     kernel and plain form, and device time per launch from
     torch.profiler.  Every kernel updates state in place (window_walk
     its cache, predictor and bank leaves, fast_forward_walk its
     predictor and L1 leaves, chain_classify the floor table), so it runs
     on copies and the plain form on the originals, and its written
     leaves must be the copies' own tensors:
       * window_walk at P = 0: random operands, seeded collision operands
         (operands.seeded_window_arrays) and a window captured from the
         port's own radix64 run (timed: K = 16, P = 0);
       * window_walk at P = 12 (fan-out replay on and off): random and
         seeded collision operands with a pending [P, T] bank and
         banking windows captured from the port's own radix64 chain-12
         run (timed: K = 16, P = 12);
       * chain_classify, one replay iteration from the state's own arrays
         (head gathers, directory-row gathers, classify) against the
         plain chain_step: state-level seeded sets
         (operands.random_chain_step_arrays) at H = 1024, a
         non-power-of-two H and a colliding H = 4 with the fan-out replay
         and the DRAM queue model each on and off, and iterations
         captured at run_chain_step's inputs in the port's own radix64
         chain-12 run (timed, device time per launch);
       * fast_forward_walk at F = 64: seeded operand sets (engage and
         decline, the run-ahead bound crossed and not, repeated lines,
         predictor-slot collisions, models disabled, tiles that are not
         candidates, no predictor, miss_chain 12) and analytic rounds
         captured from the port's own radix64 span-1000 run, some with
         engaging tiles (timed on a captured round);
       * window_walk at the wide width K = 64, P = 0 and P = 12: random
         and seeded collision operands and wide windows captured from the
         fast-forward runs (timed: K = 64, P = 0 and P = 12).
     Each kernel's bound counts the bytes the function needs on the
     timed operands (chain_bytes, ff_bytes, window_bytes).  The chain
     wrapper must make one device allocation per call and the
     fast-forward wrapper none beyond its three fresh outputs (the
     allocator's request counts); the chain wrapper's host time is split
     into carving its output views, its checks and its allocation.
  4. The golden shapes radix8 and fft8 at miss_chain 0 against
     tests/data/chain_off_golden.json, exactly; radix8 at miss_chain 12
     (86 engine rounds, completion 8,686.6 ns).
  5. The chain-off main path at full width: ``gen_radix(64,
     keys_per_tile=2048, radix=256, seed=0)`` on the default config —
     all_done, round_ctr 13838, completion 243,651.8 ns, window-kernel
     launches == ctr_window.
  6. The chain-replay paths at full width, miss_chain 12: the radix64
     trace at a cut depth, ``gen_radix(64, keys_per_tile=512, radix=256,
     seed=0)`` (round_ctr 740, completion 133,200.8 ns; the full depth,
     2,181 rounds and 245,006.6 ns, is held on the card by
     tests/test_torch_card_paths.py) and ``gen_fft(64,
     points_per_tile=64, writeback=True)`` (round_ctr 377, completion
     60,677.0 ns, 1,897 fan-outs served in-pass, 17 fallbacks).
     chain_classify launches == 12 x chain passes (round_ctr - ctr_window
     - ctr_complex - ctr_conflict), window launches == ctr_window.  An
     untimed second fft64 run records, at run_chain_step's inputs, its
     first replay iterations that serve a fan-out, and chain_classify is
     held against its plain form on each of them.
  7. Profiled stretches of the chain-off and the chain-12 radix64 runs
     (torch.profiler; 4 quanta and 1 quantum, continuing phase 3's
     simulations), and of the radix64_ff_span run (4 quanta, continuing
     phase 3's fast-forward simulation; it runs after phase 8's
     radix64_ff_span path, whose unprofiled wall it is held against):
     device busy time per round, held against the unprofiled wall time
     per round of phases 5, 6 and 8, kernels and host polls per round,
     and each kernel's share.
  8. The fast-forward paths at full width, ``tpu/fast_forward = 8``
     (wide rounds of 64 events):
       * radix64_ff_span: the radix64 trace at miss_chain 0 and a
         run-ahead span of 1000 ns (round_ctr 13353, completion
         243,687.4 ns, ctr_ff 1804, ctr_ffq 356, ff_events 211211,
         icount 1,844,224); fast_forward_walk launches > 0 and at least
         the analytic rounds that engaged, window_walk launches ==
         ctr_window, no chain_classify launch;
       * fft64_ff_span: the fft64 trace at miss_chain 12, span 1000, the
         path on which all three kernels run (round_ctr 293, completion
         61,719.4 ns, 1,737 fan-outs, 13 fallbacks);
       * fft64_ff: the same at span 0, where only the wide rounds run
         (round_ctr 278, completion 62,347.6 ns, ctr_ff 73, ctr_ffq 29,
         ff_events 28817, 1,737 fan-outs, 14 fallbacks, no
         fast_forward_walk launch).
     Chain passes (round_ctr - ctr_window - ctr_complex - ctr_conflict
     - engaged analytic rounds) == ctr_resolve at miss_chain 12 and 0 at
     0; chain_classify launches == 12 x chain passes.

Before each path of phases 4 to 6 and 8 every kernel's launch count is
set to 0, and it is read just after; each full-width path prints its
peak device memory and the part of it above what was held before the
path started.  The last two lines of standard output are the
``kernels`` JSON object and the ``ok`` JSON object.  Without a CUDA
device, or without the port's sources beside this file, the script exits
non-zero and prints no result.
"""

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# Values pinned by BENCH_r06's radix64, fft64 and radix8_pallas rows
# (all-integer engine, so they are device-independent); the JAX package
# on the CPU gives BENCH_r06's values for radix64_chain12 (2,181 rounds,
# 245,006.6 ns), fft64, radix64_ff and fft64_ff.
FULL_KEYS = 2048
FULL_ROUND_CTR = 13838
FULL_COMPLETION_PS = 243_651_800
CHAIN = 12
# Phase 6 runs radix64_chain12 at a cut depth, so that the script with
# phase 8 ends well inside its time limit on a slow host (the full depth
# took 176-251 s of host-bound wall on an NVIDIA H100 80GB HBM3 at
# 700 W; tests/test_torch_card_paths.py holds it on the card).  The JAX
# package on the CPU gives these values for gen_radix(64,
# keys_per_tile=512, radix=256, seed=0) at miss_chain 12.
CHAIN_KEYS = 512
CHAIN_CUT_ROUND_CTR = 740
CHAIN_CUT_COMPLETION_PS = 133_200_800
FFT_ROUND_CTR = 377
FFT_COMPLETION_PS = 60_677_000
FFT_FANOUT_SERVED = 1897
FFT_FALLBACK = 17
FFT_CAPTURED = 8                   # fft64 fan-out iterations held in phase 6
RADIX8_CHAIN_ROUND_CTR = 86
# radix8 chain 12's completion, as the JAX package computes it on the CPU
# (tests/test_torch_chain_sim.py holds the port to it).
RADIX8_CHAIN_COMPLETION_PS = 8_686_600
# Fast-forward paths (phase 8), as the JAX package computes them on the
# CPU; the span-0 fft64 row is BENCH_r06's fft64_ff.
FF = 8
FF_SPAN_NS = 1000
FULL_ICOUNT = 1_844_224
FF_SPAN_CTRS = dict(round_ctr=13353, ctr_window=6548, ctr_complex=3614,
                    ctr_conflict=2787, ctr_resolve=1711, ctr_quantum=547,
                    ctr_ff=1804, ctr_ffq=356, ff_events=211211)
FF_SPAN_COMPLETION_PS = 243_687_400
FFT_FF_SPAN_CTRS = dict(round_ctr=293, ctr_window=92, ctr_complex=27,
                        ctr_conflict=90, ctr_resolve=70, ctr_quantum=31,
                        ctr_ff=79, ctr_ffq=29, ff_events=38318)
FFT_FF_SPAN_COMPLETION_PS = 61_719_400
FFT_FF_SPAN_FALLBACK = 13
FFT_FF_CTRS = dict(round_ctr=278, ctr_window=97, ctr_complex=27,
                   ctr_conflict=86, ctr_resolve=68, ctr_quantum=32,
                   ctr_ff=73, ctr_ffq=29, ff_events=28817)
FFT_FF_COMPLETION_PS = 62_347_600
FFT_FF_FANOUT_SERVED = 1737
FFT_FF_FALLBACK = 14
HBM_BYTES_PER_S = 3.35e12          # H100 SXM peak memory rate


T_START = time.perf_counter()


def stamp(what: str) -> None:
    """Elapsed seconds since the script started, after a phase."""
    print(f"[{time.perf_counter() - T_START:.1f} s] {what}", flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    raise SystemExit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def time_cuda(fn, iters: int, warmup: int) -> float:
    """Milliseconds per call: CUDA events around ``iters`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def max_abs_err(a, b) -> int:
    import torch
    check(a.dtype == b.dtype and a.shape == b.shape,
          f"dtype/shape mismatch {a.dtype}{tuple(a.shape)} vs "
          f"{b.dtype}{tuple(b.shape)}")
    if a.numel() == 0:
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item())


def nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def chain_bytes(params, si, head, out) -> int:
    """Bytes one replay iteration (head gathers, directory-row gathers,
    classify) must move on these operands: each input element the
    function reads, once, and every output element (``head`` and
    ``out`` are the plain step's result on ``si``).

    Every tile reads its head index, stop flag, bank count and base, and
    the delta and local cost of its head slot (both feed outputs of
    every row); an active tile also its head's request word.  Every
    tile's directory row is read (its probe and victim scan feed the way
    of every row), each distinct flat set's A words once, and the W
    sharer words of the way each row picks, each distinct (set, way)
    once (a combining member's own-bit word is among them: a member's
    way is its representative's, in the same row).  Periods: each tile
    its L1 side (the fill time of every row) and, without a magic
    network, its network period; each distinct home its directory
    period and network period; each served owner leg's owner its L2 and
    network periods; each fan-out row its core period; with the DRAM
    queue model off each tile its L2 period.  Writes: every ChainHead
    and ChainOut element, and with the queue model off each floor-table
    slot a served row wins (line and time), once."""
    import torch
    T = params.num_tiles
    A = params.directory.associativity
    W = si.dir_sharers.shape[0] // A
    net = params.net_memory.model != "magic"
    i64 = torch.int64

    def distinct(*keys):
        return torch.unique(torch.stack([k.to(i64) for k in keys]),
                            dim=1).shape[1]

    moved = T * (4 + 1 + 4 + 8)                     # head, stopped, count,
    #                                                 base
    moved += T * (8 + 8) + 8 * int(head.active.sum())  # delta, extra, req
    moved += 8 * A * distinct(head.fidx)             # directory rows
    moved += 8 * W * distinct(head.fidx, out.way)    # sharer words
    moved += 4 * T * (1 + int(net))                  # L1 and network
    moved += 4 * distinct(head.home) * (1 + int(net))  # dir, network
    legs = out.owner[out.owner_leg]
    if legs.numel():
        moved += 4 * distinct(legs) * (1 + int(net))  # L2, network
    moved += 4 * int(out.fan_go.sum()) if out.inv_bool is not None else 0
    if out.ftbl is not None:
        moved += 4 * T                               # L2 period
        won = head.hidx[out.serve_all]
        moved += 16 * (distinct(won) if won.numel() else 0)
    return moved + nbytes(head) + nbytes(t for f, t in zip(out._fields, out)
                                          if f != "ftbl")


def ff_bytes(params, vp, fi) -> int:
    """Bytes one fast-forward call must move on these operands: each input
    element the function reads, once, and every output element it
    writes.

    A candidate tile (tile_active, models enabled) reads its committed
    prefix: per event the valid flag and the op, and what its kind uses
    (COMPUTE: arg, arg2 and addr; BRANCH: arg and addr when there is a
    predictor; MEM: addr, and arg2 only where the tile engages, for the
    icount row).  Each COMPUTE or MEM event probes one set row of L1I or
    L1D (A words, once per distinct row), each branch one predictor
    entry (once per distinct slot).  The walk stops at the first event
    it does not commit.  Where the clock before that event has reached
    the run-ahead bound, nothing of the event is needed (the clock is
    the sum of the committed events' times); otherwise the event is
    ineligible, and the walk reads its valid flag, its op where it is
    valid, and the address and probed row of a COMPUTE or MEM.  Every
    tile reads its active flag and clock (a declined tile returns the
    clock); a candidate reads three periods.  Every tile writes its
    clock, n_ret and 12 counters; an engaged tile also writes each word
    it touches and each predictor entry it updates, once.  The whole
    cache arrays are not counted: the function needs only the rows it
    probes."""
    import torch
    from graphite_tpu_torch.engine.kernels import window as kwin
    fp = kwin.ff_price(params, vp, fi)
    T, F = fi.addr.shape
    dev = fi.addr.device
    cand = fi.tile_active & fi.models_enabled
    comm = fp.commit0                        # a prefix; only candidates
    n_c = comm.sum(1)
    pre = fi.clock + torch.where(comm, fp.dt, 0).sum(1)
    at_bound = pre >= kwin._ff_bound(params, vp, fi.boundary)
    stop = (cand & ~at_bound & (n_c < F))[:, None] \
        & (torch.arange(F, device=dev)[None] == n_c[:, None])
    rows = torch.arange(T, device=dev)[:, None].expand(T, F)

    def count(mask):
        return int(mask.sum())

    def distinct(mask, *keys):
        return torch.unique(torch.stack([k[mask].to(torch.int64)
                                         for k in keys]), dim=1).shape[1]

    is_mem = fp.is_rd | fp.is_wr
    eng = comm & fp.engage[:, None]
    # is_comp / is_mem are false on an invalid event (its op reads as NOP).
    probe_i = (comm | stop) & fp.is_comp
    probe_d = (comm | stop) & is_mem
    moved = count(comm | stop)                              # valid_ev
    moved += 4 * count(comm | (stop & fi.valid_ev))         # op
    moved += 8 * count(comm & fp.is_comp)                   # arg, arg2
    moved += 4 * count(eng & is_mem)                        # arg2
    moved += 8 * count(probe_i | probe_d)                   # addr
    moved += distinct(probe_i, rows, fp.pI.set_idx) \
        * params.l1i.associativity * 8
    moved += distinct(probe_d, rows, fp.pD.set_idx) \
        * params.l1d.associativity * 8
    if fp.bidx is not None:
        moved += (4 + 8) * count(comm & fp.is_br)           # arg, addr
        moved += distinct(comm & fp.is_br, rows, fp.bidx)   # table entries
    moved += T * (1 + 8) + count(cand) * 3 * 4 + 8 + 1 + 4  # active, clock,
    #                                  periods, boundary, enable, stamp base
    moved += T * (8 + 4 + 12 * 8)                           # clock, n_ret, ctr
    moved += 8 * (distinct(eng & fp.is_comp, rows, fp.pI.set_idx, fp.pI.way)
                  + distinct(eng & is_mem, rows, fp.pD.set_idx, fp.pD.way))
    if fp.bidx is not None:
        moved += distinct(eng & fp.is_br, rows, fp.bidx)
    return moved


def window_bytes(params, vp, wi, out) -> int:
    """Bytes one window walk must move on these operands: each input
    element the function reads, once, and every output element it writes
    (``out`` is the plain form's result on ``wi``).

    Every event's arg and arg2 are read (each event's spawn landing and
    child are outputs).  A tile that retires (active, models enabled)
    examines its retired prefix and the event that stops it, unless the
    window had closed before that event (the clock past the bound, or at
    P > 0 the chain out of room or credit): per examined event its valid
    flag, its op where valid, and its address where its kind uses it
    (COMPUTE, MEM, STALL and SYNC; BRANCH with a predictor).  A COMPUTE
    probes its L1I row, a MEM its L1D row, and either one its L2 row where
    the L1 does not serve it (A words a row, each distinct row once); a
    branch reads its predictor entry (once per distinct slot); at P > 0 a
    tile whose examined events probe reads its pending bank slots.  Every
    tile reads its active flag, clock and core period (and its id and
    network period without a magic network); a retiring tile its L1I,
    L1D and L2 periods; at P > 0 every tile its bank count and relative
    clock, a retiring one its bank head.  Writes: the fresh outputs, each
    distinct word the retired prefix touches, each fill word (and its
    round-robin pointer, read and written, on a miss under round_robin),
    each predictor entry written, each banked element's three words.
    The whole cache arrays are not counted: the function needs only the
    rows it probes."""
    import torch
    from graphite_tpu_torch.engine import cache as cachemod
    from graphite_tpu_torch.engine.kernels import window as kwin
    from graphite_tpu_torch.isa import EventOp
    T, K = wi.addr.shape
    dev = wi.addr.device
    P = params.miss_chain
    act = wi.tile_active & wi.models_enabled
    n = out.n_ret.to(torch.int64)
    ar = torch.arange(K, device=dev)
    ret = ar[None] < n[:, None]
    if P > 0:
        wb = kwin._spanned_bound(params, vp, wi.boundary)
        nm = out.mq_count
        still = torch.where(nm == 0, out.clock < wb,
                            (out.chain_rel < vp.quantum_ps) & (nm < P))
    else:
        still = out.clock < wi.boundary
    stop = (act & still & (n < K))[:, None] & (ar[None] == n[:, None])
    exam = ret | stop
    op = torch.where(wi.valid_ev & exam, wi.meta[0], int(EventOp.NOP))
    is_comp = op == EventOp.COMPUTE
    is_rd, is_wr = op == EventOp.MEM_READ, op == EventOp.MEM_WRITE
    is_mem = is_rd | is_wr
    is_br = op == EventOp.BRANCH
    is_time = (op == EventOp.STALL) | (op == EventOp.SYNC)
    bp = params.core.bp_type != "none"
    line = wi.addr >> (params.line_size.bit_length() - 1)

    def probe(word, rr, cp):
        return cachemod.probe(cachemod.CacheArrays(word=word, rr_ptr=rr),
                              line, cp.num_sets)

    pI = probe(wi.l1i_word, wi.l1i_rr, params.l1i)
    pD = probe(wi.l1d_word, wi.l1d_rr, params.l1d)
    p2 = probe(wi.l2_word, wi.l2_rr, params.l2)
    l1_ok = pD.hit & (is_rd | (pD.state >= cachemod.M))
    mem_l2 = is_mem & ~l1_ok & p2.hit & (is_rd | (p2.state == cachemod.M))
    comp_l2 = is_comp & ~pI.hit & p2.hit
    rows = torch.arange(T, device=dev)[:, None].expand(T, K)
    bidx = wi.addr % params.core.bp_size

    def count(mask):
        return int(mask.sum())

    def distinct(mask, *keys):
        return torch.unique(torch.stack([k[mask].to(torch.int64)
                                         for k in keys]), dim=1).shape[1]

    moved = count(exam) + 4 * count(wi.valid_ev & exam)      # valid, op
    moved += 8 * T * K                                        # arg, arg2
    moved += 8 * count(is_mem | is_comp | is_time | (is_br & bp))  # addr
    moved += 8 * (params.l1i.associativity
                  * distinct(is_comp, rows, pI.set_idx)
                  + params.l1d.associativity
                  * distinct(is_mem, rows, pD.set_idx)
                  + params.l2.associativity * distinct(
                      (is_comp & ~pI.hit) | (is_mem & ~l1_ok), rows,
                      p2.set_idx))
    if bp:
        moved += distinct(is_br, rows, bidx)                  # entries read
    moved += T * (1 + 8 + 4) + 3 * 4 * count(act) + 8 + 1 + 4
    if params.net_user.model != "magic":
        moved += T * (4 + 4)                                  # id, period
    moved += T * (8 + 4 + 12 * 8) + T * K * (1 + 4 + 8)       # fresh
    r = ret & act[:, None]
    for hit_touch, fill, pr, cp in (
            (r & is_comp & pI.hit, r & comp_l2, pI, params.l1i),
            (r & is_mem & l1_ok, r & mem_l2, pD, params.l1d)):
        moved += 8 * (distinct(hit_touch, rows, pr.set_idx, pr.way)
                      + count(fill))
        if cp.replacement == "round_robin":
            moved += 8 * count(fill & ~pr.hit)
    moved += 8 * distinct(r & (mem_l2 | comp_l2), rows, p2.set_idx, p2.way)
    if bp:
        moved += distinct(r & is_br, rows, bidx)              # entries set
    if P > 0:
        probes = (is_mem | is_comp).any(1) & act
        npend = torch.clamp(wi.mq_count - wi.mq_head, min=0)
        moved += 8 * int(npend[probes].sum())                 # pending
        moved += T * (4 + 8) + 4 * count(act)                 # count, rel,
        #                                                       head
        moved += T * (8 + 4)                                  # fresh
        moved += 24 * int((out.mq_count - wi.mq_count).sum())  # banked
    return moved


def compare(kind, got, ref, label) -> int:
    """Every output field of a kernel against its plain form."""
    err = 0
    for f in ref._fields:
        a, b = getattr(got, f), getattr(ref, f)
        check((a is None) == (b is None), f"{kind}: field {f} presence")
        if b is None:
            continue
        e = max_abs_err(a, b)
        check(e == 0, f"{kind} kernel != plain on {label}, field {f} "
                      f"(max abs err {e})")
        err = max(err, e)
    return err


class Recorder:
    """Wraps a kernel entry point of the engine so that a run hands over
    (clones of) the operands of its first calls that ``keep`` accepts."""

    def __init__(self, module, name, keep, limit):
        self.module, self.name = module, name
        self.orig = getattr(module, name)
        self.keep, self.limit, self.seen = keep, limit, []

    def __enter__(self):
        def rec(params, vp, operands, *rest):
            if len(self.seen) < self.limit and self.keep(operands):
                self.seen.append(clone_operands(operands))
            return self.orig(params, vp, operands, *rest)
        setattr(self.module, self.name, rec)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def device_ms(fn, kernel: str, launches: int = 100):
    """Device time per launch of ``kernel`` over ``launches`` calls of
    ``fn`` (torch.profiler), or None where the profiler sees no device
    events."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        for _ in range(launches):
            fn()
        torch.cuda.synchronize()
    total, n = 0.0, 0
    for evt in prof.key_averages():
        if kernel in evt.key and evt.device_type is not None \
                and "cuda" in str(evt.device_type).lower():
            total += getattr(evt, "self_device_time_total",
                             getattr(evt, "self_cuda_time_total", 0.0))
            n += evt.count
    return total / 1e3 / n if n else None


def host_ms(fn, iters: int = 2000) -> float:
    """Milliseconds of host time per call of ``fn`` (no device wait)."""
    for _ in range(50):
        fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


def allocations(fn) -> int:
    """Device allocation requests one call of ``fn`` makes."""
    import torch
    fn()
    key = "allocation.all.allocated"
    before = torch.cuda.memory_stats()[key]
    fn()
    return torch.cuda.memory_stats()[key] - before


def device_kernels(fn) -> int:
    """Device kernels one call of ``fn`` launches (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(evt.count for evt in prof.key_averages()
               if evt.device_type is not None
               and "cuda" in str(evt.device_type).lower()
               and getattr(evt, "self_device_time_total",
                           getattr(evt, "self_cuda_time_total", 0.0)))


def clone_operands(nt):
    return type(nt)(*[t.clone() if t is not None else None for t in nt])


def step_pair(kchain, p, v, si, H):
    """chain_classify's fused kernel and the plain step on the same
    operands: the kernel writes the floor table in place, so it runs on
    a clone of it and the plain step on ``si``.  The floor table the
    kernel returns must be the clone itself."""
    work = si._replace(ftbl=None if si.ftbl is None else si.ftbl.clone())
    got = kchain.chain_step_cuda(p, v, work, H)
    ref = kchain.chain_step(p, v, si, H)
    if work.ftbl is not None:
        check(got[1].ftbl.data_ptr() == work.ftbl.data_ptr(),
              "chain_classify: the floor table is not the operand's own")
    return got, ref


def compare_step(got, ref, label) -> int:
    """Every ChainHead and ChainOut field of the fused kernel against the
    plain step (the floor table included where the queue model is off)."""
    return max(compare("chain_classify", got[0], ref[0], label),
               compare("chain_classify", got[1], ref[1], label))


def ff_pair(kwin, p, v, fi):
    """fast_forward_walk's kernel and its plain form on the same operands:
    the kernel updates its operands in place, so it runs on a clone and
    the plain form on ``fi``; the leaves it writes must be the clone's
    own tensors."""
    work = clone_operands(fi)
    got = kwin.fast_forward_walk_cuda(p, v, work)
    ref = kwin.fast_forward_walk(p, v, fi)
    for f in kwin.FF_INPLACE_FIELDS:
        check(getattr(got, f).data_ptr() == getattr(work, f).data_ptr(),
              f"fast_forward_walk: leaf {f} is not the operand's own tensor")
    return got, ref


def ff_times(kwin, p, v, fi, iters=200, warmup=20):
    """One fast_forward_walk case, every launch from the span-start state
    of ``fi`` (which no launch touches): the wrapper's time per call
    (CUDA events over calls on fresh copies of the leaves the kernel
    writes), the kernel's device time per launch (torch.profiler, each
    launch after a device copy that restores those leaves) and the plain
    form's time."""
    def fresh():
        return fi._replace(**{f: getattr(fi, f).clone()
                              for f in kwin.FF_INPLACE_FIELDS})

    pool = iter([fresh() for _ in range(iters + warmup)])
    ms = time_cuda(lambda: kwin.fast_forward_walk_cuda(p, v, next(pool)),
                   iters=iters, warmup=warmup)
    del pool
    work = fresh()

    def restore_and_launch():
        for f in kwin.FF_INPLACE_FIELDS:
            getattr(work, f).copy_(getattr(fi, f))
        kwin.fast_forward_walk_cuda(p, v, work)

    dev = device_ms(restore_and_launch, "fast_forward_walk_kernel")
    plain = time_cuda(lambda: kwin.fast_forward_walk(p, v, fi), iters=50,
                      warmup=5)
    return ms, dev, plain


def walk_pair(kwin, p, v, wi, T):
    """window_walk's kernel and its plain form on the same operands: the
    kernel updates its operands in place, so it runs on a clone and the
    plain form on ``wi``.  The leaves the kernel writes must be the
    clone's own tensors."""
    work = clone_operands(wi)
    got = kwin.window_walk_cuda(p, v, work, T)
    ref = kwin.window_walk(p, v, wi, T)
    for f in kwin.INPLACE_FIELDS:
        if getattr(work, f) is not None:
            check(getattr(got, f).data_ptr() == getattr(work, f).data_ptr(),
                  f"window_walk: leaf {f} is not the operand's own tensor")
    return got, ref


def walk_times(kwin, p, v, wi, T, iters=200, warmup=20):
    """One window_walk case, every launch from the window-start state of
    ``wi`` (which no launch touches): the wrapper's time per call (CUDA
    events over calls on fresh copies of the leaves the kernel writes),
    the kernel's device time per launch (torch.profiler; each launch
    after a device copy that restores those leaves, so the rows it reads
    are warm in L2, as in the engine where the round's other ops have
    just touched them), the plain form's time and the plain result."""
    written = [f for f in kwin.INPLACE_FIELDS if getattr(wi, f) is not None]

    def fresh():
        return wi._replace(**{f: getattr(wi, f).clone() for f in written})

    pool = iter([fresh() for _ in range(iters + warmup)])
    ms = time_cuda(lambda: kwin.window_walk_cuda(p, v, next(pool), T),
                   iters=iters, warmup=warmup)
    del pool
    work = fresh()

    def restore_and_launch():
        for f in written:
            getattr(work, f).copy_(getattr(wi, f))
        kwin.window_walk_cuda(p, v, work, T)

    dev = device_ms(restore_and_launch, "window_walk_kernel")
    big = wi.addr.shape[1] > 16 and p.miss_chain > 0
    plain = time_cuda(lambda: kwin.window_walk(p, v, wi, T),
                      iters=20 if big else 50, warmup=3 if big else 5)
    return ms, dev, plain, kwin.window_walk(p, v, wi, T)


def peak_reset() -> int:
    """Restart the peak-memory count; return the bytes allocated now."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def peak_line(held: int) -> str:
    """The peak since :func:`peak_reset`, and its part above ``held``."""
    import torch
    peak = torch.cuda.max_memory_allocated()
    return (f"max_memory_allocated {peak} B ({peak - held} B above the "
            f"{held} B held before the run)")


def fmt_ms(ms) -> str:
    return "not measured" if ms is None else f"{ms:.6f} ms"


def profile_stretch(psim, wall_ms, card, label, names, quanta):
    """torch.profiler over ``quanta`` quantum steps of a simulation
    already past its start-up: device time per round against the
    unprofiled ``wall_ms`` per round, kernels and host polls per round,
    and each named kernel's time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from graphite_tpu_torch.engine.quantum import megarun
    params = psim.params
    torch.cuda.synchronize()
    q0 = int(psim.state.ctr_quantum.item())
    r0 = int(psim.state.round_ctr.item())
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        psim.state = megarun(params, psim.state, psim.trace, quanta,
                             vp=psim.vp)
        torch.cuda.synchronize()
        pwall = time.perf_counter() - t0
    pr = max(int(psim.state.round_ctr.item()) - r0, 1)
    pq = int(psim.state.ctr_quantum.item()) - q0
    dev_us, n_kernels, ppolls = 0.0, 0, 0
    per = {n: [0.0, 0] for n in names}
    for evt in prof.key_averages():
        if evt.key == "aten::_local_scalar_dense":     # one per .item()
            ppolls += evt.count
        t = getattr(evt, "self_device_time_total",
                    getattr(evt, "self_cuda_time_total", 0.0))
        if t and evt.device_type is not None \
                and "cuda" in str(evt.device_type).lower():
            dev_us += t
            n_kernels += evt.count
            for n in names:
                if n in evt.key:
                    per[n][0] += t
                    per[n][1] += evt.count
    if dev_us <= 0:
        print(f"profile {label}: {pq} quanta, {pr} rounds in {pwall:.3f} s "
              f"wall; device time not measured (the profiler saw no "
              f"device events), host polls {ppolls}")
        return
    busy_ms = dev_us / 1e3 / pr
    shares = ", ".join(
        f"{n} {per[n][0] / 1e3:.3f} ms over {per[n][1]} launches "
        f"({per[n][0] / 1e3 / max(per[n][1], 1):.6f} ms each, "
        f"{per[n][0] / dev_us:.4f} of device time)" for n in names)
    # The profiler's host overhead stretches the wall of this stretch, so
    # the busy share is device time per round over the unprofiled wall
    # time per round of the same run.
    print(f"profile {label}: {pq} quanta, {pr} rounds in {pwall:.3f} s "
          f"profiled wall ({1e3 * pwall / pr:.4f} ms/round); device busy "
          f"{dev_us / 1e3:.3f} ms ({busy_ms:.6f} ms/round, "
          f"{busy_ms / wall_ms:.4f} of the unprofiled {wall_ms:.4f} "
          f"ms/round, idle share {1 - busy_ms / wall_ms:.4f}), {n_kernels} "
          f"device kernels ({n_kernels / pr:.1f} per round), host polls "
          f"{ppolls} ({ppolls / pr:.2f} per round); {shares} on {card}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this test needs a card")
    sys.path.insert(0, HERE)
    try:
        import graphite_tpu_torch
    except ImportError as e:
        fail(f"the port's sources are not beside chip_smoke.py ({e})")
    check(os.path.dirname(os.path.dirname(os.path.abspath(
        graphite_tpu_torch.__file__))) == HERE,
        "graphite_tpu_torch was imported from outside this checkout")
    check("jax" not in sys.modules, "jax must not be imported")

    from graphite_tpu_torch import load_config
    from graphite_tpu_torch.engine import core as kcore
    from graphite_tpu_torch.engine import resolve as kres
    from graphite_tpu_torch.engine.core import window_operands
    from graphite_tpu_torch.engine.kernels import build
    from graphite_tpu_torch.engine.kernels import chain as kchain
    from graphite_tpu_torch.engine.kernels.dispatch import (COUNTS,
                                                            reset_counts)
    from graphite_tpu_torch.engine.kernels.operands import (
        chain_step_in_from_numpy, ff_in_from_numpy, random_chain_step_arrays,
        random_ff_arrays, random_window_arrays, seeded_window_arrays,
        window_in_from_numpy)
    from graphite_tpu_torch.engine.kernels import window as kwin
    from graphite_tpu_torch.engine.quantum import next_boundary
    from graphite_tpu_torch.engine.sim import Simulator
    from graphite_tpu_torch.engine.vparams import variant_params
    from graphite_tpu_torch.events import synth
    from graphite_tpu_torch.params import SimParams

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()

    # ---- 1. the card
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, devices {count}")

    # ---- 2. build every kernel from this checkout
    t0 = time.perf_counter()
    info = build.build_all()
    stamp("phase 2: kernels built")
    print(f"build: {len(info)} source(s) in "
          f"{time.perf_counter() - t0:.3f} s")
    for name, rec in info.items():
        lines = [ln.strip() for ln in rec["ptxas"]
                 if "registers" in ln or "spill" in ln]
        for ln in lines:
            print(f"build: {name}: {ln}")
    # No kernel indexes a per-thread array at runtime: ptxas gives none of
    # them a stack (local memory) at all.
    for name in build.SOURCES:
        frames = [ln for ln in info[name]["ptxas"]
                  if "bytes stack frame" in ln]
        check(bool(frames) and all(
            ln.strip().startswith("0 bytes stack frame") for ln in frames),
            f"{name}: ptxas reports a stack frame: {frames}")

    # ---- 3. kernels vs plain forms on the card, at the main paths' shapes
    def config(**over):
        cfg = load_config()
        for k, v in over.items():
            cfg.set(k, v)
        return SimParams.from_config(cfg)

    params = config()                                  # default config
    cparams = config(**{"tpu/miss_chain": CHAIN})
    vp, cvp = variant_params(params), variant_params(cparams)
    T, K = params.num_tiles, params.block_events
    H = max(1024, 16 * T)
    trace = synth.gen_radix(64, keys_per_tile=FULL_KEYS, radix=256, seed=0)

    # window_walk, P = 0
    cases = [(f"random seed {seed}", window_in_from_numpy(
        random_window_arrays(params, K, seed), dev))
        for seed in range(8)]
    cases += [(f"seeded collisions seed {seed}", window_in_from_numpy(
        seeded_window_arrays(params, K, seed), dev)) for seed in range(4)]
    cap_sim = Simulator(params, trace, device=dev)
    cap_sim.run(max_steps=2)
    st = cap_sim.state._replace(boundary=next_boundary(params,
                                                       cap_sim.state))
    # The walk's operands alias the simulation's state, which phase 7
    # continues: keep a copy, which no launch touches (walk_pair and
    # walk_times launch on copies of it).
    _, captured = window_operands(params, st, cap_sim.trace)
    captured = clone_operands(captured)
    cases.append(("captured radix64 window", captured))
    err_w = 0
    for label, wi in cases:
        got, ref = walk_pair(kwin, params, vp, wi, T)
        torch.cuda.synchronize()
        err_w = max(err_w, compare("window_walk", got, ref, label))
    print(f"kernel window_walk P=0: {len(cases)} operand sets, every output "
          f"leaf equal to the plain form, the written leaves the operands' "
          f"own (max abs err {err_w})")

    def walk_line(label, p, v, wi):
        ms, dev_ms, plain, ref = walk_times(kwin, p, v, wi, T)
        moved = window_bytes(p, v, wi, ref)
        bound = moved / HBM_BYTES_PER_S * 1e3
        print(f"kernel window_walk {label}: {ms:.6f} ms/launch (wrapper), "
              f"device {fmt_ms(dev_ms)} per launch, plain {plain:.6f} ms, "
              f"bound {bound:.9f} ms ({moved} bytes the function reads and "
              f"writes on these operands, at "
              f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s), library call: none on "
              f"{card}")
        return ms, plain, bound

    ms0, _, _ = walk_line("K=16 P=0", params, vp, captured)

    # Operands of the port's own radix64 chain-12 run: banking windows
    # (a pending bank, or elements banked by this window) and replay
    # iterations with at least one active head.
    csim = Simulator(cparams, trace, device=dev)
    def any_head(si):
        return bool(((~si.stopped) & (si.head < si.stop_hi)).any())

    with Recorder(kcore.kwindow, "run_window",
                  lambda wi: bool((wi.mq_count > wi.mq_head).any()), 6) \
            as rw, Recorder(kres.kchain, "run_chain_step", any_head, 24) \
            as rc:
        csim.run(max_steps=2)
    check(len(rw.seen) == 6 and len(rc.seen) == 24,
          f"captured {len(rw.seen)} banking windows and {len(rc.seen)} "
          f"replay iterations from the chain-12 run")

    # window_walk, P = 12
    cases = []
    for fan in (True, False):
        p = config(**{"tpu/miss_chain": CHAIN, "tpu/fanout_replay": fan})
        v = variant_params(p)
        for seed in range(4):
            cases.append((p, v, f"random fanout={fan} seed {seed}",
                          window_in_from_numpy(
                              random_window_arrays(p, K, seed), dev)))
        for seed in range(4):
            cases.append((p, v, f"seeded collisions fanout={fan} seed "
                                f"{seed}", window_in_from_numpy(
                                    seeded_window_arrays(p, K, seed), dev)))
    cases += [(cparams, cvp, f"captured radix64 chain-12 window {i}", wi)
              for i, wi in enumerate(rw.seen)]
    for p, v, label, wi in cases:
        got, ref = walk_pair(kwin, p, v, wi, T)
        torch.cuda.synchronize()
        err_w = max(err_w, compare("window_walk", got, ref, label))
    print(f"kernel window_walk P={CHAIN}: {len(cases)} operand sets, every "
          f"output leaf equal to the plain form, the written leaves the "
          f"operands' own (max abs err {err_w})")
    ms_w, plain_w, bound_w = walk_line(f"K=16 P={CHAIN}", cparams, cvp,
                                       rw.seen[-1])

    # chain_classify: one replay iteration from the state's own arrays
    cases = []
    for fan in (True, False):
        for queue in (True, False):
            p = config(**{"tpu/miss_chain": CHAIN, "tpu/fanout_replay": fan,
                          "dram/queue_model/enabled": queue})
            v = variant_params(p)
            for h, seeds in ((H, range(3)), (1000, range(3, 4)),
                             (4, range(4, 6))):
                for seed in seeds:
                    cases.append((p, v, h, f"fanout={fan} queue={queue} "
                                           f"H={h} seed {seed}",
                                  chain_step_in_from_numpy(
                                      random_chain_step_arrays(p, h, seed),
                                      dev)))
    cases += [(cparams, cvp, H, f"captured radix64 chain-12 iteration {i}",
               si) for i, si in enumerate(rc.seen)]
    err_c = 0
    for p, v, h, label, si in cases:
        got, ref = step_pair(kchain, p, v, si, h)
        torch.cuda.synchronize()
        err_c = max(err_c, compare_step(got, ref, label))
    print(f"kernel chain_classify: {len(cases)} operand sets "
          f"({len(rc.seen)} captured), every ChainHead and ChainOut field "
          f"and the in-place floor table equal to the plain step (max abs "
          f"err {err_c})")
    si12 = rc.seen[0]
    ms_c = time_cuda(lambda: kchain.chain_step_cuda(cparams, cvp, si12, H),
                     iters=500, warmup=50)
    dev_c = device_ms(lambda: kchain.chain_step_cuda(cparams, cvp, si12, H),
                      "chain_classify_kernel")
    plain_c = time_cuda(lambda: kchain.chain_step(cparams, cvp, si12, H),
                        iters=50, warmup=5)
    # What the wrapper's host time is made of: carving the output views
    # from the one buffer, and the operand checks.
    step = kchain.chain_step_entry(cparams, cvp, H, si12.dir_sharers.shape[0]
                                   // cparams.directory.associativity)
    buf = torch.empty(step.layout.nbytes, dtype=torch.uint8, device=dev)
    n_views = sum(t is not None for nt in step.layout.carve(buf, None)
                  for t in nt)
    carve_ms = host_ms(lambda: step.layout.carve(buf, None))
    check_ms = host_ms(lambda: (step.bind_pass(si12), step.check(si12)))
    alloc_ms = host_ms(lambda: torch.empty(step.layout.nbytes,
                                           dtype=torch.uint8, device=dev))
    n_alloc = allocations(lambda: kchain.chain_step_cuda(cparams, cvp, si12,
                                                         H))
    check(n_alloc == 1, f"chain_classify: the wrapper makes {n_alloc} "
                        f"device allocations per call, not one")
    print(f"kernel chain_classify: one device allocation per call; "
          f"wrapper parts on the host, per call: "
          f"carving {n_views} output views {carve_ms:.6f} ms, the operand "
          f"checks {check_ms:.6f} ms, the one allocation {alloc_ms:.6f} ms")
    n_fold = device_kernels(lambda: kchain.chain_rows(
        si12.dir_word, si12.dir_sharers, kchain.chain_head(
            cparams, si12.mq_req, si12.mq_delta, si12.mq_extra, si12.head,
            si12.stopped, si12.stop_hi, si12.base, H).fidx))
    print(f"kernel chain_classify: the plain chain_head + chain_rows launch "
          f"{n_fold} device kernels on these operands (the gathers the "
          f"pass issued before its classify kernel until the step was "
          f"fused)")
    moved_c = chain_bytes(cparams, si12,
                          *kchain.chain_step(cparams, cvp, si12, H))
    bound_c = moved_c / HBM_BYTES_PER_S * 1e3
    print(f"kernel chain_classify: {ms_c:.6f} ms/launch (wrapper), device "
          f"{fmt_ms(dev_c)} per launch, plain {plain_c:.6f} ms, bound "
          f"{bound_c:.9f} ms ({moved_c} bytes the function reads and "
          f"writes on these operands, at {HBM_BYTES_PER_S / 1e12:.2f} "
          f"TB/s), library call: none on {card}")

    # fast_forward_walk at F = 64
    fparams = config(**{"tpu/fast_forward": FF,
                        "tpu/fast_forward_span": FF_SPAN_NS})
    fvp = variant_params(fparams)
    F = kcore._ff_width(fparams)
    check(F == 64, f"fast-forward width {F} != 64")
    cases = []
    for label, over in (
            ("span 1000", {}), ("span 0", {"tpu/fast_forward_span": 0}),
            ("no predictor", {"branch_predictor/type": "none"}),
            ("chain 12 span 300", {"tpu/miss_chain": CHAIN,
                                   "tpu/fast_forward_span": 300})):
        p = config(**{"tpu/fast_forward": FF,
                      "tpu/fast_forward_span": FF_SPAN_NS, **over})
        v = variant_params(p)
        for seed in range(8):
            cases.append((p, v, f"{label} seed {seed}", ff_in_from_numpy(
                random_ff_arrays(p, F, seed), dev)))
    # Operands of the port's own radix64 span-1000 run: analytic rounds
    # with engaging tiles, and wide windows the walk retires past one
    # narrow round's capacity.
    fsim = Simulator(fparams, trace, device=dev)
    with Recorder(kcore.kwindow, "run_fast_forward",
                  lambda fi: bool(kwin.ff_price(fparams, fvp, fi)
                                  .engage.any()), 6) as rff, \
            Recorder(kcore.kwindow, "run_window",
                     lambda wi: bool((kwin.window_walk(
                         fparams, fvp, wi, T).n_ret > K).any()), 4) as rww:
        for step in range(1, 17):
            if len(rff.seen) == 6 and len(rww.seen) == 4:
                break
            fsim.run(max_steps=step)
    check(len(rff.seen) >= 1 and len(rww.seen) >= 1,
          f"captured {len(rff.seen)} engaging analytic rounds and "
          f"{len(rww.seen)} wide windows from the radix64 span-1000 run")
    cases += [(fparams, fvp, f"captured radix64 analytic round {i}", fi)
              for i, fi in enumerate(rff.seen)]
    err_f, engaged_f = 0, 0
    for p, v, label, fi in cases:
        got, ref = ff_pair(kwin, p, v, fi)
        torch.cuda.synchronize()
        err_f = max(err_f, compare("fast_forward_walk", got, ref, label))
        engaged_f += int((ref.n_ret > 0).sum().item())
    check(engaged_f > 0, "no tile engaged in any fast_forward_walk set")
    print(f"kernel fast_forward_walk: {len(cases)} operand sets "
          f"({len(rff.seen)} captured), {engaged_f} engaged tiles, every "
          f"output field equal to the plain form, the written leaves the "
          f"operands' own (max abs err {err_f})")
    fi_cap = rff.seen[-1]
    ms_f, dev_f, plain_f = ff_times(kwin, fparams, fvp, fi_cap)
    # clock, n_ret and the counters: no clone of the state it updates
    n_alloc = allocations(lambda: kwin.fast_forward_walk_cuda(
        fparams, fvp, clone_operands(fi_cap)))
    n_clone = allocations(lambda: clone_operands(fi_cap))
    check(n_alloc - n_clone == 3,
          f"fast_forward_walk: the wrapper makes {n_alloc - n_clone} device "
          f"allocations per call, not 3 (its fresh outputs)")
    moved_f = ff_bytes(fparams, fvp, fi_cap)
    bound_f = moved_f / HBM_BYTES_PER_S * 1e3
    print(f"kernel fast_forward_walk: {ms_f:.6f} ms/launch (wrapper), "
          f"device {fmt_ms(dev_f)} per launch, plain "
          f"{plain_f:.6f} ms, bound {bound_f:.9f} ms "
          f"({moved_f} bytes the function reads and writes on these "
          f"operands, at {HBM_BYTES_PER_S / 1e12:.2f} TB/s), library call: "
          f"none on {card}")

    # window_walk at the wide width K = 64, P = 0 and P = 12
    fcparams = config(**{"tpu/fast_forward": FF,
                         "tpu/fast_forward_span": FF_SPAN_NS,
                         "tpu/miss_chain": CHAIN})
    fcvp = variant_params(fcparams)
    fft = synth.gen_fft(64, points_per_tile=64, writeback=True)
    fcsim = Simulator(fcparams, fft, device=dev)
    # Wide rounds fill the bank in one round (cap_w = 1), so a wide
    # window starts on an empty bank: keep windows that bank elements.
    with Recorder(kcore.kwindow, "run_window",
                  lambda wi: bool((kwin.window_walk(
                      fcparams, fcvp, wi, T).mq_count > wi.mq_count).any()),
                  4) as rwc:
        for step in range(1, 17):
            if len(rwc.seen) == 4:
                break
            fcsim.run(max_steps=step)
    check(len(rwc.seen) >= 1, "captured no wide banking window from the "
                              "fft64 chain-12 fast-forward run")
    cases = []
    for label, over in (("P=0", {}), ("P=12", {"tpu/miss_chain": CHAIN}),
                        ("P=12 no fan-out", {"tpu/miss_chain": CHAIN,
                                             "tpu/fanout_replay": False})):
        p = config(**{"tpu/fast_forward": FF, **over})
        v = variant_params(p)
        for gen in (random_window_arrays, seeded_window_arrays):
            for seed in range(3):
                cases.append((p, v, f"K=64 {label} {gen.__name__} seed "
                                    f"{seed}", window_in_from_numpy(
                                        gen(p, F, seed), dev)))
    cases += [(fparams, fvp, f"captured radix64 wide window {i}", wi)
              for i, wi in enumerate(rww.seen)]
    cases += [(fcparams, fcvp, f"captured fft64 wide banking window {i}", wi)
              for i, wi in enumerate(rwc.seen)]
    for p, v, label, wi in cases:
        check(wi.addr.shape[1] == 64, f"{label}: K != 64")
        got, ref = walk_pair(kwin, p, v, wi, T)
        torch.cuda.synchronize()
        err_w = max(err_w, compare("window_walk", got, ref, label))
    print(f"kernel window_walk K=64: {len(cases)} operand sets, every output "
          f"leaf equal to the plain form, the written leaves the operands' "
          f"own (max abs err {err_w})")
    walk_line("K=64 P=0", fparams, fvp, rww.seen[-1])
    walk_line(f"K=64 P={CHAIN}", fcparams, fcvp, rwc.seen[-1])
    # The other fast-forward simulation and the recorded operands are done
    # with; phase 7 continues cap_sim, csim and fsim.
    del fcsim, rff, rww, rwc, cases, fi_cap, wi, got, ref

    stamp("phase 3: kernels held against their plain forms")

    def round_ctrs(st):
        return {f: int(getattr(st, f).item()) for f in (
            "ctr_quantum", "ctr_window", "ctr_complex", "ctr_conflict",
            "ctr_resolve", "round_ctr", "ctr_ff", "ctr_ffq", "ff_events")}

    # ---- 4. golden shapes, exactly
    gold = json.load(open(os.path.join(HERE, "tests", "data",
                                       "chain_off_golden.json")))
    for name, gtrace in (
            ("radix8", synth.gen_radix(num_tiles=8, keys_per_tile=64,
                                       radix=16, seed=3)),
            ("fft8", synth.gen_fft(num_tiles=8, points_per_tile=64))):
        sim = Simulator(config(**{"general/total_cores": 8,
                                  "tpu/miss_chain": 0}), gtrace, device=dev)
        reset_counts()
        s = sim.run(max_steps=256)
        g = gold[name]
        check(bool(s.done.all()), f"{name}: not all done")
        check(s.completion_time_ps == g["completion_time_ps"],
              f"{name}: completion {s.completion_time_ps} != "
              f"{g['completion_time_ps']}")
        check(s.clock.tolist() == g["clock"], f"{name}: clocks differ")
        for f, want in g["round_ctrs"].items():
            got = int(getattr(sim.state, f).item())
            check(got == want, f"{name}.{f}: {got} != golden {want}")
        for k, want in g["counters"].items():
            check(s.counters[k].tolist() == want, f"{name}.{k} differs")
        check(COUNTS["window_walk"] == int(sim.state.ctr_window.item()),
              f"{name}: kernel launches != ctr_window")
        print(f"golden {name}: exact (round_ctr "
              f"{int(sim.state.round_ctr.item())}, completion "
              f"{s.completion_time_ps} ps, {COUNTS['window_walk']} "
              f"kernel launches)")
    sim = Simulator(config(**{"general/total_cores": 8,
                              "tpu/miss_chain": CHAIN}),
                    synth.gen_radix(num_tiles=8, keys_per_tile=64, radix=16,
                                    seed=3), device=dev)
    reset_counts()
    s = sim.run(max_steps=256)
    c8 = round_ctrs(sim.state)
    passes8 = c8["round_ctr"] - c8["ctr_window"] - c8["ctr_complex"] \
        - c8["ctr_conflict"]
    check(bool(s.done.all()), "radix8 chain 12: not all done")
    check(c8["round_ctr"] == RADIX8_CHAIN_ROUND_CTR
          and s.completion_time_ps == RADIX8_CHAIN_COMPLETION_PS,
          f"radix8 chain 12: round_ctr {c8['round_ctr']}, completion "
          f"{s.completion_time_ps} != {RADIX8_CHAIN_ROUND_CTR}, "
          f"{RADIX8_CHAIN_COMPLETION_PS}")
    check(COUNTS["chain_classify"] == CHAIN * passes8
          and COUNTS["window_walk"] == c8["ctr_window"],
          "radix8 chain 12: kernel launches do not match the round counts")
    print(f"radix8 chain 12: exact (round_ctr {c8['round_ctr']}, completion "
          f"{s.completion_time_ps} ps, {passes8} chain passes, "
          f"chain_classify launches {COUNTS['chain_classify']}, "
          f"window_walk launches {COUNTS['window_walk']})")

    stamp("phase 4: golden shapes")

    # ---- 5. the chain-off main path at full width
    held = peak_reset()
    sim = Simulator(params, trace, device=dev)
    reset_counts()
    t0 = time.perf_counter()
    s = sim.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches0 = COUNTS["window_walk"]
    ctr = round_ctrs(sim.state)
    rounds = ctr["round_ctr"]
    check(bool(s.done.all()), "radix64: not all done")
    check(rounds == FULL_ROUND_CTR, f"radix64: round_ctr {rounds} != "
                                    f"{FULL_ROUND_CTR}")
    check(s.completion_time_ps == FULL_COMPLETION_PS,
          f"radix64: completion {s.completion_time_ps} != "
          f"{FULL_COMPLETION_PS}")
    check(launches0 == ctr["ctr_window"] and launches0 > 0,
          f"radix64: kernel launches {launches0} != ctr_window "
          f"{ctr['ctr_window']}")
    check(COUNTS["chain_classify"] == 0, "radix64: chain kernel launched")
    mips = s.total_instructions / wall / 1e6
    print(f"radix64 keys_per_tile={FULL_KEYS}: all_done, round_ctr "
          f"{rounds}, completion {s.completion_time_ps / 1000:.1f} ns, "
          f"{s.total_instructions} instructions; counters {ctr}")
    print(f"radix64: wall {wall:.3f} s, {rounds / wall:.2f} rounds/s, "
          f"{1e3 * wall / rounds:.4f} ms/round, simulated MIPS {mips:.6f}, "
          f"{peak_line(held)}, "
          f"window_walk launches {launches0}, "
          f"kernel share {launches0 * ms0 / 1e3 / wall:.4f} of wall "
          f"(launches x {ms0:.6f} ms) on {card}")
    wall_ms0 = 1e3 * wall / rounds

    stamp("phase 5: chain-off radix64")

    # ---- 6. the chain-replay paths at full width
    def chain_run(label, ctrace, want_rounds, want_ps):
        held = peak_reset()
        sim = Simulator(cparams, ctrace, device=dev)
        reset_counts()
        t0 = time.perf_counter()
        s = sim.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        lw, lc = COUNTS["window_walk"], COUNTS["chain_classify"]
        c = round_ctrs(sim.state)
        r = c["round_ctr"]
        passes = r - c["ctr_window"] - c["ctr_complex"] - c["ctr_conflict"]
        check(bool(s.done.all()), f"{label}: not all done")
        check(r == want_rounds, f"{label}: round_ctr {r} != {want_rounds}")
        check(s.completion_time_ps == want_ps,
              f"{label}: completion {s.completion_time_ps} != {want_ps}")
        check(lw == c["ctr_window"] and lw > 0,
              f"{label}: window_walk launches {lw} != ctr_window "
              f"{c['ctr_window']}")
        check(lc == CHAIN * passes and lc > 0,
              f"{label}: chain_classify launches {lc} != {CHAIN} x "
              f"{passes} chain passes")
        fan = int(s.counters["chain_fanout_served"].sum())
        fb = int(s.counters["chain_fallback"].sum())
        mips = s.total_instructions / wall / 1e6
        print(f"{label}: all_done, round_ctr {r}, completion "
              f"{s.completion_time_ps / 1000:.1f} ns, {s.total_instructions} "
              f"instructions, chain_fanout_served {fan}, chain_fallback "
              f"{fb}; counters {c}, chain passes {passes}")
        print(f"{label}: wall {wall:.3f} s, {r / wall:.2f} rounds/s, "
              f"{1e3 * wall / r:.4f} ms/round, simulated MIPS {mips:.6f}, "
              f"{peak_line(held)}, "
              f"window_walk launches {lw}, chain_classify launches {lc}, "
              f"kernel share {(lw * ms_w + lc * ms_c) / 1e3 / wall:.4f} of "
              f"wall on {card}")
        return lw, lc, fan, fb, 1e3 * wall / r

    lw12, lc12, _, _, wall_ms12 = chain_run(
        f"radix64_chain12 keys_per_tile={CHAIN_KEYS}",
        synth.gen_radix(64, keys_per_tile=CHAIN_KEYS, radix=256, seed=0),
        CHAIN_CUT_ROUND_CTR, CHAIN_CUT_COMPLETION_PS)
    _, _, fan, fb, _ = chain_run("fft64", fft, FFT_ROUND_CTR,
                                 FFT_COMPLETION_PS)
    check(fan == FFT_FANOUT_SERVED and fb == FFT_FALLBACK,
          f"fft64: chain_fanout_served {fan} / chain_fallback {fb} != "
          f"{FFT_FANOUT_SERVED} / {FFT_FALLBACK}")

    # The radix run serves no fan-out, so phase 3's captured iterations
    # leave the fan-out rank, the [KF, T] invalidation masks and the
    # max-hop legs to the seeded operands.  An untimed second fft64 run,
    # stopped once it has them, records its first iterations that serve a
    # fan-out (the plain form picks them), and the kernel is held against
    # the plain form on each.
    with Recorder(kres.kchain, "run_chain_step",
                  lambda si: bool(kchain.chain_step(
                      cparams, cvp, si, H)[1].fan_go.any()),
                  FFT_CAPTURED) as rf:
        fsim2 = Simulator(cparams, fft, device=dev)
        for step in range(1, FFT_ROUND_CTR):
            if len(rf.seen) == FFT_CAPTURED or bool(fsim2.state.done.all()):
                break
            fsim2.run(max_steps=step)
        del fsim2
    check(len(rf.seen) == FFT_CAPTURED,
          f"fft64: captured {len(rf.seen)} fan-out iterations, want "
          f"{FFT_CAPTURED}")
    served = 0
    for i, si in enumerate(rf.seen):
        got, ref = step_pair(kchain, cparams, cvp, si, H)
        torch.cuda.synchronize()
        err_c = max(err_c, compare_step(
            got, ref, f"captured fft64 fan-out iteration {i}"))
        served += int(ref[1].fan_go.sum().item())
    sif = rf.seen[0]
    dev_cf = device_ms(lambda: kchain.chain_step_cuda(cparams, cvp, sif, H),
                       "chain_classify_kernel")
    print(f"kernel chain_classify: {len(rf.seen)} fft64 iterations with "
          f"{served} fan-outs served, every output field equal to the plain "
          f"form (max abs err {err_c}); device {fmt_ms(dev_cf)} per launch "
          f"on the first (fan-out rank, masks and their barrier live) on "
          f"{card}")

    stamp("phase 6: chain-12 radix64 and fft64")

    # ---- 7. where the time goes: profiled stretches of both radix64 runs
    # The stretches continue phase 3's two simulations, which are eight
    # quanta past their start.  They are short: the profiler's own cost
    # grows with the events it records, and a chain-12 round issues about
    # ten times the host ops of a chain-off round.
    profile_stretch(cap_sim, wall_ms0, card, "radix64", ["window_walk"],
                    quanta=4)
    stamp("phase 7: chain-off stretch profiled")
    profile_stretch(csim, wall_ms12, card, "radix64_chain12",
                    ["window_walk", "chain_classify"], quanta=1)
    stamp("phase 7: chain-12 stretch profiled")

    # ---- 8. the fast-forward paths at full width
    def ff_run(label, p, ctrace, want, want_ps):
        held = peak_reset()
        sim = Simulator(p, ctrace, device=dev)
        reset_counts()
        t0 = time.perf_counter()
        s = sim.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        lw, lc = COUNTS["window_walk"], COUNTS["chain_classify"]
        lf = COUNTS["fast_forward_walk"]
        engaged = COUNTS["ff_engaged"]
        c = round_ctrs(sim.state)
        r = c["round_ctr"]
        # Every engine round is a window round, a complex slot, a conflict
        # round, a chain pass (one per resolve pass at P > 0) or an
        # analytic round in which some tile engaged.
        passes = r - c["ctr_window"] - c["ctr_complex"] - c["ctr_conflict"] \
            - engaged
        check(bool(s.done.all()), f"{label}: not all done")
        for k, v in want.items():
            check(c[k] == v, f"{label}: {k} {c[k]} != {v}")
        check(s.completion_time_ps == want_ps,
              f"{label}: completion {s.completion_time_ps} != {want_ps}")
        check(lw == c["ctr_window"] and lw > 0,
              f"{label}: window_walk launches {lw} != ctr_window "
              f"{c['ctr_window']}")
        check(lf >= engaged, f"{label}: fast_forward_walk launches {lf} < "
                             f"{engaged} engaged analytic rounds")
        check(passes == (c["ctr_resolve"] if p.miss_chain else 0),
              f"{label}: {passes} chain passes from the round identity, "
              f"ctr_resolve {c['ctr_resolve']}")
        check(lc == p.miss_chain * passes,
              f"{label}: chain_classify launches {lc} != {p.miss_chain} x "
              f"{passes} chain passes")
        fan = int(s.counters["chain_fanout_served"].sum())
        fb = int(s.counters["chain_fallback"].sum())
        mips = s.total_instructions / wall / 1e6
        print(f"{label}: all_done, round_ctr {r}, completion "
              f"{s.completion_time_ps / 1000:.1f} ns, {s.total_instructions} "
              f"instructions, chain_fanout_served {fan}, chain_fallback "
              f"{fb}; counters {c}, analytic rounds that engaged {engaged}, "
              f"chain passes {passes}")
        print(f"{label}: wall {wall:.3f} s, {r / wall:.2f} rounds/s, "
              f"{1e3 * wall / r:.4f} ms/round, simulated MIPS {mips:.6f}, "
              f"{peak_line(held)}, "
              f"window_walk launches {lw}, chain_classify launches {lc}, "
              f"fast_forward_walk launches {lf} on {card}")
        return s, lf, lc, fan, fb, 1e3 * wall / r

    s, lf_span, lc_f, _, _, wall_ms_ff = ff_run(
        "radix64_ff_span", fparams, trace, FF_SPAN_CTRS,
        FF_SPAN_COMPLETION_PS)
    check(lf_span > 0 and lc_f == 0,
          f"radix64_ff_span: fast_forward_walk launches {lf_span}, "
          f"chain_classify launches {lc_f}")
    check(s.total_instructions == FULL_ICOUNT,
          f"radix64_ff_span: icount {s.total_instructions} != {FULL_ICOUNT}")
    stamp("phase 8: radix64_ff_span")
    # Phase 7's fast-forward stretch, held against the run just made.
    profile_stretch(fsim, wall_ms_ff, card, "radix64_ff_span",
                    ["window_walk", "fast_forward_walk"], quanta=4)
    del fsim
    stamp("phase 7: fast-forward stretch profiled")
    _, lf, lc, fan, fb, _ = ff_run("fft64_ff_span", fcparams, fft,
                                FFT_FF_SPAN_CTRS, FFT_FF_SPAN_COMPLETION_PS)
    check(lf > 0 and lc > 0 and fan == FFT_FF_FANOUT_SERVED
          and fb == FFT_FF_SPAN_FALLBACK,
          f"fft64_ff_span: fast_forward_walk launches {lf}, chain_classify "
          f"launches {lc}, chain_fanout_served {fan} / chain_fallback {fb} "
          f"!= {FFT_FF_FANOUT_SERVED} / {FFT_FF_SPAN_FALLBACK}")
    stamp("phase 8: fft64_ff_span")
    s, lf, lc, fan, fb, _ = ff_run(
        "fft64_ff", config(**{"tpu/fast_forward": FF,
                              "tpu/miss_chain": CHAIN}),
        fft, FFT_FF_CTRS, FFT_FF_COMPLETION_PS)
    check(lf == 0 and lc > 0 and fan == FFT_FF_FANOUT_SERVED
          and fb == FFT_FF_FALLBACK,
          f"fft64_ff: fast_forward_walk launches {lf} (the leg is dormant at "
          f"span 0), chain_fanout_served {fan} / chain_fallback {fb} != "
          f"{FFT_FF_FANOUT_SERVED} / {FFT_FF_FALLBACK}")
    check(s.to_dict()["ff_rounds"] == FFT_FF_CTRS["ctr_ff"],
          "fft64_ff: summary ff_rounds")
    stamp("phase 8: fft64_ff")

    kernels = [{
        "name": "window_walk",
        "route": "cuda",
        "source": "graphite_tpu_torch/engine/kernels/csrc/window_walk.cu",
        "replaces": "graphite_tpu/engine/kernels/window.py:163",
        "launches": lw12,
        "max_abs_err": err_w,
        "ms": ms_w,
        "plain_ms": plain_w,
        "bound_ms": bound_w,
        "bound_by": "bytes",
        "library_ms": None,
    }, {
        "name": "chain_classify",
        "route": "cuda",
        "source": "graphite_tpu_torch/engine/kernels/csrc/chain_classify.cu",
        "replaces": "graphite_tpu/engine/kernels/chain.py:134",
        "launches": lc12,
        "max_abs_err": err_c,
        "ms": ms_c,
        "plain_ms": plain_c,
        "bound_ms": bound_c,
        "bound_by": "bytes",
        "library_ms": None,
    }, {
        "name": "fast_forward_walk",
        "route": "cuda",
        "source": "graphite_tpu_torch/engine/kernels/csrc/"
                  "fast_forward_walk.cu",
        "replaces": "graphite_tpu/engine/kernels/window.py:779",
        "launches": lf_span,
        "max_abs_err": err_f,
        "ms": ms_f,
        "plain_ms": plain_f,
        "bound_ms": bound_f,
        "bound_by": "bytes",
        "library_ms": None,
    }]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
