"""PyTorch port, the ThreadScheduler (more trace streams than tiles)
against the JAX package on the CPU, every SimState leaf equal (tolerance
0, the seat and stream-store leaves and the round counters included):

  * ``schedule_rotate`` on seeded states, op by op against the JAX
    function (tests/torch_jax_ref.eager): every tile has one role, so
    each state reaches every give-up cause (done, YIELD, THREAD_START
    before the SPAWN, an expired preemption quantum) and every veto (a
    parked SH / EX / IFETCH request, a non-empty miss chain, a tile with
    no waiting stream), twice in a row so the outgoing streams' keys
    order the next rotation;
  * the resolvers' stream-store branches on seeded states with S > T:
    ``resolve_barrier``'s store wakes, ``resolve_cond``'s store bound
    and store wakes (strict and in replay mode), ``resolve_join``'s
    seat merge, ``resolve_start``'s seat gather, and the whole
    ``resolve`` pass;
  * the window round and the complex slot under seats: each tile reads
    its seated stream's trace row, the window cache refreshes when its
    seat changed, DONE lands in the stream's ``done_at``, YIELD marks
    the seat, SPAWN children with stream ids >= T land;
  * whole runs through ``Simulator.run``, ``run_simulation`` and ``cli
    run``: the shapes of tests/test_scheduler.py (its one-stream-per-
    tile shape is in tests/test_torch_sync_runs.py), and
    ``gen_threads_oversubscribed(16)`` at T = 8 under miss_chain 0, 12
    and ``tpu/fast_forward = 8`` (span 1000 ns, where the analytic leg
    and the wide rounds stay off: ``ctr_ff == 0``), a cond pair sharing
    tiles (store wakes), lock contention with a short preemption quantum
    (sync parks rotated out), children seated before their SPAWN, and
    the system events at S = 2T;
  * the JAX package's three refusals, raised by both packages on the
    same inputs: fewer streams than tiles, more than
    ``general/max_threads_per_core`` streams a tile, CAPI messaging with
    more streams than tiles.

The case in ``LIVE`` runs the JAX package live (the cheapest, which
reaches the barrier store wakes); the others, the cond store wakes, the
THREAD_START rotation, the chain replay beside the seats and SPAWN
children >= T among them, hold the JAX package's recorded pins
(tests/torch_jax_ref.py); so do the rotation's and the store resolvers'
outputs, one rotation case live (tests/torch_jax_ref.check_outputs).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from graphite_tpu.config import load_config as jax_load_config
from graphite_tpu.engine import core as jcore
from graphite_tpu.engine import quantum as jquantum
from graphite_tpu.engine import resolve as jresolve
from graphite_tpu.engine import state as jstate
from graphite_tpu.engine.sim import Simulator as JaxSimulator
from graphite_tpu.engine.state import TraceArrays as JTraceArrays
from graphite_tpu.engine.vparams import variant_params as jax_vp
from graphite_tpu.events import synth as jax_synth
from graphite_tpu.events.schema import Trace as JTrace
from graphite_tpu.events.schema import TraceBuilder as JaxTraceBuilder
from graphite_tpu.params import SimParams as JaxSimParams
from graphite_tpu_torch import cli, convert, load_config
from graphite_tpu_torch.engine import core as tcore
from graphite_tpu_torch.engine import quantum as tquantum
from graphite_tpu_torch.engine import resolve as tresolve
from graphite_tpu_torch.engine import state as tstate
from graphite_tpu_torch.engine.sim import Simulator, run_simulation
from graphite_tpu_torch.engine.state import (
    PEND_BARRIER, PEND_CBC, PEND_COND, PEND_CSIG, PEND_EX_REQ, PEND_IFETCH,
    PEND_JOIN, PEND_MUTEX, PEND_NONE, PEND_SH_REQ, PEND_START)
from graphite_tpu_torch.engine.vparams import variant_params
from graphite_tpu_torch.events import synth as tsynth
from graphite_tpu_torch.events.schema import Trace, TraceBuilder
from graphite_tpu_torch.isa import EventOp
from graphite_tpu_torch.params import SimParams

import torch_jax_ref as ref

MODULE = "test_torch_scheduler"
T = 8
S = 20             # streams of the seeded states: 3 on tiles 0-3, 2 on 4-7
MAX_STEPS = 256
Q = 10_000_000     # the default thread_scheduling/switch_quantum, in ps


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params(over=None, tiles=T):
    cj, ct = jax_load_config(), load_config()
    for c in (cj, ct):
        c.set("general/total_cores", tiles)
        c.set("general/max_threads_per_core", 3)
        for k, v in (over or {}).items():
            c.set(k, v)
    return JaxSimParams.from_config(cj), SimParams.from_config(ct)


def _jax_state(jp, leaves):
    """The JAX SimState holding ``leaves`` (a flat numpy dict)."""
    st = jstate.make_state(jp, has_capi=False, num_streams=S)
    out = {}
    for f, v in zip(st._fields, st):
        if isinstance(v, tuple) and hasattr(v, "_fields"):
            out[f] = type(v)(**{g: jnp.asarray(leaves[f"{f}.{g}"])
                                for g in v._fields})
        else:
            a = np.asarray(leaves[f])
            if f == "dir_sharers":
                a = a.view(np.uint64)
            out[f] = jnp.asarray(a)
    return type(st)(**out)


def _fresh_leaves(jp):
    return {k: np.array(v) for k, v in convert.leaves_to_numpy(
        jax.device_get(jstate.make_state(jp, has_capi=False,
                                         num_streams=S))).items()}


def _compare(jout, tout):
    ref.assert_leaves_equal(convert.leaves_to_numpy(jax.device_get(jout)),
                            convert.state_to_numpy(tout))


def _leaves(jst):
    return convert.leaves_to_numpy(jax.device_get(jst))


def _pinned(tleaves, jax_leaves, tp, arrays, live=False):
    """The port's flat leaves ``tleaves`` held to the JAX function's
    (``jax_leaves()``, run op by op where ``live``, else their pin:
    tests/torch_jax_ref.check_outputs) on the same inputs ``arrays``."""
    ref.check_outputs(MODULE, tleaves, jax_leaves, {"params": repr(tp)},
                      arrays, live)


def _own_streams(t):
    return np.arange(t, S, T)


def _seat_leaves(jp, rng):
    """Seats, a stream store and the context leaves around them: each
    tile seats one of its own streams (s % T == tile), the store holds
    every stream's saved context (stale for the seated ones), keys are
    unique."""
    lv = _fresh_leaves(jp)
    seat = np.asarray([rng.choice(_own_streams(t)) for t in range(T)],
                      np.int32)
    lv.update(
        seat_stream=seat,
        boundary=np.asarray(50_000_000, np.int64),
        seat_since=(50_000_000 - rng.integers(0, Q, size=T)).astype(np.int64),
        clock=rng.integers(30, 60, size=T).astype(np.int64) * 1_000_000,
        cursor=rng.integers(0, 40, size=T).astype(np.int32),
        pend_addr=rng.integers(0, 3, size=T).astype(np.int64),
        pend_issue=rng.integers(0, 40, size=T).astype(np.int64) * 1_000_000,
        pend_aux=rng.integers(0, 4, size=T).astype(np.int32),
        pend_extra=rng.integers(0, 9, size=T).astype(np.int64) * 1000,
        spawned_at=np.where(rng.random(S) < 0.5, -1,
                            rng.integers(0, 40, size=S) * 1_000_000),
        strm_cursor=rng.integers(0, 40, size=S).astype(np.int32),
        strm_clock=rng.integers(0, 80, size=S).astype(np.int64) * 1_000_000,
        strm_pend_kind=rng.choice(
            [PEND_NONE, PEND_MUTEX, PEND_BARRIER, PEND_COND, PEND_JOIN,
             PEND_START], size=S).astype(np.int32),
        strm_pend_addr=rng.integers(0, 3, size=S).astype(np.int64),
        strm_pend_issue=rng.integers(0, 40, size=S).astype(np.int64)
        * 1_000_000,
        strm_pend_aux=rng.integers(0, 4, size=S).astype(np.int32),
        strm_pend_extra=rng.integers(0, 9, size=S).astype(np.int64) * 1000,
        strm_done=rng.random(S) < 0.2,
        strm_key=(rng.permutation(S) * 3 + 7).astype(np.int64))
    return lv


ROLES = ("done", "yield", "unspawned", "expired", "mem_park", "chain",
         "no_wait", "stay")
GIVES_UP = ("done", "yield", "unspawned", "expired")


def _rotate_leaves(jp, seed):
    """A state in which each tile has one role of ``ROLES``: the four
    give-up causes, the three vetoes (each on a tile that would give up
    otherwise) and a tile that keeps its stream."""
    rng = np.random.default_rng(seed)
    lv = _seat_leaves(jp, rng)
    roles = rng.permutation(ROLES)
    seat = lv["seat_stream"]
    done = np.zeros(T, bool)
    yld = np.zeros(T, bool)
    kind = rng.choice([PEND_NONE, PEND_MUTEX, PEND_BARRIER, PEND_COND,
                       PEND_JOIN], size=T).astype(np.int32)
    mq = np.zeros(T, np.int32)
    expired = np.zeros(T, bool)
    for t, role in enumerate(roles):
        waiting = [s for s in _own_streams(t) if s != seat[t]]
        lv["strm_done"][waiting] = role == "no_wait"
        if role == "done":
            done[t] = True
        elif role == "yield":
            yld[t] = True
        elif role == "unspawned":
            kind[t] = PEND_START
            lv["spawned_at"][seat[t]] = -1
        elif role == "expired":
            expired[t] = True
        elif role == "mem_park":
            kind[t] = rng.choice([PEND_SH_REQ, PEND_EX_REQ, PEND_IFETCH])
            expired[t] = True
            done[t] = rng.random() < 0.5
        elif role == "chain":
            mq[t] = rng.integers(1, 12)
            yld[t] = True
        elif role == "no_wait":
            yld[t] = True
    lv["seat_since"] = np.where(expired, 50_000_000 - Q
                                - rng.integers(0, 3, size=T) * 1000,
                                lv["seat_since"]).astype(np.int64)
    lv.update(done=done, seat_yield=yld, pend_kind=kind, mq_count=mq)
    return lv, roles


@pytest.mark.parametrize("chain,seed", [(c, s) for c in (0, 12)
                                        for s in range(3)])
def test_schedule_rotate_matches_jax(chain, seed):
    """Each give-up cause rotates its seat to the tile's lowest-key
    waiting stream, each veto holds it; a second rotation a quantum
    later orders the outgoing streams behind the rest."""
    jp, tp = _params({"tpu/miss_chain": chain})
    lv, roles = _rotate_leaves(jp, 31 * seed + chain)
    tst = convert.state_from_numpy(tp, lv, "cpu")
    tleaves = {}
    for k in range(2):
        tst = tquantum.schedule_rotate(tp, tst, variant_params(tp))
        tleaves[k] = convert.state_to_numpy(tst)
        if k == 0:
            moved = tst.seat_stream.numpy() != lv["seat_stream"]
            np.testing.assert_array_equal(
                moved, [r in GIVES_UP for r in roles])
            tst = tst._replace(boundary=tst.boundary + Q)

    def jax_leaves():
        jst = _jax_state(jp, lv)
        out = {}
        for k in range(2):
            jst = ref.eager(jquantum.schedule_rotate)(jp, jst, jax_vp(jp))
            out[k] = _leaves(jst)
            jst = jst._replace(boundary=jst.boundary + Q)
        return out

    _pinned(tleaves, jax_leaves, tp, {**lv, "fn": np.array("rotate")},
            live=(chain, seed) == (0, 0))


def _sched_parked_leaves(jp, seed, kinds):
    """Seats and a store parked on ``kinds`` with operands that make each
    resolver's store cases occur: barriers with their count reached,
    conds with seated tokens and stored waiters, children done in a seat
    or in the store, spawned and unspawned seated streams."""
    rng = np.random.default_rng(seed)
    lv = _seat_leaves(jp, rng)
    pk = rng.choice(kinds, size=T).astype(np.int32)
    spk = rng.choice(kinds, size=S).astype(np.int32)
    issue = rng.integers(0, 40, size=T).astype(np.int64) * 250_000
    aux = rng.integers(0, S, size=T).astype(np.int32)    # children
    aux[pk == PEND_COND] = rng.integers(0, 3, size=int((pk == PEND_COND)
                                                       .sum()))
    aux[pk == PEND_BARRIER] = rng.integers(1, 4, size=int(
        (pk == PEND_BARRIER).sum()))
    saux = rng.integers(1, 4, size=S).astype(np.int32)
    lv.update(
        pend_kind=pk, pend_issue=issue, pend_aux=aux,
        done=(pk == PEND_NONE) & (rng.random(T) < 0.3),
        clock=issue + rng.integers(0, 3, size=T) * 500_000,
        strm_pend_kind=spk, strm_pend_aux=saux,
        strm_pend_issue=rng.integers(0, 40, size=S).astype(np.int64)
        * 250_000,
        strm_clock=rng.integers(0, 40, size=S).astype(np.int64) * 250_000,
        done_at=rng.integers(0, 40, size=S).astype(np.int64) * 250_000,
        lock_holder=np.where(rng.random(64) < 0.3,
                             rng.integers(1, T + 1, size=64),
                             0).astype(np.int32),
        lock_free_at=rng.integers(0, 40, size=64).astype(np.int64)
        * 250_000,
        bar_count=rng.integers(0, 4, size=16).astype(np.int32),
        bar_time=rng.integers(0, 40, size=16).astype(np.int64) * 250_000,
        models_enabled=np.asarray(bool(rng.random() < 0.8)))
    return lv


RESOLVERS = {
    "barrier": ([PEND_BARRIER, PEND_NONE], "resolve_barrier"),
    "cond": ([PEND_COND, PEND_CSIG, PEND_CBC, PEND_MUTEX, PEND_NONE],
             "resolve_cond"),
    "join": ([PEND_JOIN, PEND_NONE], "resolve_join"),
    "start": ([PEND_START, PEND_NONE], "resolve_start"),
}


@pytest.mark.parametrize("name,seed,replay", [
    (n, s, False) for n in sorted(RESOLVERS) for s in range(3)]
    + [("cond", s, True) for s in range(2)])
def test_store_resolver_matches_jax(name, seed, replay):
    kinds, fn = RESOLVERS[name]
    jp, tp = _params({"tpu/cond_replay": replay})
    lv = _sched_parked_leaves(jp, 17 * seed + len(name), kinds)
    if name == "barrier":
        # A stored waiter of a reached barrier, and one of a barrier
        # that is not.
        lv["bar_count"][:2] = [3, 0]
        lv["strm_pend_kind"][[0, 1]] = PEND_BARRIER
        lv["strm_pend_addr"][[0, 1]] = [0, 1]
        lv["strm_pend_aux"][[0, 1]] = [2, 2]
        lv["strm_done"][[0, 1]] = False
    if name == "cond":
        # A seated token, and a waiter of its cond in the store parked
        # before it (the only token and waiter of cond 1); a stored
        # runnable stream whose frozen clock bounds the tokens.
        lv["pend_addr"][lv["pend_addr"] == 1] = 2
        lv["strm_pend_addr"][lv["strm_pend_addr"] == 1] = 2
        t0 = next(t for t in range(T) if t != 0)
        lv["pend_kind"][t0] = PEND_CBC if seed % 2 else PEND_CSIG
        lv["pend_addr"][t0] = 1
        lv["pend_issue"][t0] = 6_000_000
        w = next(s for s in _own_streams(0) if s != lv["seat_stream"][0])
        lv["strm_pend_kind"][w] = PEND_COND
        lv["strm_pend_addr"][w] = 1
        lv["strm_pend_issue"][w] = 2_000_000
        lv["strm_done"][w] = False
        r = next(s for s in _own_streams(1) if s != lv["seat_stream"][1])
        lv["strm_pend_kind"][r] = PEND_NONE
        lv["strm_clock"][r] = 250_000 * (seed + 1)
        lv["strm_done"][r] = False
    tout = getattr(tresolve, fn)(tp, variant_params(tp),
                                 convert.state_from_numpy(tp, lv, "cpu"))
    _pinned(convert.state_to_numpy(tout), lambda: _leaves(
        ref.eager(getattr(jresolve, fn))(jp, jax_vp(jp),
                                         _jax_state(jp, lv))),
        tp, {**lv, "fn": np.array(fn)})
    if name == "barrier":
        assert int(tout.strm_pend_kind[0]) == PEND_NONE
        assert int(tout.strm_pend_kind[1]) == PEND_BARRIER
    if name == "cond" and not replay:
        assert int(tout.strm_pend_kind[w]) == PEND_MUTEX


@pytest.mark.parametrize("seed", range(2))
def test_resolve_pass_with_store_matches_jax(seed):
    jp, tp = _params()
    lv = _sched_parked_leaves(
        jp, 300 + seed, [PEND_NONE, PEND_BARRIER, PEND_MUTEX, PEND_COND,
                         PEND_CSIG, PEND_CBC, PEND_JOIN, PEND_START])
    tout = tresolve.resolve(tp, convert.state_from_numpy(tp, lv, "cpu"),
                            variant_params(tp))
    _pinned(convert.state_to_numpy(tout), lambda: _leaves(
        ref.eager(jresolve.resolve)(jp, _jax_state(jp, lv), jax_vp(jp))),
        tp, {**lv, "fn": np.array("resolve")})


# ----------------------------------- the window round and slot on seats

def _seat_trace(seed, n=24):
    """[S, n] events: compute, memory, SPAWN of children on every stream
    (ids >= T among them), YIELD, DONE, THREAD_START, JOIN."""
    rng = np.random.default_rng(seed)
    ops = np.asarray([EventOp.COMPUTE, EventOp.MEM_READ, EventOp.MEM_WRITE,
                      EventOp.BRANCH, EventOp.SPAWN, EventOp.YIELD,
                      EventOp.DONE, EventOp.THREAD_START, EventOp.JOIN,
                      EventOp.STALL], np.int32)
    op = rng.choice(ops, size=(S, n), p=[.3, .2, .1, .1, .1, .05, .05,
                                         .04, .03, .03]).astype(np.int32)
    arg = rng.integers(1, 60, size=(S, n)).astype(np.int32)
    arg2 = rng.integers(0, S, size=(S, n)).astype(np.int32)
    mem = (op == EventOp.MEM_READ) | (op == EventOp.MEM_WRITE)
    arg2[mem] = 0
    addr = (0x1000_0000 + 64 * rng.integers(0, 64, size=(S, n))).astype(
        np.int64)
    addr[op == EventOp.STALL] = 3_000_000
    return Trace(ops=op, addr=addr, arg=arg, arg2=arg2)


@pytest.mark.parametrize("chain,seed", [(0, 0), (0, 1), (12, 2)])
def test_window_and_slot_on_seats_match_jax(chain, seed):
    """A window round (the cache refreshed for tiles whose seat changed
    since it was taken) and a complex slot on seated streams' rows."""
    jp, tp = _params({"tpu/miss_chain": chain})
    rng = np.random.default_rng(500 + seed)
    lv = _seat_leaves(jp, rng)
    lv.update(done=np.zeros(T, bool), pend_kind=np.zeros(T, np.int32),
              mq_count=np.zeros(T, np.int32),
              cursor=rng.integers(0, 8, size=T).astype(np.int32),
              clock=rng.integers(0, 4, size=T).astype(np.int64) * 300_000,
              boundary=np.asarray(2_000_000, np.int64))
    # Half the tiles' cached windows were taken for another seat.
    jst = ref.eager(jcore._window_refresh)(jp, _jax_state(jp, lv),
                                           JTraceArrays.from_trace(
                                               _jtrace(seed)),
                                           jnp.ones(T, bool))
    lv = convert.leaves_to_numpy(jax.device_get(jst))
    stale = rng.random(T) < 0.5
    lv["seat_stream"] = np.where(
        stale, [rng.choice(_own_streams(t)) for t in range(T)],
        lv["seat_stream"]).astype(np.int32)
    trace = _seat_trace(seed)
    jtr = JTraceArrays.from_trace(_jtrace(seed))
    ttr = tstate.TraceArrays.from_trace(trace, "cpu")
    jst = _jax_state(jp, lv)
    tst = convert.state_from_numpy(tp, lv, "cpu")
    jst = ref.eager(jcore._block_retire)(jp, jax_vp(jp), jst, jtr)
    tst = tcore._block_retire(tp, variant_params(tp), tst, ttr)
    _compare(jst, tst)
    np.testing.assert_array_equal(tst.win_seat.numpy(),
                                  tst.seat_stream.numpy())
    jst = ref.eager(jcore._complex_slot)(jp, jax_vp(jp), jst, jtr)
    tst = tcore._complex_slot(tp, variant_params(tp), tst, ttr)
    _compare(jst, tst)


def _jtrace(seed):
    t = _seat_trace(seed)
    return JTrace(ops=t.ops, addr=t.addr, arg=t.arg, arg2=t.arg2)


# ------------------------------------------------------------ whole runs
# Each builder takes a TraceBuilder class, so both packages build the
# same arrays.

def synth(fn, **kw):
    def build(TB):
        mod = jax_synth if TB is JaxTraceBuilder else tsynth
        return getattr(mod, fn)(**kw)
    return build


def barrier_across_streams(TB):
    """tests/test_scheduler.py: a barrier spanning every stream, twice
    the tiles: released waiters that are descheduled wake in the store."""
    tb = TB(8)
    for s in range(4):
        tb.compute(s, 20, 10)
        tb.spawn(s, 4 + s)
        tb.barrier(s, 0, 8)
        tb.done(s)
    for s in range(4, 8):
        tb.thread_start(s)
        tb.compute(s, 50, 20)
        tb.barrier(s, 0, 8)
        tb.done(s)
    return tb.build()


def lock_convoy(TB):
    """tests/test_scheduler.py's wake-skew bound: 4 streams on 2 tiles
    take one mutex 6 times each."""
    tb = TB(4)
    for s in range(4):
        for _ in range(6):
            tb.mutex_lock(s, 0)
            tb.compute(s, 50, 50)
            tb.mutex_unlock(s, 0)
        tb.done(s)
    return tb.build()


def cond_pairs(TB):
    """Waiters 0-3 and their signalers 4-7 share tiles (s % 4): a waiter
    and its signaler are never seated together, so every wake is a store
    wake; the last token is a broadcast."""
    tb = TB(8)
    for w in range(4):
        tb.mutex_lock(w, w)
        tb.cond_wait(w, w % 2, w)
        tb.mutex_unlock(w, w)
        tb.done(w)
    for s in range(4, 8):
        tb.stall_until(s, 2_000_000 * (s - 3))
        if s == 7:
            tb.cond_broadcast(s, 1)
        else:
            tb.cond_signal(s, s % 2)
        tb.done(s)
    return tb.build()


def children_seated_first(TB):
    """Streams 0-3 (seated first) are children gated on THREAD_START;
    their parents 4-7 wait behind them on the same tiles, so each seat
    gives up its unspawned child."""
    tb = TB(8)
    for c in range(4):
        tb.thread_start(c)
        tb.compute(c, 80, 20)
        tb.done(c)
    for p in range(4, 8):
        tb.compute(p, 30, 10)
        tb.spawn(p, p - 4)
        tb.join(p, p - 4)
        tb.done(p)
    return tb.build()


MT2 = {"general/max_threads_per_core": 2}
MT4 = {"general/max_threads_per_core": 4}
THREADS16 = synth("gen_threads_oversubscribed", num_streams=16)
THREADS8 = synth("gen_threads_oversubscribed", num_streams=8)
FF = {"tpu/fast_forward": 8, "tpu/fast_forward_span": 1000}

# name: (builder, tiles, config overrides, entry point)
RUNS = {
    # tests/test_scheduler.py
    "two_threads_per_tile": (THREADS8, 4, MT4, "run_simulation"),
    "serializes_compute_packed": (
        synth("gen_threads_oversubscribed", num_streams=8,
              compute_blocks=16), 4, MT4, "simulator"),
    "serializes_compute_spread": (
        synth("gen_threads_oversubscribed", num_streams=8,
              compute_blocks=16), 8, {"general/max_threads_per_core": 1},
        "cli"),
    "four_threads_per_tile": (
        synth("gen_threads_oversubscribed", num_streams=8,
              compute_blocks=4), 2, MT4, "simulator"),
    "barrier_across_streams": (barrier_across_streams, 4, MT2,
                               "run_simulation"),
    "lock_convoy": (lock_convoy, 2, MT2, "simulator"),
    # gen_threads_oversubscribed at S = 2T
    "threads16on8": (THREADS16, 8, MT2, "simulator"),
    "threads16on8_chain12": (THREADS16, 8, {**MT2, "tpu/miss_chain": 12},
                             "run_simulation"),
    "threads16on8_ff8_span1000": (THREADS16, 8, {**MT2, **FF},
                                  "simulator"),
    # the store wakes, sync parks preempted, THREAD_START rotations
    "cond_pairs": (cond_pairs, 4, MT2, "simulator"),
    "lock16on8_switch500": (
        synth("gen_lock_contention", num_tiles=16, acquisitions=2,
              critical_cycles=50), 8,
        {**MT2, "thread_scheduling/switch_quantum": 500}, "simulator"),
    "children_seated_first": (children_seated_first, 4, MT2,
                              "run_simulation"),
    "sysev16on8_chain12": (
        lambda TB: tsynth.gen_system_events(16, seed=0, builder=TB), 8,
        {**MT2, "tpu/miss_chain": 12}, "simulator"),
}
LIVE = ("barrier_across_streams",)


def _run_params(tiles, over):
    cj, ct = jax_load_config(), load_config()
    for c in (cj, ct):
        c.set("general/total_cores", tiles)
        for k, v in over.items():
            c.set(k, v)
    return JaxSimParams.from_config(cj), SimParams.from_config(ct)


def _with_run(leaves, s, steps):
    out = dict(leaves)
    out["steps"] = np.asarray(steps, np.int64)
    out["completion_ps"] = np.asarray(s.completion_time_ps, np.int64)
    out["streams_done"] = np.asarray(s.done)
    return out


def _summary_lines(text):
    return [ln for ln in text.splitlines()
            if "Host Time" not in ln and "Simulated MIPS" not in ln]


@pytest.fixture(scope="module")
def runs():
    """name -> (the port's summary, the JAX package's leaves), each case
    run once for the tests that read it."""
    done = {}

    def get(name):
        if name in done:
            return done[name]
        build, tiles, over, _ = RUNS[name]
        ttrace = build(TraceBuilder)
        jp, tp = _run_params(tiles, over)
        tsim = Simulator(tp, ttrace, device="cpu")
        tsum = tsim.run(max_steps=MAX_STEPS)
        jrun = {}

        def jax_leaves():
            jtrace = build(JaxTraceBuilder)
            for f in ("ops", "addr", "arg", "arg2"):
                assert getattr(jtrace, f).tobytes() == \
                    getattr(ttrace, f).tobytes(), f
            jsim = JaxSimulator(jp, jtrace)
            jrun["summary"] = jsim.run(max_steps=MAX_STEPS)
            return _with_run(
                convert.leaves_to_numpy(jax.device_get(jsim.state)),
                jrun["summary"], jsim.steps)

        jleaves = ref.check(
            MODULE, name,
            _with_run(convert.state_to_numpy(tsim.state), tsum, tsim.steps),
            jax_leaves, ref.inputs({"general/total_cores": tiles, **over},
                                   ttrace, steps=MAX_STEPS),
            live=name in LIVE)
        if jrun:
            # A live run: the rendered summary and its dict too.
            jsum = jrun["summary"]
            assert _summary_lines(tsum.render()) \
                == _summary_lines(jsum.render())
            td, jd = tsum.to_dict(), jsum.to_dict()
            for k in ("host_seconds", "simulated_mips"):
                td.pop(k), jd.pop(k)
            assert td == jd
        done[name] = (tsum, tsim, jleaves, ttrace, tp)
        return done[name]
    return get


@pytest.mark.parametrize("name", sorted(RUNS))
def test_scheduler_run_matches_jax(name, runs, tmp_path):
    tsum, tsim, jleaves, ttrace, tp = runs(name)
    _, tiles, over, entry = RUNS[name]
    streams = ttrace.num_tiles
    assert tsum.done.shape == (streams,) and tsum.done.all()
    assert tsim.state.sched_enabled == (streams > tiles)
    if streams > tiles:
        assert tsim.state.strm_key.shape == (streams,)
        assert tsim.state.seat_stream.shape == (tiles,)
    completion_ps = int(jleaves["completion_ps"])
    if entry == "run_simulation":
        s = run_simulation(tp, ttrace, max_steps=MAX_STEPS, device="cpu")
        assert s.completion_time_ps == completion_ps
        for k in s.counters:
            np.testing.assert_array_equal(
                jleaves[f"counters.{k}"], s.counters[k], err_msg=k)
    if entry == "cli":
        # The CLI sizes the tile count from the trace, as the JAX
        # package's does (one stream per tile), whatever total_cores
        # says: half the streams here, with one thread a core.
        assert streams == tiles
        path, out = str(tmp_path / "t.npz"), str(tmp_path / "sim.out")
        ttrace.save(path)
        assert cli.main(["run", "--trace", path, "--device", "cpu", "-o",
                         out, f"--general/total_cores={tiles // 2}"]
                        + [f"--{k}={v}" for k, v in over.items()]) == 0
        text = open(out).read()
        assert f"Total Tiles{' ' * 35}: {tiles}" in text
        assert f"Completion Time (in ns){' ' * 23}: " \
               f"{completion_ps / 1000:.1f}" in text
        assert f"Streams Completed{' ' * 29}: {streams} / {streams}" in text
    if "ff8" in name:
        # Fast-forward stays off while the scheduler is seated.
        assert int(jleaves["ctr_ff"]) == 0 and int(jleaves["ff_events"]) == 0


def test_oversubscription_serializes_compute(runs):
    """tests/test_scheduler.py: two streams time-sharing a core finish
    later than the same work spread over twice the tiles."""
    packed = runs("serializes_compute_packed")[0]
    spread = runs("serializes_compute_spread")[0]
    assert packed.completion_time_ps > spread.completion_time_ps


def test_deterministic(runs):
    a = runs("two_threads_per_tile")[0]
    jp, tp = _run_params(4, MT4)
    b = run_simulation(tp, THREADS8(TraceBuilder), max_steps=MAX_STEPS,
                       device="cpu")
    assert a.completion_time_ps == b.completion_time_ps
    for k in a.counters:
        np.testing.assert_array_equal(a.counters[k], b.counters[k], k)


def test_rotated_parked_wake_skew_bounded(runs):
    """tests/test_scheduler.py's bound on a serialised lock convoy: one
    rotation period and one lax quantum of slack per handoff."""
    s, sim = runs("lock_convoy")[:2]
    p = sim.params
    bound = 4 * 6 * (100_000 + p.thread_switch_quantum_ps + p.quantum_ps)
    assert s.completion_time_ps <= bound


# --------------------------------------------------------------- refusals

@pytest.mark.parametrize("case", ["fewer_streams", "over_threads_per_core",
                                  "capi"])
def test_refusals_match_jax(case):
    """The JAX package's three ValueErrors, raised by the port on the
    same inputs with the same words."""
    if case == "fewer_streams":
        jp, tp = _run_params(8, {})
        build = synth("gen_radix", num_tiles=4, keys_per_tile=8, radix=8)
        match = "streams"
    elif case == "over_threads_per_core":
        jp, tp = _run_params(4, {"general/max_threads_per_core": 1})
        build = THREADS8
        match = "max_threads_per_core"
    else:
        jp, tp = _run_params(4, MT2)
        build = synth("gen_ping_pong", num_tiles=8, messages=2)
        match = "CAPI"
    with pytest.raises(ValueError, match=match) as jerr:
        JaxSimulator(jp, build(JaxTraceBuilder))
    with pytest.raises(ValueError, match=match) as terr:
        Simulator(tp, build(TraceBuilder), device="cpu")
    assert str(terr.value) == str(jerr.value)
