"""PyTorch port, the synchronisation, CAPI and system-event machinery part
by part against the JAX package on the CPU (its functions run op by op,
tests/torch_jax_ref.eager), every SimState leaf equal:

  * each sync resolver (``resolve_recv``, ``resolve_send``,
    ``resolve_mutex``, ``resolve_cond`` strict and in replay mode,
    ``resolve_join``, ``resolve_start``) on seeded parked states: random
    parks of every sync kind, channel rings at every fill level, held
    and free locks, spawned and unspawned streams;
  * the cases that each branch exists for: cond tokens that expire with
    no waiter, a broadcast posted while the poster holds the mutex its
    waiters re-acquire (the whole ``resolve`` pass, in its order),
    signals that wake exactly the earliest waiter, a full channel ring
    that parks a SEND and the RECV that frees it;
  * ``_complex_slot`` on seeded states whose next events cover every
    event kind (ATOMIC, SEND / RECV with full and free rings, the sync
    and thread kinds, STALL, SYNC, DVFS_SET, YIELD, SYSCALL of every
    class, the ROI markers), at miss_chain 0 and 12 (an ATOMIC miss
    banks with the atomic bit of its request word) and with a
    hop-by-hop user network, whose SEND flies over the link horizons;
  * the chain replay (the plain chain pass and a conflict round) on a
    state whose banks hold atomics.

One resolver case runs the JAX function live; the others hold its
leaves as recorded for the same inputs (tests/torch_jax_ref.py).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from graphite_tpu.config import load_config as jax_load_config
from graphite_tpu.engine import core as jcore
from graphite_tpu.engine import resolve as jresolve
from graphite_tpu.engine import state as jstate
from graphite_tpu.engine.state import TraceArrays as JTraceArrays
from graphite_tpu.engine.vparams import variant_params as jax_vp
from graphite_tpu.events.schema import Trace as JTrace
from graphite_tpu.params import SimParams as JaxSimParams
from graphite_tpu_torch import convert, load_config
from graphite_tpu_torch.engine import core as tcore
from graphite_tpu_torch.engine import resolve as tresolve
from graphite_tpu_torch.engine import state as tstate
from graphite_tpu_torch.engine.state import (
    PEND_BARRIER, PEND_CBC, PEND_COND, PEND_CSIG, PEND_JOIN, PEND_MUTEX,
    PEND_NONE, PEND_RECV, PEND_SEND, PEND_START)
from graphite_tpu_torch.engine.vparams import variant_params
from graphite_tpu_torch.events.schema import Trace
from graphite_tpu_torch.events.schema import TraceBuilder as TB
from graphite_tpu_torch.isa import EventOp, SyscallClass
from graphite_tpu_torch.params import SimParams

import torch_jax_ref as ref

MODULE = "test_torch_sync"

T = 8
DEPTH = 2          # channel ring depth: rings fill within a few sends
HBH_USER = {"network/user": "emesh_hop_by_hop",
            "network/emesh_hop_by_hop/queue_model/enabled": True}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params(over=None):
    cj, ct = jax_load_config(), load_config()
    for c in (cj, ct):
        c.set("general/total_cores", T)
        c.set("tpu/channel_depth", DEPTH)
        for k, v in (over or {}).items():
            c.set(k, v)
    return JaxSimParams.from_config(cj), SimParams.from_config(ct)


def _jax_state(jp, leaves):
    """The JAX SimState holding ``leaves`` (a flat numpy dict)."""
    st = jstate.make_state(jp, has_capi=True)
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
    """The initial state's leaves, as writable arrays."""
    return {k: np.array(v) for k, v in convert.leaves_to_numpy(
        jax.device_get(jstate.make_state(jp, has_capi=True))).items()}


def _parked_leaves(jp, seed, kinds):
    """A state with every tile parked on one of ``kinds`` (or runnable,
    or done), with operands that make each resolver's cases occur."""
    rng = np.random.default_rng(seed)
    lv = _fresh_leaves(jp)
    pk = rng.choice(kinds, size=T).astype(np.int32)
    done = (pk == PEND_NONE) & (rng.random(T) < 0.3)
    # Times on a coarse grid, so that ties occur.
    issue = rng.integers(0, 40, size=T).astype(np.int64) * 250_000
    addr = rng.integers(0, 3, size=T).astype(np.int64)       # ids
    aux = rng.integers(0, T, size=T).astype(np.int32)        # tiles
    send = pk == PEND_SEND
    addr[send] = rng.integers(0, 300, size=int(send.sum()))  # payload
    cw = pk == PEND_COND
    aux[cw] = rng.integers(0, 3, size=int(cw.sum()))         # mutex ids
    bar = pk == PEND_BARRIER
    aux[bar] = rng.integers(1, 4, size=int(bar.sum()))       # participants
    lv.update(
        pend_kind=pk, pend_addr=addr, pend_issue=issue, pend_aux=aux,
        done=done,
        clock=issue + rng.integers(0, 3, size=T) * 500_000,
        done_at=rng.integers(0, 40, size=T).astype(np.int64) * 250_000,
        spawned_at=np.where(rng.random(T) < 0.5, -1,
                            rng.integers(0, 40, size=T) * 250_000),
        lock_holder=np.where(rng.random(64) < 0.3,
                             rng.integers(1, T + 1, size=64),
                             0).astype(np.int32),
        lock_free_at=rng.integers(0, 40, size=64).astype(np.int64)
        * 250_000,
        bar_count=rng.integers(0, 4, size=16).astype(np.int32),
        bar_time=rng.integers(0, 40, size=16).astype(np.int64) * 250_000,
        models_enabled=np.asarray(bool(rng.random() < 0.8)))
    lv["done"] = lv["done"] | (rng.random(T) < 0.2) & (pk == PEND_NONE)
    recvd = rng.integers(0, 5, size=(T, T)).astype(np.int32)
    lv["ch_recvd"] = recvd
    lv["ch_sent"] = recvd + rng.integers(0, DEPTH + 1,
                                         size=(T, T)).astype(np.int32)
    lv["ch_time"] = rng.integers(0, 40, size=(DEPTH, T, T)).astype(
        np.int64) * 250_000
    return lv


def _compare(jout_fn, tout, tp, arrays, live=False):
    """Every leaf of the port's state ``tout`` held to the JAX function's
    (``jout_fn()``, run op by op where ``live``, else its pin:
    tests/torch_jax_ref.check_outputs) on the same inputs ``arrays``."""
    ref.check_outputs(
        MODULE, convert.state_to_numpy(tout),
        lambda: convert.leaves_to_numpy(jax.device_get(jout_fn())),
        {"params": repr(tp)}, arrays, live)


def _both(jfn, tfn, jp, tp, leaves, live=False):
    """Run the port's function and the JAX function (op by op, or its
    pin) on the state ``leaves``; every leaf equal.  Returns the port's
    state."""
    tout = tfn(tp, variant_params(tp),
               convert.state_from_numpy(tp, leaves, "cpu"))
    _compare(lambda: ref.eager(jfn)(jp, jax_vp(jp), _jax_state(jp, leaves)),
             tout, tp, {**leaves, "fn": np.array(jfn.__name__)}, live)
    return tout


SYNC_KINDS = [PEND_NONE, PEND_RECV, PEND_SEND, PEND_BARRIER, PEND_MUTEX,
              PEND_COND, PEND_CSIG, PEND_CBC, PEND_JOIN, PEND_START]
RESOLVERS = {
    "recv": ([PEND_RECV, PEND_NONE], "resolve_recv"),
    "send": ([PEND_SEND, PEND_NONE], "resolve_send"),
    "mutex": ([PEND_MUTEX, PEND_NONE], "resolve_mutex"),
    "cond": ([PEND_COND, PEND_CSIG, PEND_CBC, PEND_MUTEX, PEND_NONE],
             "resolve_cond"),
    "join": ([PEND_JOIN, PEND_NONE], "resolve_join"),
    "start": ([PEND_START, PEND_NONE], "resolve_start"),
}


@pytest.mark.parametrize("name,seed", [(n, s) for n in sorted(RESOLVERS)
                                       for s in range(3)])
def test_resolver_matches_jax(name, seed):
    kinds, fn = RESOLVERS[name]
    jp, tp = _params()
    leaves = _parked_leaves(jp, 10 * seed + len(name), kinds)
    tout = _both(getattr(jresolve, fn), getattr(tresolve, fn), jp, tp,
                 leaves, live=(name, seed) == ("recv", 0))
    moved = tout.pend_kind.numpy() != leaves["pend_kind"]
    if name != "cond":
        # Some seeds release nothing; across them every resolver does.
        assert not moved.any() or (tout.cursor.numpy()[moved] == 1).all()


@pytest.mark.parametrize("seed", range(3))
def test_resolve_cond_replay_matches_jax(seed):
    """Replay mode (captured traces): any parked waiter matches its
    cond's token, and orphaned waits wake once the tiles are quiesced."""
    jp, tp = _params({"tpu/cond_replay": True})
    assert jp.cond_replay and tp.cond_replay
    leaves = _parked_leaves(jp, 100 + seed,
                            [PEND_COND, PEND_CSIG, PEND_CBC, PEND_MUTEX,
                             PEND_BARRIER])
    _both(jresolve.resolve_cond, tresolve.resolve_cond, jp, tp, leaves)


@pytest.mark.parametrize("seed", range(4))
def test_resolve_pass_matches_jax(seed):
    """The whole pass on states parked on every kind: the sync resolvers
    in their order, the cond wakes competing for their mutexes in the
    same pass."""
    jp, tp = _params()
    leaves = _parked_leaves(jp, 200 + seed, SYNC_KINDS)
    tout = tresolve.resolve(tp, convert.state_from_numpy(tp, leaves, "cpu"),
                            variant_params(tp))
    _compare(lambda: ref.eager(jresolve.resolve)(
        jp, _jax_state(jp, leaves), jax_vp(jp)), tout, tp,
        {**leaves, "fn": np.array("resolve")})


def _cond_case(kinds, issue, aux=None, addr=None, clock=None, holder=None):
    jp, tp = _params()
    lv = _fresh_leaves(jp)
    lv["pend_kind"] = np.asarray(kinds, np.int32)
    lv["pend_issue"] = np.asarray(issue, np.int64)
    lv["pend_addr"] = np.asarray(addr if addr is not None else [0] * T,
                                 np.int64)
    lv["pend_aux"] = np.asarray(aux if aux is not None else [0] * T,
                                np.int32)
    if clock is not None:
        lv["clock"] = np.asarray(clock, np.int64)
    if holder is not None:
        lv["lock_holder"][0] = holder
    return jp, tp, lv


def test_cond_token_expires_with_no_waiter():
    """A signal with no waiter parked is lost once no other tile can
    still park before it: the poster is acked, nothing wakes; a token
    that a runnable tile could still precede stays parked."""
    N = PEND_NONE
    kinds = [PEND_CSIG, PEND_CSIG] + [N] * (T - 2)
    issue = [1_000_000, 9_000_000] + [0] * (T - 2)
    clock = [0, 0] + [5_000_000] * (T - 2)
    jp, tp, lv = _cond_case(kinds, issue, addr=[0, 1] + [0] * (T - 2),
                            clock=clock)
    tout = _both(jresolve.resolve_cond, tresolve.resolve_cond, jp, tp, lv)
    pk = tout.pend_kind.numpy()
    assert pk[0] == N and pk[1] == PEND_CSIG      # lost / still pending
    assert int(tout.cursor[0]) == 1


def _jax_resolves(jp, lv, passes):
    """The JAX state after ``passes`` resolve passes from ``lv``."""
    jst = _jax_state(jp, lv)
    for _ in range(passes):
        jst = ref.eager(jresolve.resolve)(jp, jst, jax_vp(jp))
    return jst


def test_broadcast_while_poster_holds_mutex():
    """lock; broadcast; unlock: the broadcaster holds the mutex its
    woken waiters re-park on.  The first pass wakes the waiters parked
    before the broadcast into mutex parks, which wait for the unlock; in
    the second the token resolves (the waiters' rewound mutex parks do
    not pin it) and the poster is acked."""
    N = PEND_NONE
    kinds = [PEND_CBC, PEND_COND, PEND_COND, PEND_COND] + [N] * (T - 4)
    issue = [8_000_000, 1_000_000, 2_000_000, 9_000_000] + [0] * (T - 4)
    clock = [0] * 4 + [20_000_000] * (T - 4)
    jp, tp, lv = _cond_case(kinds, issue, clock=clock, holder=1)
    tst = convert.state_from_numpy(tp, lv, "cpu")
    for i in range(2):
        tst = tresolve.resolve(tp, tst, variant_params(tp))
        _compare(lambda: _jax_resolves(jp, lv, i + 1), tst, tp,
                 {**lv, "fn": np.array("resolve"), "passes": np.array(i + 1)})
        pk = tst.pend_kind.numpy()
        assert pk[1] == PEND_MUTEX and pk[2] == PEND_MUTEX
        assert pk[3] == PEND_COND                  # parked after it
    assert pk[0] == N                              # the poster is acked


def test_signal_wakes_the_earliest_waiter():
    N = PEND_NONE
    kinds = [PEND_COND, PEND_COND, PEND_CSIG, PEND_CSIG] + [N] * (T - 4)
    issue = [2_000_000, 1_000_000, 5_000_000, 6_000_000] + [0] * (T - 4)
    clock = [0] * 4 + [30_000_000] * (T - 4)
    jp, tp, lv = _cond_case(kinds, issue, aux=[1, 2] + [0] * (T - 2),
                            clock=clock)
    tout = _both(jresolve.resolve_cond, tresolve.resolve_cond, jp, tp, lv)
    pk = tout.pend_kind.numpy()
    # One token per cond per pass: the earlier signal wakes tile 1.
    assert pk[1] == PEND_MUTEX and pk[0] == PEND_COND
    assert int(tout.pend_addr[1]) == 2             # its mutex id


def test_full_channel_ring_parks_send_until_recv():
    """Tile 0 sends to tile 1 with the ring full: the SEND parks; tile
    1's RECV consumes a slot (stamping it with its completion); the
    parked send then completes no earlier than that."""
    jp, tp = _params()
    lv = _fresh_leaves(jp)
    lv["ch_sent"][0, 1] = DEPTH
    lv["ch_time"][:, 0, 1] = [3_000_000, 4_000_000]
    kinds = [PEND_SEND, PEND_RECV] + [PEND_NONE] * (T - 2)
    lv["pend_kind"] = np.asarray(kinds, np.int32)
    lv["pend_aux"] = np.asarray([1, 0] + [0] * (T - 2), np.int32)
    lv["pend_addr"] = np.asarray([64] + [0] * (T - 1), np.int64)
    lv["pend_issue"] = np.asarray([1_000_000, 2_000_000] + [0] * (T - 2),
                                  np.int64)
    lv["clock"] = np.full(T, 50_000_000, np.int64)
    send0 = _both(jresolve.resolve_send, tresolve.resolve_send, jp, tp, lv)
    assert int(send0.pend_kind[0]) == PEND_SEND    # still full
    after = convert.state_to_numpy(
        _both(jresolve.resolve_recv, tresolve.resolve_recv, jp, tp, lv))
    assert after["pend_kind"][1] == PEND_NONE
    tout = _both(jresolve.resolve_send, tresolve.resolve_send, jp, tp,
                 after)
    assert int(tout.pend_kind[0]) == PEND_NONE
    assert int(tout.clock[0]) > int(after["clock"][1])


# ------------------------------------------------------ the complex slot

def _slot_trace(seed):
    """Per-tile next events covering every event kind, with arguments
    each kind reads (SEND / RECV peers, lock and cond ids, children,
    syscall classes with VM payloads, DVFS modules and MHz)."""
    rng = np.random.default_rng(seed)
    ops = np.asarray([EventOp.ATOMIC, EventOp.SEND, EventOp.RECV,
                      EventOp.MUTEX_LOCK, EventOp.MUTEX_UNLOCK,
                      EventOp.COND_WAIT, EventOp.COND_SIGNAL,
                      EventOp.COND_BROADCAST, EventOp.SPAWN, EventOp.JOIN,
                      EventOp.THREAD_START, EventOp.YIELD, EventOp.STALL,
                      EventOp.SYNC, EventOp.DVFS_SET, EventOp.SYSCALL,
                      EventOp.ENABLE_MODELS, EventOp.DISABLE_MODELS,
                      EventOp.MEM_READ, EventOp.MEM_WRITE, EventOp.COMPUTE,
                      EventOp.BRANCH, EventOp.BARRIER_WAIT, EventOp.DONE],
                     np.int32)
    N = 4
    op = rng.choice(ops, size=(T, N)).astype(np.int32)
    if seed % 2 == 0:
        # no DISABLE_MODELS: most of the slot's timing is then live
        op[op == EventOp.DISABLE_MODELS] = EventOp.ATOMIC
    arg = rng.integers(0, 4, size=(T, N)).astype(np.int32)
    arg2 = rng.integers(0, T, size=(T, N)).astype(np.int32)
    addr = (0x1000_0000 + 64 * rng.integers(0, 16, size=(T, N))).astype(
        np.int64)
    sysc = op == EventOp.SYSCALL
    arg[sysc] = rng.integers(0, len(SyscallClass), size=int(sysc.sum()))
    arg2[sysc] = rng.integers(0, 300, size=int(sysc.sum()))
    addr[sysc] = rng.integers(0, 1 << 20, size=int(sysc.sum()))
    dv = op == EventOp.DVFS_SET
    arg[dv] = rng.integers(0, 7, size=int(dv.sum()))
    arg2[dv] = rng.integers(500, 3000, size=int(dv.sum()))
    st_ = (op == EventOp.STALL) | (op == EventOp.SYNC)
    addr[st_] = rng.integers(0, 40, size=int(st_.sum())) * 250_000
    arg[op == EventOp.SEND] = rng.integers(
        0, 300, size=int((op == EventOp.SEND).sum()))
    return Trace(ops=op, addr=addr, arg=arg, arg2=arg2)


def _slot_case(seed, over):
    jp, tp = _params(over)
    rng = np.random.default_rng(1000 + seed)
    lv = _fresh_leaves(jp)
    lv["clock"] = rng.integers(0, 4, size=T).astype(np.int64) * 300_000
    lv["cursor"] = rng.integers(0, 3, size=T).astype(np.int32)
    lv["done"] = rng.random(T) < 0.1
    lv["models_enabled"] = np.asarray(bool(seed % 3 != 2))
    lv["boundary"] = np.asarray(2_000_000, np.int64)
    recvd = rng.integers(0, 3, size=(T, T)).astype(np.int32)
    lv["ch_recvd"] = recvd
    lv["ch_sent"] = recvd + rng.integers(0, DEPTH + 1,
                                         size=(T, T)).astype(np.int32)
    lv["ch_time"] = rng.integers(0, 8, size=(DEPTH, T, T)).astype(
        np.int64) * 250_000
    lv["spawned_at"] = np.where(rng.random(T) < 0.5, -1, 1_000)
    return jp, tp, lv, _slot_trace(seed)


def _slot_both(jp, tp, lv, trace):
    ttr = tstate.TraceArrays.from_trace(trace, "cpu")
    tout = tcore._complex_slot(tp, variant_params(tp),
                               convert.state_from_numpy(tp, lv, "cpu"), ttr)

    def jout():
        jtr = JTraceArrays.from_trace(JTrace(
            ops=trace.ops, addr=trace.addr, arg=trace.arg, arg2=trace.arg2))
        return ref.eager(jcore._complex_slot)(jp, jax_vp(jp),
                                              _jax_state(jp, lv), jtr)

    _compare(jout, tout, tp, {**lv, "fn": np.array("_complex_slot"),
                              "trace_ops": trace.ops,
                              "trace_addr": trace.addr,
                              "trace_arg": trace.arg,
                              "trace_arg2": trace.arg2})
    return tout


SLOT_CASES = {
    "emesh": {},
    "chain12": {"tpu/miss_chain": 12},
    "hbh_user": HBH_USER,
    "atac_user": {"network/user": "atac"},
}


@pytest.mark.parametrize("name,seed", [(n, s) for n in sorted(SLOT_CASES)
                                       for s in range(3)])
def test_complex_slot_every_kind_matches_jax(name, seed):
    jp, tp, lv, trace = _slot_case(seed, SLOT_CASES[name])
    tout = _slot_both(jp, tp, lv, trace)
    if name == "chain12":
        # banked atomics carry bit 3 of the request word
        at = (trace.ops[np.arange(T), np.minimum(lv["cursor"], 3)]
              == EventOp.ATOMIC)
        banked = tout.mq_count.numpy() > 0
        bit = (tout.mq_req[0].numpy() >> 3) & 1
        np.testing.assert_array_equal(bit[banked], at[banked])


def test_slot_send_flies_over_the_user_links():
    """Under a hop-by-hop user network with its queue model on, a batch
    of SENDs into one tile contends on the links into it."""
    jp, tp = _params(HBH_USER)
    lv = _fresh_leaves(jp)
    ops = np.full((T, 2), EventOp.DONE, np.int32)
    ops[:, 0] = EventOp.SEND
    arg = np.full((T, 2), 256, np.int32)
    arg2 = np.full((T, 2), 3, np.int32)
    trace = Trace(ops=ops, addr=np.zeros((T, 2), np.int64), arg=arg,
                  arg2=arg2)
    tout = _slot_both(jp, tp, lv, trace)
    assert int(tout.counters.net_link_wait_ps.sum()) > 0
    assert (tout.link_free_user.numpy() > 0).any()
    assert int(tout.counters.sends.sum()) == T


@functools.lru_cache(maxsize=None)
def _atomic_bank_state():
    """A state one complex slot into a trace of contended ATOMICs on two
    shared lines at miss_chain 12 (every miss banks as element 0): the
    port's slot, which test_complex_slot_every_kind_matches_jax holds to
    the JAX package's."""
    jp, tp = _params({"tpu/miss_chain": 12})
    tb = TB(T)
    for t in range(T):
        tb.atomic(t, 0x8000_0000 + 64 * (t % 2))
        tb.read(t, 0x8000_0000 + 64 * ((t + 1) % 2))
    trace = tb.build()
    st = tstate.make_state(tp, "cpu", has_capi=False)
    st = tcore._complex_slot(tp, variant_params(tp), st,
                             tstate.TraceArrays.from_trace(trace, "cpu"))
    return jp, tp, convert.state_to_numpy(st)


def test_atomic_in_chain_bank_replays_like_jax():
    """Banked atomics (bit 3 of the request word set) through the plain
    chain pass and a conflict round: the kind is ``req & 7``."""
    jp, tp, lv = _atomic_bank_state()
    assert ((lv["mq_req"][0] >> 3) & 1).sum() == T
    tst = convert.state_from_numpy(tp, lv, "cpu")
    tout = tresolve.resolve_memory(tp, variant_params(tp), tst)
    _compare(lambda: ref.eager(jresolve.resolve_memory)(
        jp, jax_vp(jp), _jax_state(jp, lv)), tout, tp,
        {**lv, "fn": np.array("resolve_memory")})
    assert int(tout.counters.dir_ex_req.sum()) > 0
