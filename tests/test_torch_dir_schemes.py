"""PyTorch port, the limited directory schemes (limited_broadcast,
limited_no_broadcast, ackwise, limitless; reference
directory_schemes/directory_entry_*.cc) against the JAX package on the
CPU, every SimState leaf equal (tolerance 0):

  * ``directory.popcount`` / ``lowest_bit`` on int64 words against the
    JAX package's uint64 ones, top bit set;
  * the scheme legs of the conflict round (``resolve_memory``, run op by
    op) on seeded states whose directory entries hold more sharers than
    the hardware pointers: pointer eviction, the limitless trap, the
    broadcast's every-tile latency and its T-1 INV packets;
  * whole runs of the five shapes of tests/test_dir_schemes.py (T = 6)
    through ``Simulator.run`` and ``run_simulation``, with their
    assertions; a scheme under shared L2 (``l2_directory/...``); the
    hop-by-hop mesh's broadcast tree on and off; a broadcast on the
    contended hop-by-hop mesh, through ``cli run``; and miss_chain 12,
    where the chain replay stands down under a limited scheme.

The cheapest whole run compares with the JAX package live; the others,
and the scheme legs, hold to its pins (tests/torch_jax_ref.py).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from graphite_tpu.config import load_config as jax_load_config
from graphite_tpu.engine import directory as jdir
from graphite_tpu.engine import resolve as jresolve
from graphite_tpu.engine import state as jstate
from graphite_tpu.engine.sim import Simulator as JaxSimulator
from graphite_tpu.engine.vparams import variant_params as jax_vp
from graphite_tpu.events.schema import Trace as JTrace
from graphite_tpu.params import SimParams as JaxSimParams
from graphite_tpu_torch import cli, convert, load_config
from graphite_tpu_torch.engine import dense
from graphite_tpu_torch.engine import directory as tdir
from graphite_tpu_torch.engine import resolve as tresolve
from graphite_tpu_torch.engine.sim import Simulator, run_simulation
from graphite_tpu_torch.engine.state import (PEND_EX_REQ, PEND_NONE,
                                             PEND_SH_REQ, dword_pack)
from graphite_tpu_torch.engine.vparams import variant_params
from graphite_tpu_torch.events import synth
from graphite_tpu_torch.events.schema import TraceBuilder
from graphite_tpu_torch.params import SimParams

import torch_jax_ref as ref

MODULE = "test_torch_dir_schemes"
SCHEMES = ("limited_broadcast", "limited_no_broadcast", "ackwise",
           "limitless")
HBH = {"network/memory": "emesh_hop_by_hop"}
TREE = "network/emesh_hop_by_hop/broadcast_tree_enabled"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params(T, over):
    cj, ct = jax_load_config(), load_config()
    for c in (cj, ct):
        c.set("general/total_cores", T)
        for k, v in over.items():
            c.set(k, v)
    return JaxSimParams.from_config(cj), SimParams.from_config(ct)


def _scheme(scheme, k):
    return {"dram_directory/directory_type": scheme,
            "dram_directory/max_hw_sharers": k}


# ------------------------------------------------------------ bit words


@pytest.mark.parametrize("W", [1, 2, 3])
def test_popcount_and_lowest_bit_match_jax(W):
    rng = np.random.default_rng(W)
    words = rng.integers(0, 2**64, size=(64, W), dtype=np.uint64)
    # Sparse rows, empty rows, leading empty words and the top bit alone.
    words[rng.random((64, W)) < 0.4] = 0
    words[:4] = 0
    words[4:8, :] = 0
    words[4:8, -1] = np.uint64(1) << np.uint64(63)
    words[8, 0] = np.uint64(1) << np.uint64(63)
    words[9] = np.uint64(2**64 - 1)
    jw = jnp.asarray(words)
    tw = torch.from_numpy(words.view(np.int64))
    np.testing.assert_array_equal(np.asarray(jdir.popcount(jw)),
                                  tdir.popcount(tw).numpy())
    assert tdir.popcount(tw).dtype == torch.int32
    np.testing.assert_array_equal(
        np.asarray(jdir.lowest_bit(jw)).view(np.int64),
        tdir.lowest_bit(tw).numpy())


# ------------------------------------------- the conflict round, op by op


def _jax_state(jp, leaves):
    """The JAX SimState holding ``leaves`` (a flat numpy dict)."""
    st = jstate.make_state(jp)
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


def _seeded_leaves(jp, tp, seed):
    """Every tile parked on a read or write of one of four lines: one
    shared by most tiles, one at two sharers, one modified, one
    uncached; issue times on a coarse grid, so that ties occur."""
    T = tp.num_tiles
    rng = np.random.default_rng(seed)
    lv = {k: np.array(v) for k, v in convert.leaves_to_numpy(
        jax.device_get(jstate.make_state(jp))).items()}
    A = tp.directory.associativity
    lines = torch.tensor([(synth.SHARED_BASE >> 6) + 17 * i
                          for i in range(4)])
    home = dense.home_of_line(tp, lines)
    fidx = (home * tp.directory.num_sets
            + dense.dir_set_of_line(tp, lines)).numpy()
    sharers = [rng.choice(T, size=n, replace=False)
               for n in (T // 2, 2, 1)]
    owner = int(sharers[2][0])
    words = dword_pack(lines[:3], torch.tensor([1, 2, 3]),
                       torch.tensor([1, 1, 3]),        # S, S, M
                       torch.tensor([-1, -1, owner])).numpy()
    dword = lv["dir_word"]
    dsh = lv["dir_sharers"].view(np.int64)
    for i in range(3):
        way = int(rng.integers(0, A))
        dword[way, fidx[i]] = words[i]
        bits = 0
        for t in sharers[i]:
            bits |= 1 << int(t)
        dsh[way, fidx[i]] = np.int64(bits)
    pick = rng.choice(4, size=T, p=[0.5, 0.2, 0.15, 0.15])
    kind = np.where(rng.random(T) < 0.35, PEND_EX_REQ, PEND_SH_REQ)
    kind[rng.random(T) < 0.1] = PEND_NONE
    issue = rng.integers(0, 8, size=T).astype(np.int64) * 100_000
    # On the widely shared line: a non-sharer's read first (a pointer
    # past the cap) and one write after it (an overflowed invalidation).
    kind[pick == 0] = PEND_SH_REQ
    new, wr = [t for t in range(T) if t not in sharers[0]][:2]
    pick[[new, wr]] = 0
    kind[[new, wr]] = PEND_SH_REQ, PEND_EX_REQ
    issue[[new, wr]] = 0, 50_000
    lv.update(
        pend_kind=kind.astype(np.int32),
        pend_addr=(lines.numpy()[pick] << 6).astype(np.int64),
        pend_issue=issue, clock=np.zeros(T, np.int64))
    return lv


@pytest.mark.parametrize("scheme,seed", [
    ("limited_broadcast", 0), ("limited_no_broadcast", 1), ("ackwise", 2),
    ("limitless", 3)])
def test_scheme_legs_match_jax(scheme, seed):
    """``resolve_memory`` on a seeded parked state, every leaf equal to
    the JAX package's (op by op; its leaves as recorded for the same
    inputs unless ``GRAPHITE_TORCH_JAX`` asks for a live run); against
    the port's full map on the same state, the scheme's leg moves the
    counters it exists for."""
    T = 8
    jp, tp = _params(T, _scheme(scheme, 2))
    lv = _seeded_leaves(jp, tp, seed)
    tout = tresolve.resolve_memory(
        tp, variant_params(tp), convert.state_from_numpy(tp, lv, "cpu"))
    ref.check_outputs(
        MODULE, convert.state_to_numpy(tout),
        lambda: convert.leaves_to_numpy(jax.device_get(
            ref.eager(jresolve.resolve_memory)(jp, jax_vp(jp),
                                               _jax_state(jp, lv)))),
        {"params": repr(tp)}, lv)
    _, tpf = _params(T, {})
    full = tresolve.resolve_memory(
        tpf, variant_params(tpf), convert.state_from_numpy(tpf, lv, "cpu"))
    c, f = tout.counters, full.counters
    inv, inv_f = int(c.dir_invalidations.sum()), \
        int(f.dir_invalidations.sum())
    if scheme == "limitless":
        assert inv == inv_f
        assert int(c.mem_stall_ps.sum()) > int(f.mem_stall_ps.sum())
    else:
        assert inv > inv_f


# ------------------------------------------------------------ whole runs


def _readers_then_writer(T, readers=3, writer=3):
    """Tiles 0..readers-1 read one line in turn; ``writer`` then writes."""
    tb = TraceBuilder(T)
    addr = synth.SHARED_BASE
    for r in range(readers):
        tb.stall_until(r, 2_000_000 * (r + 1))
        tb.read(r, addr, 8)
    tb.stall_until(writer, 2_000_000 * (readers + 2))
    tb.write(writer, addr, 8)
    return tb.build()


def _five_readers(T):
    tb = TraceBuilder(T)
    for r in range(5):
        tb.stall_until(r, 2_000_000 * (r + 1))
        tb.read(r, synth.SHARED_BASE, 8)
    return tb.build()


def _read_then_write(T):
    tb = TraceBuilder(T)
    tb.read(0, synth.SHARED_BASE, 8)
    tb.stall_until(1, 5_000_000)
    tb.write(1, synth.SHARED_BASE, 8)
    return tb.build()


def _migratory8(T=8):
    """Lines read and then written by tile after tile: invalidations of
    entries past two pointers."""
    return synth.gen_migratory(num_tiles=T, lines=4, rounds=2)


# name: (T, trace, config overrides, entry point)
RUNS = {
    # tests/test_dir_schemes.py's shapes (T = 6; its full map has two
    # hardware pointers too, which size the directory entries).
    "lnb_caps_k2": (6, _five_readers, _scheme("limited_no_broadcast", 2),
                    "simulator"),
    "five_readers_full_map": (6, _five_readers, _scheme("full_map", 2),
                              "simulator"),
    "limitless_k2": (6, lambda T: _readers_then_writer(T, 5, 5),
                     _scheme("limitless", 2), "run_simulation"),
    "rtw5_full_map": (6, lambda T: _readers_then_writer(T, 5, 5),
                      _scheme("full_map", 2), "run_simulation"),
    "limited_broadcast_k1": (6, _readers_then_writer,
                             _scheme("limited_broadcast", 1),
                             "run_simulation"),
    "ackwise_k1": (6, _readers_then_writer, _scheme("ackwise", 1),
                   "run_simulation"),
    "rtw3_full_map": (6, _readers_then_writer, _scheme("full_map", 2),
                      "run_simulation"),
    **{f"under_cap_{s}": (6, _read_then_write, _scheme(s, 4),
                          "run_simulation") for s in SCHEMES},
    "under_cap_full_map": (6, _read_then_write, _scheme("full_map", 2),
                           "run_simulation"),
    # A scheme under shared L2, the broadcast tree on and off, the
    # contended mesh, the chain replay standing down.
    "migratory8_sh_l2_lnb": (8, _migratory8, {
        "caching_protocol/type": "pr_l1_sh_l2_msi",
        "l2_directory/directory_type": "limited_no_broadcast",
        "l2_directory/max_hw_sharers": 2}, "simulator"),
    "migratory8_lb_tree": (8, _migratory8, {
        **_scheme("limited_broadcast", 2), **HBH, TREE: True},
        "simulator"),
    "migratory8_lb_no_tree": (8, _migratory8, {
        **_scheme("limited_broadcast", 2), **HBH, TREE: False},
        "simulator"),
    "migratory8_lb_contended": (8, _migratory8, {
        **_scheme("limited_broadcast", 2), **HBH,
        "network/emesh_hop_by_hop/queue_model/enabled": True}, "cli"),
    "migratory8_ackwise_chain12": (8, _migratory8, {
        **_scheme("ackwise", 2), "tpu/miss_chain": 12}, "simulator"),
}
LIVE = ("lnb_caps_k2",)
MAX_STEPS = 4096
_DONE = {}


def _run(name, tmp_path_factory):
    """The port's run of case ``name`` through its entry point, held to
    the JAX package's leaves: (completion ps, the port's flat leaves)."""
    if name in _DONE:
        return _DONE[name]
    T, make, over, entry = RUNS[name]
    jp, tp = _params(T, over)
    trace = make(T)
    # Every entry point builds a Simulator and runs it: keep it, to read
    # its state.
    sims = []
    orig = Simulator.run

    def keep(self, *a, **kw):
        sims.append(self)
        return orig(self, *a, **kw)
    Simulator.run = keep
    try:
        if entry == "cli":
            path = str(tmp_path_factory.mktemp(name) / "t.npz")
            trace.save(path)
            assert cli.main(
                ["run", "--trace", path, "--device", "cpu",
                 "-o", path + ".out"]
                + [f"--{k}={str(v).lower() if isinstance(v, bool) else v}"
                   for k, v in over.items()]) == 0
        elif entry == "run_simulation":
            run_simulation(tp, trace, max_steps=MAX_STEPS, device="cpu")
        else:
            Simulator(tp, trace, device="cpu").run(max_steps=MAX_STEPS)
    finally:
        Simulator.run = orig
    tsim, = sims
    assert bool(tsim.state.done.all())

    def jax_leaves():
        jt = JTrace(ops=trace.ops, addr=trace.addr, arg=trace.arg,
                    arg2=trace.arg2)
        jsim = JaxSimulator(jp, jt)
        jsim.run(max_steps=MAX_STEPS)
        return convert.leaves_to_numpy(jax.device_get(jsim.state))

    leaves = convert.state_to_numpy(tsim.state)
    ref.check(MODULE, name, leaves, jax_leaves,
              ref.inputs({"general/total_cores": T, **over}, trace,
                         steps=MAX_STEPS), live=name in LIVE)
    _DONE[name] = (int(leaves["clock"].max()), leaves)
    return _DONE[name]


def _inv(name, tpf):
    return int(_run(name, tpf)[1]["counters.dir_invalidations"].sum())


def _popcounts(leaves):
    return np.array([bin(int(w)).count("1")
                     for w in leaves["dir_sharers"].reshape(-1)])


@pytest.mark.parametrize("name", sorted(RUNS))
def test_scheme_run_matches_jax(name, tmp_path_factory):
    _run(name, tmp_path_factory)


def test_limited_no_broadcast_caps_sharers(tmp_path_factory):
    # The 3rd..5th readers each evicted one victim sharer; the full map
    # tracks all five with no invalidation.
    assert _inv("lnb_caps_k2", tmp_path_factory) == 3
    assert _popcounts(_run("lnb_caps_k2", tmp_path_factory)[1]).max() <= 2
    assert _inv("five_readers_full_map", tmp_path_factory) == 0
    assert _popcounts(
        _run("five_readers_full_map", tmp_path_factory)[1]).max() == 5


def test_limitless_trap_slows_overflowed_entries(tmp_path_factory):
    assert _inv("limitless_k2", tmp_path_factory) \
        == _inv("rtw5_full_map", tmp_path_factory)
    assert _run("limitless_k2", tmp_path_factory)[0] \
        > _run("rtw5_full_map", tmp_path_factory)[0]


def test_broadcast_schemes_traffic_and_latency(tmp_path_factory):
    # The full map invalidates the 3 true sharers; both broadcasts send
    # T-1 = 5; ackwise at the full map's latency.
    assert _inv("rtw3_full_map", tmp_path_factory) == 3
    assert _inv("limited_broadcast_k1", tmp_path_factory) == 5
    assert _inv("ackwise_k1", tmp_path_factory) == 5
    assert _run("ackwise_k1", tmp_path_factory)[0] \
        == _run("rtw3_full_map", tmp_path_factory)[0]


def test_under_cap_entries_behave_like_full_map(tmp_path_factory):
    full = _run("under_cap_full_map", tmp_path_factory)[0]
    for s in SCHEMES:
        assert _run(f"under_cap_{s}", tmp_path_factory)[0] == full, s
        assert _inv(f"under_cap_{s}", tmp_path_factory) \
            == _inv("under_cap_full_map", tmp_path_factory), s


def test_broadcast_tree_sends_one_packet(tmp_path_factory):
    """With the tree an overflowed broadcast injects one packet; the
    flits and the invalidations keep the T-1 traversals."""
    tree = _run("migratory8_lb_tree", tmp_path_factory)[1]
    flat = _run("migratory8_lb_no_tree", tmp_path_factory)[1]
    for k in ("counters.dir_invalidations", "counters.net_mem_flits"):
        np.testing.assert_array_equal(tree[k], flat[k])
    assert tree["counters.net_mem_pkts"].sum() \
        < flat["counters.net_mem_pkts"].sum()
    # On the contended mesh the broadcast's INVs reach every tile too
    # (the multicast is priced zero-load, beside the contended legs).
    cont = _run("migratory8_lb_contended", tmp_path_factory)[1]
    assert cont["counters.dir_invalidations"].sum() > 0
    assert cont["counters.net_link_wait_ps"].sum() > 0


def test_chain_replay_stands_down_under_a_scheme(tmp_path_factory):
    lv = _run("migratory8_ackwise_chain12", tmp_path_factory)[1]
    assert lv["counters.chain_fanout_served"].sum() == 0
    assert lv["counters.chain_fallback"].sum() == 0
    assert int(lv["ctr_conflict"]) > 0
