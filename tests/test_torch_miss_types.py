"""PyTorch port, miss-type classification ([cache]/track_miss_types;
reference cache.h:45-49 cold/capacity/sharing counters) against the JAX
package on the CPU, every SimState leaf and round counter equal
(tolerance 0), the [T, MISS_FILTER_SLOTS] seen and inv filters among
them:

  * the classification on its own (``resolve._classify_misses``), op by
    op against the JAX conflict round's rule, on seeded filters where
    two deliveries to one tile hash to one slot and line + 1 wraps in
    int32;
  * whole runs of the four shapes of tests/test_miss_types.py (T = 2
    and 4; the capacity case on an 8 KB L2 under a 4 KB L1D, a quarter
    of the reference test's 32 KB L2 and its misses) through
    ``Simulator.run``, with their assertions;
  * radix8 at miss_chain 0 and 12 (at 12 the chain replay classifies
    beside the chain_classify step), and migratory8 at 0 and 12 (sharing
    misses: INV deliveries mark the targets' filters).

The cheapest whole run compares with the JAX package live; the others
hold to its pins (tests/torch_jax_ref.py).
"""

import numpy as np
import pytest
import torch

from graphite_tpu_torch import convert, load_config
from graphite_tpu_torch.engine import dense
from graphite_tpu_torch.engine import resolve as tresolve
from graphite_tpu_torch.engine.sim import Simulator
from graphite_tpu_torch.engine.state import MISS_FILTER_SLOTS, make_state
from graphite_tpu_torch.events import synth
from graphite_tpu_torch.events.schema import TraceBuilder
from graphite_tpu_torch.params import SimParams

import torch_jax_ref as ref

MODULE = "test_torch_miss_types"
TRACK = {"l2_cache/T1/track_miss_types": True}
CHAIN12 = {"tpu/miss_chain": 12}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params(T, over):
    from graphite_tpu.config import load_config as jax_load_config
    from graphite_tpu.params import SimParams as JaxSimParams
    cj, ct = jax_load_config(), load_config()
    for c in (cj, ct):
        c.set("general/total_cores", T)
        for k, v in over.items():
            c.set(k, v)
    return JaxSimParams.from_config(cj), SimParams.from_config(ct)


# ------------------------------------------- the classification rule


def _jax_classify(state, line, served, dlv_lines, dlv_valid, dlv_down):
    """The JAX conflict round's classification (graphite_tpu/engine/
    resolve.py, the ``track_miss_types`` block of ``round_body``) on the
    same arrays, op by op."""
    import jax.numpy as jnp
    from graphite_tpu.engine import dense as jdense
    T = line.shape[0]
    seen, inv = jnp.asarray(state["seen"]), jnp.asarray(state["inv"])
    line, win = jnp.asarray(line), jnp.asarray(served)
    HF = seen.shape[1]
    rows = jnp.arange(T)
    fslot = (jdense.fmix64(line) % jnp.uint64(HF)).astype(jnp.int32)
    key32 = (line + 1).astype(jnp.int32)
    seen_hit = jnp.take_along_axis(seen, fslot[:, None], axis=1)[:, 0] \
        == key32
    inv_hit = jnp.take_along_axis(inv, fslot[:, None], axis=1)[:, 0] \
        == key32
    m_shar = win & inv_hit
    counts = [win & ~inv_hit & ~seen_hit, win & ~inv_hit & seen_hit,
              m_shar]
    rows_w = jnp.where(win, rows, T).astype(jnp.int32)
    seen = seen.at[rows_w, fslot].set(key32, mode="drop")
    inv = inv.at[jnp.where(m_shar, rows, T), fslot].set(0, mode="drop")
    dl = jnp.asarray(dlv_lines)
    inv_dlv = jnp.asarray(dlv_valid) & (jnp.asarray(dlv_down) == 0)
    dslot = (jdense.fmix64(dl) % jnp.uint64(HF)).astype(jnp.int32)
    tgt = jnp.where(inv_dlv, jnp.arange(T, dtype=jnp.int32)[:, None], T)
    inv = inv.at[tgt, dslot].set((dl + 1).astype(jnp.int32), mode="drop")
    return [np.asarray(c) for c in counts], np.asarray(seen), \
        np.asarray(inv)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_classification_matches_jax(seed):
    T, J = 8, 6
    _, tp = _params(T, TRACK)
    rng = np.random.default_rng(seed)
    HF = MISS_FILTER_SLOTS
    pool = np.concatenate([rng.integers(0, 1 << 40, 12),
                           [2**31 - 1, 2**32 - 1, -1 + 2**33]])
    line = rng.choice(pool, T).astype(np.int64)
    fs = dense.fmix64(torch.from_numpy(line))
    fslot = tresolve.umod64(fs, HF).numpy()
    seen = np.zeros((T, HF), np.int32)
    inv = np.zeros((T, HF), np.int32)
    key = (line + 1).astype(np.int32)
    for t in range(T):                    # seen / inv marks on half
        r = rng.random()
        if r < 0.3:
            seen[t, fslot[t]] = key[t]
        elif r < 0.6:
            inv[t, fslot[t]] = key[t]
            seen[t, fslot[t]] = key[t]
    served = rng.random(T) < 0.8
    dlv_lines = rng.choice(pool, (T, J)).astype(np.int64)
    # Two deliveries to one tile that hash to one slot, other lines:
    # the last in row order wins.
    dslot = tresolve.umod64(dense.fmix64(torch.from_numpy(dlv_lines)),
                            HF).numpy()
    probe = torch.arange(1, 1 << 18)
    pslot = tresolve.umod64(dense.fmix64(probe), HF).numpy()
    for t in range(T):
        cands = probe.numpy()[(pslot == dslot[t, 0])
                              & (probe.numpy() != dlv_lines[t, 0])]
        assert cands.size
        dlv_lines[t, 3] = cands[0]
        if t < 4:
            dlv_lines[t, 0] = line[t]     # the tile's own served line
    dlv_valid = rng.random((T, J)) < 0.7
    dlv_down = np.where(rng.random((T, J)) < 0.8, 0, 1).astype(np.int32)
    counts, jseen, jinv = _jax_classify(dict(seen=seen, inv=inv), line,
                                        served, dlv_lines, dlv_valid,
                                        dlv_down)
    st = make_state(tp, "cpu")._replace(seen_filter=torch.from_numpy(seen),
                                        inv_filter=torch.from_numpy(inv))
    out = tresolve._classify_misses(
        st, torch.arange(T), torch.from_numpy(line),
        torch.from_numpy(served), torch.from_numpy(dlv_lines),
        torch.from_numpy(dlv_valid), torch.from_numpy(dlv_down))
    c = out.counters
    for got, want in zip((c.l2_miss_cold, c.l2_miss_capacity,
                          c.l2_miss_sharing), counts):
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    np.testing.assert_array_equal(out.seen_filter.numpy(), jseen)
    np.testing.assert_array_equal(out.inv_filter.numpy(), jinv)
    assert sum(int(x.sum()) for x in counts) == int(served.sum())


# ------------------------------------------------------------ whole runs


def _cold(T):
    tb = TraceBuilder(T)
    for _ in range(2):
        for i in range(8):
            tb.read(0, synth.PRIVATE_BASE + i * 64, 8)
    return tb.build()


def _sharing(T):
    tb = TraceBuilder(T)
    tb.read(0, synth.SHARED_BASE, 8)
    tb.stall_until(1, 5_000_000)
    tb.write(1, synth.SHARED_BASE, 8)
    tb.stall_until(0, 10_000_000)
    tb.read(0, synth.SHARED_BASE, 8)
    return tb.build()


# An 8 KB L2 (128 lines) under a 4 KB L1D: the second pass over 192
# lines misses both.
CAPACITY_L2 = {"l2_cache/T1/cache_size": 8, "l1_dcache/T1/cache_size": 4}


def _capacity_lines():
    _, tp = _params(2, {**TRACK, **CAPACITY_L2})
    return (tp.l2.num_sets * tp.l2.associativity * 3) // 2


def _capacity(T):
    tb = TraceBuilder(T)
    for _ in range(2):
        for i in range(_capacity_lines()):
            tb.read(0, synth.PRIVATE_BASE + i * 64, 8)
    return tb.build()


def _disabled(T):
    tb = TraceBuilder(T)
    tb.read(0, synth.PRIVATE_BASE, 8)
    return tb.build()


def _radix8(T):
    return synth.gen_radix(8, keys_per_tile=32, radix=16, seed=0)


def _migratory8(T):
    return synth.gen_migratory(num_tiles=8, lines=4, rounds=2)


# name: (tiles, trace, config overrides)
RUNS = {
    "cold": (2, _cold, TRACK),
    "sharing": (4, _sharing, TRACK),
    "capacity": (2, _capacity, {**TRACK, **CAPACITY_L2}),
    "disabled": (2, _disabled, {}),
    "radix8": (8, _radix8, TRACK),
    "radix8_chain12": (8, _radix8, {**TRACK, **CHAIN12}),
    "migratory8": (8, _migratory8, TRACK),
    "migratory8_chain12": (8, _migratory8, {**TRACK, **CHAIN12}),
}
LIVE = ("cold",)
MAX_STEPS = 4096
_DONE = {}


def _run(name):
    """The port's run of case ``name``, held to the JAX package's leaves;
    returns the port's flat leaves."""
    if name in _DONE:
        return _DONE[name]
    T, make, over = RUNS[name]
    jp, tp = _params(T, over)
    trace = make(T)
    sim = Simulator(tp, trace, device="cpu")
    sim.run(max_steps=MAX_STEPS)
    assert bool(sim.state.all_done())

    def jax_leaves():
        import jax
        from graphite_tpu.engine.sim import Simulator as JaxSimulator
        from graphite_tpu.events.schema import Trace as JTrace
        jsim = JaxSimulator(jp, JTrace(ops=trace.ops, addr=trace.addr,
                                       arg=trace.arg, arg2=trace.arg2))
        jsim.run(max_steps=MAX_STEPS)
        return convert.leaves_to_numpy(jax.device_get(jsim.state))

    leaves = convert.state_to_numpy(sim.state)
    ref.check(MODULE, name, leaves, jax_leaves,
              ref.inputs({"general/total_cores": T, **over}, trace,
                         steps=MAX_STEPS), live=name in LIVE)
    _DONE[name] = leaves
    return leaves


def _agg(name):
    return {k[len("counters."):]: int(v.sum())
            for k, v in _run(name).items() if k.startswith("counters.")}


@pytest.mark.parametrize("name", sorted(RUNS))
def test_miss_type_run_matches_jax(name):
    _run(name)


def test_cold_misses():
    c = _agg("cold")
    assert c["l2_miss_cold"] == 8
    assert c["l2_miss_capacity"] == 0 and c["l2_miss_sharing"] == 0
    assert c["l2_miss"] == c["l2_miss_cold"]


def test_sharing_misses():
    c = _agg("sharing")
    assert c["l2_miss_sharing"] == 1
    assert c["l2_miss_cold"] == 2
    assert c["l2_miss_capacity"] == 0


def test_capacity_misses():
    n = _capacity_lines()
    c = _agg("capacity")
    assert c["l2_miss_cold"] >= n
    assert c["l2_miss_capacity"] > n // 3
    assert c["l2_miss_sharing"] == 0
    assert c["l2_miss"] == (c["l2_miss_cold"] + c["l2_miss_capacity"]
                            + c["l2_miss_sharing"])


def test_disabled_by_default():
    lv = _run("disabled")
    assert _agg("disabled")["l2_miss_cold"] == 0
    assert lv["seen_filter"].shape == (1, 1)


def test_chain_pass_classifies_every_served_miss():
    """At miss_chain 12 the chain replay serves (and classifies) most
    misses; cold + capacity + sharing is every served miss."""
    for name in ("radix8_chain12", "migratory8_chain12"):
        lv, c = _run(name), _agg(name)
        assert lv["seen_filter"].shape == (8, MISS_FILTER_SLOTS)
        served = c["dir_sh_req"] + c["dir_ex_req"]
        assert c["l2_miss_cold"] + c["l2_miss_capacity"] \
            + c["l2_miss_sharing"] == served, name
    assert _agg("migratory8_chain12")["l2_miss_sharing"] > 0
    assert _agg("migratory8")["l2_miss_sharing"] > 0
