"""PyTorch port, the ``basic`` and ``m_g_1`` DRAM queue models against the
JAX package on the CPU, ``dram_qacc`` (the models' float64 state) bit
for bit:

  * ``basic_ring``, ``mg1_delay``, ``probe`` and ``occupy`` on seeded
    batches (repeated resources, occupancy rows, the moving average off
    and at windows 1, 2, 16 and 64, one batch of 1,200 rows on few
    resources at window 2), against the JAX functions as XLA compiles
    them (``jax.jit``: XLA's CPU code fuses a multiply into the add that
    consumes it, and the port follows it with ``ops.fma``);
  * the moving average's decay table against ``jnp.power`` at counts 0
    to 20,000;
  * the shapes of tests/test_queue_models.py for the two models, and its
    ``test_dram_queue_type_changes_sim`` for both at miss_chain 0 and 12
    as whole runs, every SimState leaf equal (one live, the others on
    the JAX package's pins, tests/torch_jax_ref.py).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from graphite_tpu.config import load_config as jax_load_config
from graphite_tpu.engine import queue_models as jq
from graphite_tpu.engine.sim import Simulator as JaxSimulator
from graphite_tpu.events import synth as jax_synth
from graphite_tpu.params import SimParams as JaxSimParams
from graphite_tpu_torch import convert, load_config
from graphite_tpu_torch.engine import queue_models as tq
from graphite_tpu_torch.engine.sim import Simulator, run_simulation
from graphite_tpu_torch.events import synth
from graphite_tpu_torch.params import SimParams

import torch_jax_ref as ref

MODULE = "test_torch_queue_models"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bytes_equal(a, b, what=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype,
                                                       b.dtype)
    assert a.tobytes() == b.tobytes(), (what, a, b)


@functools.lru_cache(maxsize=None)
def _jit_probe(qtype, window, occ):
    if occ:
        return jax.jit(lambda r, a, s, v, rs, re, rp, m, o_r, o_a, o_s, o_v:
                       jq.probe(qtype, r, a, s, v, rs, re, rp, m, o_r, o_a,
                                o_s, o_v, ma_window=window))
    return jax.jit(lambda r, a, s, v, rs, re, rp, m:
                   jq.probe(qtype, r, a, s, v, rs, re, rp, m,
                            ma_window=window))


@functools.lru_cache(maxsize=None)
def _jit_occupy(qtype, window, svc):
    return jax.jit(lambda rs, re, rp, m, r, t0, v:
                   jq.occupy(qtype, rs, re, rp, m, r, t0, svc, v,
                             ma_window=window))


def _batch(rng, K, C, spread=10**9, steady=False):
    """(resource, arrival, service, valid): a few resources, repeated;
    with ``steady`` arrivals close to a per-resource base, so that the
    average sits near the arrivals."""
    res = rng.integers(0, C, K).astype(np.int32)
    if steady:
        base = rng.integers(1_000, spread, C)
        arr = base[res] + rng.integers(0, 3, K)
    else:
        arr = rng.integers(0, spread, K)
    return (res, arr.astype(np.int64),
            rng.integers(1, 3_000, K).astype(np.int64), rng.random(K) < 0.85)


def _state(rng, C, R=8, empty=False):
    """(ring_start, ring_end, ring_ptr, moments [6, C])."""
    rs = np.zeros((R, C), np.int64)
    re = np.zeros((R, C), np.int64)
    rp = np.zeros(C, np.int32)
    m = np.zeros((6, C), np.float64)
    if not empty:
        re[0] = rng.integers(0, 2 * 10**9, C)
        m[0] = rng.integers(1, 10**6, C)
        m[1] = m[0] ** 2 / rng.integers(1, 30, C) + rng.integers(0, 10**9, C)
        m[2] = rng.integers(1, 60, C)
        m[3] = rng.integers(1, 10**9, C)
        m[4] = rng.integers(1_000, 10**9, C) + rng.random(C)
        m[5] = rng.integers(0, 70, C)
    return rs, re, rp, m


def _both_probe(qtype, window, batch, st, occ=None):
    """The JAX probe (compiled) and the port's on the same operands;
    every output equal, byte for byte.  Returns the port's outputs."""
    args = list(batch) + list(st) + (list(occ) if occ is not None else [])
    jout = _jit_probe(qtype, window, occ is not None)(
        *[jnp.asarray(a) for a in args])
    targs = [torch.from_numpy(np.array(a)) for a in args]
    tout = tq.probe(qtype, *targs[:8],
                    *(targs[8:] if occ is not None else [None] * 4),
                    ma_window=window)
    for i, (a, b) in enumerate(zip(jout, tout)):
        _bytes_equal(a, b.numpy(), f"{qtype} W={window} output {i}")
    return tout


CASES = [("basic", 0), ("basic", 1), ("basic", 2), ("basic", 16),
         ("basic", 64), ("m_g_1", 0)]


@pytest.mark.parametrize("qtype,window", CASES)
def test_probe_matches_jax(qtype, window):
    rng = np.random.default_rng(window + 7 * len(qtype))
    for trial in range(12):
        C = 4
        st = _state(rng, C, empty=trial % 4 == 0)
        batch = _batch(rng, 24, C, steady=trial % 2 == 1)
        occ = _batch(rng, 24, C) if trial % 3 else None
        _both_probe(qtype, window, batch, st, occ)


@pytest.mark.parametrize("qtype,window", CASES)
def test_occupy_matches_jax(qtype, window):
    rng = np.random.default_rng(100 + window + len(qtype))
    for trial in range(6):
        C = 4
        st = _state(rng, C, empty=trial == 0)
        res, arr, _, val = _batch(rng, 16, C, steady=trial % 2 == 1)
        jout = _jit_occupy(qtype, window, 150)(
            *[jnp.asarray(a) for a in list(st) + [res, arr, val]])
        tout = tq.occupy(qtype, *[torch.from_numpy(np.array(a))
                                  for a in st],
                         torch.from_numpy(res), torch.from_numpy(arr), 150,
                         torch.from_numpy(val), ma_window=window)
        for i, (a, b) in enumerate(zip(jout, tout)):
            _bytes_equal(a, b.numpy(), f"{qtype} W={window} output {i}")


def test_long_batch_on_few_resources():
    """1,200 rows on three resources at window 2: the decay (1/2)^n runs
    through the subnormal range to zero."""
    rng = np.random.default_rng(11)
    C = 4
    res, arr, svc, val = _batch(rng, 1200, C, steady=True)
    res = np.where(np.arange(1200) < 1050, 0,
                   rng.integers(1, 3, 1200)).astype(np.int32)
    val[:1050] = True
    st = _state(rng, C)
    tout = _both_probe("basic", 2, (res, arr, svc, val), st)
    assert float(tout[6][5, 0]) == 2.0


def test_basic_and_mg1_direct_calls_match_jax():
    """``basic_ring`` and ``mg1_delay`` called directly (without moments,
    and with occupancy rows)."""
    rng = np.random.default_rng(3)
    C = 4
    batch = _batch(rng, 20, C)
    occ = _batch(rng, 12, C)
    rs, re, rp, m = _state(rng, C)
    j = [jnp.asarray(a) for a in batch]
    t = [torch.from_numpy(np.array(a)) for a in batch]
    jq_, jm = jax.jit(lambda *a: jq.basic_ring(*a))(
        *j, jnp.asarray(rs), jnp.asarray(re), jnp.asarray(rp))
    tq_, tm = tq.basic_ring(*t, torch.from_numpy(rs), torch.from_numpy(re),
                            torch.from_numpy(rp))
    assert jm is None and tm is None
    for a, b in zip(jq_, tq_):
        _bytes_equal(a, b.numpy())
    jo = [jnp.asarray(a) for a in occ]
    to = [torch.from_numpy(np.array(a)) for a in occ]
    jout = jax.jit(lambda *a: jq.mg1_delay(*a[:4], a[4], *a[5:]))(
        *j, jnp.asarray(m[:4]), *jo)
    tout = tq.mg1_delay(*t, torch.from_numpy(m[:4].copy()), *to)
    for a, b in zip(jout, tout):
        _bytes_equal(a, b.numpy())


def test_mg1_prices_from_the_fused_variance():
    """Moments where sum_s2 / n - (sum_s / n)^2 rounded twice and rounded
    once (XLA's fused multiply-subtract) give waits either side of an
    integer: the port charges the compiled JAX package's wait."""
    m = np.array([[2524382.0], [float.fromhex("0x1.49f488758ffffp+37")],
                  [36.0], [38195617.0]])
    args = (np.zeros(1, np.int32), np.full(1, 10**9, np.int64),
            np.full(1, 5, np.int64), np.ones(1, bool), m)
    jdelay = jax.jit(jq.mg1_delay)(*[jnp.asarray(a) for a in args])[2]
    eager = ref.eager(jq.mg1_delay)(*[jnp.asarray(a) for a in args])[2]
    tdelay = tq.mg1_delay(*[torch.from_numpy(np.array(a))
                            for a in args])[2]
    assert int(jdelay[0]) == int(tdelay[0]) == int(eager[0]) - 1


@pytest.mark.parametrize("window", [1, 2, 16, 64])
def test_keep_table_matches_jnp_power(window):
    n = np.arange(20_001, dtype=np.float64)
    want = np.asarray(jnp.power(1.0 - 1.0 / window, jnp.asarray(n)))
    _bytes_equal(want, tq.keep_table(window, 20_000, "cpu").numpy())


# ------------------------------------- tests/test_queue_models.py's shapes


def _rings(n_res=4, slots=8):
    return (torch.zeros((slots, n_res), dtype=torch.int64),
            torch.zeros((slots, n_res), dtype=torch.int64),
            torch.zeros(n_res, dtype=torch.int32))


def _t(x, dtype=torch.int64):
    return torch.tensor(x, dtype=dtype)


def test_basic_waits_for_the_horizon():
    """Unlike the history ring, ``basic`` never inserts into a past idle
    gap: an arrival before the horizon waits for it."""
    rs, re, rp = _rings()
    re[0, 0] = 2000
    q, _ = tq.basic_ring(_t([0], torch.int32), _t([100]), _t([50]),
                         torch.ones(1, dtype=torch.bool), rs, re, rp)
    assert int(q.start[0]) == 2000


def test_basic_horizon_semantics():
    q, _ = tq.basic_ring(_t([0, 0, 0], torch.int32), _t([0, 5, 100]),
                         _t([10, 10, 10]), torch.ones(3, dtype=torch.bool),
                         *_rings())
    assert q.delay.tolist() == [0, 5, 0]
    assert q.end.tolist() == [10, 20, 110]
    assert int(q.ring_end[0, 0]) == 110


def test_basic_occupancy_rows_serialize():
    rs, re, rp = _rings()
    out = tq.occupy("basic", rs, re, rp, None, _t([0, 0], torch.int32),
                    _t([0, 0]), 100, torch.ones(2, dtype=torch.bool))
    assert int(out[1][0, 0]) == 200


def test_basic_moving_average_overdelays_bursts():
    m = torch.zeros((6, 4), dtype=torch.float64)
    m[5, 0] = 64.0
    rs, re, rp = _rings()
    re[0, 0] = 1000
    args = (_t([0], torch.int32), _t([900]), _t([10]),
            torch.ones(1, dtype=torch.bool), rs, re, rp)
    q, m2 = tq.basic_ring(*args, moments=m, ma_window=64)
    q0, _ = tq.basic_ring(*args, moments=None, ma_window=0)
    assert int(q.delay[0]) > int(q0.delay[0]) == 100
    assert float(m2[5, 0]) == 64.0


def test_mg1_formula_and_empty_queue():
    m = torch.zeros((4, 4), dtype=torch.float64)
    m[:, 0] = torch.tensor([1000.0, 100000.0, 10.0, 2000.0])
    _, end, delay, new_m = tq.mg1_delay(
        _t([0], torch.int32), _t([5000]), _t([100]),
        torch.ones(1, dtype=torch.bool), m)
    mu, lam = 1.0 / 100.0, 10.0 / 2000.0
    want = int(np.ceil(0.5 * mu * lam * (1 / mu**2) / (mu - lam)))
    assert int(delay[0]) == want
    assert int(end[0]) == 5000 + want + 100
    assert float(new_m[2, 0]) == 11.0 and float(new_m[0, 0]) == 1100.0
    _, _, delay, _ = tq.mg1_delay(
        _t([0], torch.int32), _t([50]), _t([10]),
        torch.ones(1, dtype=torch.bool), torch.zeros((4, 4),
                                                     dtype=torch.float64))
    assert int(delay[0]) == 0


@pytest.mark.parametrize("qtype", tq.VALID_TYPES)
def test_probe_dispatch_all_types(qtype):
    rs, re, rp = _rings()
    m = torch.zeros((6, 4), dtype=torch.float64)
    out = tq.probe(qtype, _t([0, 1], torch.int32), _t([0, 10]),
                   _t([5, 5]), torch.ones(2, dtype=torch.bool), rs, re, rp,
                   m, ma_window=64)
    assert int(out[1][0]) == int(out[0][0]) + 5
    assert int(out[2][0]) >= 0
    assert len(tq.occupy(qtype, rs, re, rp, m, _t([0], torch.int32),
                         _t([7]), 5, torch.ones(1, dtype=torch.bool))) == 4


def test_unknown_type_rejected():
    rs, re, rp = _rings()
    m = torch.zeros((6, 4), dtype=torch.float64)
    one = torch.ones(1, dtype=torch.bool)
    with pytest.raises(ValueError, match="unknown queue model"):
        tq.probe("windowed", _t([0], torch.int32), _t([0]), _t([5]), one,
                 rs, re, rp, m)
    with pytest.raises(ValueError, match="unknown queue model"):
        tq.occupy("windowed", rs, re, rp, m, _t([0], torch.int32), _t([0]),
                  5, one)


# ------------------------------------------------------------ whole runs

RADIX4 = dict(num_tiles=4, keys_per_tile=16, radix=8, seed=2)
LIVE = ("basic_chain0",)


@pytest.mark.parametrize("qtype", ["basic", "m_g_1"])
@pytest.mark.parametrize("chain", [0, 12])
def test_dram_queue_type_changes_sim(qtype, chain):
    """tests/test_queue_models.py's end-to-end shape (64 steps on a 4-tile
    radix) under each model, at miss_chain 0 and 12 (m_g_1 through
    ``run_simulation``): every leaf, ``dram_qacc`` among them, equal to
    the JAX package's, and the model's state moved."""
    name = f"{qtype}_chain{chain}"
    over = {"general/total_cores": 4, "dram/queue_model/type": qtype,
            "tpu/miss_chain": chain}
    cj, ct = jax_load_config(), load_config()
    for c in (cj, ct):
        for k, v in over.items():
            c.set(k, v)
    jp, tp = JaxSimParams.from_config(cj), SimParams.from_config(ct)
    trace = synth.gen_radix(**RADIX4)
    tsim = Simulator(tp, trace, device="cpu")
    s = tsim.run(max_steps=64)
    assert s.done.all() and s.completion_time_ps > 0
    if qtype == "m_g_1":
        s2 = run_simulation(tp, trace, max_steps=64, device="cpu")
        assert s2.completion_time_ps == s.completion_time_ps

    def jax_leaves():
        jsim = JaxSimulator(jp, jax_synth.gen_radix(**RADIX4))
        jsim.run(max_steps=64)
        return convert.leaves_to_numpy(jax.device_get(jsim.state))

    leaves = convert.state_to_numpy(tsim.state)
    jleaves = ref.check(MODULE, name, leaves, jax_leaves,
                        ref.inputs(over, trace, steps=64),
                        live=name in LIVE)
    _bytes_equal(jleaves["dram_qacc"], leaves["dram_qacc"], "dram_qacc")
    rows = (4, 5) if qtype == "basic" else (0, 1, 2, 3)
    assert (leaves["dram_qacc"][list(rows)] != 0).any()
