"""PyTorch port, the whole slice: the default-config simulator end to end.

  * The port alone reproduces tests/data/chain_off_golden.json (radix8 and
    fft8): per-tile clocks, completion, every counter, every round counter.
  * Both packages, run on the same radix8 trace, end with every SimState
    leaf equal (value and dtype; the uint64 sharer bitmap as int64 bits).
  * Carry-across: the JAX state after two megasteps, converted with
    graphite_tpu_torch.convert, runs one more megastep in both packages
    to equal states.
All comparisons are exact (tolerance 0: the engine is all-integer).
"""

import json
import os

import numpy as np
import pytest

import jax

from graphite_tpu.config import load_config as jax_load_config
from graphite_tpu.engine import quantum as jquantum
from graphite_tpu.engine import state as jstate
from graphite_tpu.engine.sim import Simulator as JaxSimulator
from graphite_tpu.events import synth as jax_synth
from graphite_tpu.params import SimParams as JaxSimParams
from graphite_tpu_torch import convert, load_config
from graphite_tpu_torch.engine import quantum as tquantum
from graphite_tpu_torch.engine import state as tstate
from graphite_tpu_torch.engine.sim import Simulator
from graphite_tpu_torch.events import synth
from graphite_tpu_torch.params import SimParams

GOLDEN = os.path.join(os.path.dirname(__file__), "data",
                      "chain_off_golden.json")
ROUND_CTRS = ("ctr_quantum", "ctr_window", "ctr_complex", "ctr_conflict",
              "ctr_resolve", "round_ctr")

# The traces and overrides of test_block_equivalence.py's golden test.
CASES = {
    "radix8": dict(fn="gen_radix", kw=dict(num_tiles=8, keys_per_tile=64,
                                           radix=16, seed=3)),
    "fft8": dict(fn="gen_fft", kw=dict(num_tiles=8, points_per_tile=64)),
}


def _params(T, **over):
    cj, ct = jax_load_config(), load_config()
    for c in (cj, ct):
        c.set("general/total_cores", T)
        for k, v in over.items():
            c.set(k, v)
    return JaxSimParams.from_config(cj), SimParams.from_config(ct)


def _assert_leaves_equal(jleaves, tleaves):
    assert set(jleaves) == set(tleaves)
    for name in sorted(jleaves):
        a, b = np.asarray(jleaves[name]), np.asarray(tleaves[name])
        assert a.dtype == b.dtype and a.shape == b.shape, \
            (name, a.dtype, b.dtype, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("name", sorted(CASES))
def test_port_reproduces_chain_off_golden(name):
    gold = json.load(open(GOLDEN))[name]
    case = CASES[name]
    _, tp = _params(8, **{"tpu/miss_chain": 0})
    sim = Simulator(tp, getattr(synth, case["fn"])(**case["kw"]),
                    device="cpu")
    s = sim.run(max_steps=256)
    assert s.done.all()
    assert s.completion_time_ps == gold["completion_time_ps"]
    assert s.clock.tolist() == gold["clock"]
    for f, want in gold["round_ctrs"].items():
        assert int(getattr(sim.state, f)) == want, f
    for k, want in gold["counters"].items():
        assert s.counters[k].tolist() == want, k


def test_initial_state_leaves_match():
    jp, tp = _params(8)
    trace = synth.gen_radix(num_tiles=8, keys_per_tile=16, radix=16, seed=0)
    jl = convert.leaves_to_numpy(jax.device_get(
        jstate.make_state(jp, has_capi=False, num_streams=8)))
    tl = convert.leaves_to_numpy(
        Simulator(tp, trace, device="cpu").state)
    jl["dir_sharers"] = jl["dir_sharers"].view(np.int64)
    _assert_leaves_equal(jl, tl)


@pytest.fixture(scope="module")
def radix8_jax():
    """One JAX radix8 simulator, advanced two megasteps (for the
    carry-across test) and then to the end."""
    jp, _ = _params(8)
    trace = jax_synth.gen_radix(num_tiles=8, keys_per_tile=64, radix=16,
                                seed=3)
    sim = JaxSimulator(jp, trace)
    sim.run(max_steps=2)
    mid = jax.device_get(sim.state)
    sim.run(max_steps=256)
    return jp, sim, mid


def test_both_packages_end_radix8_with_equal_state(radix8_jax):
    _, jsim, _ = radix8_jax
    _, tp = _params(8)
    tsim = Simulator(tp, synth.gen_radix(num_tiles=8, keys_per_tile=64,
                                         radix=16, seed=3), device="cpu")
    tsim.run(max_steps=256)
    assert bool(tsim.state.done.all())
    _assert_leaves_equal(convert.leaves_to_numpy(jax.device_get(jsim.state)),
                         convert.state_to_numpy(tsim.state))


def test_carry_across_mid_run_state(radix8_jax):
    jp, jsim, mid = radix8_jax
    _, tp = _params(8)
    leaves = convert.leaves_to_numpy(mid)
    tst = convert.state_from_numpy(tp, leaves, "cpu")
    # The conversion itself is lossless, and back again.
    _assert_leaves_equal(leaves, convert.state_to_numpy(tst))
    jtr = jsim.trace
    ttr = convert.trace_from_numpy(np.asarray(jtr.addr),
                                   np.asarray(jtr.meta), "cpu")
    q = jp.quanta_per_step
    jnext = jax.device_get(jquantum.megarun(jp, jax.device_put(mid), jtr, q))
    tnext = tquantum.megarun(tp, tst, ttr, q)
    assert int(tnext.ctr_quantum) == int(mid.ctr_quantum) + q
    _assert_leaves_equal(convert.leaves_to_numpy(jnext),
                         convert.state_to_numpy(tnext))
    assert tstate.SimState._fields == jstate.SimState._fields


@pytest.mark.slow
def test_radix64_default_geometry_matches_jax():
    """T = 64 at the default geometry (depth cut to keep it a test)."""
    jp, tp = _params(64)
    kw = dict(num_tiles=64, keys_per_tile=64, radix=256, seed=0)
    jsim = JaxSimulator(jp, jax_synth.gen_radix(**kw))
    jsim.run()
    tsim = Simulator(tp, synth.gen_radix(**kw), device="cpu")
    tsim.run()
    _assert_leaves_equal(convert.leaves_to_numpy(jax.device_get(jsim.state)),
                         convert.state_to_numpy(tsim.state))
