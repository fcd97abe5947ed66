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
import torch

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

import torch_jax_ref as ref


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The engine's CPU path is thousands of tiny ops: one intra-op
    thread per test worker is faster than contending for every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


RADIX8 = dict(num_tiles=8, keys_per_tile=64, radix=16, seed=3)
R8_OVER = {"general/total_cores": 8}


@pytest.fixture(scope="module")
def radix8_jax():
    """The JAX package's radix8 run, made at the first need: its state
    after two megasteps (``mid``), one more megastep from there
    (``next``), and its end state (``end``), as flat leaves."""
    states = {}

    def get(which):
        if not states:
            jp, _ = _params(8)
            sim = JaxSimulator(jp, jax_synth.gen_radix(**RADIX8))
            sim.run(max_steps=2)
            mid = jax.device_get(sim.state)
            nxt = jquantum.megarun(jp, jax.device_put(mid), sim.trace,
                                   jp.quanta_per_step)
            sim.run(max_steps=256)
            states.update(mid=convert.leaves_to_numpy(mid),
                          next=convert.leaves_to_numpy(jax.device_get(nxt)),
                          end=convert.leaves_to_numpy(
                              jax.device_get(sim.state)))
        return states[which]
    return get


def test_both_packages_end_radix8_with_equal_state(radix8_jax):
    _, tp = _params(8)
    tsim = Simulator(tp, synth.gen_radix(**RADIX8), device="cpu")
    tsim.run(max_steps=256)
    assert bool(tsim.state.done.all())
    ref.check("test_torch_sim", "radix8_end",
              convert.state_to_numpy(tsim.state), lambda: radix8_jax("end"),
              ref.inputs(R8_OVER, tsim.trace, steps=256), live=True)


def test_carry_across_mid_run_state(radix8_jax):
    """The state two megasteps into the run (the JAX package's: its pins,
    or its run), carried through ``convert``, runs one more megastep to
    the JAX package's state."""
    _, tp = _params(8)
    tsim = Simulator(tp, synth.gen_radix(**RADIX8), device="cpu")
    tsim.run(max_steps=2)
    leaves = ref.check("test_torch_sim", "radix8_mid",
                       convert.state_to_numpy(tsim.state),
                       lambda: radix8_jax("mid"),
                       ref.inputs(R8_OVER, tsim.trace, steps=2), live=True)
    tst = convert.state_from_numpy(tp, leaves, "cpu")
    # The conversion itself is lossless, and back again.
    _assert_leaves_equal(leaves, convert.state_to_numpy(tst))
    q = tp.quanta_per_step
    tnext = tquantum.megarun(tp, tst, tsim.trace, q)
    assert int(tnext.ctr_quantum) == int(leaves["ctr_quantum"]) + q
    ref.check("test_torch_sim", "radix8_next", convert.state_to_numpy(tnext),
              lambda: radix8_jax("next"),
              ref.inputs(R8_OVER, tsim.trace, steps=2, more=q), live=True)
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
