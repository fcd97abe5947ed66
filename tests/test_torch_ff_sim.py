"""PyTorch port, the fast-forward path end to end (``tpu/fast_forward``).

Both packages run the same traces; every SimState leaf — the round
counters with ``ctr_ff``, ``ctr_ffq`` and ``ff_events``, caches,
predictor tables, counters — must end equal (tolerance 0: the engine is
all-integer), and so must the summary dict and its ``[fast_forward]``
render block:

  * radix8 at fast_forward 4 and run-ahead spans 0, 200 and 1000 ns (at
    span 0 only the wide window rounds run; above 0 the analytic leg
    engages);
  * fft8 with write-back at miss_chain 12, fast_forward 4, span 1000 —
    wide chain-cadence rounds, the chain replay and the analytic leg;
  * the fast_forward = 0 golden (tests/data/fast_forward_golden.json)
    through the port alone;
  * carry-across: a JAX state cut mid-run at fast_forward 4, span 1000,
    converted and finished by the port;
  * ``slow``: radix64 (keys_per_tile 64, radix 64) at fast_forward 8,
    span 1000.

The JAX package's end states come through tests/torch_jax_ref.py:
its live run on the cases in ``LIVE``, its recorded pins on the others.
"""

import functools
import json
import os

import numpy as np
import pytest
import torch

import jax

from graphite_tpu.config import load_config as jax_load_config
from graphite_tpu.engine.sim import Simulator as JaxSimulator
from graphite_tpu.events import synth as jax_synth
from graphite_tpu.params import SimParams as JaxSimParams
from graphite_tpu_torch import convert, load_config
from graphite_tpu_torch.engine.kernels import dispatch as tdispatch
from graphite_tpu_torch.engine.sim import Simulator
from graphite_tpu_torch.events import synth
from graphite_tpu_torch.params import SimParams

import torch_jax_ref as ref

RADIX8 = ("gen_radix", dict(num_tiles=8, keys_per_tile=64, radix=16,
                            seed=3))
FFT8 = ("gen_fft", dict(num_tiles=8, points_per_tile=64, writeback=True))
CASES = {
    "radix8_span0": (RADIX8, {"tpu/fast_forward": 4}),
    "radix8_span200": (RADIX8, {"tpu/fast_forward": 4,
                                "tpu/fast_forward_span": 200}),
    "radix8_span1000": (RADIX8, {"tpu/fast_forward": 4,
                                 "tpu/fast_forward_span": 1000}),
    "fft8_chain12_span1000": (FFT8, {"tpu/fast_forward": 4,
                                     "tpu/miss_chain": 12,
                                     "tpu/fast_forward_span": 1000}),
}
# The cases compared with the JAX package's live run in tier-1, its
# radix8_span1000 run shared with the carry-across test (the others with
# its recorded pins: tests/torch_jax_ref.py).
LIVE = ("radix8_span1000",)
GOLDEN = os.path.join(os.path.dirname(__file__), "data",
                      "fast_forward_golden.json")
ROUND_CTRS = ("round_ctr", "ctr_window", "ctr_complex", "ctr_conflict",
              "ctr_resolve", "ctr_quantum", "ctr_ff", "ctr_ffq", "ff_events")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The engine's CPU path is thousands of tiny ops: one intra-op
    thread per test worker is faster than contending for every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _over(T, over):
    return {"general/total_cores": T, **over}


def _params(T, over):
    cj, ct = jax_load_config(), load_config()
    for c in (cj, ct):
        for k, v in _over(T, over).items():
            c.set(k, v)
    return JaxSimParams.from_config(cj), SimParams.from_config(ct)


def _assert_leaves_equal(jleaves, tleaves):
    assert set(jleaves) == set(tleaves)
    for name in sorted(jleaves):
        a, b = np.asarray(jleaves[name]), np.asarray(tleaves[name])
        assert a.dtype == b.dtype and a.shape == b.shape, \
            (name, a.dtype, b.dtype, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=name)


def _ctrs(state):
    return {f: int(getattr(state, f)) for f in ROUND_CTRS}


@functools.lru_cache(maxsize=None)
def _jax_run(name):
    """The JAX package's whole run of a case, shared by the tests."""
    (fn, kw), over = CASES[name]
    jp, _ = _params(kw["num_tiles"], over)
    jsim = JaxSimulator(jp, getattr(jax_synth, fn)(**kw))
    jsum = jsim.run(max_steps=4096)
    return jsim, jsum


def _summary_dict(s):
    d = s.to_dict()
    for k in ("host_seconds", "simulated_mips"):
        d.pop(k)
    return d


def _ff_block(render):
    lines = render.splitlines()
    i = lines.index("[fast_forward]")
    return lines[i:i + 4]


def _with_summary(leaves, s):
    """The flat leaves and, as two more, the summary's dict (less its
    host timings) and the render's fast-forward block, as bytes."""
    d = json.dumps(_summary_dict(s), sort_keys=True,
                   default=lambda x: x.item())
    block = "\n".join(_ff_block(s.render()))
    return {**leaves, "summary": np.frombuffer(d.encode(), np.uint8),
            "ff_block": np.frombuffer(block.encode(), np.uint8)}


@functools.lru_cache(maxsize=None)
def _port_run(name):
    """The port's whole run of a case on the CPU, shared by the tests that
    read it: the simulator, its summary and the analytic rounds in which
    some tile engaged (its end state equals the JAX package's:
    test_ff_run_ends_with_equal_state)."""
    (fn, kw), over = CASES[name]
    _, tp = _params(kw["num_tiles"], over)
    tsim = Simulator(tp, getattr(synth, fn)(**kw), device="cpu")
    tdispatch.reset_counts()
    tsum = tsim.run(max_steps=4096)
    return tsim, tsum, tdispatch.COUNTS["ff_engaged"]


@pytest.mark.parametrize("name", sorted(CASES))
def test_ff_run_ends_with_equal_state(name):
    (fn, kw), over = CASES[name]
    tsim, tsum, engaged = _port_run(name)
    assert bool(tsim.state.done.all())
    # The host's count of analytic rounds in which some tile engaged:
    # none at span 0.  Every engine round is a window round, a complex
    # slot, a conflict round, a chain pass (one per resolve pass at
    # P > 0) or an engaged analytic round.
    c = _ctrs(tsim.state)
    assert (engaged > 0) == ("tpu/fast_forward_span" in over)
    passes = c["ctr_resolve"] if "tpu/miss_chain" in over else 0
    assert c["round_ctr"] == c["ctr_window"] + c["ctr_complex"] \
        + c["ctr_conflict"] + passes + engaged

    def jax_leaves():
        jsim, jsum = _jax_run(name)
        return _with_summary(
            convert.leaves_to_numpy(jax.device_get(jsim.state)), jsum)

    ref.check("test_torch_ff_sim", name,
              _with_summary(convert.state_to_numpy(tsim.state), tsum),
              jax_leaves, ref.inputs(_over(kw["num_tiles"], over),
                                     tsim.trace, steps=4096),
              live=name in LIVE)
    assert tsum.ff_rounds > 0 and tsum.ff_quanta > 0




def test_span_engages_the_analytic_leg():
    """The analytic leg engages above span 0: more events priced in
    closed form at span 1000 than at span 0 (where only the wide window
    rounds count), on radix8 and on the fft8 chain-12 trace; the values
    are the JAX package's (the runs' end states equal its own)."""
    r0 = _ctrs(_port_run("radix8_span0")[0].state)
    r1 = _ctrs(_port_run("radix8_span1000")[0].state)
    assert r1["ff_events"] > r0["ff_events"] and r1["ctr_ff"] > r0["ctr_ff"]
    assert (r0["round_ctr"], r0["ctr_ff"], r0["ctr_ffq"],
            r0["ff_events"]) == (467, 11, 6, 386)
    assert (r1["round_ctr"], r1["ctr_ff"], r1["ctr_ffq"],
            r1["ff_events"]) == (469, 13, 6, 638)
    f1 = _ctrs(_port_run("fft8_chain12_span1000")[0].state)
    assert (f1["round_ctr"], f1["ctr_ff"], f1["ctr_ffq"],
            f1["ff_events"]) == (84, 32, 12, 5901)
    # fft8 chain 12 at span 0 prices 5,245 events in wide rounds alone.
    assert f1["ff_events"] > 5245


@pytest.mark.parametrize("name", ["radix8", "fft8"])
def test_port_reproduces_ff_off_golden(name):
    """fast_forward = 0 is the exact engine: the port alone reproduces the
    JAX package's ff-off golden."""
    gold = json.load(open(GOLDEN))[name]
    trace = synth.gen_radix(num_tiles=8, keys_per_tile=64, radix=16,
                            seed=3) if name == "radix8" \
        else synth.gen_fft(num_tiles=8, points_per_tile=64)
    _, tp = _params(8, {"tpu/fast_forward": 0})
    sim = Simulator(tp, trace, device="cpu")
    s = sim.run(max_steps=256)
    assert s.done.all()
    assert s.completion_time_ps == gold["completion_time_ps"]
    assert s.clock.tolist() == gold["clock"]
    for f, want in gold["round_ctrs"].items():
        assert int(getattr(sim.state, f)) == want, f
    for k, want in gold["counters"].items():
        assert s.counters[k].tolist() == want, k
    assert "[fast_forward]" not in s.render()
    assert "ff_rounds" not in s.to_dict()


def test_carry_across_mid_run_ff_state():
    """The state two megasteps into the radix8 span-1000 run, with
    analytic rounds already engaged, carried through ``convert``,
    finishes in the port exactly as the JAX run finishes (both states
    the JAX package's: its pins, or its run)."""
    (fn, kw), over = CASES["radix8_span1000"]
    jp, tp = _params(8, over)
    tsim = Simulator(tp, getattr(synth, fn)(**kw), device="cpu")
    tsim.run(max_steps=2)

    def jax_cut():
        jsim = JaxSimulator(jp, getattr(jax_synth, fn)(**kw))
        jsim.run(max_steps=2)
        return convert.leaves_to_numpy(jax.device_get(jsim.state))

    leaves = ref.check("test_torch_ff_sim", "carry_cut",
                       convert.state_to_numpy(tsim.state), jax_cut,
                       ref.inputs(_over(8, over), tsim.trace, steps=2),
                       live="radix8_span1000" in LIVE)
    assert int(leaves["ctr_ff"]) > 0 and not leaves["done"].all()
    tsim = Simulator(tp, getattr(synth, fn)(**kw), device="cpu")
    tsim.state = convert.state_from_numpy(tp, leaves, "cpu")
    _assert_leaves_equal(leaves, convert.state_to_numpy(tsim.state))
    tsim.run(max_steps=4096)
    ref.check("test_torch_ff_sim", "carry_end",
              convert.state_to_numpy(tsim.state),
              lambda: convert.leaves_to_numpy(jax.device_get(
                  _jax_run("radix8_span1000")[0].state)),
              ref.inputs(_over(8, over), tsim.trace, steps=2, more=4096),
              live="radix8_span1000" in LIVE)


@pytest.mark.slow
def test_radix64_ff8_span1000_matches_jax():
    """T = 64 at the default geometry, fast_forward 8 (F = 64), span
    1000 (depth cut to keep it a test: keys_per_tile 64, radix 64)."""
    kw = dict(num_tiles=64, keys_per_tile=64, radix=64, seed=3)
    over = {"tpu/fast_forward": 8, "tpu/fast_forward_span": 1000}
    jp, tp = _params(64, over)
    jsim = JaxSimulator(jp, jax_synth.gen_radix(**kw))
    jsim.run(max_steps=4096)
    tsim = Simulator(tp, synth.gen_radix(**kw), device="cpu")
    s = tsim.run(max_steps=4096)
    _assert_leaves_equal(convert.leaves_to_numpy(jax.device_get(jsim.state)),
                         convert.state_to_numpy(tsim.state))
    assert int(tsim.state.round_ctr) == 1438
    assert s.completion_time_ps == 25_961_800
