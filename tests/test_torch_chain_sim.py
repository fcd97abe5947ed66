"""PyTorch port, the chain replay end to end (``tpu/miss_chain = 12``).

Both packages run the same traces; every SimState leaf — round counters,
the [P, T] chain bank, caches, directory, counters — must end equal
(tolerance 0: the engine is all-integer):

  * radix8 (the ``radix8_pallas`` bench shape: 86 engine rounds);
  * fft8 with write-back;
  * radix8 with the DRAM queue model off (the classify step then owns
    the completion and the floor write);
  * carry-across: a JAX state cut mid-chain (after a local advance, with
    banked elements) goes through one resolve pass and then whole quanta
    in both packages.

The JAX package's end states come through tests/torch_jax_ref.py:
its live run on the cases in ``LIVE``, its recorded pins on the others.
"""

import numpy as np
import pytest
import torch

import jax

from graphite_tpu.config import load_config as jax_load_config
from graphite_tpu.engine import core as jcore
from graphite_tpu.engine import quantum as jquantum
from graphite_tpu.engine import resolve as jresolve
from graphite_tpu.engine.sim import Simulator as JaxSimulator
from graphite_tpu.events import synth as jax_synth
from graphite_tpu.params import SimParams as JaxSimParams
from graphite_tpu_torch import convert, load_config
from graphite_tpu_torch.engine import core as tcore
from graphite_tpu_torch.engine import quantum as tquantum
from graphite_tpu_torch.engine import resolve as tresolve
from graphite_tpu_torch.engine.sim import Simulator
from graphite_tpu_torch.events import synth
from graphite_tpu_torch.params import SimParams

import torch_jax_ref as ref

CHAIN = {"tpu/miss_chain": 12}
CASES = {
    "radix8": ("gen_radix", dict(num_tiles=8, keys_per_tile=64, radix=16,
                                 seed=3), {}),
    "fft8_writeback": ("gen_fft", dict(num_tiles=8, points_per_tile=64,
                                       writeback=True), {}),
    "radix8_queue_off": ("gen_radix", dict(num_tiles=8, keys_per_tile=64,
                                           radix=16, seed=3),
                         {"dram/queue_model/enabled": False}),
}
# The cases compared with the JAX package's live run in tier-1 (the
# others with its recorded pins: tests/torch_jax_ref.py).
LIVE = ("radix8",)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The engine's CPU path is thousands of tiny ops: one intra-op
    thread per test worker is faster than contending for every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _over(T, over):
    return {"general/total_cores": T, **CHAIN, **over}


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


def _run_both(fn, kw, over, max_steps=4096):
    jp, tp = _params(kw["num_tiles"], over)
    jsim = JaxSimulator(jp, getattr(jax_synth, fn)(**kw))
    jsim.run(max_steps=max_steps)
    tsim = Simulator(tp, getattr(synth, fn)(**kw), device="cpu")
    tsim.run(max_steps=max_steps)
    return jsim, tsim


@pytest.mark.parametrize("name", sorted(CASES))
def test_chain_run_ends_with_equal_state(name):
    fn, kw, over = CASES[name]
    jp, tp = _params(kw["num_tiles"], over)
    tsim = Simulator(tp, getattr(synth, fn)(**kw), device="cpu")
    tsim.run(max_steps=4096)
    assert bool(tsim.state.done.all())

    def jax_leaves():
        jsim = JaxSimulator(jp, getattr(jax_synth, fn)(**kw))
        jsim.run(max_steps=4096)
        return convert.leaves_to_numpy(jax.device_get(jsim.state))

    ref.check("test_torch_chain_sim", name,
              convert.state_to_numpy(tsim.state), jax_leaves,
              ref.inputs(_over(kw["num_tiles"], over), tsim.trace,
                         steps=4096), live=name in LIVE)
    if name == "radix8":
        # The radix8_pallas bench row's round count, and the completion
        # chip_smoke.py pins for the same run on the card.
        assert int(tsim.state.round_ctr) == 86
        assert int(tsim.state.clock.max()) == 8_686_600


def test_carry_across_mid_chain_state():
    """A few quanta into the fft8 chain-12 run, the next quantum opened and
    cut after its first local advance (the window rounds have banked
    chains that no resolve pass has served yet): that state, carried
    through ``convert``, goes through the resolve pass that serves the
    banks and a whole megastep more.  Every state equal to the JAX
    package's (its pins, or its run)."""
    fn, kw, over = CASES["fft8_writeback"]
    jp, tp = _params(8, over)
    tsim = Simulator(tp, getattr(synth, fn)(**kw), device="cpu")
    ttr = tsim.trace
    st = tsim.state
    for _ in range(6):                    # a few quanta into the run
        st = tquantum.quantum_step(tp, st, ttr)
    # Open the next quantum as quantum_step does.
    st = st._replace(boundary=tquantum.next_boundary(tp, st),
                     ctr_quantum=st.ctr_quantum + 1)
    jax_states = {}

    def jax_state(which):
        if not jax_states:
            jsim = JaxSimulator(jp, getattr(jax_synth, fn)(**kw))
            qstep = jax.jit(lambda s: jquantum.quantum_step(jp, s,
                                                            jsim.trace))
            jst = jsim.state
            for _ in range(6):
                jst = qstep(jst)
            jst = jst._replace(boundary=jquantum.next_boundary(jp, jst),
                               ctr_quantum=jst.ctr_quantum + 1)
            cut = jax.jit(lambda s: jcore.local_advance(jp, s, jsim.trace))(
                jst)
            res = jax.jit(lambda s: jresolve.resolve(jp, s))(cut)
            nxt = jquantum.megarun(jp, res, jsim.trace, jp.quanta_per_step)
            jax_states.update({k: convert.leaves_to_numpy(jax.device_get(v))
                               for k, v in (("open", jst), ("cut", cut),
                                            ("res", res), ("next", nxt))})
        return jax_states[which]

    def check(which, state):
        return ref.check("test_torch_chain_sim", f"carry_{which}",
                         convert.state_to_numpy(state),
                         lambda: jax_state(which),
                         ref.inputs(_over(8, over), ttr, quanta=6,
                                    which=which), live="carry" in LIVE)

    check("open", st)
    leaves = check("cut", tcore.local_advance(tp, st, ttr))
    assert not leaves["done"].all()
    assert (leaves["mq_count"] > 0).any(), "the cut holds no chain"
    tst = convert.state_from_numpy(tp, leaves, "cpu")
    _assert_leaves_equal(leaves, convert.state_to_numpy(tst))
    tres = tresolve.resolve(tp, tst)
    check("res", tres)
    check("next", tquantum.megarun(tp, tres, ttr, tp.quanta_per_step))


@pytest.mark.slow
def test_radix64_chain12_matches_jax():
    """T = 64 at the default geometry, chain 12 (depth cut to keep it a
    test: keys_per_tile 64)."""
    kw = dict(num_tiles=64, keys_per_tile=64, radix=256, seed=0)
    jsim, tsim = _run_both("gen_radix", kw, {})
    _assert_leaves_equal(convert.leaves_to_numpy(jax.device_get(jsim.state)),
                         convert.state_to_numpy(tsim.state))
