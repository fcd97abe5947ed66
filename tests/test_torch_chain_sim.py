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


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The engine's CPU path is thousands of tiny ops: one intra-op
    thread per test worker is faster than contending for every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params(T, over):
    cj, ct = jax_load_config(), load_config()
    for c in (cj, ct):
        c.set("general/total_cores", T)
        for k, v in {**CHAIN, **over}.items():
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
    jsim, tsim = _run_both(fn, kw, over)
    assert bool(tsim.state.done.all())
    _assert_leaves_equal(convert.leaves_to_numpy(jax.device_get(jsim.state)),
                         convert.state_to_numpy(tsim.state))
    if name == "radix8":
        # The radix8_pallas bench row's round count, and the completion
        # chip_smoke.py pins for the same run on the card.
        assert int(tsim.state.round_ctr) == 86
        assert int(tsim.state.clock.max()) == 8_686_600


def test_carry_across_mid_chain_state():
    fn, kw, over = CASES["fft8_writeback"]
    jp, tp = _params(8, over)
    jsim = JaxSimulator(jp, getattr(jax_synth, fn)(**kw))
    qstep = jax.jit(lambda s: jquantum.quantum_step(jp, s, jsim.trace))
    ladv = jax.jit(lambda s: jcore.local_advance(jp, s, jsim.trace))
    st = jsim.state
    for _ in range(6):                    # a few quanta into the run
        st = qstep(st)
    # Open the next quantum as quantum_step does, and cut after its first
    # local advance: the window rounds have banked chains that no resolve
    # pass has served yet.
    st = st._replace(boundary=jquantum.next_boundary(jp, st),
                     ctr_quantum=st.ctr_quantum + 1)
    cut = jax.device_get(ladv(st))
    assert not np.asarray(cut.done).all()
    assert (np.asarray(cut.mq_count) > 0).any(), "the cut holds no chain"
    leaves = convert.leaves_to_numpy(cut)
    tst = convert.state_from_numpy(tp, leaves, "cpu")
    _assert_leaves_equal(leaves, convert.state_to_numpy(tst))
    ttr = convert.trace_from_numpy(np.asarray(jsim.trace.addr),
                                   np.asarray(jsim.trace.meta), "cpu")

    # The resolve pass that serves the cut's banks, then whole quanta.
    jres = jax.jit(lambda s: jresolve.resolve(jp, s))(jax.device_put(cut))
    tres = tresolve.resolve(tp, tst)
    _assert_leaves_equal(convert.leaves_to_numpy(jax.device_get(jres)),
                         convert.state_to_numpy(tres))
    q = jp.quanta_per_step
    jnext = jax.device_get(jquantum.megarun(jp, jres, jsim.trace, q))
    tnext = tquantum.megarun(tp, tres, ttr, q)
    _assert_leaves_equal(convert.leaves_to_numpy(jnext),
                         convert.state_to_numpy(tnext))
    # And the port's local advance from the same cut point agrees too.
    tcut = tcore.local_advance(tp, convert.state_from_numpy(
        tp, convert.leaves_to_numpy(jax.device_get(st)), "cpu"), ttr)
    _assert_leaves_equal(leaves, convert.state_to_numpy(tcut))


@pytest.mark.slow
def test_radix64_chain12_matches_jax():
    """T = 64 at the default geometry, chain 12 (depth cut to keep it a
    test: keys_per_tile 64)."""
    kw = dict(num_tiles=64, keys_per_tile=64, radix=256, seed=0)
    jsim, tsim = _run_both("gen_radix", kw, {})
    _assert_leaves_equal(convert.leaves_to_numpy(jax.device_get(jsim.state)),
                         convert.state_to_numpy(tsim.state))
