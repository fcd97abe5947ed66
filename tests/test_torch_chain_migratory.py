"""PyTorch port, the chain replay on migratory sharing: every line moves
from tile to tile, so chain heads meet owner flushes and invalidation
fan-outs.  With the fan-out replay on, multi-sharer heads are served
inside the chain pass (``chain_fanout_served`` > 0); with it off they
hard-stop into the conflict rounds.  Both packages run
``gen_migratory(8, lines=8, rounds=4)`` at ``tpu/miss_chain = 12``, and
every SimState leaf must end equal (tolerance 0).

The JAX package's end states come through tests/torch_jax_ref.py:
its live run on the cases in ``LIVE``, its recorded pins on the others.
"""

import pytest
import torch

import jax

from graphite_tpu.config import load_config as jax_load_config
from graphite_tpu.engine.sim import Simulator as JaxSimulator
from graphite_tpu.events import synth as jax_synth
from graphite_tpu.params import SimParams as JaxSimParams
from graphite_tpu_torch import convert, load_config
from graphite_tpu_torch.engine.sim import Simulator
from graphite_tpu_torch.events import synth
from graphite_tpu_torch.params import SimParams

import torch_jax_ref as ref

KW = dict(num_tiles=8, lines=8, rounds=4)
# The cases compared with the JAX package's live run in tier-1 (the
# others with its recorded pins: tests/torch_jax_ref.py).
LIVE = ("fanout_on",)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The engine's CPU path is thousands of tiny ops: one intra-op
    thread per test worker is faster than contending for every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("fanout", [True, False], ids=["fanout_on",
                                                       "fanout_off"])
def test_migratory_chain_run_ends_with_equal_state(fanout):
    over = {"general/total_cores": 8, "tpu/miss_chain": 12,
            "tpu/fanout_replay": fanout}
    cj, ct = jax_load_config(), load_config()
    for c in (cj, ct):
        for k, v in over.items():
            c.set(k, v)
    tsim = Simulator(SimParams.from_config(ct), synth.gen_migratory(**KW),
                     device="cpu")
    tsim.run(max_steps=4096)
    assert bool(tsim.state.done.all())

    def jax_leaves():
        jsim = JaxSimulator(JaxSimParams.from_config(cj),
                            jax_synth.gen_migratory(**KW))
        jsim.run(max_steps=4096)
        return convert.leaves_to_numpy(jax.device_get(jsim.state))

    name = "fanout_on" if fanout else "fanout_off"
    ref.check("test_torch_chain_migratory", name,
              convert.state_to_numpy(tsim.state), jax_leaves,
              ref.inputs(over, tsim.trace, steps=4096), live=name in LIVE)
    served = int(tsim.state.counters.chain_fanout_served.sum())
    if fanout:
        assert served > 0
    else:
        assert served == 0 and int(tsim.state.ctr_conflict) > 0
