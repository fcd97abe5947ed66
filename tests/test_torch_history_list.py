"""PyTorch port, the ``history_list`` DRAM queue model against the JAX
package on the CPU.  The JAX package prices ``history_list`` and
``history_tree`` through the same busy-interval ring (its
``queue_models.probe`` / ``occupy``), so the port admits both: whole
runs at T = 8 under ``history_list``, at miss_chain 0 and 12, end with
every SimState leaf equal to the JAX package's (tolerance 0): its live run
at miss_chain 0, its recorded pin at 12 (tests/torch_jax_ref.py).
The ``basic`` and ``m_g_1`` models are tests/test_torch_queue_models.py's;
here ``m_g_1`` beside miss-type tracking is refused by the latter.
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

RADIX8 = dict(num_tiles=8, keys_per_tile=64, radix=16, seed=3)
MAX_STEPS = 4096


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _over(queue, chain):
    return {"general/total_cores": 8, "dram/queue_model/type": queue,
            "tpu/miss_chain": chain}


def _params(over):
    cj, ct = jax_load_config(), load_config()
    for c in (cj, ct):
        for k, v in over.items():
            c.set(k, v)
    return JaxSimParams.from_config(cj), SimParams.from_config(ct)


@pytest.mark.parametrize("chain", [0, 12])
def test_history_list_run_matches_jax(chain):
    over = _over("history_list", chain)
    jp, tp = _params(over)
    assert tp.dram.queue_model_type == "history_list"
    tsim = Simulator(tp, synth.gen_radix(**RADIX8), device="cpu")
    tsim.run(max_steps=MAX_STEPS)
    assert bool(tsim.state.done.all())

    def jax_leaves():
        jsim = JaxSimulator(jp, jax_synth.gen_radix(**RADIX8))
        jsim.run(max_steps=MAX_STEPS)
        return convert.leaves_to_numpy(jax.device_get(jsim.state))

    ref.check("test_torch_history_list", f"radix8_chain{chain}",
              convert.state_to_numpy(tsim.state), jax_leaves,
              ref.inputs(over, tsim.trace, steps=MAX_STEPS),
              live=chain == 0)
    # The queue priced DRAM waits: the ring holds busy intervals.
    assert bool((tsim.state.dram_ring_end > 0).any())


def test_m_g_1_queue_refused_at_construction():
    # The m_g_1 queue and miss-type tracking run
    # (tests/test_torch_queue_models.py, tests/test_torch_miss_types.py);
    # beside streaming ingest, which stays refused, the configuration is
    # refused by that key.
    _, tp = _params({**_over("m_g_1", 0),
                     "l2_cache/T1/track_miss_types": True,
                     "trace/segment_events": 4096})
    assert tp.dram.queue_model_type == "m_g_1"
    with pytest.raises(NotImplementedError, match="streaming"):
        Simulator(tp, synth.gen_radix(**RADIX8), device="cpu")
