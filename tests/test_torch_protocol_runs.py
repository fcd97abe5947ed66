"""PyTorch port, the coherence protocols in whole runs against the JAX
package on the CPU: MOSI (``pr_l1_pr_l2_dram_directory_mosi``), shared-L2
MSI (``pr_l1_sh_l2_msi``) and shared-L2 MESI (``pr_l1_sh_l2_mesi``), at
``tpu/miss_chain`` 0 and 12 and at ``tpu/fast_forward = 8`` with a
run-ahead span of 1000 ns.  Each run ends with every SimState leaf
(round counters, directory words and sharer bitmaps, every cache word
and counter) equal to the JAX package's, tolerance 0.

The traces are those of the JAX package's own protocol tests:
``gen_migratory(8, lines=6, rounds=3)`` (tests/test_mosi.py's and
tests/test_shared_l2.py's invariants tests), tests/test_mosi.py's radix
trace, tests/test_block_equivalence.py's ``test_mosi_equivalent`` and
``test_shared_l2_equivalent`` traces and tests/test_kernels.py's
shared-L2 MESI radix trace.  The hand-built traces of those tests run in
test_torch_protocols.py.  A carry-across test takes a shared-L2 MESI
state from the JAX package into the port mid-run.  The JAX package's
end states come through tests/torch_jax_ref.py: its live run on the
cases in ``LIVE``, its recorded pins on the others.
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
from graphite_tpu_torch.events import synth as tsynth
from graphite_tpu_torch.params import SimParams

import torch_jax_ref as ref

MOSI = "pr_l1_pr_l2_dram_directory_mosi"
SH_MSI = "pr_l1_sh_l2_msi"
SH_MESI = "pr_l1_sh_l2_mesi"
CHAIN12 = {"tpu/miss_chain": 12}
FF_SPAN = {"tpu/fast_forward": 8, "tpu/fast_forward_span": 1000}


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
        for k, v in over.items():
            c.set(k, v)
    return JaxSimParams.from_config(cj), SimParams.from_config(ct)


# ---- the generated traces: (generator, kwargs)
MIGRATORY = ("gen_migratory", dict(num_tiles=8, lines=6, rounds=3))
RADIX_KERNELS = ("gen_radix", dict(num_tiles=8, keys_per_tile=32, radix=16,
                                   seed=11))
RADIX_MOSI = ("gen_radix", dict(num_tiles=8, keys_per_tile=48, radix=16,
                                seed=9))
RADIX_SH = ("gen_radix", dict(num_tiles=8, keys_per_tile=48, radix=16,
                              seed=11))
RADIX64KEYS = ("gen_radix", dict(num_tiles=8, keys_per_tile=64, radix=16))

# name: (trace, protocol, config overrides)
GENERATED = {
    "migratory_mosi": (MIGRATORY, MOSI, {}),
    "migratory_mosi_chain12": (MIGRATORY, MOSI, CHAIN12),
    "migratory_sh_msi": (MIGRATORY, SH_MSI, {}),
    "migratory_sh_msi_chain12": (MIGRATORY, SH_MSI, CHAIN12),
    "migratory_sh_mesi": (MIGRATORY, SH_MESI, {}),
    "migratory_sh_mesi_chain12": (MIGRATORY, SH_MESI, CHAIN12),
    "migratory_sh_mesi_chain12_ff": (MIGRATORY, SH_MESI,
                                     {**CHAIN12, **FF_SPAN}),
    "radix_kernels_sh_mesi": (RADIX_KERNELS, SH_MESI, {}),
    "radix_kernels_sh_mesi_chain12": (RADIX_KERNELS, SH_MESI, CHAIN12),
    "radix_kernels_sh_mesi_ff": (RADIX_KERNELS, SH_MESI, FF_SPAN),
    "radix_equivalent_mosi": (RADIX_MOSI, MOSI, {}),
    "radix_equivalent_sh_mesi": (RADIX_SH, SH_MESI, {}),
    "radix_mosi_chain12": (RADIX64KEYS, MOSI, CHAIN12),
}
# The cases compared with the JAX package's live run in tier-1 (the
# others with its recorded pins: tests/torch_jax_ref.py).
LIVE = ("migratory_sh_mesi_chain12",)


_assert_leaves_equal = ref.assert_leaves_equal


def _both(key, T, over, jtrace, ttrace):
    """Run the port to the end, every leaf equal to the JAX package's
    (torch_jax_pins: its pins, or its run); returns the port's
    summary."""
    jp, tp = _params(T, over)
    tsim = Simulator(tp, ttrace, device="cpu")
    s = tsim.run(max_steps=4096)
    assert bool(s.done.all())

    def jax_leaves():
        jsim = JaxSimulator(jp, jtrace())
        jsim.run(max_steps=4096)
        return convert.leaves_to_numpy(jax.device_get(jsim.state))

    ref.check("test_torch_protocol_runs", key,
              convert.state_to_numpy(tsim.state), jax_leaves,
              ref.inputs({"general/total_cores": T, **over}, tsim.trace,
                         steps=4096), live=key in LIVE)
    return s


def _sum(s, k):
    return int(s.counters[k].sum())


@pytest.mark.parametrize("name", sorted(GENERATED))
def test_generated_trace_matches_jax(name):
    (fn, kw), proto, over = GENERATED[name]
    s = _both(name, kw["num_tiles"],
              {"caching_protocol/type": proto, **over},
              lambda: getattr(jax_synth, fn)(**kw),
              getattr(tsynth, fn)(**kw))
    if proto != MOSI:
        # Every slice miss read DRAM (test_shared_l2's invariant).
        assert _sum(s, "l2_miss") == _sum(s, "dram_reads")


def test_carry_across_shared_mesi_mid_run():
    """The state of a shared-L2 MESI chain-12 run after two quanta (E and O
    slice entries, the [1, T, 1] placeholder of the private L2), carried
    through ``convert.state_from_numpy``, runs one more quantum to the
    JAX package's state (torch_jax_ref.megarun_carry)."""
    (fn, kw), proto, over = GENERATED["radix_kernels_sh_mesi_chain12"]
    over = {"caching_protocol/type": proto, **over}
    jp, tp = _params(kw["num_tiles"], over)
    leaves, tnext = ref.megarun_carry(
        "test_torch_protocol_runs", "carry", jp,
        lambda: getattr(jax_synth, fn)(**kw), tp,
        getattr(tsynth, fn)(**kw), 2, 1,
        {"general/total_cores": kw["num_tiles"], **over},
        live="carry" in LIVE)
    assert leaves["l2.word"].shape == (1, kw["num_tiles"], 1)
    dstate = leaves["dir_word"] & 7
    assert (dstate == 2).any() and (dstate == 3).any()   # O and E entries
    assert int(tnext.ctr_quantum) == 3
