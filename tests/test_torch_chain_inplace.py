"""PyTorch port, the engine under the fused chain kernel's contract, on
the CPU.

On the card each replay iteration is one launch of ``chain_step_cuda``:
every ChainHead and ChainOut leaf is a view of ONE fresh device buffer
(``chain.StepLayout``), and with the DRAM queue model off the kernel
writes the floors into the pass's ``ftbl`` in place and returns that
tensor as ChainOut.ftbl.  Engine code that kept a leaf of one iteration
past the next, or a reference to the floor table from before the
iteration, would read something else on the card than on the CPU.
These tests run whole chain-12 simulations on the CPU with
``run_chain_step`` replaced by a shim that does what the kernel does —
the plain step's results copied into one carved buffer per call, the
floor table updated in place — and hold every SimState leaf to the JAX
package's (tolerance 0: the engine is all-integer), with the DRAM queue
model on and off.

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
from graphite_tpu_torch.engine import resolve as tresolve
from graphite_tpu_torch.engine.kernels import chain as tchain
from graphite_tpu_torch.engine.sim import Simulator
from graphite_tpu_torch.events import synth
from graphite_tpu_torch.params import SimParams

import torch_jax_ref as ref

RADIX8 = ("gen_radix", dict(num_tiles=8, keys_per_tile=64, radix=16,
                            seed=3))
FFT8 = ("gen_fft", dict(num_tiles=8, points_per_tile=32, writeback=True))
QUEUE_OFF = {"dram/queue_model/enabled": False}
CASES = {
    "radix8": (RADIX8, {}),
    "radix8_queue_off": (RADIX8, QUEUE_OFF),
    "fft8": (FFT8, {}),
    "fft8_queue_off": (FFT8, QUEUE_OFF),
}
# The cases compared with the JAX package's live run in tier-1 (the
# others with its recorded pins: tests/torch_jax_ref.py).
LIVE = ("radix8_queue_off",)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The engine's CPU path is thousands of tiny ops: one intra-op
    thread per test worker is faster than contending for every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _over(T, over):
    return {"general/total_cores": T, "tpu/miss_chain": 12, **over}


def _params(T, over):
    cj, ct = jax_load_config(), load_config()
    for c in (cj, ct):
        for k, v in _over(T, over).items():
            c.set(k, v)
    return JaxSimParams.from_config(cj), SimParams.from_config(ct)


class InPlaceChainStep:
    """``run_chain_step`` as the fused CUDA kernel behaves: the plain
    step's leaves written into one buffer per call (filled with a
    pattern first, so a leaf the copy missed would show), the floor table
    updated in place and returned as ChainOut.ftbl."""

    def __init__(self):
        self.calls = 0
        self.ftbl_writes = 0

    def __call__(self, params, vp, si, H):
        ref_head, ref = tchain.chain_step(params, vp, si, H)
        A = params.directory.associativity
        layout = tchain.StepLayout(params, si.dir_sharers.shape[0] // A)
        buf = torch.full((layout.nbytes,), 0xA5, dtype=torch.uint8)
        head, out = layout.carve(buf, si.ftbl)
        for got, r in ((head, ref_head), (out, ref)):
            for f in r._fields:
                t = getattr(got, f)
                if t is not None and f != "ftbl":
                    t.copy_(getattr(r, f))
        if si.ftbl is not None:
            self.ftbl_writes += int((si.ftbl != ref.ftbl).any())
            si.ftbl.copy_(ref.ftbl)
        self.calls += 1
        return head, out


@pytest.mark.parametrize("name", sorted(CASES))
def test_engine_under_fused_chain_step(name, monkeypatch):
    (fn, kw), over = CASES[name]
    jp, tp = _params(kw["num_tiles"], over)
    shim = InPlaceChainStep()
    monkeypatch.setattr(tresolve.kchain, "run_chain_step", shim)
    tsim = Simulator(tp, getattr(synth, fn)(**kw), device="cpu")
    tsim.run(max_steps=4096)
    assert shim.calls > 0 and shim.calls % tp.miss_chain == 0
    if over:
        assert shim.ftbl_writes > 0
    assert bool(tsim.state.done.all())
    if name == "radix8":
        # The radix8_pallas bench row's round count, and the completion
        # chip_smoke.py pins for the same run on the card.
        assert int(tsim.state.round_ctr) == 86
        assert int(tsim.state.clock.max()) == 8_686_600
    def jax_leaves():
        jsim = JaxSimulator(jp, getattr(jax_synth, fn)(**kw))
        jsim.run(max_steps=4096)
        return convert.leaves_to_numpy(jax.device_get(jsim.state))

    ref.check("test_torch_chain_inplace", name,
              convert.state_to_numpy(tsim.state), jax_leaves,
              ref.inputs(_over(kw["num_tiles"], over), tsim.trace,
                         steps=4096), live=name in LIVE)
