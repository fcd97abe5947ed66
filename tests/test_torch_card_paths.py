"""PyTorch port, full-width paths on the card that ``chip_smoke.py`` runs
only at a cut depth.

  * radix64_chain12 at full depth: ``gen_radix(64, keys_per_tile=2048,
    radix=256, seed=0)`` at miss_chain 12 on the default config, 2,181
    engine rounds and a completion of 245,006,600 ps (BENCH_r06's
    radix64_chain12 row, which the JAX package on the CPU reproduces).
    ``chip_smoke.py`` runs this trace at keys_per_tile 512 to stay well
    inside its time limit; this test holds the full depth.

Run on the card: ``python -m pytest -m gpu --noconftest
tests/test_torch_card_paths.py -q`` (a few minutes).
"""

import pytest
import torch

from graphite_tpu_torch import load_config
from graphite_tpu_torch.engine.kernels import dispatch
from graphite_tpu_torch.engine.sim import Simulator
from graphite_tpu_torch.events import synth
from graphite_tpu_torch.params import SimParams

CHAIN = 12
# BENCH_r06's radix64_chain12, confirmed on the JAX package on the CPU.
RADIX64_CHAIN12_CTRS = dict(round_ctr=2181, ctr_window=1412, ctr_complex=67,
                            ctr_conflict=6, ctr_resolve=696, ctr_quantum=123)
RADIX64_CHAIN12_COMPLETION_PS = 245_006_600


@pytest.mark.gpu
@pytest.mark.slow
def test_radix64_chain12_full_depth_on_card():
    """Every round counter and the completion time exactly, through both
    kernels: window_walk once per window round, chain_classify P times
    per chain pass (one pass per resolve pass)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU form and "
                    "the full-width run is sized for the card")
    cfg = load_config()
    cfg.set("tpu/miss_chain", CHAIN)
    params = SimParams.from_config(cfg)
    trace = synth.gen_radix(64, keys_per_tile=2048, radix=256, seed=0)
    sim = Simulator(params, trace, device="cuda")
    dispatch.reset_counts()
    s = sim.run()
    assert bool(s.done.all())
    ctrs = {k: int(getattr(sim.state, k).item())
            for k in RADIX64_CHAIN12_CTRS}
    assert ctrs == RADIX64_CHAIN12_CTRS
    assert s.completion_time_ps == RADIX64_CHAIN12_COMPLETION_PS
    assert dispatch.COUNTS["window_walk"] == ctrs["ctr_window"]
    assert dispatch.COUNTS["chain_classify"] == CHAIN * ctrs["ctr_resolve"]
    assert dispatch.COUNTS["fast_forward_walk"] == 0
