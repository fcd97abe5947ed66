"""PyTorch port, full-width paths on the card that ``chip_smoke.py`` runs
only at a cut depth.

  * radix64_chain12 at full depth: ``gen_radix(64, keys_per_tile=2048,
    radix=256, seed=0)`` at miss_chain 12 on the default config, 2,181
    engine rounds and a completion of 245,006,600 ps (BENCH_r06's
    radix64_chain12 row, which the JAX package on the CPU reproduces).
    ``chip_smoke.py`` runs this trace at keys_per_tile 64 to stay well
    inside its time limit; this test holds the full depth.
  * radix64 chain-off and radix64_ff_span (``tpu/fast_forward = 8``,
    span 1000 ns) at full depth, keys_per_tile 2048: 13,838 rounds and
    243,651,800 ps (BENCH_r06's radix64 row), and 13,353 rounds and
    243,687,400 ps (the JAX package on the CPU).  ``chip_smoke.py`` runs
    the first at keys_per_tile 64 and the second's first 60 quanta.
  * One-card scale (``chip_smoke.py`` phase 9 runs them too, radix256
    for its first 24 quanta): radix256,
    ``gen_radix(256, keys_per_tile=96, radix=256, seed=0)`` on the
    default config (5,475 rounds, 116,211,400 ps), and radix1024 and
    radix1024_chain12, ``gen_radix(1024, keys_per_tile=16, radix=64,
    seed=0)`` at ``tpu/block_events = 4``, miss_chain 0 (2,912 rounds,
    64,803,200 ps) and 12 (632 rounds, 63,390,000 ps; chain_classify's
    wide form).  Every round counter is the JAX package's on the CPU;
    BENCH_r06 gives the same rounds and completions for radix256 and
    radix1024.
  * The network models: ``gen_fft(64, points_per_tile=64,
    writeback=True)`` at miss_chain 12 under ATAC on both networks (367
    rounds, 59,469,000 ps) and under the contended hop-by-hop mesh
    (1,759 rounds, 209,377,800 ps, 8,595,738,800 ps of link wait), the
    JAX package's values on the CPU; ``chip_smoke.py`` phase 11 runs
    both at a cut depth.

  * The system events: ``synth.gen_system_events(8, seed=0)`` in
    ``chip_smoke.py``'s sysev64_ff configuration, every leaf of the
    card's run equal to the CPU run's (``chip_smoke.py`` phase 12 runs
    its four sync paths whole at T = 64, so none of them is repeated
    here).

Run on the card: ``python -m pytest -m gpu --noconftest
tests/test_torch_card_paths.py -q`` (about ten minutes).
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
# name: (tiles, gen_radix kwargs, config, counters, completion in ps)
FULL64 = {
    "radix64": (64, dict(keys_per_tile=2048, radix=256), {},
                dict(round_ctr=13838, ctr_window=7444, ctr_complex=3601,
                     ctr_conflict=2793, ctr_resolve=1711, ctr_quantum=545),
                243_651_800),
    "radix64_ff_span": (64, dict(keys_per_tile=2048, radix=256),
                        {"tpu/fast_forward": 8,
                         "tpu/fast_forward_span": 1000},
                        dict(round_ctr=13353, ctr_window=6548,
                             ctr_complex=3614, ctr_conflict=2787,
                             ctr_resolve=1711, ctr_quantum=547, ctr_ff=1804,
                             ctr_ffq=356, ff_events=211211),
                        243_687_400),
}
SCALE = {
    "radix256": (256, dict(keys_per_tile=96, radix=256), {},
                 dict(round_ctr=5475, ctr_window=2543, ctr_complex=1710,
                      ctr_conflict=1222, ctr_resolve=845, ctr_quantum=252),
                 116_211_400),
    "radix1024": (1024, dict(keys_per_tile=16, radix=64),
                  {"tpu/block_events": 4},
                  dict(round_ctr=2912, ctr_window=1561, ctr_complex=787,
                       ctr_conflict=564, ctr_resolve=370, ctr_quantum=124),
                  64_803_200),
    "radix1024_chain12": (1024, dict(keys_per_tile=16, radix=64),
                          {"tpu/block_events": 4, "tpu/miss_chain": CHAIN},
                          dict(round_ctr=632, ctr_window=442, ctr_complex=86,
                               ctr_conflict=8, ctr_resolve=96,
                               ctr_quantum=31),
                          63_390_000),
}


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


@pytest.mark.gpu
@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(FULL64))
def test_radix64_full_depth_on_card(name):
    """radix64 at miss_chain 0, without and with the fast-forward leg:
    every round counter and the completion time exactly; window_walk
    once per window round, no chain_classify launch, fast_forward_walk
    launched only with the leg on."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU form and "
                    "the full-width run is sized for the card")
    T, kw, over, want, completion_ps = FULL64[name]
    cfg = load_config()
    for k, v in over.items():
        cfg.set(k, v)
    params = SimParams.from_config(cfg)
    sim = Simulator(params, synth.gen_radix(T, seed=0, **kw), device="cuda")
    dispatch.reset_counts()
    s = sim.run()
    assert bool(s.done.all())
    ctrs = {k: int(getattr(sim.state, k).item()) for k in want}
    assert ctrs == want
    assert s.completion_time_ps == completion_ps
    assert s.total_instructions == 1_844_224
    assert dispatch.COUNTS["window_walk"] == ctrs["ctr_window"]
    assert dispatch.COUNTS["chain_classify"] == 0
    assert (dispatch.COUNTS["fast_forward_walk"] > 0) == (
        params.fast_forward > 0)


# radix64 under shared-L2 MESI at miss_chain 12 and tpu/fast_forward = 8,
# span 1000 ns: the path on which all three kernels take their protocol
# branches (chip_smoke.py phase 10 runs 12 quanta of it at keys_per_tile
# 64); the JAX package's values on the CPU.
SHL2_MESI = {"caching_protocol/type": "pr_l1_sh_l2_mesi",
             "tpu/miss_chain": CHAIN, "tpu/fast_forward": 8,
             "tpu/fast_forward_span": 1000}
RADIX64_SHL2_MESI_CTRS = dict(round_ctr=1633, ctr_window=669, ctr_complex=63,
                              ctr_conflict=97, ctr_resolve=657,
                              ctr_quantum=117, ctr_ff=686, ctr_ffq=117,
                              ff_events=528982)
RADIX64_SHL2_MESI_COMPLETION_PS = 236_662_000


@pytest.mark.gpu
@pytest.mark.slow
def test_radix64_shl2_mesi_ff_span_full_depth_on_card():
    """Every round counter and the completion time exactly; every kernel
    launched: window_walk once per window round, chain_classify P times
    per chain pass, fast_forward_walk at least once per analytic round
    that engaged."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU form and "
                    "the full-width run is sized for the card")
    cfg = load_config()
    for k, v in SHL2_MESI.items():
        cfg.set(k, v)
    params = SimParams.from_config(cfg)
    sim = Simulator(params, synth.gen_radix(64, keys_per_tile=2048,
                                            radix=256, seed=0),
                    device="cuda")
    dispatch.reset_counts()
    s = sim.run()
    assert bool(s.done.all())
    ctrs = {k: int(getattr(sim.state, k).item())
            for k in RADIX64_SHL2_MESI_CTRS}
    assert ctrs == RADIX64_SHL2_MESI_CTRS
    assert s.completion_time_ps == RADIX64_SHL2_MESI_COMPLETION_PS
    assert s.total_instructions == 1_844_224
    engaged = dispatch.COUNTS["ff_engaged"]
    passes = ctrs["round_ctr"] - ctrs["ctr_window"] - ctrs["ctr_complex"] \
        - ctrs["ctr_conflict"] - engaged
    assert passes == ctrs["ctr_resolve"]
    assert dispatch.COUNTS["window_walk"] == ctrs["ctr_window"]
    assert dispatch.COUNTS["chain_classify"] == CHAIN * passes > 0
    assert dispatch.COUNTS["fast_forward_walk"] >= engaged > 0


@pytest.mark.gpu
@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(SCALE))
def test_one_card_scale_full_depth_on_card(name):
    """Every round counter and the completion time exactly at T = 256 and
    1024; window_walk once per window round, chain_classify (its wide
    form at T = 1024) P times per chain pass."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU form and "
                    "the full-width run is sized for the card")
    T, kw, over, want, completion_ps = SCALE[name]
    cfg = load_config()
    cfg.set("general/total_cores", T)
    for k, v in over.items():
        cfg.set(k, v)
    params = SimParams.from_config(cfg)
    sim = Simulator(params, synth.gen_radix(T, seed=0, **kw), device="cuda")
    dispatch.reset_counts()
    s = sim.run()
    assert bool(s.done.all())
    ctrs = {k: int(getattr(sim.state, k).item()) for k in want}
    assert ctrs == want
    assert s.completion_time_ps == completion_ps
    assert dispatch.COUNTS["window_walk"] == ctrs["ctr_window"]
    assert dispatch.COUNTS["chain_classify"] \
        == params.miss_chain * ctrs["ctr_resolve"]
    if params.miss_chain:
        from graphite_tpu_torch.engine.kernels import chain as kchain
        assert kchain.chain_step_entry(params, sim.vp, max(1024, 16 * T),
                                       (T + 63) // 64).wide == (T > 512)


# The network models at full depth (chip_smoke.py phase 11 runs them at a
# cut depth): ``gen_fft(64, points_per_tile=64, writeback=True)`` at
# miss_chain 12 under ATAC on both networks (default AtacParams), and
# under the contended hop-by-hop mesh, where the chain pass stands down
# and the conflict rounds fly every leg.  The JAX package's values on the
# CPU.
NETWORKS = {
    "fft64_atac_chain12": (
        {"network/memory": "atac", "network/user": "atac",
         "tpu/miss_chain": CHAIN},
        dict(round_ctr=367, ctr_window=186, ctr_complex=27, ctr_conflict=86,
             ctr_resolve=68, ctr_quantum=30),
        59_469_000, 0, (1909, 19)),
    "fft64_hbh_contended": (
        {"network/memory": "emesh_hop_by_hop",
         "network/emesh_hop_by_hop/queue_model/enabled": True,
         "tpu/miss_chain": CHAIN},
        dict(round_ctr=1759, ctr_window=532, ctr_complex=35,
             ctr_conflict=1192, ctr_resolve=334, ctr_quantum=105),
        209_377_800, 8_595_738_800, (0, 0)),
}


@pytest.mark.gpu
@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(NETWORKS))
def test_network_paths_full_depth_on_card(name):
    """Every round counter, the completion time, the summed link wait and
    the chain pass's fan-out tallies exactly; window_walk once per window
    round, chain_classify P times per chain pass (none under contention,
    where the chain pass stands down)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU form and "
                    "the full-width run is sized for the card")
    over, want, completion_ps, wait_ps, (fan, fb) = NETWORKS[name]
    cfg = load_config()
    for k, v in over.items():
        cfg.set(k, v)
    params = SimParams.from_config(cfg)
    sim = Simulator(params, synth.gen_fft(64, points_per_tile=64,
                                          writeback=True), device="cuda")
    dispatch.reset_counts()
    s = sim.run()
    assert bool(s.done.all())
    ctrs = {k: int(getattr(sim.state, k).item()) for k in want}
    assert ctrs == want
    assert s.completion_time_ps == completion_ps
    assert int(s.counters["net_link_wait_ps"].sum()) == wait_ps
    assert int(s.counters["chain_fanout_served"].sum()) == fan
    assert int(s.counters["chain_fallback"].sum()) == fb
    passes = ctrs["round_ctr"] - ctrs["ctr_window"] - ctrs["ctr_complex"] \
        - ctrs["ctr_conflict"]
    assert dispatch.COUNTS["window_walk"] == ctrs["ctr_window"]
    assert dispatch.COUNTS["chain_classify"] == CHAIN * passes
    assert (passes == 0) == (wait_ps > 0)


# synth.gen_system_events at T = 8 in chip_smoke.py's sysev64_ff
# configuration (tpu/fast_forward = 8, span 1000 ns, miss_chain 12): the
# three kernels on the card against the plain forms on the CPU, over a
# whole run that reaches their STALL / SYNC rows, the DVFS periods, the
# ROI markers and banked atomics.
SYSEV = {"general/total_cores": 8, "tpu/fast_forward": 8,
         "tpu/fast_forward_span": 1000, "tpu/miss_chain": CHAIN}


@pytest.mark.gpu
def test_system_events_on_card_equal_cpu():
    """Every SimState leaf of the card's run equal to the CPU run's, with
    every kernel launched: window_walk once per window round,
    chain_classify P times per chain pass, fast_forward_walk at least
    once per analytic round that engaged."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU form")
    from graphite_tpu_torch import convert
    cfg = load_config()
    for k, v in SYSEV.items():
        cfg.set(k, v)
    params = SimParams.from_config(cfg)
    trace = synth.gen_system_events(8, seed=0)
    cpu = Simulator(params, trace, device="cpu")
    cpu.run()
    card = Simulator(params, trace, device="cuda")
    dispatch.reset_counts()
    s = card.run()
    assert bool(s.done.all())
    want = convert.state_to_numpy(cpu.state)
    got = convert.state_to_numpy(card.state)
    assert set(want) == set(got)
    for name in sorted(want):
        assert want[name].dtype == got[name].dtype, name
        assert (want[name] == got[name]).all(), name
    st = card.state
    engaged = dispatch.COUNTS["ff_engaged"]
    passes = int(st.round_ctr) - int(st.ctr_window) - int(st.ctr_complex) \
        - int(st.ctr_conflict) - engaged
    assert passes == int(st.ctr_resolve) > 0
    assert dispatch.COUNTS["window_walk"] == int(st.ctr_window)
    assert dispatch.COUNTS["chain_classify"] == CHAIN * passes
    assert dispatch.COUNTS["fast_forward_walk"] >= engaged > 0
