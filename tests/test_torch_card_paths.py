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
  * The ThreadScheduler: ``gen_threads_oversubscribed(16)`` on 8 tiles
    at miss_chain 12, every leaf of the card's run equal to the CPU
    run's; and at full width, 128 streams on 64 tiles, the runs longer
    than ``chip_smoke.py`` phase 13's: threads128on64
    (``gen_threads_oversubscribed(128, compute_blocks=64, yields=8)`` at
    miss_chain 0, 2,558 rounds), sysev128on64 and sysev128on64_chain12
    (``synth.gen_system_events(128, seed=0)`` at miss_chain 0 and 12,
    3,659 and 957 rounds), each pinned from the JAX package on the CPU
    (the round counters, the completion, the counter sums, every stream
    done).

  * chain_classify's grid form: radix1536_chain12 (``gen_radix(1536,
    keys_per_tile=16, radix=64, seed=0)`` at ``tpu/block_events = 4``,
    miss_chain 12, the default directory: 818 rounds, 93,687,000 ps;
    ``chip_smoke.py`` phase 14 runs its first 8 quanta) and
    fft64_dir64w_chain12 (fft64 at miss_chain 12 with 64 directory
    ways: 393 rounds, 61,541,400 ps), whole runs pinned from the JAX
    package on the CPU.
  * fft64 at miss_chain 12 under fast-forward (span 1000 and 0), under
    MOSI and under shared-L2 MSI with 8 DRAM controllers, whole runs
    (``chip_smoke.py`` phases 8 and 10 run their first quanta), pinned
    from the JAX package on the CPU.
  * lock64 (``gen_lock_contention(64, acquisitions=16,
    critical_cycles=50)``) whole, 5,900 rounds (``chip_smoke.py`` phase 12
    runs its first 160 quanta), pinned from the JAX package on the CPU.

  * The limited directory schemes and the ``basic`` and ``m_g_1`` DRAM
    queue models (``chip_smoke.py`` phase 15 runs their first quanta):
    the paths of tests/record_card_pins.py, whole, every SimState leaf
    the JAX package's on the CPU.
  * Miss-type tracking and the iocoom cores, uniform and mixed
    (``chip_smoke.py`` phase 16 runs their first quanta): the paths of
    tests/data/card_pins_ioc_mt.json, whole, the same way.

Run on the card: ``python -m pytest -m gpu --noconftest
tests/test_torch_card_paths.py -q`` (about fifteen minutes).
"""

import gc
import json
import os
import sys

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


# chain_classify's grid form at full width (first in this file, before
# the other full-width runs): radix1536_chain12,
# ``gen_radix(1536, keys_per_tile=16, radix=64, seed=0)`` at
# ``tpu/block_events = 4`` and miss_chain 12 on the default directory
# (24 sharer words, 4.83 GB of them; a 39-wide mesh of 40 rows, the
# last holding 15 tiles), and fft64_dir64w_chain12, ``gen_fft(64,
# points_per_tile=64, writeback=True)`` at miss_chain 12 with 64
# directory ways (256 sets of 16,384 entries a tile).  Whole runs; the
# JAX package's values on the CPU.
GRID_PATHS = {
    "radix1536_chain12": (
        1536, {"tpu/block_events": 4, "tpu/miss_chain": CHAIN},
        dict(round_ctr=818, ctr_window=571, ctr_complex=112, ctr_conflict=13,
             ctr_resolve=122, ctr_quantum=43),
        93_687_000, 443_872, (34, 0)),
    "fft64_dir64w_chain12": (
        64, {"tpu/miss_chain": CHAIN, "dram_directory/associativity": 64},
        dict(round_ctr=393, ctr_window=191, ctr_complex=32, ctr_conflict=98,
             ctr_resolve=72, ctr_quantum=31),
        61_541_400, 557_056, (1910, 24)),
}


@pytest.mark.gpu
@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(GRID_PATHS))
def test_grid_form_paths_full_depth_on_card(name):
    """Every round counter, the completion, the instruction count and the
    chain pass's fan-out tallies exactly; window_walk once per window
    round, chain_classify P times per chain pass, every launch its grid
    form (more than 1,024 tiles, or more than 32 directory ways)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU form and "
                    "the full-width run is sized for the card")
    from graphite_tpu_torch.engine.kernels import chain as kchain
    T, over, want, completion_ps, icount, (fan, fb) = GRID_PATHS[name]
    # The radix path's state and its drop-scatters' copies take about 31
    # GB of the card: give it all the memory this process has cached.
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    print(f"{name}: {free} of {total} B free on the card, "
          f"{torch.cuda.memory_reserved()} B reserved by PyTorch",
          file=sys.stderr)
    cfg = load_config()
    cfg.set("general/total_cores", T)
    for k, v in over.items():
        cfg.set(k, v)
    params = SimParams.from_config(cfg)
    trace = synth.gen_radix(T, keys_per_tile=16, radix=64, seed=0) \
        if name.startswith("radix") \
        else synth.gen_fft(64, points_per_tile=64, writeback=True)
    sim = Simulator(params, trace, device="cuda")
    dispatch.reset_counts()
    s = sim.run()
    assert bool(s.done.all())
    ctrs = {k: int(getattr(sim.state, k).item()) for k in want}
    assert ctrs == want
    assert s.completion_time_ps == completion_ps
    assert s.total_instructions == icount
    assert int(s.counters["chain_fanout_served"].sum()) == fan
    assert int(s.counters["chain_fallback"].sum()) == fb
    assert dispatch.COUNTS["window_walk"] == ctrs["ctr_window"]
    assert dispatch.COUNTS["chain_classify"] == CHAIN * ctrs["ctr_resolve"]
    assert kchain.chain_step_entry(params, sim.vp, max(1024, 16 * T),
                                   (T + 63) // 64).form == kchain.GRID


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
                                       (T + 63) // 64).form \
            == (kchain.WIDE if T > 512 else kchain.SHARED)


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


# The ThreadScheduler at full width: 128 streams on 64 tiles
# (general/max_threads_per_core = 2), the JAX package's values on the
# CPU: (trace, config, round counters, completion in ps, counter sums,
# the [vm] section).
SCHED_SUMS = ("icount", "mutex_acquires", "cond_waits", "cond_signals",
              "joins", "spawns", "syscalls", "syscall_ps", "sync_stall_ps",
              "mem_stall_ps")
SYSEV128_VM = dict(data_segment_bytes=569344, stack_segment_bytes=134217728,
                   dynamic_segment_bytes=5906432, mmap_bytes=5906432,
                   munmap_bytes=94208, brk_overflow=False,
                   dynamic_overflow=False)
SCHED = {
    "threads128on64": (
        lambda: synth.gen_threads_oversubscribed(128, compute_blocks=64,
                                                 yields=8), {},
        dict(round_ctr=2558, ctr_window=1251, ctr_complex=884,
             ctr_conflict=423, ctr_resolve=263, ctr_quantum=237),
        49_588_200,
        dict(icount=833792, mutex_acquires=0, cond_waits=0, cond_signals=0,
             joins=64, spawns=64, syscalls=0, syscall_ps=0,
             sync_stall_ps=1_262_142_200, mem_stall_ps=1_375_699_400),
        None),
    "sysev128on64": (
        lambda: synth.gen_system_events(128, seed=0), {},
        dict(round_ctr=3659, ctr_window=1937, ctr_complex=1358,
             ctr_conflict=364, ctr_resolve=307, ctr_quantum=269),
        65_535_400,
        dict(icount=150003, mutex_acquires=192, cond_waits=64,
             cond_signals=64, joins=0, spawns=0, syscalls=256,
             syscall_ps=450_572_144, sync_stall_ps=2_154_460_542,
             mem_stall_ps=317_812_119),
        SYSEV128_VM),
    "sysev128on64_chain12": (
        lambda: synth.gen_system_events(128, seed=0),
        {"tpu/miss_chain": CHAIN},
        dict(round_ctr=957, ctr_window=530, ctr_complex=285,
             ctr_conflict=0, ctr_resolve=142, ctr_quantum=149),
        64_728_800,
        dict(icount=150003, mutex_acquires=192, cond_waits=64,
             cond_signals=64, joins=0, spawns=0, syscalls=256,
             syscall_ps=450_572_144, sync_stall_ps=2_434_549_448,
             mem_stall_ps=316_831_631),
        SYSEV128_VM),
}


@pytest.mark.gpu
@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(SCHED))
def test_scheduler_paths_full_depth_on_card(name):
    """Every round counter, the completion and the counter sums exactly,
    all 128 streams done; window_walk once per window round,
    chain_classify P times per chain pass, no fast_forward_walk."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU form and "
                    "the full-width run is sized for the card")
    make, over, want, completion_ps, sums, vm = SCHED[name]
    cfg = load_config()
    cfg.set("general/max_threads_per_core", 2)
    for k, v in over.items():
        cfg.set(k, v)
    params = SimParams.from_config(cfg)
    sim = Simulator(params, make(), device="cuda")
    dispatch.reset_counts()
    s = sim.run()
    assert s.done.shape == (128,) and bool(s.done.all())
    ctrs = {k: int(getattr(sim.state, k).item()) for k in want}
    assert ctrs == want
    assert s.completion_time_ps == completion_ps
    assert {k: int(s.counters[k].sum()) for k in sums} == sums
    assert s.vm_summary() == vm
    passes = ctrs["round_ctr"] - ctrs["ctr_window"] - ctrs["ctr_complex"] \
        - ctrs["ctr_conflict"]
    P = params.miss_chain
    assert passes == (ctrs["ctr_resolve"] if P else 0)
    assert dispatch.COUNTS["window_walk"] == ctrs["ctr_window"]
    assert dispatch.COUNTS["chain_classify"] == P * passes
    assert dispatch.COUNTS["fast_forward_walk"] == 0


@pytest.mark.gpu
def test_scheduler_on_card_equal_cpu():
    """gen_threads_oversubscribed(16) on 8 tiles at miss_chain 12: every
    SimState leaf of the card's run (the seats and the stream store
    among them) equal to the CPU run's, both kernels launched."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU form")
    from graphite_tpu_torch import convert
    cfg = load_config()
    for k, v in (("general/total_cores", 8),
                 ("general/max_threads_per_core", 2),
                 ("tpu/miss_chain", CHAIN)):
        cfg.set(k, v)
    params = SimParams.from_config(cfg)
    trace = synth.gen_threads_oversubscribed(16)
    cpu = Simulator(params, trace, device="cpu")
    cpu.run()
    card = Simulator(params, trace, device="cuda")
    dispatch.reset_counts()
    s = card.run()
    assert s.done.shape == (16,) and bool(s.done.all())
    want = convert.state_to_numpy(cpu.state)
    got = convert.state_to_numpy(card.state)
    assert set(want) == set(got)
    for name in sorted(want):
        assert want[name].dtype == got[name].dtype, name
        assert (want[name] == got[name]).all(), name
    st = card.state
    passes = int(st.round_ctr) - int(st.ctr_window) - int(st.ctr_complex) \
        - int(st.ctr_conflict)
    assert passes == int(st.ctr_resolve) > 0
    assert dispatch.COUNTS["window_walk"] == int(st.ctr_window) > 0
    assert dispatch.COUNTS["chain_classify"] == CHAIN * passes


# The fft64 paths that chip_smoke.py phases 8 and 10 run for their first
# quanta only: ``gen_fft(64, points_per_tile=64, writeback=True)`` at
# miss_chain 12 under fast-forward (span 1000 and 0), under MOSI, and
# under shared-L2 MSI with the DRAM controllers on 8 tiles.  Whole runs;
# the JAX package's values on the CPU.
FFT64_PATHS = {
    "fft64_ff_span": (
        {"tpu/fast_forward": 8, "tpu/fast_forward_span": 1000},
        dict(round_ctr=293, ctr_window=92, ctr_complex=27, ctr_conflict=90,
             ctr_resolve=70, ctr_quantum=31, ctr_ff=79, ctr_ffq=29,
             ff_events=38318),
        61_719_400, (1737, 13)),
    "fft64_ff": (
        {"tpu/fast_forward": 8},
        dict(round_ctr=278, ctr_window=97, ctr_complex=27, ctr_conflict=86,
             ctr_resolve=68, ctr_quantum=32, ctr_ff=73, ctr_ffq=29,
             ff_events=28817),
        62_347_600, (1737, 14)),
    "fft64_mosi": (
        {"caching_protocol/type": "pr_l1_pr_l2_dram_directory_mosi"},
        dict(round_ctr=354, ctr_window=171, ctr_complex=19, ctr_conflict=100,
             ctr_resolve=64, ctr_quantum=25),
        48_966_200, (1855, 94)),
    "fft64_shl2_msi": (
        {"caching_protocol/type": "pr_l1_sh_l2_msi",
         "dram/num_controllers": 8},
        dict(round_ctr=371, ctr_window=190, ctr_complex=30, ctr_conflict=67,
             ctr_resolve=84, ctr_quantum=19),
        37_856_600, (282, 41)),
}


@pytest.mark.gpu
@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(FFT64_PATHS))
def test_fft64_paths_full_depth_on_card(name):
    """Every round counter, the completion, the instruction count and the
    chain pass's fan-out tallies exactly; window_walk once per window
    round."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU form and "
                    "the full-width run is sized for the card")
    over, want, completion_ps, (fan, fb) = FFT64_PATHS[name]
    cfg = load_config()
    for k, v in {"tpu/miss_chain": CHAIN, **over}.items():
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
    assert s.total_instructions == 557_056
    assert int(s.counters["chain_fanout_served"].sum()) == fan
    assert int(s.counters["chain_fallback"].sum()) == fb
    assert dispatch.COUNTS["window_walk"] == ctrs["ctr_window"]
    assert dispatch.COUNTS["chain_classify"] > 0


@pytest.mark.gpu
@pytest.mark.slow
def test_lock64_full_depth_on_card():
    """``gen_lock_contention(64, acquisitions=16, critical_cycles=50)`` on
    the default config, whole (``chip_smoke.py`` phase 12 runs its first
    160 quanta): every round counter, the completion and the mutex
    tallies, the JAX package's values on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU form")
    params = SimParams.from_config(load_config())
    sim = Simulator(params, synth.gen_lock_contention(
        64, acquisitions=16, critical_cycles=50), device="cuda")
    dispatch.reset_counts()
    s = sim.run()
    assert bool(s.done.all())
    want = dict(round_ctr=5900, ctr_window=3398, ctr_complex=2438,
                ctr_conflict=64, ctr_resolve=64, ctr_quantum=343)
    assert {k: int(getattr(sim.state, k).item()) for k in want} == want
    assert s.completion_time_ps == 147_411_200
    assert s.total_instructions == 51200
    assert int(s.counters["mutex_acquires"].sum()) == 1024
    assert int(s.counters["sync_stall_ps"].sum()) == 9_032_793_600
    assert dispatch.COUNTS["window_walk"] == want["ctr_window"]


# The limited directory schemes and the basic and m_g_1 DRAM queue models
# at full width (chip_smoke.py phase 15 runs the first quanta of each):
# radix64 (keys_per_tile 64) under each scheme with four hardware
# pointers, a migratory trace whose overflowed entries broadcast (on the
# hop-by-hop mesh with and without its broadcast tree, and under
# ackwise), and radix64 at miss_chain 12 under each queue model; whole
# runs, every leaf the JAX package's on the CPU
# (tests/record_card_pins.py).
def _pins(name):
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "data", name)) as f:
        return json.load(f)


DIR_QUEUE_PINS = _pins("card_pins_dir_queue.json")


def _pinned_path_whole(name, pin):
    """Every SimState leaf (``dram_qacc`` by its bytes), the round
    counters and the completion exactly; window_walk once per window
    round, chain_classify P times per chain pass where the chain replay
    runs (a full-map directory and simple cores) and never elsewhere."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU form and "
                    "the full-width run is sized for the card")
    from graphite_tpu_torch import convert
    from torch_jax_ref import digest
    gen, kw = pin["trace"]
    cfg = load_config()
    for k, v in pin["over"].items():
        cfg.set(k, v)
    params = SimParams.from_config(cfg)
    sim = Simulator(params, getattr(synth, gen)(**kw), device="cuda")
    dispatch.reset_counts()
    s = sim.run()
    assert bool(s.done.all())
    want = pin["whole"]
    ctrs = {k: int(getattr(sim.state, k).item()) for k in want["ctrs"]}
    assert ctrs == want["ctrs"]
    assert s.completion_time_ps == want["completion_ps"]
    leaves = convert.state_to_numpy(sim.state)
    assert {k: digest(v) for k, v in leaves.items()} == want["leaves"]
    chain = params.miss_chain \
        if params.directory.directory_type == "full_map" \
        and params.core.model == "simple" else 0
    print(f"{name}: window_walk launches {dispatch.COUNTS['window_walk']}, "
          f"chain_classify launches {dispatch.COUNTS['chain_classify']}",
          file=sys.stderr)
    assert dispatch.COUNTS["window_walk"] == ctrs["ctr_window"]
    assert dispatch.COUNTS["chain_classify"] == chain * ctrs["ctr_resolve"]
    return s


@pytest.mark.gpu
@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(DIR_QUEUE_PINS))
def test_dir_scheme_and_queue_paths_whole_on_card(name):
    _pinned_path_whole(name, DIR_QUEUE_PINS[name])


# Miss-type tracking and the iocoom cores at full width (chip_smoke.py
# phase 16 runs the first quanta of each): radix64 (keys_per_tile 64)
# under a uniform iocoom model list at miss_chain 0 and 12 and under
# 32 simple then 32 iocoom tiles, the scoreboard trace with one-entry
# queues, and tracking at miss_chain 12 (radix64) and 0 (a migratory
# trace: sharing misses); whole runs, every leaf the JAX package's on the
# CPU (tests/record_card_pins.py).
IOC_MT_PINS = _pins("card_pins_ioc_mt.json")


@pytest.mark.gpu
@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(IOC_MT_PINS))
def test_iocoom_and_miss_type_paths_whole_on_card(name):
    s = _pinned_path_whole(name, IOC_MT_PINS[name])
    if IOC_MT_PINS[name]["over"].get("l2_cache/T1/track_miss_types"):
        assert sum(int(s.counters[f"l2_miss_{k}"].sum()) for k in (
            "cold", "capacity", "sharing")) > 0


# The paths chip_smoke.py cuts to make room for phase 17 (phase 5's
# radix64 and phase 6's radix64_chain12 at keys_per_tile 64, phase 10's
# radix64_shl2_mesi_ff_span, phase 11's fft64_atac_chain12, phase 12's
# lock64 and sysev64_ff, phase 13's threads128on64_chain12 and
# lock128on64), whole, every leaf the JAX package's on the CPU
# (tests/record_card_pins.py).
CUT_PINS = _pins("card_pins_cuts.json")


@pytest.mark.gpu
@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(CUT_PINS))
def test_cut_paths_whole_on_card(name):
    _pinned_path_whole(name, CUT_PINS[name])


# Tile sharding with replicated state at full width (chip_smoke.py phase
# 17 runs the first quanta of each at 2 and 4 shards): radix64 (keys_per_
# tile 64) at miss_chain 0 and 12 and fft64 at fast_forward 8, span 1000,
# miss_chain 12, whole runs on 2 gloo ranks sharing the card, every leaf
# of every rank the JAX package's unsharded run on the CPU (its sharded
# run equals it, tests/test_sharding.py; tests/record_card_pins.py).
SHARD_PINS = _pins("card_pins_shard.json")


def _sharded_whole_rank(group, pin):
    """One rank's whole run of a phase-17 path: its leaves' digests, its
    round counters, its completion and its launch counts."""
    from graphite_tpu_torch import convert
    from torch_jax_ref import digest
    gen, kw = pin["trace"]
    cfg = load_config()
    for k, v in pin["over"].items():
        cfg.set(k, v)
    cfg.set("tpu/tile_shards", str(group.size))
    params = SimParams.from_config(cfg)
    sim = Simulator(params, getattr(synth, gen)(**kw), group=group)
    dispatch.reset_counts()
    s = sim.run()
    return dict(done=bool(s.done.all()), completion_ps=s.completion_time_ps,
                ctrs={k: int(getattr(sim.state, k).item())
                      for k in pin["whole"]["ctrs"]},
                leaves={k: digest(v) for k, v in
                        convert.state_to_numpy(sim.state).items()},
                counts=dict(dispatch.COUNTS))


@pytest.mark.gpu
@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(SHARD_PINS))
def test_sharded_paths_whole_on_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU form and "
                    "the full-width run is sized for the card")
    from graphite_tpu_torch.parallel.mesh import launch
    pin = SHARD_PINS[name]
    want = pin["whole"]
    for r in launch(_sharded_whole_rank, 2, device="cuda", timeout_s=3000,
                    args=(pin,)):
        assert r["done"] and r["completion_ps"] == want["completion_ps"]
        assert r["ctrs"] == want["ctrs"] and r["leaves"] == want["leaves"]
        n = r["counts"]
        assert n["run_window_sharded"] == n["window_walk"] \
            == want["ctrs"]["ctr_window"]
        assert n["run_fast_forward_sharded"] == n["fast_forward_walk"]
        print(f"{name}: run_window_sharded launches "
              f"{n['run_window_sharded']}, run_fast_forward_sharded "
              f"{n['run_fast_forward_sharded']}, chain_classify "
              f"{n['chain_classify']}", file=sys.stderr)
