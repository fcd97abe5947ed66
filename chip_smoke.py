#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is caught):

  1. The card (nvidia-smi name and power limit), torch and CUDA versions.
  2. Build every CUDA source of the port from this checkout (one nvcc per
     source, started together); print the seconds and the ptxas
     register/spill lines; no kernel may have a stack frame.
  3. Every kernel against its plain PyTorch form ON THE CARD at the main
     paths' shapes (T = 64, default geometry), every output element
     equal; times from CUDA events over many launches after warm-up,
     kernel and plain form, and device time per launch from
     torch.profiler.  Every kernel updates state in place (window_walk
     its cache, predictor and bank leaves, fast_forward_walk its
     predictor and L1 leaves, chain_classify the floor table), so it runs
     on copies and the plain form on the originals, and its written
     leaves must be the copies' own tensors:
       * window_walk at P = 0: random operands, seeded collision operands
         (operands.seeded_window_arrays) and a window captured from the
         port's own radix64 run (timed: K = 16, P = 0);
       * window_walk at P = 12 (fan-out replay on and off): random and
         seeded collision operands with a pending [P, T] bank and
         banking windows captured from the port's own radix64 chain-12
         run (timed: K = 16, P = 12);
       * chain_classify, one replay iteration from the state's own arrays
         (head gathers, directory-row gathers, classify) against the
         plain chain_step: state-level seeded sets
         (operands.random_chain_step_arrays) at H = 1024, a
         non-power-of-two H and a colliding H = 4 with the fan-out replay
         and the DRAM queue model each on and off, and iterations
         captured at run_chain_step's inputs in the port's own radix64
         chain-12 run (timed, device time per launch);
       * fast_forward_walk at F = 64: seeded operand sets (engage and
         decline, the run-ahead bound crossed and not, repeated lines,
         predictor-slot collisions, models disabled, tiles that are not
         candidates, no predictor, miss_chain 12) and analytic rounds
         captured from the port's own radix64 span-1000 run, some with
         engaging tiles (timed on a captured round);
       * window_walk at the wide width K = 64, P = 0 and P = 12: random
         and seeded collision operands and wide windows captured from the
         fast-forward runs (timed: K = 64, P = 0 and P = 12);
       * one-card scale, T = 1024: window_walk at K = 4 (random, seeded
         and a window captured from the port's own radix1024 run; timed),
         and chain_classify's wide form (16 ways, 16 sharer words, H =
         16,384: tables in its workspace, directory rows read in place)
         on state-level seeded sets of every configuration at three H
         (a fan-out whose sharers cross sharer word 8 among them) and on
         iterations captured from the port's own radix1024 chain-12 run
         (timed);
       * the coherence protocols (MOSI, shared-L2 MSI, shared-L2 MESI):
         window_walk at K = 16 and 64, P = 0 and 12, on random and seeded
         operands (E lines written and touched again, shared-L2 banked
         fills of one L1 set, pending banks on L1 sets; no L2 operand
         with shared L2); chain_classify on state-level seeded sets of
         every configuration with the DRAM controllers on every tile and
         on a quarter of them (chain heads whose DRAM site is not their
         slice), each protocol's own cases (O entries read, written and
         evicted, E grants, fan-outs), and its wide form at T = 1024
         under shared-L2 MESI; fast_forward_walk under shared-L2 MESI
         (the sticky E->M upgrade) — eight sets per protocol and kernel
         at least;
       * window_walk's iocoom branches: seeded sets
         (operands.iocoom_window_arrays: register-annotated events, drain
         points, queue completions above the clock) under a uniform
         iocoom model list and under mixed ones with simple and iocoom
         tiles first and last in both orders, speculative loads on and
         off, at P = 0 and 12; windows captured from the port's own
         scoreboard64 run (one-entry queues) whose queues complete after
         the clock (timed: K = 16, P = 0, iocoom flags on, printed beside
         the simple K = 16, P = 0 window's time).
     Each kernel's bound counts the bytes the function needs on the
     timed operands (chain_bytes, ff_bytes, window_bytes).  The chain
     wrapper must make one device allocation per call and the
     fast-forward wrapper none beyond its three fresh outputs (the
     allocator's request counts); the chain wrapper's host time is split
     into carving its output views, its checks and its allocation.
  4. The golden shapes radix8 and fft8 at miss_chain 0 against
     tests/data/chain_off_golden.json, exactly; radix8 at miss_chain 12
     (86 engine rounds, completion 8,686.6 ns).
  5. The chain-off main path at full width and a cut depth:
     ``gen_radix(64, keys_per_tile=64, radix=256, seed=0)`` on the
     default config for its first 60 quanta (1,303 rounds) — every
     SimState leaf, round counter and counter sum, the latest clock and
     the clocks' and cursors' sums the JAX package's
     (tests/data/card_pins_cuts.json), window-kernel launches ==
     ctr_window (the whole keys-64 run, 3,516 rounds, and the full
     depth, keys_per_tile 2048, 13,838 rounds and 243,651.8 ns, are held
     on the card by tests/test_torch_card_paths.py).
  6. The chain-replay paths at full width, miss_chain 12: the radix64
     trace of phase 5 for its first quanta, held as phase 5's is (the
     whole keys-64 run, 347 rounds to 72,082.6 ns, and the full depth,
     2,181 rounds and 245,006.6 ns, are held on the card by
     tests/test_torch_card_paths.py) and ``gen_fft(64,
     points_per_tile=64, writeback=True)`` (round_ctr 377, completion
     60,677.0 ns, 1,897 fan-outs served in-pass, 17 fallbacks).
     chain_classify launches == 12 x chain passes (round_ctr - ctr_window
     - ctr_complex - ctr_conflict), window launches == ctr_window.  The
     fft64 run records, at run_chain_step's inputs, its first replay
     iterations that serve a fan-out, and chain_classify is held against
     its plain form on each of them once the run's counts are read.
  7. Profiled stretches of the chain-off and the chain-12 radix64 runs
     (torch.profiler with device activity only; 2 quanta, and the first
     2 sub-rounds of a quantum with the top device kernels, continuing
     phase 3's simulations), and of the radix64_ff_span run (2 quanta,
     continuing phase 3's fast-forward simulation; it runs after phase
     8's radix64_ff_span path, whose unprofiled wall it is held
     against): device busy time per round, held against the unprofiled
     wall time per round of phases 5, 6 and 8, kernels and host polls
     (device-to-host copies) per round, each kernel's share, and the
     profiler's own seconds.
  8. The fast-forward paths at full width, ``tpu/fast_forward = 8``
     (wide rounds of 64 events):
       * radix64_ff_span: phase 5's cut radix64 trace at miss_chain 0
         and a run-ahead span of 1000 ns, for its first 60 quanta, in
         which every analytic round of the run engages (round_ctr 1293,
         latest clock 27,141.8 ns, ctr_ff 23, ctr_ffq 9, ff_events 828,
         icount 30,640, and the clocks' and cursors' sums; the full
         depth, 13,353 rounds, is held on the card by
         tests/test_torch_card_paths.py); fast_forward_walk launches > 0
         and at least the analytic rounds that engaged, window_walk
         launches == ctr_window, no chain_classify launch;
       * fft64_ff_span: the fft64 trace at miss_chain 12, span 1000, the
         path on which all three kernels run, for its first 16 quanta
         (round_ctr 142, latest clock 34,043.8 ns, 598 fan-outs, 5
         fallbacks, the clocks' and cursors' sums; the whole run, 293
         rounds, is held on the card by tests/test_torch_card_paths.py);
       * fft64_ff: the same at span 0, where only the wide rounds run,
         for its first 16 quanta (round_ctr 139, ctr_ff 40, ctr_ffq 15,
         ff_events 15413, 598 fan-outs, 5 fallbacks, no
         fast_forward_walk launch; the whole run, 278 rounds, on the
         card by tests/test_torch_card_paths.py).
     Chain passes (round_ctr - ctr_window - ctr_complex - ctr_conflict
     - engaged analytic rounds) == ctr_resolve at miss_chain 12 and 0 at
     0; chain_classify launches == 12 x chain passes.
  9. One-card scale at full width, every round counter and the
     completion the JAX package's on the CPU (BENCH_r06 gives the same
     rounds and completions for radix1024 and the full-depth radix256):
       * radix1024: ``gen_radix(1024, keys_per_tile=16, radix=64,
         seed=0)`` at ``tpu/block_events = 4``, miss_chain 0, BASELINE's
         scored configuration, for its first 60 quanta
         (round_ctr 1612, latest clock 31,250.8 ns, the clocks' and
         cursors' sums; the whole run, 2,912 rounds to 64,803.2 ns, on
         the card by tests/test_torch_card_paths.py);
         then a profiled stretch of 2 quanta continuing phase 3's
         radix1024 simulation, with the device kernels that took the most
         time;
       * radix1024_chain12: the same trace at miss_chain 12, for its
         first 12 quanta (round_ctr 375, latest clock
         27,558.0 ns, the clocks' and cursors' sums; the whole run, 632
         rounds to 63,390.0 ns with 20 fan-outs, on the card by
         tests/test_torch_card_paths.py); chain_classify launches == 12 x
         ctr_resolve, all of its wide form;
       * radix256: ``gen_radix(256, keys_per_tile=96, radix=256,
         seed=0)`` on the default config for its first 24 quanta
         (round_ctr 542, latest clock 12,225.8 ns, the clocks' and
         cursors' sums; the whole run, 5,475 rounds, is held on the card
         by tests/test_torch_card_paths.py);
       * radix512: ``gen_radix(512, keys_per_tile=16, radix=64, seed=0)``
         at block_events 4 for 8 quanta (the last size with dense one-hot
         [T, H] tables), for its peak device memory.

  10. The coherence protocols at full width (64 tiles, the default
      config), each exact against the JAX package's values on the CPU:
       * radix64_shl2_mesi_ff_span: phase 5's cut trace under
         ``pr_l1_sh_l2_mesi`` at miss_chain 12 and
         ``tpu/fast_forward = 8``, span 1000 ns, for its first 6
         quanta (tests/data/card_pins_cuts.json: round counters, latest
         clock, icount, the clocks' and cursors' sums): all three kernels
         on their protocol branches, each launched (the whole keys-64
         run and the full depth, 1,633 rounds, are held on the card by
         tests/test_torch_card_paths.py);
       * fft64_mosi: ``gen_fft(64, points_per_tile=64, writeback=True)``
         under MOSI at miss_chain 12 for its first 14 quanta (round_ctr
         179, latest clock 29,192.6 ns, 534 fan-outs, 52 fallbacks; the
         whole run, 354 rounds, on the card by
         tests/test_torch_card_paths.py);
       * fft64_shl2_msi: the same trace under ``pr_l1_sh_l2_msi`` at
         miss_chain 12 with the DRAM controllers on 8 of the 64 tiles, so
         that a slice miss's controller is often another tile, for its
         first 12 quanta (round_ctr 230, latest clock 24,310.6 ns, 150
         fan-outs, 16 fallbacks; the whole run, 371 rounds, on the card
         by tests/test_torch_card_paths.py).
     Each path records (clones of) the operands of its first window
     walks, replay iterations and analytic rounds; once its launch
     counts are read, each kernel is held against its plain form on
     them and timed (device time per launch under each protocol; the
     fast-forward walk on a recorded round where some tile engages,
     else on phase 3's seeded set with the most engaged tiles).
  11. The network models:
       * chain_classify's network legs on seeded state-level sets at T =
         64 under the default emesh_hop_counter, ATAC (cluster size 4,
         cluster-based, star; cluster size 16, distance-based, btree)
         and emesh_hop_by_hop with its queue model off, with the fan-out
         replay and the DRAM queue both on and both off (fan-out targets
         in the home's cluster and in others); under ATAC with shared-L2
         MSI and the controllers on a quarter of the tiles (slice misses
         whose controller sits in another cluster); the wide form at T =
         1024 under both routings; device time per launch of each
         network beside emesh's, and the bound;
       * window_walk with a quarter of its events SPAWNs (children on
         every tile) under each user network, K = 16 and 64, P = 0 and
         12 (spawns across ATAC clusters); device time per launch;
       * fft64_atac_chain12: ``gen_fft(64, points_per_tile=64,
         writeback=True)`` at miss_chain 12 with ATAC on both networks,
         its first 16 quanta (tests/data/card_pins_cuts.json: round
         counters, latest clock, fan-outs and fallbacks, the clocks' and
         cursors' sums; the whole run, 367 rounds to 59,469.0 ns with
         1,909 fan-outs, on the card by tests/test_torch_card_paths.py);
       * fft64_hbh_contended: the same trace under emesh_hop_by_hop with
         its queue model on, for its first 40 quanta (round_ctr 710,
         latest clock 88,225.6 ns, 3,217,312,800 ps of link wait, the
         clocks' and cursors' sums; the whole run, 1,759 rounds, is held
         on the card by tests/test_torch_card_paths.py): the chain pass
         stands down (no chain_classify launch), the window walk banks
         and the conflict rounds fly every leg.
     Each path is pinned from the JAX package on the CPU and records its
     first window walks and replay iterations, on which the kernels are
     held against their plain forms once the launch counts are read.

  12. Synchronisation, CAPI messaging and system events at one stream
      per tile, T = 64, each run (lock64 and sysev64_ff cut by quanta,
      tests/data/card_pins_cuts.json, their whole runs on the card by
      tests/test_torch_card_paths.py; the others whole) exact against
      the JAX package's
      values on the CPU (every round counter, the completion, the sums
      of the sync, thread, syscall, network and stall counters, the
      [vm] section):
       * lock64: ``gen_lock_contention(64, acquisitions=16,
         critical_cycles=50)`` on the default config, for its first 80
         quanta (1,150 rounds; the whole run, 5,900 rounds and 1,024
         acquires);
       * pingpong64_hbh_user: ``gen_ping_pong(64, messages=32,
         size=64)`` under a hop-by-hop user network with its queue model
         on: every SEND flies over the user links (264 rounds);
       * threads64_chain12: ``gen_threads_oversubscribed(num_streams=64,
         compute_blocks=8, cost_cycles=100, yields=2)`` at miss_chain 12
         (SPAWN, THREAD_START, JOIN, YIELD; 31 rounds);
       * sysev64_ff: ``synth.gen_system_events(64, seed=0)`` (ATOMICs,
         cond pairs, every SYSCALL class with the VM payloads, DVFS_SET,
         the ROI markers, STALL and SYNC) at ``tpu/fast_forward = 8``,
         span 1000 ns, miss_chain 12: all three kernels (its first 8
         quanta; the whole run, 266 rounds).
     The last two record their first window walks with SPAWN rows (with
     STALL or SYNC rows), replay iterations (with a banked ATOMIC at a
     head) and analytic rounds, on which each kernel is held against its
     plain form once the launch counts are read.

  13. The ThreadScheduler at full width: T = 64 tiles, S = 128 trace
      streams (``general/max_threads_per_core = 2``), each exact against
      the JAX package's values on the CPU (the round counters, the
      completion, the counter sums of phase 12; whole runs: every
      stream done):
       * threads128on64_chain12: ``gen_threads_oversubscribed(128,
         compute_blocks=64, yields=8)`` at miss_chain 12 (seat rotations
         on done, YIELD and the preemption quantum; SPAWNs of streams
         64-127 from the window walk; the chain pass beside the seats),
         its first 17 quanta (tests/data/card_pins_cuts.json; the whole
         run, 243 rounds, on the card by tests/test_torch_card_paths.py);
       * lock128on64: ``gen_lock_contention(128, acquisitions=2,
         critical_cycles=50)`` (mutex parks rotated out and back), its
         first 60 quanta (the whole run, 1,830 rounds, on the card);
       * barrier128on64: ``gen_barrier_compute(128)`` (barrier waiters
         woken in the stream store).
     The first records its first window walks with a SPAWN of a stream
     >= T (the landing leg's ``child % T``, ``s_ids`` = 128) and its
     replay iterations, on which the kernels are held against their
     plain forms.  The longer scheduler runs (threads128on64 at
     miss_chain 0, the system events at S = 128 at miss_chain 0 and 12)
     are held on the card by tests/test_torch_card_paths.py.
  14. chain_classify's grid form (past 1,024 tiles or 16 sharer words,
      past 32 directory ways: ceil(T / 256) blocks of one cooperative
      launch), the largest grid the card holds at once, and:
       * the grid form against the plain step on state-level seeded
         sets of every configuration (fan-out replay and DRAM queue
         model on and off): at T = 2,048 on a directory of 4 sets a
         tile, at 64 and 128 directory ways (T = 64), and, asked for, at
         T = 1,024 on the wide form's sets; among them fan-outs past 32
         targets, across blocks, and directory hits past way 32; the
         wrapper and device time per launch, the plain step's and the
         bound of each group (at T = 1,024 the wide form's beside it);
       * radix1536_chain12: ``gen_radix(1536, keys_per_tile=16,
         radix=64, seed=0)`` at ``tpu/block_events = 4`` and miss_chain
         12 on the default directory (24 sharer words, 4.83 GB; a 39-wide
         mesh of 40 rows, the last holding 15 tiles): the grid form on the first
         replay iterations of a one-quantum run, then its first 8 quanta
         exact against the JAX package's values on the CPU (round_ctr
         270, latest clock 20,754.0 ns, the clocks' and cursors' sums; the
         whole run, 818 rounds with its conflict rounds and fan-outs, on
         the card by tests/test_torch_card_paths.py), chain_classify
         launches == 12 x chain passes, every one of its grid form.

  15. The limited directory schemes and the ``basic`` and ``m_g_1`` DRAM
      queue models:
       * ``basic_ring``, ``mg1_delay``, ``probe`` and ``occupy`` on
         seeded batches as CUDA tensors against the same calls on the
         CPU, every output byte for byte (the float64 ``dram_qacc``
         moments among them): the moving average off and at windows 1,
         2, 16 and 64, occupancy rows, 1,200 rows on few resources, and
         moments whose M/G/1 wait turns on the fused variance;
       * cut runs at T = 64, every SimState leaf (by its digest) and
         round counter the JAX package's on the CPU
         (tests/data/card_pins_dir_queue.json, written by
         tests/record_card_pins.py): phase 5's radix64 trace under each
         limited scheme with four hardware pointers for 6 quanta (the
         radix trace never invalidates, so only limited_no_broadcast's
         pointer eviction and limitless's trap move its counters);
         ``gen_migratory(64, lines=8, rounds=1)`` under
         limited_broadcast on the hop-by-hop mesh with its broadcast
         tree on and off and under ackwise, 6 quanta each (an overflowed
         broadcast in each); radix64 at miss_chain 12 under ``basic``
         (window 64) and ``m_g_1`` for 4 quanta.  window_walk launches
         == ctr_window, chain_classify launches == 12 x chain passes
         under the queue models and 0 under a scheme (the chain replay
         serves full-map directories only).  The whole runs are held on
         the card by tests/test_torch_card_paths.py.

  16. Miss-type tracking and the iocoom cores: cut runs at T = 64 held
      as phase 15's are (tests/data/card_pins_ioc_mt.json, written by
      tests/record_card_pins.py): radix64_iocoom (phase 5's trace under
      ``<default,iocoom,T1,T1,T1>``), radix64_iocoom_chain12 (the same
      at miss_chain 12: the chain replay stands down, chain_classify
      launches 0), radix64_mixed (32 simple tiles, then 32 iocoom),
      scoreboard64 (``synth.gen_scoreboard``: register-annotated loads
      and computes, one-entry load and store queues), radix64_chain12_mt
      (``track_miss_types`` at miss_chain 12: the chain pass classifies
      beside chain_classify's launches) and migratory64_mt (tracking at
      miss_chain 0: sharing misses).  Each prints its rounds, latest
      clock, summed cold / capacity / sharing L2 misses and its
      window_walk and chain_classify launches.  The whole runs are held
      on the card by tests/test_torch_card_paths.py.

  17. Tile sharding with replicated state (``tpu/tile_shards`` = S > 1):
      one graphite_tpu_torch.parallel.mesh.launch per S of gloo ranks
      sharing the card, each rank walking its T/S tiles with the CUDA
      kernels (run_window_sharded, run_fast_forward_sharded) and
      gathering the rest in one gloo collective a walk.  At S = 2 the cut
      paths radix64 (16 quanta), radix64_chain12 (6 quanta; chain_classify
      on every rank) and fft64_ff_span (10 quanta, the first analytic
      rounds that engage), at S = 4 radix64; every leaf and round counter
      of every rank the JAX package's unsharded run
      (tests/data/card_pins_shard.json, tests/record_card_pins.py; its
      sharded run equals it), run_window_sharded and window_walk
      launched once per window round on every rank, chain_classify P
      times per chain pass.  Then both sharded walks, on operands
      recorded from those runs, against the whole-tile kernel and the
      plain form at S = 2, 4 and 8; rank 0 times the sharded call, the
      kernel's device time at T/S tiles and the plain form, and counts
      the slice's bytes for the bound.  The whole runs are held on the
      card by tests/test_torch_card_paths.py.

Before each path of phases 4 to 6 and 8 to 17 every kernel's launch count is
set to 0, and it is read just after; each full-width path prints its
peak device memory and the part of it above what was held before the
path started.  The last two lines of standard output are the
``kernels`` JSON object and the ``ok`` JSON object.  Without a CUDA
device, or without the port's sources beside this file, the script exits
non-zero and prints no result.
"""

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# Values pinned by BENCH_r06's fft64 and radix8_pallas rows (all-integer
# engine, so they are device-independent); the JAX package on the CPU
# gives BENCH_r06's values for radix64 (13,838 rounds, 243,651.8 ns),
# radix64_chain12 (2,181 rounds, 245,006.6 ns), fft64, radix64_ff and
# fft64_ff.  Phase 3's captures and phase 7's stretches use the full
# radix64 trace.
FULL_KEYS = 2048
# Phases 5 and 8 run the radix64 trace at a cut depth, so that the script
# with phase 9 ends well inside its time limit on a slow host (at full
# depth radix64 took 143-170 s and radix64_ff_span 132-155 s of
# host-bound wall on an NVIDIA H100 80GB HBM3 at 700 W;
# tests/test_torch_card_paths.py holds both full depths on the card).
# The JAX package on the CPU gives these values for gen_radix(64,
# keys_per_tile=64, radix=256, seed=0) (since phase 11 was added; at
# keys_per_tile 128, 4,115 rounds and 81,960.8 ns; at 256, 5,309 rounds
# and 100,052.2 ns).
# Since phase 17 was added, phase 5 runs this trace's first 60 quanta
# and phase 6 its first 16 at miss_chain 12 (their pins in
# tests/data/card_pins_cuts.json; the whole keys-64 runs, 3,516 rounds to
# 72,044.6 ns and 347 rounds to 72,082.6 ns, are held on the card by
# tests/test_torch_card_paths.py).
CUT_KEYS = 64
CHAIN = 12
FFT_ROUND_CTR = 377
FFT_COMPLETION_PS = 60_677_000
FFT_FANOUT_SERVED = 1897
FFT_FALLBACK = 17
FFT_CAPTURED = 8                   # fft64 fan-out iterations held in phase 6
RADIX8_CHAIN_ROUND_CTR = 86
# radix8 chain 12's completion, as the JAX package computes it on the CPU
# (tests/test_torch_chain_sim.py holds the port to it).
RADIX8_CHAIN_COMPLETION_PS = 8_686_600
# Fast-forward paths (phase 8), as the JAX package computes them on the
# CPU; the span-0 fft64 row is BENCH_r06's fft64_ff.
FF = 8
FF_SPAN_NS = 1000
# radix64_ff_span runs phase 5's cut trace for 60 quanta (a cut run; the
# whole keys-64 run takes 3,506 rounds to 72,044.6 ns, every analytic
# round that engages within the first 60 quanta).
FF_SPAN_QUANTA = 60
FF_SPAN_CTRS = dict(round_ctr=1293, ctr_window=593, ctr_complex=409,
                    ctr_conflict=284, ctr_resolve=196, ctr_quantum=60,
                    ctr_ff=23, ctr_ffq=9, ff_events=828)
FF_SPAN_COMPLETION_PS = 27_141_800      # the latest clock at the cut
FF_SPAN_CUT = dict(clock_sum=995_889_200, cursor_sum=16_899)
FF_SPAN_ICOUNT = 30_640
# fft64_ff_span and fft64_ff for their first 16 quanta (the
# whole runs, 293 and 278 rounds to 61,719.4 and 62,347.6 ns with 1,737
# fan-outs, are held on the card by tests/test_torch_card_paths.py): by
# then both have fan-outs, fallbacks and engaged analytic rounds.
FFT_FF_QUANTA = 16
FFT_FF_SPAN_CTRS = dict(round_ctr=142, ctr_window=45, ctr_complex=7,
                        ctr_conflict=47, ctr_resolve=36, ctr_quantum=16,
                        ctr_ff=42, ctr_ffq=15, ff_events=20437)
FFT_FF_SPAN_COMPLETION_PS = 34_043_800  # the latest clock at the cut
FFT_FF_SPAN_FALLBACK = 5
FFT_FF_CTRS = dict(round_ctr=139, ctr_window=49, ctr_complex=7,
                   ctr_conflict=47, ctr_resolve=36, ctr_quantum=16,
                   ctr_ff=40, ctr_ffq=15, ff_events=15413)
FFT_FF_COMPLETION_PS = 34_043_800       # the latest clock at the cut
FFT_FF_FANOUT_SERVED = 598
FFT_FF_FALLBACK = 5
# Both cuts reach the same clocks and cursors.
FFT_FF_CUT = dict(clock_sum=2_104_508_400, cursor_sum=33_103)
HBM_BYTES_PER_S = 3.35e12          # H100 SXM peak memory rate
# One-card scale (phases 3 and 9), as the JAX package computes them on
# the CPU; BENCH_r06's radix256 and radix1024 rows give the same rounds
# and completions.  The 1024-tile rows run tpu/block_events = 4
# (bench.py), which puts T * H above the dense-table cap: the conflict
# rounds take the scatter forms, and chain_classify its wide form.
SCALE_K = 4
SCALE_H = 16384                    # max(1024, 16 T) at T = 1024
# radix1024 for its first 60 quanta (the whole run, 2,912
# rounds and 64,803.2 ns as in BENCH_r06, is held on the card by
# tests/test_torch_card_paths.py).
RADIX1024_QUANTA = 60
RADIX1024_CTRS = dict(round_ctr=1612, ctr_window=938, ctr_complex=397,
                      ctr_conflict=277, ctr_resolve=183, ctr_quantum=60)
RADIX1024_COMPLETION_PS = 31_250_800    # the latest clock at the cut
RADIX1024_CUT = dict(clock_sum=20_014_394_400, cursor_sum=73_300)
RADIX1024_CUT_ICOUNT = 129_142
# radix1024_chain12 for its first 12 quanta (the whole run,
# 632 rounds to 63,390.0 ns with 20 fan-outs, on the card by
# tests/test_torch_card_paths.py).
RADIX1024_CHAIN12_QUANTA = 12
RADIX1024_CHAIN12_CTRS = dict(round_ctr=375, ctr_window=260, ctr_complex=51,
                              ctr_conflict=6, ctr_resolve=58,
                              ctr_quantum=12)
RADIX1024_CHAIN12_COMPLETION_PS = 27_558_000  # the latest clock at the cut
RADIX1024_CHAIN12_CUT = dict(clock_sum=19_582_317_400, cursor_sum=70_465)
RADIX1024_CHAIN12_ICOUNT = 125_357
RADIX1024_CHAIN12_FANOUT = 0
# radix256 (BENCH_r06's trace, keys_per_tile 96) for its first 24
# quanta, since phase 11 was added (the whole run, 5,475 rounds and
# 116,211.4 ns as in BENCH_r06, is held on the card by
# tests/test_torch_card_paths.py).
RADIX256_QUANTA = 24
RADIX256_CTRS = dict(round_ctr=542, ctr_window=258, ctr_complex=151,
                     ctr_conflict=133, ctr_resolve=71, ctr_quantum=24)
RADIX256_COMPLETION_PS = 12_225_800     # the latest clock at the cut
RADIX256_CUT = dict(clock_sum=2_752_533_600, cursor_sum=72_559)
RADIX256_ICOUNT = 145_147
# gen_radix(512, keys_per_tile=16, radix=64, seed=0) at block_events 4,
# 8 quanta (the last size at which the conflict round's one-hot tables
# are dense): the JAX package's counters after those quanta.
RADIX512_QUANTA = 8
RADIX512_CUT = dict(round_ctr=232, ctr_window=148, ctr_complex=49,
                    ctr_conflict=35, ctr_resolve=24, ctr_quantum=8,
                    clock_max=6_764_600, clock_sum=2_237_566_200,
                    cursor_sum=9848)


# The coherence protocols (phases 3 and 10), as the JAX package computes
# them on the CPU.
MOSI = "pr_l1_pr_l2_dram_directory_mosi"
SH_MSI = "pr_l1_sh_l2_msi"
SH_MESI = "pr_l1_sh_l2_mesi"
PROTOCOLS = (MOSI, SH_MSI, SH_MESI)
SHL2_MESI_FF = {"caching_protocol/type": SH_MESI, "tpu/miss_chain": CHAIN,
                "tpu/fast_forward": FF, "tpu/fast_forward_span": FF_SPAN_NS}
# radix64_shl2_mesi_ff_span runs phase 5's trace for 6 quanta (a cut run,
# in which all three kernels launch; tests/data/card_pins_cuts.json; the
# whole keys-64 run takes 426 rounds to 65,174.8 ns).
# fft64_mosi for its first 14 quanta and fft64_shl2_msi for its first 12
# (the whole runs, 354 rounds to 48,966.2 ns with 1,855
# fan-outs and 94 fallbacks, and 371 rounds to 37,856.6 ns with 282 and
# 41, are held on the card by tests/test_torch_card_paths.py).
FFT_MOSI_QUANTA = 14
FFT_MOSI_CTRS = dict(round_ctr=179, ctr_window=94, ctr_complex=7,
                     ctr_conflict=41, ctr_resolve=37, ctr_quantum=14)
FFT_MOSI_COMPLETION_PS = 29_192_600     # the latest clock at the cut
FFT_MOSI_CUT = dict(clock_sum=1_826_229_200, cursor_sum=31_904)
FFT_MOSI_ICOUNT = 279_956
FFT_MOSI_FANOUT, FFT_MOSI_FALLBACK = 534, 52
# fft64 under shared-L2 MSI with the controllers on 8 tiles (stride 8).
SHL2_CTRL = 8
FFT_SHL2_QUANTA = 12
FFT_SHL2_CTRS = dict(round_ctr=230, ctr_window=118, ctr_complex=17,
                     ctr_conflict=41, ctr_resolve=54, ctr_quantum=12)
FFT_SHL2_COMPLETION_PS = 24_310_600     # the latest clock at the cut
FFT_SHL2_CUT = dict(clock_sum=1_511_812_400, cursor_sum=36_938)
FFT_SHL2_ICOUNT = 286_650
FFT_SHL2_FANOUT, FFT_SHL2_FALLBACK = 150, 16
# The network models (phase 11): gen_fft(64, points_per_tile=
# NET_FFT_POINTS, writeback=True) at miss_chain 12 under ATAC on both
# networks (default AtacParams; its first 16 quanta since phase 17 was
# added, tests/data/card_pins_cuts.json; the whole run, 367 rounds to
# 59,469.0 ns with 1,909 fan-outs and 19 fallbacks, is held on the card
# by tests/test_torch_card_paths.py) and under the contended hop-by-hop
# mesh, as the JAX package computes them on the CPU.
NET_FFT_POINTS = 64
# fft64_hbh_contended runs its first 40 quanta (a cut run: 710 of its
# 1,759 rounds; the whole run, 209,377.8 ns and 8,595,738,800 ps of link
# wait, is held on the card by tests/test_torch_card_paths.py).
FFT_HBH_QUANTA = 40
FFT_HBH_CTRS = dict(round_ctr=710, ctr_window=218, ctr_complex=11,
                    ctr_conflict=481, ctr_resolve=136, ctr_quantum=40)
FFT_HBH_COMPLETION_PS = 88_225_600      # the latest clock at the cut
FFT_HBH_CUT = dict(clock_sum=5_421_584_800, cursor_sum=31_002)
FFT_HBH_LINK_WAIT_PS = 3_217_312_800


# The synchronisation, CAPI and system-event paths (phase 12) and the
# ThreadScheduler paths (phase 13), whole runs at T = 64, as the JAX
# package computes them on the CPU: the round counters, the completion,
# the sums of the counters named and the [vm] section (None: the trace
# makes no memory-management syscall).
SYNC_SUMS = ("icount", "mutex_acquires", "cond_waits", "cond_signals",
             "joins", "spawns", "syscalls", "syscall_ps", "net_link_wait_ps",
             "sends", "recvs", "net_user_flits", "sync_stall_ps",
             "mem_stall_ps")
# lock64, sysev64_ff, threads128on64_chain12 and lock128on64 run cut since
# phase 17 was added: main() adds their entries from
# tests/data/card_pins_cuts.json (``quanta``, ``cut``: the latest clock,
# the clocks' and cursors' sums at the cut); their whole runs (5,900
# rounds to 147,411.2 ns; 266 to 52,823.2 ns; 243 to 48,968.6 ns; 1,830
# to 46,035.2 ns) are held on the card by tests/test_torch_card_paths.py.
SYNC_PINS = {
    # The pairs are mesh neighbours, so no two packets share a link: the
    # flights run and wait 0 ps (the fan-in of test_torch_sync_runs.py
    # shows the waits on the CPU).
    "pingpong64_hbh_user": dict(
        ctrs=dict(round_ctr=264, ctr_window=132, ctr_complex=132,
                  ctr_conflict=0, ctr_resolve=0, ctr_quantum=17),
        completion_ps=768_000,
        sums=dict(icount=0, mutex_acquires=0, cond_waits=0, cond_signals=0,
                  joins=0, spawns=0, syscalls=0, syscall_ps=0,
                  net_link_wait_ps=0, sends=2048, recvs=2048,
                  net_user_flits=18432, sync_stall_ps=44_704_000,
                  mem_stall_ps=0),
        vm=None),
    "threads64_chain12": dict(
        ctrs=dict(round_ctr=31, ctr_window=18, ctr_complex=7,
                  ctr_conflict=0, ctr_resolve=6, ctr_quantum=3),
        completion_ps=4_127_400,
        sums=dict(icount=54912, mutex_acquires=0, cond_waits=0,
                  cond_signals=0, joins=32, spawns=32, syscalls=0,
                  syscall_ps=0, net_link_wait_ps=0, sends=0, recvs=0,
                  net_user_flits=0, sync_stall_ps=31_836_400,
                  mem_stall_ps=115_703_200),
        vm=None),
    # Phase 13: 128 trace streams on 64 tiles under the ThreadScheduler
    # (``streams``: every one reported done).
    "barrier128on64": dict(
        ctrs=dict(round_ctr=248, ctr_window=131, ctr_complex=116,
                  ctr_conflict=1, ctr_resolve=1, ctr_quantum=81),
        completion_ps=13_355_400,
        sums=dict(icount=260053, mutex_acquires=0, cond_waits=0,
                  cond_signals=0, joins=0, spawns=0, syscalls=0,
                  syscall_ps=0, net_link_wait_ps=0, sends=0, recvs=0,
                  net_user_flits=0, sync_stall_ps=289_671_600,
                  mem_stall_ps=75_618_000),
        vm=None, streams=128),
}


# Phase 3's iocoom operand sets: (label, config overrides) at T = 64,
# each at miss_chain 0 and 12; the mixed lists put simple and iocoom
# tiles first and last in both orders.
_IOCOOM = {"tile/model_list": "<default,iocoom,T1,T1,T1>"}
_NOSPEC = {"core/iocoom/speculative_loads_enabled": False}
_MIXED = {"tile/model_list": "<32,simple,T1,T1,T1>, <32,iocoom,T1,T1,T1>"}
_SWAPPED = {"tile/model_list": "<32,iocoom,T1,T1,T1>, <32,simple,T1,T1,T1>"}
IOCOOM_WALK_SETS = (
    ("uniform", _IOCOOM), ("uniform nospec", {**_IOCOOM, **_NOSPEC}),
    ("mixed", _MIXED), ("mixed nospec", {**_MIXED, **_NOSPEC}),
    ("swapped nospec", {**_SWAPPED, **_NOSPEC}))

# Phase 14: radix1536_chain12, ``gen_radix(1536, keys_per_tile=16,
# radix=64, seed=0)`` at block_events 4 and miss_chain 12 on the default
# directory (24 sharer words, 4.83 GB of them; chain_classify's grid
# form), cut at 8 quanta, as the JAX package computes it on the CPU (the
# whole run, 818 rounds with 13 conflict rounds and 34 fan-outs, is held
# on the card by tests/test_torch_card_paths.py).
RADIX1536_T = 1536
RADIX1536_QUANTA = 8
RADIX1536_CTRS = dict(round_ctr=270, ctr_window=194, ctr_complex=37,
                      ctr_conflict=0, ctr_resolve=39, ctr_quantum=8)
RADIX1536_COMPLETION_PS = 20_754_000    # the latest clock at the cut
RADIX1536_CUT = dict(clock_sum=18_207_678_600, cursor_sum=54_447)
RADIX1536_ICOUNT = 109_683
RADIX1536_FANOUT = 0
GRID_SMALL_DIR = 64        # directory entries a tile at T = 2048: 4 sets


T_START = time.perf_counter()


def stamp(what: str) -> None:
    """Elapsed seconds since the script started, after a phase."""
    print(f"[{time.perf_counter() - T_START:.1f} s] {what}", flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    raise SystemExit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def time_cuda(fn, iters: int, warmup: int) -> float:
    """Milliseconds per call: CUDA events around ``iters`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def max_abs_err(a, b) -> int:
    import torch
    check(a.dtype == b.dtype and a.shape == b.shape,
          f"dtype/shape mismatch {a.dtype}{tuple(a.shape)} vs "
          f"{b.dtype}{tuple(b.shape)}")
    if a.numel() == 0:
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item())


def nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def chain_bytes(params, si, head, out) -> int:
    """Bytes one replay iteration (head gathers, directory-row gathers,
    classify) must move on these operands: each input element the
    function reads, once, and every output element (``head`` and
    ``out`` are the plain step's result on ``si``).

    Every tile reads its head index, stop flag, bank count and base, and
    the delta and local cost of its head slot (both feed outputs of
    every row); an active tile also its head's request word.  Every
    tile's directory row is read (its probe and victim scan feed the way
    of every row), each distinct flat set's A words once, and the W
    sharer words of the way each row picks, each distinct (set, way)
    once (a combining member's own-bit word is among them: a member's
    way is its representative's, in the same row).  Periods: each tile
    its L1 side (the fill time of every row) and, without a magic
    network, its network period; each distinct home its directory
    period and network period; each served owner leg's owner its L2
    (with shared L2: L1D) and network periods; each fan-out row its core
    period; with the DRAM queue model off each tile its L2 period (none
    with shared L2); with shared L2 and a network that is not magic, each
    distinct memory controller that a DRAM read reaches from another
    slice its network period; under atac the two per-tile tables
    (cluster and access-point hops), once.  Writes: every ChainHead
    and ChainOut element, and with the queue model off each floor-table
    slot a served row wins (line and time), once."""
    import torch
    T = params.num_tiles
    A = params.directory.associativity
    W = si.dir_sharers.shape[0] // A
    net = params.net_memory.model != "magic"
    i64 = torch.int64

    def distinct(*keys):
        return torch.unique(torch.stack([k.to(i64) for k in keys]),
                            dim=1).shape[1]

    moved = T * (4 + 1 + 4 + 8)                     # head, stopped, count,
    #                                                 base
    if params.net_memory.model == "atac":
        moved += T * (4 + 4)                         # cluster_of, ap_hops
    moved += T * (8 + 8) + 8 * int(head.active.sum())  # delta, extra, req
    moved += 8 * A * distinct(head.fidx)             # directory rows
    moved += 8 * W * distinct(head.fidx, out.way)    # sharer words
    moved += 4 * T * (1 + int(net))                  # L1 and network
    moved += 4 * distinct(head.home) * (1 + int(net))  # dir, network
    legs = out.owner[out.owner_leg]
    if legs.numel():
        moved += 4 * distinct(legs) * (1 + int(net))  # L2, network
    moved += 4 * int(out.fan_go.sum()) if out.inv_bool is not None else 0
    sites = out.need_read & (out.from_dram_ps > 0)
    if bool(sites.any()):
        from graphite_tpu_torch.engine import dense
        moved += 4 * distinct(dense.dram_site_of_line(
            params, head.line[sites]))               # controller network
    if out.ftbl is not None:
        moved += 0 if params.shared_l2 else 4 * T    # L2 period
        won = head.hidx[out.serve_all]
        moved += 16 * (distinct(won) if won.numel() else 0)
    return moved + nbytes(head) + nbytes(t for f, t in zip(out._fields, out)
                                          if f != "ftbl")


def ff_bytes(params, vp, fi) -> int:
    """Bytes one fast-forward call must move on these operands: each input
    element the function reads, once, and every output element it
    writes.

    A candidate tile (tile_active, models enabled) reads its committed
    prefix: per event the valid flag and the op, and what its kind uses
    (COMPUTE: arg, arg2 and addr; BRANCH: arg and addr when there is a
    predictor; MEM: addr, and arg2 only where the tile engages, for the
    icount row).  Each COMPUTE or MEM event probes one set row of L1I or
    L1D (A words, once per distinct row), each branch one predictor
    entry (once per distinct slot).  The walk stops at the first event
    it does not commit.  Where the clock before that event has reached
    the run-ahead bound, nothing of the event is needed (the clock is
    the sum of the committed events' times); otherwise the event is
    ineligible, and the walk reads its valid flag, its op where it is
    valid, and the address and probed row of a COMPUTE or MEM.  Every
    tile reads its active flag and clock (a declined tile returns the
    clock); a candidate reads three periods.  Every tile writes its
    clock, n_ret and 12 counters; an engaged tile also writes each word
    it touches and each predictor entry it updates, once.  The whole
    cache arrays are not counted: the function needs only the rows it
    probes."""
    import torch
    from graphite_tpu_torch.engine.kernels import window as kwin
    fp = kwin.ff_price(params, vp, fi)
    T, F = fi.addr.shape
    dev = fi.addr.device
    cand = fi.tile_active & fi.models_enabled
    comm = fp.commit0                        # a prefix; only candidates
    n_c = comm.sum(1)
    pre = fi.clock + torch.where(comm, fp.dt, 0).sum(1)
    at_bound = pre >= kwin._ff_bound(params, vp, fi.boundary)
    stop = (cand & ~at_bound & (n_c < F))[:, None] \
        & (torch.arange(F, device=dev)[None] == n_c[:, None])
    rows = torch.arange(T, device=dev)[:, None].expand(T, F)

    def count(mask):
        return int(mask.sum())

    def distinct(mask, *keys):
        return torch.unique(torch.stack([k[mask].to(torch.int64)
                                         for k in keys]), dim=1).shape[1]

    is_mem = fp.is_rd | fp.is_wr
    eng = comm & fp.engage[:, None]
    # is_comp / is_mem are false on an invalid event (its op reads as NOP).
    probe_i = (comm | stop) & fp.is_comp
    probe_d = (comm | stop) & is_mem
    moved = count(comm | stop)                              # valid_ev
    moved += 4 * count(comm | (stop & fi.valid_ev))         # op
    moved += 8 * count(comm & fp.is_comp)                   # arg, arg2
    moved += 4 * count(eng & is_mem)                        # arg2
    moved += 8 * count(probe_i | probe_d)                   # addr
    moved += distinct(probe_i, rows, fp.pI.set_idx) \
        * params.l1i.associativity * 8
    moved += distinct(probe_d, rows, fp.pD.set_idx) \
        * params.l1d.associativity * 8
    if fp.bidx is not None:
        moved += (4 + 8) * count(comm & fp.is_br)           # arg, addr
        moved += distinct(comm & fp.is_br, rows, fp.bidx)   # table entries
    moved += T * (1 + 8) + count(cand) * 3 * 4 + 8 + 1 + 4  # active, clock,
    #                                  periods, boundary, enable, stamp base
    moved += T * (8 + 4 + 12 * 8)                           # clock, n_ret, ctr
    moved += 8 * (distinct(eng & fp.is_comp, rows, fp.pI.set_idx, fp.pI.way)
                  + distinct(eng & is_mem, rows, fp.pD.set_idx, fp.pD.way))
    if fp.bidx is not None:
        moved += distinct(eng & fp.is_br, rows, fp.bidx)
    return moved


def window_bytes(params, vp, wi, out) -> int:
    """Bytes one window walk must move on these operands: each input
    element the function reads, once, and every output element it writes
    (``out`` is the plain form's result on ``wi``).

    Every event's arg and arg2 are read (each event's spawn landing and
    child are outputs).  A tile that retires (active, models enabled)
    examines its retired prefix and the event that stops it, unless the
    window had closed before that event (the clock past the bound, or at
    P > 0 the chain out of room or credit): per examined event its valid
    flag, its op where valid, and its address where its kind uses it
    (COMPUTE, MEM, STALL and SYNC; BRANCH with a predictor).  A COMPUTE
    probes its L1I row, a MEM its L1D row, and either one its L2 row where
    the L1 does not serve it (A words a row, each distinct row once; no
    L2 row with shared L2, where the L2 period is not read either); a
    branch reads its predictor entry (once per distinct slot); at P > 0 a
    tile whose examined events probe reads its pending bank slots.  Every
    tile reads its active flag, clock and core period (and its id and
    network period without a magic network, and under atac the two
    per-tile tables, cluster and access-point hops); a retiring tile its L1I,
    L1D and L2 periods; at P > 0 every tile its bank count and relative
    clock, a retiring one its bank head.  Writes: the fresh outputs, each
    distinct word the retired prefix touches, each fill word (and its
    round-robin pointer, read and written, on a miss under round_robin),
    each predictor entry written, each banked element's three words.
    Under iocoom cores every tile reads its load and store queue rings
    and its iocoom mask entry.  The whole cache arrays are not counted:
    the function needs only the rows it probes."""
    import torch
    from graphite_tpu_torch.engine import cache as cachemod
    from graphite_tpu_torch.engine.kernels import window as kwin
    from graphite_tpu_torch.isa import EventOp
    T, K = wi.addr.shape
    dev = wi.addr.device
    P = params.miss_chain
    act = wi.tile_active & wi.models_enabled
    n = out.n_ret.to(torch.int64)
    ar = torch.arange(K, device=dev)
    ret = ar[None] < n[:, None]
    if P > 0:
        wb = kwin._spanned_bound(params, vp, wi.boundary)
        nm = out.mq_count
        still = torch.where(nm == 0, out.clock < wb,
                            (out.chain_rel < vp.quantum_ps) & (nm < P))
    else:
        still = out.clock < wi.boundary
    stop = (act & still & (n < K))[:, None] & (ar[None] == n[:, None])
    exam = ret | stop
    op = torch.where(wi.valid_ev & exam, wi.meta[0], int(EventOp.NOP))
    is_comp = op == EventOp.COMPUTE
    is_rd, is_wr = op == EventOp.MEM_READ, op == EventOp.MEM_WRITE
    is_mem = is_rd | is_wr
    is_br = op == EventOp.BRANCH
    is_time = (op == EventOp.STALL) | (op == EventOp.SYNC)
    bp = params.core.bp_type != "none"
    line = wi.addr >> (params.line_size.bit_length() - 1)

    def probe(word, rr, cp):
        return cachemod.probe(cachemod.CacheArrays(word=word, rr_ptr=rr),
                              line, cp.num_sets)

    pI = probe(wi.l1i_word, wi.l1i_rr, params.l1i)
    pD = probe(wi.l1d_word, wi.l1d_rr, params.l1d)
    shared = params.shared_l2
    writable = cachemod.E if params.protocol_kind == "sh_l2_mesi" \
        else cachemod.M
    l1_ok = pD.hit & (is_rd | (pD.state >= writable))
    if shared:
        mem_l2 = comp_l2 = torch.zeros_like(l1_ok)
    else:
        p2 = probe(wi.l2_word, wi.l2_rr, params.l2)
        mem_l2 = is_mem & ~l1_ok & p2.hit \
            & (is_rd | (p2.state == cachemod.M))
        comp_l2 = is_comp & ~pI.hit & p2.hit
    rows = torch.arange(T, device=dev)[:, None].expand(T, K)
    bidx = wi.addr % params.core.bp_size

    def count(mask):
        return int(mask.sum())

    def distinct(mask, *keys):
        return torch.unique(torch.stack([k[mask].to(torch.int64)
                                         for k in keys]), dim=1).shape[1]

    moved = count(exam) + 4 * count(wi.valid_ev & exam)      # valid, op
    moved += 8 * T * K                                        # arg, arg2
    moved += 8 * count(is_mem | is_comp | is_time | (is_br & bp))  # addr
    moved += 8 * (params.l1i.associativity
                  * distinct(is_comp, rows, pI.set_idx)
                  + params.l1d.associativity
                  * distinct(is_mem, rows, pD.set_idx))
    if not shared:
        moved += 8 * params.l2.associativity * distinct(
            (is_comp & ~pI.hit) | (is_mem & ~l1_ok), rows, p2.set_idx)
    if bp:
        moved += distinct(is_br, rows, bidx)                  # entries read
    moved += T * (1 + 8 + 4) + (2 if shared else 3) * 4 * count(act) \
        + 8 + 1 + 4
    if params.net_user.model != "magic":
        moved += T * (4 + 4)                                  # id, period
    if params.net_user.model == "atac":
        moved += T * (4 + 4)                                  # atac tables
    moved += T * (8 + 4 + 12 * 8) + T * K * (1 + 4 + 8)       # fresh
    if params.core.model == "iocoom":                         # rings, mask
        moved += T * (8 * (wi.lq_ready.shape[0] + wi.sq_ready.shape[0])
                      + 1)
    r = ret & act[:, None]
    for hit_touch, fill, pr, cp in (
            (r & is_comp & pI.hit, r & comp_l2, pI, params.l1i),
            (r & is_mem & l1_ok, r & mem_l2, pD, params.l1d)):
        moved += 8 * (distinct(hit_touch, rows, pr.set_idx, pr.way)
                      + count(fill))
        if cp.replacement == "round_robin":
            moved += 8 * count(fill & ~pr.hit)
    if not shared:
        moved += 8 * distinct(r & (mem_l2 | comp_l2), rows, p2.set_idx,
                              p2.way)
    if bp:
        moved += distinct(r & is_br, rows, bidx)              # entries set
    if P > 0:
        probes = (is_mem | is_comp).any(1) & act
        npend = torch.clamp(wi.mq_count - wi.mq_head, min=0)
        moved += 8 * int(npend[probes].sum())                 # pending
        moved += T * (4 + 8) + 4 * count(act)                 # count, rel,
        #                                                       head
        moved += T * (8 + 4)                                  # fresh
        moved += 24 * int((out.mq_count - wi.mq_count).sum())  # banked
    return moved


def compare(kind, got, ref, label) -> int:
    """Every output field of a kernel against its plain form."""
    err = 0
    for f in ref._fields:
        a, b = getattr(got, f), getattr(ref, f)
        check((a is None) == (b is None), f"{kind}: field {f} presence")
        if b is None:
            continue
        e = max_abs_err(a, b)
        check(e == 0, f"{kind} kernel != plain on {label}, field {f} "
                      f"(max abs err {e})")
        err = max(err, e)
    return err


class Recorder:
    """Wraps a kernel entry point of the engine so that a run hands over
    (clones of) the operands of its first calls that ``keep`` accepts:
    ``keep(operands)``, or with ``after`` ``keep(result)`` (the operands
    cloned before the call, which may update them in place)."""

    def __init__(self, module, name, keep, limit, after=False):
        self.module, self.name = module, name
        self.orig = getattr(module, name)
        self.keep, self.limit, self.seen = keep, limit, []
        self.after = after

    def __enter__(self):
        def rec(params, vp, operands, *rest):
            if len(self.seen) >= self.limit:
                return self.orig(params, vp, operands, *rest)
            if not self.after:
                if self.keep(operands):
                    self.seen.append(clone_operands(operands))
                return self.orig(params, vp, operands, *rest)
            kept = clone_operands(operands)
            out = self.orig(params, vp, operands, *rest)
            if self.keep(out):
                self.seen.append(kept)
            return out
        setattr(self.module, self.name, rec)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def device_ms(fn, kernel: str, launches: int = 50):
    """Device time per launch of ``kernel`` over ``launches`` calls of
    ``fn`` (torch.profiler), or None where the profiler sees no device
    events."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        for _ in range(launches):
            fn()
        torch.cuda.synchronize()
    total, n = 0.0, 0
    for evt in prof.key_averages():
        if kernel in evt.key and evt.device_type is not None \
                and "cuda" in str(evt.device_type).lower():
            total += getattr(evt, "self_device_time_total",
                             getattr(evt, "self_cuda_time_total", 0.0))
            n += evt.count
    return total / 1e3 / n if n else None


def host_ms(fn, iters: int = 500) -> float:
    """Milliseconds of host time per call of ``fn`` (no device wait)."""
    for _ in range(20):
        fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


def allocations(fn) -> int:
    """Device allocation requests one call of ``fn`` makes."""
    import torch
    fn()
    key = "allocation.all.allocated"
    before = torch.cuda.memory_stats()[key]
    fn()
    return torch.cuda.memory_stats()[key] - before


def device_kernels(fn) -> int:
    """Device kernels one call of ``fn`` launches (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(evt.count for evt in prof.key_averages()
               if evt.device_type is not None
               and "cuda" in str(evt.device_type).lower()
               and getattr(evt, "self_device_time_total",
                           getattr(evt, "self_cuda_time_total", 0.0)))


def clone_operands(nt):
    return type(nt)(*[t.clone() if t is not None else None for t in nt])


def step_pair(kchain, p, v, si, H):
    """chain_classify's fused kernel and the plain step on the same
    operands: the kernel writes the floor table in place, so it runs on
    a clone of it and the plain step on ``si``.  The floor table the
    kernel returns must be the clone itself."""
    work = si._replace(ftbl=None if si.ftbl is None else si.ftbl.clone())
    got = kchain.chain_step_cuda(p, v, work, H)
    ref = kchain.chain_step(p, v, si, H)
    if work.ftbl is not None:
        check(got[1].ftbl.data_ptr() == work.ftbl.data_ptr(),
              "chain_classify: the floor table is not the operand's own")
    return got, ref


def compare_step(got, ref, label) -> int:
    """Every ChainHead and ChainOut field of the fused kernel against the
    plain step (the floor table included where the queue model is off)."""
    return max(compare("chain_classify", got[0], ref[0], label),
               compare("chain_classify", got[1], ref[1], label))


def ff_pair(kwin, p, v, fi):
    """fast_forward_walk's kernel and its plain form on the same operands:
    the kernel updates its operands in place, so it runs on a clone and
    the plain form on ``fi``; the leaves it writes must be the clone's
    own tensors."""
    work = clone_operands(fi)
    got = kwin.fast_forward_walk_cuda(p, v, work)
    ref = kwin.fast_forward_walk(p, v, fi)
    for f in kwin.FF_INPLACE_FIELDS:
        check(getattr(got, f).data_ptr() == getattr(work, f).data_ptr(),
              f"fast_forward_walk: leaf {f} is not the operand's own tensor")
    return got, ref


def ff_times(kwin, p, v, fi, iters=100, warmup=10):
    """One fast_forward_walk case, every launch from the span-start state
    of ``fi`` (which no launch touches): the wrapper's time per call
    (CUDA events over calls on fresh copies of the leaves the kernel
    writes), the kernel's device time per launch (torch.profiler, each
    launch after a device copy that restores those leaves) and the plain
    form's time."""
    def fresh():
        return fi._replace(**{f: getattr(fi, f).clone()
                              for f in kwin.FF_INPLACE_FIELDS})

    pool = iter([fresh() for _ in range(iters + warmup)])
    ms = time_cuda(lambda: kwin.fast_forward_walk_cuda(p, v, next(pool)),
                   iters=iters, warmup=warmup)
    del pool
    work = fresh()

    def restore_and_launch():
        for f in kwin.FF_INPLACE_FIELDS:
            getattr(work, f).copy_(getattr(fi, f))
        kwin.fast_forward_walk_cuda(p, v, work)

    dev = device_ms(restore_and_launch, "fast_forward_walk_kernel")
    plain = time_cuda(lambda: kwin.fast_forward_walk(p, v, fi), iters=20,
                      warmup=3)
    return ms, dev, plain


def walk_pair(kwin, p, v, wi, s_ids):
    """window_walk's kernel and its plain form on the same operands (the
    trace's ``s_ids`` streams): the kernel updates its operands in place,
    so it runs on a clone and the plain form on ``wi``.  The leaves the
    kernel writes must be the clone's own tensors."""
    work = clone_operands(wi)
    got = kwin.window_walk_cuda(p, v, work, s_ids)
    ref = kwin.window_walk(p, v, wi, s_ids)
    for f in kwin.INPLACE_FIELDS:
        if getattr(work, f) is not None:
            check(getattr(got, f).data_ptr() == getattr(work, f).data_ptr(),
                  f"window_walk: leaf {f} is not the operand's own tensor")
    return got, ref


def walk_times(kwin, p, v, wi, T, iters=100, warmup=10):
    """One window_walk case, every launch from the window-start state of
    ``wi`` (which no launch touches): the wrapper's time per call (CUDA
    events over calls on fresh copies of the leaves the kernel writes),
    the kernel's device time per launch (:func:`walk_device_ms`), the
    plain form's time and the plain result."""
    written = [f for f in kwin.INPLACE_FIELDS if getattr(wi, f) is not None]

    def fresh():
        return wi._replace(**{f: getattr(wi, f).clone() for f in written})

    pool = iter([fresh() for _ in range(iters + warmup)])
    ms = time_cuda(lambda: kwin.window_walk_cuda(p, v, next(pool), T),
                   iters=iters, warmup=warmup)
    del pool
    dev = walk_device_ms(kwin, p, v, wi, T)
    big = wi.addr.shape[1] > 16 and p.miss_chain > 0
    plain = time_cuda(lambda: kwin.window_walk(p, v, wi, T),
                      iters=10 if big else 20, warmup=2 if big else 3)
    return ms, dev, plain, kwin.window_walk(p, v, wi, T)


def walk_device_ms(kwin, p, v, wi, T, launches: int = 50):
    """window_walk's device time per launch (torch.profiler), each launch
    from the window-start state of ``wi``: a device copy restores the
    leaves the kernel writes before it, so the rows it reads are warm in
    L2, as in the engine where the round's other ops have just touched
    them."""
    written = [f for f in kwin.INPLACE_FIELDS if getattr(wi, f) is not None]
    work = wi._replace(**{f: getattr(wi, f).clone() for f in written})

    def restore_and_launch():
        for f in written:
            getattr(work, f).copy_(getattr(wi, f))
        kwin.window_walk_cuda(p, v, work, T)

    return device_ms(restore_and_launch, "window_walk_kernel", launches)


def peak_reset() -> int:
    """Restart the peak-memory count; return the bytes allocated now."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def peak_line(held: int) -> str:
    """The peak since :func:`peak_reset`, and its part above ``held``."""
    import torch
    peak = torch.cuda.max_memory_allocated()
    return (f"max_memory_allocated {peak} B ({peak - held} B above the "
            f"{held} B held before the run)")


def leaf_digest(a) -> str:
    """``dtype|shape|sha256`` of one state leaf, as
    tests/torch_jax_ref.py digests the JAX package's."""
    import hashlib
    import numpy as np
    a = np.ascontiguousarray(np.asarray(a))
    return (f"{a.dtype.str}|{'x'.join(map(str, a.shape))}|"
            f"{hashlib.sha256(a.tobytes()).hexdigest()[:32]}")


SHARD_TIMEOUT_S = 600.0     # each phase-17 launch, its ranks' own limit
# Phase 17's cut paths (tests/data/card_pins_shard.json): at 2 shards,
# at 4.
SHARD_PATHS_2 = ("radix64_shard", "radix64_chain12_shard",
                 "fft64_ff_span_shard")
SHARD_PATHS_4 = ("radix64_shard",)


def _shard_params(over, shards):
    from graphite_tpu_torch import load_config
    from graphite_tpu_torch.params import SimParams
    cfg = load_config()
    for k, v in over.items():
        cfg.set(k, v)
    cfg.set("tpu/tile_shards", str(shards))
    return SimParams.from_config(cfg)


def _shard_walks(group, walks, ffs, s_ids):
    """Each sharded walk on recorded operands (the same on every rank)
    against the whole-tile kernel and the plain form; rank 0 then times
    the sharded call, the kernel's device time per launch at its T/S
    tiles, the plain form, and counts the bytes its slice must move.
    Every rank makes the same collectives in the same order."""
    import dataclasses
    import torch
    from graphite_tpu_torch.engine.kernels import window as kwin
    from graphite_tpu_torch.engine.vparams import variant_params
    res = {}
    for kind, sets in (("run_window_sharded", walks),
                       ("run_fast_forward_sharded", ffs)):
        err, last = 0, None
        for over, nt in sets:
            p = _shard_params(over, 1)
            ps = dataclasses.replace(p, tile_shards=group.size)
            v = variant_params(p)
            nt = type(nt)(*[t.to(group.device) if t is not None else None
                            for t in nt])
            arg = clone_operands(nt)
            if kind == "run_window_sharded":
                got = kwin.run_window_sharded(ps, v, arg, s_ids, group)
                refs = (kwin.window_walk_cuda(p, v, clone_operands(nt),
                                              s_ids),
                        kwin.window_walk(p, v, nt, s_ids))
            else:
                got = kwin.run_fast_forward_sharded(ps, v, arg, group)
                refs = (kwin.fast_forward_walk_cuda(p, v,
                                                    clone_operands(nt)),
                        kwin.fast_forward_walk(p, v, nt))
            # The sharded walk writes its own cuts, never its operands.
            for f, a, b in zip(nt._fields, arg, nt):
                check(a is None or torch.equal(a, b),
                      f"{kind} wrote its operand {f}")
            for ref in refs:
                for f in ref._fields:
                    a, b = getattr(got, f), getattr(ref, f)
                    check((a is None) == (b is None), f"{kind}: {f}")
                    if b is not None:
                        err = max(err, max_abs_err(a, b))
            last = (p, ps, v, nt)
        p, ps, v, nt = last
        tl = p.num_tiles // group.size
        if kind == "run_window_sharded":
            call = lambda: kwin.run_window_sharded(  # noqa: E731
                ps, v, nt, s_ids, group)
            local = kwin.shard_local_window_in(nt, 0, tl)
            plain = lambda: kwin.window_walk(p, v, nt, s_ids)  # noqa: E731
        else:
            call = lambda: kwin.run_fast_forward_sharded(  # noqa: E731
                ps, v, nt, group)
            local = kwin.shard_local_ff_in(nt, 0, tl)
            plain = lambda: kwin.fast_forward_walk(p, v, nt)  # noqa: E731
        ms = time_cuda(call, iters=20, warmup=3)
        rec = dict(sets=len(sets), max_abs_err=err, ms=ms, tiles=tl)
        if group.rank == 0:
            if kind == "run_window_sharded":
                rec["device_ms"] = walk_device_ms(kwin, p, v, local, s_ids)
                moved = window_bytes(p, v, local,
                                     kwin.window_walk(p, v, local, s_ids))
            else:
                work = clone_operands(local)

                def restore_and_launch():
                    for f in kwin.FF_INPLACE_FIELDS:
                        getattr(work, f).copy_(getattr(local, f))
                    kwin.fast_forward_walk_cuda(p, v, work)

                rec["device_ms"] = device_ms(restore_and_launch,
                                             "fast_forward_walk_kernel")
                moved = ff_bytes(p, v, local)
            rec["plain_ms"] = time_cuda(plain, iters=5, warmup=1)
            rec["bytes"] = moved
            rec["bound_ms"] = moved / HBM_BYTES_PER_S * 1e3
        res[kind] = rec
    torch.cuda.synchronize()
    return res


def phase17_rank(group, pins, names, walk_file, record):
    """One rank of phase 17 (parallel.mesh.launch, gloo ranks sharing the
    card): the pinned cut paths ``names`` under ``tpu/tile_shards`` = the
    group's size, each held leaf by leaf to its JAX pin and its kernels'
    launches to its round counters, then both sharded walks held against
    the whole-tile kernels and the plain forms on recorded operands.
    With ``record``, operands are recorded from the paths (radix64
    windows and engaging fast-forward rounds) and rank 0 saves them to
    ``walk_file``; without, they are loaded from it."""
    import torch
    from graphite_tpu_torch import convert
    from graphite_tpu_torch.engine import core as kcore
    from graphite_tpu_torch.engine.kernels.dispatch import (COUNTS,
                                                            reset_counts)
    from graphite_tpu_torch.engine.quantum import megarun
    from graphite_tpu_torch.engine.sim import Simulator
    from graphite_tpu_torch.events import synth
    paths = {}
    walks, ffs = [], []
    for name in names:
        pin = pins[name]
        gen, kw = pin["trace"]
        p = _shard_params(pin["over"], group.size)
        sim = Simulator(p, getattr(synth, gen)(**kw), group=group)
        rw = Recorder(kcore.kwindow, "run_window_sharded",
                      lambda wi: bool(wi.tile_active.any()), 2)
        rf = Recorder(kcore.kwindow, "run_fast_forward_sharded",
                      lambda out: bool((out.n_ret > 0).any()), 2,
                      after=True)
        recording = contextlib.ExitStack()
        if record and name.startswith("radix64_shard"):
            recording.enter_context(rw)
        if record and p.fast_forward > 0:
            recording.enter_context(rf)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        with recording:
            sim.state = megarun(p, sim.state, sim.trace, pin["quanta"],
                                vp=sim.vp, group=group)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(COUNTS)
        walks += [(pin["over"], w) for w in rw.seen]
        ffs += [(pin["over"], f) for f in rf.seen]
        leaves = convert.state_to_numpy(sim.state)
        want = pin["cut"]["leaves"]
        bad = sorted(k for k in set(leaves) | set(want)
                     if k not in leaves or k not in want
                     or leaf_digest(leaves[k]) != want[k])
        ctrs = {k: int(leaves[k]) for k in pin["cut"]["ctrs"]}
        paths[name] = dict(
            bad=bad, ctrs=ctrs, wall=wall, counts=counts,
            quanta=pin["quanta"], peak=torch.cuda.max_memory_allocated(),
            completion_ps=int(leaves["clock"].max()),
            fanout=int(leaves["counters.chain_fanout_served"].sum()),
            ff_rounds=int(leaves["ctr_ff"]))
        del sim
    if record:
        if group.rank == 0:
            torch.save(dict(
                walks=[(o, tuple(t.cpu() if t is not None else None
                                 for t in w)) for o, w in walks],
                ffs=[(o, tuple(t.cpu() for t in f)) for o, f in ffs]),
                walk_file)
    else:
        from graphite_tpu_torch.engine.kernels import window as kwin
        saved = torch.load(walk_file)
        walks = [(o, kwin.WindowIn(*w)) for o, w in saved["walks"]]
        ffs = [(o, kwin.FFIn(*f)) for o, f in saved["ffs"]]
    check(walks and ffs, f"phase 17: {len(walks)} window and {len(ffs)} "
                         f"fast-forward operand sets recorded")
    reset_counts()
    return dict(paths=paths, walks=_shard_walks(group, walks, ffs, 64))


def check_shard_runs(shards, runs, pins, card):
    """Phase 17's checks of one launch's ranks: every path's leaves and
    round counters the JAX package's (every rank), the sharded walks
    launched once per window round (and once per analytic round),
    chain_classify P times per chain pass, both sharded walks equal
    to the whole-tile kernel and the plain form on the recorded
    operands.  Prints rank 0's numbers; returns rank 0's launches of
    the two sharded walks over the paths."""
    total = [0, 0]
    for rank, res in enumerate(runs):
        for name, r in res["paths"].items():
            check(not r["bad"], f"{name} at {shards} shards, rank "
                  f"{rank}: leaves differ from the JAX package's: "
                  f"{r['bad']}")
            c, n = r["ctrs"], r["counts"]
            check(c == pins[name]["cut"]["ctrs"],
                  f"{name}: round counters {c}")
            check(n["run_window_sharded"] == c["ctr_window"]
                  == n["window_walk"] and c["ctr_window"] > 0,
                  f"{name} at {shards} shards, rank {rank}: "
                  f"run_window_sharded launches "
                  f"{n['run_window_sharded']}, window_walk "
                  f"{n['window_walk']}, ctr_window {c['ctr_window']}")
            check(n["run_fast_forward_sharded"]
                  == n["fast_forward_walk"]
                  >= n["ff_engaged"],
                  f"{name}: fast-forward launches {n}")
            p = _shard_params(pins[name]["over"], 1)
            check((n["run_fast_forward_sharded"] > 0)
                  == (p.fast_forward > 0),
                  f"{name}: run_fast_forward_sharded launches "
                  f"{n['run_fast_forward_sharded']}")
            P = p.miss_chain
            check(n["chain_classify"] == P * (c["ctr_resolve"] if P
                                              else 0)
                  and (P == 0 or n["chain_classify"] > 0),
                  f"{name}: chain_classify launches "
                  f"{n['chain_classify']} != {P} x chain passes")
            if rank == 0:
                total[0] += n["run_window_sharded"]
                total[1] += n["run_fast_forward_sharded"]
                rounds = c["round_ctr"]
                print(f"{name} at {shards} shards: cut at "
                      f"{r['quanta']} quanta, every leaf and round "
                      f"counter the JAX package's on every rank, "
                      f"round_ctr {rounds}, latest clock "
                      f"{r['completion_ps'] / 1000:.1f} ns, "
                      f"chain_fanout_served {r['fanout']}, ctr_ff "
                      f"{r['ff_rounds']}; run_window_sharded launches "
                      f"{n['run_window_sharded']} (T/S = "
                      f"{64 // shards} blocks each), "
                      f"run_fast_forward_sharded "
                      f"{n['run_fast_forward_sharded']}, "
                      f"chain_classify {n['chain_classify']}")
                print(f"{name} at {shards} shards: wall "
                      f"{r['wall']:.3f} s, "
                      f"{1e3 * r['wall'] / rounds:.4f} ms/round, "
                      f"rank 0's peak device memory {r['peak']} B on "
                      f"{card}")
        for kind, w in res["walks"].items():
            check(w["sets"] > 0 and w["max_abs_err"] == 0,
                  f"{kind} at {shards} shards, rank {rank}: {w}")
    for kind, w in runs[0]["walks"].items():
        print(f"kernel {kind} at {shards} shards ({w['tiles']} tiles a "
              f"rank): {w['sets']} recorded operand sets, equal to the "
              f"whole-tile kernel and the plain form on every rank; "
              f"{w['ms']:.6f} ms/call (the sharded call, gather "
              f"included), device {fmt_ms(w['device_ms'])} per launch, "
              f"plain {w['plain_ms']:.6f} ms, bound "
              f"{w['bound_ms']:.9f} ms ({w['bytes']} bytes the slice "
              f"moves, at {HBM_BYTES_PER_S / 1e12:.2f} TB/s) on {card}")
    return total


def phase17(card: str, count: int):
    """Phase 17: one launch of gloo ranks sharing the card per shard count
    (2: the three cut paths; 4: radix64; 8: the walks on the operands the
    2-rank launch recorded), each rank's results checked.  Returns the
    launches' results by shard count and rank 0's launches of the two
    sharded walks in the 2-rank launch's paths."""
    from graphite_tpu_torch.parallel.mesh import launch
    pins17 = json.load(open(os.path.join(HERE, "tests", "data",
                                         "card_pins_shard.json")))
    runs17 = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        walk_file = os.path.join(tmp, "walks.pt")
        for shards, names in ((2, SHARD_PATHS_2), (4, SHARD_PATHS_4),
                              (8, ())):
            t0 = time.perf_counter()
            runs17[shards] = launch(phase17_rank, shards, device="cuda",
                                    timeout_s=SHARD_TIMEOUT_S,
                                    args=(pins17, list(names), walk_file,
                                          shards == 2))
            print(f"phase 17: {shards} ranks on {count} card(s), one "
                  f"launch in {time.perf_counter() - t0:.3f} s")
            lsw = check_shard_runs(shards, runs17[shards], pins17, card)
            if shards == 2:
                lw17 = lsw
            stamp(f"phase 17: {shards} shards")
    return runs17, lw17


def phase15_queue_models(dev) -> int:
    """``basic_ring``, ``mg1_delay``, ``probe`` and ``occupy`` on seeded
    batches as CUDA tensors, every output byte for byte the same call's
    on the CPU (``dram_qacc``, the models' float64 state, among them):
    repeated resources, occupancy rows, the moving average off and at
    windows 1, 2, 16 and 64, a batch of 1,200 rows on few resources at
    window 2, and moments whose M/G/1 wait turns on the fused variance.
    Returns the bytes compared."""
    import numpy as np
    import torch
    from graphite_tpu_torch.engine import queue_models as tq
    rng = np.random.default_rng(15)
    compared = 0

    def same(label, cpu, card):
        nonlocal compared
        for i, (a, b) in enumerate(zip(cpu, card)):
            if a is None:
                check(b is None, f"{label} output {i}: None on the CPU")
                continue
            a, b = a.numpy(), b.cpu().numpy()
            check(a.dtype == b.dtype and a.tobytes() == b.tobytes(),
                  f"{label} output {i}: the card's differs from the CPU's")
            compared += a.nbytes

    def both(fn, label, *args, **kw):
        def on(d):
            def t(a):
                return torch.from_numpy(np.array(a)).to(d) \
                    if isinstance(a, np.ndarray) else a
            return fn(*[t(a) for a in args],
                      **{k: t(v) for k, v in kw.items()})
        cpu, card = on("cpu"), on(dev)
        if isinstance(cpu[0], tuple):          # (RingFcfsResult, moments)
            cpu, card = list(cpu[0]) + [cpu[1]], list(card[0]) + [card[1]]
        same(label, cpu, card)

    def batch(K, C, steady):
        res = rng.integers(0, C, K).astype(np.int32)
        base = rng.integers(1_000, 10**9, C)
        arr = (base[res] + rng.integers(0, 3, K)) if steady \
            else rng.integers(0, 10**9, K)
        return (res, arr.astype(np.int64),
                rng.integers(1, 3_000, K).astype(np.int64),
                rng.random(K) < 0.85)

    def state(C, R=8):
        re = np.zeros((R, C), np.int64)
        re[0] = rng.integers(0, 2 * 10**9, C)
        m = np.zeros((6, C), np.float64)
        m[0] = rng.integers(1, 10**6, C)
        m[1] = m[0] ** 2 / rng.integers(1, 30, C) \
            + rng.integers(0, 10**9, C)
        m[2] = rng.integers(1, 60, C)
        m[3] = rng.integers(1, 10**9, C)
        m[4] = rng.integers(1_000, 10**9, C) + rng.random(C)
        m[5] = rng.integers(0, 70, C)
        return [np.zeros((R, C), np.int64), re, np.zeros(C, np.int32), m]

    C = 64
    for qtype, window in (("basic", 0), ("basic", 1), ("basic", 2),
                          ("basic", 16), ("basic", 64), ("m_g_1", 0)):
        for trial in range(4):
            st = state(C)
            b = batch(2 * C, C, trial % 2 == 1)
            occ = batch(2 * C, C, False)
            both(tq.probe, f"probe {qtype} W={window}", qtype, *b, *st,
                 *occ, ma_window=window)
            both(tq.occupy, f"occupy {qtype} W={window}", qtype, *st,
                 b[0], b[1], 150, b[3], ma_window=window)
    b = batch(1200, 4, True)
    b[0][:1050] = 0
    b[3][:1050] = True
    both(tq.probe, "probe basic W=2, 1,200 rows", "basic", *b, *state(4),
         ma_window=2)
    b = batch(96, C, False)
    st = state(C)
    both(tq.basic_ring, "basic_ring", *b, *st[:3], *batch(32, C, True),
         moments=st[3], ma_window=64)
    both(tq.mg1_delay, "mg1_delay", *b, st[3], *batch(32, C, False))
    m = np.array([[2524382.0], [float.fromhex("0x1.49f488758ffffp+37")],
                  [36.0], [38195617.0]])
    both(tq.mg1_delay, "mg1_delay fused variance", np.zeros(1, np.int32),
         np.full(1, 10**9, np.int64), np.full(1, 5, np.int64),
         np.ones(1, bool), m)
    return compared


def fmt_ms(ms) -> str:
    return "not measured" if ms is None else f"{ms:.6f} ms"


def profile_stretch(psim, wall_ms, card, label, names, quanta=None,
                    subrounds=None, top=0):
    """torch.profiler (device activity only) over ``quanta`` quantum
    steps of a simulation already past its start-up, or over the first
    ``subrounds`` sub-rounds (local advance, then resolve) of its next
    quantum: device time per round against the unprofiled ``wall_ms``
    per round, kernels and host polls (device-to-host copies, each a
    host wait) per round, each named kernel's time and, with ``top``,
    the ``top`` device kernels that took the most time; and the
    profiler's own seconds around the stretch."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from graphite_tpu_torch.engine.core import local_advance
    from graphite_tpu_torch.engine.quantum import megarun, next_boundary
    from graphite_tpu_torch.engine.resolve import resolve
    params, vp = psim.params, psim.vp
    torch.cuda.synchronize()
    q0 = int(psim.state.ctr_quantum.item())
    r0 = int(psim.state.round_ctr.item())
    t_prof = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        if subrounds is None:
            psim.state = megarun(params, psim.state, psim.trace, quanta,
                                 vp=vp)
        else:
            # The simulation is left inside its quantum: it is not run
            # on after its stretch.
            st = psim.state._replace(
                boundary=next_boundary(params, psim.state, vp=vp),
                ctr_quantum=psim.state.ctr_quantum + 1)
            for _ in range(subrounds):
                st = resolve(params, local_advance(params, st, psim.trace,
                                                   vp=vp), vp=vp)
            psim.state = st
        torch.cuda.synchronize()
        pwall = time.perf_counter() - t0
    pr = max(int(psim.state.round_ctr.item()) - r0, 1)
    pq = int(psim.state.ctr_quantum.item()) - q0
    what = f"{pq} quanta" if subrounds is None \
        else f"{subrounds} sub-rounds of 1 quantum"
    dev_us, n_kernels, ppolls = 0.0, 0, 0
    per = {n: [0.0, 0] for n in names}
    by_kernel = []
    for evt in prof.key_averages():
        if "Memcpy DtoH" in evt.key:          # one per .item() / .tolist()
            ppolls += evt.count
        t = getattr(evt, "self_device_time_total",
                    getattr(evt, "self_cuda_time_total", 0.0))
        if t and evt.device_type is not None \
                and "cuda" in str(evt.device_type).lower():
            dev_us += t
            n_kernels += evt.count
            by_kernel.append((t, evt.count, evt.key))
            for n in names:
                if n in evt.key:
                    per[n][0] += t
                    per[n][1] += evt.count
    own_s = time.perf_counter() - t_prof - pwall
    if dev_us <= 0:
        print(f"profile {label}: {what}, {pr} rounds in {pwall:.3f} s "
              f"wall; device time not measured (the profiler saw no "
              f"device events), host polls {ppolls}; the profiler's own "
              f"time {own_s:.3f} s")
        return
    busy_ms = dev_us / 1e3 / pr
    shares = ", ".join(
        f"{n} {per[n][0] / 1e3:.3f} ms over {per[n][1]} launches "
        f"({per[n][0] / 1e3 / max(per[n][1], 1):.6f} ms each, "
        f"{per[n][0] / dev_us:.4f} of device time)" for n in names)
    # The profiler's host overhead stretches the wall of this stretch, so
    # the busy share is device time per round over the unprofiled wall
    # time per round of the same run.
    print(f"profile {label}: {what}, {pr} rounds in {pwall:.3f} s "
          f"profiled wall ({1e3 * pwall / pr:.4f} ms/round); device busy "
          f"{dev_us / 1e3:.3f} ms ({busy_ms:.6f} ms/round, "
          f"{busy_ms / wall_ms:.4f} of the unprofiled {wall_ms:.4f} "
          f"ms/round, idle share {1 - busy_ms / wall_ms:.4f}), {n_kernels} "
          f"device kernels ({n_kernels / pr:.1f} per round), host polls "
          f"{ppolls} ({ppolls / pr:.2f} per round); {shares}; the "
          f"profiler's own time {own_s:.3f} s, on {card}")
    for t, n, key in sorted(by_kernel, reverse=True)[:top]:
        print(f"profile {label}: top device kernel {key[:90]!r}: "
              f"{t / 1e3:.3f} ms over {n} launches ({t / 1e3 / pr:.6f} "
              f"ms/round, {t / dev_us:.4f} of device time)")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this test needs a card")
    sys.path.insert(0, HERE)
    try:
        import graphite_tpu_torch
    except ImportError as e:
        fail(f"the port's sources are not beside chip_smoke.py ({e})")
    check(os.path.dirname(os.path.dirname(os.path.abspath(
        graphite_tpu_torch.__file__))) == HERE,
        "graphite_tpu_torch was imported from outside this checkout")
    check("jax" not in sys.modules, "jax must not be imported")

    from graphite_tpu_torch import load_config
    from graphite_tpu_torch.engine import core as kcore
    from graphite_tpu_torch.engine import dense, noc_atac
    from graphite_tpu_torch.engine import resolve as kres
    from graphite_tpu_torch.engine.core import window_operands
    from graphite_tpu_torch.engine.kernels import build
    from graphite_tpu_torch.engine.kernels import chain as kchain
    from graphite_tpu_torch.engine.kernels.dispatch import (COUNTS,
                                                            reset_counts)
    from graphite_tpu_torch.engine.kernels.operands import (
        chain_step_in_from_numpy, ff_in_from_numpy, iocoom_window_arrays,
        random_chain_step_arrays, random_ff_arrays, random_window_arrays,
        seeded_window_arrays, spawn_window_arrays, window_in_from_numpy)
    from graphite_tpu_torch.engine.kernels import window as kwin
    from graphite_tpu_torch.engine.quantum import megarun, next_boundary
    from graphite_tpu_torch.engine.sim import Simulator, SimSummary
    from graphite_tpu_torch.engine.vparams import variant_params
    from graphite_tpu_torch.events import synth
    from graphite_tpu_torch.isa import EventOp
    from graphite_tpu_torch.params import SimParams

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()

    # ---- 1. the card
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, devices {count}")

    # ---- 2. build every kernel from this checkout
    t0 = time.perf_counter()
    info = build.build_all()
    stamp("phase 2: kernels built")
    print(f"build: {len(info)} source(s) in "
          f"{time.perf_counter() - t0:.3f} s")
    for name, rec in info.items():
        lines = [ln.strip() for ln in rec["ptxas"]
                 if "registers" in ln or "spill" in ln]
        for ln in lines:
            print(f"build: {name}: {ln}")
    # No kernel indexes a per-thread array at runtime: ptxas gives none of
    # them a stack (local memory) at all.
    for name in build.SOURCES:
        frames = [ln for ln in info[name]["ptxas"]
                  if "bytes stack frame" in ln]
        check(bool(frames) and all(
            ln.strip().startswith("0 bytes stack frame") for ln in frames),
            f"{name}: ptxas reports a stack frame: {frames}")

    # ---- 3. kernels vs plain forms on the card, at the main paths' shapes
    def config(**over):
        cfg = load_config()
        for k, v in over.items():
            cfg.set(k, v)
        return SimParams.from_config(cfg)

    params = config()                                  # default config
    cparams = config(**{"tpu/miss_chain": CHAIN})
    vp, cvp = variant_params(params), variant_params(cparams)
    T, K = params.num_tiles, params.block_events
    H = max(1024, 16 * T)
    trace = synth.gen_radix(64, keys_per_tile=FULL_KEYS, radix=256, seed=0)

    # window_walk, P = 0
    cases = [(f"random seed {seed}", window_in_from_numpy(
        random_window_arrays(params, K, seed), dev))
        for seed in range(8)]
    cases += [(f"seeded collisions seed {seed}", window_in_from_numpy(
        seeded_window_arrays(params, K, seed), dev)) for seed in range(4)]
    cap_sim = Simulator(params, trace, device=dev)
    cap_sim.run(max_steps=2)
    st = cap_sim.state._replace(boundary=next_boundary(params,
                                                       cap_sim.state))
    # The walk's operands alias the simulation's state, which phase 7
    # continues: keep a copy, which no launch touches (walk_pair and
    # walk_times launch on copies of it).
    _, captured = window_operands(params, st, cap_sim.trace)
    captured = clone_operands(captured)
    cases.append(("captured radix64 window", captured))
    err_w = 0
    for label, wi in cases:
        got, ref = walk_pair(kwin, params, vp, wi, T)
        torch.cuda.synchronize()
        err_w = max(err_w, compare("window_walk", got, ref, label))
    print(f"kernel window_walk P=0: {len(cases)} operand sets, every output "
          f"leaf equal to the plain form, the written leaves the operands' "
          f"own (max abs err {err_w})")

    def walk_line(label, p, v, wi, s_ids=T):
        ms, dev_ms, plain, ref = walk_times(kwin, p, v, wi, s_ids)
        moved = window_bytes(p, v, wi, ref)
        bound = moved / HBM_BYTES_PER_S * 1e3
        print(f"kernel window_walk {label}: {ms:.6f} ms/launch (wrapper), "
              f"device {fmt_ms(dev_ms)} per launch, plain {plain:.6f} ms, "
              f"bound {bound:.9f} ms ({moved} bytes the function reads and "
              f"writes on these operands, at "
              f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s), library call: none on "
              f"{card}")
        return ms, plain, bound

    ms0, _, _ = walk_line("K=16 P=0", params, vp, captured)
    stamp("phase 3: window_walk P=0")

    # Operands of the port's own radix64 chain-12 run: banking windows
    # (a pending bank, or elements banked by this window) and replay
    # iterations with at least one active head.
    csim = Simulator(cparams, trace, device=dev)
    def any_head(si):
        return bool(((~si.stopped) & (si.head < si.stop_hi)).any())

    with Recorder(kcore.kwindow, "run_window",
                  lambda wi: bool((wi.mq_count > wi.mq_head).any()), 6) \
            as rw, Recorder(kres.kchain, "run_chain_step", any_head, 24) \
            as rc:
        csim.run(max_steps=1)
    check(len(rw.seen) == 6 and len(rc.seen) == 24,
          f"captured {len(rw.seen)} banking windows and {len(rc.seen)} "
          f"replay iterations from the chain-12 run")

    # window_walk, P = 12
    cases = []
    for fan in (True, False):
        p = config(**{"tpu/miss_chain": CHAIN, "tpu/fanout_replay": fan})
        v = variant_params(p)
        for seed in range(4):
            cases.append((p, v, f"random fanout={fan} seed {seed}",
                          window_in_from_numpy(
                              random_window_arrays(p, K, seed), dev)))
        for seed in range(4):
            cases.append((p, v, f"seeded collisions fanout={fan} seed "
                                f"{seed}", window_in_from_numpy(
                                    seeded_window_arrays(p, K, seed), dev)))
    cases += [(cparams, cvp, f"captured radix64 chain-12 window {i}", wi)
              for i, wi in enumerate(rw.seen)]
    for p, v, label, wi in cases:
        got, ref = walk_pair(kwin, p, v, wi, T)
        torch.cuda.synchronize()
        err_w = max(err_w, compare("window_walk", got, ref, label))
    print(f"kernel window_walk P={CHAIN}: {len(cases)} operand sets, every "
          f"output leaf equal to the plain form, the written leaves the "
          f"operands' own (max abs err {err_w})")
    ms_w, plain_w, bound_w = walk_line(f"K=16 P={CHAIN}", cparams, cvp,
                                       rw.seen[-1])
    stamp("phase 3: window_walk P=12")

    # chain_classify: one replay iteration from the state's own arrays
    cases = []
    for fan in (True, False):
        for queue in (True, False):
            p = config(**{"tpu/miss_chain": CHAIN, "tpu/fanout_replay": fan,
                          "dram/queue_model/enabled": queue})
            v = variant_params(p)
            for h, seeds in ((H, range(3)), (1000, range(3, 4)),
                             (4, range(4, 6))):
                for seed in seeds:
                    cases.append((p, v, h, f"fanout={fan} queue={queue} "
                                           f"H={h} seed {seed}",
                                  chain_step_in_from_numpy(
                                      random_chain_step_arrays(p, h, seed),
                                      dev)))
    cases += [(cparams, cvp, H, f"captured radix64 chain-12 iteration {i}",
               si) for i, si in enumerate(rc.seen)]
    err_c = 0
    for p, v, h, label, si in cases:
        got, ref = step_pair(kchain, p, v, si, h)
        torch.cuda.synchronize()
        err_c = max(err_c, compare_step(got, ref, label))
    print(f"kernel chain_classify: {len(cases)} operand sets "
          f"({len(rc.seen)} captured), every ChainHead and ChainOut field "
          f"and the in-place floor table equal to the plain step (max abs "
          f"err {err_c})")
    si12 = rc.seen[0]
    ms_c = time_cuda(lambda: kchain.chain_step_cuda(cparams, cvp, si12, H),
                     iters=200, warmup=20)
    dev_c = device_ms(lambda: kchain.chain_step_cuda(cparams, cvp, si12, H),
                      "chain_classify_kernel")
    plain_c = time_cuda(lambda: kchain.chain_step(cparams, cvp, si12, H),
                        iters=20, warmup=3)
    # What the wrapper's host time is made of: carving the output views
    # from the one buffer, and the operand checks.
    step = kchain.chain_step_entry(cparams, cvp, H, si12.dir_sharers.shape[0]
                                   // cparams.directory.associativity)
    buf = torch.empty(step.layout.nbytes, dtype=torch.uint8, device=dev)
    n_views = sum(t is not None for nt in step.layout.carve(buf, None)
                  for t in nt)
    carve_ms = host_ms(lambda: step.layout.carve(buf, None))
    check_ms = host_ms(lambda: (step.bind_pass(si12), step.check(si12)))
    alloc_ms = host_ms(lambda: torch.empty(step.layout.nbytes,
                                           dtype=torch.uint8, device=dev))
    n_alloc = allocations(lambda: kchain.chain_step_cuda(cparams, cvp, si12,
                                                         H))
    check(n_alloc == 1, f"chain_classify: the wrapper makes {n_alloc} "
                        f"device allocations per call, not one")
    print(f"kernel chain_classify: one device allocation per call; "
          f"wrapper parts on the host, per call: "
          f"carving {n_views} output views {carve_ms:.6f} ms, the operand "
          f"checks {check_ms:.6f} ms, the one allocation {alloc_ms:.6f} ms")
    n_fold = device_kernels(lambda: kchain.chain_rows(
        si12.dir_word, si12.dir_sharers, kchain.chain_head(
            cparams, si12.mq_req, si12.mq_delta, si12.mq_extra, si12.head,
            si12.stopped, si12.stop_hi, si12.base, H).fidx))
    print(f"kernel chain_classify: the plain chain_head + chain_rows launch "
          f"{n_fold} device kernels on these operands (the gathers the "
          f"pass issued before its classify kernel until the step was "
          f"fused)")
    moved_c = chain_bytes(cparams, si12,
                          *kchain.chain_step(cparams, cvp, si12, H))
    bound_c = moved_c / HBM_BYTES_PER_S * 1e3
    print(f"kernel chain_classify: {ms_c:.6f} ms/launch (wrapper), device "
          f"{fmt_ms(dev_c)} per launch, plain {plain_c:.6f} ms, bound "
          f"{bound_c:.9f} ms ({moved_c} bytes the function reads and "
          f"writes on these operands, at {HBM_BYTES_PER_S / 1e12:.2f} "
          f"TB/s), library call: none on {card}")
    stamp("phase 3: chain_classify T=64")

    # fast_forward_walk at F = 64
    fparams = config(**{"tpu/fast_forward": FF,
                        "tpu/fast_forward_span": FF_SPAN_NS})
    fvp = variant_params(fparams)
    F = kcore._ff_width(fparams)
    check(F == 64, f"fast-forward width {F} != 64")
    cases = []
    for label, over in (
            ("span 1000", {}), ("span 0", {"tpu/fast_forward_span": 0}),
            ("no predictor", {"branch_predictor/type": "none"}),
            ("chain 12 span 300", {"tpu/miss_chain": CHAIN,
                                   "tpu/fast_forward_span": 300})):
        p = config(**{"tpu/fast_forward": FF,
                      "tpu/fast_forward_span": FF_SPAN_NS, **over})
        v = variant_params(p)
        for seed in range(8):
            cases.append((p, v, f"{label} seed {seed}", ff_in_from_numpy(
                random_ff_arrays(p, F, seed), dev)))
    # Operands of the port's own radix64 span-1000 run: analytic rounds
    # with engaging tiles, and wide windows the walk retires past one
    # narrow round's capacity.
    fsim = Simulator(fparams, trace, device=dev)
    with Recorder(kcore.kwindow, "run_fast_forward",
                  lambda fi: bool(kwin.ff_price(fparams, fvp, fi)
                                  .engage.any()), 6) as rff, \
            Recorder(kcore.kwindow, "run_window",
                     lambda wi: bool((kwin.window_walk(
                         fparams, fvp, wi, T).n_ret > K).any()), 4) as rww:
        for step in range(1, 17):
            if len(rff.seen) == 6 and len(rww.seen) == 4:
                break
            fsim.run(max_steps=step)
    check(len(rff.seen) >= 1 and len(rww.seen) >= 1,
          f"captured {len(rff.seen)} engaging analytic rounds and "
          f"{len(rww.seen)} wide windows from the radix64 span-1000 run")
    cases += [(fparams, fvp, f"captured radix64 analytic round {i}", fi)
              for i, fi in enumerate(rff.seen)]
    err_f, engaged_f = 0, 0
    for p, v, label, fi in cases:
        got, ref = ff_pair(kwin, p, v, fi)
        torch.cuda.synchronize()
        err_f = max(err_f, compare("fast_forward_walk", got, ref, label))
        engaged_f += int((ref.n_ret > 0).sum().item())
    check(engaged_f > 0, "no tile engaged in any fast_forward_walk set")
    print(f"kernel fast_forward_walk: {len(cases)} operand sets "
          f"({len(rff.seen)} captured), {engaged_f} engaged tiles, every "
          f"output field equal to the plain form, the written leaves the "
          f"operands' own (max abs err {err_f})")
    fi_cap = rff.seen[-1]
    ms_f, dev_f, plain_f = ff_times(kwin, fparams, fvp, fi_cap)
    # clock, n_ret and the counters: no clone of the state it updates
    n_alloc = allocations(lambda: kwin.fast_forward_walk_cuda(
        fparams, fvp, clone_operands(fi_cap)))
    n_clone = allocations(lambda: clone_operands(fi_cap))
    check(n_alloc - n_clone == 3,
          f"fast_forward_walk: the wrapper makes {n_alloc - n_clone} device "
          f"allocations per call, not 3 (its fresh outputs)")
    moved_f = ff_bytes(fparams, fvp, fi_cap)
    bound_f = moved_f / HBM_BYTES_PER_S * 1e3
    print(f"kernel fast_forward_walk: {ms_f:.6f} ms/launch (wrapper), "
          f"device {fmt_ms(dev_f)} per launch, plain "
          f"{plain_f:.6f} ms, bound {bound_f:.9f} ms "
          f"({moved_f} bytes the function reads and writes on these "
          f"operands, at {HBM_BYTES_PER_S / 1e12:.2f} TB/s), library call: "
          f"none on {card}")
    stamp("phase 3: fast_forward_walk")

    # window_walk at the wide width K = 64, P = 0 and P = 12
    fcparams = config(**{"tpu/fast_forward": FF,
                         "tpu/fast_forward_span": FF_SPAN_NS,
                         "tpu/miss_chain": CHAIN})
    fcvp = variant_params(fcparams)
    fft = synth.gen_fft(64, points_per_tile=64, writeback=True)
    fcsim = Simulator(fcparams, fft, device=dev)
    # Wide rounds fill the bank in one round (cap_w = 1), so a wide
    # window starts on an empty bank: keep windows that bank elements.
    with Recorder(kcore.kwindow, "run_window",
                  lambda wi: bool((kwin.window_walk(
                      fcparams, fcvp, wi, T).mq_count > wi.mq_count).any()),
                  4) as rwc:
        for step in range(1, 17):
            if len(rwc.seen) == 4:
                break
            fcsim.run(max_steps=step)
    check(len(rwc.seen) >= 1, "captured no wide banking window from the "
                              "fft64 chain-12 fast-forward run")
    cases = []
    for label, over in (("P=0", {}), ("P=12", {"tpu/miss_chain": CHAIN}),
                        ("P=12 no fan-out", {"tpu/miss_chain": CHAIN,
                                             "tpu/fanout_replay": False})):
        p = config(**{"tpu/fast_forward": FF, **over})
        v = variant_params(p)
        for gen in (random_window_arrays, seeded_window_arrays):
            for seed in range(3):
                cases.append((p, v, f"K=64 {label} {gen.__name__} seed "
                                    f"{seed}", window_in_from_numpy(
                                        gen(p, F, seed), dev)))
    cases += [(fparams, fvp, f"captured radix64 wide window {i}", wi)
              for i, wi in enumerate(rww.seen)]
    cases += [(fcparams, fcvp, f"captured fft64 wide banking window {i}", wi)
              for i, wi in enumerate(rwc.seen)]
    for p, v, label, wi in cases:
        check(wi.addr.shape[1] == 64, f"{label}: K != 64")
        got, ref = walk_pair(kwin, p, v, wi, T)
        torch.cuda.synchronize()
        err_w = max(err_w, compare("window_walk", got, ref, label))
    print(f"kernel window_walk K=64: {len(cases)} operand sets, every output "
          f"leaf equal to the plain form, the written leaves the operands' "
          f"own (max abs err {err_w})")
    walk_line("K=64 P=0", fparams, fvp, rww.seen[-1])
    walk_line(f"K=64 P={CHAIN}", fcparams, fcvp, rwc.seen[-1])
    stamp("phase 3: window_walk K=64")
    # The other fast-forward simulation and the recorded operands are done
    # with; phase 7 continues cap_sim, csim and fsim.
    del fcsim, rff, rww, rwc, cases, fi_cap, wi, got, ref

    # ---- both kernels at one-card scale, T = 1024
    T1k = 1024
    sparams = config(**{"general/total_cores": T1k,
                        "tpu/block_events": SCALE_K})
    svp = variant_params(sparams)
    trace1k = synth.gen_radix(T1k, keys_per_tile=16, radix=64, seed=0)
    # window_walk at K = 4, as radix1024 runs it (a grid of 1,024 blocks,
    # 16x radix64's): random and seeded collision operands, and a window
    # captured from the port's own radix1024 run, whose simulation phase
    # 9's profiled stretch continues.
    s1k = Simulator(sparams, trace1k, device=dev)
    s1k.run(max_steps=1)
    st = s1k.state._replace(boundary=next_boundary(sparams, s1k.state))
    _, cap1k = window_operands(sparams, st, s1k.trace)
    cap1k = clone_operands(cap1k)
    del st
    cases = [(f"T=1024 {gen.__name__} seed {seed}", window_in_from_numpy(
        gen(sparams, SCALE_K, seed), dev))
        for gen in (random_window_arrays, seeded_window_arrays)
        for seed in range(2)]
    cases.append(("captured radix1024 window", cap1k))
    err_w1k = 0
    for label, wi in cases:
        got, ref = walk_pair(kwin, sparams, svp, wi, T1k)
        torch.cuda.synchronize()
        err_w1k = max(err_w1k, compare("window_walk", got, ref, label))
    err_w = max(err_w, err_w1k)
    print(f"kernel window_walk T=1024 K={SCALE_K}: {len(cases)} operand "
          f"sets, every output leaf equal to the plain form, the written "
          f"leaves the operands' own (max abs err {err_w1k})")
    walk_line(f"T=1024 K={SCALE_K} P=0", sparams, svp, cap1k, T1k)
    stamp("phase 3: window_walk T=1024")

    # chain_classify's wide form at T = 1024 (16 ways, 16 sharer words,
    # H = 16,384: the tables in its workspace, the directory rows read
    # where they lie): state-level seeded sets on a directory of 16 sets
    # per home (every case of the step, a fan-out whose sharers cross
    # word 8 among them), and iterations captured at run_chain_step's
    # inputs in the port's own radix1024 chain-12 run.
    cases = []
    for fan in (True, False):
        for queue in (True, False):
            p = config(**{"general/total_cores": T1k,
                          "tpu/miss_chain": CHAIN,
                          "tpu/fanout_replay": fan,
                          "dram/queue_model/enabled": queue,
                          "dram_directory/total_entries": 256})
            v = variant_params(p)
            for h, seeds in ((SCALE_H, range(2)), (1000, range(2, 3)),
                             (4, range(3, 4))):
                for seed in seeds:
                    cases.append((p, v, h, f"T=1024 fanout={fan} "
                                           f"queue={queue} H={h} seed {seed}",
                                  chain_step_in_from_numpy(
                                      random_chain_step_arrays(p, h, seed),
                                      dev)))
    scparams = config(**{"general/total_cores": T1k,
                         "tpu/block_events": SCALE_K,
                         "tpu/miss_chain": CHAIN})
    scvp = variant_params(scparams)
    s1kc = Simulator(scparams, trace1k, device=dev)
    with Recorder(kres.kchain, "run_chain_step", any_head, 3) as rc1k:
        s1kc.state = megarun(scparams, s1kc.state, s1kc.trace, 1,
                             vp=s1kc.vp)
    del s1kc
    check(len(rc1k.seen) == 3,
          f"captured {len(rc1k.seen)} replay iterations from the radix1024 "
          f"chain-12 run, want 3")
    cases += [(scparams, scvp, SCALE_H,
               f"captured radix1024 chain-12 iteration {i}", si)
              for i, si in enumerate(rc1k.seen)]
    err_c1k, past8 = 0, 0
    for p, v, h, label, si in cases:
        A = p.directory.associativity
        check(kchain.chain_step_entry(p, v, h, si.dir_sharers.shape[0] // A)
              .form == kchain.WIDE,
              f"chain_classify {label}: not the wide form")
        got, ref = step_pair(kchain, p, v, si, h)
        torch.cuda.synchronize()
        err_c1k = max(err_c1k, compare_step(got, ref, label))
        ib = ref[1].inv_bool
        if ib is not None:
            past8 += int((ib[:, :512].any(1) & ib[:, 512:].any(1)).sum())
    err_c = max(err_c, err_c1k)
    check(past8 > 0, "chain_classify T=1024: no fan-out whose sharers "
                     "cross sharer word 8")
    step1k = kchain.chain_step_entry(scparams, scvp, SCALE_H, 16)
    print(f"kernel chain_classify T=1024 (wide form: {step1k.smem} B of "
          f"shared memory, a {step1k.ws_bytes} B workspace): {len(cases)} "
          f"operand sets ({len(rc1k.seen)} captured, {past8} fan-outs "
          f"across sharer word 8), every ChainHead and ChainOut field and "
          f"the in-place floor table equal to the plain step (max abs err "
          f"{err_c1k})")
    si1k = rc1k.seen[0]
    ms_c1k = time_cuda(lambda: kchain.chain_step_cuda(scparams, scvp, si1k,
                                                      SCALE_H),
                       iters=100, warmup=10)
    dev_c1k = device_ms(lambda: kchain.chain_step_cuda(scparams, scvp, si1k,
                                                       SCALE_H),
                        "chain_classify_kernel")
    plain_c1k = time_cuda(lambda: kchain.chain_step(scparams, scvp, si1k,
                                                    SCALE_H),
                          iters=5, warmup=1)
    moved_c1k = chain_bytes(scparams, si1k, *kchain.chain_step(
        scparams, scvp, si1k, SCALE_H))
    print(f"kernel chain_classify T=1024 (wide form): {ms_c1k:.6f} "
          f"ms/launch (wrapper), device {fmt_ms(dev_c1k)} per launch, plain "
          f"{plain_c1k:.6f} ms, bound "
          f"{moved_c1k / HBM_BYTES_PER_S * 1e3:.9f} ms ({moved_c1k} bytes "
          f"the function reads and writes on these operands, at "
          f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s), library call: none on "
          f"{card}")
    del rc1k, cases, si1k, si, got, ref, cap1k, wi
    stamp("phase 3: one-card scale")

    # ---- the coherence protocols: every kernel's protocol branches, on
    # eight seeded sets per protocol and kernel (phase 10 adds operands
    # captured from each protocol path)
    for proto in PROTOCOLS:
        short = proto.replace("pr_l1_pr_l2_dram_directory_", "").replace(
            "pr_l1_", "")
        # window_walk: K = 16 and 64, P = 0 and 12, random and seeded
        nw = 0
        for P in (0, CHAIN):
            p = config(**{"caching_protocol/type": proto,
                          "tpu/miss_chain": P})
            v = variant_params(p)
            for Kw in (K, 64):
                for gen in (random_window_arrays, seeded_window_arrays):
                    for seed in (nw % 4,):
                        wi = window_in_from_numpy(gen(p, Kw, seed), dev)
                        check((wi.l2_word is None) == p.shared_l2,
                              f"{short}: L2 operands present under "
                              f"{proto}")
                        got, ref = walk_pair(kwin, p, v, wi, T)
                        torch.cuda.synchronize()
                        err_w = max(err_w, compare(
                            "window_walk", got, ref, f"{short} P={P} "
                            f"K={Kw} {gen.__name__} seed {seed}"))
                        nw += 1
        # chain_classify: every configuration, the controllers on every
        # tile (H = 1024) and on a quarter of them (a colliding H = 4)
        nc, legs = 0, 0
        for fan in (True, False):
            for queue in (True, False):
                for ctrl in ("ALL", T // 4):
                    p = config(**{"caching_protocol/type": proto,
                                  "tpu/miss_chain": CHAIN,
                                  "tpu/fanout_replay": fan,
                                  "dram/queue_model/enabled": queue,
                                  "dram/num_controllers": ctrl})
                    v = variant_params(p)
                    for h, seed in ((H if ctrl == "ALL" else 4, nc),):
                        si = chain_step_in_from_numpy(
                            random_chain_step_arrays(p, h, seed), dev)
                        got, ref = step_pair(kchain, p, v, si, h)
                        torch.cuda.synchronize()
                        err_c = max(err_c, compare_step(
                            got, ref, f"{short} fanout={fan} queue={queue} "
                            f"ctrl={ctrl} H={h} seed {seed}"))
                        legs += int((ref[1].need_read
                                     & (ref[1].from_dram_ps > 0)).sum())
                        nc += 1
        check((legs > 0) == (proto != MOSI),
              f"{short}: {legs} DRAM reads from another slice's controller")
        print(f"kernel window_walk {short}: {nw} operand sets, every output "
              f"leaf equal to the plain form (max abs err {err_w}); kernel "
              f"chain_classify {short}: {nc} operand sets ({legs} slice "
              f"misses whose controller is another tile), every ChainHead "
              f"and ChainOut field equal to the plain step (max abs err "
              f"{err_c})")
    # chain_classify's wide form at T = 1024 under shared-L2 MESI (32-set
    # slices of 8 ways, 16 sharer words)
    nc = 0
    for fan in (True, False):
        for queue in (True, False):
            p = config(**{"general/total_cores": T1k,
                          "caching_protocol/type": SH_MESI,
                          "tpu/miss_chain": CHAIN, "tpu/fanout_replay": fan,
                          "dram/queue_model/enabled": queue,
                          "dram/num_controllers": 64,
                          "l2_cache/T1/cache_size": 16})
            v = variant_params(p)
            for h in ((SCALE_H,) if fan else (4,)):
                check(kchain.chain_step_entry(p, v, h, 16).form
                      == kchain.WIDE,
                      "chain_classify T=1024 shared-L2 MESI: not the wide "
                      "form")
                si = chain_step_in_from_numpy(
                    random_chain_step_arrays(p, h, nc), dev)
                got, ref = step_pair(kchain, p, v, si, h)
                torch.cuda.synchronize()
                err_c = max(err_c, compare_step(
                    got, ref, f"T=1024 sh_l2_mesi fanout={fan} "
                              f"queue={queue} H={h}"))
                nc += 1
    print(f"kernel chain_classify T=1024 sh_l2_mesi (wide form): {nc} "
          f"operand sets, every field equal to the plain step (max abs err "
          f"{err_c})")
    # fast_forward_walk under shared-L2 MESI (the sticky E->M upgrade)
    nf = upg = 0
    fi_best, eng_best = None, -1      # the set with the most engaged tiles
    for label, over in (("span 1000", {}),
                        ("chain 12 span 300", {"tpu/miss_chain": CHAIN,
                                               "tpu/fast_forward_span": 300})):
        p = config(**{**SHL2_MESI_FF, "tpu/miss_chain": 0, **over})
        v = variant_params(p)
        for seed in range(8):
            fi = ff_in_from_numpy(random_ff_arrays(p, F, seed), dev)
            fp = kwin.ff_price(p, v, fi)
            upg += int((fp.commit0 & fp.engage[:, None] & fp.is_wr
                        & (fp.pD.state == 3)).sum())
            if label == "span 1000" and int(fp.engage.sum()) > eng_best:
                fi_best, eng_best = clone_operands(fi), int(fp.engage.sum())
            got, ref = ff_pair(kwin, p, v, fi)
            torch.cuda.synchronize()
            err_f = max(err_f, compare("fast_forward_walk", got, ref,
                                       f"sh_l2_mesi {label} seed {seed}"))
            nf += 1
    check(upg > 0, "fast_forward_walk sh_l2_mesi: no committed write to an "
                   "E line")
    print(f"kernel fast_forward_walk sh_l2_mesi: {nf} operand sets ({upg} "
          f"committed writes to E lines), every output field equal to the "
          f"plain form (max abs err {err_f})")
    stamp("phase 3: protocol operand sets")

    ff_seeded = (config(**{**SHL2_MESI_FF, "tpu/miss_chain": 0}), fi_best)
    del got, ref, si, wi, fi_best

    # ---- window_walk's iocoom branches: seeded sets under a uniform
    # model list and mixed ones in both orders (the first and last tiles
    # differ), speculative loads on and off, P = 0 and 12, with
    # register-annotated events and queue completions above the clock;
    # then windows captured from the port's own scoreboard64 run (one-
    # entry queues), one of them timed beside phase 3's simple K = 16,
    # P = 0 window.
    n_ioc = 0
    for label, over in IOCOOM_WALK_SETS:
        for P in (0, CHAIN):
            p = config(**over, **{"tpu/miss_chain": P})
            v = variant_params(p)
            for seed in range(4):
                wi = window_in_from_numpy(iocoom_window_arrays(p, K, seed),
                                          dev)
                got, ref = walk_pair(kwin, p, v, wi, T)
                torch.cuda.synchronize()
                err_w = max(err_w, compare(
                    "window_walk", got, ref,
                    f"iocoom {label} P={P} seed {seed}"))
                n_ioc += 1
    pins16 = json.load(open(os.path.join(HERE, "tests", "data",
                                         "card_pins_ioc_mt.json")))
    sb = pins16["scoreboard64"]
    sb_params = config(**sb["over"])
    sb_vp = variant_params(sb_params)
    sb_sim = Simulator(sb_params, getattr(synth, sb["trace"][0])(
        **sb["trace"][1]), device=dev)

    def late_drain(wi):
        late = torch.maximum(wi.lq_ready.amax(0), wi.sq_ready.amax(0)) \
            > wi.clock
        return bool((late & wi.tile_active).any())

    with Recorder(kcore.kwindow, "run_window", late_drain, 4) as rw:
        sb_sim.run(max_steps=2)
    check(len(rw.seen) == 4, f"captured {len(rw.seen)} scoreboard64 "
                             f"windows with queues completing late")
    for i, wi in enumerate(rw.seen):
        got, ref = walk_pair(kwin, sb_params, sb_vp, wi, T)
        torch.cuda.synchronize()
        err_w = max(err_w, compare("window_walk", got, ref,
                                   f"captured scoreboard64 window {i}"))
        n_ioc += 1
    print(f"kernel window_walk iocoom: {n_ioc} operand sets, every output "
          f"leaf equal to the plain form, the written leaves the operands' "
          f"own (max abs err {err_w})")
    ms_ioc, plain_ioc, _ = walk_line("K=16 P=0 iocoom flags on", sb_params,
                                     sb_vp, rw.seen[-1])
    print(f"kernel window_walk iocoom flags on {ms_ioc:.6f} ms/launch "
          f"(wrapper) against flags off {ms0:.6f} ms (phase 3's K=16 P=0 "
          f"window) on {card}")
    del sb_sim, rw, got, ref, wi
    stamp("phase 3: window_walk iocoom")

    stamp("phase 3: kernels held against their plain forms")

    def round_ctrs(st):
        return {f: int(getattr(st, f).item()) for f in (
            "ctr_quantum", "ctr_window", "ctr_complex", "ctr_conflict",
            "ctr_resolve", "round_ctr", "ctr_ff", "ctr_ffq", "ff_events")}

    def advance(sim, quanta=None):
        """Run ``sim`` to its end, or (a cut run) for ``quanta`` quanta;
        returns its summary and the wall seconds."""
        t0 = time.perf_counter()
        if quanta is None:
            s = sim.run()
        else:
            sim.state = megarun(sim.params, sim.state, sim.trace, quanta,
                                vp=sim.vp)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if quanta is not None:
            s = SimSummary(sim.params, sim.state, wall, 0)
        return s, wall

    def end_word(quanta):
        return "all_done" if quanta is None else f"cut at {quanta} quanta"

    def check_end(label, sim, s, want_ps, cut=None):
        """A whole run: every stream done, the completion; a cut run
        (``cut``): the latest clock (its completion so far), the clocks'
        sum and the trace cursors' sum, the JAX package's after as many
        quanta."""
        check(s.completion_time_ps == want_ps,
              f"{label}: completion {s.completion_time_ps} != {want_ps}")
        if cut is None:
            check(bool(s.done.all()), f"{label}: not all done")
            return
        got = dict(clock_sum=int(sim.state.clock.sum().item()),
                   cursor_sum=int(sim.state.cursor.to(torch.int64).sum()
                                  .item()))
        for k, v in cut.items():
            check(got[k] == v, f"{label}: {k} {got[k]} != {v}")

    # The depth cuts of phases 5, 6 and 10 to 13, each held to the JAX
    # package leaf by leaf (tests/record_card_pins.py); their whole runs
    # are held on the card by tests/test_torch_card_paths.py.
    from graphite_tpu_torch import convert
    cuts = json.load(open(os.path.join(HERE, "tests", "data",
                                       "card_pins_cuts.json")))

    def held_to_cut(label, sim, s, pin):
        """A cut run at its pin: the latest clock, the clocks' and
        cursors' sums, the round counters, every counter's sum and every
        SimState leaf (by digest) the JAX package's after as many
        quanta."""
        want = pin["cut"]
        check_end(label, sim, s, want["completion_ps"],
                  dict(clock_sum=want["clock_sum"],
                       cursor_sum=want["cursor_sum"]))
        c = round_ctrs(sim.state)
        for k, v in want["ctrs"].items():
            check(c[k] == v, f"{label}: {k} {c[k]} != {v}")
        for k, v in want["sums"].items():
            got = int(s.counters[k].sum())
            check(got == v, f"{label}: sum of {k} {got} != {v}")
        leaves = convert.state_to_numpy(sim.state)
        bad = sorted(k for k in set(leaves) | set(want["leaves"])
                     if k not in leaves or k not in want["leaves"]
                     or leaf_digest(leaves[k]) != want["leaves"][k])
        check(not bad, f"{label}: leaves differ from the JAX package's: "
                       f"{bad}")

    # ---- 4. golden shapes, exactly
    gold = json.load(open(os.path.join(HERE, "tests", "data",
                                       "chain_off_golden.json")))
    for name, gtrace in (
            ("radix8", synth.gen_radix(num_tiles=8, keys_per_tile=64,
                                       radix=16, seed=3)),
            ("fft8", synth.gen_fft(num_tiles=8, points_per_tile=64))):
        sim = Simulator(config(**{"general/total_cores": 8,
                                  "tpu/miss_chain": 0}), gtrace, device=dev)
        reset_counts()
        s = sim.run(max_steps=256)
        g = gold[name]
        check(bool(s.done.all()), f"{name}: not all done")
        check(s.completion_time_ps == g["completion_time_ps"],
              f"{name}: completion {s.completion_time_ps} != "
              f"{g['completion_time_ps']}")
        check(s.clock.tolist() == g["clock"], f"{name}: clocks differ")
        for f, want in g["round_ctrs"].items():
            got = int(getattr(sim.state, f).item())
            check(got == want, f"{name}.{f}: {got} != golden {want}")
        for k, want in g["counters"].items():
            check(s.counters[k].tolist() == want, f"{name}.{k} differs")
        check(COUNTS["window_walk"] == int(sim.state.ctr_window.item()),
              f"{name}: kernel launches != ctr_window")
        print(f"golden {name}: exact (round_ctr "
              f"{int(sim.state.round_ctr.item())}, completion "
              f"{s.completion_time_ps} ps, {COUNTS['window_walk']} "
              f"kernel launches)")
    sim = Simulator(config(**{"general/total_cores": 8,
                              "tpu/miss_chain": CHAIN}),
                    synth.gen_radix(num_tiles=8, keys_per_tile=64, radix=16,
                                    seed=3), device=dev)
    reset_counts()
    s = sim.run(max_steps=256)
    c8 = round_ctrs(sim.state)
    passes8 = c8["round_ctr"] - c8["ctr_window"] - c8["ctr_complex"] \
        - c8["ctr_conflict"]
    check(bool(s.done.all()), "radix8 chain 12: not all done")
    check(c8["round_ctr"] == RADIX8_CHAIN_ROUND_CTR
          and s.completion_time_ps == RADIX8_CHAIN_COMPLETION_PS,
          f"radix8 chain 12: round_ctr {c8['round_ctr']}, completion "
          f"{s.completion_time_ps} != {RADIX8_CHAIN_ROUND_CTR}, "
          f"{RADIX8_CHAIN_COMPLETION_PS}")
    check(COUNTS["chain_classify"] == CHAIN * passes8
          and COUNTS["window_walk"] == c8["ctr_window"],
          "radix8 chain 12: kernel launches do not match the round counts")
    print(f"radix8 chain 12: exact (round_ctr {c8['round_ctr']}, completion "
          f"{s.completion_time_ps} ps, {passes8} chain passes, "
          f"chain_classify launches {COUNTS['chain_classify']}, "
          f"window_walk launches {COUNTS['window_walk']})")

    stamp("phase 4: golden shapes")

    # ---- 5. the chain-off main path at full width (cut depth)
    cut_trace = synth.gen_radix(64, keys_per_tile=CUT_KEYS, radix=256,
                                seed=0)
    held = peak_reset()
    sim = Simulator(params, cut_trace, device=dev)
    reset_counts()
    pin = cuts["radix64_cut"]
    s, wall = advance(sim, pin["quanta"])
    launches0 = COUNTS["window_walk"]
    ctr = round_ctrs(sim.state)
    rounds = ctr["round_ctr"]
    held_to_cut("radix64", sim, s, pin)
    check(launches0 == ctr["ctr_window"] and launches0 > 0,
          f"radix64: kernel launches {launches0} != ctr_window "
          f"{ctr['ctr_window']}")
    check(COUNTS["chain_classify"] == 0, "radix64: chain kernel launched")
    mips = s.total_instructions / wall / 1e6
    print(f"radix64 keys_per_tile={CUT_KEYS}: cut at {pin['quanta']} "
          f"quanta, every leaf the JAX package's, round_ctr "
          f"{rounds}, latest clock {s.completion_time_ps / 1000:.1f} ns, "
          f"{s.total_instructions} instructions; counters {ctr}")
    print(f"radix64: wall {wall:.3f} s, {rounds / wall:.2f} rounds/s, "
          f"{1e3 * wall / rounds:.4f} ms/round, simulated MIPS {mips:.6f}, "
          f"{peak_line(held)}, "
          f"window_walk launches {launches0}, "
          f"kernel share {launches0 * ms0 / 1e3 / wall:.4f} of wall "
          f"(launches x {ms0:.6f} ms) on {card}")
    wall_ms0 = 1e3 * wall / rounds

    stamp("phase 5: chain-off radix64")

    # ---- 6. the chain-replay paths at full width
    def chain_run(label, ctrace, want_rounds, want_ps, rec=None, pin=None):
        """A whole chain-12 run at its pinned rounds and completion, or
        (``pin``) a cut run held to its pin."""
        held = peak_reset()
        sim = Simulator(cparams, ctrace, device=dev)
        reset_counts()
        with rec or contextlib.nullcontext():
            s, wall = advance(sim, pin and pin["quanta"])
        lw, lc = COUNTS["window_walk"], COUNTS["chain_classify"]
        c = round_ctrs(sim.state)
        r = c["round_ctr"]
        passes = r - c["ctr_window"] - c["ctr_complex"] - c["ctr_conflict"]
        if pin is None:
            check(bool(s.done.all()), f"{label}: not all done")
            check(r == want_rounds,
                  f"{label}: round_ctr {r} != {want_rounds}")
            check(s.completion_time_ps == want_ps,
                  f"{label}: completion {s.completion_time_ps} != "
                  f"{want_ps}")
        else:
            held_to_cut(label, sim, s, pin)
        check(lw == c["ctr_window"] and lw > 0,
              f"{label}: window_walk launches {lw} != ctr_window "
              f"{c['ctr_window']}")
        check(lc == CHAIN * passes and lc > 0,
              f"{label}: chain_classify launches {lc} != {CHAIN} x "
              f"{passes} chain passes")
        fan = int(s.counters["chain_fanout_served"].sum())
        fb = int(s.counters["chain_fallback"].sum())
        mips = s.total_instructions / wall / 1e6
        print(f"{label}: {end_word(pin and pin['quanta'])}, round_ctr {r}, "
              f"completion {s.completion_time_ps / 1000:.1f} ns, "
              f"{s.total_instructions} instructions, chain_fanout_served "
              f"{fan}, chain_fallback {fb}; counters {c}, chain passes "
              f"{passes}")
        print(f"{label}: wall {wall:.3f} s, {r / wall:.2f} rounds/s, "
              f"{1e3 * wall / r:.4f} ms/round, simulated MIPS {mips:.6f}, "
              f"{peak_line(held)}, "
              f"window_walk launches {lw}, chain_classify launches {lc}, "
              f"kernel share {(lw * ms_w + lc * ms_c) / 1e3 / wall:.4f} of "
              f"wall on {card}")
        return lw, lc, fan, fb, 1e3 * wall / r

    lw12, lc12, _, _, wall_ms12 = chain_run(
        f"radix64_chain12 keys_per_tile={CUT_KEYS}", cut_trace, None, None,
        pin=cuts["radix64_chain12_cut"])
    # The radix run serves no fan-out, so phase 3's captured iterations
    # leave the fan-out rank, the [KF, T] invalidation masks and the
    # max-hop legs to the seeded operands: the fft64 run records its
    # first iterations that serve a fan-out (the kernel's own result
    # says), and the kernel is held against the plain form on each.
    rf = Recorder(kres.kchain, "run_chain_step",
                  lambda out: bool(out[1].fan_go.any()), FFT_CAPTURED,
                  after=True)
    _, _, fan, fb, _ = chain_run("fft64", fft, FFT_ROUND_CTR,
                                 FFT_COMPLETION_PS, rec=rf)
    check(fan == FFT_FANOUT_SERVED and fb == FFT_FALLBACK,
          f"fft64: chain_fanout_served {fan} / chain_fallback {fb} != "
          f"{FFT_FANOUT_SERVED} / {FFT_FALLBACK}")
    check(len(rf.seen) == FFT_CAPTURED,
          f"fft64: captured {len(rf.seen)} fan-out iterations, want "
          f"{FFT_CAPTURED}")
    served = 0
    for i, si in enumerate(rf.seen):
        got, ref = step_pair(kchain, cparams, cvp, si, H)
        torch.cuda.synchronize()
        err_c = max(err_c, compare_step(
            got, ref, f"captured fft64 fan-out iteration {i}"))
        served += int(ref[1].fan_go.sum().item())
    sif = rf.seen[0]
    dev_cf = device_ms(lambda: kchain.chain_step_cuda(cparams, cvp, sif, H),
                       "chain_classify_kernel")
    print(f"kernel chain_classify: {len(rf.seen)} fft64 iterations with "
          f"{served} fan-outs served, every output field equal to the plain "
          f"form (max abs err {err_c}); device {fmt_ms(dev_cf)} per launch "
          f"on the first (fan-out rank, masks and their barrier live) on "
          f"{card}")

    stamp("phase 6: chain-12 radix64 and fft64")

    # ---- 7. where the time goes: profiled stretches of both radix64 runs
    # The stretches continue phase 3's two simulations, which are 16
    # (chain-off) and 8 (chain-12) quanta past their start.  They are
    # short: the profiler's own cost grows with the events it records,
    # and a chain-12 round issues about ten times the host ops of a
    # chain-off round.
    profile_stretch(cap_sim, wall_ms0, card, "radix64", ["window_walk"],
                    quanta=2)
    stamp("phase 7: chain-off stretch profiled")
    profile_stretch(csim, wall_ms12, card, "radix64_chain12",
                    ["window_walk", "chain_classify"], subrounds=2, top=5)
    stamp("phase 7: chain-12 stretch profiled")

    # ---- 8. the fast-forward paths at full width
    def ff_run(label, p, ctrace, want, want_ps, quanta=None, cut=None):
        held = peak_reset()
        sim = Simulator(p, ctrace, device=dev)
        reset_counts()
        s, wall = advance(sim, quanta)
        lw, lc = COUNTS["window_walk"], COUNTS["chain_classify"]
        lf = COUNTS["fast_forward_walk"]
        engaged = COUNTS["ff_engaged"]
        c = round_ctrs(sim.state)
        r = c["round_ctr"]
        # Every engine round is a window round, a complex slot, a conflict
        # round, a chain pass (one per resolve pass at P > 0) or an
        # analytic round in which some tile engaged.
        passes = r - c["ctr_window"] - c["ctr_complex"] - c["ctr_conflict"] \
            - engaged
        check_end(label, sim, s, want_ps, cut)
        for k, v in want.items():
            check(c[k] == v, f"{label}: {k} {c[k]} != {v}")
        check(lw == c["ctr_window"] and lw > 0,
              f"{label}: window_walk launches {lw} != ctr_window "
              f"{c['ctr_window']}")
        check(lf >= engaged, f"{label}: fast_forward_walk launches {lf} < "
                             f"{engaged} engaged analytic rounds")
        check(passes == (c["ctr_resolve"] if p.miss_chain else 0),
              f"{label}: {passes} chain passes from the round identity, "
              f"ctr_resolve {c['ctr_resolve']}")
        check(lc == p.miss_chain * passes,
              f"{label}: chain_classify launches {lc} != {p.miss_chain} x "
              f"{passes} chain passes")
        fan = int(s.counters["chain_fanout_served"].sum())
        fb = int(s.counters["chain_fallback"].sum())
        mips = s.total_instructions / wall / 1e6
        print(f"{label}: {end_word(quanta)}, round_ctr {r}, completion "
              f"{s.completion_time_ps / 1000:.1f} ns, {s.total_instructions} "
              f"instructions, chain_fanout_served {fan}, chain_fallback "
              f"{fb}; counters {c}, analytic rounds that engaged {engaged}, "
              f"chain passes {passes}")
        print(f"{label}: wall {wall:.3f} s, {r / wall:.2f} rounds/s, "
              f"{1e3 * wall / r:.4f} ms/round, simulated MIPS {mips:.6f}, "
              f"{peak_line(held)}, "
              f"window_walk launches {lw}, chain_classify launches {lc}, "
              f"fast_forward_walk launches {lf} on {card}")
        return s, lf, lc, fan, fb, 1e3 * wall / r

    s, lf_span, lc_f, _, _, wall_ms_ff = ff_run(
        f"radix64_ff_span keys_per_tile={CUT_KEYS}", fparams, cut_trace,
        FF_SPAN_CTRS, FF_SPAN_COMPLETION_PS, quanta=FF_SPAN_QUANTA,
        cut=FF_SPAN_CUT)
    check(lf_span > 0 and lc_f == 0,
          f"radix64_ff_span: fast_forward_walk launches {lf_span}, "
          f"chain_classify launches {lc_f}")
    check(s.total_instructions == FF_SPAN_ICOUNT,
          f"radix64_ff_span: icount {s.total_instructions} != "
          f"{FF_SPAN_ICOUNT}")
    stamp("phase 8: radix64_ff_span")
    # Phase 7's fast-forward stretch, held against the run just made.
    profile_stretch(fsim, wall_ms_ff, card, "radix64_ff_span",
                    ["window_walk", "fast_forward_walk"], quanta=2)
    del fsim
    stamp("phase 7: fast-forward stretch profiled")
    _, lf, lc, fan, fb, _ = ff_run("fft64_ff_span", fcparams, fft,
                                FFT_FF_SPAN_CTRS, FFT_FF_SPAN_COMPLETION_PS,
                                quanta=FFT_FF_QUANTA, cut=FFT_FF_CUT)
    check(lf > 0 and lc > 0 and fan == FFT_FF_FANOUT_SERVED
          and fb == FFT_FF_SPAN_FALLBACK,
          f"fft64_ff_span: fast_forward_walk launches {lf}, chain_classify "
          f"launches {lc}, chain_fanout_served {fan} / chain_fallback {fb} "
          f"!= {FFT_FF_FANOUT_SERVED} / {FFT_FF_SPAN_FALLBACK}")
    stamp("phase 8: fft64_ff_span")
    s, lf, lc, fan, fb, _ = ff_run(
        "fft64_ff", config(**{"tpu/fast_forward": FF,
                              "tpu/miss_chain": CHAIN}),
        fft, FFT_FF_CTRS, FFT_FF_COMPLETION_PS, quanta=FFT_FF_QUANTA,
        cut=FFT_FF_CUT)
    check(lf == 0 and lc > 0 and fan == FFT_FF_FANOUT_SERVED
          and fb == FFT_FF_FALLBACK,
          f"fft64_ff: fast_forward_walk launches {lf} (the leg is dormant at "
          f"span 0), chain_fanout_served {fan} / chain_fallback {fb} != "
          f"{FFT_FF_FANOUT_SERVED} / {FFT_FF_FALLBACK}")
    check(s.to_dict()["ff_rounds"] == FFT_FF_CTRS["ctr_ff"],
          "fft64_ff: summary ff_rounds")
    stamp("phase 8: fft64_ff")

    # ---- 9. one-card scale at full width
    def scale_run(label, p, ctrace, want, want_ps, want_icount,
                  quanta=None, cut=None):
        held = peak_reset()
        sim = Simulator(p, ctrace, device=dev)
        reset_counts()
        s, wall = advance(sim, quanta)
        lw, lc = COUNTS["window_walk"], COUNTS["chain_classify"]
        c = round_ctrs(sim.state)
        r = c["round_ctr"]
        check_end(label, sim, s, want_ps, cut)
        for k, v in want.items():
            check(c[k] == v, f"{label}: {k} {c[k]} != {v}")
        check(s.total_instructions == want_icount,
              f"{label}: icount {s.total_instructions} != {want_icount}")
        check(lw == c["ctr_window"] and lw > 0,
              f"{label}: window_walk launches {lw} != ctr_window "
              f"{c['ctr_window']}")
        check(lc == p.miss_chain * c["ctr_resolve"],
              f"{label}: chain_classify launches {lc} != {p.miss_chain} x "
              f"{c['ctr_resolve']} chain passes")
        check(COUNTS["fast_forward_walk"] == 0,
              f"{label}: fast_forward_walk launched")
        fan = int(s.counters["chain_fanout_served"].sum())
        fb = int(s.counters["chain_fallback"].sum())
        mips = s.total_instructions / wall / 1e6
        print(f"{label}: {end_word(quanta)}, round_ctr {r}, completion "
              f"{s.completion_time_ps / 1000:.1f} ns, {s.total_instructions} "
              f"instructions, chain_fanout_served {fan}, chain_fallback "
              f"{fb}; counters {c}")
        print(f"{label}: wall {wall:.3f} s, {r / wall:.2f} rounds/s, "
              f"{1e3 * wall / r:.4f} ms/round, simulated MIPS {mips:.6f}, "
              f"{peak_line(held)}, window_walk launches {lw}, "
              f"chain_classify launches {lc} on {card}")
        return sim, lc, fan, 1e3 * wall / r

    sim, _, _, wall_ms1k = scale_run(
        f"radix1024 ({RADIX1024_QUANTA} quanta)", sparams, trace1k,
        RADIX1024_CTRS, RADIX1024_COMPLETION_PS, RADIX1024_CUT_ICOUNT,
        quanta=RADIX1024_QUANTA, cut=RADIX1024_CUT)
    del sim
    stamp("phase 9: radix1024")
    # The profiled stretch continues phase 3's radix1024 simulation, one
    # quantum past its start; the top kernels show what the [T, T] and
    # [T, A, A] work and the directory scatters' copies cost.
    profile_stretch(s1k, wall_ms1k, card, "radix1024", ["window_walk"],
                    quanta=2, top=12)
    del s1k
    stamp("phase 9: radix1024 stretch profiled")
    sim, lc1k, fan, _ = scale_run(
        f"radix1024_chain12 ({RADIX1024_CHAIN12_QUANTA} quanta)", scparams,
        trace1k, RADIX1024_CHAIN12_CTRS, RADIX1024_CHAIN12_COMPLETION_PS,
        RADIX1024_CHAIN12_ICOUNT, quanta=RADIX1024_CHAIN12_QUANTA,
        cut=RADIX1024_CHAIN12_CUT)
    check(fan == RADIX1024_CHAIN12_FANOUT and lc1k > 0,
          f"radix1024_chain12: chain_fanout_served {fan} != "
          f"{RADIX1024_CHAIN12_FANOUT}")
    step = kchain.chain_step_entry(scparams, sim.vp, SCALE_H, 16)
    check(step.form == kchain.WIDE,
          "radix1024_chain12: chain_classify did not launch its wide form")
    print(f"radix1024_chain12: chain_classify launched its wide form "
          f"({lc1k} launches = {CHAIN} x {RADIX1024_CHAIN12_CTRS['ctr_resolve']} "
          f"chain passes)")
    del sim, step
    stamp("phase 9: radix1024_chain12")
    p256 = config(**{"general/total_cores": 256})
    scale_run("radix256", p256,
              synth.gen_radix(256, keys_per_tile=96, radix=256, seed=0),
              RADIX256_CTRS, RADIX256_COMPLETION_PS, RADIX256_ICOUNT,
              quanta=RADIX256_QUANTA, cut=RADIX256_CUT)
    stamp("phase 9: radix256")
    # T = 512, the last size with dense one-hot [T, H] tables (4,194,304
    # elements each): a cut run, for its peak device memory.
    p512 = config(**{"general/total_cores": 512, "tpu/block_events": SCALE_K})
    held = peak_reset()
    sim = Simulator(p512, synth.gen_radix(512, keys_per_tile=16, radix=64,
                                          seed=0), device=dev)
    t0 = time.perf_counter()
    st512 = megarun(p512, sim.state, sim.trace, RADIX512_QUANTA, vp=sim.vp)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    c = round_ctrs(st512)
    c.update(clock_max=int(st512.clock.max().item()),
             clock_sum=int(st512.clock.sum().item()),
             cursor_sum=int(st512.cursor.to(torch.int64).sum().item()))
    for k, v in RADIX512_CUT.items():
        check(c[k] == v, f"radix512 cut: {k} {c[k]} != {v}")
    print(f"radix512 ({RADIX512_QUANTA} quanta): round_ctr {c['round_ctr']}, "
          f"counters {c}; wall {wall:.3f} s "
          f"({1e3 * wall / c['round_ctr']:.4f} ms/round), {peak_line(held)} "
          f"on {card}")
    del sim, st512
    stamp("phase 9: radix512 cut")

    # ---- 10. the coherence protocols at full width
    def proto_run(label, p, ptrace, want, want_ps, want_icount,
                  quanta=None, cut=None):
        """One protocol path, exact against its pins; the run records
        (clones of) the operands of its first window walks, replay
        iterations and analytic rounds, on which each kernel is held
        against its plain form and timed once the launch counts are
        read."""
        held = peak_reset()
        sim = Simulator(p, ptrace, device=dev)
        reset_counts()
        with Recorder(kcore.kwindow, "run_window",
                      lambda wi: bool(wi.tile_active.any()), 2) as rwp, \
                Recorder(kres.kchain, "run_chain_step", any_head, 4) as rcp, \
                Recorder(kcore.kwindow, "run_fast_forward",
                         lambda fi: bool(fi.tile_active.any()), 2) as rfp:
            s, wall = advance(sim, quanta)
        lw, lc = COUNTS["window_walk"], COUNTS["chain_classify"]
        lf, engaged = COUNTS["fast_forward_walk"], COUNTS["ff_engaged"]
        c = round_ctrs(sim.state)
        r = c["round_ctr"]
        passes = r - c["ctr_window"] - c["ctr_complex"] - c["ctr_conflict"] \
            - engaged
        check_end(label, sim, s, want_ps, cut)
        for k, v in want.items():
            check(c[k] == v, f"{label}: {k} {c[k]} != {v}")
        check(want_icount is None or s.total_instructions == want_icount,
              f"{label}: icount {s.total_instructions} != {want_icount}")
        check(lw == c["ctr_window"] and lw > 0,
              f"{label}: window_walk launches {lw} != ctr_window "
              f"{c['ctr_window']}")
        check(passes == c["ctr_resolve"] and lc == p.miss_chain * passes
              and lc > 0, f"{label}: chain_classify launches {lc} != "
                          f"{p.miss_chain} x {passes} chain passes")
        check(lf >= engaged, f"{label}: fast_forward_walk launches {lf} < "
                             f"{engaged} engaged analytic rounds")
        fan = int(s.counters["chain_fanout_served"].sum())
        fb = int(s.counters["chain_fallback"].sum())
        mips = s.total_instructions / wall / 1e6
        print(f"{label}: {end_word(quanta)}, round_ctr {r}, completion "
              f"{s.completion_time_ps / 1000:.1f} ns, {s.total_instructions} "
              f"instructions, chain_fanout_served {fan}, chain_fallback "
              f"{fb}, dram_reads {int(s.counters['dram_reads'].sum())}, "
              f"l2_access {int(s.counters['l2_access'].sum())}, l2_miss "
              f"{int(s.counters['l2_miss'].sum())}; counters {c}, analytic "
              f"rounds that engaged {engaged}, chain passes {passes}")
        print(f"{label}: wall {wall:.3f} s, {r / wall:.2f} rounds/s, "
              f"{1e3 * wall / r:.4f} ms/round, simulated MIPS {mips:.6f}, "
              f"{peak_line(held)}, window_walk launches {lw}, "
              f"chain_classify launches {lc}, fast_forward_walk launches "
              f"{lf} on {card}")
        del sim
        proto_kernels(label, p, rwp.seen, rcp.seen, rfp.seen)
        return lw, lc, lf, fan, fb

    def proto_kernels(label, p, windows, iterations, rounds):
        """Each kernel against its plain form on the operands a protocol
        path recorded, and its time on the card on the last of them (the
        fast-forward walk on a recorded round where some tile engages,
        else on phase 3's seeded set with the most engaged tiles)."""
        nonlocal err_w, err_c, err_f
        v = variant_params(p)
        check(bool(windows) and bool(iterations),
              f"{label}: recorded {len(windows)} windows and "
              f"{len(iterations)} replay iterations")
        for i, wi in enumerate(windows):
            got, ref = walk_pair(kwin, p, v, wi, T)
            torch.cuda.synchronize()
            err_w = max(err_w, compare("window_walk", got, ref,
                                       f"{label} window {i}"))
        for i, si in enumerate(iterations):
            got, ref = step_pair(kchain, p, v, si, H)
            torch.cuda.synchronize()
            err_c = max(err_c, compare_step(got, ref,
                                            f"{label} iteration {i}"))
        for i, fi in enumerate(rounds):
            got, ref = ff_pair(kwin, p, v, fi)
            torch.cuda.synchronize()
            err_f = max(err_f, compare("fast_forward_walk", got, ref,
                                       f"{label} analytic round {i}"))
        wms, wdev, wplain, wref = walk_times(kwin, p, v, windows[-1], T)
        wbound = window_bytes(p, v, windows[-1], wref) \
            / HBM_BYTES_PER_S * 1e3
        si = iterations[0]
        cms = time_cuda(lambda: kchain.chain_step_cuda(p, v, si, H),
                        iters=300, warmup=30)
        cdev = device_ms(lambda: kchain.chain_step_cuda(p, v, si, H),
                         "chain_classify_kernel")
        cplain = time_cuda(lambda: kchain.chain_step(p, v, si, H),
                           iters=20, warmup=3)
        cbound = chain_bytes(p, si, *kchain.chain_step(p, v, si, H)) \
            / HBM_BYTES_PER_S * 1e3
        line = (f"kernel times {label} (recorded in the run): window_walk "
                f"K={windows[-1].addr.shape[1]} {wms:.6f} ms/launch "
                f"(wrapper), device {fmt_ms(wdev)}, plain {wplain:.6f} ms, "
                f"bound {wbound:.9f} ms; chain_classify {cms:.6f} ms/launch "
                f"(wrapper), device {fmt_ms(cdev)}, plain {cplain:.6f} ms, "
                f"bound {cbound:.9f} ms")
        if rounds:
            eng = [fi for fi in rounds
                   if bool(kwin.ff_price(p, v, fi).engage.any())]
            fpp, fpv, fi_t = (p, v, eng[-1]) if eng else (
                ff_seeded[0], variant_params(ff_seeded[0]), ff_seeded[1])
            fms, fdev, fplain = ff_times(kwin, fpp, fpv, fi_t)
            fbound = ff_bytes(fpp, fpv, fi_t) / HBM_BYTES_PER_S * 1e3
            kind = "a recorded" if eng else "the seeded"
            line += (f"; fast_forward_walk ({kind} round) {fms:.6f} "
                     f"ms/launch (wrapper), device "
                     f"{fmt_ms(fdev)}, plain {fplain:.6f} ms, bound "
                     f"{fbound:.9f} ms")
        print(f"{line}; library call: none; every recorded operand set "
              f"equal to the plain forms (max abs err window {err_w}, "
              f"chain {err_c}, ff {err_f}) on {card}")

    pin = cuts["radix64_shl2_mesi_ff_span_cut"]
    lw, lc, lf, _, _ = proto_run(
        f"radix64_shl2_mesi_ff_span keys_per_tile={CUT_KEYS}",
        config(**SHL2_MESI_FF), cut_trace, pin["cut"]["ctrs"],
        pin["cut"]["completion_ps"], pin["cut"]["sums"]["icount"],
        quanta=pin["quanta"], cut=dict(clock_sum=pin["cut"]["clock_sum"],
                                       cursor_sum=pin["cut"]["cursor_sum"]))
    check(lw > 0 and lc > 0 and lf > 0,
          f"radix64_shl2_mesi_ff_span: launches window_walk {lw}, "
          f"chain_classify {lc}, fast_forward_walk {lf}: each kernel must "
          f"run on its protocol branches")
    stamp("phase 10: radix64_shl2_mesi_ff_span")
    _, _, _, fan, fb = proto_run(
        "fft64_mosi", config(**{"caching_protocol/type": MOSI,
                                "tpu/miss_chain": CHAIN}), fft,
        FFT_MOSI_CTRS, FFT_MOSI_COMPLETION_PS, FFT_MOSI_ICOUNT,
        quanta=FFT_MOSI_QUANTA, cut=FFT_MOSI_CUT)
    check(fan == FFT_MOSI_FANOUT and fb == FFT_MOSI_FALLBACK,
          f"fft64_mosi: chain_fanout_served {fan} / chain_fallback {fb} != "
          f"{FFT_MOSI_FANOUT} / {FFT_MOSI_FALLBACK}")
    stamp("phase 10: fft64_mosi")
    _, _, _, fan, fb = proto_run(
        "fft64_shl2_msi", config(**{"caching_protocol/type": SH_MSI,
                                    "tpu/miss_chain": CHAIN,
                                    "dram/num_controllers": SHL2_CTRL}), fft,
        FFT_SHL2_CTRS, FFT_SHL2_COMPLETION_PS, FFT_SHL2_ICOUNT,
        quanta=FFT_SHL2_QUANTA, cut=FFT_SHL2_CUT)
    check(fan == FFT_SHL2_FANOUT and fb == FFT_SHL2_FALLBACK,
          f"fft64_shl2_msi: chain_fanout_served {fan} / chain_fallback {fb} "
          f"!= {FFT_SHL2_FANOUT} / {FFT_SHL2_FALLBACK}")
    stamp("phase 10: fft64_shl2_msi")

    # ---- 11. the network models: each kernel's network branch on seeded
    # sets (ATAC under both routings and receive networks, at cluster
    # sizes 4 and 16; the hop-by-hop mesh with its queue model off; the
    # default emesh_hop_counter beside them for time), then two full-width
    # paths, each exact against its JAX pins
    def atac(net, cs=4, routing="cluster_based", rnet="star"):
        return {f"network/{net}": "atac", "network/atac/cluster_size": cs,
                "network/atac/global_routing_strategy": routing,
                "network/atac/receive_network_type": rnet}

    def clusters(p, net):
        return noc_atac.geometry(getattr(p, f"net_{net}").atac, dev)[0]

    net_cases = {
        "emesh": {},
        "atac_cs4": atac("memory"),
        "atac_cs16_distance_btree": atac("memory", 16, "distance_based",
                                         "btree"),
        "hbh_queue_off": {"network/memory": "emesh_hop_by_hop"},
    }
    net_times = {}
    nc = fan_same = fan_other = 0
    for name, over in net_cases.items():
        # the fan-out replay and the DRAM queue both on (H = 1,024) and
        # both off (a colliding H = 4)
        for fan, h in ((True, H), (False, 4)):
            p = config(**{**over, "tpu/miss_chain": CHAIN,
                          "tpu/fanout_replay": fan,
                          "dram/queue_model/enabled": fan})
            v = variant_params(p)
            si = chain_step_in_from_numpy(
                random_chain_step_arrays(p, h, nc), dev)
            got, ref = step_pair(kchain, p, v, si, h)
            torch.cuda.synchronize()
            err_c = max(err_c, compare_step(
                got, ref, f"{name} fanout={fan} queue={fan} H={h} "
                          f"seed {nc}"))
            nc += 1
            if p.net_memory.model == "atac" and fan:
                head, out = ref
                cl = clusters(p, "memory")
                for k in range(out.inv_bool.shape[0]):
                    rows = torch.nonzero(out.fan_go & (
                        head.line == out.line_fr[k]))
                    if rows.numel() and bool(out.inv_bool[k].any()):
                        hc = cl[head.home[rows[0, 0]]]
                        tc = cl[out.inv_bool[k]]
                        fan_same += int((tc == hc).sum())
                        fan_other += int((tc != hc).sum())
            if fan:
                # timed on a set of its own, as phase 3 times its sets
                st = chain_step_in_from_numpy(
                    random_chain_step_arrays(p, H, 0), dev)
                net_times[("chain_classify", name)] = device_ms(
                    lambda: kchain.chain_step_cuda(p, v, st, H),
                    "chain_classify_kernel")
                if name != "emesh":
                    net_times[("chain_bound", name)] = chain_bytes(
                        p, st, *kchain.chain_step(p, v, st, H)) \
                        / HBM_BYTES_PER_S * 1e3
    check(fan_same > 0 and fan_other > 0,
          f"chain_classify atac: fan-out targets in the home's cluster "
          f"{fan_same}, in others {fan_other}")
    # shared-L2 slice misses whose controller sits in another cluster,
    # and the wide form at T = 1024 under both routings (one operand set:
    # the arrays do not depend on the network)
    far = 0
    wide_arrays = None
    for routing in ("cluster_based", "distance_based"):
        p = config(**{**atac("memory", 16, routing), "tpu/miss_chain": CHAIN,
                      "caching_protocol/type": SH_MSI,
                      "dram/queue_model/enabled": False,
                      "dram/num_controllers": T // 4})
        v = variant_params(p)
        cl = clusters(p, "memory")
        for seed in range(2):
            si = chain_step_in_from_numpy(
                random_chain_step_arrays(p, H, seed), dev)
            got, ref = step_pair(kchain, p, v, si, H)
            torch.cuda.synchronize()
            err_c = max(err_c, compare_step(got, ref, f"atac {routing} "
                                            f"shared L2 seed {seed}"))
            head, out = ref
            m = out.need_read & (out.from_dram_ps > 0)
            site = dense.dram_site_of_line(p, head.line[m]).to(torch.int64)
            far += int((cl[site] != cl[head.home[m].to(torch.int64)]).sum())
            nc += 1
        # (phase 3's small directory: its arrays are quick to make)
        pw = config(**{**atac("memory", 16, routing), "tpu/miss_chain": CHAIN,
                       "general/total_cores": T1k,
                       "dram_directory/total_entries": 256})
        vw = variant_params(pw)
        check(kchain.chain_step_entry(pw, vw, SCALE_H, 16).form
              == kchain.WIDE,
              "chain_classify T=1024 atac: not the wide form")
        if wide_arrays is None:
            wide_arrays = random_chain_step_arrays(pw, SCALE_H, 0)
        si = chain_step_in_from_numpy(wide_arrays, dev)
        got, ref = step_pair(kchain, pw, vw, si, SCALE_H)
        torch.cuda.synchronize()
        err_c = max(err_c, compare_step(got, ref, f"T=1024 atac {routing}"))
        nc += 1
    check(far > 0, "chain_classify atac shared L2: no slice miss whose "
                   "controller sits in another cluster")
    stamp("phase 11: chain_classify network sets")
    # window_walk: SPAWN rows under each user network
    walk_nets = {
        "emesh": {},
        "atac_cs4": atac("user"),
        "atac_cs16_distance_btree": atac("user", 16, "distance_based",
                                         "btree"),
        "hbh": {"network/user": "emesh_hop_by_hop"},
    }
    nw = crossing = 0
    for name, over in walk_nets.items():
        for P in (0, CHAIN):
            p = config(**{**over, "tpu/miss_chain": P})
            v = variant_params(p)
            for Kw in (K, 64):
                for seed in (nw % 4,):
                    wi = window_in_from_numpy(
                        spawn_window_arrays(p, Kw, seed), dev)
                    got, ref = walk_pair(kwin, p, v, wi, T)
                    torch.cuda.synchronize()
                    err_w = max(err_w, compare(
                        "window_walk", got, ref, f"{name} P={P} K={Kw} "
                                                 f"spawn seed {seed}"))
                    nw += 1
                    if p.net_user.model == "atac":
                        cl = clusters(p, "user")
                        src = wi.tile_ids.to(torch.int64)[:, None].expand(
                            T, Kw)
                        dst = ref.spawn_child.to(torch.int64) % T
                        crossing += int(((wi.meta[0] == EventOp.SPAWN)
                                         & (cl[src] != cl[dst])).sum())
            if P == 0:
                wi = window_in_from_numpy(spawn_window_arrays(p, K, 0), dev)
                net_times[("window_walk", name)] = walk_device_ms(
                    kwin, p, v, wi, T, launches=50)
                if name != "emesh":
                    net_times[("window_bound", name)] = window_bytes(
                        p, v, wi, kwin.window_walk(p, v, wi, T)) \
                        / HBM_BYTES_PER_S * 1e3
    check(crossing > 0, "window_walk atac: no SPAWN across clusters")
    print(f"kernel chain_classify networks: {nc} operand sets (fan-out "
          f"targets in the home's cluster {fan_same}, in others "
          f"{fan_other}; {far} shared-L2 slice misses whose controller sits "
          f"in another cluster; the wide form at T = 1024 under both "
          f"routings), every ChainHead and ChainOut field equal to the "
          f"plain step (max abs err {err_c}); kernel window_walk networks: "
          f"{nw} operand sets with SPAWN rows ({crossing} across ATAC "
          f"clusters), every output equal to the plain form (max abs err "
          f"{err_w})")
    for (kname, name), ms in sorted(net_times.items()):
        what = (f"bound {ms:.9f} ms" if kname.endswith("bound")
                else f"device {fmt_ms(ms)}")
        print(f"kernel network time {kname} {name}: {what} per launch on "
              f"{card}")
    stamp("phase 11: network operand sets")

    def net_run(label, p, ptrace, want, want_ps, want_wait, contended,
                quanta=None, cut=None):
        """One network path, exact against its pins; the run records the
        operands of its first window walks and replay iterations, on which
        the kernels are held against their plain forms once the launch
        counts are read."""
        nonlocal err_w, err_c
        held = peak_reset()
        sim = Simulator(p, ptrace, device=dev)
        reset_counts()
        with Recorder(kcore.kwindow, "run_window",
                      lambda wi: bool(wi.tile_active.any()), 2) as rwp, \
                Recorder(kres.kchain, "run_chain_step", any_head, 4) as rcp:
            s, wall = advance(sim, quanta)
        lw, lc = COUNTS["window_walk"], COUNTS["chain_classify"]
        c = round_ctrs(sim.state)
        r = c["round_ctr"]
        passes = r - c["ctr_window"] - c["ctr_complex"] - c["ctr_conflict"]
        wait = int(s.counters["net_link_wait_ps"].sum())
        check_end(label, sim, s, want_ps, cut)
        for k, v in want.items():
            check(c[k] == v, f"{label}: {k} {c[k]} != {v}")
        check(wait == want_wait, f"{label}: net_link_wait_ps {wait} != "
                                 f"{want_wait}")
        check(lw == c["ctr_window"] and lw > 0,
              f"{label}: window_walk launches {lw} != ctr_window "
              f"{c['ctr_window']}")
        if contended:
            # the chain pass stands down; the window walk banks and the
            # conflict rounds fly every leg
            check(lc == 0 and passes == 0 and wait > 0,
                  f"{label}: chain_classify launches {lc}, chain passes "
                  f"{passes}, link wait {wait}")
        else:
            check(passes == c["ctr_resolve"] and lc == p.miss_chain * passes
                  and lc > 0, f"{label}: chain_classify launches {lc} != "
                              f"{p.miss_chain} x {passes} chain passes")
        fan = int(s.counters["chain_fanout_served"].sum())
        fb = int(s.counters["chain_fallback"].sum())
        print(f"{label}: {end_word(quanta)}, round_ctr {r}, completion "
              f"{s.completion_time_ps / 1000:.1f} ns, {s.total_instructions} "
              f"instructions, net_link_wait_ps {wait}, chain_fanout_served "
              f"{fan}, chain_fallback {fb}; counters {c}")
        print(f"{label}: wall {wall:.3f} s, {r / wall:.2f} rounds/s, "
              f"{1e3 * wall / r:.4f} ms/round, simulated MIPS "
              f"{s.total_instructions / wall / 1e6:.6f}, {peak_line(held)}, "
              f"window_walk launches {lw}, chain_classify launches {lc} on "
              f"{card}")
        del sim
        v = variant_params(p)
        check(bool(rwp.seen) and (contended or bool(rcp.seen)),
              f"{label}: recorded {len(rwp.seen)} windows and "
              f"{len(rcp.seen)} replay iterations")
        for i, wi in enumerate(rwp.seen):
            got, ref = walk_pair(kwin, p, v, wi, T)
            torch.cuda.synchronize()
            err_w = max(err_w, compare("window_walk", got, ref,
                                       f"{label} window {i}"))
        for i, si in enumerate(rcp.seen):
            got, ref = step_pair(kchain, p, v, si, H)
            torch.cuda.synchronize()
            err_c = max(err_c, compare_step(got, ref,
                                            f"{label} iteration {i}"))
        print(f"{label}: kernels held on the run's recorded operands "
              f"({len(rwp.seen)} windows, {len(rcp.seen)} replay "
              f"iterations), max abs err window {err_w}, chain {err_c}")
        return lw, lc, fan, fb

    fft_net = synth.gen_fft(64, points_per_tile=NET_FFT_POINTS,
                            writeback=True)
    pin = cuts["fft64_atac_chain12_cut"]
    want = pin["cut"]
    _, _, fan, fb = net_run(
        f"fft64_atac_chain12 points_per_tile={NET_FFT_POINTS}",
        config(**{"network/memory": "atac", "network/user": "atac",
                  "tpu/miss_chain": CHAIN}), fft_net,
        want["ctrs"], want["completion_ps"], 0, contended=False,
        quanta=pin["quanta"], cut=dict(clock_sum=want["clock_sum"],
                                       cursor_sum=want["cursor_sum"]))
    check(fan == want["sums"]["chain_fanout_served"] and fan > 0
          and fb == want["sums"]["chain_fallback"],
          f"fft64_atac_chain12: chain_fanout_served {fan} / chain_fallback "
          f"{fb} != {want['sums']['chain_fanout_served']} / "
          f"{want['sums']['chain_fallback']}")
    stamp("phase 11: fft64_atac_chain12")
    net_run(f"fft64_hbh_contended points_per_tile={NET_FFT_POINTS}",
            config(**{"network/memory": "emesh_hop_by_hop",
                      "network/emesh_hop_by_hop/queue_model/enabled": True,
                      "tpu/miss_chain": CHAIN}), fft_net,
            FFT_HBH_CTRS, FFT_HBH_COMPLETION_PS, FFT_HBH_LINK_WAIT_PS,
            contended=True, quanta=FFT_HBH_QUANTA, cut=FFT_HBH_CUT)
    stamp("phase 11: fft64_hbh_contended")

    # ---- 12. synchronisation, CAPI and system events at full width,
    # one stream per tile, each exact against its JAX pins (lock64 and
    # sysev64_ff, and in phase 13 threads128on64_chain12 and lock128on64,
    # cut: tests/data/card_pins_cuts.json)
    for label, streams in (("lock64", T), ("sysev64_ff", T),
                           ("threads128on64_chain12", 2 * T),
                           ("lock128on64", 2 * T)):
        pin = cuts[f"{label}_cut"]
        want = pin["cut"]
        SYNC_PINS[label] = dict(
            ctrs=want["ctrs"], completion_ps=want["completion_ps"],
            sums={k: want["sums"][k] for k in SYNC_SUMS}, vm=want["vm"],
            quanta=pin["quanta"], streams=streams,
            cut=dict(clock_sum=want["clock_sum"],
                     cursor_sum=want["cursor_sum"]))
    def sync_run(label, p, strace, windows=None, iterations=None,
                 rounds=False):
        """One phase-12 or phase-13 path; with ``windows`` and
        ``iterations`` (predicates on the walk's and the replay step's
        operands) and ``rounds`` it records (clones of) the operands of
        its first window walks, replay iterations and analytic rounds,
        on which each kernel is held against its plain form once the
        launch counts are read."""
        nonlocal err_w, err_c, err_f
        pin = SYNC_PINS[label]
        streams = pin.get("streams", T)
        held = peak_reset()
        sim = Simulator(p, strace, device=dev)
        reset_counts()
        with Recorder(kcore.kwindow, "run_window",
                      windows or (lambda wi: False), 3) as rwp, \
                Recorder(kres.kchain, "run_chain_step",
                         iterations or (lambda si: False), 4) as rcp, \
                Recorder(kcore.kwindow, "run_fast_forward",
                         (lambda fi: bool(fi.tile_active.any())) if rounds
                         else (lambda fi: False), 3) as rfp:
            s, wall = advance(sim, pin.get("quanta"))
        lw, lc = COUNTS["window_walk"], COUNTS["chain_classify"]
        lf, engaged = COUNTS["fast_forward_walk"], COUNTS["ff_engaged"]
        c = round_ctrs(sim.state)
        r = c["round_ctr"]
        passes = r - c["ctr_window"] - c["ctr_complex"] - c["ctr_conflict"] \
            - engaged
        check_end(label, sim, s, pin["completion_ps"], pin.get("cut"))
        check(s.done.shape == (streams,),
              f"{label}: {s.done.shape[0]} streams reported, not {streams}")
        for k, v in pin["ctrs"].items():
            check(c[k] == v, f"{label}: {k} {c[k]} != {v}")
        sums = {k: int(s.counters[k].sum()) for k in SYNC_SUMS}
        for k, v in pin["sums"].items():
            check(sums[k] == v, f"{label}: sum of {k} {sums[k]} != {v}")
        check(s.vm_summary() == pin["vm"],
              f"{label}: [vm] {s.vm_summary()} != {pin['vm']}")
        check(lw == c["ctr_window"] and lw > 0,
              f"{label}: window_walk launches {lw} != ctr_window "
              f"{c['ctr_window']}")
        check(passes == (c["ctr_resolve"] if p.miss_chain else 0)
              and lc == p.miss_chain * passes,
              f"{label}: chain_classify launches {lc} != {p.miss_chain} x "
              f"{passes} chain passes")
        check(lf >= engaged, f"{label}: fast_forward_walk launches {lf} < "
                             f"{engaged} engaged analytic rounds")
        print(f"{label}: {end_word(pin.get('quanta'))}, round_ctr {r}, "
              f"completion {s.completion_time_ps / 1000:.1f} ns; counters "
              f"{c}; sums "
              f"{sums}; vm {s.vm_summary()}; analytic rounds that engaged "
              f"{engaged}, chain passes {passes}")
        print(f"{label}: wall {wall:.3f} s, {r / wall:.2f} rounds/s, "
              f"{1e3 * wall / r:.4f} ms/round, simulated MIPS "
              f"{s.total_instructions / wall / 1e6:.6f}, {peak_line(held)}, "
              f"window_walk launches {lw}, chain_classify launches {lc}, "
              f"fast_forward_walk launches {lf} on {card}")
        del sim
        v = variant_params(p)
        check((windows is None or bool(rwp.seen))
              and (iterations is None or bool(rcp.seen))
              and (not rounds or bool(rfp.seen)),
              f"{label}: recorded {len(rwp.seen)} windows, {len(rcp.seen)} "
              f"replay iterations, {len(rfp.seen)} analytic rounds")
        for i, wi in enumerate(rwp.seen):
            got, ref = walk_pair(kwin, p, v, wi, streams)
            torch.cuda.synchronize()
            err_w = max(err_w, compare("window_walk", got, ref,
                                       f"{label} window {i}"))
        for i, si in enumerate(rcp.seen):
            got, ref = step_pair(kchain, p, v, si, H)
            torch.cuda.synchronize()
            err_c = max(err_c, compare_step(got, ref,
                                            f"{label} iteration {i}"))
        for i, fi in enumerate(rfp.seen):
            got, ref = ff_pair(kwin, p, v, fi)
            torch.cuda.synchronize()
            err_f = max(err_f, compare("fast_forward_walk", got, ref,
                                       f"{label} analytic round {i}"))
        if rwp.seen or rcp.seen or rfp.seen:
            print(f"{label}: kernels held on the run's recorded operands "
                  f"({len(rwp.seen)} windows, {len(rcp.seen)} replay "
                  f"iterations, {len(rfp.seen)} analytic rounds), max abs "
                  f"err window {err_w}, chain {err_c}, ff {err_f}")
        return lw, lc, lf

    def rows_of(*ops):
        """A window predicate: some valid event is one of ``ops``."""
        def keep(wi):
            hit = torch.zeros_like(wi.valid_ev)
            for o in ops:
                hit |= wi.meta[0] == int(o)
            return bool((hit & wi.valid_ev).any())
        return keep

    def atomic_head(si):
        """A replay iteration in which some active head is a banked
        ATOMIC (bit 3 of its request word)."""
        hsel = torch.clamp(si.head, 0, CHAIN - 1).to(torch.int64)[None, :]
        req = torch.gather(si.mq_req, 0, hsel)[0]
        return bool((((~si.stopped) & (si.head < si.stop_hi))
                     & (((req >> 3) & 1) == 1)).any())

    sync_run("lock64", config(), synth.gen_lock_contention(
        T, acquisitions=16, critical_cycles=50))
    stamp("phase 12: lock64")
    sync_run("pingpong64_hbh_user",
             config(**{"network/user": "emesh_hop_by_hop",
                       "network/emesh_hop_by_hop/queue_model/enabled": True}),
             synth.gen_ping_pong(T, messages=32, size=64))
    stamp("phase 12: pingpong64_hbh_user")
    lw, lc, _ = sync_run(
        "threads64_chain12", config(**{"tpu/miss_chain": CHAIN}),
        synth.gen_threads_oversubscribed(num_streams=T, compute_blocks=8,
                                         cost_cycles=100, yields=2),
        windows=rows_of(EventOp.SPAWN), iterations=any_head)
    check(lw > 0 and lc > 0, f"threads64_chain12: launches window_walk {lw}, "
                             f"chain_classify {lc}")
    stamp("phase 12: threads64_chain12")
    lw, lc, lf = sync_run(
        "sysev64_ff", config(**{"tpu/fast_forward": FF,
                                "tpu/fast_forward_span": 1000,
                                "tpu/miss_chain": CHAIN}),
        synth.gen_system_events(T, seed=0),
        windows=rows_of(EventOp.STALL, EventOp.SYNC),
        iterations=atomic_head, rounds=True)
    check(lw > 0 and lc > 0 and lf > 0,
          f"sysev64_ff: launches window_walk {lw}, chain_classify {lc}, "
          f"fast_forward_walk {lf}: each kernel must run")
    stamp("phase 12: sysev64_ff")

    # ---- 13. the ThreadScheduler at full width: 128 streams on 64 tiles,
    # each a whole run exact against its JAX pins
    def sched(**over):
        return config(**{"general/max_threads_per_core": 2, **over})

    def spawn_past_tiles(wi):
        """A window with a valid SPAWN of a stream id >= T."""
        return bool(((wi.meta[0] == int(EventOp.SPAWN))
                     & (wi.meta[2] >= T) & wi.valid_ev).any())

    lw, lc, lf = sync_run(
        "threads128on64_chain12", sched(**{"tpu/miss_chain": CHAIN}),
        synth.gen_threads_oversubscribed(num_streams=2 * T,
                                         compute_blocks=64, yields=8),
        windows=spawn_past_tiles, iterations=any_head)
    check(lw > 0 and lc > 0 and lf == 0,
          f"threads128on64_chain12: launches window_walk {lw}, "
          f"chain_classify {lc}, fast_forward_walk {lf}")
    stamp("phase 13: threads128on64_chain12")
    sync_run("lock128on64", sched(), synth.gen_lock_contention(
        2 * T, acquisitions=2, critical_cycles=50))
    stamp("phase 13: lock128on64")
    sync_run("barrier128on64", sched(), synth.gen_barrier_compute(2 * T))
    stamp("phase 13: barrier128on64")

    # ---- 14. chain_classify's grid form: past 1,024 tiles (16 sharer
    # words) and past 32 directory ways, on seeded sets, then the
    # radix1536_chain12 path at full width
    cap_blocks, cap_threads = kchain.grid_capacity()
    print(f"kernel chain_classify grid form: at most {cap_blocks} blocks of "
          f"{cap_threads} threads resident at once on this card (at most "
          f"{cap_blocks * cap_threads} tiles)")

    def grid_sets(label, T14, over, hs):
        """State-level seeded sets of every configuration (fan-out replay
        and DRAM queue model each on and off) at each H of ``hs``."""
        sets = []
        for fan in (True, False):
            for queue in (True, False):
                p = config(**{"general/total_cores": T14,
                              "tpu/miss_chain": CHAIN,
                              "tpu/fanout_replay": fan,
                              "dram/queue_model/enabled": queue, **over})
                v = variant_params(p)
                for h in hs:
                    seed = len(sets)
                    sets.append((p, v, h, f"{label} fanout={fan} "
                                          f"queue={queue} H={h} seed {seed}",
                                 chain_step_in_from_numpy(
                                     random_chain_step_arrays(p, h, seed),
                                     dev)))
        return sets

    def grid_entry(p, v, si, h, form=None):
        A14 = p.directory.associativity
        return kchain.chain_step_entry(p, v, h,
                                       si.dir_sharers.shape[0] // A14, form)

    def grid_pair(p, v, si, h, label, form=None):
        """The grid form (chosen by the sizes, or asked for) and the plain
        step on the same operands, the floor table on a clone; every
        field equal."""
        step = grid_entry(p, v, si, h, form)
        check(step.form == kchain.GRID,
              f"chain_classify {label}: not the grid form")
        work = si._replace(ftbl=None if si.ftbl is None else si.ftbl.clone())
        got = step(work)
        ref = kchain.chain_step(p, v, si, h)
        if work.ftbl is not None:
            check(got[1].ftbl.data_ptr() == work.ftbl.data_ptr(),
                  "chain_classify: the floor table is not the operand's "
                  "own")
        torch.cuda.synchronize()
        return compare_step(got, ref, label), ref

    def grid_times(label, p, v, si, h, form=None):
        """Wrapper and device time per launch of the form the entry
        takes, the plain step's time and the bound, on one set (DRAM
        queue model on: the floor table is not written)."""
        step = grid_entry(p, v, si, h, form)
        ms = time_cuda(lambda: step(si), iters=100, warmup=10)
        dv = device_ms(lambda: step(si), "chain_classify_kernel")
        plain = time_cuda(lambda: kchain.chain_step(p, v, si, h), iters=10,
                          warmup=2)
        moved = chain_bytes(p, si, *kchain.chain_step(p, v, si, h))
        bound = moved / HBM_BYTES_PER_S * 1e3
        form_name = ("shared", "wide", "grid")[step.form]
        print(f"kernel chain_classify {label} ({form_name} form, "
              f"{step.ws_bytes} B workspace): {ms:.6f} ms/launch (wrapper), "
              f"device {fmt_ms(dv)} per launch, plain {plain:.6f} ms, bound "
              f"{bound:.9f} ms ({moved} bytes the function reads and writes "
              f"on these operands, at {HBM_BYTES_PER_S / 1e12:.2f} TB/s), "
              f"library call: none on {card}")
        return ms, dv, plain, bound

    err_g, fan32, blocks_x, past32 = 0, 0, 0, 0
    groups = (
        ("T=2048", 2048, {"dram_directory/total_entries": GRID_SMALL_DIR},
         (2048 * 16, 4), None),
        ("A=64 T=64", T, {"dram_directory/associativity": 64}, (H, 4), None),
        ("A=128 T=64", T, {"dram_directory/associativity": 128}, (H,), None),
        ("T=1024", T1k, {"dram_directory/total_entries": 256},
         (SCALE_H, 4), kchain.GRID))
    for label, T14, over, hs, form in groups:
        sets = grid_sets(label, T14, over, hs)
        for p, v, h, lab, si in sets:
            e, ref = grid_pair(p, v, si, h, lab, form)
            err_g = max(err_g, e)
            co = ref[1]
            if co.inv_bool is not None:
                fan32 += int((co.fan_go & (co.inv_count > 32)).sum())
                if T14 > cap_threads:
                    nb = co.inv_bool.reshape(co.inv_bool.shape[0], -1,
                                             cap_threads).any(2).sum(1)
                    blocks_x += int((nb > 1).sum())
            if p.directory.associativity > 32:
                past32 += int((co.hit & (co.way >= 32)).sum())
        print(f"kernel chain_classify {label} (grid form"
              f"{', asked for' if form is not None else ''}): {len(sets)} "
              f"seeded sets, every ChainHead and ChainOut field and the "
              f"in-place floor table equal to the plain step (max abs err "
              f"{err_g})")
        p, v, h, lab, si = sets[0]          # fan-out on, queue on
        if form is not None:                # the wide form on the same set
            grid_times(f"{label} {lab}", p, v, si, h)
        grid_times(f"{label} {lab}", p, v, si, h, form)
        del sets, si
        stamp(f"phase 14: grid form {label}")
    check(fan32 > 0 and blocks_x > 0 and past32 > 0,
          f"chain_classify grid form: fan-outs past 32 targets {fan32}, "
          f"across blocks {blocks_x}, hits past way 32 {past32}")
    print(f"kernel chain_classify grid form: {fan32} fan-outs past 32 "
          f"targets, {blocks_x} whose targets lie in more than one block, "
          f"{past32} directory hits past way 32 (the second hit-held word)")

    # radix1536_chain12: the first replay iterations of a one-quantum run
    # of its own (their clones hold the 4.83 GB sharer array, so they stay
    # out of the pinned run's peak memory), held against the plain step
    # and timed; then the pinned cut.
    p15 = config(**{"general/total_cores": RADIX1536_T,
                    "tpu/block_events": SCALE_K, "tpu/miss_chain": CHAIN})
    v15 = variant_params(p15)
    H15 = max(1024, 16 * RADIX1536_T)
    trace15 = synth.gen_radix(RADIX1536_T, keys_per_tile=16, radix=64,
                              seed=0)
    rsim = Simulator(p15, trace15, device=dev)
    with Recorder(kres.kchain, "run_chain_step", any_head, 2) as r15:
        rsim.state = megarun(p15, rsim.state, rsim.trace, 1, vp=rsim.vp)
    del rsim
    check(len(r15.seen) == 2, f"captured {len(r15.seen)} replay iterations "
                              f"from the radix1536 chain-12 run, want 2")
    for i, si in enumerate(r15.seen):
        e, _ = grid_pair(p15, v15, si, H15,
                         f"captured radix1536 chain-12 iteration {i}")
        err_g = max(err_g, e)
    print(f"kernel chain_classify radix1536 (grid form): "
          f"{len(r15.seen)} replay iterations recorded in the run, every "
          f"field equal to the plain step (max abs err {err_g})")
    ms_g, _, plain_g, bound_g = grid_times(
        "T=1536 captured radix1536 chain-12 iteration 0", p15, v15,
        r15.seen[0], H15)
    del r15, si
    stamp("phase 14: radix1536 recorded iterations")
    sim, lc15, fan, _ = scale_run(
        f"radix1536_chain12 ({RADIX1536_QUANTA} quanta)", p15, trace15,
        RADIX1536_CTRS, RADIX1536_COMPLETION_PS, RADIX1536_ICOUNT,
        quanta=RADIX1536_QUANTA, cut=RADIX1536_CUT)
    check(fan == RADIX1536_FANOUT and lc15 > 0,
          f"radix1536_chain12: chain_fanout_served {fan} != "
          f"{RADIX1536_FANOUT}")
    check(kchain.chain_step_entry(p15, sim.vp, H15, (RADIX1536_T + 63)
                                  // 64).form == kchain.GRID,
          "radix1536_chain12: chain_classify did not launch its grid form")
    print(f"radix1536_chain12: chain_classify launched its grid form "
          f"({lc15} launches = {CHAIN} x {RADIX1536_CTRS['ctr_resolve']} "
          f"chain passes), a {p15.mesh_width}-wide mesh of "
          f"{RADIX1536_T} tiles")
    del sim
    stamp("phase 14: radix1536_chain12")

    # ---- 15. the limited directory schemes and the basic and m_g_1
    # DRAM queue models
    qbytes = phase15_queue_models(dev)
    print(f"queue models: basic (windows 0, 1, 2, 16, 64) and m_g_1 on "
          f"CUDA tensors equal to the CPU's, byte for byte "
          f"({qbytes} B of outputs compared)")
    stamp("phase 15: queue models on the card")

    def pinned_paths(phase, pins):
        """Cut runs at T = 64, each held leaf by leaf (by digest) and
        round counter by round counter to the JAX package's on the CPU
        (tests/record_card_pins.py), window_walk launched once per window
        round and chain_classify P times per chain pass (the replay runs
        under a full-map directory with simple cores only).  Returns the
        window_walk launches."""
        total = 0
        for name in sorted(pins):
            pin = pins[name]
            gen, kw = pin["trace"]
            p = config(**pin["over"])
            held = peak_reset()
            sim = Simulator(p, getattr(synth, gen)(**kw), device=dev)
            reset_counts()
            s, wall = advance(sim, pin["quanta"])
            lw, lc = COUNTS["window_walk"], COUNTS["chain_classify"]
            total += lw
            c = round_ctrs(sim.state)
            want = pin["cut"]
            check_end(name, sim, s, want["completion_ps"],
                      dict(clock_sum=want["clock_sum"],
                           cursor_sum=want["cursor_sum"]))
            for k, v in want["ctrs"].items():
                check(c[k] == v, f"{name}: {k} {c[k]} != {v}")
            leaves = convert.state_to_numpy(sim.state)
            check(set(leaves) == set(want["leaves"]),
                  f"{name}: leaves "
                  f"{sorted(set(leaves) ^ set(want['leaves']))}")
            bad = sorted(k for k, v in leaves.items()
                         if leaf_digest(v) != want["leaves"][k])
            check(not bad, f"{name}: leaves differ from the JAX package's: "
                           f"{bad}")
            check(lw == c["ctr_window"] and lw > 0,
                  f"{name}: window_walk launches {lw} != ctr_window "
                  f"{c['ctr_window']}")
            replay = p.miss_chain and p.core.model == "simple" \
                and p.directory.directory_type == "full_map"
            passes = c["ctr_resolve"] if replay else 0
            check(lc == p.miss_chain * passes,
                  f"{name}: chain_classify launches {lc} != "
                  f"{p.miss_chain} x {passes} chain passes")
            check(not replay or lc > 0,
                  f"{name}: chain_classify never launched")
            r = c["round_ctr"]
            mt = {k: int(s.counters[f"l2_miss_{k}"].sum())
                  for k in ("cold", "capacity", "sharing")}
            print(f"{name}: cut at {pin['quanta']} quanta, every leaf and "
                  f"round counter the JAX package's (dram_qacc "
                  f"{leaf_digest(leaves['dram_qacc'])}), round_ctr {r}, "
                  f"latest clock {s.completion_time_ps / 1000:.1f} ns, "
                  f"invalidations "
                  f"{int(s.counters['dir_invalidations'].sum())}, "
                  f"net_mem_pkts {int(s.counters['net_mem_pkts'].sum())}, "
                  f"l2 misses cold {mt['cold']} capacity {mt['capacity']} "
                  f"sharing {mt['sharing']}; window_walk launches {lw}, "
                  f"chain_classify launches {lc}")
            print(f"{name}: wall {wall:.3f} s, {1e3 * wall / r:.4f} "
                  f"ms/round, {peak_line(held)} on {card}")
            del sim
            stamp(f"phase {phase}: {name}")
        return total

    pinned_paths(15, json.load(open(os.path.join(
        HERE, "tests", "data", "card_pins_dir_queue.json"))))


    # ---- 16. miss-type tracking and the iocoom cores (uniform and mixed
    # model lists)
    lw16 = pinned_paths(16, pins16)
    print(f"phase 16: window_walk launches {lw16} over its "
          f"{len(pins16)} paths")

    # ---- 17. tile sharding with replicated state: one launch of gloo ranks
    # sharing the card per shard count
    runs17, lw17 = phase17(card, count)
    w17 = runs17[2][0]["walks"]

    kernels = [{
        "name": "window_walk",
        "route": "cuda",
        "source": "graphite_tpu_torch/engine/kernels/csrc/window_walk.cu",
        "note": "carries the iocoom branches (drain floors, draining "
                "branches on the absolute clock, annotated hits declined)",
        "replaces": "graphite_tpu/engine/kernels/window.py:163",
        "launches": lw12,
        "max_abs_err": err_w,
        "ms": ms_w,
        "plain_ms": plain_w,
        "bound_ms": bound_w,
        "bound_by": "bytes",
        "library_ms": None,
    }, {
        "name": "chain_classify (shared form)",
        "route": "cuda",
        "source": "graphite_tpu_torch/engine/kernels/csrc/chain_classify.cu",
        "replaces": "graphite_tpu/engine/kernels/chain.py:134",
        "launches": lc12,
        "max_abs_err": err_c,
        "ms": ms_c,
        "plain_ms": plain_c,
        "bound_ms": bound_c,
        "bound_by": "bytes",
        "library_ms": None,
    }, {
        "name": "chain_classify (wide form)",
        "route": "cuda",
        "source": "graphite_tpu_torch/engine/kernels/csrc/chain_classify.cu",
        "replaces": "graphite_tpu/engine/kernels/chain.py:134",
        "launches": lc1k,
        "max_abs_err": err_c1k,
        "ms": ms_c1k,
        "plain_ms": plain_c1k,
        "bound_ms": moved_c1k / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes",
        "library_ms": None,
    }, {
        "name": "chain_classify (grid form)",
        "route": "cuda",
        "source": "graphite_tpu_torch/engine/kernels/csrc/chain_classify.cu",
        "replaces": "graphite_tpu/engine/kernels/chain.py:134",
        "launches": lc15,
        "max_abs_err": err_g,
        "ms": ms_g,
        "plain_ms": plain_g,
        "bound_ms": bound_g,
        "bound_by": "bytes",
        "library_ms": None,
    }, {
        "name": "fast_forward_walk",
        "route": "cuda",
        "source": "graphite_tpu_torch/engine/kernels/csrc/"
                  "fast_forward_walk.cu",
        "replaces": "graphite_tpu/engine/kernels/window.py:779",
        "launches": lf_span,
        "max_abs_err": err_f,
        "ms": ms_f,
        "plain_ms": plain_f,
        "bound_ms": bound_f,
        "bound_by": "bytes",
        "library_ms": None,
    }]
    for name, source, replaces, launches in (
            ("run_window_sharded", "window_walk.cu",
             "graphite_tpu/engine/kernels/window.py:696", lw17[0]),
            ("run_fast_forward_sharded", "fast_forward_walk.cu",
             "graphite_tpu/engine/kernels/window.py:1006", lw17[1])):
        rec = w17[name]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"graphite_tpu_torch/engine/kernels/csrc/{source}",
            "note": f"the kernel on a shard's {rec['tiles']} tiles of 64 "
                    f"(2 gloo ranks sharing the card), outputs gathered "
                    f"by one gloo collective; ms is the sharded call, "
                    f"device_ms the kernel's launch at those tiles",
            "replaces": replaces,
            "launches": launches,
            "max_abs_err": max(r["walks"][name]["max_abs_err"]
                               for runs in runs17.values() for r in runs),
            "ms": rec["ms"],
            "device_ms": rec["device_ms"],
            "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"],
            "bound_by": "bytes",
            "library_ms": None,
        })
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
