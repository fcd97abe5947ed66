"""The full-width paths that ``chip_smoke.py`` (cut by quanta) and
``tests/test_torch_card_paths.py`` (whole runs) hold the port to on the
card, and the JAX package's values for them, recorded on the CPU:

  * phase 15, the limited directory schemes and the ``basic`` and
    ``m_g_1`` DRAM queue models, into
    ``tests/data/card_pins_dir_queue.json``;
  * phase 16, the iocoom cores (uniform and mixed model lists) and
    miss-type tracking, into ``tests/data/card_pins_ioc_mt.json``;
  * the depth cuts of phases 5, 6 and 10 to 13 (each path's whole run
    is held on the card by tests/test_torch_card_paths.py), into
    ``tests/data/card_pins_cuts.json``; these also keep every counter's
    sum and the [vm] section at the cut;
  * phase 17, tile sharding with replicated state, into
    ``tests/data/card_pins_shard.json``: the paths run there under
    ``tpu/tile_shards`` = 2 and 4, held to the JAX package's unsharded
    run (its sharded run equals it bit for bit, tests/test_sharding.py).

    JAX_PLATFORMS=cpu python tests/record_card_pins.py [path ...]

For each path the file keeps its trace (a ``synth`` generator and its
arguments), its config overrides and its cut, and, for the cut and the
whole run, the round counters, the latest clock, the clocks' and
cursors' sums and every SimState leaf's digest (dtype, shape and the
SHA-256 of its bytes, as tests/torch_jax_ref.py digests them).

The radix64 trace never writes a line that another tile holds (no
invalidation at any depth, under a full map or a scheme), so the
broadcast schemes' legs are held on a migratory trace as well.
"""

from __future__ import annotations

import json
import os
import sys

RADIX64 = ["gen_radix", dict(num_tiles=64, keys_per_tile=64, radix=256,
                             seed=0)]
MIGRATORY64 = ["gen_migratory", dict(num_tiles=64, lines=8, rounds=1)]
# graphite_tpu_torch.events.synth's generator, made with the JAX
# package's TraceBuilder here (the JAX synth module has no such trace).
SCOREBOARD64 = ["gen_scoreboard", dict(num_tiles=64, rounds=6, seed=0)]
HBH = {"network/memory": "emesh_hop_by_hop"}
TREE = "network/emesh_hop_by_hop/broadcast_tree_enabled"


def _scheme(scheme, k=4):
    return {"dram_directory/directory_type": scheme,
            "dram_directory/max_hw_sharers": k}


# name: (trace, config overrides, quanta of the cut run)
DIR_QUEUE = {
    **{f"radix64_{s}": (RADIX64, _scheme(s), 6) for s in (
        "limited_broadcast", "limited_no_broadcast", "ackwise",
        "limitless")},
    "migratory64_lb_hbh_tree": (
        MIGRATORY64, {**_scheme("limited_broadcast"), **HBH, TREE: True},
        6),
    "migratory64_lb_hbh_no_tree": (
        MIGRATORY64, {**_scheme("limited_broadcast"), **HBH, TREE: False},
        6),
    "migratory64_ackwise": (MIGRATORY64, _scheme("ackwise"), 6),
    "radix64_chain12_basic": (
        RADIX64, {"tpu/miss_chain": 12, "dram/queue_model/type": "basic"},
        4),
    "radix64_chain12_m_g_1": (
        RADIX64, {"tpu/miss_chain": 12, "dram/queue_model/type": "m_g_1"},
        4),
}
IOCOOM = {"tile/model_list": "<default,iocoom,T1,T1,T1>"}
MIXED = {"tile/model_list":
         "<32,simple,T1,T1,T1>, <32,iocoom,T1,T1,T1>"}
TRACK = {"l2_cache/T1/track_miss_types": True}
IOC_MT = {
    "radix64_iocoom": (RADIX64, IOCOOM, 6),
    "radix64_iocoom_chain12": (RADIX64, {**IOCOOM, "tpu/miss_chain": 12},
                               2),
    "radix64_mixed": (RADIX64, MIXED, 6),
    "scoreboard64": (SCOREBOARD64, {
        **IOCOOM, "core/iocoom/num_load_queue_entries": 1,
        "core/iocoom/num_store_queue_entries": 1}, 8),
    "radix64_chain12_mt": (RADIX64, {**TRACK, "tpu/miss_chain": 12}, 4),
    "migratory64_mt": (MIGRATORY64, TRACK, 6),
}
FFT64 = ["gen_fft", dict(num_tiles=64, points_per_tile=64, writeback=True)]
SHARD = {
    "radix64_shard": (RADIX64, {}, 16),
    "radix64_chain12_shard": (RADIX64, {"tpu/miss_chain": 12}, 6),
    "fft64_ff_span_shard": (FFT64, {
        "tpu/fast_forward": 8, "tpu/fast_forward_span": 1000,
        "tpu/miss_chain": 12}, 10),
}
LOCK64 = ["gen_lock_contention", dict(num_tiles=64, acquisitions=16,
                                     critical_cycles=50)]
SYSEV64 = ["gen_system_events", dict(num_tiles=64, seed=0)]
FF8 = {"tpu/fast_forward": 8, "tpu/fast_forward_span": 1000}
SCHED = {"general/max_threads_per_core": 2}
CUTS = {
    "radix64_cut": (RADIX64, {}, 60),
    "radix64_chain12_cut": (RADIX64, {"tpu/miss_chain": 12}, 10),
    "radix64_shl2_mesi_ff_span_cut": (RADIX64, {
        **FF8, "caching_protocol/type": "pr_l1_sh_l2_mesi",
        "tpu/miss_chain": 12}, 6),
    "fft64_atac_chain12_cut": (FFT64, {
        "network/memory": "atac", "network/user": "atac",
        "tpu/miss_chain": 12}, 16),
    "lock64_cut": (LOCK64, {}, 80),
    "sysev64_ff_cut": (SYSEV64, {**FF8, "tpu/miss_chain": 12}, 8),
    "threads128on64_chain12_cut": (
        ["gen_threads_oversubscribed", dict(num_streams=128,
                                            compute_blocks=64, yields=8)],
        {**SCHED, "tpu/miss_chain": 12}, 17),
    "lock128on64_cut": (
        ["gen_lock_contention", dict(num_tiles=128, acquisitions=2,
                                     critical_cycles=50)], SCHED, 60),
}
CTRS = ("round_ctr", "ctr_window", "ctr_complex", "ctr_conflict",
        "ctr_resolve", "ctr_quantum")
HERE = os.path.dirname(os.path.abspath(__file__))
# pin file -> its paths
PIN_SETS = {
    os.path.join(HERE, "data", "card_pins_dir_queue.json"): DIR_QUEUE,
    os.path.join(HERE, "data", "card_pins_ioc_mt.json"): IOC_MT,
    os.path.join(HERE, "data", "card_pins_shard.json"): SHARD,
    os.path.join(HERE, "data", "card_pins_cuts.json"): CUTS,
}
PATHS = {**DIR_QUEUE, **IOC_MT, **SHARD, **CUTS}


def _values(leaves, tparams):
    import numpy as np
    sys.path.insert(0, HERE)
    from graphite_tpu_torch.engine import vm
    from torch_jax_ref import digest
    return dict(
        ctrs={k: int(leaves[k]) for k in CTRS},
        completion_ps=int(np.asarray(leaves["clock"]).max()),
        clock_sum=int(np.asarray(leaves["clock"]).sum()),
        cursor_sum=int(np.asarray(leaves["cursor"]).astype(np.int64).sum()),
        sums={k.split(".", 1)[1]: int(np.asarray(v).sum())
              for k, v in sorted(leaves.items())
              if k.startswith("counters.")},
        vm=vm.summarize(tparams.num_tiles, tparams.stack_base,
                        tparams.stack_size_per_core,
                        int(leaves["vm_brk"]), int(leaves["vm_mmap_bytes"]),
                        int(leaves["vm_munmap_bytes"])),
        leaves={k: digest(v) for k, v in sorted(leaves.items())})


def record(name):
    import jax
    from graphite_tpu.config import load_config
    from graphite_tpu.engine import quantum
    from graphite_tpu.engine.sim import Simulator
    from graphite_tpu.events import synth
    from graphite_tpu.events.schema import TraceBuilder
    from graphite_tpu.params import SimParams
    from graphite_tpu_torch import convert
    from graphite_tpu_torch import load_config as tload_config
    from graphite_tpu_torch.events import synth as tsynth
    from graphite_tpu_torch.params import SimParams as TSimParams
    (gen, kw), over, quanta = PATHS[name]
    cfg, tcfg = load_config(), tload_config()
    for k, v in over.items():
        cfg.set(k, v)
        tcfg.set(k, v)
    params = SimParams.from_config(cfg)
    tparams = TSimParams.from_config(tcfg)
    trace = getattr(synth, gen)(**kw) if hasattr(synth, gen) \
        else getattr(tsynth, gen)(**kw, builder=TraceBuilder)
    sim = Simulator(params, trace)
    cut = quantum.megarun(params, sim.state, sim.trace, quanta)
    cut = convert.leaves_to_numpy(jax.device_get(cut))
    sim.run()
    whole = convert.leaves_to_numpy(jax.device_get(sim.state))
    return dict(trace=[gen, kw], over=over, quanta=quanta,
                cut=_values(cut, tparams), whole=_values(whole, tparams))


def main(names):
    sys.path.insert(0, os.path.dirname(HERE))
    for name in names or sorted(PATHS):
        path, = [p for p, paths in PIN_SETS.items() if name in paths]
        rec = record(name)
        # Read the file again just before writing it: several recorders
        # may run at once, one path each.
        try:
            with open(path) as f:
                pins = json.load(f)
        except FileNotFoundError:
            pins = {}
        pins[name] = rec
        w = rec["whole"]
        print(f"{name}: cut {rec['cut']['ctrs']}, whole "
              f"{w['ctrs']}, {w['completion_ps']} ps", flush=True)
        with open(path, "w") as f:
            json.dump(pins, f, indent=1, sort_keys=True)
            f.write("\n")


if __name__ == "__main__":
    main(sys.argv[1:])
