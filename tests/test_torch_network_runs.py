"""PyTorch port, the network models in whole runs against the JAX package
on the CPU: ATAC on the memory network (tests/test_atac.py's radix shape,
cluster-based at ``tpu/miss_chain`` 0 and distance-based with the btree
receive network at 12) and the contended hop-by-hop mesh
(``network/memory = emesh_hop_by_hop`` with its queue model on; the
migratory shape of tests/test_noc_contention.py at chain 0 with a
hop-by-hop user network, whose link horizons are a [4, T] leaf, and at
chain 12, where the chain pass stands down; tests/test_noc_contention.py's
16-tile shared-readers hot spot under ``slow``).  Each run ends with every
SimState leaf equal to the JAX package's, tolerance 0, the
``link_free_*`` horizons and the ``net_link_wait_ps`` counter included.
A carry-across test takes a contended JAX state into the port mid-run
(``convert``), and the configurations the port still refuses are
checked at construction.

The cheapest run (``LIVE``) compares with the JAX package's live run;
the other cases and the carry-across with its recorded pins
(tests/torch_jax_ref.py).
"""

import numpy as np
import pytest
import torch

import jax

from graphite_tpu.config import load_config as jax_load_config
from graphite_tpu.engine.sim import Simulator as JaxSimulator
from graphite_tpu.events import synth as jax_synth
from graphite_tpu.params import SimParams as JaxSimParams
from graphite_tpu_torch import cli, convert, load_config
from graphite_tpu_torch.engine.sim import Simulator, run_simulation
from graphite_tpu_torch.events import synth as tsynth
from graphite_tpu_torch.params import SimParams

import torch_jax_ref as ref

CONTENDED = {"network/memory": "emesh_hop_by_hop",
             "network/emesh_hop_by_hop/queue_model/enabled": True}
RADIX16 = ("gen_radix", dict(num_tiles=16, keys_per_tile=24, radix=8,
                             seed=4))
MIGRATORY = ("gen_migratory", dict(num_tiles=8, lines=4, rounds=2))

# name: (trace, config overrides, entry point)
RUNS = {
    "radix16_atac": (RADIX16, {"network/memory": "atac"}, "simulator"),
    "radix16_atac_distance_btree_chain12": (RADIX16, {
        "network/memory": "atac",
        "network/atac/global_routing_strategy": "distance_based",
        "network/atac/receive_network_type": "btree",
        "tpu/miss_chain": 12}, "run_simulation"),
    "migratory_contended_user_hbh": (MIGRATORY, {
        **CONTENDED, "network/user": "emesh_hop_by_hop"}, "cli"),
    "migratory_contended_chain12": (MIGRATORY, {
        **CONTENDED, "tpu/miss_chain": 12}, "simulator"),
    # tests/test_noc_contention.py's hot-spot shape (slow there too: a
    # JAX compile of its own at 16 tiles)
    "shared_readers16_contended": (
        ("gen_shared_readers", dict(num_tiles=16, lines=12, passes=2)),
        CONTENDED, "simulator"),
}
SLOW = ("shared_readers16_contended",)
LIVE = ("radix16_atac",)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
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


def _traces(trace):
    """(a function making the JAX package's trace, the port's trace)."""
    fn, kw = trace
    return (lambda: getattr(jax_synth, fn)(**kw)), getattr(tsynth, fn)(**kw)


_assert_leaves_equal = ref.assert_leaves_equal


def _entry_point_summary(name, tp, over, ttrace, tmp_path):
    """The case's user entry point (run_simulation or ``cli run``) on the
    same trace: (completion ps, the summary's per-tile counters or None,
    the rendered text or None)."""
    entry = RUNS[name][2]
    if entry == "run_simulation":
        s = run_simulation(tp, ttrace, max_steps=4096, device="cpu")
        return s.completion_time_ps, s.counters, None
    path = str(tmp_path / "t.npz")
    ttrace.save(path)
    out = str(tmp_path / "sim.out")
    args = ["run", "--trace", path, "--device", "cpu", "-o", out] + [
        f"--{k}={str(v).lower() if isinstance(v, bool) else v}"
        for k, v in over.items()]
    assert cli.main(args) == 0
    return None, None, open(out).read()


@pytest.mark.parametrize("name", [
    pytest.param(n, marks=pytest.mark.slow) if n in SLOW else n
    for n in sorted(RUNS)])
def test_network_run_matches_jax(name, tmp_path):
    trace, over, _ = RUNS[name]
    jtrace, ttrace = _traces(trace)
    T = trace[1]["num_tiles"]
    jp, tp = _params(T, over)
    tsim = Simulator(tp, ttrace, device="cpu")
    tsum = tsim.run(max_steps=4096)
    assert bool(tsim.state.done.all())

    def with_completion(leaves, s):
        return {**leaves, "completion_ps": np.asarray(s.completion_time_ps,
                                                      np.int64)}

    def jax_leaves():
        jsim = JaxSimulator(jp, jtrace())
        jsum = jsim.run(max_steps=4096)
        return with_completion(
            convert.leaves_to_numpy(jax.device_get(jsim.state)), jsum)

    # The JAX package's leaves and completion (equal to the port's).
    jleaves = ref.check(
        "test_torch_network_runs", name,
        with_completion(convert.state_to_numpy(tsim.state), tsum),
        jax_leaves, ref.inputs({"general/total_cores": T, **over},
                               ttrace, steps=4096), live=name in LIVE)
    completion_ps = int(jleaves["completion_ps"])
    if RUNS[name][2] != "simulator":
        ps, counters, text = _entry_point_summary(name, tp, over, ttrace,
                                                  tmp_path)
        if text is None:
            assert ps == completion_ps
            for k in tsum.counters:
                np.testing.assert_array_equal(
                    jleaves[f"counters.{k}"], counters[k], err_msg=k)
        else:
            ns = completion_ps / 1000
            assert f"Completion Time (in ns){' ' * 23}: {ns:.1f}" in text
            assert f"Streams Completed{' ' * 29}: {T} / {T}" in text
    wait = int(jleaves["counters.net_link_wait_ps"].sum())
    assert (wait > 0) == ("contended" in name)
    if "contended" in name:
        assert (jleaves["link_free_mem"] > 0).any()
    assert jleaves["link_free_user"].shape == (
        4, T if "user_hbh" in name else 0)
    if "chain12" in name and "contended" in name:
        # The chain pass stands down: every element is served in a
        # conflict round, each a round of its own.
        assert int(jleaves["ctr_conflict"]) > 0


def test_carry_across_contended_mid_run():
    """A contended state after two quanta (memory-link horizons set, the
    [4, T] user-link leaf of a hop-by-hop user network), carried through
    ``convert.state_from_numpy``, runs one more quantum to the JAX
    package's state (torch_jax_ref.megarun_carry)."""
    trace, over, _ = RUNS["migratory_contended_user_hbh"]
    jtrace, ttrace = _traces(trace)
    T = trace[1]["num_tiles"]
    jp, tp = _params(T, over)
    leaves, tnext = ref.megarun_carry(
        "test_torch_network_runs", "carry", jp, jtrace, tp, ttrace, 2, 1,
        {"general/total_cores": T, **over})
    assert (leaves["link_free_mem"] > 0).any()
    assert leaves["link_free_user"].shape == (4, T)
    assert int(tnext.ctr_quantum) == 3
    assert not np.array_equal(tnext.link_free_mem.numpy(),
                              leaves["link_free_mem"])


@pytest.mark.parametrize("over,trace_fn", [
    # The user network's contended SEND flight, the directory schemes,
    # the broadcast tree, miss-type tracking and iocoom cores run
    # (test_torch_sync_runs, test_torch_dir_schemes,
    # test_torch_miss_types, test_torch_iocoom); beside a key that stays
    # refused, each network configuration is refused by that key.
    ({"network/user": "emesh_hop_by_hop",
      "network/emesh_hop_by_hop/queue_model/enabled": True,
      "dram_directory/directory_type": "limitless",
      "l2_cache/T1/track_miss_types": True,
      "statistics_trace/enabled": True},
     lambda: tsynth.gen_lock_contention(num_tiles=4, acquisitions=2)),
    ({**CONTENDED, "network/emesh_hop_by_hop/broadcast_tree_enabled": True,
      "dram_directory/directory_type": "limited_broadcast",
      "trace/segment_events": 4096}, None),
    ({"network/memory": "atac",
      "dram_directory/directory_type": "ackwise",
      "tile/model_list": "<default,iocoom,T1,T1,T1>",
      "tpu/tile_shards": 2, "tpu/shard_state": "resident"}, None),
], ids=["user_hbh_limitless_sync", "broadcast_tree_scheme", "atac_ackwise"])
def test_network_configs_still_refused(over, trace_fn):
    cfg = load_config()
    cfg.set("general/total_cores", 4)
    for k, v in over.items():
        cfg.set(k, v)
    params = SimParams.from_config(cfg)
    trace = trace_fn() if trace_fn else tsynth.gen_radix(
        num_tiles=4, keys_per_tile=8, radix=8, seed=0)
    with pytest.raises(NotImplementedError, match="slice"):
        Simulator(params, trace, device="cpu")
