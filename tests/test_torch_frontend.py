"""PyTorch port, frontend: config/params, synthetic traces, trace files,
package isolation and the device contract.

Every comparison is exact: parameters field by field, trace arrays byte
for byte.
"""

import dataclasses
import subprocess
import sys

import numpy as np
import pytest
import torch

from graphite_tpu.config import load_config as jax_load_config
from graphite_tpu.events import synth as jax_synth
from graphite_tpu.events.schema import Trace as JaxTrace
from graphite_tpu.params import SimParams as JaxSimParams
from graphite_tpu_torch import load_config
from graphite_tpu_torch.engine.sim import Simulator
from graphite_tpu_torch.events import synth
from graphite_tpu_torch.events.schema import Trace
from graphite_tpu_torch.params import SimParams


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The engine's CPU path is thousands of tiny ops: one intra-op
    thread per test worker is faster than contending for every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


OVERRIDES = [
    {},
    {"general/total_cores": 8},
    {"general/total_cores": 16, "tpu/block_events": 4,
     "l1_dcache/T1/replacement_policy": "round_robin"},
    {"caching_protocol/type": "pr_l1_sh_l2_mesi", "tpu/miss_chain": 12},
    {"tile/model_list": "<default,iocoom,T1,T1,T1>",
     "network/memory": "emesh_hop_by_hop"},
    # the system events' keys: per-class syscall service cycles, the
    # channel ring depth, the cond replay mode, the DVFS sync delay
    {"syscall/read_cost": 2000, "syscall/brk_cost": 7,
     "tpu/channel_depth": 4, "tpu/cond_replay": True,
     "dvfs/synchronization_delay": 3,
     "general/trigger_models_within_application": "true"},
]


def _both_params(over):
    cj, ct = jax_load_config(), load_config()
    for k, v in over.items():
        cj.set(k, v)
        ct.set(k, v)
    return JaxSimParams.from_config(cj), SimParams.from_config(ct)


@pytest.mark.parametrize("over", OVERRIDES,
                         ids=lambda o: ",".join(f"{k}={v}" for k, v in
                                                o.items()) or "defaults")
def test_params_equal_field_by_field(over):
    jp, tp = _both_params(over)
    a, b = dataclasses.asdict(jp), dataclasses.asdict(tp)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k] == b[k], k
    for name in ("num_sets",):
        for lvl in ("l1i", "l1d", "l2"):
            assert getattr(getattr(jp, lvl), name) \
                == getattr(getattr(tp, lvl), name)
    assert jp.protocol_kind == tp.protocol_kind
    assert jp.shared_l2 == tp.shared_l2


GENERATORS = [
    ("gen_radix", dict(num_tiles=8, keys_per_tile=64, radix=16, seed=3)),
    ("gen_radix", dict(num_tiles=64, keys_per_tile=32, radix=256, seed=0)),
    ("gen_fft", dict(num_tiles=8, points_per_tile=64)),
    ("gen_fft", dict(num_tiles=8, points_per_tile=64, writeback=True)),
    ("gen_migratory", dict(num_tiles=8)),
    ("gen_lock_contention", dict(num_tiles=8, acquisitions=4)),
    ("gen_barrier_compute", dict(num_tiles=4)),
]


@pytest.mark.parametrize("name,kw", GENERATORS,
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(GENERATORS)])
def test_synth_traces_byte_equal(name, kw):
    a = getattr(jax_synth, name)(**kw)
    b = getattr(synth, name)(**kw)
    for f in ("ops", "addr", "arg", "arg2"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        assert x.tobytes() == y.tobytes(), f


def test_npz_loads_across_packages(tmp_path):
    tj = jax_synth.gen_fft(num_tiles=4, points_per_tile=32)
    tt = synth.gen_radix(num_tiles=4, keys_per_tile=16, radix=8, seed=1)
    tj.save(str(tmp_path / "j.npz"))
    tt.save(str(tmp_path / "t.npz"))
    a = Trace.load(str(tmp_path / "j.npz"))
    b = JaxTrace.load(str(tmp_path / "t.npz"))
    for f in ("ops", "addr", "arg", "arg2"):
        np.testing.assert_array_equal(getattr(a, f), getattr(tj, f))
        np.testing.assert_array_equal(getattr(b, f), getattr(tt, f))
        assert getattr(a, f).dtype == getattr(tj, f).dtype


def test_port_imports_no_jax():
    """Every module of the port imports without pulling in jax or any
    part of the JAX package (run in a fresh interpreter)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import graphite_tpu_torch as g\n"
        "for m in pkgutil.walk_packages(g.__path__, g.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' "
        "or k.startswith('jax.') or k == 'graphite_tpu' "
        "or k.startswith('graphite_tpu.'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_default_device_is_cuda():
    """``device=None`` means CUDA: without a GPU the constructor raises
    rather than running on the CPU."""
    cfg = load_config()
    cfg.set("general/total_cores", 4)
    params = SimParams.from_config(cfg)
    trace = synth.gen_radix(num_tiles=4, keys_per_tile=8, radix=8, seed=0)
    if torch.cuda.is_available():
        assert Simulator(params, trace).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            Simulator(params, trace)
    assert Simulator(params, trace, device="cpu").device.type == "cpu"


@pytest.mark.parametrize("over,trace_fn", [
    # Every coherence protocol, directory scheme, DRAM queue model,
    # network model and core model, the chain replay and miss-type
    # tracking run (tests/test_torch_dir_schemes.py,
    # tests/test_torch_queue_models.py, tests/test_torch_iocoom.py,
    # tests/test_torch_miss_types.py); beside a key that stays refused
    # (resident tile sharding, streaming ingest, the statistics ring)
    # each is
    # refused by that key, under private or shared L2.
    ({"tpu/miss_chain": 12, "l2_cache/T1/track_miss_types": True,
      "trace/segment_events": 4096}, None),
    ({"dram_directory/directory_type": "ackwise",
      "tile/model_list": "<default,iocoom,T1,T1,T1>",
      "statistics_trace/enabled": True}, None),
    ({"tile/model_list": "<default,iocoom,T1,T1,T1>",
      "tpu/tile_shards": 2, "tpu/shard_state": "resident"}, None),
    ({"caching_protocol/type": "pr_l1_sh_l2_msi",
      "l2_directory/directory_type": "limited_no_broadcast",
      "l2_cache/T1/track_miss_types": True,
      "trace/segment_events": 4096}, None),
    ({"dram/queue_model/type": "basic", "trace/segment_events": 4096},
     None),
    ({"network/memory": "emesh_hop_by_hop",
      "network/emesh_hop_by_hop/broadcast_tree_enabled": True,
      "dram_directory/directory_type": "limited_broadcast",
      "statistics_trace/enabled": True}, None),
    # The same under a CAPI trace.
    ({"dram/queue_model/type": "basic", "tpu/tile_shards": 2,
      "tpu/shard_state": "resident"},
     lambda: synth.gen_ping_pong(num_tiles=4, messages=2)),
], ids=["miss_chain", "ackwise", "iocoom", "sh_l2_limited", "basic_queue",
        "hop_by_hop", "basic_queue_capi"])
def test_outside_slice_refused_at_construction(over, trace_fn):
    cfg = load_config()
    cfg.set("general/total_cores", 4)
    for k, v in over.items():
        cfg.set(k, v)
    params = SimParams.from_config(cfg)
    trace = trace_fn() if trace_fn else synth.gen_radix(
        num_tiles=4, keys_per_tile=8, radix=8, seed=0)
    with pytest.raises(NotImplementedError, match="slice"):
        Simulator(params, trace, device="cpu")


def test_initial_state_leaves_match_capi():
    """A CAPI trace's initial state: the [T, T] channel counters and the
    [D, T, T] arrival ring beside every other leaf (the lock, barrier,
    spawn, DVFS period and VM leaves among them), leaf for leaf the JAX
    package's make_state."""
    import jax
    from graphite_tpu.engine import state as jstate
    from graphite_tpu_torch import convert
    jp, tp = _both_params({"general/total_cores": 4})
    trace = synth.gen_ping_pong(num_tiles=4, messages=2)
    jl = convert.leaves_to_numpy(jax.device_get(
        jstate.make_state(jp, has_capi=True, num_streams=4)))
    tl = convert.state_to_numpy(Simulator(tp, trace, device="cpu").state)
    assert set(jl) == set(tl)
    for name in sorted(jl):
        a, b = np.asarray(jl[name]), tl[name]
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert tl["ch_time"].shape == (tp.channel_depth, 4, 4)
    assert tl["ch_sent"].shape == (4, 4)


def test_cli_run_and_params(tmp_path, capsys):
    from graphite_tpu_torch import cli
    path = str(tmp_path / "t.npz")
    synth.gen_radix(num_tiles=4, keys_per_tile=16, radix=8, seed=2).save(path)
    out = str(tmp_path / "sim.out")
    assert cli.main(["run", "--trace", path, "--device", "cpu",
                     "-o", out]) == 0
    text = open(out).read()
    assert "Streams Completed                             : 4 / 4" in text
    assert cli.main(["params", "--general/total_cores=16"]) == 0
    assert '"num_tiles": 16' in capsys.readouterr().out
