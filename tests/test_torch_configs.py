"""PyTorch port, the slice's configuration knobs end to end: both packages
run one random trace (numpy seed) under each supported setting and must
end with every SimState leaf equal (tolerance 0), and with the same
summary (and, with power modeling on, the same energy section).

The trace mixes every event kind of the slice — COMPUTE, BRANCH (no
synthetic generator emits branches), MEM_READ and MEM_WRITE over a small
shared line pool (hits, set conflicts, sharing and upgrades), barriers at
the same position in every stream, DONE — so the complex slot, the window
walk and resolve all see each kind.
"""

import numpy as np
import pytest

import jax

from graphite_tpu.config import load_config as jax_load_config
from graphite_tpu.engine.sim import Simulator as JaxSimulator
from graphite_tpu.events.schema import TraceBuilder as JaxTraceBuilder
from graphite_tpu.params import SimParams as JaxSimParams
from graphite_tpu_torch import convert, load_config
from graphite_tpu_torch.engine.sim import Simulator
from graphite_tpu_torch.events.schema import TraceBuilder
from graphite_tpu_torch.params import SimParams

T = 4


def _mixed_events(seed, n=120):
    """Per-tile event lists (one shared plan for both packages)."""
    rng = np.random.default_rng(seed)
    lines = rng.integers(0, 1 << 14, size=24) * 64
    pcs = 0x400000 + rng.integers(0, 64, size=6) * 4
    plan = []
    for t in range(T):
        evs = []
        for i in range(n):
            if i in (n // 3, 2 * n // 3):
                evs.append(("barrier", i // (n // 3), T))
                continue
            r = rng.random()
            if r < 0.3:
                evs.append(("compute", int(rng.integers(1, 30)),
                            int(rng.integers(1, 40))))
            elif r < 0.55:
                evs.append(("read", int(rng.choice(lines))
                            + int(rng.integers(0, 64))))
            elif r < 0.75:
                evs.append(("write", int(rng.choice(lines))))
            else:
                evs.append(("branch", bool(rng.random() < 0.6),
                            int(rng.choice(pcs))))
        plan.append(evs)
    return plan


def _build(builder_cls, plan):
    b = builder_cls(T)
    for t, evs in enumerate(plan):
        for ev in evs:
            kind = ev[0]
            if kind == "compute":
                b.compute(t, ev[1], ev[2])
            elif kind == "read":
                b.read(t, ev[1])
            elif kind == "write":
                b.write(t, ev[1])
            elif kind == "branch":
                b.branch(t, ev[1], pc=ev[2])
            else:
                b.barrier(t, ev[1], ev[2])
        b.done(t)
    return b.build()


SETTINGS = {
    "defaults": {},
    "round_robin_l1": {"l1_dcache/T1/replacement_policy": "round_robin",
                       "l1_icache/T1/replacement_policy": "round_robin",
                       "l2_cache/T1/replacement_policy": "round_robin"},
    "no_predictor": {"branch_predictor/type": "none"},
    "window_off": {"tpu/block_events": 0},
    "window_cache_off_k4": {"tpu/window_cache": "false",
                            "tpu/block_events": 4},
    "dram_queue_off": {"dram/queue_model/enabled": "false"},
    "magic_networks": {"network/user": "magic", "network/memory": "magic"},
    "models_off": {"general/enable_core_modeling": "false"},
    "with_power_modeling": {"general/enable_power_modeling": "true"},
}


@pytest.mark.parametrize("setting", sorted(SETTINGS))
def test_setting_matches_jax(setting):
    plan = _mixed_events(seed=sorted(SETTINGS).index(setting))
    cj, ct = jax_load_config(), load_config()
    for c in (cj, ct):
        c.set("general/total_cores", T)
        for k, v in SETTINGS[setting].items():
            c.set(k, v)
    jp, tp = JaxSimParams.from_config(cj), SimParams.from_config(ct)
    jsim = JaxSimulator(jp, _build(JaxTraceBuilder, plan))
    js = jsim.run(max_steps=512)
    tsim = Simulator(tp, _build(TraceBuilder, plan), device="cpu")
    ts = tsim.run(max_steps=512)
    assert bool(js.done.all()) and bool(ts.done.all())
    assert ts.render().split("Host Time")[0] \
        == js.render().split("Host Time")[0]
    if tp.enable_power_modeling:
        assert ts.to_dict()["energy"] == js.to_dict()["energy"]
        assert ts.render().split("[energy]")[1] \
            == js.render().split("[energy]")[1]
    jl = convert.leaves_to_numpy(jax.device_get(jsim.state))
    tl = convert.state_to_numpy(tsim.state)
    assert set(jl) == set(tl)
    for name in sorted(jl):
        a, b = np.asarray(jl[name]), tl[name]
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
