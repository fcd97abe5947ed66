"""PyTorch port, the iocoom cores (in-order core, out-of-order memory;
reference iocoom_core_model.{h,cc}, [core/iocoom] carbon_sim.cfg:180-186)
against the JAX package on the CPU, every SimState leaf and round
counter equal (tolerance 0):

  * the plain window walk, op by op against the JAX walk
    (``tests/torch_jax_ref.eager``), on seeded iocoom operands
    (``operands.iocoom_window_arrays``: register-annotated events, drain
    points, queue completions above the clock) under a uniform model
    list and a mixed one in both orders, speculative loads on and off,
    at miss_chain 0 and 12;
  * whole runs of the nine shapes of tests/test_iocoom.py (T = 2 and 8;
    the heterogeneous one in both orders) through ``Simulator.run``,
    with their assertions;
  * further whole runs: iocoom at miss_chain 12 (the chain replay stands
    down), the knobs flipped (no speculative loads, one outstanding RFO,
    one-entry queues) at miss_chain 0 and 12 and under a mixed list,
    fast-forward configured but off under iocoom, and the
    ThreadScheduler at 16 streams on 8 tiles (the scoreboard clears at a
    rotation).

The cheapest whole run compares with the JAX package live; the others,
and the walk's outputs, hold to its pins (tests/torch_jax_ref.py).  The card's kernel-vs-plain
check of the iocoom operand sets is tests/test_torch_window.py's.
"""

import numpy as np
import pytest
import torch

from graphite_tpu_torch import convert, load_config
from graphite_tpu_torch.engine.kernels import operands as toperands
from graphite_tpu_torch.engine.kernels import window as twin
from graphite_tpu_torch.engine.sim import Simulator
from graphite_tpu_torch.engine.vparams import variant_params
from graphite_tpu_torch.events import synth
from graphite_tpu_torch.events.schema import TraceBuilder
from graphite_tpu_torch.params import SimParams

import torch_jax_ref as ref

MODULE = "test_torch_iocoom"
IOCOOM = {"tile/model_list": "<default,iocoom,T1,T1,T1>"}
SIMPLE = {"tile/model_list": "<default,simple,T1,T1,T1>"}
NO_QUEUE = {"dram/queue_model/enabled": False}
NOSPEC = {"core/iocoom/speculative_loads_enabled": False}
KNOBS = {**NOSPEC, "core/iocoom/multiple_outstanding_RFOs_enabled": False,
         "core/iocoom/num_load_queue_entries": 2,
         "core/iocoom/num_store_queue_entries": 1}
CHAIN12 = {"tpu/miss_chain": 12}


def _mixed(order, per=1):
    return {"tile/model_list": ", ".join(
        f"<{per},{c},T1,T1,T1>" for c in order)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params(T, over):
    from graphite_tpu.config import load_config as jax_load_config
    from graphite_tpu.params import SimParams as JaxSimParams
    cj, ct = jax_load_config(), load_config()
    for c in (cj, ct):
        c.set("general/total_cores", T)
        for k, v in over.items():
            c.set(k, v)
    return JaxSimParams.from_config(cj), SimParams.from_config(ct)


# ------------------------------------------------- the walk, op by op


WALK_CONFIGS = {
    "uniform": IOCOOM,
    "uniform_nospec": {**IOCOOM, **NOSPEC},
    "mixed_nospec": {**_mixed(("simple", "iocoom"), 4), **NOSPEC},
    "mixed_swapped_nospec": {**_mixed(("iocoom", "simple"), 4), **NOSPEC},
    "uniform_nospec_chain12": {**IOCOOM, **NOSPEC, **CHAIN12},
    "mixed_chain12": {**_mixed(("iocoom", "simple"), 4), **CHAIN12},
}


@pytest.mark.parametrize("config", sorted(WALK_CONFIGS))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_iocoom_walk_matches_jax(config, seed):
    import jax.numpy as jnp
    from graphite_tpu.engine.kernels import window as jwin
    from graphite_tpu.engine.vparams import variant_params as jax_vp
    jp, tp = _params(8, WALK_CONFIGS[config])
    a = toperands.iocoom_window_arrays(tp, tp.block_events, seed)
    tout = twin.window_walk(tp, variant_params(tp),
                            toperands.window_in_from_numpy(a, "cpu"), 8)

    def jax_out():
        jwi = jwin.WindowIn(**{
            f: (jnp.asarray(a[f]) if a.get(f) is not None else None)
            for f in jwin.WindowIn._fields})
        return ref.fields_of(tout, ref.eager(jwin.window_walk)(
            jp, jax_vp(jp), jwi, 8))

    ref.check_outputs(MODULE, tout, jax_out, {"params": repr(tp)}, a)


def test_iocoom_operands_reach_the_branches():
    """The seeded sets hold annotated hits, drain points whose queues
    complete after the clock, and retired SPAWNs and branches."""
    _, tp = _params(8, {**IOCOOM, **NOSPEC})
    seen = dict(annotated=0, late_drain=0, spawn=0, branch=0)
    for seed in range(3):
        a = toperands.iocoom_window_arrays(tp, tp.block_events, seed)
        op, _, arg2 = a["meta"]
        seen["annotated"] += int(((op == 1) & ((arg2 >> 20) != 0)).sum()
                                 + ((op == 2) & ((arg2 >> 8) & 31 != 0)).sum())
        drain = np.maximum(a["lq_ready"].max(0), a["sq_ready"].max(0))
        seen["late_drain"] += int((drain > a["clock"]).sum())
        out = twin.window_walk(tp, variant_params(tp),
                               toperands.window_in_from_numpy(a, "cpu"), 8)
        ret = np.arange(op.shape[1])[None, :] < out.n_ret.numpy()[:, None]
        seen["spawn"] += int(out.spawn_mask.sum())
        seen["branch"] += int(((op == 4) & ret).sum())
    assert all(v > 0 for v in seen.values()), seen


# ------------------------------------------------------------ whole runs


def _miss_compute(T, n_loads=4, cost=200):
    tb = TraceBuilder(T)
    for i in range(n_loads):
        tb.read(0, synth.SHARED_BASE + 64 * i, 8)
        tb.compute(0, cost_cycles=cost, icount=1)
    for t in range(1, T):
        tb.stall_until(t, 1)
    return tb.build()


def _one(op):
    def make(T):
        tb = TraceBuilder(T)
        getattr(tb, op)(0, synth.SHARED_BASE, 8)
        tb.stall_until(1, 1)
        return tb.build()
    return make


def _three_loads(T):
    tb = TraceBuilder(T)
    for i in range(3):
        tb.read(0, synth.SHARED_BASE + 64 * i, 8)
    tb.stall_until(1, 1)
    return tb.build()


def _raw(dep):
    def make(T):
        tb = TraceBuilder(T)
        tb.read(0, synth.SHARED_BASE, 8, dest_reg=5 if dep else None)
        tb.compute(0, cost_cycles=10, icount=1, src_reg=5 if dep else None)
        tb.stall_until(1, 1)
        return tb.build()
    return make


def _reg_chain(dep):
    def make(T):
        tb = TraceBuilder(T)
        tb.read(0, synth.SHARED_BASE, 8, dest_reg=1 if dep else None)
        tb.compute(0, 5, 1, src_reg=1 if dep else None,
                   dst_reg=2 if dep else None)
        tb.compute(0, 5, 1, src_reg=2 if dep else None,
                   dst_reg=3 if dep else None)
        tb.compute(0, 5, 1, src_reg=3 if dep else None)
        tb.stall_until(1, 1)
        return tb.build()
    return make


def _hit_load(T):
    tb = TraceBuilder(T)
    tb.read(0, synth.PRIVATE_BASE, 8)
    tb.read(0, synth.PRIVATE_BASE, 8, dest_reg=7)
    tb.compute(0, 5, 1, src_reg=7)
    tb.stall_until(1, 1)
    return tb.build()


def _two_tile_miss_compute(T, n_loads=4, cost=200):
    tb = TraceBuilder(T)
    for t in range(2):
        base = synth.PRIVATE_BASE + t * 0x10000
        for i in range(n_loads):
            tb.read(t, base + 64 * i, 8)
            tb.compute(t, cost_cycles=cost, icount=1)
    return tb.build()


def _threads_regs(S):
    """gen_threads_oversubscribed's shape (parents spawn and join a
    child each; children start gated and YIELD) with register-annotated
    loads and computes on both halves, so a rotation leaves the
    outgoing stream's register writes pending in the scoreboard."""
    half = S // 2
    tb = TraceBuilder(S)
    for s in range(half):
        base = synth.PRIVATE_BASE + s * synth.PRIVATE_SPAN
        tb.compute(s, 100, 100)
        tb.spawn(s, half + s, cost_cycles=10)
        for b in range(6):
            tb.read(s, synth.SHARED_BASE + 64 * (b + 8 * s), 8,
                    dest_reg=b % 4)
            tb.compute(s, 50, 50, src_reg=(b + 3) % 4, dst_reg=4)
            tb.write(s, base + 64 * b)
        tb.join(s, half + s)
        tb.done(s)
    for s in range(half, S):
        tb.thread_start(s)
        base = synth.PRIVATE_BASE + s * synth.PRIVATE_SPAN
        for b in range(6):
            tb.read(s, synth.SHARED_BASE + 64 * (b + 8 * s), 8,
                    dest_reg=(b + 1) % 4)
            tb.compute(s, 80, 80, src_reg=b % 4, dst_reg=(b + 2) % 4)
            if b % 2 == 0:
                tb.thread_yield(s)
        tb.done(s)
    return tb.build()


def _radix8(T):
    return synth.gen_radix(8, keys_per_tile=128, radix=64)


def _radix8_small(T):
    return synth.gen_radix(8, keys_per_tile=32, radix=16, seed=1)


def _scoreboard8(T):
    return synth.gen_scoreboard(8, rounds=4, seed=2)


# name: (tiles, trace, config overrides)
RUNS = {
    # tests/test_iocoom.py's shapes (T = 2, the radix one at T = 8).
    "miss_compute_simple": (2, _miss_compute, SIMPLE),
    "miss_compute_iocoom": (2, _miss_compute, IOCOOM),
    "done_drain_simple": (2, _one("read"), SIMPLE),
    "done_drain_iocoom": (2, _one("read"), IOCOOM),
    "atomic_simple": (2, _one("atomic"), SIMPLE),
    "atomic_iocoom": (2, _one("atomic"), IOCOOM),
    "lq_one_entry": (2, _three_loads,
                     {**IOCOOM, "core/iocoom/num_load_queue_entries": 1}),
    "lq_wide": (2, _three_loads, IOCOOM),
    "radix8_simple": (8, _radix8, SIMPLE),
    "radix8_iocoom": (8, _radix8, IOCOOM),
    "raw_dep": (2, _raw(True), IOCOOM),
    "raw_free": (2, _raw(False), IOCOOM),
    "reg_chain_dep": (2, _reg_chain(True), IOCOOM),
    "reg_chain_free": (2, _reg_chain(False), IOCOOM),
    "hit_load": (2, _hit_load, IOCOOM),
    "hetero_simple": (2, _two_tile_miss_compute, {**SIMPLE, **NO_QUEUE}),
    "hetero_iocoom": (2, _two_tile_miss_compute, {**IOCOOM, **NO_QUEUE}),
    "hetero_mixed": (2, _two_tile_miss_compute,
                     {**_mixed(("simple", "iocoom")), **NO_QUEUE}),
    "hetero_swapped": (2, _two_tile_miss_compute,
                       {**_mixed(("iocoom", "simple")), **NO_QUEUE}),
    # Further cases.
    "radix8_iocoom_chain12": (8, _radix8_small, {**IOCOOM, **CHAIN12}),
    "scoreboard8_knobs": (8, _scoreboard8, {**IOCOOM, **KNOBS}),
    "scoreboard8_knobs_chain12": (8, _scoreboard8,
                                  {**IOCOOM, **KNOBS, **CHAIN12}),
    "scoreboard8_mixed_chain12": (8, _scoreboard8, {
        **_mixed(("iocoom", "simple"), 4), **NOSPEC, **CHAIN12}),
    "scoreboard8_ff_off": (8, _scoreboard8, {
        **IOCOOM, "tpu/fast_forward": 2, "tpu/fast_forward_span": 1000}),
    "threads16on8_iocoom": (8, lambda T: _threads_regs(16), {
        **IOCOOM, "general/max_threads_per_core": 2}),
}
LIVE = ("raw_dep",)
MAX_STEPS = 4096
_DONE = {}


def _run(name):
    """The port's run of case ``name``, held to the JAX package's leaves;
    returns its flat leaves."""
    if name in _DONE:
        return _DONE[name]
    T, make, over = RUNS[name]
    jp, tp = _params(T, over)
    trace = make(T)
    sim = Simulator(tp, trace, device="cpu")
    sim.run(max_steps=MAX_STEPS)
    assert bool(sim.state.all_done())

    def jax_leaves():
        import jax
        from graphite_tpu.engine.sim import Simulator as JaxSimulator
        from graphite_tpu.events.schema import Trace as JTrace
        jsim = JaxSimulator(jp, JTrace(ops=trace.ops, addr=trace.addr,
                                       arg=trace.arg, arg2=trace.arg2))
        jsim.run(max_steps=MAX_STEPS)
        return convert.leaves_to_numpy(jax.device_get(jsim.state))

    leaves = convert.state_to_numpy(sim.state)
    ref.check(MODULE, name, leaves, jax_leaves,
              ref.inputs({"general/total_cores": T, **over}, trace,
                         steps=MAX_STEPS), live=name in LIVE)
    _DONE[name] = leaves
    return leaves


def _clock(name, tile=0):
    return int(_run(name)["clock"][tile])


def _sum(name, leaf):
    return int(_run(name)[leaf].sum())


@pytest.mark.parametrize("name", sorted(RUNS))
def test_iocoom_run_matches_jax(name):
    _run(name)


def test_iocoom_hides_miss_latency_behind_compute():
    assert _clock("miss_compute_iocoom") < _clock("miss_compute_simple")
    for f in ("l2_miss", "dram_reads", "dir_sh_req"):
        assert _sum("miss_compute_iocoom", f"counters.{f}") \
            == _sum("miss_compute_simple", f"counters.{f}"), f


def test_iocoom_done_drains_outstanding_loads():
    assert _clock("done_drain_iocoom") == _clock("done_drain_simple")


def test_iocoom_atomic_waits_full_latency():
    assert _clock("atomic_iocoom") == _clock("atomic_simple")


def test_iocoom_lq_backpressure():
    assert _clock("lq_wide") < _clock("lq_one_entry")


def test_iocoom_radix_runs_and_beats_simple_time():
    assert _sum("radix8_iocoom", "counters.icount") \
        == _sum("radix8_simple", "counters.icount")
    assert int(_run("radix8_iocoom")["clock"].max()) \
        <= int(_run("radix8_simple")["clock"].max())


def test_register_scoreboard_raw_stall():
    assert _clock("raw_dep") > _clock("raw_free")


def test_register_scoreboard_chain():
    assert _clock("reg_chain_dep") > _clock("reg_chain_free")


def test_scoreboard_hit_load_feeds_register():
    lv = _run("hit_load")
    assert lv["done"].all()
    # The hitting load wrote r7 (at its hit completion).
    assert lv["reg_ready"][7, 0] > 0


def test_heterogeneous_tiles_run_their_own_model():
    simple = _run("hetero_simple")["clock"]
    ioc = _run("hetero_iocoom")["clock"]
    mixed = _run("hetero_mixed")["clock"]
    swapped = _run("hetero_swapped")["clock"]
    assert ioc[1] < simple[1]
    assert mixed[0] == simple[0] and mixed[1] == ioc[1]
    assert swapped[0] == ioc[0] and swapped[1] == simple[1]


def test_chain_replay_stands_down_under_iocoom():
    lv = _run("radix8_iocoom_chain12")
    assert lv["counters.chain_fanout_served"].sum() == 0
    assert lv["counters.chain_fallback"].sum() == 0
    assert int(lv["ctr_conflict"]) > 0


def test_knobs_move_the_timing():
    """No speculative loads, one outstanding RFO and short queues make
    the scoreboard trace slower than the defaults' widths would."""
    lv = _run("scoreboard8_knobs")
    assert lv["lq_ready"].shape == (2, 8) and lv["sq_ready"].shape == (1, 8)
    assert int(lv["lq_next"].sum()) > 0 and int(lv["sq_next"].sum()) > 0


def test_engine_hands_the_kernel_its_operands():
    """The window operands the engine assembles under iocoom, after
    resolve passes have written the load/store rings, pass the CUDA
    wrapper's checks (dtype, shape, contiguity, no aliasing)."""
    from graphite_tpu_torch.engine import quantum
    from graphite_tpu_torch.engine.core import window_operands
    T, make, over = RUNS["scoreboard8_knobs"]
    _, tp = _params(T, over)
    sim = Simulator(tp, make(T), device="cpu")
    st = quantum.megarun(tp, sim.state, sim.trace, 6)
    assert int(st.lq_next.sum()) > 0 and int(st.sq_next.sum()) > 0
    _, wi = window_operands(tp, st, sim.trace, sim.vp)
    twin._check_inputs(tp, wi)


def test_fast_forward_off_under_iocoom():
    lv = _run("scoreboard8_ff_off")
    assert int(lv["ctr_ff"]) == 0 and int(lv["ff_events"]) == 0


def test_scheduler_clears_the_scoreboard():
    """The parents' loads and computes write registers before they join
    their children; the rotations to the children and back clear each
    tile's scoreboard, so none is left at the end."""
    lv = _run("threads16on8_iocoom")
    assert lv["reg_ready"].shape == (32, 8)
    assert lv["done"].all() and lv["strm_done"][8:].all()
    assert (lv["reg_ready"] == 0).all()
