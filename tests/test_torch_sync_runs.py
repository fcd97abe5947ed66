"""PyTorch port, whole runs of the synchronisation, CAPI, thread and
system-event kinds against the JAX package on the CPU, one stream per
tile.  Each run ends with every SimState leaf equal to the JAX package's
(tolerance 0, the round counters included), or raises DeadlockError at
the same step with every leaf equal:

  * the hand-built traces of tests/test_threads_cond.py (all eleven:
    cond wake-up timing, lost signals, broadcasts, spawn gates, joins,
    a broadcast while holding the mutex, the deadlocks),
    tests/test_syscall.py (the golden READ, the classes, the ROI gate),
    tests/test_vm.py (the [vm] section and its absence) and
    tests/test_scheduler.py's one-stream-per-tile run at two
    max_threads_per_core settings;
  * lock contention and ping-pong under the default mesh, ATAC and the
    contended hop-by-hop user mesh (SEND's flight over the user links),
    and a fan-in of messages whose flights wait on shared links;
  * gen_threads_oversubscribed at one stream per tile (SPAWN, JOIN,
    THREAD_START, YIELD) at miss_chain 0 and 12;
  * synth.gen_system_events (ATOMICs, cond pairs, every SYSCALL class,
    DVFS_SET, the ROI markers, STALL and SYNC) at T = 8 under
    ``tpu/fast_forward = 8`` (span 1000 ns) at miss_chain 12, the
    configuration of chip_smoke.py's sysev64_ff path, and at miss_chain
    0 without fast-forward.

Cases run through ``Simulator.run``, ``run_simulation`` or ``cli run``.
The cases in ``LIVE`` run the JAX package live (their rendered summary
is held to the JAX package's too); the others hold the JAX package's
recorded pins (tests/torch_jax_ref.py).
"""

import numpy as np
import pytest
import torch

import jax

from graphite_tpu.config import load_config as jax_load_config
from graphite_tpu.engine.sim import DeadlockError as JaxDeadlockError
from graphite_tpu.engine.sim import Simulator as JaxSimulator
from graphite_tpu.events import synth as jax_synth
from graphite_tpu.events.schema import TraceBuilder as JaxTraceBuilder
from graphite_tpu.params import SimParams as JaxSimParams
from graphite_tpu_torch import cli, convert, load_config
from graphite_tpu_torch.engine.sim import (DeadlockError, Simulator,
                                           run_simulation)
from graphite_tpu_torch.events import synth as tsynth
from graphite_tpu_torch.events.schema import TraceBuilder
from graphite_tpu_torch.isa import SyscallClass
from graphite_tpu_torch.params import SimParams

import torch_jax_ref as ref

MODULE = "test_torch_sync_runs"
MAX_STEPS = 4096


# ------------------------------------------- hand-built traces (builders)
# Each takes a TraceBuilder class, so that both packages build the same
# arrays.

def producer_consumer(TB):
    tb = TB(4)
    tb.mutex_lock(0, 0)
    tb.cond_wait(0, 0, 0)
    tb.mutex_unlock(0, 0)
    tb.stall_until(1, 8_000_000)
    tb.mutex_lock(1, 0)
    tb.cond_signal(1, 0)
    tb.mutex_unlock(1, 0)
    return tb.build()


def signal_before_wait_is_lost(TB):
    tb = TB(2)
    tb.cond_signal(1, 0)
    tb.stall_until(0, 50_000_000)
    tb.mutex_lock(0, 0)
    tb.cond_wait(0, 0, 0)
    tb.mutex_unlock(0, 0)
    return tb.build()


def broadcast_wakes_all(TB):
    tb = TB(4)
    for t in range(3):
        tb.mutex_lock(t, t)
        tb.cond_wait(t, 0, t)
        tb.mutex_unlock(t, t)
    tb.stall_until(3, 10_000_000)
    tb.cond_broadcast(3, 0)
    return tb.build()


def signal_wakes_exactly_one(TB):
    tb = TB(4)
    for t in (0, 1):
        tb.mutex_lock(t, t)
        tb.cond_wait(t, 0, t)
        tb.mutex_unlock(t, t)
    tb.stall_until(2, 10_000_000)
    tb.cond_signal(2, 0)
    tb.stall_until(3, 30_000_000)
    tb.cond_signal(3, 0)
    return tb.build()


def spawn_gates_thread_start(TB):
    tb = TB(2)
    tb.thread_start(1)
    tb.compute(1, 100, 10)
    tb.stall_until(0, 5_000_000)
    tb.spawn(0, 1, cost_cycles=200)
    return tb.build()


def join_blocks_until_child_done(TB):
    tb = TB(2)
    tb.thread_start(1)
    tb.stall_until(1, 20_000_000)
    tb.done(1)
    tb.spawn(0, 1)
    tb.join(0, 1)
    return tb.build()


def unspawned_thread_deadlocks(TB):
    tb = TB(2)
    tb.thread_start(1)
    tb.compute(0, 10, 1)
    return tb.build()


def broadcast_then_signal_interleave(TB):
    tb = TB(5)
    for t in (0, 1):
        tb.mutex_lock(t, t)
        tb.cond_wait(t, 0, t)
        tb.mutex_unlock(t, t)
    tb.stall_until(2, 30_000_000)
    tb.mutex_lock(2, 2)
    tb.cond_wait(2, 0, 2)
    tb.mutex_unlock(2, 2)
    tb.stall_until(3, 20_000_000)
    tb.cond_broadcast(3, 0)
    tb.stall_until(4, 40_000_000)
    tb.cond_signal(4, 0)
    return tb.build()


def early_signal_lost_later_signal_wakes(TB):
    tb = TB(4)
    tb.cond_signal(3, 0)
    tb.done(3)
    tb.stall_until(0, 10_000_000)
    tb.mutex_lock(0, 0)
    tb.cond_wait(0, 0, 0)
    tb.mutex_unlock(0, 0)
    tb.done(0)
    tb.stall_until(1, 12_000_000)
    tb.mutex_lock(1, 1)
    tb.cond_wait(1, 0, 1)
    tb.mutex_unlock(1, 1)
    tb.done(1)
    tb.stall_until(2, 30_000_000)
    tb.cond_signal(2, 0)
    tb.done(2)
    return tb.build()


def fork_join_broadcast_holding_mutex(TB):
    tb = TB(4)
    for w in (1, 2):
        tb.thread_start(w)
        tb.mutex_lock(w, 0)
        tb.cond_wait(w, 0, 0)
        tb.mutex_unlock(w, 0)
        tb.compute(w, 500, 100)
        tb.done(w)
    tb.spawn(0, 1)
    tb.spawn(0, 2)
    tb.stall_until(0, 10_000_000)
    tb.mutex_lock(0, 0)
    tb.cond_broadcast(0, 0)
    tb.mutex_unlock(0, 0)
    tb.join(0, 1)
    tb.join(0, 2)
    return tb.build()


def cond_lifecycle(TB):
    tb = TB(4)
    for t in (0, 1):
        tb.mutex_lock(t, 0)
        tb.cond_wait(t, 0, 0)
        tb.mutex_unlock(t, 0)
    tb.stall_until(2, 10_000_000)
    tb.cond_broadcast(2, 0)
    return tb.build()


def syscall_read(TB):
    tb = TB(1)
    tb.syscall(0, SyscallClass.READ, nbytes=64)
    return tb.build()


def syscall_classes(TB):
    tb = TB(4)
    tb.syscall(0, SyscallClass.OPEN)
    tb.syscall(1, SyscallClass.WRITE, nbytes=4096)
    tb.syscall(1, SyscallClass.WRITE, nbytes=0)
    return tb.build()


def syscall_open(TB):
    tb = TB(1)
    tb.syscall(0, SyscallClass.OPEN)
    return tb.build()


def vm_syscalls(TB):
    tb = TB(2)
    tb.syscall(0, SyscallClass.MMAP, nbytes=40, vm_arg=4096)
    tb.syscall(0, SyscallClass.BRK, nbytes=8, vm_arg=1 << 16)
    tb.syscall(1, SyscallClass.MMAP, nbytes=40, vm_arg=8192)
    tb.syscall(1, SyscallClass.MUNMAP, nbytes=16, vm_arg=8192)
    return tb.build()


def no_vm_syscalls(TB):
    tb = TB(2)
    tb.compute(0, 5, 1)
    tb.compute(1, 5, 1)
    return tb.build()


def fan_in(TB):
    """Every tile messages tile 0 at once and tile 0 answers each: the
    sends into tile 0 share the links next to it."""
    tb = TB(8)
    for t in range(1, 8):
        tb.send(t, 0, 256)
        tb.recv(t, 0, 64)
    for t in range(1, 8):
        tb.recv(0, t, 256)
        tb.send(0, t, 64)
    return tb.build()


def system_events(T):
    def build(TB):
        return tsynth.gen_system_events(T, seed=0, builder=TB)
    return build


def synth(fn, **kw):
    """A generator of both packages' synth modules (gen_system_events is
    the port's own, given each package's TraceBuilder)."""
    def build(TB):
        mod = jax_synth if TB is JaxTraceBuilder else tsynth
        return getattr(mod, fn)(**kw)
    return build


HBH_USER = {"network/user": "emesh_hop_by_hop",
            "network/emesh_hop_by_hop/queue_model/enabled": True}
ATAC = {"network/memory": "atac", "network/user": "atac"}
FF_CHAIN = {"tpu/fast_forward": 8, "tpu/fast_forward_span": 1000,
            "tpu/miss_chain": 12}
LOCK4 = synth("gen_lock_contention", num_tiles=4, acquisitions=2)
PING4 = synth("gen_ping_pong", num_tiles=4, messages=2)
LOCK8 = synth("gen_lock_contention", num_tiles=8, acquisitions=3,
              critical_cycles=40)
PING8 = synth("gen_ping_pong", num_tiles=8, messages=4, size=64)
THREADS8 = synth("gen_threads_oversubscribed", num_streams=8,
                 compute_blocks=3, cost_cycles=100, yields=2)
RADIX4 = synth("gen_radix", num_tiles=4, keys_per_tile=16, radix=8, seed=2)

# name: (builder, config overrides, entry point, deadlocks)
RUNS = {
    # tests/test_threads_cond.py
    "producer_consumer": (producer_consumer, {}, "run_simulation", False),
    "signal_before_wait_is_lost": (signal_before_wait_is_lost, {},
                                   "simulator", True),
    "broadcast_wakes_all": (broadcast_wakes_all, {}, "run_simulation",
                            False),
    "signal_wakes_exactly_one": (signal_wakes_exactly_one, {},
                                 "run_simulation", False),
    "spawn_gates_thread_start": (spawn_gates_thread_start, {},
                                 "run_simulation", False),
    "join_blocks_until_child_done": (join_blocks_until_child_done, {},
                                     "run_simulation", False),
    "unspawned_thread_deadlocks": (unspawned_thread_deadlocks, {},
                                   "simulator", True),
    "broadcast_then_signal_interleave": (broadcast_then_signal_interleave,
                                         {}, "run_simulation", False),
    "early_signal_lost_later_signal_wakes": (
        early_signal_lost_later_signal_wakes, {}, "simulator", True),
    "fork_join_broadcast_holding_mutex": (fork_join_broadcast_holding_mutex,
                                          {}, "cli", False),
    "cond_lifecycle": (cond_lifecycle, {}, "run_simulation", False),
    # tests/test_syscall.py
    "syscall_golden_read": (syscall_read, {"syscall/read_cost": 2000},
                            "run_simulation", False),
    "syscall_classes_and_network": (syscall_classes, {}, "cli", False),
    "syscall_roi_gated": (syscall_open, {
        "general/trigger_models_within_application": "true"},
        "run_simulation", False),
    # tests/test_vm.py
    "vm_accounts_syscalls": (vm_syscalls, {}, "cli", False),
    "vm_section_absent": (no_vm_syscalls, {}, "run_simulation", False),
    # tests/test_scheduler.py: one stream per tile at either setting
    "radix4_threads_per_core_1": (RADIX4, {
        "general/max_threads_per_core": 1}, "run_simulation", False),
    "radix4_threads_per_core_4": (RADIX4, {
        "general/max_threads_per_core": 4}, "run_simulation", False),
    # the kinds the port used to refuse, in the shapes it refused them
    "lock4": (LOCK4, {}, "cli", False),
    "ping4": (PING4, {}, "cli", False),
    "ping4_hbh_user": (PING4, HBH_USER, "cli", False),
    # lock contention and ping-pong under each network
    "lock8": (LOCK8, {}, "simulator", False),
    "lock8_atac": (LOCK8, ATAC, "run_simulation", False),
    "lock8_hbh_user": (LOCK8, HBH_USER, "simulator", False),
    "ping8": (PING8, {}, "run_simulation", False),
    "ping8_atac": (PING8, ATAC, "simulator", False),
    "ping8_hbh_user": (PING8, HBH_USER, "run_simulation", False),
    # (ping-pong pairs are mesh neighbours: their packets never share a
    # link; a fan-in's do)
    "fan_in8_hbh_user": (fan_in, HBH_USER, "simulator", False),
    # threads at one stream per tile
    "threads8": (THREADS8, {}, "run_simulation", False),
    "threads8_chain12": (THREADS8, {"tpu/miss_chain": 12}, "cli", False),
    # the system events
    "sysev8": (system_events(8), {}, "run_simulation", False),
    "sysev8_ff_chain12": (system_events(8), FF_CHAIN, "simulator", False),
}
LIVE = ("producer_consumer",)


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


def _run(sim, deadlock_error):
    """Run to the end: (summary or None, the step the run stopped at,
    whether it raised the deadlock error)."""
    try:
        return sim.run(max_steps=MAX_STEPS), sim.steps, False
    except deadlock_error:
        return None, sim.steps, True


def _with_run(leaves, s, steps, stuck):
    out = dict(leaves)
    out["steps"] = np.asarray(steps, np.int64)
    out["deadlocked"] = np.asarray(stuck)
    if s is not None:
        out["completion_ps"] = np.asarray(s.completion_time_ps, np.int64)
    return out


def _summary_lines(text):
    """The rendered summary without its host-time lines."""
    return [ln for ln in text.splitlines()
            if "Host Time" not in ln and "Simulated MIPS" not in ln]


def _entry_point(entry, tp, over, ttrace, tmp_path):
    """The case's user entry point on the same trace: (the summary's
    completion and per-tile counters, or the rendered text)."""
    if entry == "run_simulation":
        s = run_simulation(tp, ttrace, max_steps=MAX_STEPS, device="cpu")
        return (s.completion_time_ps, s.counters), None
    path = str(tmp_path / "t.npz")
    ttrace.save(path)
    out = str(tmp_path / "sim.out")
    args = ["run", "--trace", path, "--device", "cpu", "-o", out] + [
        f"--{k}={str(v).lower() if isinstance(v, bool) else v}"
        for k, v in over.items()]
    assert cli.main(args) == 0
    return None, open(out).read()


@pytest.mark.parametrize("name", sorted(RUNS))
def test_sync_run_matches_jax(name, tmp_path):
    build, over, entry, deadlocks = RUNS[name]
    ttrace = build(TraceBuilder)
    T = ttrace.num_tiles
    jp, tp = _params(T, over)
    tsim = Simulator(tp, ttrace, device="cpu")
    tsum, tsteps, tstuck = _run(tsim, DeadlockError)
    assert tstuck == deadlocks
    jrun = {}

    def jax_leaves():
        jtrace = build(JaxTraceBuilder)
        for f in ("ops", "addr", "arg", "arg2"):
            assert getattr(jtrace, f).tobytes() == \
                getattr(ttrace, f).tobytes(), f
        jsim = JaxSimulator(jp, jtrace)
        jsum, jsteps, jstuck = _run(jsim, JaxDeadlockError)
        jrun["summary"] = jsum
        return _with_run(convert.leaves_to_numpy(jax.device_get(jsim.state)),
                         jsum, jsteps, jstuck)

    jleaves = ref.check(
        MODULE, name,
        _with_run(convert.state_to_numpy(tsim.state), tsum, tsteps, tstuck),
        jax_leaves, ref.inputs({"general/total_cores": T, **over}, ttrace,
                               steps=MAX_STEPS), live=name in LIVE)
    if jrun.get("summary") is not None:
        # A live run: the rendered summary and its dict are the JAX
        # package's, the host-time lines aside.
        assert _summary_lines(tsum.render()) \
            == _summary_lines(jrun["summary"].render())
        td, jd = tsum.to_dict(), jrun["summary"].to_dict()
        for k in ("host_seconds", "simulated_mips"):
            td.pop(k), jd.pop(k)
        assert td == jd
    if deadlocks:
        assert not bool(tsim.state.done.all())
        return
    assert bool(tsim.state.done.all())
    completion_ps = int(jleaves["completion_ps"])
    if entry != "simulator":
        got, text = _entry_point(entry, tp, over, ttrace, tmp_path)
        if text is None:
            ps, counters = got
            assert ps == completion_ps
            for k in counters:
                np.testing.assert_array_equal(
                    jleaves[f"counters.{k}"], counters[k], err_msg=k)
        else:
            assert f"Completion Time (in ns){' ' * 23}: " \
                   f"{completion_ps / 1000:.1f}" in text
            assert f"Streams Completed{' ' * 29}: {T} / {T}" in text
            assert ("[vm]" in text) == (name == "vm_accounts_syscalls")
    if name == "vm_accounts_syscalls":
        vm = tsum.vm_summary()
        assert vm["mmap_bytes"] == 4096 + 8192
        assert vm["munmap_bytes"] == 8192
        assert vm["data_segment_bytes"] == 1 << 16
        assert int(tsum.counters["syscalls"].sum()) == 4
    if name == "vm_section_absent":
        assert tsum.vm_summary() is None and "[vm]" not in tsum.render()
    if name.startswith("fan_in"):
        assert int(jleaves["counters.net_link_wait_ps"].sum()) > 0
        assert (jleaves["link_free_user"] > 0).any()
    if name == "syscall_roi_gated":
        assert int(tsum.counters["syscalls"].sum()) == 0


def test_one_stream_per_tile_ignores_threads_per_core():
    """tests/test_scheduler.py: a trace with as many streams as tiles
    runs the same at any max_threads_per_core (the scheduler's seats
    engage only with more streams than tiles)."""
    a = RUNS["radix4_threads_per_core_1"]
    b = RUNS["radix4_threads_per_core_4"]
    sa = run_simulation(_params(4, a[1])[1], a[0](TraceBuilder),
                        device="cpu")
    sb = run_simulation(_params(4, b[1])[1], b[0](TraceBuilder),
                        device="cpu")
    assert sa.completion_time_ps == sb.completion_time_ps
    for k in sa.counters:
        np.testing.assert_array_equal(sa.counters[k], sb.counters[k], k)
