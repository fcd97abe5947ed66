"""Host-side simulation driver + end-of-run summary.

Counterpart of ``graphite_tpu/engine/sim.py``: ``Simulator`` builds the
device trace and the initial state, ``run`` drives ``megarun`` in polling
windows with the same no-progress ``DeadlockError`` check, and
``SimSummary`` renders the same ``sim.out``-style report and dict.

``device=None`` means CUDA: with no GPU present the constructor raises
instead of falling back to the CPU.  Configurations and trace events
outside this slice of the port raise ``NotImplementedError`` at
construction (:func:`check_slice`), naming the slice that ports them.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from graphite_tpu_torch.config import Config
from graphite_tpu_torch.engine.kernels import dispatch
from graphite_tpu_torch.engine.kernels.chain import check_chain_config
from graphite_tpu_torch.engine.kernels.window import MAX_WINDOW
from graphite_tpu_torch.engine.quantum import megarun
from graphite_tpu_torch.engine.state import SimState, TraceArrays, make_state
from graphite_tpu_torch.engine.vparams import variant_params
from graphite_tpu_torch.events.schema import Trace
from graphite_tpu_torch.isa import EventOp
from graphite_tpu_torch.params import SimParams
from graphite_tpu_torch.time_base import ps_to_ns

# Where more trace streams than tiles (the ThreadScheduler's seats) will
# run.
SCHEDULER_SLICE = "the ThreadScheduler slice (model breadth 3a-ii)"


def check_slice(params: SimParams, trace: Optional[Trace] = None,
                device=None) -> None:
    """Refuse, loudly, every configuration and event kind the port does
    not run yet — nothing is mispriced silently.  Admitted: simple cores,
    every coherence protocol (private L1/L2 under MSI or MOSI, shared L2
    under MSI or MESI) with a full-map directory, every network model on
    the memory and user networks (magic, emesh_hop_counter, atac under
    either routing strategy and receive network, emesh_hop_by_hop with
    its queue model off or on: contended link flights on the memory
    network, and SEND's flight on a hop-by-hop user network), the
    history DRAM queue (on or off), ``tpu/miss_chain`` 0 to 256 with the
    fan-out replay on or off, ``tpu/fast_forward`` at any width and
    run-ahead span, any tile count the directory's owner field holds
    (state.py), and every event kind (the sync, CAPI, thread, ROI, DVFS
    and syscall kinds among them) at one trace stream per tile.  More
    streams than tiles waits for the ThreadScheduler slice.  On a CUDA ``device`` the chain replay is also held to the
    classify kernel's limits (kernels/chain.check_chain_config)."""
    def later(what, where="a later slice (model breadth)"):
        raise NotImplementedError(
            f"{what} is not ported yet: it belongs to {where} of the "
            f"PyTorch port")

    if params.core.model != "simple" or params.core.mixed:
        later("the iocoom core model")
    if params.tile_shards > 1 or params.shard_state != "replicated":
        later("tile sharding (tpu/tile_shards > 1, resident shard state)",
              "the multi-device slice")
    if params.segment_events > 0:
        later("streaming trace ingest (trace/segment_events > 0)",
              "the run-lifecycle slice")
    if params.directory.directory_type != "full_map":
        later(f"the {params.directory.directory_type!r} directory scheme")
    if params.dram.queue_model_type != "history_tree":
        later(f"the {params.dram.queue_model_type!r} DRAM queue model")
    if (params.stats_enabled or params.progress_enabled
            or params.power_trace_enabled or params.telemetry_enabled):
        later("telemetry sampling and the statistics ring",
              "the run-lifecycle slice")
    if params.track_miss_types:
        later("miss-type classification ([cache]/track_miss_types)")
    if params.miss_chain > 0:
        check_chain_config(params, device)
    if params.block_events > MAX_WINDOW:
        later(f"tpu/block_events > {MAX_WINDOW}")
    if trace is not None:
        if trace.num_tiles != params.num_tiles:
            later("more trace streams than tiles", SCHEDULER_SLICE)


class SimSummary:
    """Counter roll-up with sim.out-style rendering."""

    def __init__(self, params: SimParams, state: SimState,
                 host_seconds: float, steps: int):
        self.params = params
        self.host_seconds = host_seconds
        self.steps = steps
        self.quanta = int(state.ctr_quantum.item())
        self.clock = state.clock.cpu().numpy()
        # Per-stream done (one stream per tile in this slice).
        self.done = state.done.cpu().numpy()
        self.period_ps = state.period_ps.cpu().numpy()
        self.counters: Dict[str, np.ndarray] = {
            f: getattr(state.counters, f).cpu().numpy()
            for f in state.counters._fields
        }
        self.vm_brk = int(state.vm_brk.item())
        self.vm_mmap_bytes = int(state.vm_mmap_bytes.item())
        self.vm_munmap_bytes = int(state.vm_munmap_bytes.item())
        # Fast-forward attribution: analytic and wide rounds that beat a
        # narrow round, the quanta they ran in, and the events they
        # retired beyond it (all zero when tpu/fast_forward = 0).
        self.ff_rounds = int(state.ctr_ff.item())
        self.ff_quanta = int(state.ctr_ffq.item())
        self.ff_events = int(state.ff_events.item())

    # ------------------------------------------------------------ metrics

    @property
    def completion_time_ps(self) -> int:
        return int(self.clock.max())

    @property
    def total_instructions(self) -> int:
        return int(self.counters["icount"].sum())

    @property
    def simulated_mips(self) -> float:
        if self.host_seconds <= 0:
            return float("inf")
        return self.total_instructions / self.host_seconds / 1e6

    def energy(self):
        """Analytic McPAT/DSENT-shaped energy breakdown (graphite_tpu_torch.
        energy) on the final counters at each module's current V/f."""
        from graphite_tpu_torch.energy import compute_energy
        return compute_energy(self.params, self.counters,
                              self.completion_time_ps, self.period_ps)

    def to_dict(self) -> Dict:
        agg = {k: int(v.sum()) for k, v in self.counters.items()}
        out = {
            "num_tiles": self.params.num_tiles,
            "completion_time_ns": ps_to_ns(self.completion_time_ps),
            "host_seconds": self.host_seconds,
            "device_steps": self.steps,
            "quanta": self.quanta,
            "total_instructions": self.total_instructions,
            "simulated_mips": self.simulated_mips,
            "all_done": bool(self.done.all()),
            # Per-stream completion (VERDICT weak #9): how many of the
            # trace's streams retired DONE — with the ThreadScheduler
            # this counts descheduled streams too, so a stuck run shows
            # WHICH fraction finished instead of one false/true.
            "streams_done": int(self.done.sum()),
            "num_streams": int(self.done.shape[0]),
            "aggregate": agg,
        }
        if self.params.fast_forward > 0:
            out["ff_rounds"] = self.ff_rounds
            out["ff_quanta"] = self.ff_quanta
            out["ff_events"] = self.ff_events
            out["ff_quanta_frac"] = round(
                self.ff_quanta / max(self.quanta, 1), 4)
        if self.params.enable_power_modeling:
            out["energy"] = self.energy().to_dict()
        vm_sec = self.vm_summary()
        if vm_sec is not None:
            out["vm"] = vm_sec
        return out

    def vm_summary(self):
        """Simulated address-space accounting (engine/vm.summarize;
        reference vm_manager.cc segments) — None when the trace made no
        memory-management syscalls."""
        from graphite_tpu_torch.engine import vm as vmmod
        return vmmod.summarize(
            self.params.num_tiles, self.params.stack_base,
            self.params.stack_size_per_core, self.vm_brk,
            self.vm_mmap_bytes, self.vm_munmap_bytes)

    def render(self) -> str:
        c = self.counters
        agg = {k: v.sum() for k, v in c.items()}
        lines = []
        w = 46
        def row(k, v):
            lines.append(f"    {k:<{w}}: {v}")
        lines.append("[general]")
        row("Total Tiles", self.params.num_tiles)
        row("Completion Time (in ns)", f"{ps_to_ns(self.completion_time_ps):.1f}")
        row("Streams Completed",
            f"{int(self.done.sum())} / {int(self.done.shape[0])}")
        row("Total Instructions", agg["icount"])
        row("Host Time (in s)", f"{self.host_seconds:.3f}")
        row("Simulated MIPS", f"{self.simulated_mips:.3f}")
        if self.params.fast_forward > 0:
            lines.append("[fast_forward]")
            row("Analytic Rounds", self.ff_rounds)
            row("Fast-Forwarded Quanta",
                f"{self.ff_quanta} / {self.quanta}")
            row("Events Priced In Closed Form", self.ff_events)
        lines.append("[core]")
        row("Total Instructions", agg["icount"])
        row("Branches", agg["branches"])
        row("Branch Mispredictions", agg["mispredicts"])
        lines.append("[l1_icache]")
        row("Cache Accesses", agg["l1i_access"])
        row("Cache Misses", agg["l1i_miss"])
        lines.append("[l1_dcache]")
        row("Read Accesses", agg["l1d_read"])
        row("Read Misses", agg["l1d_read_miss"])
        row("Write Accesses", agg["l1d_write"])
        row("Write Misses", agg["l1d_write_miss"])
        lines.append("[l2_cache]")
        row("Cache Accesses", agg["l2_access"])
        row("Cache Misses", agg["l2_miss"])
        if self.params.track_miss_types:
            row("Cold Misses", agg["l2_miss_cold"])
            row("Capacity Misses", agg["l2_miss_capacity"])
            row("Sharing Misses", agg["l2_miss_sharing"])
        lines.append("[dram_directory]")
        row("Shared Requests", agg["dir_sh_req"])
        row("Exclusive Requests", agg["dir_ex_req"])
        row("Invalidations", agg["dir_invalidations"])
        row("Writebacks", agg["dir_writebacks"])
        row("Cache-to-Cache Forwards", agg["dir_forwards"])
        row("Evictions", agg["dir_evictions"])
        row("Conflict-Round Deferrals", agg["dir_deferrals"])
        lines.append("[dram]")
        row("Reads", agg["dram_reads"])
        row("Writes", agg["dram_writes"])
        lines.append("[network (memory)]")
        row("Packets", agg["net_mem_pkts"])
        row("Flits", agg["net_mem_flits"])
        row("Link Contention Delay (in ns, total)",
            f"{ps_to_ns(agg['net_link_wait_ps']):.1f}")
        lines.append("[network (user)]")
        row("Packets", agg["net_user_pkts"])
        row("Flits", agg["net_user_flits"])
        lines.append("[sync]")
        row("Barriers", agg["barriers"])
        row("Mutex Acquires", agg["mutex_acquires"])
        row("Cond Waits", agg["cond_waits"])
        row("Cond Signals/Broadcasts", agg["cond_signals"])
        row("Messages Sent", agg["sends"])
        row("Messages Received", agg["recvs"])
        lines.append("[threads]")
        row("Spawns", agg["spawns"])
        row("Joins", agg["joins"])
        lines.append("[syscalls]")
        row("Syscalls", agg["syscalls"])
        row("Syscall Time (in ns, total)",
            f"{ps_to_ns(agg['syscall_ps']):.1f}")
        vm_sec = self.vm_summary()
        if vm_sec is not None:
            lines.append("[vm]")
            row("Data Segment (brk) Bytes", vm_sec["data_segment_bytes"])
            row("Dynamic Segment (mmap) Bytes", vm_sec["mmap_bytes"])
            row("Unmapped (munmap) Bytes", vm_sec["munmap_bytes"])
            row("Stack Segment Bytes", vm_sec["stack_segment_bytes"])
            if vm_sec["brk_overflow"] or vm_sec["dynamic_overflow"]:
                row("SEGMENT OVERFLOW", ", ".join(
                    name for name, flag
                    in (("brk", vm_sec["brk_overflow"]),
                        ("dynamic", vm_sec["dynamic_overflow"])) if flag))
        lines.append("[stalls]")
        row("Memory Stall (in ns, total)", f"{ps_to_ns(agg['mem_stall_ps']):.1f}")
        row("Sync Stall (in ns, total)", f"{ps_to_ns(agg['sync_stall_ps']):.1f}")
        if self.params.enable_power_modeling:
            e = self.energy()
            seconds = max(self.completion_time_ps * 1e-12, 1e-30)
            lines.append("[energy]")
            for name in ("core", "l1i", "l1d", "l2", "directory", "dram",
                         "network", "leakage"):
                row(f"{name.capitalize()} Energy (in uJ)",
                    f"{float(getattr(e, name).sum()) * 1e6:.3f}")
            row("Total Energy (in uJ)", f"{float(e.total.sum()) * 1e6:.3f}")
            row("Average Power (in W)",
                f"{float(e.total.sum()) / seconds:.3f}")
            row("Tile Area (in mm^2)", f"{e.area_mm2_per_tile:.3f}")
        return "\n".join(lines) + "\n"


class DeadlockError(RuntimeError):
    """No tile made progress across a full polling window — the trace is
    waiting on something that can never happen (e.g. mismatched barrier
    participant counts)."""


class Simulator:
    """Headless simulator-as-library.  ``device=None`` means CUDA."""

    def __init__(self, params: SimParams, trace: Trace, device=None):
        if trace.num_tiles < params.num_tiles:
            raise ValueError(
                f"trace has {trace.num_tiles} streams, params expect "
                f"at least {params.num_tiles}")
        self.device = dispatch.resolve_device(device)
        check_slice(params, trace, self.device)
        self.params = params
        self.vp = variant_params(params)
        self.trace = TraceArrays.from_trace(trace, self.device)
        ops = np.asarray(trace.ops)
        has_capi = bool(((ops == int(EventOp.SEND))
                         | (ops == int(EventOp.RECV))).any())
        self.state = make_state(params, self.device, has_capi=has_capi,
                                num_streams=trace.num_tiles)
        self.steps = 0
        self.host_seconds = 0.0

    def run(self, max_steps: Optional[int] = None,
            poll_every: int = 8) -> SimSummary:
        """Run until every tile is DONE (or ``max_steps`` megastep
        equivalents of ``quanta_per_step`` quanta each)."""
        t0 = time.perf_counter()
        last_progress = None
        qps = self.params.quanta_per_step
        while True:
            window = poll_every if max_steps is None \
                else max(min(poll_every, max_steps - self.steps), 0)
            if window == 0:
                break
            self.state = megarun(self.params, self.state, self.trace,
                                 window * qps, vp=self.vp)
            done = bool(self.state.all_done().item())
            cursor_sum = int(self.state.cursor.to(torch.int64).sum().item())
            clock_sum = int(self.state.clock.sum().item())
            quanta = int(self.state.ctr_quantum.item())
            self.steps = -(-quanta // qps)
            if done:
                break
            if max_steps is not None and self.steps >= max_steps:
                break
            progress = (cursor_sum, clock_sum)
            if progress == last_progress:
                raise DeadlockError(
                    f"no progress after {self.steps} steps "
                    f"(cursor_sum={cursor_sum}, clock_sum={clock_sum})")
            last_progress = progress
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.host_seconds = time.perf_counter() - t0
        return self.summary()

    def summary(self) -> SimSummary:
        return SimSummary(self.params, self.state, self.host_seconds,
                          self.steps)


def run_simulation(params: SimParams, trace: Trace,
                   max_steps: Optional[int] = None,
                   device=None) -> SimSummary:
    return Simulator(params, trace, device=device).run(max_steps=max_steps)


def run_simulation_from_trace(cfg: Config, trace_path: str,
                              device=None) -> SimSummary:
    """CLI entry (graphite_tpu_torch.cli 'run')."""
    trace = Trace.load(trace_path)
    params = SimParams.from_config(cfg, num_tiles=trace.num_tiles)
    return run_simulation(params, trace, device=device)
