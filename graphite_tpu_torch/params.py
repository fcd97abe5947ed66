"""Typed, derived simulation parameters — the model-factory boundary.

``SimParams.from_config`` plays the role of the reference's config-selected
model factories (CoreModel::create core_model.cc:15,
MemoryManager::createMMU memory_manager.cc:29-52,
NetworkModel::createModel network_model.h:90,
QueueModel::create queue_model.h:7-39): every model variant is chosen here
from the same config keys, and the chosen variants fully determine the
shapes and constants of the jitted kernels.

Everything in this tree is a hashable Python scalar/tuple, so a
``SimParams`` is hashable and frozen — changing a model
choice recompiles, changing runtime state does not.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Optional, Tuple

from graphite_tpu_torch.config import Config, ConfigError
from graphite_tpu_torch.isa import STATIC_COST_TYPES, DVFSModule
from graphite_tpu_torch.time_base import ns_to_ps


def _int_or_keyword(cfg: Config, path: str, keyword: str) -> Optional[int]:
    """Config value that is either the magic ``keyword`` (-> None) or an
    integer; anything else is a ConfigError."""
    raw = cfg.get_str(path).strip()
    if raw.lower() == keyword.lower():
        return None
    try:
        return int(raw)
    except ValueError:
        raise ConfigError(
            f"{path} must be {keyword!r} or an integer: {raw!r}") from None


def _ceil_log2(x: int) -> int:
    return max(0, (x - 1).bit_length())


def _positive(value: int, path: str) -> int:
    if value < 1:
        raise ConfigError(f"{path} must be >= 1: {value}")
    return value


def _nonneg(value: int, path: str) -> int:
    if value < 0:
        raise ConfigError(f"{path} must be >= 0: {value}")
    return value


# Engine stamp-allocation stride per round (see engine/core.STAMP_STRIDE;
# defined here so the config validator needn't import the engine): block
# windows use stamp offsets 0..K-1, the general slot and resolve fills use
# the top two, so K is capped at STRIDE - 2.
STAMP_STRIDE = 64


def _block_events(value: int) -> int:
    if not 0 <= value <= STAMP_STRIDE - 2:
        raise ConfigError(
            f"tpu/block_events must be in [0, {STAMP_STRIDE - 2}] "
            f"(stamp-stride limit): {value}")
    return value


# Upper bound on tpu/miss_chain: the chain replay is a fori_loop of P
# per-slot phases inside ONE resolve pass, so P is a direct multiplier
# on per-pass device work — past the low hundreds the pass stops being
# "a round" in any honest sense, and the [P, T] bank arrays start to
# rival the caches.  Banking depth beyond a window's miss yield per
# sub-round (~block_events) buys nothing anyway: the chain cadence
# serves every sub-round.
MISS_CHAIN_MAX = 256


def _miss_chain(value: int) -> int:
    if not 0 <= value <= MISS_CHAIN_MAX:
        raise ConfigError(
            f"tpu/miss_chain must be in [0, {MISS_CHAIN_MAX}]: {value}")
    return value


# Upper bound on tpu/fast_forward (span width, in block_events-sized
# windows): an engaged fast-forward round prices its whole span under ONE
# round_ctr value, so the span's per-event stamp offsets must fit the
# round's exclusive STAMP_STRIDE allocation (the effective span is also
# clipped to the resident window-cache width, 4 windows — see
# engine/core._ff_width).  Values past STRIDE buy nothing.
FAST_FORWARD_MAX = STAMP_STRIDE


def _fast_forward(value: int) -> int:
    if not 0 <= value <= FAST_FORWARD_MAX:
        raise ConfigError(
            f"tpu/fast_forward must be in [0, {FAST_FORWARD_MAX}]: "
            f"{value}")
    return value


_PALLAS_KERNEL_MODES = ("auto", "off", "interpret", "on")


def _pallas_kernels(value: str) -> str:
    if value not in _PALLAS_KERNEL_MODES:
        raise ConfigError(
            f"tpu/pallas_kernels must be one of {_PALLAS_KERNEL_MODES}: "
            f"{value!r}")
    return value


_SHARD_STATE_MODES = ("replicated", "resident")


def _shard_state(value: str) -> str:
    if value not in _SHARD_STATE_MODES:
        raise ConfigError(
            f"tpu/shard_state must be one of {_SHARD_STATE_MODES}: "
            f"{value!r}")
    return value


def _tile_shards(raw: str, num_tiles: int) -> int:
    """Resolve ``tpu/tile_shards`` to a concrete shard count.

    ``"auto"`` takes the largest divisor of the tile count that the
    attached device set can carry (1 on a single device — today's
    program); an explicit integer must divide ``num_tiles`` evenly and
    fit the device count, because shard_map splits the tile axis into
    equal per-device blocks.  The resolved value is STATIC: it selects
    the compiled program (sharded vs single-device), so it lives in
    SimParams like ``pallas_kernels`` rather than in a runtime flag.
    """
    if raw == "auto":
        import torch
        d = torch.cuda.device_count() if torch.cuda.is_available() else 1
        s = max(v for v in range(1, d + 1) if num_tiles % v == 0)
        return s
    try:
        value = int(raw)
    except ValueError:
        raise ConfigError(
            f"tpu/tile_shards must be 'auto' or a positive integer: "
            f"{raw!r}")
    if value < 1:
        raise ConfigError(f"tpu/tile_shards must be >= 1: {value}")
    if num_tiles % value:
        raise ConfigError(
            f"tpu/tile_shards={value} must divide the tile count "
            f"{num_tiles} (shard_map splits the tile axis into equal "
            f"per-device blocks)")
    return value


def _syscall_costs(cfg: Config) -> tuple:
    """[syscall] per-class service cycles, ordered by isa.SyscallClass."""
    from graphite_tpu_torch.isa import SyscallClass
    return tuple(
        cfg.get_int(f"syscall/{c.name.lower()}_cost")
        for c in SyscallClass)


def _ceil_pow2(x: int) -> int:
    return 1 << _ceil_log2(x)


@dataclasses.dataclass(frozen=True)
class CacheParams:
    """Geometry + latency for one set-associative cache level
    (reference: common/tile/memory_subsystem/cache/cache.h:26-80 and the
    [l1_icache/*]/[l1_dcache/*]/[l2_cache/*] sections)."""

    name: str
    line_size: int          # bytes
    size_kb: int
    associativity: int
    num_banks: int
    replacement: str        # 'lru' | 'round_robin'
    data_access_cycles: int
    tags_access_cycles: int
    perf_model: str         # 'parallel' | 'sequential'
    track_miss_types: bool

    @property
    def num_sets(self) -> int:
        sets = (self.size_kb * 1024) // (self.line_size * self.associativity)
        if sets * self.line_size * self.associativity != self.size_kb * 1024:
            raise ConfigError(f"{self.name}: size not divisible into sets")
        return sets

    @property
    def set_bits(self) -> int:
        sets = self.num_sets
        if sets & (sets - 1):
            raise ConfigError(f"{self.name}: num_sets {sets} not a power of 2")
        return sets.bit_length() - 1

    @property
    def access_cycles(self) -> int:
        """Hit latency: parallel tag+data lookup takes max(), sequential
        takes the sum (reference: cache_perf_model_parallel.h /
        cache_perf_model_sequential.h)."""
        if self.perf_model == "parallel":
            return max(self.data_access_cycles, self.tags_access_cycles)
        return self.data_access_cycles + self.tags_access_cycles

    @classmethod
    def from_config(cls, cfg: Config, section: str, name: str) -> "CacheParams":
        g = lambda k: f"{section}/{k}"
        return cls(
            name=name,
            line_size=cfg.get_int(g("cache_line_size")),
            size_kb=cfg.get_int(g("cache_size")),
            associativity=cfg.get_int(g("associativity")),
            num_banks=cfg.get_int(g("num_banks")),
            replacement=cfg.get_str(g("replacement_policy")),
            data_access_cycles=cfg.get_int(g("data_access_time")),
            tags_access_cycles=cfg.get_int(g("tags_access_time")),
            perf_model=cfg.get_str(g("perf_model_type")),
            track_miss_types=cfg.get_bool(g("track_miss_types")),
        )


@dataclasses.dataclass(frozen=True)
class DirectoryParams:
    """DRAM-directory geometry (reference: [dram_directory] section;
    auto-sizing semantics of
    common/tile/memory_subsystem/cache/directory_cache.cc:243-330)."""

    total_entries: int
    associativity: int
    max_hw_sharers: int
    directory_type: str     # full_map | limited_broadcast | limited_no_broadcast | ackwise | limitless
    access_cycles: int
    limitless_trap_cycles: int
    # Ack-combining cost (cycles) the directory pays per invalidation
    # round: the INV round trip completes when the LAST sharer's ack has
    # been folded in (reference dram_directory_cntlr counts acks and
    # unblocks on the final one).  Default 1 keeps the pre-round-9
    # math (one requester-core cycle on top of the max-hop round trip).
    inv_ack_cycles: int = 1

    @property
    def num_sets(self) -> int:
        return self.total_entries // self.associativity

    @classmethod
    def from_config(cls, cfg: Config, num_tiles: int, l2: CacheParams,
                    num_slices: int) -> "DirectoryParams":
        assoc = cfg.get_int("dram_directory/associativity")
        total_entries = _int_or_keyword(cfg, "dram_directory/total_entries", "auto")
        if total_entries is None:
            # Cover 2x the aggregate L2 capacity, spread over the directory
            # slices, rounded up to a power-of-2 set count (same sizing rule
            # as the reference, directory_cache.cc:249-256).
            sets = math.ceil(2.0 * l2.size_kb * 1024 * num_tiles /
                             (l2.line_size * assoc * num_slices))
            sets = _ceil_pow2(sets)
            total_entries = sets * assoc

        access = _int_or_keyword(cfg, "dram_directory/access_time", "auto")
        if access is None:
            access = _auto_directory_access_cycles(
                total_entries, num_tiles, cfg.get_int("dram_directory/max_hw_sharers"))

        return cls(
            total_entries=total_entries,
            associativity=assoc,
            max_hw_sharers=cfg.get_int("dram_directory/max_hw_sharers"),
            directory_type=cfg.get_str("dram_directory/directory_type"),
            access_cycles=access,
            limitless_trap_cycles=cfg.get_int("limitless/software_trap_penalty"),
            inv_ack_cycles=_positive(
                cfg.get_int("dram_directory/inv_ack_combining_cycles", 1),
                "dram_directory/inv_ack_combining_cycles"),
        )


def _auto_directory_access_cycles(total_entries: int, num_tiles: int,
                                  max_hw_sharers: int) -> int:
    """Size-binned access latency, as in the reference's auto table
    (directory_cache.cc:300-322): bigger structure -> more cycles."""
    # Entry size ~ state byte + sharer bitmap over the tracked sharers.
    entry_bytes = 1 + max(4, max_hw_sharers // 8)
    size_kb = math.ceil(total_entries * entry_bytes / 1024)
    for bound, cycles in ((16, 1), (32, 2), (64, 4), (128, 6), (256, 8),
                          (512, 10), (1024, 13), (2048, 16)):
        if size_kb <= bound:
            return cycles
    return 20


QUEUE_MODEL_TYPES = ("basic", "history_list", "history_tree", "m_g_1")
_QUEUE_MODEL_TYPES = QUEUE_MODEL_TYPES


def _queue_model_type(val: str, key: str) -> str:
    """Queue-model selection fails loudly on unknown types, matching the
    reference factory (QueueModel::create, queue_model.cc:18-37 —
    LOG_PRINT_ERROR on anything it doesn't know).  ``m_g_1`` is accepted
    directly (the reference embeds it inside history_tree;
    queue_model_m_g_1.cc is its own class)."""
    if val not in _QUEUE_MODEL_TYPES:
        raise ConfigError(
            f"{key} = {val!r}: unknown queue model (valid: "
            f"{', '.join(_QUEUE_MODEL_TYPES)})")
    return val


def _basic_ma_window(cfg: Config) -> int:
    """[queue_model/basic] moving-average window (reference
    queue_model_basic.cc:14-31): 0 when disabled; only arithmetic_mean
    is implemented — other averagers fail loudly."""
    if not cfg.get_bool("queue_model/basic/moving_avg_enabled", False):
        return 0
    ma_type = cfg.get_str("queue_model/basic/moving_avg_type",
                          "arithmetic_mean")
    if ma_type != "arithmetic_mean":
        raise ConfigError(
            f"queue_model/basic/moving_avg_type = {ma_type!r} is not "
            f"implemented (supported: arithmetic_mean)")
    w = cfg.get_int("queue_model/basic/moving_avg_window_size", 1)
    if w <= 0:
        raise ConfigError(
            f"queue_model/basic/moving_avg_window_size must be positive, "
            f"got {w}")
    return w


def _link_queue_model_type(val: str, key: str) -> str:
    if val not in ("basic", "history_list", "history_tree"):
        raise ConfigError(
            f"{key} = {val!r}: unknown link queue model (valid: basic, "
            f"history_list, history_tree — the reference factory's set, "
            f"queue_model.cc:18-37)")
    return val


@dataclasses.dataclass(frozen=True)
class DramParams:
    """DRAM controller timing (reference: [dram] section;
    dram_perf_model.h:19-60 latency = access cost + size/bandwidth +
    queueing delay)."""

    latency_ns: float
    per_controller_bandwidth_gbps: float
    num_controllers: int          # resolved count (ALL -> num_tiles)
    controller_home_stride: int   # tiles between successive controllers
    queue_model_enabled: bool
    queue_model_type: str
    # [queue_model/basic] moving average: effective window size, 0 when
    # disabled (reference queue_model_basic.cc reads moving_avg_enabled/
    # window_size/type; only arithmetic_mean is implemented here).
    basic_ma_window: int = 0

    @property
    def latency_ps(self) -> int:
        return int(ns_to_ps(self.latency_ns))

    def processing_ps_per_line(self, line_size: int) -> int:
        # bytes / (GB/s) = ns; serialization cost per cache line.
        return int(round(line_size / self.per_controller_bandwidth_gbps * 1000))

    @classmethod
    def from_config(cls, cfg: Config, num_tiles: int) -> "DramParams":
        n = _int_or_keyword(cfg, "dram/num_controllers", "ALL")
        if n is None:
            n = num_tiles
        elif n <= 0 or n > num_tiles:
            raise ConfigError(f"dram/num_controllers out of range: {n}")
        stride = max(1, num_tiles // n)
        return cls(
            latency_ns=cfg.get_float("dram/latency"),
            per_controller_bandwidth_gbps=cfg.get_float("dram/per_controller_bandwidth"),
            num_controllers=n,
            controller_home_stride=stride,
            queue_model_enabled=cfg.get_bool("dram/queue_model/enabled"),
            queue_model_type=_queue_model_type(
                cfg.get_str("dram/queue_model/type"), "dram/queue_model/type"),
            basic_ma_window=_basic_ma_window(cfg),
        )


def _telemetry_interval_ns(cfg: Config) -> int:
    """[telemetry] interval contribution to the shared sampling cadence
    (ns; 1<<40 = no contribution).  The default 'auto' RIDES whatever
    cadence the statistics/progress/power rings already configured —
    turning telemetry on must not retime or early-saturate the traces
    the user explicitly asked for — and falls back to 10 us when
    telemetry is the only sampler.  An explicit integer participates in
    the shared min like any other sampler."""
    if not cfg.get_bool("telemetry/enabled", False):
        return 1 << 40
    if not cfg.has("telemetry/interval"):
        val = None
    else:
        val = _int_or_keyword(cfg, "telemetry/interval", "auto")
    if val is None:     # auto
        others_on = (cfg.get_bool("statistics_trace/enabled")
                     or cfg.get_bool("progress_trace/enabled")
                     or cfg.get_bool(
                         "runtime_energy_modeling/power_trace/enabled",
                         False))
        return (1 << 40) if others_on else 10000
    # 0 would reach _maybe_sample's `boundary // interval` as a jitted
    # divide-by-zero (implementation-defined on device, no exception).
    return _positive(val, "telemetry/interval")


def pow2_grid(n: int, tall: bool) -> Tuple[int, int]:
    """Factor a power-of-two count onto a grid (reference
    initializeClusters / sub-cluster math, network_model_atac.cc:594-630):
    even log2 -> square; odd -> 2:1, long side on Y when ``tall`` (the
    cluster grid) or on X otherwise (the sub-cluster grid)."""
    lg = n.bit_length() - 1
    assert n == 1 << lg
    if lg % 2 == 0:
        return 1 << (lg // 2), 1 << (lg // 2)
    lo, hi = 1 << ((lg - 1) // 2), 1 << ((lg + 1) // 2)
    return (lo, hi) if tall else (hi, lo)


@dataclasses.dataclass(frozen=True)
class AtacParams:
    """ATAC hybrid optical-broadcast network geometry + delays
    (reference: network_model_atac.{h,cc}, [network/atac]
    carbon_sim.cfg:315-352).  All fields are scalars so SimParams stays
    hashable (jit static arg); per-tile tables derive from these in
    engine/noc_atac.py.
    """

    num_tiles: int
    enet_width: int
    enet_height: int
    cluster_size: int
    num_clusters: int
    numx_clusters: int
    numy_clusters: int
    cluster_width: int
    cluster_height: int
    num_access_points: int            # per cluster
    receive_net_type: str             # star | htree
    global_routing_strategy: str      # cluster_based | distance_based
    unicast_distance_threshold: int
    send_hub_router_delay: int        # cycles
    receive_hub_router_delay: int     # cycles
    star_net_router_delay: int        # cycles
    optical_link_delay_cycles: int    # EO + waveguide + OE, at init freq

    @classmethod
    def from_config(cls, cfg: Config, num_tiles: int,
                    net_freq_ghz: float) -> "AtacParams":
        # ENet sizing per the reference (isTileCountPermissible,
        # network_model_atac.cc:844-856 — same rule as the electrical
        # mesh): w = floor(sqrt(T)), h = ceil(T/w), T must fill the grid.
        w = int(math.floor(math.sqrt(num_tiles)))
        h = int(math.ceil(num_tiles / w))
        if num_tiles != w * h:
            raise ConfigError(
                f"network/atac: can't form a mesh with tile count "
                f"{num_tiles} (reference isTileCountPermissible)")
        csize = cfg.get_int("network/atac/cluster_size", 4)
        if csize <= 0 or num_tiles % csize:
            raise ConfigError(
                f"network/atac/cluster_size = {csize} must divide the "
                f"tile count {num_tiles}")
        nclust = num_tiles // csize
        # Cluster grid factorization (reference initializeClusters,
        # network_model_atac.cc:594-618).  The reference's sqrt math
        # silently assumes a power-of-two cluster count; here that
        # assumption is a loud check.
        if nclust != 1 << (nclust.bit_length() - 1):
            raise ConfigError(
                f"network/atac: cluster count {nclust} must be a power "
                f"of two (reference initializeClusters sqrt math)")
        nx, ny = pow2_grid(nclust, tall=True)
        cw, ch = w // nx, h // ny
        if cw * nx != w or ch * ny != h:
            raise ConfigError(
                f"network/atac: cluster grid {nx}x{ny} does not tile the "
                f"{w}x{h} ENet evenly")
        # Optical waveguide length (mm) per the reference's cases
        # (computeOpticalLinkLength, network_model_atac.cc:560-585).
        tile_w = cfg.get_float("general/tile_width", 1.0)
        if nclust == 2:
            length = ch * tile_w
        elif nclust == 4:
            length = (cw * tile_w) * (ch * tile_w)
        elif nclust == 8:
            length = (cw * tile_w) * (2 * ch * tile_w)
        else:
            rect_l = (nx - 2) * cw * tile_w
            rect_h = (ch * 2) * tile_w
            length = max(ny // 4, 1) * 2 * (rect_l + rect_h)
        wg_ns_per_mm = cfg.get_float(
            "link_model/optical/waveguide_delay_per_mm", 10e-3)
        eo = cfg.get_int("link_model/optical/E-O_conversion_delay", 1)
        oe = cfg.get_int("link_model/optical/O-E_conversion_delay", 1)
        # Cycle count fixed at the network's initial frequency, as the
        # reference computes it once at init (optical_link_model.cc:51-54).
        optical_cycles = int(math.ceil(
            wg_ns_per_mm * length * net_freq_ghz + eo + oe))
        rnet = cfg.get_str("network/atac/receive_network_type", "star")
        if rnet not in ("star", "btree"):
            raise ConfigError(
                f"network/atac/receive_network_type = {rnet!r} "
                f"(valid: star, btree — reference parseReceiveNetType)")
        strat = cfg.get_str("network/atac/global_routing_strategy",
                            "cluster_based")
        if strat not in ("cluster_based", "distance_based"):
            raise ConfigError(
                f"network/atac/global_routing_strategy = {strat!r} "
                f"(valid: cluster_based, distance_based)")
        return cls(
            num_tiles=num_tiles, enet_width=w, enet_height=h,
            cluster_size=csize, num_clusters=nclust,
            numx_clusters=nx, numy_clusters=ny,
            cluster_width=cw, cluster_height=ch,
            num_access_points=cfg.get_int(
                "network/atac/num_optical_access_points_per_cluster", 4),
            receive_net_type=rnet,
            global_routing_strategy=strat,
            unicast_distance_threshold=cfg.get_int(
                "network/atac/unicast_distance_threshold", 4),
            send_hub_router_delay=cfg.get_int(
                "network/atac/onet/send_hub/router/delay", 1),
            receive_hub_router_delay=cfg.get_int(
                "network/atac/onet/receive_hub/router/delay", 1),
            star_net_router_delay=cfg.get_int(
                "network/atac/star_net/router/delay", 1),
            optical_link_delay_cycles=optical_cycles,
        )


@dataclasses.dataclass(frozen=True)
class NetworkParams:
    """One logical network's model selection + constants (reference:
    [network] + per-model sections; models enumerated in
    common/network/network_model.h and common/network/models/)."""

    model: str                 # magic | emesh_hop_counter | emesh_hop_by_hop | atac
    flit_width_bits: int
    router_delay_cycles: int
    link_delay_cycles: int
    queue_model_enabled: bool
    queue_model_type: str
    broadcast_tree_enabled: bool
    atac: Optional[AtacParams] = None

    @classmethod
    def from_config(cls, cfg: Config, which: str, num_tiles: int,
                    net_freq_ghz: float) -> "NetworkParams":
        model = cfg.get_str(f"network/{which}")
        sec = f"network/{model}"
        if model == "magic":
            return cls(model, 64, 0, 0, False, "none", False)
        atac = None
        if model == "atac":
            atac = AtacParams.from_config(cfg, num_tiles, net_freq_ghz)
        return cls(
            model=model,
            flit_width_bits=cfg.get_int(f"{sec}/flit_width", 64),
            # ATAC's electrical mesh (ENet) reuses the emesh router/link
            # delays ("ENet is modeled similar to an electrical mesh",
            # carbon_sim.cfg:331).
            router_delay_cycles=cfg.get_int(
                f"{sec}/enet/router/delay" if model == "atac"
                else f"{sec}/router/delay", 1),
            link_delay_cycles=cfg.get_int(f"{sec}/link/delay", 1),
            queue_model_enabled=cfg.get_bool(f"{sec}/queue_model/enabled", False),
            # Link queues accept the reference factory's three types
            # (basic/history_list/history_tree — queue_model.cc:18-37;
            # m_g_1 is DRAM-only here, as in the reference where it only
            # exists inside history_tree).  All three map to the exact
            # per-link FCFS sweep (noc_flight.py) — exact FCFS == basic
            # for in-order arrivals and >= history fidelity otherwise.
            queue_model_type=_link_queue_model_type(
                cfg.get_str(f"{sec}/queue_model/type", "history_tree"),
                f"{sec}/queue_model/type"),
            broadcast_tree_enabled=cfg.get_bool(f"{sec}/broadcast_tree_enabled", False),
            atac=atac,
        )


@dataclasses.dataclass(frozen=True)
class CoreParams:
    """Core model selection + static costs (reference: [tile]/model_list,
    [core/static_instruction_costs], [branch_predictor],
    core model registry common/tile/core/core_model.cc:15)."""

    model: str                    # 'simple' | 'iocoom'
    static_costs: Tuple[int, ...]  # indexed by InstructionType order
    bp_type: str
    bp_size: int
    bp_mispredict_penalty: int
    # iocoom knobs (reference: [core/iocoom], carbon_sim.cfg:180-186)
    load_queue_entries: int
    store_queue_entries: int
    speculative_loads: bool
    multiple_outstanding_rfos: bool
    # Heterogeneous [tile]/model_list (reference carbon_sim.cfg:158-176,
    # config.cc:365-460): per-tile True where the tile runs the iocoom
    # model.  None = homogeneous (every tile is ``model``); when set,
    # ``model`` is "iocoom" so the engine allocates the LQ/SQ/scoreboard
    # state, and the per-tile mask gates its semantics.
    iocoom_mask: Optional[Tuple[bool, ...]] = None

    @property
    def mixed(self) -> bool:
        return self.iocoom_mask is not None

    @classmethod
    def from_config(cls, cfg: Config, core_type: str,
                    iocoom_mask: Optional[Tuple[bool, ...]] = None
                    ) -> "CoreParams":
        costs = tuple(
            cfg.get_int(f"core/static_instruction_costs/{t.config_key}")
            for t in STATIC_COST_TYPES
        )
        return cls(
            model=core_type,
            static_costs=costs,
            iocoom_mask=iocoom_mask,
            bp_type=cfg.get_str("branch_predictor/type"),
            bp_size=cfg.get_int("branch_predictor/size"),
            bp_mispredict_penalty=cfg.get_int("branch_predictor/mispredict_penalty"),
            load_queue_entries=cfg.get_int("core/iocoom/num_load_queue_entries"),
            store_queue_entries=cfg.get_int("core/iocoom/num_store_queue_entries"),
            speculative_loads=cfg.get_bool("core/iocoom/speculative_loads_enabled"),
            multiple_outstanding_rfos=cfg.get_bool("core/iocoom/multiple_outstanding_RFOs_enabled"),
        )


_MODEL_LIST_RE = re.compile(r"<([^>]*)>")


def parse_tile_model_list(raw: str) -> Tuple[Tuple[str, str, str, str, str], ...]:
    """Parse [tile]/model_list tuples
    ``<count, core-type, l1i, l1d, l2>`` (reference: carbon_sim.cfg:158-176)."""
    tuples = []
    for m in _MODEL_LIST_RE.finditer(raw):
        fields = [f.strip() for f in m.group(1).split(",")]
        if len(fields) != 5:
            raise ConfigError(f"bad tile model tuple: <{m.group(1)}>")
        tuples.append(tuple(fields))
    if not tuples:
        raise ConfigError(f"no tile model tuples in {raw!r}")
    return tuple(tuples)


def parse_dvfs_domains(raw: str) -> Tuple[Tuple[float, Tuple[int, ...]], ...]:
    """Parse [dvfs]/domains ``<freq, MODULE, ...>`` tuples into
    (freq_ghz, module-ids) pairs (reference: carbon_sim.cfg:147-151,
    dvfs_manager.h:19-88)."""
    domains = []
    for m in _MODEL_LIST_RE.finditer(raw):
        fields = [f.strip() for f in m.group(1).split(",") if f.strip()]
        try:
            freq = float(fields[0])
            modules = tuple(int(DVFSModule.parse(f)) for f in fields[1:])
        except (IndexError, ValueError, KeyError):
            raise ConfigError(f"bad dvfs domain tuple: <{m.group(1)}>") from None
        domains.append((freq, modules))
    if not domains:
        raise ConfigError(f"no dvfs domains in {raw!r}")
    return tuple(domains)


@dataclasses.dataclass(frozen=True)
class SimParams:
    """All static parameters of one simulation run."""

    num_tiles: int
    mesh_width: int
    mesh_height: int
    max_frequency_ghz: float
    quantum_ps: int
    clock_skew_scheme: str

    # ThreadScheduler (reference: common/system/thread_scheduler.h:30-56 +
    # round_robin_thread_scheduler.cc): how many app-thread streams may
    # queue on one tile (the reference's general/max_threads_per_core
    # knob, config.cc:48), and the preemption quantum after which a
    # seated stream rotates out round-robin.  The reference measures its
    # switch quantum in HOST seconds (thread_scheduler.cc:632-636,
    # time(NULL)); here it is SIMULATED time — deterministic and
    # host-independent, the TPU engine's native clock.
    max_threads_per_core: int
    thread_switch_quantum_ps: int

    core: CoreParams
    l1i: CacheParams
    l1d: CacheParams
    l2: CacheParams
    protocol: str
    l2_directory_type: str
    l2_max_hw_sharers: int
    directory: DirectoryParams
    dram: DramParams
    net_user: NetworkParams
    net_memory: NetworkParams

    dvfs_domains: Tuple[Tuple[float, Tuple[int, ...]], ...]
    dvfs_sync_delay_cycles: int
    # Miss-type classification ([cache]/track_miss_types on the L1D or L2;
    # reference cache.h:45-49): resolve classifies every served miss as
    # cold / capacity / sharing through per-tile line filters.
    track_miss_types: bool
    # Per-class syscall service cycles at the MCP's syscall server, indexed
    # by isa.SyscallClass (reference: syscall_server.cc executes the host
    # call and charges marshalling round trips; the service table is this
    # rebuild's analytic stand-in for host-execution time, [syscall] in
    # defaults.cfg).
    syscall_cost_cycles: tuple

    # Simulated address-space layout (reference: vm_manager.cc reads
    # [stack] stack_base / stack_size_per_core, carbon_sim.cfg:113-117;
    # engine/vm.py).
    stack_base: int
    stack_size_per_core: int

    enable_core_modeling: bool
    enable_power_modeling: bool
    technology_node: int

    # Region-of-interest: initial models-enabled flag (reference:
    # [general]/trigger_models_within_application + Simulator::
    # enableModels, simulator.cc:287-301) — when triggering within the
    # application, timing models stay off until an ENABLE_MODELS event.
    models_enabled_at_start: bool

    # Periodic sampling (reference: StatisticsManager barrier-clocked
    # sampling statistics_manager.cc:41-114 + pin/progress_trace.cc).
    stats_enabled: bool
    progress_enabled: bool
    stat_interval_ps: int
    max_stat_samples: int
    # Periodic power trace ([runtime_energy_modeling/power_trace],
    # reference carbon_sim.cfg:141-145 + TileEnergyMonitor): sample the
    # energy-bearing counters every [runtime_energy_modeling] interval
    # and derive per-interval power.  Parsed only: the port refuses it
    # until telemetry sampling is ported (engine/sim.check_slice).
    power_trace_enabled: bool
    # [telemetry] engine-health round metrics (obs/metrics.TEL_SERIES):
    # sampled at quantum boundaries through the SAME _maybe_sample hook
    # as the statistics/progress/power rings (its interval folds into
    # stat_interval_ps), so enabling telemetry adds no fused-loop
    # branches; disabling it allocates no sample arrays.
    telemetry_enabled: bool

    # TPU engine knobs
    # Window width of the block-retirement fast path (events gathered per
    # tile per local round; 0 disables it — every event then goes through
    # the general one-event slot, the round-2 engine shape).
    block_events: int
    # Quantum-scoped block-window cache: gather the window's trace slice
    # into resident [T, 4K] SimState arrays that advance with the cursor,
    # instead of re-gathering [T, K] from the full device trace every
    # round (engine/core._block_retire; PROFILE.md lever 2).  Results are
    # bit-identical either way — false restores the per-round gather (the
    # round-identity oracle in tests/test_block_equivalence.py).
    window_cache: bool
    max_events_per_quantum: int
    directory_conflict_rounds: int
    rounds_per_quantum: int
    quanta_per_step: int
    # Max invalidation fan-outs (EX-on-S invalidation sets + shared-victim
    # directory evictions) delivered per conflict round; requests beyond the
    # budget defer to the next round (counted in dir_deferrals).  Bounds the
    # per-round invalidation scatter at [budget, T] instead of [T, T].
    max_inv_fanout_per_round: int
    # Miss-chain banking depth (the round-4 perf design): the block window
    # keeps executing past L2 misses WITHOUT installing them (blocking
    # semantics, stall-on-use), banking up to this many pending requests
    # per tile; each resolve pass replays banked chains sequentially
    # inside one engine round (element k+1 is priced against the
    # post-element-k directory state; its issue is element k's
    # completion plus the recorded local delta), so a tile costs ~1
    # device round per CHAIN instead of one per miss.  Gated at 2%
    # completion parity against the oracle (tests/
    # test_chain_equivalence.py).  0 restores the round-3
    # one-parked-request engine (the equivalence oracle) bit-exactly.
    miss_chain: int
    # Upper bound on one-element-per-round conflict rounds per resolve
    # pass (the fan-out/live-victim fallback after the chain replay);
    # leftovers carry to the next sub-round's pass via mq_head.
    max_resolve_rounds: int
    # Round-9 chain cadence (effective only with miss_chain > 0): serve
    # invalidation fan-outs INSIDE the chain replay (batched per-sharer
    # INV pricing instead of demoting the whole chain to the
    # one-element-per-round fallback), let the block window span the
    # quantum boundary by one quantum instead of truncating mid-window,
    # and advance the barrier past served chain progress.  False
    # restores the round-8 chain engine — the bench fft64 A/B switch.
    fanout_replay: bool
    # Round-10 Pallas round-cost kernels (engine/kernels/): run the block
    # window's K-deep walk and the chain replay's classify/elect/combine
    # phase as fused TPU kernels over VMEM-resident operands instead of
    # dozens of sequentially dispatched XLA ops.  A STRING so the sweep
    # zoo classifies it structural by nature:
    #   "auto"      — real Pallas on a TPU backend, plain lax elsewhere
    #   "off"       — always the lax reference path
    #   "interpret" — Pallas kernels under the interpreter (CPU-testable;
    #                 the bit-identity gate in tests/test_kernels.py)
    #   "on"        — force real Pallas lowering (TPU only)
    # Results are bit-identical across all values — the kernels run the
    # SAME walk/classify code on block-sliced operands (all-integer
    # arithmetic; per-tile independent), dispatched in kernels/dispatch.
    # The PyTorch port parses this key (defaults.cfg is shared verbatim)
    # but never reads it: its kernels are chosen by the tensors' device
    # (engine/kernels/dispatch.py), with no mode knob.
    pallas_kernels: str
    # Round-11 explicit tile-axis sharding (parallel/mesh.py): the
    # RESOLVED shard count of the quantum step's shard_map over the
    # device mesh.  1 is today's single-device program, bit for bit
    # (no shard_map wrapper is applied at all); S > 1 runs the block
    # window's walk on T/S tiles per device (sliced operands, outputs
    # all_gathered back) with the quantum barrier as an explicit pmin
    # collective, everything else replicated.  Bit-identical across
    # values — the gate in tests/test_sharding.py.  Config accepts
    # "auto" (largest divisor of T the device set carries) or an
    # explicit divisor of T; the field always holds the resolved int.
    tile_shards: int
    # Round-15 resident sharding (engine/resident.py): "replicated" is
    # the round-11 program above — state replicated on every device, the
    # hot phase shard_mapped, outputs all_gathered back each step.
    # "resident" keeps every T-leading SimState leaf SHARDED along the
    # tile axis for the whole run: the window walk and local advance run
    # shard-local with no output gathers, and the resolve/chain phase is
    # re-expressed as home-binned routing (chain heads bucketed by
    # dense.home_fold home shard, all_to_all-routed to their home
    # device, priced against home-resident directory state, routed
    # back).  Per-device resident HBM drops from O(T) to O(T/S) and the
    # 13 per-step all_gathers become <=2 fixed-capacity all_to_alls
    # plus the existing pmin barrier.  The resident program is its own
    # family: its contract is shard-count invariance (resident S=8 ==
    # resident S=1, bit for bit), checked in tests/test_sharding.py.
    # Only a validated config subset lowers (engine/resident.py
    # validate_params); anything else raises ConfigError up front.
    shard_state: str
    # Per-(source shard, dest shard) record capacity of the resident
    # routing all_to_all.  0 ("auto") sizes it at 2*T/S — structurally
    # never overflowing; smaller explicit values shrink the routed
    # payload, and a step whose inbound heads exceed the budget takes
    # the host-side overflow spill (value-identical, counted in
    # obs routing_overflows_total) so correctness never depends on the
    # heuristic.
    route_capacity: int
    channel_depth: int
    # Captured-trace replay: a recorded COND_WAIT provably consumed SOME
    # signal in the native run, but simulated retiming can invert the
    # recorded wait/signal pair; replay mode wakes waiters on any
    # outstanding token at max(park, token time) instead of enforcing
    # strict lost-signal eligibility (engine/resolve.resolve_cond).
    cond_replay: bool
    # Round-12 adaptive-fidelity fast-forward (engine/core.py + the
    # kernels/window.fast_forward_walk leg): before each detailed
    # sub-round, detect tiles whose next events are ALL hit/compute —
    # no bankable misses, no sync ops, no pending chain heads — and
    # price the longest such prefix of the resident window in closed
    # form (cumulative clock advance + bulk counter accumulation +
    # batched LRU touches) instead of iterating window rounds.  The
    # value is the span width in block_events-sized windows (clipped to
    # the resident cache's 4 windows and the stamp stride); 0 compiles
    # the fast-forward leg out entirely — bit-identical to the
    # pre-round-12 engine (tests/data/fast_forward_golden.json).
    fast_forward: int
    # Fast-forward accuracy budget, picoseconds (config key
    # tpu/fast_forward_span is in NANOSECONDS): eligible tiles may
    # commit analytic progress up to this far PAST the quantum boundary,
    # trading barrier fidelity for fewer quanta, the same knob class as
    # Graphite's lax synchronization.  0 (the default) keeps the exact
    # quantum barrier.  VARIANT in the sweep zoo — a traced operand
    # (vparams.py), so sweeps get a cost/accuracy axis without
    # recompiling.
    fast_forward_span_ps: int
    # Round-16 streaming segmented ingest (engine/ingest.py, config key
    # [trace] segment_events): 0 uploads the whole trace at startup —
    # today's program, bit for bit.  > 0 keeps only a [T, segment_events]
    # RESIDENT SEGMENT of the event stream on device (plus one prefetch
    # buffer uploading the predicted next window while the megarun
    # runs), bounding device trace memory at O(segment) for any trace
    # length; the streamed walk is bit-identical to the whole-trace
    # program (speculative quantum + rollback at segment overruns —
    # ingest.py's contract).  Must be >= 2x the engine's read lookahead
    # (``ingest_lookahead``); the not-yet-validated combinations
    # (resident shard_state, fast_forward, multi-thread scheduling)
    # reject loudly in __post_init__ / engine/ingest.validate_streaming.
    segment_events: int

    @property
    def ingest_lookahead(self) -> int:
        """Max events past the cursor one engine round may READ (the
        window-cache refresh gathers the full [T, WC] resident span):
        the streaming overrun guard's per-row lookahead.  Whole-trace
        runs never use it."""
        K = self.block_events
        if K <= 0:
            return 1
        if self.window_cache:
            return 4 * K     # state._win_cache_width's geometry
        return K

    @property
    def line_size(self) -> int:
        return self.l2.line_size

    @property
    def shared_l2(self) -> bool:
        """True for the shared-distributed-L2 protocols: the directory
        arrays ARE the per-tile L2 slices (directory integrated in L2,
        reference pr_l1_sh_l2_msi/l2_cache_cntlr.cc + l2_directory_cfg.cc),
        and there is no private L2."""
        return self.protocol.startswith("pr_l1_sh_l2")

    @property
    def protocol_kind(self) -> str:
        """Directory FSM family: 'msi' | 'mosi' | 'sh_l2_msi' | 'sh_l2_mesi'."""
        return {
            "pr_l1_pr_l2_dram_directory_msi": "msi",
            "pr_l1_pr_l2_dram_directory_mosi": "mosi",
            "pr_l1_sh_l2_msi": "sh_l2_msi",
            "pr_l1_sh_l2_mesi": "sh_l2_mesi",
        }[self.protocol]

    def __post_init__(self):
        sizes = {self.l1i.line_size, self.l1d.line_size, self.l2.line_size}
        if len(sizes) != 1:
            raise ConfigError(
                f"cache line sizes must agree across L1I/L1D/L2, got {sizes}")
        # A config-compatible simulator that quietly simulates a different
        # machine is worse than one that refuses: every selectable model
        # variant that the engine does not implement yet fails loudly here
        # instead of silently running the implemented one.
        def _check(what, value, supported):
            if value not in supported:
                raise ConfigError(
                    f"{what} '{value}' is not implemented "
                    f"(supported: {sorted(supported)})")
        _check("tile core model", self.core.model, {"simple", "iocoom"})
        if self.core.model == "iocoom":
            _positive(self.core.load_queue_entries,
                      "core/iocoom/num_load_queue_entries")
            _positive(self.core.store_queue_entries,
                      "core/iocoom/num_store_queue_entries")
        _check("caching_protocol/type", self.protocol,
               {"pr_l1_pr_l2_dram_directory_msi",
                "pr_l1_pr_l2_dram_directory_mosi",
                "pr_l1_sh_l2_msi", "pr_l1_sh_l2_mesi"})
        # Validate the OPERATIVE scheme field (directory.directory_type is
        # what the engine reads; it is sourced from [l2_directory] under
        # shared L2 and [dram_directory] otherwise).
        _schemes = {"full_map", "limited_broadcast", "limited_no_broadcast",
                    "ackwise", "limitless"}
        _check("l2_directory/directory_type" if self.shared_l2
               else "dram_directory/directory_type",
               self.directory.directory_type, _schemes)
        if self.directory.directory_type != "full_map":
            _positive(self.directory.max_hw_sharers,
                      "directory max_hw_sharers")
        if self.enable_power_modeling:
            from graphite_tpu_torch.energy import DVFS_LEVELS
            _check("general/technology_node", self.technology_node,
                   set(DVFS_LEVELS))
        _check("network/user model", self.net_user.model,
               {"magic", "emesh_hop_counter", "emesh_hop_by_hop", "atac"})
        _check("network/memory model", self.net_memory.model,
               {"magic", "emesh_hop_counter", "emesh_hop_by_hop", "atac"})
        _check("branch_predictor/type", self.core.bp_type,
               {"one_bit", "none"})
        # [stack] layout sanity up front — a bad layout must not surface
        # as a VMError from the run SUMMARY after an hours-long
        # simulation already completed (engine/vm.VMManager asserts the
        # same invariants at reporting time).
        from graphite_tpu_torch.engine.vm import START_DATA, START_DYNAMIC
        end_stack = self.stack_base \
            + self.num_tiles * self.stack_size_per_core
        if not (START_DATA < self.stack_base < end_stack < START_DYNAMIC):
            raise ConfigError(
                f"[stack] layout invalid: stacks "
                f"{self.stack_base:#x}-{end_stack:#x} must sit between "
                f"the data segment ({START_DATA:#x}) and the dynamic "
                f"segment ({START_DYNAMIC:#x})")
        # Streaming segmented ingest composes only with the validated
        # subset; every other combination refuses up front (the round-15
        # resident rule: a config that would quietly run a DIFFERENT
        # program is worse than one that refuses).
        if self.segment_events > 0:
            if self.shard_state != "replicated":
                raise ConfigError(
                    "trace/segment_events (streaming ingest) requires "
                    "tpu/shard_state=replicated — the resident tile-"
                    "sharded program does not compose with segment "
                    "swaps yet (tile_shards > 1 replicated is fine)")
            if self.fast_forward > 0:
                raise ConfigError(
                    "trace/segment_events with tpu/fast_forward > 0 is "
                    "not validated: analytic spans widen the trace "
                    "lookahead past the segment overrun guard — run "
                    "streamed traces with fast_forward=0")
            L = self.ingest_lookahead
            if self.segment_events < 2 * L:
                raise ConfigError(
                    f"trace/segment_events={self.segment_events} must "
                    f"be >= 2x the engine read lookahead ({L} events — "
                    f"the window cache's resident span); smaller "
                    f"segments cannot guarantee swap progress")

    def module_freq_ghz(self, module: DVFSModule) -> float:
        """Initial frequency of a module from its DVFS domain."""
        for freq, modules in self.dvfs_domains:
            if int(module) in modules:
                return freq
        return self.max_frequency_ghz

    @classmethod
    def from_config(cls, cfg: Config, num_tiles: Optional[int] = None) -> "SimParams":
        T = num_tiles if num_tiles is not None else cfg.get_int("general/total_cores")
        mesh_w = int(math.floor(math.sqrt(T)))
        mesh_h = int(math.ceil(T / mesh_w))

        tiles = parse_tile_model_list(cfg.get_str("tile/model_list"))
        # Sequential tuple fill, exactly the reference's semantics
        # (config.cc:365-460): each tuple covers ``count`` tiles in
        # order, "default" count = all T, counts must sum to exactly T.
        # Core types MAY mix (heterogeneous simple/iocoom per tile —
        # the engine gates iocoom semantics on a per-tile mask); cache
        # configs must agree across tuples and are rejected loudly
        # otherwise — per-tile cache GEOMETRY mixes would break the
        # packed [T, sets, ways] state layout, and silently running the
        # first tuple mis-simulated the config (VERDICT r2 weak #5).
        per_tile_core: list = []
        cache_names = set()
        for cnt_s, ctype, n1i, n1d, n2 in tiles:
            try:
                cnt = T if cnt_s == "default" else int(cnt_s)
            except ValueError:
                raise ConfigError(
                    f"bad tile count {cnt_s!r} in [tile]/model_list "
                    "(a number or 'default')") from None
            if cnt < 1:
                # A dropped tuple would silently mis-simulate the config
                # (VERDICT r2 weak #5) — reject instead.
                raise ConfigError(
                    f"tile count {cnt} in [tile]/model_list must be >= 1")
            ctype = "simple" if ctype == "default" else ctype
            if ctype not in ("simple", "iocoom"):
                raise ConfigError(
                    f"unknown core type {ctype!r} in [tile]/model_list "
                    "(valid: simple, iocoom)")
            if len(per_tile_core) + cnt > T:
                raise ConfigError(
                    f"[tile]/model_list covers more than total_cores={T} "
                    "tiles")
            per_tile_core.extend([ctype] * cnt)
            # Normalize before comparing: 'default' IS T1 (reference
            # config.cc DEFAULT_CACHE_TYPE), so mixing the two spellings
            # is homogeneous.
            cache_names.add(tuple("T1" if n == "default" else n
                                  for n in (n1i, n1d, n2)))
        if len(per_tile_core) != T:
            raise ConfigError(
                f"[tile]/model_list covers {len(per_tile_core)} of "
                f"total_cores={T} tiles")
        if len(cache_names) > 1:
            raise ConfigError(
                "heterogeneous cache configs in [tile]/model_list are "
                f"not implemented (got {sorted(cache_names)}); per-tile "
                "cache geometry mixes would break the packed state "
                "layout — core-type mixes are supported")
        l1i_name, l1d_name, l2_name = next(iter(cache_names))
        if any(c == "iocoom" for c in per_tile_core):
            core_type = "iocoom"
            iocoom_mask = tuple(c == "iocoom" for c in per_tile_core) \
                if any(c == "simple" for c in per_tile_core) else None
        else:
            core_type = "simple"
            iocoom_mask = None
        l1i_name = "T1" if l1i_name == "default" else l1i_name
        l1d_name = "T1" if l1d_name == "default" else l1d_name
        l2_name = "T1" if l2_name == "default" else l2_name

        l1i = CacheParams.from_config(cfg, f"l1_icache/{l1i_name}", "l1_icache")
        l1d = CacheParams.from_config(cfg, f"l1_dcache/{l1d_name}", "l1_dcache")
        l2 = CacheParams.from_config(cfg, f"l2_cache/{l2_name}", "l2_cache")

        dram = DramParams.from_config(cfg, T)
        protocol = cfg.get_str("caching_protocol/type")
        if protocol.startswith("pr_l1_sh_l2"):
            # Shared-distributed L2: the "directory" is the per-tile L2
            # slice itself (tags + state + L1-sharer tracking), so its
            # geometry and access latency come from the L2 cache config
            # and the sharer-tracking knobs from [l2_directory]
            # (reference: l2_directory_cfg.cc, l2_cache_cntlr.cc).
            directory = DirectoryParams(
                total_entries=l2.num_sets * l2.associativity,
                associativity=l2.associativity,
                max_hw_sharers=cfg.get_int("l2_directory/max_hw_sharers"),
                directory_type=cfg.get_str("l2_directory/directory_type"),
                access_cycles=l2.access_cycles,
                limitless_trap_cycles=cfg.get_int(
                    "limitless/software_trap_penalty"),
                inv_ack_cycles=_positive(
                    cfg.get_int("dram_directory/inv_ack_combining_cycles", 1),
                    "dram_directory/inv_ack_combining_cycles"),
            )
        else:
            directory = DirectoryParams.from_config(
                cfg, T, l2, num_slices=dram.num_controllers)

        scheme = cfg.get_str("clock_skew_management/scheme")
        if scheme == "lax_p2p":
            scheme = "lax_barrier"  # subsumed on TPU (see SURVEY.md section 5.7)
        quantum_ns = cfg.get_int("clock_skew_management/lax_barrier/quantum")

        return cls(
            num_tiles=T,
            mesh_width=mesh_w,
            mesh_height=mesh_h,
            max_frequency_ghz=cfg.get_float("general/max_frequency"),
            quantum_ps=int(ns_to_ps(quantum_ns)),
            clock_skew_scheme=scheme,
            max_threads_per_core=_positive(
                cfg.get_int("general/max_threads_per_core", 1),
                "general/max_threads_per_core"),
            thread_switch_quantum_ps=int(ns_to_ps(_positive(
                cfg.get_int("thread_scheduling/switch_quantum", 10_000),
                "thread_scheduling/switch_quantum"))),
            core=CoreParams.from_config(cfg, core_type, iocoom_mask),
            l1i=l1i,
            l1d=l1d,
            l2=l2,
            protocol=protocol,
            l2_directory_type=cfg.get_str("l2_directory/directory_type"),
            l2_max_hw_sharers=cfg.get_int("l2_directory/max_hw_sharers"),
            directory=directory,
            dram=dram,
            net_user=NetworkParams.from_config(
                cfg, "user", num_tiles=T,
                net_freq_ghz=cfg.get_float("general/max_frequency")),
            net_memory=NetworkParams.from_config(
                cfg, "memory", num_tiles=T,
                net_freq_ghz=cfg.get_float("general/max_frequency")),
            dvfs_domains=parse_dvfs_domains(cfg.get_str("dvfs/domains")),
            dvfs_sync_delay_cycles=cfg.get_int("dvfs/synchronization_delay"),
            syscall_cost_cycles=_syscall_costs(cfg),
            stack_base=cfg.get_int("stack/stack_base"),
            stack_size_per_core=_positive(
                cfg.get_int("stack/stack_size_per_core"),
                "stack/stack_size_per_core"),
            track_miss_types=(l1d.track_miss_types or l2.track_miss_types),
            enable_core_modeling=cfg.get_bool("general/enable_core_modeling"),
            enable_power_modeling=cfg.get_bool("general/enable_power_modeling"),
            technology_node=cfg.get_int("general/technology_node"),
            models_enabled_at_start=(
                cfg.get_bool("general/enable_core_modeling")
                and not cfg.get_bool(
                    "general/trigger_models_within_application")),
            stats_enabled=cfg.get_bool("statistics_trace/enabled"),
            progress_enabled=cfg.get_bool("progress_trace/enabled"),
            stat_interval_ps=int(ns_to_ps(min(
                (cfg.get_int("statistics_trace/sampling_interval")
                 if cfg.get_bool("statistics_trace/enabled") else 1 << 40),
                (cfg.get_int("progress_trace/interval")
                 if cfg.get_bool("progress_trace/enabled") else 1 << 40),
                (cfg.get_int("runtime_energy_modeling/interval", 1000)
                 if cfg.get_bool(
                     "runtime_energy_modeling/power_trace/enabled", False)
                 else 1 << 40),
                _telemetry_interval_ns(cfg)))),
            power_trace_enabled=cfg.get_bool(
                "runtime_energy_modeling/power_trace/enabled", False),
            telemetry_enabled=cfg.get_bool("telemetry/enabled", False),
            max_stat_samples=cfg.get_int("tpu/max_stat_samples", 1024),
            block_events=_block_events(cfg.get_int("tpu/block_events", 16)),
            window_cache=cfg.get_bool("tpu/window_cache", True),
            max_events_per_quantum=cfg.get_int("tpu/max_events_per_quantum"),
            directory_conflict_rounds=cfg.get_int("tpu/directory_conflict_rounds"),
            rounds_per_quantum=cfg.get_int("tpu/rounds_per_quantum", 4),
            quanta_per_step=cfg.get_int("tpu/quanta_per_step"),
            max_inv_fanout_per_round=_positive(cfg.get_int(
                "tpu/max_inv_fanout_per_round", 8),
                "tpu/max_inv_fanout_per_round"),
            miss_chain=_miss_chain(cfg.get_int("tpu/miss_chain", 0)),
            max_resolve_rounds=_positive(
                cfg.get_int("tpu/max_resolve_rounds", 4),
                "tpu/max_resolve_rounds"),
            fanout_replay=cfg.get_bool("tpu/fanout_replay", True),
            pallas_kernels=_pallas_kernels(
                cfg.get_str("tpu/pallas_kernels", "auto")),
            tile_shards=_tile_shards(
                cfg.get_str("tpu/tile_shards", "1"), T),
            shard_state=_shard_state(
                cfg.get_str("tpu/shard_state", "replicated")),
            route_capacity=_nonneg(
                cfg.get_int("tpu/route_capacity", 0),
                "tpu/route_capacity"),
            channel_depth=cfg.get_int("tpu/channel_depth", 16),
            cond_replay=cfg.get_bool("tpu/cond_replay", False),
            fast_forward=_fast_forward(
                cfg.get_int("tpu/fast_forward", 0)),
            fast_forward_span_ps=int(ns_to_ps(_nonneg(
                cfg.get_int("tpu/fast_forward_span", 0),
                "tpu/fast_forward_span"))),
            segment_events=_nonneg(
                cfg.get_int("trace/segment_events", 0),
                "trace/segment_events"),
        )
