"""Analytic energy/power/area accounting (the McPAT + CACTI + DSENT role).

The reference drives ~65k LoC of third-party engines through thin
interfaces whose *shape* is: per-component event counters x per-event
energy costs, plus leakage power x time, with technology-node and
DVFS voltage/frequency scaling (reference:
common/mcpat/mcpat_core_interface.h:80-99 — per-instruction micro-op
event counts in, {area, leakage_energy, dynamic_energy} per component
out; contrib/dsent/ for per-flit router/link energies;
common/tile/tile_energy_monitor.cc for the periodic roll-up).

Here the same capability is a closed-form table model evaluated on the
engine's existing Counters — no RTL-calibrated engine is ported (the
constants are order-of-magnitude analytic stand-ins, documented per
component), but every scaling *behavior* the reference exposes is
modeled:

  * dynamic energy  = events x E_event(component) x (V / V_nom)^2
  * leakage power   = P_leak(component) x V / V_nom, integrated over the
    run's completion time
  * technology scaling across 45/32/22 nm (dynamic energy ~ node^2 from
    capacitance, leakage mildly rising as nodes shrink)
  * DVFS voltage levels: discrete (voltage, max-frequency-factor) tables
    per node — the voltage needed for a module's current frequency is
    the lowest level that still supports it (reference:
    technology/dvfs_levels_{45,32,22}nm.cfg, dvfs_manager.cc) —
    frequencies above the top level's reach raise ConfigError.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict

import numpy as np

from graphite_tpu_torch.config import ConfigError
from graphite_tpu_torch.isa import DVFSModule

# Discrete DVFS levels per technology node: (voltage V, max-frequency
# factor).  Same tables as the reference's technology/dvfs_levels_*.cfg
# (physical V/f operating points, quoted as data).
DVFS_LEVELS = {
    45: ((1.1, 1.0), (1.06, 0.88), (1.02, 0.77), (0.98, 0.65),
         (0.94, 0.54), (0.9, 0.42)),
    32: ((1.1, 1.0), (1.04, 0.87), (0.98, 0.75), (0.92, 0.62),
         (0.86, 0.49), (0.8, 0.36)),
    22: ((1.0, 1.0), (0.96, 0.87), (0.92, 0.75), (0.88, 0.63),
         (0.84, 0.5), (0.8, 0.37)),
}


def nominal_voltage(tech_nm: int) -> float:
    return DVFS_LEVELS[_node(tech_nm)][0][0]


def _node(tech_nm: int) -> int:
    if tech_nm not in DVFS_LEVELS:
        raise ConfigError(
            f"general/technology_node {tech_nm} has no DVFS level table "
            f"(supported: {sorted(DVFS_LEVELS)})")
    return tech_nm


def voltage_for_frequency(freq_ghz, max_freq_ghz: float,
                          tech_nm: int) -> np.ndarray:
    """Lowest level voltage supporting ``freq_ghz`` (elementwise).

    Mirrors DVFSManager's level lookup (dvfs_manager.cc getVoltage): each
    level's reach is factor * max_frequency; running faster than the top
    level supports is a config error.
    """
    levels = DVFS_LEVELS[_node(tech_nm)]
    f = np.asarray(freq_ghz, dtype=np.float64)
    v = np.full(f.shape, np.nan)
    # 1% relative tolerance: engine frequencies are derived from integer
    # ps periods (period = round(1000/f)), which perturbs them by up to
    # ~0.25% — far above float epsilon, far below the >=10% spacing of
    # adjacent levels, so a module configured exactly at a level boundary
    # stays on its level instead of tripping the next one (or the error).
    for volt, factor in levels:           # descending reach
        v = np.where(f <= factor * max_freq_ghz * 1.01, volt, v)
    if np.isnan(v).any():
        raise ConfigError(
            f"frequency {float(np.max(f)):.3f} GHz exceeds the "
            f"{_node(tech_nm)}nm top DVFS level "
            f"({levels[0][1] * max_freq_ghz:.3f} GHz)")
    return v


# ---------------------------------------------------------------- tables
# Per-event dynamic energies in pJ at 45 nm / nominal voltage, and
# per-component leakage in mW.  Analytic stand-ins at published orders of
# magnitude (a 45nm ALU op is a few pJ; SRAM reads grow ~sqrt(size);
# 2D-mesh router+link flit traversal ~1-2 pJ; DRAM tens of pJ/byte).

_E_INST_PJ = 6.0          # mean per-instruction core energy (fetch+decode+ex)
_E_BRANCH_PJ = 2.0        # predictor + redirect overhead
_E_DIR_PJ = 4.0           # directory/slice tag+bitmap update
_E_DRAM_PJ_PER_BYTE = 25.0
_E_ROUTER_FLIT_PJ = 1.2   # per-flit per-hop router traversal (DSENT-shaped)
_E_LINK_FLIT_PJ = 0.8     # per-flit per-hop link traversal
_LEAK_CORE_MW = 8.0
_LEAK_CACHE_MW_PER_KB = 0.06
_LEAK_ROUTER_MW = 1.5

# Dynamic energy ~ C V^2: capacitance shrinks ~linearly per node step,
# V^2 from the node's nominal voltage; leakage density RISES as nodes
# shrink (subthreshold), net per-tile leakage roughly flat-to-down.
_NODE_DYN = {45: 1.0, 32: 0.60, 22: 0.38}
_NODE_LEAK = {45: 1.0, 32: 0.85, 22: 0.75}


def _cache_access_pj(size_kb: int, assoc: int, banks: int = 1) -> float:
    """CACTI-shaped SRAM access energy: grows with sqrt(capacity) and
    mildly with associativity (more ways read per access).  Banking cuts
    dynamic access energy — each access activates one bank of
    size/banks — at an area premium (CACTI's banked organization; the
    [cache]/num_banks knob the reference feeds McPAT)."""
    banks = max(banks, 1)
    return 0.4 * math.sqrt(max(size_kb / banks, 1)) \
        * (1.0 + 0.08 * assoc)


def _cache_area_mm2(size_kb: int, tech_nm: int, banks: int = 1) -> float:
    """~0.25 mm^2 per 256KB at 45nm, scaling with node^2; each extra bank
    adds ~3% periphery overhead (decoders/sense amps per bank)."""
    return 0.25 * (size_kb / 256.0) * (tech_nm / 45.0) ** 2 \
        * (1.0 + 0.03 * (max(banks, 1) - 1))


@dataclasses.dataclass(frozen=True)
class EnergyBreakdown:
    """Per-tile energy arrays in joules ([T] float64 each) + static area."""

    core: np.ndarray
    l1i: np.ndarray
    l1d: np.ndarray
    l2: np.ndarray
    directory: np.ndarray
    dram: np.ndarray
    network: np.ndarray
    leakage: np.ndarray
    area_mm2_per_tile: float

    @property
    def dynamic_total(self) -> np.ndarray:
        return (self.core + self.l1i + self.l1d + self.l2 + self.directory
                + self.dram + self.network)

    @property
    def total(self) -> np.ndarray:
        return self.dynamic_total + self.leakage

    def to_dict(self) -> Dict:
        d = {f.name: float(getattr(self, f.name).sum())
             for f in dataclasses.fields(self)
             if f.name != "area_mm2_per_tile"}
        d["dynamic_total"] = float(self.dynamic_total.sum())
        d["total"] = float(self.total.sum())
        d["area_mm2_per_tile"] = self.area_mm2_per_tile
        return d


def compute_energy(params, counters: Dict[str, np.ndarray],
                   completion_time_ps: int,
                   period_ps: np.ndarray) -> EnergyBreakdown:
    """Evaluate the table model on final counters.

    ``period_ps``: [T, NUM_DVFS_MODULES] int32 — each module's current
    clock period; its frequency selects the discrete voltage level whose
    square scales that module's dynamic energy (the same counters-x-
    energy-at-current-V/f evaluation McPATCoreInterface performs on its
    event counts, mcpat_core_interface.h:96-99).
    """
    tech = params.technology_node
    dyn = _NODE_DYN[_node(tech)]
    leak_f = _NODE_LEAK[_node(tech)]
    vnom = nominal_voltage(tech)
    freq = 1000.0 / np.maximum(np.asarray(period_ps, np.float64), 1.0)
    volt = voltage_for_frequency(freq, params.max_frequency_ghz, tech)
    vf2 = (volt / vnom) ** 2               # [T, M] per-module V^2 scale

    def vm(module: DVFSModule) -> np.ndarray:
        return vf2[:, int(module)]

    c = {k: np.asarray(v, np.float64) for k, v in counters.items()}
    pj = 1e-12 * dyn

    core = pj * vm(DVFSModule.CORE) * (
        _E_INST_PJ * c["icount"] + _E_BRANCH_PJ * c["branches"])
    e_l1i = _cache_access_pj(params.l1i.size_kb, params.l1i.associativity,
                             params.l1i.num_banks)
    e_l1d = _cache_access_pj(params.l1d.size_kb, params.l1d.associativity,
                             params.l1d.num_banks)
    e_l2 = _cache_access_pj(params.l2.size_kb, params.l2.associativity,
                            params.l2.num_banks)
    l1i = pj * vm(DVFSModule.L1_ICACHE) * e_l1i * c["l1i_access"]
    l1d = pj * vm(DVFSModule.L1_DCACHE) * e_l1d * (
        c["l1d_read"] + c["l1d_write"])
    l2 = pj * vm(DVFSModule.L2_CACHE) * e_l2 * c["l2_access"]
    directory = pj * vm(DVFSModule.DIRECTORY) * _E_DIR_PJ * (
        c["dir_sh_req"] + c["dir_ex_req"] + c["dir_invalidations"])
    dram = pj * _E_DRAM_PJ_PER_BYTE * params.line_size * (
        c["dram_reads"] + c["dram_writes"])
    # Flit counters tally injections; each flit traverses ~mean-hop-count
    # routers+links (2/3 of the mesh span per dimension for uniform
    # traffic) — the aggregate form of DSENT's per-hop energies.
    mean_hops = max(1.0, (params.mesh_width + params.mesh_height) / 3.0)
    e_hop = (_E_ROUTER_FLIT_PJ + _E_LINK_FLIT_PJ) * mean_hops
    network = pj * e_hop * (
        vm(DVFSModule.NETWORK_MEMORY) * c["net_mem_flits"]
        + vm(DVFSModule.NETWORK_USER) * c["net_user_flits"])

    # Leakage: P x V/Vnom x time (reference computes leakage energy per
    # interval at current voltage).
    seconds = completion_time_ps * 1e-12
    cache_kb = (params.l1i.size_kb + params.l1d.size_kb
                + (0 if params.shared_l2 else params.l2.size_kb))
    slice_kb = params.l2.size_kb if params.shared_l2 else 0
    leak_mw = (_LEAK_CORE_MW
               + _LEAK_CACHE_MW_PER_KB * (cache_kb + slice_kb)
               + _LEAK_ROUTER_MW)
    vscale = volt[:, int(DVFSModule.CORE)] / vnom
    leakage = leak_f * leak_mw * 1e-3 * seconds * vscale \
        * np.ones_like(core)

    area = (2.0 * (tech / 45.0) ** 2            # core + router
            + _cache_area_mm2(params.l1i.size_kb, tech,
                              params.l1i.num_banks)
            + _cache_area_mm2(params.l1d.size_kb, tech,
                              params.l1d.num_banks)
            + _cache_area_mm2(params.l2.size_kb, tech,
                              params.l2.num_banks))
    return EnergyBreakdown(core=core, l1i=l1i, l1d=l1d, l2=l2,
                           directory=directory, dram=dram, network=network,
                           leakage=leakage, area_mm2_per_tile=area)
