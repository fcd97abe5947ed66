"""Timing operands of one run — counterpart of
``graphite_tpu/engine/vparams.py``.

The JAX engine passes its derived integer timing constants as a pytree
of traced scalars so the sweep engine can ``vmap`` config variants.  The
port runs one configuration at a time, so the same leaves are plain
Python ints (exact integer math, derived the same way); a batched sweep
form belongs to a later slice.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

from graphite_tpu_torch.params import NetworkParams, SimParams


class NetVariant(NamedTuple):
    """One logical network's numeric delays and widths (ints)."""

    flit_width_bits: int
    router_delay_cycles: int
    link_delay_cycles: int
    atac_send_hub_delay: int
    atac_receive_hub_delay: int
    atac_star_delay: int
    atac_optical_cycles: int
    atac_unicast_threshold: int


def net_variant(net: NetworkParams) -> NetVariant:
    a = net.atac
    return NetVariant(
        flit_width_bits=int(net.flit_width_bits),
        router_delay_cycles=int(net.router_delay_cycles),
        link_delay_cycles=int(net.link_delay_cycles),
        atac_send_hub_delay=int(a.send_hub_router_delay if a else 0),
        atac_receive_hub_delay=int(a.receive_hub_router_delay if a else 0),
        atac_star_delay=int(a.star_net_router_delay if a else 0),
        atac_optical_cycles=int(a.optical_link_delay_cycles if a else 0),
        atac_unicast_threshold=int(a.unicast_distance_threshold if a else 0),
    )


class VariantParams(NamedTuple):
    """Timing operands of one simulation run (Python ints)."""

    quantum_ps: int
    thread_switch_quantum_ps: int
    fast_forward_span_ps: int
    bp_mispredict_penalty: int
    dvfs_sync_delay_cycles: int
    syscall_cost_cycles: Tuple[int, ...]
    l1i_access_cycles: int
    l1d_access_cycles: int
    l2_access_cycles: int
    l2_tags_access_cycles: int
    dir_access_cycles: int
    limitless_trap_cycles: int
    inv_ack_cycles: int
    dram_latency_ps: int
    dram_processing_ps: int
    net_user: NetVariant
    net_memory: NetVariant


def variant_params(params: SimParams) -> VariantParams:
    """Derive the operands from a ``SimParams`` (exact integer math, the
    same derivations as the JAX package)."""
    return VariantParams(
        quantum_ps=int(params.quantum_ps),
        thread_switch_quantum_ps=int(params.thread_switch_quantum_ps),
        fast_forward_span_ps=int(params.fast_forward_span_ps),
        bp_mispredict_penalty=int(params.core.bp_mispredict_penalty),
        dvfs_sync_delay_cycles=int(params.dvfs_sync_delay_cycles),
        syscall_cost_cycles=tuple(int(c)
                                  for c in params.syscall_cost_cycles),
        l1i_access_cycles=int(params.l1i.access_cycles),
        l1d_access_cycles=int(params.l1d.access_cycles),
        l2_access_cycles=int(params.l2.access_cycles),
        l2_tags_access_cycles=int(params.l2.tags_access_cycles),
        dir_access_cycles=int(params.directory.access_cycles),
        limitless_trap_cycles=int(params.directory.limitless_trap_cycles),
        inv_ack_cycles=int(params.directory.inv_ack_cycles),
        dram_latency_ps=int(params.dram.latency_ps),
        dram_processing_ps=int(
            params.dram.processing_ps_per_line(params.line_size)),
        net_user=net_variant(params.net_user),
        net_memory=net_variant(params.net_memory),
    )
