"""Network-on-chip latency models (zero-load forms).

Counterpart of ``graphite_tpu/engine/noc.py``:

  * ``magic`` — zero-latency direct delivery;
  * ``emesh_hop_counter`` — XY hop count x (router + link delay) + flit
    serialisation, no contention;
  * ``emesh_hop_by_hop`` — the same zero-load form here; with its queue
    model on, resolve flies every memory-network unicast leg of a
    conflict round hop by hop over FCFS link horizons
    (engine/noc_flight.py), and multicasts keep the zero-load form;
  * ``atac`` — the hybrid optical network (engine/noc_atac.py),
    dispatched from the functions here.

Tiles sit row-major on a ``mesh_width x mesh_height`` grid.
"""

from __future__ import annotations

import torch

from graphite_tpu_torch.engine.vparams import NetVariant, net_variant
from graphite_tpu_torch.params import NetworkParams

# NetPacket header bytes modeled on the wire.
PACKET_HEADER_BYTES = 8


def num_flits(payload_bytes, flit_width_bits):
    """Packet length in flits."""
    bits = (payload_bytes + PACKET_HEADER_BYTES) * 8
    return (bits + flit_width_bits - 1) // flit_width_bits


def hop_count(src, dst, mesh_width: int):
    """Manhattan distance under XY dimension-ordered routing."""
    sx, sy = src % mesh_width, src // mesh_width
    dx, dy = dst % mesh_width, dst // mesh_width
    return torch.abs(sx - dx) + torch.abs(sy - dy)


def serialisation(flits):
    """The tail's serialisation cycles, ``max(flits - 1, 0)``."""
    if isinstance(flits, torch.Tensor):
        return torch.clamp(flits - 1, min=0)
    return max(flits - 1, 0)


def unicast_ps(net: NetworkParams, src, dst, payload_bytes,
               period_ps, mesh_width: int, vnet: NetVariant = None):
    """Zero-load packet latency in ps (int64, shape of ``src``/``dst``)."""
    if net.model == "magic":
        return torch.zeros(torch.broadcast_shapes(src.shape, dst.shape),
                           dtype=torch.int64, device=src.device)
    if vnet is None:
        vnet = net_variant(net)
    if net.model == "atac":
        from graphite_tpu_torch.engine import noc_atac
        return noc_atac.unicast_ps(net, src, dst, payload_bytes, period_ps,
                                   vnet=vnet)
    hops = hop_count(src, dst, mesh_width)
    flits = num_flits(payload_bytes, vnet.flit_width_bits)
    cycles = hops * (vnet.router_delay_cycles + vnet.link_delay_cycles) \
        + serialisation(flits)
    return torch.as_tensor(cycles).to(torch.int64) \
        * torch.as_tensor(period_ps).to(torch.int64)


def max_hop_to_mask_ps(net: NetworkParams, src, tile_mask,
                       payload_bytes, period_ps, mesh_width: int,
                       vnet: NetVariant = None):
    """Latency of the farthest unicast from ``src`` ([K]) to any tile set in
    ``tile_mask`` ([K, T] bool); rows with no bit set return 0."""
    if net.model == "magic":
        return torch.zeros(src.shape, dtype=torch.int64, device=src.device)
    if vnet is None:
        vnet = net_variant(net)
    if net.model == "atac":
        from graphite_tpu_torch.engine import noc_atac
        return noc_atac.max_to_mask_ps(net, src, tile_mask, payload_bytes,
                                       period_ps, vnet=vnet)
    T = tile_mask.shape[-1]
    tiles = torch.arange(T, device=src.device)
    hops = hop_count(src[:, None], tiles[None, :], mesh_width)  # [K, T]
    max_hops = torch.amax(torch.where(tile_mask, hops, 0), dim=-1)
    flits = num_flits(payload_bytes, vnet.flit_width_bits)
    cycles = max_hops * (vnet.router_delay_cycles + vnet.link_delay_cycles) \
        + max(flits - 1, 0)
    cycles = torch.where(tile_mask.any(dim=-1), cycles, 0)
    return cycles.to(torch.int64) * torch.as_tensor(period_ps).to(torch.int64)
