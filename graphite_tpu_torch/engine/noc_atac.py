"""ATAC hybrid optical-broadcast network — analytic latency model.

Counterpart of ``graphite_tpu/engine/noc_atac.py`` (reference:
common/network/models/network_model_atac.{h,cc}; ATAC = electrical mesh
clusters + an optical broadcast waveguide between per-cluster hubs +
star/htree receive networks inside each cluster):

  * **ENet** — the full-chip electrical mesh; intra-cluster traffic (and,
    under ``distance_based`` routing, short unicasts) takes plain XY hops.
  * **ONet** — cross-cluster traffic rides sender ENet -> nearest optical
    access point -> the cluster's send hub -> optical waveguide -> the
    destination cluster's receive hub.
  * **Receive net** — hub to destination tile via a star router + link
    (or an htree link).

Zero-load analytic form; optical-hub contention is not modelled (nor is
it in the JAX package).  The per-tile tables derive once per (static)
``AtacParams`` in numpy and are cached as tensors per device.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Dict, Tuple

import numpy as np
import torch

from graphite_tpu_torch.engine import noc
from graphite_tpu_torch.engine.vparams import NetVariant, net_variant
from graphite_tpu_torch.params import AtacParams, NetworkParams, pow2_grid

_TABLES: Dict[Tuple[AtacParams, torch.device], Tuple[torch.Tensor, ...]] = {}


def geometry(a: AtacParams, device=None):
    """Per-tile tables on ``device``: (cluster_of [T], ap_hops [T],
    hub_of [C]), int32.

    cluster_of: cluster id per tile (getClusterID).
    ap_hops: XY hops from a tile to its nearest optical access point —
      access points sit at sub-cluster centres.
    hub_of: the hub tile of each cluster (its centre); not read by the
      pricing, exposed for tests and topology inspection.
    """
    dev = torch.device(device if device is not None else "cpu")
    key = (a, dev)
    if key not in _TABLES:
        _TABLES[key] = tuple(torch.from_numpy(x).to(dev)
                             for x in _geometry_np(a))
    return _TABLES[key]


@lru_cache(maxsize=8)
def _geometry_np(a: AtacParams):
    T, W = a.num_tiles, a.enet_width
    t = np.arange(T)
    x, y = t % W, t // W
    cx, cy = x // a.cluster_width, y // a.cluster_height
    cluster_of = cy * a.numx_clusters + cx

    # Sub-cluster factorisation over num_access_points sub-clusters per
    # cluster (the sub-cluster grid puts the long side on X).
    nsub = max(1, min(a.num_access_points, a.cluster_size))
    if nsub != 1 << (nsub.bit_length() - 1):
        nsub = 1                 # non-power-of-two: one access point
    sx, sy = pow2_grid(nsub, tall=False)
    sub_w = max(1, a.cluster_width // sx)
    sub_h = max(1, a.cluster_height // sy)
    bound_x, bound_y = cx * a.cluster_width, cy * a.cluster_height
    pos_x = np.minimum((x - bound_x) // sub_w, sx - 1)
    pos_y = np.minimum((y - bound_y) // sub_h, sy - 1)
    ap_x = bound_x + pos_x * sub_w + sub_w // 2
    ap_y = bound_y + pos_y * sub_h + sub_h // 2
    ap_hops = np.abs(x - ap_x) + np.abs(y - ap_y)

    c = np.arange(a.num_clusters)
    hub_x = (c % a.numx_clusters) * a.cluster_width + a.cluster_width // 2
    hub_y = (c // a.numx_clusters) * a.cluster_height + a.cluster_height // 2
    hub_of = hub_y * W + hub_x
    return (np.asarray(cluster_of, np.int32),
            np.asarray(ap_hops, np.int32),
            np.asarray(hub_of, np.int32))


def _enet_cycles(a: AtacParams, vnet: NetVariant, src, dst):
    """XY hop cycles on the electrical mesh (routePacketOnENet)."""
    hops = noc.hop_count(src, dst, a.enet_width)
    return hops * (vnet.router_delay_cycles + vnet.link_delay_cycles)


def onet_const_cycles(a: AtacParams, vnet: NetVariant) -> int:
    """The ONet's cycles past the sender's access point: access-point port
    -> hub, send hub, optical link, receive hub, receive net."""
    per_hop = vnet.router_delay_cycles + vnet.link_delay_cycles
    recv = vnet.atac_star_delay + vnet.link_delay_cycles \
        if a.receive_net_type == "star" else vnet.link_delay_cycles
    return (per_hop + vnet.atac_send_hub_delay + vnet.atac_optical_cycles
            + vnet.atac_receive_hub_delay + recv)


def _onet_cycles(a: AtacParams, vnet: NetVariant, src):
    """Cycles from ``src`` to ANY remote cluster's receive-net output: the
    optical path is distance-independent past the access point."""
    _, ap_hops, _ = geometry(a, src.device)
    per_hop = vnet.router_delay_cycles + vnet.link_delay_cycles
    return ap_hops[src.to(torch.int64)] * per_hop + onet_const_cycles(a, vnet)


def unicast_cycles(net: NetworkParams, src, dst, vnet: NetVariant = None):
    """Zero-load unicast cycles src -> dst under ATAC routing
    (computeGlobalRoute): same cluster -> ENet; cross-cluster -> ONet
    (cluster_based) or ENet within the unicast distance threshold
    (distance_based)."""
    a = net.atac
    if vnet is None:
        vnet = net_variant(net)
    src, dst = torch.broadcast_tensors(torch.as_tensor(src),
                                       torch.as_tensor(dst))
    cluster_of, _, _ = geometry(a, src.device)
    enet = _enet_cycles(a, vnet, src, dst)
    onet = _onet_cycles(a, vnet, src)
    same = cluster_of[src.to(torch.int64)] == cluster_of[dst.to(torch.int64)]
    if a.global_routing_strategy == "distance_based":
        hops = noc.hop_count(src, dst, a.enet_width)
        use_enet = same | (hops <= vnet.atac_unicast_threshold)
    else:
        use_enet = same
    return torch.where(use_enet, enet, onet.to(enet.dtype))


def unicast_ps(net: NetworkParams, src, dst, payload_bytes, period_ps,
               vnet: NetVariant = None):
    if vnet is None:
        vnet = net_variant(net)
    flits = noc.num_flits(payload_bytes, vnet.flit_width_bits)
    cycles = unicast_cycles(net, src, dst, vnet=vnet) \
        + noc.serialisation(flits)
    return cycles.to(torch.int64) \
        * torch.as_tensor(period_ps, device=cycles.device).to(torch.int64)


def max_to_mask_ps(net: NetworkParams, src, tile_mask, payload_bytes,
                   period_ps, vnet: NetVariant = None):
    """Farthest-unicast bound over a [K, T] destination mask (the
    directory's invalidation fan-out charge): each destination priced by
    its own route (ENet or ONet)."""
    if vnet is None:
        vnet = net_variant(net)
    T = tile_mask.shape[-1]
    tiles = torch.arange(T, dtype=torch.int32, device=src.device)
    cyc = unicast_cycles(net, src[:, None], tiles[None, :],
                         vnet=vnet)                            # [K, T]
    max_cyc = torch.amax(torch.where(tile_mask, cyc, 0), dim=-1)
    flits = noc.num_flits(payload_bytes, vnet.flit_width_bits)
    cycles = torch.where(tile_mask.any(dim=-1),
                         max_cyc + noc.serialisation(flits), 0)
    return cycles.to(torch.int64) \
        * torch.as_tensor(period_ps, device=cycles.device).to(torch.int64)


# The kernels' network kinds (engine/kernels/csrc/chain_classify.cu and
# window_walk.cu NET_*).  emesh_hop_by_hop prices as the hop counter
# wherever a kernel runs: the chain pass stands down when its links
# contend, and the window walk's spawn leg is zero-load in both packages.
KERNEL_NET_CODES = {"magic": 0, "emesh_hop_counter": 1,
                    "emesh_hop_by_hop": 1, "atac": 2}


def kernel_scalars(net: NetworkParams, vnet: NetVariant) -> dict:
    """The network's kind and ATAC constants as the kernels take them:
    ``net_kind``, ``onet_cycles`` (the ONet past the access point),
    ``atac_dist`` (distance_based routing) and ``atac_thresh``."""
    atac = net.model == "atac"
    return dict(
        net_kind=KERNEL_NET_CODES[net.model],
        onet_cycles=onet_const_cycles(net.atac, vnet) if atac else 0,
        atac_dist=int(atac and net.atac.global_routing_strategy
                      == "distance_based"),
        atac_thresh=vnet.atac_unicast_threshold if atac else 0)


def kernel_tables(net: NetworkParams, device):
    """(cluster_of, ap_hops) int32 [T] on ``device`` under atac (built
    once per params and device), else (None, None)."""
    if net.model != "atac":
        return None, None
    cluster_of, ap_hops, _ = geometry(net.atac, device)
    return cluster_of, ap_hops
