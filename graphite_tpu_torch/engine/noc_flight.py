"""Contended hop-by-hop mesh traversal (emesh_hop_by_hop with its queue
model on).

Counterpart of ``graphite_tpu/engine/noc_flight.py`` (reference:
common/network/models/network_model_emesh_hop_by_hop.cc routePacket):
every in-flight packet advances one XY hop per iteration, and each
iteration is ONE exact FCFS sweep over the 4*T directed mesh links
(engine/queue_models.fcfs_start, with what depends only on the routes
computed once for every hop), so the same-link packets of a batch
serialise in arrival order against the link's carried horizon
(``link_free``).  A packet's head advances router + link cycles per hop;
each traversed link stays busy for the packet's flit count, and the
tail's (flits - 1)-cycle serialisation is charged once at the
destination, which is the zero-load hop-counter formula on idle links.

The JAX package loops while any packet is in flight, at most
``(W - 1) + (H - 1)`` times.  An iteration with nothing in flight changes
nothing (fcfs with every row invalid leaves the horizons alone), so this
form runs exactly ``(W - 1) + (H - 1)`` iterations and never polls the
host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from graphite_tpu_torch.engine import queue_models
from graphite_tpu_torch.engine.vparams import NetVariant, net_variant
from graphite_tpu_torch.params import NetworkParams

# Link direction codes (outgoing link of a tile).
DIR_E, DIR_W, DIR_N, DIR_S = 0, 1, 2, 3
NUM_DIRS = 4


def make_link_free(num_tiles: int, device=None) -> torch.Tensor:
    """[NUM_DIRS, T] int64 per-directed-link busy horizons."""
    return torch.zeros((NUM_DIRS, num_tiles), dtype=torch.int64,
                       device=device)


def _xy_routes(src, dst, active, mesh_width: int, max_hops: int, T: int):
    """Every packet's XY dimension-ordered route, hop by hop (X first,
    then Y; reference computeNextDest): ([max_hops, K] directed-link id
    ``dir * T + pos`` of hop h, [max_hops, K] bool "flies hop h").

    A packet n = |dx| + |dy| hops away flies hops 0 .. n - 1: the JAX
    package's loop state (position, in-flight flag) follows from the hop
    index alone, so the whole route is known before the first hop is
    served."""
    sx, sy = src % mesh_width, src // mesh_width
    tx, ty = dst % mesh_width, dst // mesh_width
    nx = torch.abs(tx - sx)
    n = nx + torch.abs(ty - sy)
    h = torch.arange(max_hops, device=src.device)[:, None]
    in_x = h < nx
    px = torch.where(in_x, sx + torch.sign(tx - sx) * h, tx)
    py = torch.where(in_x, sy, sy + torch.sign(ty - sy) * (h - nx))
    d = torch.where(in_x, torch.where(tx > sx, DIR_E, DIR_W),
                    torch.where(ty > sy, DIR_N, DIR_S))
    link = d * T + py * mesh_width + px
    return link, active & (h < n)


class FlightResult(NamedTuple):
    arrival: torch.Tensor    # [K] int64 — tail arrival at the destination
    wait_ps: torch.Tensor    # [K] int64 — total queueing delay en route
    link_free: torch.Tensor  # [NUM_DIRS, T] updated horizons


def flight(net: NetworkParams, mesh_width: int, mesh_height: int,
           src: torch.Tensor, dst: torch.Tensor, depart: torch.Tensor,
           flits, active: torch.Tensor, link_free: torch.Tensor,
           period_ps: torch.Tensor, vnet: NetVariant = None) -> FlightResult:
    """Fly a batch of packets src -> dst, contending on shared links.

    src/dst: [K] tiles; depart: [K] int64 ps; flits: int or [K]; active:
    [K] bool (inactive packets neither move nor occupy); period_ps: [K]
    ps per network cycle of the sender, used for the whole path as in
    the zero-load model.

    On CUDA tensors the flight replays a CUDA graph of :func:`fly`
    (captured once per batch size, tile count, mesh and network delays:
    the hundreds of small ops of its fixed-trip loop in one launch, with
    the operands copied into the graph's own buffers and the results
    copied out); on CPU tensors :func:`fly` runs as it is.
    """
    if vnet is None:
        vnet = net_variant(net)
    K = src.shape[0]
    dev = depart.device
    fl = torch.broadcast_to(
        torch.as_tensor(flits, device=dev).to(torch.int64), (K,))
    args = (src, dst, depart, fl, active, link_free, period_ps)
    if dev.type == "cuda":
        key = (K, link_free.shape[1], mesh_width, mesh_height,
               vnet.router_delay_cycles + vnet.link_delay_cycles, dev)
        graph = _GRAPHS.get(key)
        if graph is None:
            graph = _GRAPHS[key] = _GraphedFlight(
                mesh_width, mesh_height, key[4], args)
        return graph(args)
    return fly(mesh_width, mesh_height,
               vnet.router_delay_cycles + vnet.link_delay_cycles, *args)


class _GraphedFlight:
    """:func:`fly` captured as one CUDA graph over static operand
    buffers."""

    def __init__(self, mesh_width, mesh_height, hop_cycles, args):
        self.static = [torch.empty_like(a, dtype=torch.int64)
                       if a.dtype != torch.bool else torch.empty_like(a)
                       for a in args]
        self._load(args)

        def run():
            return fly(mesh_width, mesh_height, hop_cycles, *self.static)

        side = torch.cuda.Stream(device=args[2].device)
        side.wait_stream(torch.cuda.current_stream(args[2].device))
        with torch.cuda.stream(side):
            for _ in range(2):               # warm-up before the capture
                run()
        torch.cuda.current_stream(args[2].device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.out = run()

    def _load(self, args):
        for buf, a in zip(self.static, args):
            buf.copy_(a)

    def __call__(self, args) -> FlightResult:
        self._load(args)
        self.graph.replay()
        return FlightResult(*(t.clone() for t in self.out))


# (batch, tiles, mesh width, mesh height, hop cycles, device) -> graph
_GRAPHS = {}


def fly(mesh_width: int, mesh_height: int, hop_cycles: int, src, dst,
        depart, fl, active, link_free, period_ps) -> FlightResult:
    """:func:`flight`'s arithmetic: ``fl`` the [K] flit counts and
    ``hop_cycles`` the router + link cycles of one hop."""
    T = link_free.shape[1]
    R = NUM_DIRS * T
    K = src.shape[0]
    dev = depart.device
    i64 = torch.int64
    max_hops = (mesh_width - 1) + (mesh_height - 1)
    per = period_ps.to(i64)
    hop_ps = hop_cycles * per
    occ = fl * per                       # per-link serialisation occupancy

    # A packet that does not fly hop h takes the resource id -1 - row,
    # which no other row shares; the horizons are read at the clamped id
    # and written back by a scatter-max that sends rows off the link
    # range (a packet that does not fly, or a link id past 4 T on a mesh
    # that T does not fill) to a scratch slot, as mode="drop" drops them.
    link, flies = _xy_routes(src.to(i64), dst.to(i64), active, mesh_width,
                             max_hops, T)
    rows = torch.arange(K, device=dev)
    res = torch.where(flies, link, -1 - rows)
    rd = torch.clamp(res, 0, R - 1)
    sc = torch.where(flies & (res < R), res, R)
    svc = torch.where(flies, occ, 0)
    tie, eye = queue_models.fcfs_order(K, dev)
    lf = torch.cat([link_free.reshape(-1), link_free.new_zeros(1)])
    t = torch.where(active, depart, 0)
    wait = torch.zeros(K, dtype=i64, device=dev)
    for h in range(max_hops):
        r, f, sv = res[h], flies[h], svc[h]
        start = queue_models.fcfs_start(r[None, :] == r[:, None], t, sv,
                                        lf[rd[h]], tie, eye)
        lf.scatter_reduce_(0, sc[h], start + sv, "amax")
        wait = wait + torch.where(f, start - t, 0)
        t = torch.where(f, start + hop_ps, t)
    arrival = torch.where(active, t + torch.clamp(fl - 1, min=0) * per, 0)
    return FlightResult(arrival=arrival, wait_ps=wait,
                        link_free=lf[:R].reshape(NUM_DIRS, T))
