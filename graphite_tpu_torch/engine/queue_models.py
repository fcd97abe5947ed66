"""DRAM contention queue models — the ``history_list``/``history_tree``
busy-interval ring.

Counterpart of ``graphite_tpu/engine/queue_models.py`` (reference:
common/shared_models/queue_model_history_list.cc): a request arriving in
an idle gap of the controller's recorded busy intervals starts at once,
one arriving inside a busy interval waits for its end, and a batch is
serialised exactly in (arrival, row) order.  One merged interval per
(controller, batch) is recorded into an [R, C] ring.  :func:`fcfs_start`
is the horizon form of FCFS that the hop-by-hop mesh's links use
(engine/noc_flight.py).  The ``basic`` and ``m_g_1`` models are ported
in a later slice.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from graphite_tpu_torch.engine.ops import scatter

_BIG = 2**62
_NEG = -(2**62)


def _cumsum_doubling(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum in the input's dtype (log2(K) shift-adds, the
    JAX package's form; the values equal a plain cumsum)."""
    v = x
    d = 1
    K = x.shape[0]
    while d < K:
        pv = torch.cat([torch.zeros((d,), dtype=x.dtype, device=x.device),
                        v[:-d]])
        v = v + pv
        d *= 2
    return v


def fcfs_order(K: int, device):
    """([K, K] "row j before row i" on equal arrivals, [K, K] identity)."""
    rows = torch.arange(K, device=device)
    return (rows[None, :] < rows[:, None],
            torch.eye(K, dtype=torch.bool, device=device))


def fcfs_start(same, arrival, svc, horizon, tie, eye):
    """[K] FCFS service starts: row i starts at the latest of its arrival,
    its resource's ``horizon`` and the end of every earlier request on
    the same resource (``same`` [K, K]; earlier = by arrival, then by
    row), in the closed form end_i = S_i + max_{j <= i}(a_j - S_{j-1}).
    ``svc`` is 0 on rows that do not occupy; a row's own result is
    meaningful only where it is valid."""
    earlier = same & ((arrival[None, :] < arrival[:, None])
                      | ((arrival[None, :] == arrival[:, None]) & tie))
    s_prev = torch.sum(torch.where(earlier, svc[None, :], 0), dim=1)
    cand = torch.maximum(arrival, horizon) - s_prev
    return torch.amax(torch.where(earlier | eye, cand[None, :], _NEG),
                      dim=1) + s_prev


class RingFcfsResult(NamedTuple):
    start: torch.Tensor       # [K] int64 service start times
    end: torch.Tensor         # [K] int64 completion times
    delay: torch.Tensor       # [K] int64 queueing delay
    ring_start: torch.Tensor  # [R, C] updated busy-interval ring
    ring_end: torch.Tensor
    ring_ptr: torch.Tensor    # [C] int32 next slot


def _containing_end(res, t, svc, ring_start, ring_end):
    """[K] earliest feasible start >= t of a ``svc``-long service given the
    recorded busy intervals of resource ``res``."""
    rs = ring_start[:, res]                   # [R, K]
    re = ring_end[:, res]
    overlap = (rs < t[None, :] + svc[None, :]) & (t[None, :] < re)
    return torch.amax(torch.where(overlap, re, t[None, :]), dim=0)


def _merged(res_m, valid_m, s_m, e_m, C):
    """Per-resource [min start, max end] over the valid rows."""
    lo = scatter(torch.full((C,), _BIG, dtype=torch.int64,
                            device=s_m.device), res_m, s_m, "min",
                 mask=valid_m)
    hi = scatter(torch.zeros((C,), dtype=torch.int64, device=s_m.device),
                 res_m, e_m, "max", mask=valid_m)
    return lo, hi, hi > 0


def _record(ring_start, ring_end, ring_ptr, lo, hi, has):
    R, C = ring_start.shape
    cols = torch.arange(C, device=lo.device)
    slot = ring_ptr % R
    ring_start = scatter(ring_start, (slot, cols), torch.where(has, lo, 0),
                         "set", mask=has)
    ring_end = scatter(ring_end, (slot, cols), torch.where(has, hi, 0),
                       "set", mask=has)
    return ring_start, ring_end, ring_ptr + has.to(torch.int32)


def fcfs_ring(resource, arrival, service, valid, ring_start, ring_end,
              ring_ptr, occ_res=None, occ_arr=None, occ_svc=None,
              occ_valid=None, record_split: int = 1) -> RingFcfsResult:
    """Exact-within-batch FCFS against a bounded busy-interval history
    (graphite_tpu/engine/queue_models.py fcfs_ring).

    ``record_split`` > 1 (the chain replay's batches, which mix tiles at
    very different simulated times) records TWO merged intervals per
    controller — the requests starting below / above the midpoint of the
    controller's batch span — instead of one."""
    K = resource.shape[0]
    R, C = ring_start.shape
    dev = arrival.device
    res_eff = torch.where(valid, resource, C).to(torch.int64)
    res_g = torch.clamp(res_eff, max=C - 1)
    idx = torch.arange(K, dtype=torch.int32, device=dev)
    svc = torch.where(valid, service, 0)

    base = arrival
    for _ in range(3):
        base = _containing_end(res_g, base, svc, ring_start, ring_end)
    base = torch.where(valid, base, arrival)

    same = valid[None, :] & valid[:, None] \
        & (res_eff[None, :] == res_eff[:, None])
    earlier = same & ((arrival[None, :] < arrival[:, None])
                      | ((arrival[None, :] == arrival[:, None])
                         & (idx[None, :] < idx[:, None])))
    S_prev = torch.sum(torch.where(earlier, svc[None, :], 0), dim=1)
    cand = base - S_prev
    self_or_earlier = earlier | (torch.eye(K, dtype=torch.bool, device=dev)
                                 & valid[:, None])
    run = torch.amax(torch.where(self_or_earlier, cand[None, :], _NEG),
                     dim=1)
    start = run + S_prev
    end = start + svc
    delay = torch.where(valid, start - arrival, 0)

    if record_split > 1:
        loF, hiF, _ = _merged(res_eff, valid, start, end, C)
        # (loF is the BIG sentinel on empty controllers: the half-
        # difference form cannot overflow.)
        mid = loF + (torch.maximum(hiF, loF) - loF) // 2     # [C]
        grpA = valid & (start < mid[res_g])
        groups = (grpA, valid & ~grpA)
    else:
        groups = (valid,)
    for grp in groups:
        lo, hi, has = _merged(res_eff, grp, start, end, C)
        ring_start, ring_end, ring_ptr = _record(ring_start, ring_end,
                                                 ring_ptr, lo, hi, has)
    if occ_res is not None:
        occ_end = occ_arr + occ_svc
        lo2, hi2, has2 = _merged(
            torch.where(occ_valid, occ_res, C).to(torch.int64),
            occ_valid, occ_arr, occ_end, C)
        ring_start, ring_end, ring_ptr = _record(
            ring_start, ring_end, ring_ptr, lo2, hi2, has2)
    return RingFcfsResult(start=torch.where(valid, start, 0),
                          end=torch.where(valid, end, 0),
                          delay=delay, ring_start=ring_start,
                          ring_end=ring_end, ring_ptr=ring_ptr)


def insert_busy(ring_start, ring_end, ring_ptr, res, t0, svc, valid):
    """Occupancy-only insertion: one merged busy interval per
    (resource, call)."""
    R, C = ring_start.shape
    svc = torch.broadcast_to(torch.as_tensor(svc, dtype=torch.int64,
                                             device=t0.device), t0.shape)
    r_eff = torch.where(valid, res, C).to(torch.int64)
    lo, hi, has = _merged(r_eff, valid, t0, t0 + svc, C)
    return _record(ring_start, ring_end, ring_ptr, lo, hi, has)


def _history_only(qtype: str):
    if qtype not in ("history_list", "history_tree"):
        raise NotImplementedError(
            f"dram queue model {qtype!r} is ported in a later slice "
            f"(model breadth)")


def probe(qtype: str, resource, arrival, service, valid,
          ring_start, ring_end, ring_ptr, moments,
          occ_res=None, occ_arr=None, occ_svc=None, occ_valid=None,
          ma_window: int = 0, record_split: int = 1):
    """Config-dispatched queue probe: returns (start, end, delay,
    ring_start, ring_end, ring_ptr, moments).  ``record_split`` > 1
    records split busy intervals (see :func:`fcfs_ring`)."""
    _history_only(qtype)
    q = fcfs_ring(resource, arrival, service, valid, ring_start, ring_end,
                  ring_ptr, occ_res=occ_res, occ_arr=occ_arr,
                  occ_svc=occ_svc, occ_valid=occ_valid,
                  record_split=record_split)
    return (q.start, q.end, q.delay, q.ring_start, q.ring_end, q.ring_ptr,
            moments)


def occupy(qtype: str, ring_start, ring_end, ring_ptr, moments,
           res, t0, svc, valid, ma_window: int = 0):
    """Occupancy-only insertion dispatched by type (writebacks off the
    critical path).  Returns (ring_start, ring_end, ring_ptr, moments)."""
    _history_only(qtype)
    rs, re, rp = insert_busy(ring_start, ring_end, ring_ptr, res, t0, svc,
                             valid)
    return rs, re, rp, moments
