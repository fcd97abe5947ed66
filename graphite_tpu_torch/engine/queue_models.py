"""DRAM contention queue models: the ``history_list`` / ``history_tree``
busy-interval ring, the ``basic`` horizon with its moving average, and
the analytic ``m_g_1``.

Counterpart of ``graphite_tpu/engine/queue_models.py`` (reference:
common/shared_models/queue_model_{history_list,basic,m_g_1}.cc).  The
history ring: a request arriving in an idle gap of the controller's
recorded busy intervals starts at once, one arriving inside a busy
interval waits for its end, and a batch is serialised exactly in
(arrival, row) order; one merged interval per (controller, batch) is
recorded into an [R, C] ring.  ``basic`` carries one horizon per
controller (ring slot 0) and, with its moving average on, charges the
delay against an exponentially averaged arrival time kept in rows 4-5
of the float64 ``dram_qacc`` leaf; ``m_g_1`` prices a batch from the
service-time moments in rows 0-3.  The float arithmetic follows the
JAX package's operation order, so ``dram_qacc`` matches it bit for
bit: every float sum adds integer-valued float64 (counts, picosecond
times and their squares), exact in any order below 2**53, and the
moving average's decay ``(1 - 1/W) ** n`` comes from a table made on
the host (:func:`keep_table`).  Where XLA's CPU code fuses a multiply
into the add that consumes it (the average's blends, the M/G/1
variance), the port rounds once too (``ops.fma``).  :func:`fcfs_start`
is the horizon form of FCFS that the hop-by-hop mesh's links use
(engine/noc_flight.py).
"""

from __future__ import annotations

import functools
import math
import sys
from typing import NamedTuple

import numpy as np
import torch

from graphite_tpu_torch.engine.ops import fma, scatter
from graphite_tpu_torch.params import QUEUE_MODEL_TYPES

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
    R, C = ring_start.shape
    res_eff = torch.where(valid, resource, C).to(torch.int64)
    res_g = torch.clamp(res_eff, max=C - 1)
    svc = torch.where(valid, service, 0)

    base = arrival
    for _ in range(3):
        base = _containing_end(res_g, base, svc, ring_start, ring_end)
    base = torch.where(valid, base, arrival)

    start, end = _serial_fcfs(base, svc, valid,
                              _earlier_mask(res_eff, arrival, valid))
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


# The types the config may select.
VALID_TYPES = QUEUE_MODEL_TYPES


def _unknown(qtype: str):
    return ValueError(f"unknown queue model type {qtype!r} "
                      f"(valid: {', '.join(VALID_TYPES)})")


def _earlier_mask(res_eff, arrival, valid):
    """[K, K] bool: row j is served before row i (same resource, FCFS by
    (arrival, row))."""
    K = res_eff.shape[0]
    idx = torch.arange(K, device=res_eff.device)
    same = valid[None, :] & valid[:, None] \
        & (res_eff[None, :] == res_eff[:, None])
    return same & ((arrival[None, :] < arrival[:, None])
                   | ((arrival[None, :] == arrival[:, None])
                      & (idx[None, :] < idx[:, None])))


def _serial_fcfs(base, svc, valid, earlier):
    """(start, end) of rows served per resource in the order ``earlier``
    gives, each starting no earlier than its own ``base``: end_i = S_i +
    max_{j <= i}(base_j - S_{j-1}), as a dense pairwise compare."""
    K = base.shape[0]
    S_prev = torch.sum(torch.where(earlier, svc[None, :], 0), dim=1)
    cand = base - S_prev
    self_or_earlier = earlier | (torch.eye(K, dtype=torch.bool,
                                           device=base.device)
                                 & valid[:, None])
    run = torch.amax(torch.where(self_or_earlier, cand[None, :], _NEG),
                     dim=1)
    start = run + S_prev
    return start, start + svc


@functools.lru_cache(maxsize=64)
def keep_table(window: int, n: int, device) -> torch.Tensor:
    """[n + 1] float64 on ``device``: ``(1 - 1/window) ** k`` for k = 0..n,
    bit for bit the JAX package's ``jnp.power`` of the same float64
    operands (the moving average's decay over k samples of one batch).
    ``torch.pow`` differs from it in the last bits, so the table is made
    on the host, once per (window, batch length, device), with glibc's
    pow (which XLA's float64 power matches) and the results below the
    smallest normal flushed to zero, as XLA's CPU runtime flushes them.
    Callers only read it."""
    base = 1.0 - 1.0 / window
    out = np.array([math.pow(base, k) for k in range(n + 1)],
                   dtype=np.float64)
    out[np.abs(out) < sys.float_info.min] = 0.0
    return torch.from_numpy(out).to(device)


def _ma_ref_time(arrival, res_eff, earlier_mask, ma_mean, ma_n, window, C):
    """Per-row reference time: the moving average of the arrivals up to
    and including the row (reference QueueModelBasic::computeQueueDelay),
    the carried exponential average blended with the exact prefix mean
    of the batch."""
    res_g = torch.clamp(res_eff, max=C - 1)
    m0 = ma_mean[res_g]
    n0 = ma_n[res_g]
    arr_f = arrival.to(torch.float64)
    pref_n = torch.sum(earlier_mask, dim=1).to(torch.float64) + 1.0
    pref_sum = torch.sum(torch.where(earlier_mask, arr_f[None, :], 0.0),
                         dim=1) + arr_f
    pref_mean = pref_sum / pref_n
    n0w = torch.clamp(n0, max=float(window))
    w_hist = torch.where(n0 > 0.0, n0w / (n0w + pref_n), 0.0)
    # w * m0 + (1 - w) * mean, with the first product fused into the add
    # as XLA compiles it (ops.fma).
    return fma(w_hist, m0, (1.0 - w_hist) * pref_mean)


def _ma_update(ma_mean, ma_n, res_eff, arrival, valid, window, C):
    """Fold a batch of arrivals into the per-resource average: (mean,
    samples capped at the window)."""
    dev = arrival.device
    arr_f = torch.where(valid, arrival, 0).to(torch.float64)
    zeros = torch.zeros((C,), dtype=torch.float64, device=dev)
    cnt = scatter(zeros, res_eff, 1.0, "add", mask=valid)
    tot = scatter(zeros, res_eff, arr_f, "add", mask=valid)
    batch_mean = tot / torch.clamp(cnt, min=1.0)
    keep = keep_table(window, res_eff.shape[0], dev)[cnt.to(torch.int64)]
    new_mean = torch.where(cnt > 0,
                           fma(keep, ma_mean, (1.0 - keep) * batch_mean),
                           ma_mean)
    # The first batch seeds the mean.
    new_mean = torch.where((ma_n == 0.0) & (cnt > 0), batch_mean, new_mean)
    return new_mean, torch.clamp(ma_n + cnt, max=float(window))


def basic_ring(resource, arrival, service, valid, ring_start, ring_end,
               ring_ptr, occ_res=None, occ_arr=None, occ_svc=None,
               occ_valid=None, moments=None, ma_window: int = 0):
    """The reference's ``basic`` model (queue_model_basic.cc:36-63): one
    carried horizon per resource, in ring slot 0 (``ring_end[0]``);
    delay = max(0, queue_time - ref_time), queue_time = max(queue_time,
    ref_time) + service.  ``ref_time`` is the arrival, or with
    ``ma_window`` > 0 its moving average (rows 4-5 of ``moments``).
    Request and occupancy rows serialise together in FCFS order on top
    of the horizon (the reference charges every probe).  Returns
    (RingFcfsResult, moments)."""
    K = resource.shape[0]
    R, C = ring_start.shape
    if occ_res is not None:
        resource = torch.cat([resource, occ_res])
        arrival = torch.cat([arrival, occ_arr])
        service = torch.cat([service, occ_svc])
        valid = torch.cat([valid, occ_valid])
    res_eff = torch.where(valid, resource, C).to(torch.int64)
    svc = torch.where(valid, service, 0)
    horizon = ring_end[0]                                    # [C]

    # One ordering mask serves the average's prefix and the FCFS
    # serialisation: both order by true arrival.
    earlier_m = _earlier_mask(res_eff, arrival, valid)
    if ma_window > 0 and moments is not None:
        ref_f = _ma_ref_time(arrival, res_eff, earlier_m, moments[4],
                             moments[5], ma_window, C)
        ref = torch.where(valid, ref_f.to(torch.int64), arrival)
        new_mean, new_n = _ma_update(moments[4], moments[5], res_eff,
                                     arrival, valid, ma_window, C)
        moments = torch.cat([moments[:4], new_mean[None], new_n[None],
                             moments[6:]])
    else:
        ref = arrival

    # The serialisation runs on ref times; the charged delay is
    # queue_time - ref_time, applied from the true arrival.
    base = torch.maximum(ref, horizon[torch.clamp(res_eff, max=C - 1)])
    start_srl, end_srl = _serial_fcfs(base, svc, valid, earlier_m)
    delay = torch.where(valid, torch.clamp(start_srl - ref, min=0), 0)
    start = arrival + delay
    end = start + svc
    new_h = scatter(horizon, res_eff, end_srl, "max", mask=valid)
    return RingFcfsResult(
        start=torch.where(valid, start, 0)[:K],
        end=torch.where(valid, end, 0)[:K], delay=delay[:K],
        ring_start=ring_start,
        ring_end=torch.cat([new_h[None], ring_end[1:]]),
        ring_ptr=ring_ptr), moments


def _absorb(m, res, arr, svc, val, C):
    """Fold rows into the M/G/1 moments (sum_s, sum_s^2, n, newest)."""
    sv = torch.where(val, svc, 0).to(torch.float64)
    r = torch.where(val, res, C).to(torch.int64)
    rows = [torch.full_like(r, k) for k in range(4)]
    m = scatter(m, (rows[0], r), sv, "add")
    m = scatter(m, (rows[1], r), sv * sv, "add")
    m = scatter(m, (rows[2], r),
                torch.where(val, 1.0, 0.0).to(torch.float64), "add")
    return scatter(m, (rows[3], r), torch.where(
        val, (arr + svc).to(torch.float64), 0.0), "max")


def mg1_delay(resource, arrival, service, valid, moments, occ_res=None,
              occ_arr=None, occ_svc=None, occ_valid=None):
    """The reference's M/G/1 wait (queue_model_m_g_1.cc:18-47) from the
    carried moments (rows 0-3 of ``moments``: sum_s, sum_s^2, n, newest
    arrival per resource):

        W = 0.5 * mu * lam * (1/mu^2 + Var[s]) / (mu - lam),
        mu = n / sum_s,  lam = n / newest,  lam <= 0.999 mu.

    The batch is priced from the moments before it, which then absorb
    it (occupancy rows too).  Returns (start, end, delay, moments)."""
    C = moments.shape[1]
    res_eff = torch.where(valid, resource, C).to(torch.int64)
    sum_s, sum_s2, n, newest = moments[0], moments[1], moments[2], \
        moments[3]
    have = n > 0
    nn = torch.clamp(n, min=1.0)
    q = sum_s / nn
    var = fma(-q, q, sum_s2 / nn)          # sum_s2 / nn - q * q, fused
    mu = nn / torch.clamp(sum_s, min=1.0)                    # 1/ps
    lam = nn / torch.clamp(newest, min=1.0)
    lam = torch.minimum(lam, 0.999 * mu)
    w = 0.5 * mu * lam * (1.0 / (mu * mu) + var) / (mu - lam)
    w_c = torch.where(have, torch.ceil(w), 0.0).to(torch.int64)    # [C]
    delay = torch.where(valid, w_c[torch.clamp(res_eff, max=C - 1)], 0)
    start = arrival + delay
    end = start + torch.where(valid, service, 0)
    new_m = _absorb(moments, res_eff, start, service, valid, C)
    if occ_res is not None:
        new_m = _absorb(new_m, occ_res, occ_arr, occ_svc, occ_valid, C)
    return start, end, delay, new_m


def probe(qtype: str, resource, arrival, service, valid,
          ring_start, ring_end, ring_ptr, moments,
          occ_res=None, occ_arr=None, occ_svc=None, occ_valid=None,
          ma_window: int = 0, record_split: int = 1):
    """Config-dispatched queue probe (reference QueueModel::create):
    returns (start, end, delay, ring_start, ring_end, ring_ptr,
    moments).  ``record_split`` > 1 records split busy intervals (the
    history types; see :func:`fcfs_ring`)."""
    if qtype in ("history_list", "history_tree"):
        q = fcfs_ring(resource, arrival, service, valid, ring_start,
                      ring_end, ring_ptr, occ_res=occ_res, occ_arr=occ_arr,
                      occ_svc=occ_svc, occ_valid=occ_valid,
                      record_split=record_split)
        return (q.start, q.end, q.delay, q.ring_start, q.ring_end,
                q.ring_ptr, moments)
    if qtype == "basic":
        q, moments2 = basic_ring(
            resource, arrival, service, valid, ring_start, ring_end,
            ring_ptr, occ_res=occ_res, occ_arr=occ_arr, occ_svc=occ_svc,
            occ_valid=occ_valid, moments=moments, ma_window=ma_window)
        return (q.start, q.end, q.delay, q.ring_start, q.ring_end,
                q.ring_ptr, moments2)
    if qtype == "m_g_1":
        start, end, delay, new_m = mg1_delay(
            resource, arrival, service, valid, moments, occ_res=occ_res,
            occ_arr=occ_arr, occ_svc=occ_svc, occ_valid=occ_valid)
        return start, end, delay, ring_start, ring_end, ring_ptr, new_m
    raise _unknown(qtype)


def occupy(qtype: str, ring_start, ring_end, ring_ptr, moments,
           res, t0, svc, valid, ma_window: int = 0):
    """Occupancy-only insertion dispatched by type (writebacks off the
    critical path).  Returns (ring_start, ring_end, ring_ptr, moments).
    To ``basic`` an occupancy row is a probe like any other (it advances
    the horizon and the average); ``m_g_1`` absorbs it into the
    moments."""
    if qtype in ("history_list", "history_tree"):
        rs, re, rp = insert_busy(ring_start, ring_end, ring_ptr, res, t0,
                                 svc, valid)
        return rs, re, rp, moments
    svc_b = torch.broadcast_to(torch.as_tensor(svc, dtype=torch.int64,
                                               device=t0.device), t0.shape)
    if qtype == "basic":
        q, moments2 = basic_ring(res, t0, svc_b, valid, ring_start,
                                 ring_end, ring_ptr, moments=moments,
                                 ma_window=ma_window)
        return ring_start, q.ring_end, ring_ptr, moments2
    if qtype == "m_g_1":
        return ring_start, ring_end, ring_ptr, _absorb(
            moments, res, t0, svc_b, valid, moments.shape[1])
    raise _unknown(qtype)
