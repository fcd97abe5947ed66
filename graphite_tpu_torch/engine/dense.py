"""Dense one-hot primitives and the FCFS election helpers.

Counterpart of ``graphite_tpu/engine/dense.py``.  The JAX engine routes
hot-path indexed access through one-hot masks because XLA:TPU serialises
real gathers and scatters; the port keeps the same dense forms wherever
their VALUES matter (elections, ranks) so both packages compute the same
integers, and uses plain gathers where only the value is observable.

Hash keys and sharer bitmaps are ``uint64`` in JAX and ``int64`` with the
same bits here (engine/ops.py).
"""

from __future__ import annotations

import torch

from graphite_tpu_torch.engine.ops import lshr, scatter
from graphite_tpu_torch.params import SimParams

DENSE_MAX_ELEMS = 1 << 22

_FMIX_MUL = 0xFF51AFD7ED558CCD - (1 << 64)     # the uint64 constant's bits


def fmix64(x: torch.Tensor) -> torch.Tensor:
    """64-bit avalanche mix (MurmurHash3 fmix64, one multiply round) on
    int64 bit patterns: logical shifts, wrapping multiply."""
    x = x.to(torch.int64)
    x = x ^ lshr(x, 33)
    x = x * _FMIX_MUL
    x = x ^ lshr(x, 33)
    return x


def onehot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """[R, n] bool: oh[r, j] = (idx[r] == j)."""
    return idx[:, None] == torch.arange(n, dtype=idx.dtype,
                                        device=idx.device)[None, :]


def sel(oh: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """Dense gather vals[idx]: [R, n] one-hot x [n] -> [R]."""
    return torch.sum(torch.where(oh, vals[None, :], 0), dim=1,
                     dtype=vals.dtype)


def binsum(oh: torch.Tensor, mask: torch.Tensor, val) -> torch.Tensor:
    """Dense scatter-add: per-bin sum of val[r] over rows with mask ->
    [n] int64."""
    v = torch.as_tensor(val, dtype=torch.int64, device=oh.device)
    v = torch.broadcast_to(v.reshape(-1, 1), oh.shape) if v.ndim else \
        torch.full(oh.shape, int(v), dtype=torch.int64, device=oh.device)
    return torch.sum(torch.where(oh & mask[:, None], v, 0), dim=0)


def binmax(oh: torch.Tensor, mask: torch.Tensor, val: torch.Tensor,
           init) -> torch.Tensor:
    """Dense scatter-max: per-bin max of val[r] over rows with mask."""
    return torch.amax(torch.where(oh & mask[:, None], val[:, None], init),
                      dim=0)


def stacked_set_table(idx: torch.Tensor, mask: torch.Tensor,
                      vals: torch.Tensor, tbl: torch.Tensor) -> torch.Tensor:
    """tbl[f, idx[r]] = vals[f, r] where mask[r], one scatter for all F
    rows of ``tbl`` ([F, size]).  Callers guarantee at most one masked
    row per index value, so duplicate-index order never matters."""
    F = tbl.shape[0]
    fr = torch.arange(F, device=tbl.device)[:, None]
    return scatter(tbl, (fr, idx[None, :]), vals, "set", mask=mask[None, :])


BIG = 2**62


def home_fold(line: torch.Tensor, n: int) -> torch.Tensor:
    """Line -> home slot in [0, n), the bits above the slot index
    XOR-folded in first (graphite_tpu/engine/dense.py home_fold)."""
    bits = max(n.bit_length() - 1, 1)
    x = line ^ (line >> bits) ^ (line >> (2 * bits)) ^ (line >> (3 * bits))
    return (x % n).to(torch.int32)


def home_of_line(params: SimParams, line: torch.Tensor) -> torch.Tensor:
    """Home (memory-controller/directory) tile of a line."""
    return home_fold(line, params.dram.num_controllers) \
        * params.dram.controller_home_stride


def dram_site_of_line(params: SimParams, line: torch.Tensor) -> torch.Tensor:
    """Memory-controller tile for a line (== home for private L2)."""
    return home_fold(line, params.dram.num_controllers) \
        * params.dram.controller_home_stride


def dir_set_of_line(params: SimParams, line: torch.Tensor) -> torch.Tensor:
    """Directory set within a home tile, XOR-folding the high line bits."""
    ndsets = params.directory.num_sets
    nslices = params.dram.num_controllers
    x = line // nslices
    bits = ndsets.bit_length() - 1
    x = x ^ (x >> bits) ^ (x >> (2 * bits)) ^ (x >> (3 * bits))
    return (x % ndsets).to(torch.int32)


def fcfs_keys(active: torch.Tensor, issue: torch.Tensor) -> torch.Tensor:
    """Per-row FCFS key ordered by (issue, tile), unique per row."""
    T = issue.shape[0]
    rows = torch.arange(T, device=issue.device)
    issue0 = torch.amin(torch.where(active, issue, BIG))
    return torch.clip(issue - issue0, 0, 2**40) * T + rows


def elect(active, packed, idx, size):
    """Min-FCFS election: the earliest active row per ``idx`` value wins
    (dense [R, size] form; callers check the size cap at construction)."""
    R = packed.shape[0]
    if R * size > DENSE_MAX_ELEMS:
        raise NotImplementedError(
            "election tables above the dense cap (T > 512) are ported in "
            "a later slice")
    oh = onehot(idx, size)
    tbl = torch.amin(torch.where(oh & active[:, None], packed[:, None], BIG),
                     dim=0)
    return active & (sel(oh, tbl) == packed)


def grouped_rank(group: torch.Tensor, key: torch.Tensor,
                 active: torch.Tensor) -> torch.Tensor:
    """FCFS rank of each active row within its ``group``, ordered by
    ``key`` (ties by row index), as one dense [R, R] compare-and-sum.
    Inactive rows get rank 0."""
    R = key.shape[0]
    idx = torch.arange(R, dtype=torch.int32, device=key.device)
    g = group.to(torch.int32)
    before = (g[None, :] == g[:, None]) \
        & ((key[None, :] < key[:, None])
           | ((key[None, :] == key[:, None]) & (idx[None, :] < idx[:, None]))) \
        & active[None, :] & active[:, None]
    return torch.sum(before, dim=1, dtype=torch.int32)
