"""Batched set-associative cache arrays (gather/scatter form).

Counterpart of ``graphite_tpu/engine/cache.py``: one cache level across
all tiles is a packed int64 array ``[assoc, num_tiles, sets]``, one word
per line::

    bits  0..2   coherence state (I < S < O < E < M)
    bits  3..31  LRU stamp (29-bit monotone access counter)
    bits 32..62  tag (31-bit line id; frontend asserts addr < 2^37)

LRU is a timestamp (victim = min-stamp way), so concurrent touches
combine with scatter-max and coherence downgrades with scatter-min.
Every function returns new tensors; nothing is updated in place.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from graphite_tpu_torch.engine.ops import first_true, scatter
from graphite_tpu_torch.params import CacheParams

# Coherence state codes (cache lines AND directory entries).
I, S, O, E, M = 0, 1, 2, 3, 4

STATE_BITS = 3
_STATE_MASK = (1 << STATE_BITS) - 1
STAMP_BITS = 29
_STAMP_SHIFT = STATE_BITS
_STAMP_MASK = ((1 << STAMP_BITS) - 1) << _STAMP_SHIFT
TAG_SHIFT = STATE_BITS + STAMP_BITS  # 32

_STAMP_FIELD = (1 << STAMP_BITS) - 1


def _i64(x, device=None):
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64)
    return torch.as_tensor(x, dtype=torch.int64, device=device)


def pack_word(tag, stamp, state):
    """(tag, stamp, state) -> packed int64 line word (stamp masked to its
    field, so a wrap only perturbs LRU victim choice)."""
    dev = next(v.device for v in (tag, stamp, state)
               if isinstance(v, torch.Tensor))
    return (_i64(tag, dev) << TAG_SHIFT) \
        | ((_i64(stamp, dev) & _STAMP_FIELD) << _STAMP_SHIFT) \
        | _i64(state, dev)


def word_state(word):
    return (word & _STATE_MASK).to(torch.int32)


def word_stamp(word):
    return ((word & _STAMP_MASK) >> _STAMP_SHIFT).to(torch.int32)


def word_tag(word):
    return (word >> TAG_SHIFT).to(torch.int32)


def with_state(word, state):
    """Replace the state field, keeping tag+stamp."""
    return (word & ~_STATE_MASK) | _i64(state, word.device)


def with_stamp(word, stamp):
    return (word & ~_STAMP_MASK) \
        | ((_i64(stamp, word.device) & _STAMP_FIELD) << _STAMP_SHIFT)


def meta_state(meta):
    """The state field of a packed word or of the JAX package's [A, T,
    sets] ``meta`` view (its low bits are the state)."""
    return (meta & _STATE_MASK).to(torch.int32)


class CacheArrays(NamedTuple):
    """One cache level for all tiles: [assoc, T, sets] packed words."""

    word: torch.Tensor    # int64 packed (tag | stamp | state)
    rr_ptr: torch.Tensor  # int32 [T, sets] round-robin victim pointer


def make_cache(num_tiles: int, params: CacheParams,
               device) -> CacheArrays:
    A = params.associativity
    shape = (A, num_tiles, params.num_sets)
    return CacheArrays(
        word=torch.zeros(shape, dtype=torch.int64, device=device),
        rr_ptr=torch.zeros(shape[1:], dtype=torch.int32, device=device),
    )


def set_index(line: torch.Tensor, num_sets: int) -> torch.Tensor:
    """Default modulo hash over the line address."""
    return (line % num_sets).to(torch.int32)


class ProbeResult(NamedTuple):
    hit: torch.Tensor       # [...] bool
    way: torch.Tensor       # [...] int32 (valid iff hit)
    state: torch.Tensor     # [...] int32 (I when miss)
    set_idx: torch.Tensor   # [...] int32
    row: torch.Tensor       # [A, ...] gathered set-row words


def probe_rows(cache: CacheArrays, set_idx: torch.Tensor) -> torch.Tensor:
    """Gather each access's set row: [A, T, sets] x [T, ...] -> [A, T, ...]."""
    A = cache.word.shape[0]
    if set_idx.ndim == 1:
        ix = set_idx.to(torch.int64)[None, :, None].expand(A, -1, 1)
        return torch.gather(cache.word, 2, ix)[:, :, 0]
    ix = set_idx.to(torch.int64)[None].expand(A, -1, -1)
    return torch.gather(cache.word, 2, ix)


def probe(cache: CacheArrays, line: torch.Tensor,
          num_sets: int) -> ProbeResult:
    """Look up ``line`` ([T] or [T, K], per tile) in each tile's cache."""
    sidx = set_index(line, num_sets)
    row = probe_rows(cache, sidx)                       # [A, T(,K)]
    st_row = word_state(row)
    match = (word_tag(row) == line[None].to(torch.int32)) & (st_row != I)
    hit = match.any(dim=0)
    way = first_true(match, 0).to(torch.int32)
    st = torch.where(hit, torch.sum(torch.where(match, st_row, 0), dim=0),
                     I).to(torch.int32)
    return ProbeResult(hit=hit, way=way, state=st, set_idx=sidx, row=row)


def row_word(row: torch.Tensor, way: torch.Tensor) -> torch.Tensor:
    """[A, ...] gathered set row x [...] way -> [...] line word."""
    return torch.gather(row, 0, way.to(torch.int64)[None])[0]


def touch(cache: CacheArrays, set_idx: torch.Tensor, way: torch.Tensor,
          active: torch.Tensor, word: torch.Tensor,
          stamp) -> CacheArrays:
    """Stamp (set_idx, way) as most-recently-used where ``active``
    (scatter-max: concurrent touches of one line keep the freshest
    stamp).  Shapes: all [T] or all [T, K] (tile axis leading)."""
    rows = torch.arange(set_idx.shape[0], dtype=torch.int64,
                        device=set_idx.device)
    if set_idx.ndim == 2:
        rows = rows[:, None]
    new_word = with_stamp(word, stamp)
    return cache._replace(word=scatter(
        cache.word, (way, rows, set_idx), new_word, "max", mask=active))


class FillResult(NamedTuple):
    cache: CacheArrays
    way: torch.Tensor           # [T] chosen way
    victim_tag: torch.Tensor    # [T] int64 evicted line
    victim_state: torch.Tensor  # [T] int32 state of the evicted line


def fill(cache: CacheArrays, line: torch.Tensor, new_state: torch.Tensor,
         active: torch.Tensor, num_sets: int, replacement: str,
         stamp) -> FillResult:
    """Install ``line`` ([T], one per tile) in its set: upgrade in place
    when already resident, else invalid-first, then min-stamp (LRU) or
    round-robin.  At most one fill per tile per call."""
    T = line.shape[0]
    A = cache.word.shape[0]
    dev = line.device
    rows = torch.arange(T, dtype=torch.int64, device=dev)
    sidx = set_index(line, num_sets)
    row = probe_rows(cache, sidx)              # [A, T]
    st_row = word_state(row)
    resident = (word_tag(row) == line[None].to(torch.int32)) & (st_row != I)
    has_res = resident.any(dim=0)
    res_way = first_true(resident, 0)
    invalid = st_row == I
    has_invalid = invalid.any(dim=0)
    first_invalid = first_true(invalid, 0)
    if replacement == "round_robin":
        ptr = torch.gather(cache.rr_ptr, 1,
                           sidx.to(torch.int64)[:, None])[:, 0]
        policy_way = (ptr % A).to(torch.int64)
        adv = active & ~has_res
        cache = cache._replace(rr_ptr=scatter(
            cache.rr_ptr, (rows, sidx), (ptr + 1) % A, "set", mask=adv))
    else:
        policy_way = torch.argmin(word_stamp(row), dim=0)
    way = torch.where(
        has_res, res_way,
        torch.where(has_invalid, first_invalid, policy_way)).to(torch.int32)

    vic_word = row_word(row, way)
    victim_tag = word_tag(vic_word).to(torch.int64)
    victim_state = torch.where(active & ~has_res, word_state(vic_word),
                               I).to(torch.int32)

    ns = torch.as_tensor(new_state, dtype=torch.int32, device=dev)
    eff_state = torch.where(has_res, torch.maximum(ns, word_state(vic_word)),
                            ns)
    new_word = pack_word(line.to(torch.int32), stamp, eff_state)
    cache = cache._replace(word=scatter(
        cache.word, (way, rows, sidx), new_word, "set", mask=active))
    return FillResult(cache=cache, way=way, victim_tag=victim_tag,
                      victim_state=victim_state)


def downgrade_lines(cache: CacheArrays, tiles: torch.Tensor,
                    lines: torch.Tensor, valid: torch.Tensor,
                    down_state: torch.Tensor, num_sets: int) -> CacheArrays:
    """Coherence delivery of (target tile, line) pairs: the matched line
    drops to ``down_state`` (never raised; several deliveries to one line
    combine by scatter-min on the packed word)."""
    sidx = set_index(lines, num_sets)
    tiles = tiles.to(torch.int64)
    flat = tiles * num_sets + sidx                    # [R]
    A = cache.word.shape[0]
    row = cache.word.reshape(A, -1)[:, flat]          # [A, R]
    st_row = word_state(row)
    match = (word_tag(row) == lines[None].to(torch.int32)) \
        & (st_row != I) & valid[None]
    hit = match.any(dim=0)
    way = first_true(match, 0)
    cur = row_word(row, way)
    new_word = with_state(cur, torch.minimum(
        word_state(cur), down_state.to(torch.int32)))
    return cache._replace(word=scatter(
        cache.word, (way, tiles, sidx), new_word, "min", mask=hit))


def raise_line_state(cache: CacheArrays, tiles: torch.Tensor,
                     lines: torch.Tensor, valid: torch.Tensor,
                     up_state, num_sets: int) -> CacheArrays:
    """Raise a resident line's state in place (scatter-max on the packed
    word: tag and stamp unchanged, so a raise never loses to a
    concurrent touch of the same line).  A line a racing coherence
    delivery already invalidated is not found, and its raise is
    dropped."""
    sidx = set_index(lines, num_sets)
    tiles = tiles.to(torch.int64)
    flat = tiles * num_sets + sidx
    A = cache.word.shape[0]
    row = cache.word.reshape(A, -1)[:, flat]          # [A, R]
    st_row = word_state(row)
    match = (word_tag(row) == lines[None].to(torch.int32)) \
        & (st_row != I) & valid[None]
    hit = match.any(dim=0)
    way = first_true(match, 0)
    cur = row_word(row, way)
    new_word = with_state(cur, torch.maximum(
        word_state(cur), torch.as_tensor(up_state, dtype=torch.int32,
                                         device=cur.device)))
    return cache._replace(word=scatter(
        cache.word, (way, tiles, sidx), new_word, "max", mask=hit))


def invalidate_by_value(cache: CacheArrays, lines: torch.Tensor,
                        valid: torch.Tensor,
                        down_state: torch.Tensor) -> CacheArrays:
    """Per-tile delivery lists ([T, J] lines addressed to each tile's own
    cache), flattened onto :func:`downgrade_lines`."""
    T, J = lines.shape
    num_sets = cache.word.shape[2]
    tiles = torch.arange(T, dtype=torch.int32,
                         device=lines.device)[:, None].expand(T, J).reshape(-1)
    return downgrade_lines(cache, tiles, lines.reshape(-1),
                           valid.reshape(-1), down_state.reshape(-1),
                           num_sets)
