"""Directory coherence: sharer bitmaps and the protocol transition
functions.

Counterpart of ``graphite_tpu/engine/directory.py`` under the four
protocol families: MSI and MOSI with private L2 (reference:
pr_l1_pr_l2_dram_directory_{msi,mosi}/dram_directory_cntlr.cc), and the
shared-L2 slice FSM under MSI and MESI (pr_l1_sh_l2_{msi,mesi}/
l2_cache_cntlr.cc).  The bitmaps are full maps; the limited schemes
(reference directory_schemes/) add their behaviour on top in the
conflict round (engine/resolve.py), with :func:`popcount` and
:func:`lowest_bit`.  Sharer bitmaps are ``uint64`` words in JAX and
``int64`` words with the same bits here; bit 63 is the sign bit, which
``&``/``|``/``~`` and the ``(x >> s) & 1`` extraction never notice, and
:func:`popcount` shifts with ``ops.lshr``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from graphite_tpu_torch.engine.cache import E, I, M, O, S
from graphite_tpu_torch.engine.ops import lshr

# ------------------------------------------------------------- bitmaps


def make_tile_bit(tile: torch.Tensor, num_words: int) -> torch.Tensor:
    """tile id [K] -> [K, W] one-hot bitmap (int64 words)."""
    word = (tile // 64).to(torch.int64)
    bit = torch.ones_like(tile, dtype=torch.int64) << (tile % 64).to(
        torch.int64)
    K = tile.shape[0]
    oh = word[:, None] == torch.arange(num_words, device=tile.device)[None]
    return torch.where(oh, bit[:, None], torch.zeros((K, num_words),
                                                      dtype=torch.int64,
                                                      device=tile.device))


def bitmap_to_bool(words: torch.Tensor, num_tiles: int) -> torch.Tensor:
    """[K, W] bitmap words -> [K, T] bool."""
    K, W = words.shape
    shifts = torch.arange(64, dtype=torch.int64, device=words.device)
    bits = (words[:, :, None] >> shifts[None, None, :]) & 1
    return bits.reshape(K, W * 64)[:, :num_tiles].to(torch.bool)


def lowest_bit(words: torch.Tensor) -> torch.Tensor:
    """[K, W] words -> [K, W] bitmap with only the lowest set bit of the
    row kept (all-zero rows stay zero): ``x & (~x + 1)`` in the row's
    first non-zero word.  The victim sharer of limited_no_broadcast's
    pointer overflow (reference
    directory_entry_limited_no_broadcast.cc)."""
    nz = words != 0
    first = nz & (torch.cumsum(nz.to(torch.int32), dim=1) == 1)
    return torch.where(first, words & (~words + 1), 0)


def popcount(words: torch.Tensor) -> torch.Tensor:
    """[K, W] words -> [K] int32 number of set bits (a SWAR count per
    word; the adds and the multiply wrap as uint64 does)."""
    x = words - (lshr(words, 1) & 0x5555555555555555)
    x = (x & 0x3333333333333333) + (lshr(x, 2) & 0x3333333333333333)
    x = (x + lshr(x, 4)) & 0x0F0F0F0F0F0F0F0F
    x = lshr(x * 0x0101010101010101, 56)
    return torch.sum(x, dim=-1).to(torch.int32)


class MsiActions(NamedTuple):
    """Per-request coherence actions + new entry contents (all [K])."""

    new_state: torch.Tensor     # int32 directory state after the request
    new_owner: torch.Tensor     # int32 owner tile (-1 when none)
    new_sharers: torch.Tensor   # [K, W] bitmap words
    owner_leg: torch.Tensor     # bool — WB/FLUSH round trip to current owner
    owner_tile: torch.Tensor    # int32 tile the owner leg visits
    owner_downgrade_to: torch.Tensor  # int32 state the owner's copies drop to
    inv_targets: torch.Tensor   # [K, W] bitmap words — sharers to invalidate
    dram_read: torch.Tensor     # bool — data supplied by DRAM
    dram_write: torch.Tensor    # bool — writeback reaches DRAM


def transition(protocol_kind: str, is_ex, requester, state, owner, sharers,
               num_words: int, is_ifetch=None) -> MsiActions:
    """Dispatch the directory FSM by protocol kind ('msi', 'mosi',
    'sh_l2_msi' or 'sh_l2_mesi')."""
    if protocol_kind == "mosi":
        return mosi_transition(is_ex, requester, state, owner, sharers,
                               num_words)
    if protocol_kind in ("sh_l2_msi", "sh_l2_mesi"):
        return sh_l2_transition(protocol_kind == "sh_l2_mesi", is_ex,
                                requester, state, owner, sharers, num_words,
                                no_e_grant=is_ifetch)
    return msi_transition(is_ex, requester, state, owner, sharers,
                          num_words)


def msi_transition(is_ex: torch.Tensor, requester: torch.Tensor,
                   state: torch.Tensor, owner: torch.Tensor,
                   sharers: torch.Tensor, num_words: int) -> MsiActions:
    """The MSI directory FSM for a batch of requests.

      SH_REQ: U -> S {req}; S -> S +req; M -> WB_REQ to owner, S {owner, req}
      EX_REQ: U -> M req; S -> INV_REQ to sharers\\{req}, M req;
              M -> FLUSH_REQ to owner, M req
    A requester already recorded as owner is never sent its own flush.
    """
    req_bit = make_tile_bit(requester, num_words)
    has_owner = (state == M) & (owner >= 0) & (owner != requester)

    sh_state = torch.full_like(state, S)
    sh_sharers = sharers | req_bit
    sh_sharers = torch.where(
        (state == M)[:, None],
        make_tile_bit(torch.clamp(owner, min=0), num_words) | req_bit,
        sh_sharers)
    sh_owner = torch.full_like(owner, -1)

    ex_state = torch.full_like(state, M)
    ex_sharers = req_bit
    ex_owner = requester.to(torch.int32)
    inv_targets = torch.where(
        (is_ex & (state == S))[:, None], sharers & ~req_bit,
        torch.zeros_like(sharers))

    new_state = torch.where(is_ex, ex_state, sh_state)
    new_owner = torch.where(is_ex, ex_owner, sh_owner.to(torch.int32))
    new_sharers = torch.where(is_ex[:, None], ex_sharers, sh_sharers)

    owner_leg = has_owner
    owner_downgrade = torch.where(
        is_ex, torch.full_like(state, I, dtype=torch.int32),
        torch.full_like(state, S, dtype=torch.int32))
    return MsiActions(
        new_state=new_state.to(torch.int32),
        new_owner=new_owner.to(torch.int32),
        new_sharers=new_sharers,
        owner_leg=owner_leg,
        owner_tile=torch.clamp(owner, min=0).to(torch.int32),
        owner_downgrade_to=owner_downgrade,
        inv_targets=inv_targets,
        dram_read=~owner_leg,
        dram_write=owner_leg,
    )


def mosi_transition(is_ex: torch.Tensor, requester: torch.Tensor,
                    state: torch.Tensor, owner: torch.Tensor,
                    sharers: torch.Tensor, num_words: int) -> MsiActions:
    """The MOSI directory FSM.  Against MSI: SH_REQ on M or O keeps the
    owner, which downgrades to O and forwards the data (no DRAM at all);
    EX_REQ on O flushes the owner and invalidates the other sharers;
    the owner upgrading its own O line moves no data.  Dirty data
    reaches DRAM only when an M or O line is evicted."""
    req_bit = make_tile_bit(requester, num_words)
    own_bit = make_tile_bit(torch.clamp(owner, min=0), num_words)
    owned = (state == M) | (state == O)
    has_live_owner = owned & (owner >= 0)
    has_owner = has_live_owner & (owner != requester)
    req_is_owner = has_live_owner & (owner == requester)

    sh_state = torch.where(state == I, S, torch.where(owned, O, S))
    sh_owner = torch.where(owned, owner, -1)
    sh_sharers = torch.where((state == M)[:, None], own_bit | req_bit,
                             sharers | req_bit)

    inv_targets = torch.where(
        (is_ex & ((state == S) | (state == O)))[:, None],
        sharers & ~req_bit & ~torch.where(has_owner[:, None], own_bit, 0),
        torch.zeros_like(sharers))

    new_state = torch.where(is_ex, M, sh_state)
    new_owner = torch.where(is_ex, requester.to(torch.int32), sh_owner)
    new_sharers = torch.where(is_ex[:, None], req_bit, sh_sharers)
    return MsiActions(
        new_state=new_state.to(torch.int32),
        new_owner=new_owner.to(torch.int32),
        new_sharers=new_sharers,
        owner_leg=has_owner,
        owner_tile=torch.clamp(owner, min=0).to(torch.int32),
        owner_downgrade_to=torch.where(is_ex, I, O).to(torch.int32),
        inv_targets=inv_targets,
        dram_read=~has_owner & ~req_is_owner,
        dram_write=torch.zeros_like(has_owner),
    )


def sh_l2_transition(mesi: bool, is_ex: torch.Tensor,
                     requester: torch.Tensor, state: torch.Tensor,
                     owner: torch.Tensor, sharers: torch.Tensor,
                     num_words: int,
                     no_e_grant: torch.Tensor = None) -> MsiActions:
    """The shared-L2 slice FSM: the entry IS the slice line (I: not in
    the slice, the only case that reads DRAM; S: clean; O: dirty in the
    slice with no L1 owner; E: clean with one exclusive L1 owner, the
    MESI first-reader grant; M: owned dirty by one L1).  A downgraded E
    owner may have upgraded silently, so its entry becomes O like M's.
    Instruction fetches never take E (``no_e_grant``)."""
    req_bit = make_tile_bit(requester, num_words)
    own_bit = make_tile_bit(torch.clamp(owner, min=0), num_words)
    owned = (state == M) | (state == E)
    has_owner = owned & (owner >= 0) & (owner != requester)
    miss = state == I

    grant_e = miss & mesi
    if no_e_grant is not None:
        grant_e = grant_e & ~no_e_grant
    sh_miss_state = torch.where(grant_e, E, S)
    sh_state = torch.where(miss, sh_miss_state,
                           torch.where(owned, O, state))
    sh_owner = torch.where(grant_e, requester.to(torch.int32), -1)
    sh_sharers = torch.where(owned[:, None], own_bit | req_bit,
                             sharers | req_bit)

    inv_targets = torch.where(
        (is_ex & ((state == S) | (state == O)))[:, None],
        sharers & ~req_bit, torch.zeros_like(sharers))

    new_state = torch.where(is_ex, M, sh_state)
    new_owner = torch.where(is_ex, requester.to(torch.int32), sh_owner)
    new_sharers = torch.where(is_ex[:, None], req_bit, sh_sharers)
    return MsiActions(
        new_state=new_state.to(torch.int32),
        new_owner=new_owner.to(torch.int32),
        new_sharers=new_sharers,
        owner_leg=has_owner,
        owner_tile=torch.clamp(owner, min=0).to(torch.int32),
        owner_downgrade_to=torch.where(is_ex, I, S).to(torch.int32),
        inv_targets=inv_targets,
        dram_read=miss,
        dram_write=torch.zeros_like(has_owner),
    )
