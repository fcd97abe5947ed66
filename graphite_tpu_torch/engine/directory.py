"""Directory coherence: sharer bitmaps and the MSI transition function.

Counterpart of ``graphite_tpu/engine/directory.py`` for the full-map MSI
directory (reference: pr_l1_pr_l2_dram_directory_msi/
dram_directory_cntlr.cc).  Sharer bitmaps are ``uint64`` words in JAX and
``int64`` words with the same bits here; bit 63 is the sign bit, which
``&``/``|``/``~`` and the ``(x >> s) & 1`` extraction never notice.
The MOSI and shared-L2 FSMs belong to a later slice of the port.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from graphite_tpu_torch.engine.cache import I, M, S

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
    """Dispatch the directory FSM by protocol kind (MSI in this slice)."""
    if protocol_kind != "msi":
        raise NotImplementedError(
            f"directory protocol {protocol_kind!r} is ported in a later "
            f"slice (model breadth)")
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
