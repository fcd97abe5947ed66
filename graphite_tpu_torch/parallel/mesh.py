"""Tile-axis sharding over ``torch.distributed`` (replicated state).

Counterpart of ``graphite_tpu/parallel/mesh.py`` for the path the JAX
package takes at ``tpu/tile_shards`` = S > 1 with ``tpu/shard_state =
replicated``: there ``shard_wrap`` runs the quantum program under
``shard_map`` with every operand replicated, the window and fast-forward
walks slice their operands to the shard's T/S tiles and all_gather their
outputs back, and the quantum barrier is a ``pmin``.  Here each shard is
a process (a rank) that holds the whole state, and the engine is handed
the rank's :class:`ShardGroup`, which carries the two collectives that
path needs: :meth:`ShardGroup.gather_tiles` (the walks' outputs, in tile
order) and :meth:`ShardGroup.all_min` (the barrier).  There is no
implicit default group: every collective names the group's own.

:func:`launch` starts the S ranks, meeting through a ``FileStore`` in a
temporary directory (no network address is needed), and returns what
each rank's function returned.  The backend is gloo for CPU and CUDA
ranks alike: the H100 machine has one card, so its ranks share it, and
NCCL refuses two ranks on one device ("invalid usage").  gloo takes the
CUDA tensors of both collectives (int64, int32, uint8 and bool gathers,
an int64 MIN) and carries their bytes between the processes on the
host; the walks themselves run on the card.  A failed collective
raises.

The GSPMD placement of the JAX module (``shard_pytree``, ``tile_sharding``)
and the resident mode's per-leaf specs are not here: the resident slice
ports them.
"""

from __future__ import annotations

import datetime
import os
import queue
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

TILE_AXIS = "tiles"
BACKEND = "gloo"


class ShardGroup:
    """One rank of S, as the engine is handed it: the rank, the group's
    size, its process group and the device this rank computes on.

    Rank r owns tiles ``[r * T/S, (r + 1) * T/S)``: a tiled gather in
    rank order is tile order."""

    def __init__(self, rank: int, size: int, pg, device):
        self.rank = rank
        self.size = size
        self.pg = pg
        self.device = torch.device(device)

    def tiles(self, num_tiles: int) -> Tuple[int, int]:
        """(first global tile, tile count) of this rank's slice."""
        tl = num_tiles // self.size
        return self.rank * tl, tl

    def gather_tiles(self, leaves: Sequence[Tuple[torch.Tensor, int]]
                     ) -> List[torch.Tensor]:
        """The tiled all_gather of each ``(tensor, tile axis)`` leaf: every
        rank's slice concatenated along the axis in rank order, as
        ``jax.lax.all_gather(..., tiled=True)`` does.  All leaves travel
        in one collective: each is laid tile-major as raw bytes beside the
        others, one [TL, bytes] buffer per rank.  The results are
        contiguous tensors on the group's device."""
        moved = [t.movedim(ax, 0) for t, ax in leaves]
        tl = moved[0].shape[0]
        rows = [m.reshape(tl, -1).contiguous() for m in moved]
        cols = [r.view(torch.uint8) for r in rows]
        widths = [c.shape[1] for c in cols]
        buf = torch.cat(cols, dim=1)
        out = torch.empty((self.size * tl, buf.shape[1]), dtype=torch.uint8,
                          device=buf.device)
        dist.all_gather_into_tensor(out, buf, group=self.pg)
        res = []
        for (_, ax), m, r, part in zip(leaves, moved, rows,
                                       torch.split(out, widths, dim=1)):
            full = part.contiguous().view(r.dtype).reshape(
                (self.size * tl,) + tuple(m.shape[1:]))
            res.append(full.movedim(0, ax).contiguous())
        return res

    def all_min(self, x: torch.Tensor) -> torch.Tensor:
        """The MIN of a scalar over the group's ranks."""
        m = x.reshape(1).clone()
        dist.all_reduce(m, op=dist.ReduceOp.MIN, group=self.pg)
        return m.reshape(())


def check_group(tile_shards: int, group: Optional[ShardGroup]) -> None:
    """The counterpart of ``shard_wrap``'s device check: S > 1 shards
    need a group of S ranks, and a group's size must be S."""
    have = 1 if group is None else group.size
    if tile_shards > 1 and group is None:
        raise ValueError(
            f"tpu/tile_shards={tile_shards} needs a ShardGroup of that "
            f"many ranks (graphite_tpu_torch.parallel.mesh.launch); none "
            f"was given")
    if have != tile_shards:
        raise ValueError(
            f"tpu/tile_shards={tile_shards} does not match the ShardGroup's "
            f"{have} ranks")


def _rank_main(fn, rank: int, size: int, device_type: str, store_path: str,
               timeout_s: float, threads: int, args: tuple, results) -> None:
    """One rank: join the group, run ``fn(group, *args)``, report."""
    try:
        torch.set_num_threads(threads)
        if device_type == "cuda":
            dev = torch.device("cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(dev)
        else:
            dev = torch.device(device_type)
        # Ranks of one host talk over the loopback interface.
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        dist.init_process_group(
            BACKEND, store=dist.FileStore(store_path, size), rank=rank,
            world_size=size, timeout=datetime.timedelta(seconds=timeout_s))
        out = fn(ShardGroup(rank, size, dist.group.WORLD, dev), *args)
        results.put((rank, True, out))
    except Exception:
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def launch(fn: Callable[..., Any], shards: int, device="cuda",
           timeout_s: float = 600.0, args: tuple = (),
           threads: Optional[int] = None) -> List[Any]:
    """Run ``fn(group, *args)`` on ``shards`` ranks and return the ranks'
    results in rank order.  ``fn`` and ``args`` are pickled (``fn`` by
    its import path) and so is each result.

    Each rank is a fresh process (``spawn``); on CUDA rank r computes on
    ``cuda:(r % device_count)``, so ranks share a card when there are
    more of them than cards.  ``threads`` intra-op threads a rank (by
    default the host's cores split among the ranks).  If a rank raises,
    exits without a result, or the ranks have not all reported within
    ``timeout_s``, the other ranks are killed and this raises, with the
    failing rank's traceback."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("launch on CUDA needs a GPU; pass device='cpu' "
                           "for gloo ranks on the host")
    if threads is None:
        threads = max(1, (os.cpu_count() or 1) // shards)
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="graphite_shards_") as tmp:
        procs = [ctx.Process(
            target=_rank_main, daemon=True,
            args=(fn, r, shards, dev.type, os.path.join(tmp, "store"),
                  timeout_s, threads, args, results))
            for r in range(shards)]
        for p in procs:
            p.start()
        got = {}
        deadline = time.monotonic() + timeout_s
        try:
            while len(got) < shards:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"{shards} ranks: ranks {sorted(set(range(shards)) - set(got))} "
                        f"did not report within {timeout_s} s")
                try:
                    rank, ok, out = results.get(timeout=min(left, 1.0))
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in got and p.exitcode is not None]
                    if dead:
                        raise RuntimeError(
                            f"rank {dead[0]} of {shards} exited with code "
                            f"{procs[dead[0]].exitcode} and no result")
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} of {shards} failed:\n"
                                       f"{out}")
                got[rank] = out
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
            for p in procs:
                p.join(timeout=30)
    return [got[r] for r in range(shards)]
