"""The rank side of the port's tile-sharding tests (no JAX: each rank is a
fresh process, spawned by graphite_tpu_torch.parallel.mesh.launch, which
imports this module and nothing of the JAX package).

:func:`run_cases` runs every case of one shard count on one rank: one
launch per shard count per test module, not one per case.
"""

from __future__ import annotations

import time

import torch

from graphite_tpu_torch import convert, load_config
from graphite_tpu_torch.engine.sim import (DeadlockError, Simulator,
                                           run_simulation)
from graphite_tpu_torch.events import synth
from graphite_tpu_torch.events.schema import TraceBuilder
from graphite_tpu_torch.params import SimParams

import torch_jax_ref as ref


def params(T: int, shards: int, over: dict) -> SimParams:
    cfg = load_config()
    cfg.set("general/total_cores", T)
    cfg.set("tpu/tile_shards", str(shards))
    for k, v in over.items():
        cfg.set(k, v)
    return SimParams.from_config(cfg)


def gen_unspawned(num_tiles: int):
    """Every tile but 0 waits on a THREAD_START that no SPAWN releases:
    the run deadlocks."""
    tb = TraceBuilder(num_tiles)
    for t in range(1, num_tiles):
        tb.thread_start(t)
    tb.compute(0, 10, 1)
    return tb.build()


def trace(gen):
    """The trace of ``(generator name, kwargs)``: a synth generator, or
    one of this module's."""
    fn, kw = gen
    return (getattr(synth, fn, None) or globals()[fn])(**kw)


def run_case(group, shards: int, case, max_steps: int) -> dict:
    """One case ``(T, gen, overrides)`` on this rank (``group`` None: the
    unsharded run): its end state's flat leaves."""
    T, gen, over = case
    sim = Simulator(params(T, shards, over), trace(gen), device="cpu",
                    group=group)
    sim.run(max_steps=max_steps)
    return convert.state_to_numpy(sim.state)


def run_cases(group, cases: dict, max_steps: int, extras=()) -> dict:
    """Every case of ``cases`` (name -> case) on this rank, sharded: rank 0
    returns each case's leaves and its seconds, the other ranks each
    leaf's digest (the state is replicated: every rank must end equal).
    Then each ``(key, function name, args)`` of ``extras`` runs on the
    same group, ``out[key] = function(group, *args)``, in order.  Last,
    each rank runs its share of the cases unsharded (rank r the r-th,
    (r + S)-th, ... by name), returned under ``"solo"``."""
    out = {}
    for name, case in cases.items():
        t0 = time.perf_counter()
        leaves = run_case(group, group.size, case, max_steps)
        out[name] = (leaves if group.rank == 0
                     else {k: ref.digest(v) for k, v in leaves.items()},
                     time.perf_counter() - t0)
    for key, fn, args in extras:
        out[key] = globals()[fn](group, *args)
    out["solo"] = {name: run_case(None, 1, cases[name], max_steps)
                   for name in sorted(cases)[group.rank::group.size]}
    return out


def summary(group, case, max_steps: int) -> dict:
    """``run_simulation``'s summary of one case on this rank (``group``
    None: unsharded), host time and rate left out."""
    T, gen, over = case
    shards = 1 if group is None else group.size
    d = run_simulation(params(T, shards, over), trace(gen),
                       max_steps=max_steps, device="cpu",
                       group=group).to_dict()
    for k in ("host_seconds", "simulated_mips"):
        d.pop(k)
    return d


def deadlocks(group, case, max_steps: int) -> str:
    """A case that deadlocks: the name of what it raised on this rank."""
    try:
        run_case(group, group.size, case, max_steps)
    except DeadlockError as e:
        return f"DeadlockError: {e}"
    return "no error"


def fail_on(group, rank: int) -> int:
    """Raise on ``rank``; the other ranks wait in a collective."""
    if group.rank == rank:
        raise ArithmeticError(f"rank {rank} fails on purpose")
    group.all_min(torch.tensor(group.rank, dtype=torch.int64))
    return group.rank


def hang(group) -> None:
    """Never report."""
    while True:
        time.sleep(1)
