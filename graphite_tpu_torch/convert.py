"""Carry simulation state and trace arrays across the two packages.

The JAX package's ``SimState`` (after ``jax.device_get``) and the port's
``SimState`` have the same field names, shapes and values.  The one
dtype that differs is the directory sharer bitmap: ``uint64`` in JAX,
``int64`` with the same bits here; it is reinterpreted with
``.view(np.int64)`` on the way in and ``.view(np.uint64)`` on the way
out.  Leaves travel as a flat ``{name: np.ndarray}`` dict; nested
NamedTuples (the cache levels, the counters) flatten to dotted names
such as ``l1i.word`` and ``counters.icount``.

This module imports numpy and torch only: it never imports the JAX
package, so the numpy dict is the whole interface.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from graphite_tpu_torch.engine.state import (
    SimState, TraceArrays, flat_leaves, from_flat_leaves, leaf_names)
from graphite_tpu_torch.params import SimParams

# Leaves stored as uint64 by the JAX package.
UINT64_LEAVES = ("dir_sharers",)


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def leaves_to_numpy(tree) -> Dict[str, np.ndarray]:
    """Flatten a NamedTuple of arrays (either package's SimState or
    TraceArrays) into ``{dotted name: np.ndarray}``; None leaves are
    skipped."""
    out = {}
    for f, v in zip(tree._fields, tree):
        if v is None or isinstance(v, int):
            continue
        if isinstance(v, tuple) and hasattr(v, "_fields"):
            for g, w in zip(v._fields, v):
                out[f"{f}.{g}"] = _to_numpy(w)
        else:
            out[f] = _to_numpy(v)
    return out


def state_from_numpy(params: SimParams, leaves: Dict[str, np.ndarray],
                     device) -> SimState:
    """A JAX ``SimState`` as a flat numpy dict -> the port's state on
    ``device`` (uint64 leaves become int64 with the same bits)."""
    want = set(leaf_names())
    missing = want - set(leaves)
    if missing:
        raise ValueError(f"state leaves missing: {sorted(missing)}")
    T = params.num_tiles
    if leaves["clock"].shape != (T,):
        raise ValueError(f"state has {leaves['clock'].shape[0]} tiles, "
                         f"params expect {T}")
    dev = torch.device(device)
    conv = {}
    for name in want:
        a = np.asarray(leaves[name])
        if a.dtype == np.uint64:
            a = a.view(np.int64)
        conv[name] = torch.from_numpy(np.array(a)).to(dev)
    return from_flat_leaves(conv)


def state_to_numpy(state: SimState) -> Dict[str, np.ndarray]:
    """The port's state -> a flat numpy dict in the JAX package's dtypes
    (the sharer bitmap back to uint64)."""
    out = {}
    for name, t in flat_leaves(state).items():
        a = t.detach().cpu().numpy()
        if name in UINT64_LEAVES:
            a = a.view(np.uint64)
        out[name] = a
    return out


def trace_from_numpy(addr: np.ndarray, meta: np.ndarray,
                     device) -> TraceArrays:
    """JAX ``TraceArrays`` leaves (addr [T, N] int64, meta [3, T, N]
    int32) -> the port's trace arrays."""
    dev = torch.device(device)
    return TraceArrays(
        addr=torch.from_numpy(np.array(addr, np.int64)).to(dev),
        meta=torch.from_numpy(np.array(meta, np.int32)).to(dev))


def trace_to_numpy(trace: TraceArrays) -> Dict[str, np.ndarray]:
    return {"addr": trace.addr.cpu().numpy(), "meta": trace.meta.cpu().numpy()}
