"""Tensor idioms the JAX engine gets from ``jax.numpy`` and torch lacks.

Three JAX behaviours the engine leans on have no direct torch form, so
each gets ONE deliberate implementation here that every module calls:

  * ``mode="drop"`` scatters.  The JAX engine masks scatter rows by
    routing them past the array bound; torch raises on such rows (CPU)
    or device-asserts (CUDA).  :func:`scatter` pads the flattened target
    with one scratch element, sends every out-of-range row there, and
    returns a NEW tensor (JAX's ``.at[]`` is functional too).  No host
    sync: the row mask never becomes a data-dependent shape.  Where
    several rows set one element, :func:`scatter_last` keeps the last
    row, the order the JAX package's CPU scatter applies.
  * Unsigned 64-bit arithmetic.  Sharer bitmaps and hash keys are
    ``uint64`` in JAX; here they are ``int64`` with the same bits.
    Addition, subtraction, multiplication, ``&``/``|``/``^``/``~`` and
    left shifts agree bit for bit; right shifts and the modulo do not,
    hence :func:`lshr` and :func:`umod64`.
  * First-index ``argmax``/``argmin`` over bool masks (torch has no
    bool argmax): :func:`first_true`.

One more follows from how XLA compiles for the CPU: it lets LLVM fuse a
float multiply into the add or subtract that consumes it (one rounding
instead of two).  The float64 sites of the DRAM queue models that XLA
fuses so use :func:`fma`, a correctly rounded ``a * b + c`` built from
plain float64 operations, the same on the CPU and on CUDA.
"""

from __future__ import annotations

import math

import torch


def _flat_index(t: torch.Tensor, idx, mask):
    """(lin, n): each row's flat index into ``t`` for a drop-scatter at
    ``idx`` (a tuple of index tensors, broadcast together; negative
    indices wrap once, as in JAX), with every row outside an axis or
    masked off sent to the scratch position ``n = t.numel()``."""
    if not isinstance(idx, (tuple, list)):
        idx = (idx,)
    idx = torch.broadcast_tensors(*[i.to(torch.int64) for i in idx])
    shape = t.shape
    n = t.numel()
    valid = torch.ones(idx[0].shape, dtype=torch.bool, device=t.device)
    lin = torch.zeros(idx[0].shape, dtype=torch.int64, device=t.device)
    stride = 1
    strides = []
    for d in range(len(shape) - 1, -1, -1):
        strides.append(stride)
        stride *= shape[d]
    strides = strides[::-1]
    for d, ix in enumerate(idx):
        ix = torch.where(ix < 0, ix + shape[d], ix)   # numpy-style wrap
        valid = valid & (ix >= 0) & (ix < shape[d])
        lin = lin + ix * strides[d]
    if mask is not None:
        valid = valid & mask
    return torch.where(valid, lin, n), n


def scatter(t: torch.Tensor, idx, vals, op: str = "set",
            mask: torch.Tensor = None) -> torch.Tensor:
    """Functional ``t.at[idx].<op>(vals, mode="drop")``.

    ``idx`` is a tuple of integer index tensors (one per leading axis of
    ``t``, broadcast together); negative indices wrap once, as in JAX,
    and rows with any index still outside its axis — or with ``mask``
    False — are dropped.  ``op`` is ``set`` (callers
    guarantee one writer per element, or identical values; otherwise
    :func:`scatter_last`), ``add``, ``max`` or ``min`` (order-free).
    Returns a new contiguous tensor.
    """
    lin, n = _flat_index(t, idx, mask)
    v = torch.as_tensor(vals, device=t.device).to(t.dtype)
    v = torch.broadcast_to(v, lin.shape).reshape(-1)
    lin = lin.reshape(-1)
    flat = torch.cat([t.reshape(-1), t.new_zeros(1)])
    if op == "set":
        flat.index_put_((lin,), v)
    elif op == "add":
        flat.index_put_((lin,), v, accumulate=True)
    elif op in ("max", "min"):
        if t.dtype == torch.bool:
            f8 = flat.to(torch.int8)
            f8.scatter_reduce_(0, lin, v.to(torch.int8),
                               "amax" if op == "max" else "amin")
            flat = f8.to(torch.bool)
        else:
            flat.scatter_reduce_(0, lin, v, "amax" if op == "max" else "amin")
    else:
        raise ValueError(f"unknown scatter op {op!r}")
    return flat[:n].view(t.shape)


def scatter_last(t: torch.Tensor, idx, vals,
                 mask: torch.Tensor = None) -> torch.Tensor:
    """Functional ``t.at[idx].set(vals, mode="drop")`` where several rows
    may set one element: the LAST of them (the highest position in the
    broadcast index shape, in C order) wins, the order in which the JAX
    package's CPU scatter applies its updates.  Each element's winning
    position is a scatter-max of the positions, and only the winners
    then write, so the result is the same on the CPU and on CUDA, run
    after run (a plain ``index_put_`` leaves the order of duplicates
    undefined).  Indices and ``mask`` as in :func:`scatter`; no host
    sync; the positions go through a table as large as ``t``, so this
    is for small tables.  Returns a new contiguous tensor."""
    lin, n = _flat_index(t, idx, mask)
    v = torch.as_tensor(vals, device=t.device).to(t.dtype)
    v = torch.broadcast_to(v, lin.shape).reshape(-1)
    lin = lin.reshape(-1)
    pos = torch.arange(lin.numel(), device=t.device)
    last = torch.full((n + 1,), -1, dtype=torch.int64, device=t.device)
    last.scatter_reduce_(0, lin, pos, "amax")
    # A row that does not win its element writes to the scratch position,
    # which is dropped: every kept element has exactly one writer.
    lin = torch.where(last[lin] == pos, lin, n)
    flat = torch.cat([t.reshape(-1), t.new_zeros(1)])
    flat.index_put_((lin,), v)
    return flat[:n].view(t.shape)


def lshr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bit patterns (``uint64 >> s``)."""
    if s == 0:
        return x
    return (x >> s) & ((1 << (64 - s)) - 1)


def umod64(x: torch.Tensor, n: int) -> torch.Tensor:
    """``uint64(x) % n`` for int64 bit patterns, right for any n > 0.

    A negative int64 ``x`` stands for ``x + 2**64``; that is congruent to
    ``x + (2**64 % n)`` mod n, and torch's ``%`` with a positive divisor
    is already non-negative."""
    n = int(n)
    r = x % n
    return torch.where(x < 0, (r + (2**64 % n)) % n, r)


def first_true(mask: torch.Tensor, dim: int) -> torch.Tensor:
    """Index of the first True along ``dim`` (0 when none) — the value of
    ``jnp.argmax`` on a bool mask."""
    return torch.argmax(mask.to(torch.int8), dim=dim)



_SPLIT = 134217729.0     # 2**27 + 1 (Veltkamp's split of a float64)


def _two_sum(a: torch.Tensor, b: torch.Tensor):
    """(s, e): s = RN(a + b) and its exact error, a + b = s + e."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _two_prod(a: torch.Tensor, b: torch.Tensor):
    """(p, e): p = RN(a * b) and its exact error (Dekker's product)."""
    def split(x):
        c = _SPLIT * x
        hi = c - (c - x)
        return hi, x - hi
    p = a * b
    ah, al = split(a)
    bh, bl = split(b)
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float64 ``a * b + c`` rounded once, as a fused multiply-add gives it
    (Boldo and Melquiond's emulation through rounding to odd; exact for
    operands far from overflow and underflow, as the queue models'
    times and weights are).  Every step is one plain torch operation, so
    no compiler contracts it further."""
    uh, ul = _two_prod(a, b)
    th, tl = _two_sum(c, uh)
    v, e = _two_sum(tl, ul)
    # Round v = RN(tl + ul) to odd: where inexact and even, step to the
    # neighbour on the side of the exact sum.
    even = (v.view(torch.int64) & 1) == 0
    step = torch.nextafter(v, torch.where(e > 0, math.inf, -math.inf)
                           .to(v.dtype))
    v = torch.where((e != 0) & even, step, v)
    return th + v
