"""Kernel-or-plain choice, by the device a tensor lives on.

Counterpart of ``graphite_tpu/engine/kernels/dispatch.py``'s mode
resolution.  The JAX package selects a mode from ``tpu/pallas_kernels``;
the port has no such knob.  A CUDA tensor always takes the hand-written
kernel (a launch failure raises — there is no fallback on the card), a
CPU tensor always takes the plain PyTorch form, and any other device is
refused.
"""

from __future__ import annotations

import torch

# Kernel launches, one count per kernel, added to by each wrapper where it
# launches its kernel and nowhere else; and the analytic fast-forward
# rounds in which some tile engaged (``core._fast_forward_guarded``), the
# one round kind the state's counters do not separate.  A run sets them
# to 0 with :func:`reset_counts` and reads them after, to show that its
# path went through the kernels.
# The sharded walks (tile sharding) count their launches under their own
# names as well as under the kernel's.
COUNTS = {"window_walk": 0, "chain_classify": 0, "fast_forward_walk": 0,
          "run_window_sharded": 0, "run_fast_forward_sharded": 0,
          "ff_engaged": 0}


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


def use_kernel(t: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (run the plain form); raises for any other device."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise NotImplementedError(
        f"no kernel or plain form for device {t.device}")


def resolve_device(device) -> torch.device:
    """``None`` means CUDA; without a GPU that raises (never a silent
    CPU run)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "graphite_tpu_torch runs on CUDA by default and no GPU is "
            "available; pass device='cpu' to run the plain PyTorch forms")
    return dev


def check_no_alias(kernel: str, operands, written) -> None:
    """Refuse operands (a NamedTuple of tensors or None) where a leaf the
    kernel updates in place (a name in ``written``) shares storage with
    any other operand: the byte ranges of the operands, sorted by start,
    must not overlap where either one is such a leaf."""
    written = set(written)
    spans = sorted(
        (t.data_ptr(), t.data_ptr() + t.numel() * t.element_size(), f)
        for f, t in zip(operands._fields, operands)
        if t is not None and t.numel() > 0)
    reach, holder = None, None
    for start, end, f in spans:
        if reach is not None and start < reach \
                and (f in written or holder in written):
            raise ValueError(
                f"{kernel}: {f} shares storage with {holder}, and the "
                f"kernel updates {f if f in written else holder} in place")
        if reach is None or end > reach:
            reach, holder = end, f
