"""Simulated-time conventions.

Simulated time is an int64 count of **picoseconds**, matching the
reference's Time type (reference: common/misc/time_types.h:7-60).  Model
latencies are specified in cycles at some module frequency (GHz) and
converted to picoseconds at use, matching the reference's frequency-aware
Latency type (time_types.h Latency).

The engine stores integer clock periods (state.period_ps), so device code
never sees floats; the host-side conversions here round-half-up like the
reference's double->UInt64 conversion.
"""

from __future__ import annotations

import numpy as np

PS_PER_NS = 1000
PS_PER_US = 1000_000
PS_PER_S = 10**12

# A sentinel "never" time for wakeup lists / termination checks.
TIME_MAX = np.int64(2**62)


def cycles_to_ps(cycles, freq_ghz):
    """Host-side: cycle count at ``freq_ghz`` -> int64 picoseconds.

    cycles * period_ps(freq) with the same integer period the engine
    stores (state.period_ps) — device code multiplies integer periods
    directly and never sees floats.
    """
    return np.int64(cycles) * np.int64(round(PS_PER_NS / float(freq_ghz)))


def ps_to_cycles(ps, freq_ghz):
    """Host-side: int64 picoseconds -> cycle count at ``freq_ghz``
    (rounded against the engine's integer period)."""
    p = np.int64(round(PS_PER_NS / float(freq_ghz)))
    return np.int64((np.int64(ps) + p // 2) // p)


def ns_to_ps(ns) -> np.int64:
    return np.int64(round(float(ns) * PS_PER_NS))


def ps_to_ns(ps) -> float:
    return float(ps) / PS_PER_NS


def period_ps(freq_ghz) -> int:
    """Integer picoseconds per cycle at ``freq_ghz`` — the engine's clock
    convention (state.period_ps stores exactly this value per module)."""
    return int(round(PS_PER_NS / float(freq_ghz)))
