"""Module-filtered logging (the reference Log framework's role).

The reference's Log singleton (reference: common/misc/log.h, [log] config
carbon_sim.cfg:75-79) offers per-module enable/disable lists, per-tile log
files, and LOG_PRINT/LOG_ASSERT_ERROR macros compiled out unless enabled.
In a jitted array engine, per-event device logging is not meaningful —
state machines advance thousands of tiles per fused step — so the same
capability maps to:

  * host-side module-filtered loggers for everything that runs on the
    host (driver loop, config resolution, CLI, trace IO), configured from
    the same [log] keys;
  * ``log_assert`` for fail-loudly invariant checks on host values
    (LOG_ASSERT_ERROR's role);
  * device-side inspection is the summary/statistics-trace machinery
    (engine/sim.py) rather than print streams.
"""

from __future__ import annotations

import logging
import sys
from typing import Optional

_CONFIGURED = False
_ENABLED: Optional[set] = None     # None = all modules when enabled
_DISABLED: set = set()
_ROOT = "graphite_tpu_torch"


def _apply_filter(module: str, lg: logging.Logger) -> None:
    if module in _DISABLED or (_ENABLED is not None
                               and module not in _ENABLED):
        lg.setLevel(logging.CRITICAL)
    else:
        lg.setLevel(logging.NOTSET)     # inherit the root's level


def configure(cfg) -> None:
    """Apply the [log] config section (reference: log.cc reading
    log/enabled_modules + log/disabled_modules).  Re-applies the filter to
    every already-created module logger, so loggers fetched at import time
    (before configure) pick up the new policy."""
    global _CONFIGURED, _ENABLED, _DISABLED
    enabled = cfg.get_bool("log/enabled", False)
    mods = [m.strip() for m in
            cfg.get_str("log/enabled_modules", "").split(",") if m.strip()]
    dis = [m.strip() for m in
           cfg.get_str("log/disabled_modules", "").split(",") if m.strip()]
    _ENABLED = set(mods) if mods else None
    _DISABLED = set(dis)
    root = logging.getLogger(_ROOT)
    root.setLevel(logging.DEBUG if enabled else logging.WARNING)
    if not _CONFIGURED:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(logging.Formatter(
            "[%(name)s] %(levelname)s %(message)s"))
        root.addHandler(h)
        _CONFIGURED = True
    prefix = _ROOT + "."
    for name, lg in logging.Logger.manager.loggerDict.items():
        if name.startswith(prefix) and isinstance(lg, logging.Logger):
            _apply_filter(name[len(prefix):], lg)


def get_logger(module: str) -> logging.Logger:
    """Per-module logger honoring the enable/disable lists."""
    lg = logging.getLogger(f"{_ROOT}.{module}")
    _apply_filter(module, lg)
    return lg


def log_assert(condition: bool, message: str, *args) -> None:
    """LOG_ASSERT_ERROR's role: loud, formatted invariant failure."""
    if not condition:
        raise AssertionError(message % args if args else message)
