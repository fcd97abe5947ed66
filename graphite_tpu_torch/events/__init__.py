"""Event streams: the frontend <-> timing-engine contract (see schema.py)."""

from graphite_tpu_torch.events.schema import Trace, TraceBuilder  # noqa: F401
