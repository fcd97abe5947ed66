"""Command line of the PyTorch port: ``run`` and ``params``.

    python -m graphite_tpu_torch.cli run --trace t.npz [--device cpu]
    python -m graphite_tpu_torch.cli params [--section/key=value ...]

Mirrors the JAX package's ``graphite-tpu run`` / ``params``.  ``run``
uses CUDA unless ``--device`` names another device; without a GPU the
default raises rather than running on the CPU.  Config overrides use the
same ``--section/key=value`` form.  With ``--tpu/tile_shards=S`` (S > 1)
``run`` starts S ranks (parallel.mesh.launch: gloo, on the card or, with
``--device cpu``, on the host) and rank 0 prints the summary.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import List, Optional

from graphite_tpu_torch.config import load_config, parse_overrides
from graphite_tpu_torch.params import SimParams

# The wall-clock limit of a sharded run's ranks (parallel.mesh.launch).
SHARD_TIMEOUT_S = 24 * 3600.0


def _run_text(cfg, trace_path: str, device, group=None) -> str:
    from graphite_tpu_torch.engine.sim import run_simulation_from_trace
    return run_simulation_from_trace(cfg, trace_path, device=device,
                                     group=group).render()


def _rank_run(group, config, overrides, trace_path):
    """One rank of ``run --tpu/tile_shards=S``: rank 0's summary text."""
    text = _run_text(load_config(config, overrides=overrides), trace_path,
                     None, group)
    return text if group.rank == 0 else None


def _build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="graphite-tpu-torch")
    sub = ap.add_subparsers(dest="command", required=True)

    run = sub.add_parser("run", help="run a simulation from a trace")
    run.add_argument("-c", "--config", default=None)
    run.add_argument("--trace", required=True, help="trace .npz path")
    run.add_argument("-o", "--output", default=None,
                     help="summary output path")
    run.add_argument("--device", default=None,
                     help="torch device (default: cuda; 'cpu' runs the "
                          "plain PyTorch forms of the kernels)")

    par = sub.add_parser("params", help="print derived simulation parameters")
    par.add_argument("-c", "--config", default=None)
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    overrides, rest = parse_overrides(argv)
    args = _build_parser().parse_args(rest)
    cfg = load_config(args.config, overrides=overrides)
    from graphite_tpu_torch import log as logmod
    logmod.configure(cfg)

    if args.command == "params":
        params = SimParams.from_config(cfg)
        print(json.dumps(dataclasses.asdict(params), indent=2, default=str))
        return 0

    if args.command == "run":
        from graphite_tpu_torch.events.schema import Trace
        shards = SimParams.from_config(
            cfg, num_tiles=Trace.load(args.trace).num_tiles).tile_shards
        if shards > 1:
            from graphite_tpu_torch.parallel.mesh import launch
            text = launch(_rank_run, shards, device=args.device or "cuda",
                          timeout_s=SHARD_TIMEOUT_S,
                          args=(args.config, overrides, args.trace))[0]
        else:
            text = _run_text(cfg, args.trace, args.device)
        if args.output:
            with open(args.output, "w") as f:
                f.write(text)
        else:
            print(text)
        return 0
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
