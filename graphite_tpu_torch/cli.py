"""Command line of the PyTorch port: ``run`` and ``params``.

    python -m graphite_tpu_torch.cli run --trace t.npz [--device cpu]
    python -m graphite_tpu_torch.cli params [--section/key=value ...]

Mirrors the JAX package's ``graphite-tpu run`` / ``params``.  ``run``
uses CUDA unless ``--device`` names another device; without a GPU the
default raises rather than running on the CPU.  Config overrides use the
same ``--section/key=value`` form.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import List, Optional

from graphite_tpu_torch.config import load_config, parse_overrides
from graphite_tpu_torch.params import SimParams


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
        from graphite_tpu_torch.engine.sim import run_simulation_from_trace
        summary = run_simulation_from_trace(cfg, args.trace,
                                           device=args.device)
        text = summary.render()
        if args.output:
            with open(args.output, "w") as f:
                f.write(text)
        else:
            print(text)
        return 0
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
