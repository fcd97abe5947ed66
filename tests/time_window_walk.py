"""Device time per launch of ``window_walk`` at K = 16, P = 0 (the default
config, T = 64) on one CUDA card, for a checkout of the repository: the
window is captured from the checkout's own radix64 run (``gen_radix(64,
keys_per_tile=64, radix=256, seed=0)``, two steps), and each of three
readings is ``chip_smoke.walk_device_ms`` over 200 launches from the
window-start state.

    python tests/time_window_walk.py <checkout> <label>

To hold two versions of the kernel against each other, unpack the other
commit beside this one (``git archive``) and run the script on each in
turns, in one command on one card (parent, change, change, parent, ...):
each run builds its checkout's own kernel.
"""

import os
import sys


def main(tree: str, label: str) -> None:
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    os.chdir(tree)
    import chip_smoke as cs
    from graphite_tpu_torch import load_config
    from graphite_tpu_torch.engine.core import window_operands
    from graphite_tpu_torch.engine.kernels import window as kwin
    from graphite_tpu_torch.engine.quantum import next_boundary
    from graphite_tpu_torch.engine.sim import Simulator
    from graphite_tpu_torch.events import synth
    from graphite_tpu_torch.params import SimParams
    if not kwin.__file__.startswith(tree):
        raise SystemExit(f"imported {kwin.__file__}, not {tree}'s port")
    p = SimParams.from_config(load_config())
    sim = Simulator(p, synth.gen_radix(64, keys_per_tile=64, radix=256,
                                       seed=0), device="cuda")
    sim.run(max_steps=2)
    st = sim.state._replace(boundary=next_boundary(p, sim.state))
    _, wi = window_operands(p, st, sim.trace)
    wi = cs.clone_operands(wi)
    got = [cs.walk_device_ms(kwin, p, sim.vp, wi, 64, launches=200)
           for _ in range(3)]
    print(f"{label}: window_walk K=16 P=0 device ms per launch "
          + " ".join(f"{x:.6f}" for x in got), flush=True)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
