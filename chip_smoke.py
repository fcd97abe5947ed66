#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is caught):

  1. The card (nvidia-smi name and power limit), torch and CUDA versions.
  2. Build every CUDA source of the port from this checkout (one nvcc per
     source, started together); print the seconds and the ptxas
     register/spill lines.
  3. Every kernel against its plain PyTorch form ON THE CARD at the main
     path's shapes (T = 64, K = 16, default geometry): random operands
     from a numpy seed and a window captured from the port's own radix64
     run.  Every output leaf must be equal.  Times: CUDA events over many
     launches after warm-up, kernel and plain form.
  4. The golden shapes radix8 and fft8 against
     tests/data/chain_off_golden.json, exactly.
  5. The main path at full width: ``gen_radix(64, keys_per_tile=2048,
     radix=256, seed=0)`` on the default config through
     ``Simulator(...).run()`` — all_done, round_ctr 13838, completion
     243,651.8 ns, and window-kernel launches == ctr_window.  Kernel
     launch counts are zeroed just before this run and read just after.
  6. A profiled stretch of the same run (torch.profiler): device busy
     time per round, held against phase 5's unprofiled wall time per
     round (the profiler's own host overhead slows the stretch's wall).

The last two lines of standard output are the ``kernels`` JSON object
and the ``ok`` JSON object.  Without a CUDA device, or without the port's
sources beside this file, the script exits non-zero and prints no result.
"""

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# Values pinned by BENCH_r06's radix64 row (all-integer engine, so they
# are device-independent).
FULL_KEYS = 2048
FULL_ROUND_CTR = 13838
FULL_COMPLETION_PS = 243_651_800
HBM_BYTES_PER_S = 3.35e12          # H100 SXM peak memory rate


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    raise SystemExit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def time_cuda(fn, iters: int, warmup: int) -> float:
    """Milliseconds per call: CUDA events around ``iters`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def max_abs_err(a, b) -> int:
    import torch
    check(a.dtype == b.dtype and a.shape == b.shape,
          f"dtype/shape mismatch {a.dtype}{tuple(a.shape)} vs "
          f"{b.dtype}{tuple(b.shape)}")
    if a.numel() == 0:
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item())


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this test needs a card")
    sys.path.insert(0, HERE)
    try:
        import graphite_tpu_torch
    except ImportError as e:
        fail(f"the port's sources are not beside chip_smoke.py ({e})")
    check(os.path.dirname(os.path.dirname(os.path.abspath(
        graphite_tpu_torch.__file__))) == HERE,
        "graphite_tpu_torch was imported from outside this checkout")
    check("jax" not in sys.modules, "jax must not be imported")

    from graphite_tpu_torch import load_config
    from graphite_tpu_torch.engine.core import window_operands
    from graphite_tpu_torch.engine.kernels import build
    from graphite_tpu_torch.engine.kernels import window as kwin
    from graphite_tpu_torch.engine.quantum import next_boundary
    from graphite_tpu_torch.engine.sim import Simulator
    from graphite_tpu_torch.engine.vparams import variant_params
    from graphite_tpu_torch.events import synth
    from graphite_tpu_torch.params import SimParams

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()

    # ---- 1. the card
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, devices {count}")

    # ---- 2. build every kernel from this checkout
    t0 = time.perf_counter()
    info = build.build_all()
    print(f"build: {len(info)} source(s) in "
          f"{time.perf_counter() - t0:.3f} s")
    for name, rec in info.items():
        lines = [ln.strip() for ln in rec["ptxas"]
                 if "registers" in ln or "spill" in ln]
        for ln in lines:
            print(f"build: {name}: {ln}")

    # ---- 3. kernel vs plain form on the card, at the main path's shapes
    params = SimParams.from_config(load_config())      # default config
    vp = variant_params(params)
    T, K = params.num_tiles, params.block_events
    cases = []
    for seed in range(8):
        cases.append((f"random seed {seed}", kwin.window_in_from_numpy(
            kwin.random_window_arrays(params, K, seed), dev)))
    trace = synth.gen_radix(64, keys_per_tile=FULL_KEYS, radix=256, seed=0)
    cap_sim = Simulator(params, trace, device=dev)
    cap_sim.run(max_steps=2)
    st = cap_sim.state._replace(boundary=next_boundary(params,
                                                       cap_sim.state))
    _, captured = window_operands(params, st, cap_sim.trace)
    cases.append(("captured radix64 window", captured))
    err = 0
    for label, wi in cases:
        got = kwin.window_walk_cuda(params, vp, wi, T)
        ref = kwin.window_walk(params, vp, wi, T)
        torch.cuda.synchronize()
        for f in kwin.WindowOut._fields:
            e = max_abs_err(getattr(got, f), getattr(ref, f))
            check(e == 0, f"window_walk kernel != plain on {label}, "
                          f"leaf {f} (max abs err {e})")
            err = max(err, e)
    print(f"kernel window_walk: {len(cases)} operand sets, every output "
          f"leaf equal to the plain form (max abs err {err})")
    wi = captured
    ms = time_cuda(lambda: kwin.window_walk_cuda(params, vp, wi, T),
                   iters=500, warmup=50)
    plain_ms = time_cuda(lambda: kwin.window_walk(params, vp, wi, T),
                         iters=50, warmup=5)
    # Bytes the out-of-place walk must move: every operand it reads once,
    # every output it writes once.  An array the wrapper passes through
    # (the round-robin pointers: L2's always, the L1s' unless their
    # replacement is round_robin) is neither read nor written.
    out = kwin.window_walk_cuda(params, vp, wi, T)
    passed = {f for f in kwin.WindowOut._fields if f in kwin.WindowIn._fields
              and getattr(out, f) is getattr(wi, f)}
    moved = sum(t.numel() * t.element_size()
                for f, t in zip(kwin.WindowIn._fields, wi)
                if f not in passed) + sum(
        t.numel() * t.element_size()
        for f, t in zip(kwin.WindowOut._fields, out) if f not in passed)
    bound_ms = moved / HBM_BYTES_PER_S * 1e3
    print(f"kernel window_walk: {ms:.6f} ms/launch (wrapper, clones "
          f"included), plain {plain_ms:.6f} ms, bound {bound_ms:.6f} ms "
          f"({moved} bytes at {HBM_BYTES_PER_S / 1e12:.2f} TB/s) on {card}")

    # ---- 4. golden shapes, exactly
    gold = json.load(open(os.path.join(HERE, "tests", "data",
                                       "chain_off_golden.json")))
    for name, gtrace in (
            ("radix8", synth.gen_radix(num_tiles=8, keys_per_tile=64,
                                       radix=16, seed=3)),
            ("fft8", synth.gen_fft(num_tiles=8, points_per_tile=64))):
        cfg = load_config()
        cfg.set("general/total_cores", 8)
        cfg.set("tpu/miss_chain", 0)
        sim = Simulator(SimParams.from_config(cfg), gtrace, device=dev)
        kwin.run_window.launches = 0
        s = sim.run(max_steps=256)
        g = gold[name]
        check(bool(s.done.all()), f"{name}: not all done")
        check(s.completion_time_ps == g["completion_time_ps"],
              f"{name}: completion {s.completion_time_ps} != "
              f"{g['completion_time_ps']}")
        check(s.clock.tolist() == g["clock"], f"{name}: clocks differ")
        for f, want in g["round_ctrs"].items():
            got = int(getattr(sim.state, f).item())
            check(got == want, f"{name}.{f}: {got} != golden {want}")
        for k, want in g["counters"].items():
            check(s.counters[k].tolist() == want, f"{name}.{k} differs")
        check(kwin.run_window.launches == int(sim.state.ctr_window.item()),
              f"{name}: kernel launches != ctr_window")
        print(f"golden {name}: exact (round_ctr "
              f"{int(sim.state.round_ctr.item())}, completion "
              f"{s.completion_time_ps} ps, {kwin.run_window.launches} "
              f"kernel launches)")

    # ---- 5. the main path at full width
    sim = Simulator(params, trace, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kwin.run_window.launches = 0
    t0 = time.perf_counter()
    s = sim.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kwin.run_window.launches
    st = sim.state
    rounds = int(st.round_ctr.item())
    ctr = {f: int(getattr(st, f).item()) for f in (
        "ctr_quantum", "ctr_window", "ctr_complex", "ctr_conflict",
        "ctr_resolve", "round_ctr")}
    check(bool(s.done.all()), "radix64: not all done")
    check(rounds == FULL_ROUND_CTR, f"radix64: round_ctr {rounds} != "
                                    f"{FULL_ROUND_CTR}")
    check(s.completion_time_ps == FULL_COMPLETION_PS,
          f"radix64: completion {s.completion_time_ps} != "
          f"{FULL_COMPLETION_PS}")
    check(launches == ctr["ctr_window"] and launches > 0,
          f"radix64: kernel launches {launches} != ctr_window "
          f"{ctr['ctr_window']}")
    mips = s.total_instructions / wall / 1e6
    print(f"radix64 keys_per_tile={FULL_KEYS}: all_done, round_ctr "
          f"{rounds}, completion {s.completion_time_ps / 1000:.1f} ns, "
          f"{s.total_instructions} instructions; counters {ctr}")
    print(f"radix64: wall {wall:.3f} s, {rounds / wall:.2f} rounds/s, "
          f"{1e3 * wall / rounds:.4f} ms/round, simulated MIPS {mips:.6f}, "
          f"max_memory_allocated {torch.cuda.max_memory_allocated()} B, "
          f"window_walk launches {launches}, "
          f"kernel share {launches * ms / 1e3 / wall:.4f} of wall "
          f"(launches x {ms:.6f} ms) on {card}")

    # ---- 6. where the time goes: a profiled stretch of the same run
    from torch.profiler import ProfilerActivity, profile
    psim = Simulator(params, trace, device=dev)
    psim.run(max_steps=2)                 # past start-up
    torch.cuda.synchronize()
    q0 = int(psim.state.ctr_quantum.item())
    r0 = int(psim.state.round_ctr.item())
    w0 = int(psim.state.ctr_window.item())
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        psim.run(max_steps=4)
        torch.cuda.synchronize()
        pwall = time.perf_counter() - t0
    pr = int(psim.state.round_ctr.item()) - r0
    pq = int(psim.state.ctr_quantum.item()) - q0
    pw = int(psim.state.ctr_window.item()) - w0
    dev_us = 0.0
    walk_us = 0.0
    n_kernels = 0
    ppolls = 0
    for evt in prof.key_averages():
        if evt.key == "aten::_local_scalar_dense":     # one per .item()
            ppolls += evt.count
        t = getattr(evt, "self_device_time_total",
                    getattr(evt, "self_cuda_time_total", 0.0))
        if t and evt.device_type is not None \
                and "cuda" in str(evt.device_type).lower():
            dev_us += t
            n_kernels += evt.count
            if "window_walk" in evt.key:
                walk_us += t
    if dev_us > 0:
        # The profiler's host overhead stretches the wall of this stretch,
        # so the busy share is device time per round over phase 5's
        # unprofiled wall time per round.
        busy_ms = dev_us / 1e3 / max(pr, 1)
        wall_ms = 1e3 * wall / rounds
        print(f"profile: {pq} quanta, {pr} rounds in {pwall:.3f} s "
              f"profiled wall ({1e3 * pwall / max(pr, 1):.4f} ms/round); "
              f"device busy {dev_us / 1e3:.3f} ms ({busy_ms:.6f} ms/round, "
              f"{busy_ms / wall_ms:.4f} of the unprofiled {wall_ms:.4f} "
              f"ms/round, idle share {1 - busy_ms / wall_ms:.4f}), "
              f"{n_kernels} device "
              f"kernels ({n_kernels / max(pr, 1):.1f} per round), "
              f"window_walk {walk_us / 1e3:.3f} ms over {pw} launches "
              f"({walk_us / 1e3 / max(pw, 1):.6f} ms device time each), "
              f"host polls {ppolls} ({ppolls / max(pr, 1):.2f} per round) "
              f"on {card}")
    else:
        print(f"profile: {pq} quanta, {pr} rounds in {pwall:.3f} s wall; "
              f"device time not measured (profiler saw no device "
              f"events), host polls {ppolls}")

    kernels = [{
        "name": "window_walk",
        "route": "cuda",
        "source": "graphite_tpu_torch/engine/kernels/csrc/window_walk.cu",
        "replaces": "graphite_tpu/engine/kernels/window.py:163",
        "launches": launches,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes",
        "library_ms": None,
    }]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
