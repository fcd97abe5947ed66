"""PyTorch port, the engine under the CUDA walk's in-place contract, on the
CPU.

On the card ``window_walk_cuda`` updates the state's cache word arrays,
round-robin pointers, predictor table and, at ``tpu/miss_chain`` > 0, the
[P, T] chain bank in place, and returns those input tensors as the
corresponding ``WindowOut`` leaves.  Any engine code that kept a reference
to a pre-walk array and read it after the walk would see the walk's
updates there.  These tests run whole simulations on the CPU with
``run_window`` replaced by a shim that does what the kernel does — the
plain form's results copied into the operands' own storage, the operands
returned as the written leaves — and hold the runs to the same values the
other tests use: the chain-off golden and every SimState leaf against the
JAX package (tolerance 0: the engine is all-integer).

The JAX package's end states come through tests/torch_jax_ref.py:
its live run on the cases in ``LIVE``, its recorded pins on the others.
"""

import json
import os

import pytest
import torch

import jax

from graphite_tpu.config import load_config as jax_load_config
from graphite_tpu.engine.sim import Simulator as JaxSimulator
from graphite_tpu.events import synth as jax_synth
from graphite_tpu.params import SimParams as JaxSimParams
from graphite_tpu_torch import convert, load_config
from graphite_tpu_torch.engine import core as tcore
from graphite_tpu_torch.engine.kernels import window as twin
from graphite_tpu_torch.engine.sim import Simulator
from graphite_tpu_torch.events import synth
from graphite_tpu_torch.params import SimParams

import torch_jax_ref as ref

GOLDEN = os.path.join(os.path.dirname(__file__), "data",
                      "chain_off_golden.json")
RADIX8 = ("gen_radix", dict(num_tiles=8, keys_per_tile=64, radix=16,
                            seed=3))
FFT8 = ("gen_fft", dict(num_tiles=8, points_per_tile=32, writeback=True))
CASES = {
    "radix8_chain0": (RADIX8, {"tpu/miss_chain": 0}),
    "fft8_chain12": (FFT8, {"tpu/miss_chain": 12}),
    "radix8_ff4_span200": (RADIX8, {"tpu/fast_forward": 4,
                                    "tpu/fast_forward_span": 200}),
}
# The cases compared with the JAX package's live run in tier-1, one run
# shared by both tests of the case (the others with its recorded pins:
# tests/torch_jax_ref.py).
LIVE = ("radix8_ff4_span200",)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The engine's CPU path is thousands of tiny ops: one intra-op
    thread per test worker is faster than contending for every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _over(T, over):
    return {"general/total_cores": T, **over}


def _params(T, over):
    cj, ct = jax_load_config(), load_config()
    for c in (cj, ct):
        for k, v in _over(T, over).items():
            c.set(k, v)
    return JaxSimParams.from_config(cj), SimParams.from_config(ct)


class InPlaceWalk:
    """``run_window`` as the CUDA kernel behaves: the plain form, with
    every leaf the kernel writes in place copied into the operand's
    storage and the operand returned as that leaf."""

    def __init__(self):
        self.calls = 0

    def __call__(self, params, vp, wi, s_ids):
        out = twin.window_walk(params, vp, wi, s_ids)
        leaves = {}
        for f in twin.INPLACE_FIELDS:
            src = getattr(wi, f)
            if src is None:
                continue
            src.copy_(getattr(out, f))
            leaves[f] = src
        self.calls += 1
        return out._replace(**leaves)


@pytest.fixture(scope="module")
def jax_leaves():
    """The JAX package's end state of a case, run at the first need and
    shared by the tests that read it."""
    runs = {}

    def get(name):
        if name not in runs:
            (fn, kw), over = CASES[name]
            jp, _ = _params(kw["num_tiles"], over)
            jsim = JaxSimulator(jp, getattr(jax_synth, fn)(**kw))
            jsim.run(max_steps=4096)
            runs[name] = convert.leaves_to_numpy(jax.device_get(jsim.state))
        return runs[name]
    return get


def _check(key, name, tsim, jax_leaves):
    (_, kw), over = CASES[name]
    ref.check("test_torch_window_inplace", key,
              convert.state_to_numpy(tsim.state), lambda: jax_leaves(name),
              ref.inputs(_over(kw["num_tiles"], over), tsim.trace,
                         steps=4096), live=name in LIVE)


@pytest.mark.parametrize("name", sorted(CASES))
def test_engine_under_in_place_walk(name, monkeypatch, jax_leaves):
    (fn, kw), over = CASES[name]
    _, tp = _params(kw["num_tiles"], over)
    shim = InPlaceWalk()
    monkeypatch.setattr(tcore.kwindow, "run_window", shim)
    tsim = Simulator(tp, getattr(synth, fn)(**kw), device="cpu")
    tsum = tsim.run(max_steps=4096)
    assert shim.calls > 0
    assert bool(tsim.state.done.all())
    if name == "radix8_chain0":
        gold = json.load(open(GOLDEN))["radix8"]
        assert tsum.completion_time_ps == gold["completion_time_ps"]
        assert tsum.clock.tolist() == gold["clock"]
        for f, want in gold["round_ctrs"].items():
            assert int(getattr(tsim.state, f)) == want, f
        for k, want in gold["counters"].items():
            assert tsum.counters[k].tolist() == want, k
    _check(name, name, tsim, jax_leaves)


class InPlaceFFWalk:
    """``run_fast_forward`` as the CUDA kernel behaves: the plain form,
    with every leaf the kernel writes in place copied into the operand's
    storage and the operand returned as that leaf."""

    def __init__(self):
        self.calls = 0
        self.engaged = 0

    def __call__(self, params, vp, fi):
        out = twin.fast_forward_walk(params, vp, fi)
        for f in twin.FF_INPLACE_FIELDS:
            getattr(fi, f).copy_(getattr(out, f))
        self.calls += 1
        self.engaged += int((out.n_ret > 0).any())
        return out._replace(**{f: getattr(fi, f)
                               for f in twin.FF_INPLACE_FIELDS})


def test_engine_under_in_place_ff_walk(monkeypatch, jax_leaves):
    """radix8 at fast_forward 4, span 200, with both walks in place:
    every SimState leaf equal to the JAX package."""
    (fn, kw), over = CASES["radix8_ff4_span200"]
    _, tp = _params(kw["num_tiles"], over)
    walk, ff = InPlaceWalk(), InPlaceFFWalk()
    monkeypatch.setattr(tcore.kwindow, "run_window", walk)
    monkeypatch.setattr(tcore.kwindow, "run_fast_forward", ff)
    tsim = Simulator(tp, getattr(synth, fn)(**kw), device="cpu")
    tsim.run(max_steps=4096)
    assert walk.calls > 0 and ff.engaged > 0
    assert bool(tsim.state.done.all())
    _check("ff_walk_radix8_ff4_span200", "radix8_ff4_span200", tsim,
           jax_leaves)
