"""The JAX package as the port's CPU tests use it: its functions run op by
op (:func:`eager`), and its end states for the whole-run parity tests
(:func:`check`).

A kernel-parity test calls a JAX function (a window walk, a classify
step) a few times per configuration, where compiling its unrolled
per-event program costs far more than running it: :func:`eager` runs it
under ``jax.disable_jit``.  The functions are all-integer, so the
results are the same.

A whole-run parity test holds every SimState leaf of the port's run to
the JAX package's on the same params and trace.  Compiling the JAX
package's megarun for one configuration takes 20 to 170 s on the CPU,
most of such a test's time, and the tier-1 suite runs dozens of
configurations.  So each test module runs the JAX package live on a few
cases (``live=True``: its cheapest configurations that still reach the
branches the module exists to show, each JAX run shared by the tests
that read it), and holds its other cases to the JAX package's leaves as
recorded in ``tests/data/torch_jax_pins/<test module>.json``: per case
the SHA-256 of its inputs (:func:`inputs`: the config overrides, the
trace's arrays, the quanta run) and per leaf its dtype, shape and the
SHA-256 of its bytes, written by this module from the JAX package's own
run after the port's leaves were held equal to it.  A pin is read only
for the inputs it was recorded from: a case whose inputs changed fails
until its pin is recorded again.  The comparison is exact, leaf by leaf.

A function-parity test (a walk, a classify step, a resolver) holds the
port's outputs the same way (:func:`check_outputs`): the JAX function
runs on the module's live cases, and the others read the JAX outputs
recorded for the same inputs (the config and the operand arrays, whose
digest is the case's key).

``GRAPHITE_TORCH_JAX`` chooses where the other cases' leaves come from:

  * unset — the pins; a case without a pin runs the JAX package;
  * ``live`` — the JAX package, every case;
  * ``record`` — the JAX package, every case, and the pins of the cases
    that are not live are rewritten from it (after the port's leaves
    were held equal to it).

Compare every case live, or record the pins again, one module per
process (the JAX package on the CPU):

    GRAPHITE_TORCH_JAX=live JAX_PLATFORMS=cpu python -m pytest \\
        tests/test_torch_*.py -m 'not gpu and not slow' \\
        -p no:cacheprovider -n 6 --dist loadfile
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Callable, Dict

import numpy as np

ENV = "GRAPHITE_TORCH_JAX"


def eager(fn):
    """``fn`` of the JAX package, run op by op (``jax.disable_jit``); jax
    is imported at the call, so this module imports without it."""
    def run(*args):
        import jax
        with jax.disable_jit():
            return fn(*args)
    return run
PIN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                       "torch_jax_pins")


def digest(a) -> str:
    """``dtype|shape|sha256`` of one leaf (C order bytes)."""
    a = np.ascontiguousarray(np.asarray(a))
    return (f"{a.dtype.str}|{'x'.join(map(str, a.shape))}|"
            f"{hashlib.sha256(a.tobytes()).hexdigest()[:32]}")


def _path(module: str) -> str:
    return os.path.join(PIN_DIR, f"{module}.json")


def _load(module: str) -> Dict[str, Dict[str, str]]:
    try:
        with open(_path(module)) as f:
            return json.load(f)
    except FileNotFoundError:
        return {}


def inputs(over: Dict[str, object], trace=None, arrays=None,
           **extra) -> str:
    """SHA-256 of a case's inputs: the config overrides ``over`` (the
    tile count among them), the port's ``trace`` (the engine's
    TraceArrays, addr and meta, or a Trace's ops, addr, arg and arg2:
    each array's dtype, shape and bytes), a function's operand
    ``arrays`` (name -> numpy array or None, each by dtype, shape and
    bytes) and any ``extra`` values (the steps or quanta run).  The JAX
    package is fixed, so these decide its leaves."""
    h = hashlib.sha256(json.dumps(
        [sorted((str(k), str(v)) for k, v in over.items()),
         sorted((str(k), str(v)) for k, v in extra.items())]).encode())
    for name in sorted(arrays or {}):
        a = arrays[name]
        if a is None:
            h.update(f"{name}|None".encode())
            continue
        a = np.ascontiguousarray(np.asarray(a))
        h.update(f"{name}|{a.dtype.str}|{a.shape}".encode())
        h.update(a.tobytes())
    if trace is not None:
        # The engine's TraceArrays (addr, meta) or a Trace's arrays.
        fields = ("addr", "meta") if hasattr(trace, "meta") else (
            "ops", "addr", "arg", "arg2")
        for f in fields:
            a = np.ascontiguousarray(np.asarray(getattr(trace, f)))
            h.update(f"{f}|{a.dtype.str}|{a.shape}".encode())
            h.update(a.tobytes())
    return h.hexdigest()[:32]


def outputs(out, prefix: str = "") -> Dict[str, np.ndarray]:
    """A function's outputs as flat numpy leaves: a NamedTuple (nested
    ones under ``field.`` names) or a dict of torch tensors or JAX
    arrays, None fields left out, uint64 (the sharer words) as their
    int64 bits, as the port holds them."""
    items = out.items() if isinstance(out, dict) else zip(out._fields, out)
    leaves = {}
    for f, v in items:
        if v is None:
            continue
        if hasattr(v, "_fields") or isinstance(v, dict):
            leaves.update(outputs(v, f"{prefix}{f}."))
            continue
        a = np.asarray(v.cpu() if hasattr(v, "cpu") else v)
        leaves[prefix + f] = a.view(np.int64) if a.dtype == np.uint64 else a
    return leaves


def fields_of(like, out) -> Dict[str, object]:
    """``out``'s fields that ``like`` (a NamedTuple) has, as a dict: the
    JAX function's outputs limited to the port's."""
    return {f: getattr(out, f) for f in like._fields}


def check_outputs(module: str, tout, jax_out: Callable[[], object],
                  over: Dict[str, object], arrays,
                  live: bool = False) -> None:
    """Hold a port function's outputs ``tout`` to the JAX function's on the
    same operands, as :func:`check` holds end states: ``jax_out()`` (the
    JAX function run) where ``live``, :data:`ENV` asks for it or the case
    has no pin, else the pin recorded for these inputs (the config
    overrides ``over`` and the operand ``arrays``; the inputs' digest is
    the case's key)."""
    key = inputs(over, arrays=arrays)
    check(module, key, outputs(tout), lambda: outputs(jax_out()), key,
          live)


def _record(module: str, key: str, case_inputs: str,
            leaves: Dict[str, np.ndarray]) -> None:
    pins = _load(module)
    pins[key] = {"inputs": case_inputs,
                 "leaves": {name: digest(v)
                            for name, v in sorted(leaves.items())}}
    os.makedirs(PIN_DIR, exist_ok=True)
    with open(_path(module), "w") as f:
        json.dump(pins, f, indent=0, sort_keys=True)
        f.write("\n")


def assert_leaves_equal(jleaves, tleaves) -> None:
    """Every leaf of both flat dicts equal: names, dtypes, shapes,
    values; a float leaf (the DRAM queue models' ``dram_qacc``) by its
    bytes, as a pin holds it."""
    assert set(jleaves) == set(tleaves)
    for name in sorted(jleaves):
        a, b = np.asarray(jleaves[name]), np.asarray(tleaves[name])
        assert a.dtype == b.dtype and a.shape == b.shape, \
            (name, a.dtype, b.dtype, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=name)
        if a.dtype.kind == "f":
            assert np.ascontiguousarray(a).tobytes() \
                == np.ascontiguousarray(b).tobytes(), name


def check(module: str, key: str, tleaves: Dict[str, np.ndarray],
          jax_leaves: Callable[[], Dict[str, np.ndarray]],
          case_inputs: str, live: bool = False) -> Dict[str, np.ndarray]:
    """Hold the port's flat leaves ``tleaves`` (convert.state_to_numpy)
    to the JAX package's end state of case ``key`` of test module
    ``module``: ``jax_leaves()`` (the JAX package's flat leaves,
    convert.leaves_to_numpy) where the case is ``live``, :data:`ENV`
    asks for it or the case has no pin, else its pin, which must have
    been recorded from the same ``case_inputs`` (:func:`inputs`).
    Returns the JAX package's leaves: those computed, or under a pin the
    port's (equal to them leaf by leaf)."""
    mode = os.environ.get(ENV, "")
    pins = _load(module)
    if live or mode in ("live", "record") or key not in pins:
        jleaves = jax_leaves()
        assert_leaves_equal(jleaves, tleaves)
        if mode == "record" and not live:
            _record(module, key, case_inputs, jleaves)
        return jleaves
    pin = pins[key]
    assert pin["inputs"] == case_inputs, (
        f"{key}: the pin was recorded from other inputs than this case's; "
        f"record it again ({ENV}=record)")
    want = pin["leaves"]
    assert set(want) == set(tleaves), sorted(set(want) ^ set(tleaves))
    for name in sorted(want):
        assert digest(tleaves[name]) == want[name], \
            (f"{key}: leaf {name} differs from the JAX package's "
             f"({digest(tleaves[name])} != {want[name]})")
    return tleaves


def megarun_carry(module: str, key: str, jp, jax_trace: Callable, tp,
                  trace, quanta: int, more: int, over: Dict[str, object],
                  live: bool = False):
    """The carry-across check of a whole-run test: the state ``quanta``
    quanta into the run (the port's, held to the JAX package's: key
    ``<key>_mid``), carried through ``convert`` into a new port state,
    runs ``more`` quanta to the JAX package's state from the same point
    (``<key>_next``).  ``jax_trace()`` makes the JAX package's trace for
    params ``jp``; ``trace`` is the port's for ``tp``; both params come
    from the config overrides ``over``.  ``live`` as in :func:`check`.
    Returns the mid state's flat leaves and the port's final state."""
    from graphite_tpu_torch import convert
    from graphite_tpu_torch.engine import quantum as tquantum
    from graphite_tpu_torch.engine.sim import Simulator
    tsim = Simulator(tp, trace, device="cpu")
    tmid = tquantum.megarun(tp, tsim.state, tsim.trace, quanta)
    states = {}

    def jax_state(which):
        if not states:
            import jax
            from graphite_tpu.engine import quantum as jquantum
            from graphite_tpu.engine.sim import Simulator as JaxSimulator
            jsim = JaxSimulator(jp, jax_trace())
            mid = jquantum.megarun(jp, jsim.state, jsim.trace, quanta)
            nxt = jquantum.megarun(jp, mid, jsim.trace, more)
            states.update(
                mid=convert.leaves_to_numpy(jax.device_get(mid)),
                next=convert.leaves_to_numpy(jax.device_get(nxt)))
        return states[which]

    leaves = check(module, f"{key}_mid", convert.state_to_numpy(tmid),
                   lambda: jax_state("mid"),
                   inputs(over, trace, quanta=quanta), live)
    tst = convert.state_from_numpy(tp, leaves, "cpu")
    assert_leaves_equal(leaves, convert.state_to_numpy(tst))
    tnext = tquantum.megarun(tp, tst, tsim.trace, more)
    check(module, f"{key}_next", convert.state_to_numpy(tnext),
          lambda: jax_state("next"),
          inputs(over, trace, quanta=quanta, more=more), live)
    return leaves, tnext
