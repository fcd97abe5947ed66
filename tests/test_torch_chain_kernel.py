"""PyTorch port, the two kernels of the chain replay at P > 0.

  * The plain ``chain_classify`` against the JAX ``chain_classify`` (run
    inline: on the CPU ``tpu/pallas_kernels`` resolves to lax) on seeded
    random operands — fan-out replay on and off, DRAM queue model on and
    off, and a hash table of size H = 4 that forces collisions at the
    combining tables — and on the operands of the first replay
    iterations of a JAX radix8 chain-12 run.
  * The plain ``window_walk`` at P = 12 against the JAX walk, on fuzzed
    windows with a non-empty [P, T] bank and on windows captured from a
    JAX radix8 chain-12 run.
  * ``gpu``: both CUDA kernels against their plain forms on the card.

Every output field must be equal, value and dtype (tolerance 0: the
functions are all-integer; uint64 sharer words compare as int64 bits).
"""

import functools

import numpy as np
import pytest
import torch

from graphite_tpu_torch import load_config
from graphite_tpu_torch.engine.kernels import chain as tchain
from graphite_tpu_torch.engine.kernels import dispatch as tdispatch
from graphite_tpu_torch.engine.kernels import operands as toperands
from graphite_tpu_torch.engine.kernels import window as twin
from graphite_tpu_torch.engine.vparams import variant_params
from graphite_tpu_torch.params import SimParams

# The JAX package is imported inside the tests that compare against it,
# so the card's kernel tests run on a machine without jax
# (python -m pytest -m gpu --noconftest tests/test_torch_chain_kernel.py).

CHAIN = {"tpu/miss_chain": 12}
CONFIGS = {
    "fanout_queue": {},
    "fanout_noqueue": {"dram/queue_model/enabled": False},
    "nofanout_queue": {"tpu/fanout_replay": False},
    "nofanout_noqueue": {"tpu/fanout_replay": False,
                         "dram/queue_model/enabled": False},
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain forms are thousands of tiny ops: one intra-op thread
    per test worker is faster than contending for every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax():
    import jax
    import jax.numpy as jnp
    from graphite_tpu.config import load_config as jax_load_config
    from graphite_tpu.engine.kernels import chain as jchain
    from graphite_tpu.engine.kernels import window as jwin
    from graphite_tpu.engine.vparams import variant_params as jax_vp
    from graphite_tpu.params import SimParams as JaxSimParams
    return dict(jax=jax, jnp=jnp, jax_load_config=jax_load_config,
                jchain=jchain, jwin=jwin, jax_vp=jax_vp,
                JaxSimParams=JaxSimParams)


def _torch_params(T, over):
    ct = load_config()
    ct.set("general/total_cores", T)
    for k, v in {**CHAIN, **over}.items():
        ct.set(k, v)
    return SimParams.from_config(ct)


def _params(T, over):
    J = _jax()
    cj = J["jax_load_config"]()
    cj.set("general/total_cores", T)
    for k, v in {**CHAIN, **over}.items():
        cj.set(k, v)
    return J["JaxSimParams"].from_config(cj), _torch_params(T, over)


def _np(x):
    """A leaf as numpy, uint64 sharer words as int64 bits."""
    a = np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)
    return a.view(np.int64) if a.dtype == np.uint64 else a


def _assert_fields_equal(jout, tout, label=""):
    for f in tout._fields:
        a, b = getattr(jout, f), getattr(tout, f)
        assert (a is None) == (b is None), (label, f)
        if b is None:
            continue
        a, b = _np(a), _np(b)
        assert a.dtype == b.dtype and a.shape == b.shape, \
            (label, f, a.dtype, b.dtype, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=f"{label} {f}")


# ------------------------------------------------------- chain_classify

@functools.lru_cache(maxsize=None)
def _jax_classify():
    J = _jax()
    return J["jax"].jit(J["jchain"].chain_classify, static_argnums=(0, 3))


def _jax_chain_in(arrays):
    J = _jax()
    jnp = J["jnp"]
    conv = {}
    for f in J["jchain"].ChainIn._fields:
        a = arrays.get(f)
        if a is None:
            conv[f] = None
            continue
        a = np.asarray(a)
        if f == "dsharers":
            a = a.view(np.uint64)
        conv[f] = jnp.asarray(a)
    return J["jchain"].ChainIn(**conv)


def _classify_both(jp, tp, arrays, H):
    J = _jax()
    jout = _jax_classify()(jp, J["jax_vp"](jp), _jax_chain_in(arrays), H)
    tout = tchain.chain_classify(tp, variant_params(tp),
                                 toperands.chain_in_from_numpy(arrays, "cpu"),
                                 H)
    return jout, tout


def _rep_collisions(tp, arrays, tout):
    """Slots of the combining table written by served shared-read
    representatives of two or more different lines."""
    from graphite_tpu_torch.engine.state import dword_state
    ci = toperands.chain_in_from_numpy(arrays, "cpu")
    w = tout.way.to(torch.int64)
    st = dword_state(torch.gather(ci.drow, 1, w[:, None])[:, 0])
    ent = torch.where(tout.hit, st, 0)
    rep = tout.serve & ~ci.is_ex & ((ent == 0) | (ent == 1))
    lines = {}
    for r in torch.nonzero(rep).flatten().tolist():
        lines.setdefault(int(ci.hidx[r]), set()).add(int(ci.line[r]))
    return sum(len(v) > 1 for v in lines.values())


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_classify_matches_jax_on_random_operands(config, seed):
    jp, tp = _params(64, CONFIGS[config])
    H = max(1024, 16 * tp.num_tiles)
    arrays = toperands.random_chain_arrays(tp, H, seed)
    jout, tout = _classify_both(jp, tp, arrays, H)
    _assert_fields_equal(jout, tout, f"{config} seed {seed}")
    assert bool(tout.serve.any())


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_plain_classify_matches_jax_with_forced_collisions(config):
    """H = 4: every table slot is shared, so served representatives of
    different lines collide at the combining tables; the surviving row
    must be the JAX package's."""
    jp, tp = _params(64, CONFIGS[config])
    collided = 0
    for seed in range(12):
        arrays = toperands.random_chain_arrays(tp, 4, 100 + seed)
        jout, tout = _classify_both(jp, tp, arrays, 4)
        _assert_fields_equal(jout, tout, f"{config} H=4 seed {seed}")
        collided += _rep_collisions(tp, arrays, tout)
    assert collided > 0, "no representative collision was exercised"


def _capture(jp, trace_kw, steps, want, pick):
    """Run a JAX radix8 chain-12 simulation with ``pick`` (the kernel
    entry point to record: 'chain' or 'window') wrapped so each call's
    operands reach the host; returns the first ``want`` records."""
    J = _jax()
    jax = J["jax"]
    from graphite_tpu.engine import quantum as jquantum
    from graphite_tpu.engine.sim import Simulator as JaxSimulator
    from graphite_tpu.events import synth as jsynth
    mod = J["jchain"] if pick == "chain" else J["jwin"]
    name = "run_chain" if pick == "chain" else "run_window"
    orig = getattr(mod, name)
    seen = []

    def record(operands):
        seen.append(jax.tree_util.tree_map(np.asarray, operands))

    def wrapped(*args):
        jax.debug.callback(record, args[2], ordered=True)
        return orig(*args)

    sim = JaxSimulator(jp, jsynth.gen_radix(**trace_kw))
    state, tr = sim.state, sim.trace
    setattr(mod, name, wrapped)
    try:
        step = jax.jit(lambda st: jquantum.quantum_step(jp, st, tr))
        for _ in range(steps):
            state = step(state)
            jax.effects_barrier()
            if len(seen) >= want:
                break
    finally:
        setattr(mod, name, orig)
    return seen[:want]


RADIX8 = dict(num_tiles=8, keys_per_tile=64, radix=16, seed=3)


@pytest.fixture(scope="module")
def captured_chain_ins():
    jp, tp = _params(8, {})
    return jp, tp, _capture(jp, RADIX8, 40, 36, "chain")


def test_plain_classify_matches_jax_on_captured_operands(captured_chain_ins):
    jp, tp, recs = captured_chain_ins
    H = max(1024, 16 * tp.num_tiles)
    assert len(recs) == 36
    served = 0
    for i, ci in enumerate(recs):
        arrays = {f: getattr(ci, f) for f in ci._fields}
        jout, tout = _classify_both(jp, tp, arrays, H)
        _assert_fields_equal(jout, tout, f"iteration {i}")
        served += int(tout.serve_all.sum())
    assert served > 0


# ------------------------------------------------- window walk at P > 0

@functools.lru_cache(maxsize=None)
def _jax_walk():
    J = _jax()
    return J["jax"].jit(J["jwin"].window_walk, static_argnums=(0, 3))


def _jax_window_in(arrays):
    J = _jax()
    jnp = J["jnp"]
    return J["jwin"].WindowIn(**{
        f: (jnp.asarray(arrays[f]) if arrays.get(f) is not None else None)
        for f in J["jwin"].WindowIn._fields})


def _walk_both(jp, tp, arrays):
    J = _jax()
    s_ids = tp.num_tiles
    jout = _jax_walk()(jp, J["jax_vp"](jp), _jax_window_in(arrays), s_ids)
    tout = twin.window_walk(tp, variant_params(tp),
                            toperands.window_in_from_numpy(arrays, "cpu"),
                            s_ids)
    return jout, tout


WINDOW_CONFIGS = {
    "chain12": {},
    "chain12_nofanout": {"tpu/fanout_replay": False},
    "chain3_k8": {"tpu/miss_chain": 3, "tpu/block_events": 8},
}


@pytest.mark.parametrize("config", sorted(WINDOW_CONFIGS))
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_plain_walk_matches_jax_with_pending_bank(config, seed):
    jp, tp = _params(8, WINDOW_CONFIGS[config])
    arrays = toperands.random_window_arrays(tp, tp.block_events, seed)
    assert (arrays["mq_count"] > arrays["mq_head"]).any()
    jout, tout = _walk_both(jp, tp, arrays)
    _assert_fields_equal(jout, tout, f"{config} seed {seed}")


@pytest.fixture(scope="module")
def captured_windows():
    jp, tp = _params(8, {})
    return jp, tp, _capture(jp, RADIX8, 40, 60, "window")


def test_plain_walk_matches_jax_on_captured_banking_windows(
        captured_windows):
    jp, tp, recs = captured_windows
    banked = pending = 0
    for i, wi in enumerate(recs):
        arrays = {f: getattr(wi, f) for f in wi._fields}
        jout, tout = _walk_both(jp, tp, arrays)
        _assert_fields_equal(jout, tout, f"window {i}")
        banked += int((tout.mq_count.numpy() - arrays["mq_count"]).sum())
        pending += int((arrays["mq_count"] > arrays["mq_head"]).sum())
    assert banked > 0 and pending > 0


def test_run_chain_dispatches_by_device():
    """CPU tensors take the plain form and launch nothing; the kernel
    entry point refuses anything but CUDA tensors."""
    tp = _torch_params(8, {})
    vp = variant_params(tp)
    H = max(1024, 16 * tp.num_tiles)
    ci = toperands.chain_in_from_numpy(
        toperands.random_chain_arrays(tp, H, 5), "cpu")
    before = tdispatch.COUNTS["chain_classify"]
    out = tchain.run_chain(tp, vp, ci, H)
    ref = tchain.chain_classify(tp, vp, ci, H)
    assert tdispatch.COUNTS["chain_classify"] == before
    _assert_fields_equal(ref, out)
    with pytest.raises(ValueError, match="CUDA"):
        tchain.chain_classify_cuda(tp, vp, ci, H)


# ------------------------------------------------------------ on the card

@pytest.mark.gpu
@pytest.mark.parametrize("T", [8, 64])
def test_cuda_chain_kernel_matches_plain(T):
    """chain_classify's CUDA kernel against the plain form on the card:
    every configuration, the default H and a colliding H = 4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU form")
    for config in sorted(CONFIGS):
        tp = _torch_params(T, CONFIGS[config])
        vp = variant_params(tp)
        for H in (max(1024, 16 * T), 4):
            for seed in range(4):
                ci = toperands.chain_in_from_numpy(
                    toperands.random_chain_arrays(tp, H, seed), "cuda")
                before = tdispatch.COUNTS["chain_classify"]
                got = tchain.run_chain(tp, vp, ci, H)
                assert tdispatch.COUNTS["chain_classify"] == before + 1
                ref = tchain.chain_classify(tp, vp, ci, H)
                torch.cuda.synchronize()
                _assert_fields_equal(ref, got, f"{config} H={H} {seed}")


@pytest.mark.gpu
@pytest.mark.parametrize("T", [8, 64])
def test_cuda_window_kernel_matches_plain_at_p12(T):
    """window_walk's CUDA kernel against the plain form on the card with
    a pending [P, T] bank, and on a window of the port's own radix
    chain-12 run."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU form")
    from graphite_tpu_torch.engine.core import window_operands
    from graphite_tpu_torch.engine.quantum import next_boundary
    from graphite_tpu_torch.engine.sim import Simulator
    from graphite_tpu_torch.events import synth
    for config in sorted(WINDOW_CONFIGS):
        tp = _torch_params(T, WINDOW_CONFIGS[config])
        vp = variant_params(tp)
        for seed in range(4):
            wi = toperands.window_in_from_numpy(
                toperands.random_window_arrays(tp, tp.block_events, seed),
                "cuda")
            got = twin.run_window(tp, vp, wi, T)
            ref = twin.window_walk(tp, vp, wi, T)
            torch.cuda.synchronize()
            _assert_fields_equal(ref, got, f"{config} {seed}")
    tp = _torch_params(T, {})
    sim = Simulator(tp, synth.gen_radix(num_tiles=T, keys_per_tile=32,
                                        radix=16, seed=3), device="cuda")
    sim.run(max_steps=2)
    st = sim.state._replace(boundary=next_boundary(tp, sim.state))
    _, wi = window_operands(tp, st, sim.trace, sim.vp)
    got = twin.run_window(tp, sim.vp, wi, T)
    ref = twin.window_walk(tp, sim.vp, wi, T)
    torch.cuda.synchronize()
    _assert_fields_equal(ref, got, "radix")
