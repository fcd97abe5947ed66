"""PyTorch port, the window walk: the plain PyTorch ``window_walk`` against
the JAX ``window_walk`` (lax, and the Pallas kernel path in interpret
mode as the JAX package's own tests run it), and the CUDA kernel against
the plain form on the card.

Inputs are (a) random operands from a numpy seed (valid packed cache
words, every event kind the walk classifies) and (b) a ``WindowIn``
captured from a JAX radix8 run after two megasteps, so the caches hold
real lines.  Every ``WindowOut`` leaf must be equal, value and dtype
(tolerance 0: the walk is all-integer).
"""

import functools

import numpy as np
import pytest
import torch

from graphite_tpu_torch import load_config
from graphite_tpu_torch.engine.kernels import dispatch as tdispatch
from graphite_tpu_torch.engine.kernels import operands as toperands
from graphite_tpu_torch.engine.kernels import window as twin
from graphite_tpu_torch.engine.vparams import variant_params
from graphite_tpu_torch.params import SimParams

# The JAX package is imported inside the tests that compare against it,
# so the card's kernel test runs on a machine without jax
# (python -m pytest -m gpu --noconftest tests/test_torch_window.py).


def _jax_modules():
    import jax
    import jax.numpy as jnp
    from graphite_tpu.config import load_config as jax_load_config
    from graphite_tpu.engine import core as jcore
    from graphite_tpu.engine import quantum as jquantum
    from graphite_tpu.engine.kernels import window as jwin
    from graphite_tpu.engine.sim import Simulator as JaxSimulator
    from graphite_tpu.engine.vparams import variant_params as jax_vp
    from graphite_tpu.events import synth as jax_synth
    from graphite_tpu.params import SimParams as JaxSimParams
    return dict(jax=jax, jnp=jnp, jax_load_config=jax_load_config,
                jcore=jcore, jquantum=jquantum, jwin=jwin,
                JaxSimulator=JaxSimulator, jax_vp=jax_vp,
                jax_synth=jax_synth, JaxSimParams=JaxSimParams)


CONFIGS = {
    "default": {},
    "round_robin": {"l1_dcache/replacement_policy": "round_robin",
                    "l1_icache/replacement_policy": "round_robin"},
    "no_bp_k4": {"branch_predictor/type": "none", "tpu/block_events": 4},
}


def _torch_params(T, over):
    ct = load_config()
    ct.set("general/total_cores", T)
    for k, v in over.items():
        ct.set(k, v)
    return SimParams.from_config(ct)


def _params(T, over):
    J = _jax_modules()
    cj = J["jax_load_config"]()
    cj.set("general/total_cores", T)
    for k, v in over.items():
        cj.set(k, v)
    return J["JaxSimParams"].from_config(cj), _torch_params(T, over)


@functools.lru_cache(maxsize=None)
def _jax_walk():
    J = _jax_modules()
    return J["jax"].jit(J["jwin"].window_walk, static_argnums=(0, 3))


def _jax_window_in(arrays):
    """The JAX WindowIn of the same operands (fields absent from this
    configuration — the chain bank at P = 0, iocoom rings — are None)."""
    J = _jax_modules()
    return J["jwin"].WindowIn(**{
        f: (J["jnp"].asarray(arrays[f]) if arrays.get(f) is not None
            else None) for f in J["jwin"].WindowIn._fields})


def _leaves_equal(got, ref):
    """Every WindowOut leaf of two port outputs equal (None alike)."""
    for f in twin.WindowOut._fields:
        a, b = getattr(got, f), getattr(ref, f)
        if a is None or b is None:
            assert a is None and b is None, f
        elif not torch.equal(a, b):
            return f
    return None


def _assert_out_equal(jout, tout):
    for f in twin.WindowOut._fields:
        if getattr(tout, f) is None:
            assert getattr(jout, f) is None, f
            continue
        a = np.asarray(getattr(jout, f))
        b = getattr(tout, f).cpu().numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)


def _check_against_jax(jp, tp, arrays, interpret=False):
    J = _jax_modules()
    jwin, jax_vp = J["jwin"], J["jax_vp"]
    s_ids = tp.num_tiles
    jwi = _jax_window_in(arrays)
    tout = twin.window_walk(tp, variant_params(tp),
                            toperands.window_in_from_numpy(arrays, "cpu"),
                            s_ids)
    _assert_out_equal(_jax_walk()(jp, jax_vp(jp), jwi, s_ids), tout)
    if interpret:
        _assert_out_equal(
            jwin.run_window(jp, jax_vp(jp), jwi, s_ids, "interpret"), tout)
    return tout


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_plain_walk_matches_jax_on_random_operands(config, seed):
    jp, tp = _params(8, CONFIGS[config])
    arrays = toperands.random_window_arrays(tp, tp.block_events, seed)
    _check_against_jax(jp, tp, arrays, interpret=(seed == 0))


def _captured_arrays(all_live: bool):
    """A radix8 window operand set as the first window round of the next
    quantum sees it, after two JAX megasteps.  ``all_live`` also admits
    parked tiles, to walk more windows."""
    J = _jax_modules()
    jnp, jcore = J["jnp"], J["jcore"]
    jp, tp = _params(8, {})
    trace = J["jax_synth"].gen_radix(num_tiles=8, keys_per_tile=64,
                                     radix=16, seed=3)
    sim = J["JaxSimulator"](jp, trace)
    sim.run(max_steps=2)
    st = sim.state
    st = st._replace(boundary=J["jquantum"].next_boundary(jp, st))
    T, K = jp.num_tiles, jp.block_events
    N = sim.trace.num_events
    active = (~st.done) & (st.cursor < N)
    if not all_live:
        active = active & (st.pend_kind == 0) & (st.clock < st.boundary)
    meta, addr = jcore._window_slice_gather(st, sim.trace, K)
    pos = st.cursor[:, None] + jnp.arange(K, dtype=jnp.int32)[None, :]
    arrays = dict(
        meta=meta, addr=addr, valid_ev=(pos < N) & active[:, None],
        tile_active=active, tile_ids=jnp.arange(T, dtype=jnp.int32),
        clock=st.clock, period_ps=st.period_ps, bp_table=st.bp_table,
        l1i_word=st.l1i.word, l1i_rr=st.l1i.rr_ptr,
        l1d_word=st.l1d.word, l1d_rr=st.l1d.rr_ptr,
        l2_word=st.l2.word, l2_rr=st.l2.rr_ptr, boundary=st.boundary,
        models_enabled=st.models_enabled,
        stamp_base=st.round_ctr * jcore.STAMP_STRIDE)
    return jp, tp, {k: np.asarray(v) for k, v in arrays.items()}


@pytest.mark.parametrize("all_live", [False, True])
def test_plain_walk_matches_jax_on_captured_window(all_live):
    jp, tp, arrays = _captured_arrays(all_live)
    assert (arrays["l2_word"] & 7).any(), "caches should hold lines"
    out = _check_against_jax(jp, tp, arrays, interpret=True)
    if all_live:
        assert int(out.n_ret.sum()) > 0


def test_run_window_dispatches_by_device():
    """CPU tensors take the plain form and launch nothing; the kernel
    entry point refuses anything but CUDA tensors."""
    tp = _torch_params(8, {})
    arrays = toperands.random_window_arrays(tp, tp.block_events, 5)
    wi = toperands.window_in_from_numpy(arrays, "cpu")
    before = tdispatch.COUNTS["window_walk"]
    out = twin.run_window(tp, variant_params(tp), wi, 8)
    ref = twin.window_walk(tp, variant_params(tp), wi, 8)
    assert tdispatch.COUNTS["window_walk"] == before
    assert _leaves_equal(out, ref) is None
    with pytest.raises(ValueError, match="CUDA"):
        twin.window_walk_cuda(tp, variant_params(tp), wi, 8)


@pytest.mark.gpu
@pytest.mark.parametrize("T", [8, 64])
def test_cuda_kernel_matches_plain_walk(T):
    """The CUDA kernel against the plain form, on the card, at the
    default geometry: random operands and a window captured from the
    port's own radix run."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU form")
    from graphite_tpu_torch.engine.core import window_operands
    from graphite_tpu_torch.engine.quantum import next_boundary
    from graphite_tpu_torch.engine.sim import Simulator
    from graphite_tpu_torch.events import synth
    for config in sorted(CONFIGS):
        tp = _torch_params(T, CONFIGS[config])
        vp = variant_params(tp)
        for seed in range(4):
            arrays = toperands.random_window_arrays(tp, tp.block_events, seed)
            wi = toperands.window_in_from_numpy(arrays, "cuda")
            before = tdispatch.COUNTS["window_walk"]
            got = twin.run_window(tp, vp, wi, T)
            assert tdispatch.COUNTS["window_walk"] == before + 1
            ref = twin.window_walk(tp, vp, wi, T)
            torch.cuda.synchronize()
            assert _leaves_equal(got, ref) is None, (config, seed)
    tp = _torch_params(T, {})
    sim = Simulator(tp, synth.gen_radix(num_tiles=T, keys_per_tile=32,
                                        radix=16, seed=3), device="cuda")
    sim.run(max_steps=2)
    assert tdispatch.COUNTS["window_walk"] > 0
    st = sim.state._replace(boundary=next_boundary(tp, sim.state))
    _, wi = window_operands(tp, st, sim.trace)
    got = twin.run_window(tp, sim.vp, wi, T)
    ref = twin.window_walk(tp, sim.vp, wi, T)
    torch.cuda.synchronize()
    assert _leaves_equal(got, ref) is None, "radix"
