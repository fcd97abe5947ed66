"""PyTorch port, the kernels of the fast-forward path.

  * The plain ``fast_forward_walk`` against the JAX ``fast_forward_walk``
    (called on its lax path, and once through the Pallas kernel in
    interpret mode) on seeded operands at T = 8, F = 32 and 64: tiles
    that engage and decline, spans cut by the run-ahead bound and by an
    ineligible event, repeated lines, predictor-slot collisions, models
    disabled, tiles that are not candidates, no branch predictor, and
    the quantum-spanned bound of miss_chain 12; and on operand sets
    captured from the port's own radix8 run at span 1000.
  * The plain ``window_walk`` at the wide width K = 64 against the JAX
    walk, at P = 0 and P = 12, on seeded windows and on a wide window
    captured from a fast-forward run.
  * ``gpu``: both CUDA kernels against their plain forms on the card;
    both update their operands in place, so the plain forms run on
    clones taken first.

Every output field must be equal, value and dtype (tolerance 0: the
functions are all-integer).
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from graphite_tpu_torch import load_config
from graphite_tpu_torch.engine import core as tcore
from graphite_tpu_torch.engine.kernels import dispatch as tdispatch
from graphite_tpu_torch.engine.kernels import operands as toperands
from graphite_tpu_torch.engine.kernels import window as twin
from graphite_tpu_torch.engine.vparams import variant_params
from graphite_tpu_torch.params import SimParams

# The JAX package is imported inside the tests that compare against it,
# so the card's kernel tests run on a machine without jax
# (python -m pytest -m gpu --noconftest tests/test_torch_ff_kernel.py).

SPAN = {"tpu/fast_forward_span": 1000}
# fast_forward 2 and 4 give F = 32 and 64 at block_events 16.
FF_CONFIGS = {
    "f32": {"tpu/fast_forward": 2, **SPAN},
    "f64": {"tpu/fast_forward": 4, **SPAN},
    "f64_span0": {"tpu/fast_forward": 4},
    "f64_no_bp": {"tpu/fast_forward": 4, "branch_predictor/type": "none",
                  **SPAN},
    "f64_chain12": {"tpu/fast_forward": 4, "tpu/miss_chain": 12,
                    "tpu/fast_forward_span": 300},
}
WIDE_CONFIGS = {
    "p0": {"tpu/fast_forward": 4},
    "p12": {"tpu/fast_forward": 4, "tpu/miss_chain": 12},
    "p12_nofanout": {"tpu/fast_forward": 4, "tpu/miss_chain": 12,
                     "tpu/fanout_replay": False},
}
RADIX8 = dict(num_tiles=8, keys_per_tile=64, radix=16, seed=3)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain forms are many tiny ops: one intra-op thread per test
    worker is faster than contending for every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax():
    import jax
    import jax.numpy as jnp
    from graphite_tpu.config import load_config as jax_load_config
    from graphite_tpu.engine.kernels import window as jwin
    from graphite_tpu.engine.vparams import variant_params as jax_vp
    from graphite_tpu.params import SimParams as JaxSimParams
    return dict(jax=jax, jnp=jnp, jax_load_config=jax_load_config,
                jwin=jwin, jax_vp=jax_vp, JaxSimParams=JaxSimParams)


def _torch_params(T, over):
    ct = load_config()
    ct.set("general/total_cores", T)
    for k, v in over.items():
        ct.set(k, v)
    return SimParams.from_config(ct)


def _params(T, over):
    J = _jax()
    cj = J["jax_load_config"]()
    cj.set("general/total_cores", T)
    for k, v in over.items():
        cj.set(k, v)
    return J["JaxSimParams"].from_config(cj), _torch_params(T, over)


def _assert_fields_equal(jout, tout, label=""):
    for f in tout._fields:
        a, b = getattr(jout, f), getattr(tout, f)
        assert (a is None) == (b is None), (label, f)
        if b is None:
            continue
        a = np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a)
        b = np.asarray(b.cpu())
        assert a.dtype == b.dtype and a.shape == b.shape, \
            (label, f, a.dtype, b.dtype, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=f"{label} {f}")


def _np_arrays(nt):
    return {f: (None if v is None else v.cpu().numpy())
            for f, v in zip(nt._fields, nt)}


# --------------------------------------------------- fast_forward_walk

@functools.lru_cache(maxsize=None)
def _jax_ff():
    J = _jax()
    return J["jax"].jit(J["jwin"].fast_forward_walk, static_argnums=(0,))


def _ff_both(jp, tp, arrays, interpret=False):
    """The JAX walk (lax, and optionally the interpreted Pallas kernel)
    and the port's plain form on the same operands; returns the port's
    output."""
    J = _jax()
    jfi = J["jwin"].FFIn(**{f: J["jnp"].asarray(arrays[f])
                            for f in J["jwin"].FFIn._fields})
    tout = twin.fast_forward_walk(tp, variant_params(tp),
                                  toperands.ff_in_from_numpy(arrays, "cpu"))
    _assert_fields_equal(_jax_ff()(jp, J["jax_vp"](jp), jfi), tout, "lax")
    if interpret:
        _assert_fields_equal(
            J["jwin"].run_fast_forward(jp, J["jax_vp"](jp), jfi,
                                       "interpret"), tout, "interpret")
    return tout


def test_ff_interface_matches_jax():
    J = _jax()
    assert twin.FFIn._fields == J["jwin"].FFIn._fields
    assert twin.FFOut._fields == J["jwin"].FFOut._fields
    assert twin.FF_IN_AXES == J["jwin"].FF_IN_AXES
    assert twin.FF_OUT_AXES == J["jwin"].FF_OUT_AXES
    assert twin.WINDOW_CTRS == J["jwin"].WINDOW_CTRS


def test_ff_width_matches_jax():
    from graphite_tpu.engine import core as jcore
    for over in ({}, {"tpu/fast_forward": 1}, {"tpu/fast_forward": 2},
                 {"tpu/fast_forward": 8},
                 {"tpu/fast_forward": 8, "tpu/block_events": 8},
                 {"tpu/fast_forward": 8, "tpu/block_events": 40}):
        jp, tp = _params(8, over)
        assert tcore._ff_width(tp) == jcore._ff_width(jp), over


@pytest.mark.parametrize("config", sorted(FF_CONFIGS))
@pytest.mark.parametrize("seed", range(8))
def test_plain_ff_walk_matches_jax_on_seeded_operands(config, seed):
    jp, tp = _params(8, FF_CONFIGS[config])
    arrays = toperands.random_ff_arrays(tp, tcore._ff_width(tp), seed)
    _ff_both(jp, tp, arrays, interpret=(config == "f64" and seed == 0))


def test_seeded_ff_operands_cover_the_cases():
    """Across the seeds of the parity test, tiles engage and decline, the
    run-ahead bound and an ineligible event each cut a span, a declined
    tile commits more than K events without crossing the window bound,
    predictor slots collide inside committed spans, and repeated lines
    touch one word more than once."""
    seen = dict(engage=0, decline=0, bound_cut=0, event_cut=0,
                long_decline=0, slot_collision=0, repeat_touch=0)
    for config in ("f32", "f64"):
        tp = _torch_params(8, FF_CONFIGS[config])
        vp = variant_params(tp)
        for seed in range(8):
            fi = toperands.ff_in_from_numpy(toperands.random_ff_arrays(
                tp, tcore._ff_width(tp), seed), "cpu")
            fp = twin.ff_price(tp, vp, fi)
            n_lead = fp.lead.sum(1)
            n_commit = fp.commit0.sum(1)
            cand = fi.tile_active & fi.models_enabled
            seen["engage"] += int(fp.engage.sum())
            seen["decline"] += int((cand & ~fp.engage).sum())
            seen["bound_cut"] += int((n_commit < n_lead).sum())
            seen["event_cut"] += int(
                (cand & (n_lead < fi.addr.shape[1])).sum())
            seen["long_decline"] += int(
                (~fp.engage & (n_commit > tp.block_events)).sum())
            for t in torch.nonzero(fp.engage).flatten().tolist():
                c = fp.commit0[t]
                slots = fp.bidx[t][c & fp.is_br[t]].tolist()
                seen["slot_collision"] += len(slots) - len(set(slots))
                lines = fp.line[t][c & (fp.is_rd[t] | fp.is_wr[t])].tolist()
                seen["repeat_touch"] += len(lines) - len(set(lines))
    assert all(v > 0 for v in seen.values()), seen


@functools.lru_cache(maxsize=None)
def _captured_ff_ins():
    """The operands of the port's own radix8 analytic rounds at
    fast_forward 4, span 1000 (plain form, on the CPU), as numpy."""
    from graphite_tpu_torch.engine.sim import Simulator
    from graphite_tpu_torch.events import synth
    tp = _torch_params(8, FF_CONFIGS["f64"])
    seen = []
    orig = tcore.kwindow.run_fast_forward

    def rec(params, vp, fi):
        seen.append(_np_arrays(fi))
        return orig(params, vp, fi)

    tcore.kwindow.run_fast_forward = rec
    try:
        Simulator(tp, synth.gen_radix(**RADIX8), device="cpu").run(
            max_steps=256)
    finally:
        tcore.kwindow.run_fast_forward = orig
    return seen


def test_plain_ff_walk_matches_jax_on_captured_operands():
    jp, tp = _params(8, FF_CONFIGS["f64"])
    seen = _captured_ff_ins()
    assert len(seen) > 0
    vp = variant_params(tp)
    engaging = [a for a in seen if bool(twin.ff_price(
        tp, vp, toperands.ff_in_from_numpy(a, "cpu")).engage.any())]
    assert engaging, "no captured analytic round engages"
    for arrays in (seen[0], engaging[0], engaging[-1]):
        _ff_both(jp, tp, arrays)


def test_run_fast_forward_dispatches_by_device():
    """CPU tensors take the plain form and launch nothing; the kernel
    entry point refuses anything but CUDA tensors."""
    tp = _torch_params(8, FF_CONFIGS["f64"])
    vp = variant_params(tp)
    fi = toperands.ff_in_from_numpy(toperands.random_ff_arrays(tp, 64, 1),
                                    "cpu")
    before = tdispatch.COUNTS["fast_forward_walk"]
    out = twin.run_fast_forward(tp, vp, fi)
    ref = twin.fast_forward_walk(tp, vp, fi)
    assert tdispatch.COUNTS["fast_forward_walk"] == before
    _assert_fields_equal(ref, out)
    with pytest.raises(ValueError, match="CUDA"):
        twin.fast_forward_walk_cuda(tp, vp, fi)


def test_ff_walk_refuses_sticky_mesi():
    tp = _torch_params(8, FF_CONFIGS["f64"])
    fi = toperands.ff_in_from_numpy(toperands.random_ff_arrays(tp, 64, 1),
                                    "cpu")
    mesi = dataclasses.replace(tp, protocol="pr_l1_sh_l2_mesi")
    with pytest.raises(NotImplementedError, match="sh_l2_mesi"):
        twin.fast_forward_walk(mesi, variant_params(tp), fi)


# ------------------------------------------------ window_walk at K = 64

@functools.lru_cache(maxsize=None)
def _jax_walk():
    J = _jax()
    return J["jax"].jit(J["jwin"].window_walk, static_argnums=(0, 3))


def _walk_both(jp, tp, arrays):
    J = _jax()
    jwi = J["jwin"].WindowIn(**{
        f: (J["jnp"].asarray(arrays[f]) if arrays.get(f) is not None
            else None) for f in J["jwin"].WindowIn._fields})
    s_ids = tp.num_tiles
    tout = twin.window_walk(tp, variant_params(tp),
                            toperands.window_in_from_numpy(arrays, "cpu"),
                            s_ids)
    _assert_fields_equal(_jax_walk()(jp, J["jax_vp"](jp), jwi, s_ids), tout)
    return tout


@pytest.mark.parametrize("config", sorted(WIDE_CONFIGS))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_walk_matches_jax_at_k64(config, seed):
    jp, tp = _params(8, WIDE_CONFIGS[config])
    K = tcore._ff_width(tp)
    assert K == 64
    _walk_both(jp, tp, toperands.random_window_arrays(tp, K, seed))


def test_plain_walk_matches_jax_on_captured_wide_window():
    """A wide window as the port's radix8 fast-forward run hands it to
    the walk, two megasteps in."""
    from graphite_tpu_torch.engine.quantum import next_boundary
    from graphite_tpu_torch.engine.sim import Simulator
    from graphite_tpu_torch.events import synth
    jp, tp = _params(8, FF_CONFIGS["f64"])
    sim = Simulator(tp, synth.gen_radix(**RADIX8), device="cpu")
    sim.run(max_steps=2)
    st = sim.state._replace(boundary=next_boundary(tp, sim.state))
    _, wi = tcore.window_operands(tp, st, sim.trace, sim.vp,
                                  tcore._ff_width(tp))
    assert wi.addr.shape[1] == 64
    out = _walk_both(jp, tp, _np_arrays(wi))
    assert int(out.n_ret.sum()) > 0


# --------------------------------------------------------- on the card

def _clone(nt):
    return type(nt)(*[t.clone() if t is not None else None for t in nt])


def _ff_kernel_against_plain(tp, vp, fi, label):
    """fast_forward_walk's kernel on ``fi`` (which it updates in place)
    against the plain form on a clone taken first; the written leaves
    are the operands' own tensors."""
    pristine = _clone(fi)
    before = tdispatch.COUNTS["fast_forward_walk"]
    got = twin.run_fast_forward(tp, vp, fi)
    assert tdispatch.COUNTS["fast_forward_walk"] == before + 1
    ref = twin.fast_forward_walk(tp, vp, pristine)
    torch.cuda.synchronize()
    for f in twin.FF_INPLACE_FIELDS:
        assert getattr(got, f).data_ptr() == getattr(fi, f).data_ptr(), \
            (label, f)
    _assert_fields_equal(ref, got, label)
    return ref


@pytest.mark.gpu
@pytest.mark.parametrize("T", [8, 64])
def test_cuda_ff_kernel_matches_plain(T):
    """fast_forward_walk's CUDA kernel against the plain form on the
    card: every seeded configuration, and the analytic rounds of the
    port's own radix run on the card.  The kernel updates its operands
    in place, so the plain form runs on a clone taken first."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU form")
    from graphite_tpu_torch.engine.sim import Simulator
    from graphite_tpu_torch.events import synth
    engaged = 0
    for config in sorted(FF_CONFIGS):
        tp = _torch_params(T, FF_CONFIGS[config])
        vp = variant_params(tp)
        for seed in range(8):
            fi = toperands.ff_in_from_numpy(toperands.random_ff_arrays(
                tp, tcore._ff_width(tp), seed), "cuda")
            ref = _ff_kernel_against_plain(tp, vp, fi, f"{config} {seed}")
            engaged += int((ref.n_ret > 0).sum())
    assert engaged > 0
    tp = _torch_params(T, FF_CONFIGS["f64"])
    seen = []
    orig = tcore.kwindow.run_fast_forward

    def rec(params, vp, fi):
        seen.append(_clone(fi))
        return orig(params, vp, fi)

    tcore.kwindow.run_fast_forward = rec
    try:
        Simulator(tp, synth.gen_radix(num_tiles=T, keys_per_tile=64,
                                      radix=16, seed=3),
                  device="cuda").run(max_steps=4)
    finally:
        tcore.kwindow.run_fast_forward = orig
    assert seen
    for i, fi in enumerate(seen[:16]):
        _ff_kernel_against_plain(tp, variant_params(tp), fi, f"captured {i}")


@pytest.mark.gpu
@pytest.mark.parametrize("T", [8, 64])
def test_cuda_window_kernel_matches_plain_at_k64(T):
    """window_walk's CUDA kernel against the plain form at the wide
    width, P = 0 and P = 12, on random and seeded collision operands; the
    kernel updates the operands in place, so the plain form runs on a
    clone taken first."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU form")
    for config in sorted(WIDE_CONFIGS):
        tp = _torch_params(T, WIDE_CONFIGS[config])
        vp = variant_params(tp)
        for gen in (toperands.random_window_arrays,
                    toperands.seeded_window_arrays):
            for seed in range(4):
                wi = toperands.window_in_from_numpy(gen(tp, 64, seed),
                                                    "cuda")
                pristine = type(wi)(*[t.clone() if t is not None else None
                                      for t in wi])
                got = twin.run_window(tp, vp, wi, T)
                ref = twin.window_walk(tp, vp, pristine, T)
                torch.cuda.synchronize()
                for f in twin.INPLACE_FIELDS:
                    if getattr(wi, f) is not None:
                        assert getattr(got, f).data_ptr() \
                            == getattr(wi, f).data_ptr(), (config, seed, f)
                _assert_fields_equal(ref, got,
                                     f"{config} {gen.__name__} {seed}")
