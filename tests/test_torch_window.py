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
    "round_robin": {"l1_dcache/T1/replacement_policy": "round_robin",
                    "l1_icache/T1/replacement_policy": "round_robin"},
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


# Configurations of the seeded collision operands (operands.
# seeded_window_arrays): the narrow and the wide window, P = 0 and 12.
SEEDED_CONFIGS = {
    **CONFIGS,
    "p12": {"tpu/miss_chain": 12},
    "p12_no_fanout": {"tpu/miss_chain": 12, "tpu/fanout_replay": False},
}


@pytest.mark.parametrize("config", sorted(SEEDED_CONFIGS))
@pytest.mark.parametrize("wide", [False, True])
def test_plain_walk_matches_jax_on_seeded_collision_operands(config, wide):
    jp, tp = _params(8, SEEDED_CONFIGS[config])
    K = 64 if wide else tp.block_events
    for seed in range(2):
        _check_against_jax(jp, tp, toperands.seeded_window_arrays(
            tp, K, seed))


def test_seeded_window_operands_cover_the_cases():
    """Across the seeded collision sets, retired touches hit one
    (set, way) more than once (some below the resident stamp), retired
    branches write one predictor slot more than once, L2 hits fill, the
    cut falls at event 0 and at event K - 1, inactive tiles sit beside
    active ones, a bank fills to P, and windows forward onto pending
    fills and stop on a pending line or on a pending line's L2 set."""
    from graphite_tpu_torch.engine import cache as cachemod
    from graphite_tpu_torch.isa import EventOp
    seen = dict(multi_touch=0, low_stamp_touch=0, multi_branch=0, fill=0,
                cut0=0, cutlast=0, inactive=0, full_bank=0,
                pend_forward=0, pend_line_stop=0, pend_set_stop=0)
    for config in sorted(SEEDED_CONFIGS):
        tp = _torch_params(8, SEEDED_CONFIGS[config])
        vp = variant_params(tp)
        lb = tp.line_size.bit_length() - 1
        for K in (tp.block_events, 64):
            for seed in range(2):
                wi = toperands.window_in_from_numpy(
                    toperands.seeded_window_arrays(tp, K, seed), "cpu")
                out = twin.window_walk(tp, vp, wi, tp.num_tiles)
                op = torch.where(wi.valid_ev, wi.meta[0], int(EventOp.NOP))
                line = wi.addr >> lb
                is_mem = (op == EventOp.MEM_READ) | (op == EventOp.MEM_WRITE)
                is_comp = op == EventOp.COMPUTE
                pD = cachemod.probe(cachemod.CacheArrays(
                    word=wi.l1d_word, rr_ptr=wi.l1d_rr), line,
                    tp.l1d.num_sets)
                pL2 = cachemod.probe(cachemod.CacheArrays(
                    word=wi.l2_word, rr_ptr=wi.l2_rr), line, tp.l2.num_sets)
                d_word = cachemod.row_word(pD.row, pD.way)
                stamp = (int(wi.stamp_base) + torch.arange(K)) \
                    & ((1 << 29) - 1)
                active = wi.tile_active & wi.models_enabled
                seen["inactive"] += int((~active).any() & active.any())
                P = tp.miss_chain
                for t in range(tp.num_tiles):
                    n = int(out.n_ret[t])
                    r = torch.arange(K) < n
                    if bool(active[t]):
                        seen["cut0"] += n == 0
                        seen["cutlast"] += n == K - 1
                    tch = r & (op[t] == EventOp.MEM_READ) & pD.hit[t]
                    keys = list(zip(pD.set_idx[t][tch].tolist(),
                                    pD.way[t][tch].tolist()))
                    seen["multi_touch"] += len(keys) - len(set(keys))
                    seen["low_stamp_touch"] += int(
                        (tch & (stamp < cachemod.word_stamp(d_word[t])))
                        .sum())
                    seen["fill"] += int((r & (is_mem[t] | is_comp[t])
                                         & ~pD.hit[t] & pL2.hit[t]).sum())
                    if tp.core.bp_type != "none":
                        br = r & (op[t] == EventOp.BRANCH)
                        slots = (wi.addr[t][br] % tp.core.bp_size).tolist()
                        seen["multi_branch"] += len(slots) - len(set(slots))
                    if P == 0:
                        continue
                    seen["full_bank"] += int(out.mq_count[t]) == P \
                        and int(wi.mq_count[t]) < P
                    h, c = int(wi.mq_head[t]), int(wi.mq_count[t])
                    plines = (wi.mq_req[h:c, t] >> 8).tolist()
                    use = r & (is_mem[t] | is_comp[t])
                    seen["pend_forward"] += sum(
                        ln in plines for ln in line[t][use].tolist())
                    if n < K and bool(is_mem[t, n] | is_comp[t, n]):
                        ln = int(line[t, n])
                        S2 = tp.l2.num_sets
                        seen["pend_line_stop"] += ln in plines
                        seen["pend_set_stop"] += any(
                            p != ln and p % S2 == ln % S2 for p in plines)
    assert all(v > 0 for v in seen.values()), seen


def _chip_smoke():
    """chip_smoke.py as a module (its top level defines, and runs
    nothing)."""
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _sequential_window_bytes(tp, vp, wi, out):
    """chip_smoke.window_bytes' count, tile by tile and event by event
    over numpy copies of the operands."""
    from graphite_tpu_torch.isa import EventOp
    a = {f: getattr(wi, f).numpy() for f in wi._fields
         if getattr(wi, f) is not None}
    o = {f: getattr(out, f).numpy() for f in out._fields
         if getattr(out, f) is not None}
    T, K = a["addr"].shape
    P = tp.miss_chain
    lb = tp.line_size.bit_length() - 1
    bp = tp.core.bp_type != "none"
    BP = tp.core.bp_size
    magic = tp.net_user.model == "magic"

    def probe(name, t, ln):
        word = a[name]
        A, S = word.shape[0], word.shape[2]
        s = ln % S
        hit, way, state = False, 0, 0
        for w in range(A):
            x = int(word[w, t, s])
            tag = int(np.int64(x) >> 32)
            if tag == int(np.int32(np.int64(ln) & 0xFFFFFFFF)) and x & 7:
                way = way if hit else w
                hit, state = True, state + (x & 7)
        return hit, way, state, s, A

    total = 8 + 1 + 4                                  # scalars
    for t in range(T):
        total += 1 + 8 + 4 + 8 * K                     # active, clock,
        #                                  core period, arg and arg2
        total += 8 + 4 + 12 * 8 + K * (1 + 4 + 8)      # fresh outputs
        total += 0 if magic else 8
        if P > 0:
            total += 4 + 8 + 8 + 4
        if not (a["tile_active"][t] and a["models_enabled"]):
            continue
        total += 12 + (4 if P > 0 else 0)
        n = int(o["n_ret"][t])
        if P > 0:
            nm = int(o["mq_count"][t])
            still = (int(o["clock"][t]) < int(twin._spanned_bound(
                tp, vp, torch.as_tensor(a["boundary"])))) if nm == 0 \
                else (int(o["chain_rel"][t]) < vp.quantum_ps and nm < P)
            total += 24 * (nm - int(a["mq_count"][t]))
        else:
            still = int(o["clock"][t]) < int(a["boundary"])
        last = n if (n < K and still) else n - 1
        rows, words, read_slots, set_slots = set(), set(), set(), set()
        probes = False
        for j in range(last + 1):
            total += 1                                 # valid
            if not a["valid_ev"][t, j]:
                continue
            total += 4                                 # op
            op = int(a["meta"][0, t, j])
            addr = int(a["addr"][t, j])
            ln = addr >> lb
            ret = j < n
            if op in (EventOp.COMPUTE, EventOp.MEM_READ, EventOp.MEM_WRITE,
                      EventOp.STALL, EventOp.SYNC) \
                    or (op == EventOp.BRANCH and bp):
                total += 8                             # addr
            if op == EventOp.BRANCH and bp:
                read_slots.add(addr % BP)
                if ret:
                    set_slots.add(addr % BP)
            if op == EventOp.COMPUTE:
                probes = True
                hit, way, _, s, A = probe("l1i_word", t, ln)
                rows.add(("i", s, A))
                if not hit:
                    h2, w2, _, s2, A2 = probe("l2_word", t, ln)
                    rows.add(("2", s2, A2))
                    if h2 and ret:
                        words.add(("2", s2, w2))
                        total += 8                     # the L1I fill
                        if tp.l1i.replacement == "round_robin":
                            total += 8
                elif ret:
                    words.add(("i", s, way))
            elif op in (EventOp.MEM_READ, EventOp.MEM_WRITE):
                probes = True
                rd = op == EventOp.MEM_READ
                hit, way, st, s, A = probe("l1d_word", t, ln)
                rows.add(("d", s, A))
                ok = hit and (rd or st >= 4)
                if not ok:
                    h2, w2, st2, s2, A2 = probe("l2_word", t, ln)
                    rows.add(("2", s2, A2))
                    if h2 and (rd or st2 == 4) and ret:
                        words.add(("2", s2, w2))
                        total += 8                     # the L1D fill
                        if tp.l1d.replacement == "round_robin" and not hit:
                            total += 8
                elif ret:
                    words.add(("d", s, way))
        total += sum(8 * A for _, _, A in rows) + 8 * len(words)
        total += len(read_slots) + len(set_slots)
        if P > 0 and probes:
            total += 8 * max(int(a["mq_count"][t]) - int(a["mq_head"][t]),
                             0)
    return total


@pytest.mark.parametrize("config", ["default", "round_robin", "p12",
                                    "no_bp_k4"])
def test_window_bytes_matches_a_sequential_count(config):
    """chip_smoke.py's needed-bytes count of the walk (the bound it
    reports) against the same rules counted tile by tile, on random and
    seeded collision operands at T = 8, narrow and wide."""
    cs = _chip_smoke()
    tp = _torch_params(8, SEEDED_CONFIGS[config])
    vp = variant_params(tp)
    for gen in (toperands.random_window_arrays,
                toperands.seeded_window_arrays):
        for K in (tp.block_events, 64):
            for seed in range(3):
                wi = toperands.window_in_from_numpy(gen(tp, K, seed), "cpu")
                out = twin.window_walk(tp, vp, wi, 8)
                assert cs.window_bytes(tp, vp, wi, out) \
                    == _sequential_window_bytes(tp, vp, wi, out), \
                    (gen.__name__, K, seed)


def _clone(wi):
    return type(wi)(*[t.clone() if t is not None else None for t in wi])


def _kernel_against_plain(tp, vp, wi, T, label):
    """The kernel on ``wi`` against the plain form on a clone taken
    first: every leaf equal, and the leaves the kernel writes in place
    are the operands' own tensors."""
    pristine = _clone(wi)
    before = tdispatch.COUNTS["window_walk"]
    got = twin.run_window(tp, vp, wi, T)
    assert tdispatch.COUNTS["window_walk"] == before + 1
    ref = twin.window_walk(tp, vp, pristine, T)
    torch.cuda.synchronize()
    for f in twin.INPLACE_FIELDS:
        if getattr(wi, f) is not None:
            assert getattr(got, f).data_ptr() == getattr(wi, f).data_ptr(), \
                (label, f)
    assert _leaves_equal(got, ref) is None, label


@pytest.mark.gpu
@pytest.mark.parametrize("T", [8, 64])
def test_cuda_kernel_matches_plain_walk(T):
    """The CUDA kernel against the plain form, on the card, at the
    default geometry: random and seeded collision operands, and a window
    captured from the port's own radix run."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU form")
    from graphite_tpu_torch.engine.core import window_operands
    from graphite_tpu_torch.engine.quantum import next_boundary
    from graphite_tpu_torch.engine.sim import Simulator
    from graphite_tpu_torch.events import synth
    for config in sorted(SEEDED_CONFIGS):
        tp = _torch_params(T, SEEDED_CONFIGS[config])
        vp = variant_params(tp)
        for gen in (toperands.random_window_arrays,
                    toperands.seeded_window_arrays):
            for K in (tp.block_events, 64):
                for seed in range(4):
                    wi = toperands.window_in_from_numpy(
                        gen(tp, K, seed), "cuda")
                    _kernel_against_plain(
                        tp, vp, wi, T,
                        f"{config} {gen.__name__} K={K} seed {seed}")
    tp = _torch_params(T, {})
    sim = Simulator(tp, synth.gen_radix(num_tiles=T, keys_per_tile=32,
                                        radix=16, seed=3), device="cuda")
    sim.run(max_steps=2)
    assert tdispatch.COUNTS["window_walk"] > 0
    st = sim.state._replace(boundary=next_boundary(tp, sim.state))
    _, wi = window_operands(tp, st, sim.trace)
    _kernel_against_plain(tp, sim.vp, _clone(wi), T, "radix")


def test_kernel_refuses_operands_that_share_storage():
    """A leaf the kernel writes in place may share storage with no other
    operand; operands it only reads may."""
    tp = _torch_params(8, SEEDED_CONFIGS["p12"])
    wi = toperands.window_in_from_numpy(
        toperands.random_window_arrays(tp, tp.block_events, 0), "cpu")
    twin._check_inputs(tp, wi)
    with pytest.raises(ValueError, match="shares storage"):
        twin._check_inputs(tp, wi._replace(mq_delta=wi.mq_req))
    with pytest.raises(ValueError, match="shares storage"):
        words = torch.cat([wi.l1d_word.reshape(-1), wi.l1d_word.reshape(-1)])
        twin._check_inputs(tp, wi._replace(
            l1d_word=words[:wi.l1d_word.numel()].view_as(wi.l1d_word),
            l1i_word=words[16:16 + wi.l1i_word.numel()]
            .view_as(wi.l1i_word)))
    with pytest.raises(ValueError, match="shares storage"):
        twin._check_inputs(tp, wi._replace(
            l2_word=wi.l2_word.clone(), clock=wi.mq_extra[0]))
    # Operands the kernel only reads may share storage.
    twin._check_inputs(tp, wi._replace(tile_ids=wi.mq_head))
