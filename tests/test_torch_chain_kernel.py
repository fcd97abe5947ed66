"""PyTorch port, the two kernels of the chain replay at P > 0.

  * The plain ``chain_classify`` against the JAX ``chain_classify`` (run
    inline: on the CPU ``tpu/pallas_kernels`` resolves to lax) on seeded
    random operands — fan-out replay on and off, DRAM queue model on and
    off, and a hash table of size H = 4 that forces collisions at the
    combining tables — and on the operands of the first replay
    iterations of a JAX radix8 chain-12 run.
  * One replay iteration from the state's own arrays: the plain
    ``run_chain_step`` (head gathers, directory-row gathers, classify)
    against the JAX ``chain_classify`` on the ``ChainIn`` that numpy
    indexing builds from the same arrays, as the JAX ``chain_fast_pass``
    builds it; the state-level operands cover every case of the step;
    the fused kernel's exact division and its carved output buffer.
  * The plain ``window_walk`` at P = 12 against the JAX walk, on fuzzed
    windows with a non-empty [P, T] bank and on windows captured from a
    JAX radix8 chain-12 run.
  * ``gpu``: both CUDA kernels against their plain forms on the card.

Every output field must be equal, value and dtype (tolerance 0: the
functions are all-integer; uint64 sharer words compare as int64 bits):
one classify case against the JAX function run live, the others against
its outputs as recorded for the same inputs
(tests/torch_jax_ref.check_outputs).
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

import torch_jax_ref as ref

MODULE = "test_torch_chain_kernel"

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
    return ref.eager(J["jchain"].chain_classify)


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


def _classify_checked(jp, tp, arrays, H, live=False):
    """The plain chain_classify on ``arrays``, every output field held to
    the JAX function's (run where ``live``, else its pin:
    tests/torch_jax_ref.check_outputs)."""
    tout = tchain.chain_classify(tp, variant_params(tp),
                                 toperands.chain_in_from_numpy(arrays, "cpu"),
                                 H)

    def jax_out():
        J = _jax()
        return ref.fields_of(tout, _jax_classify()(
            jp, J["jax_vp"](jp), _jax_chain_in(arrays), H))

    ref.check_outputs(MODULE, tout, jax_out, {"params": repr(tp), "H": H},
                      arrays, live)
    return tout


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
    tout = _classify_checked(jp, tp, arrays, H,
                             live=(config, seed) == ("fanout_queue", 0))
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
        tout = _classify_checked(jp, tp, arrays, 4)
        collided += _rep_collisions(tp, arrays, tout)
    assert collided > 0, "no representative collision was exercised"


def _capture(tp, trace_kw, steps, want, pick):
    """Run the port's radix8 chain-12 simulation on the CPU with ``pick``
    (the kernel entry point to record: 'chain', the classify step's
    ChainIn, or 'window', the walk's WindowIn) wrapped so each call's
    operands are kept as numpy arrays; returns the first ``want``
    records.  (tests/test_torch_chain_sim.py holds this run to the JAX
    package's leaf for leaf, so these are the JAX run's operands too.)"""
    from graphite_tpu_torch.engine import core as tcore
    from graphite_tpu_torch.engine import quantum as tquantum
    from graphite_tpu_torch.engine.sim import Simulator
    from graphite_tpu_torch.events import synth as tsynth
    mod, name = (tchain, "chain_classify") if pick == "chain" \
        else (tcore.kwindow, "run_window")
    orig = getattr(mod, name)
    seen = []

    def record(params, vp, operands, *rest):
        seen.append(type(operands)(*[
            None if v is None else v.numpy().copy() for v in operands]))
        return orig(params, vp, operands, *rest)

    sim = Simulator(tp, tsynth.gen_radix(**trace_kw), device="cpu")
    state = sim.state
    setattr(mod, name, record)
    try:
        for _ in range(steps):
            state = tquantum.megarun(tp, state, sim.trace, 1)
            if len(seen) >= want:
                break
    finally:
        setattr(mod, name, orig)
    return seen[:want]


RADIX8 = dict(num_tiles=8, keys_per_tile=64, radix=16, seed=3)


@pytest.fixture(scope="module")
def captured_chain_ins():
    jp, tp = _params(8, {})
    return jp, tp, _capture(tp, RADIX8, 40, 36, "chain")


def test_plain_classify_matches_jax_on_captured_operands(captured_chain_ins):
    jp, tp, recs = captured_chain_ins
    H = max(1024, 16 * tp.num_tiles)
    assert len(recs) == 36
    served = 0
    for i, ci in enumerate(recs):
        arrays = {f: getattr(ci, f) for f in ci._fields}
        tout = _classify_checked(jp, tp, arrays, H)
        served += int(tout.serve_all.sum())
    assert served > 0


# ------------------------------------------------- window walk at P > 0

@functools.lru_cache(maxsize=None)
def _jax_walk():
    J = _jax()
    return ref.eager(J["jwin"].window_walk)


def _jax_window_in(arrays):
    J = _jax()
    jnp = J["jnp"]
    return J["jwin"].WindowIn(**{
        f: (jnp.asarray(arrays[f]) if arrays.get(f) is not None else None)
        for f in J["jwin"].WindowIn._fields})


def _walk_checked(jp, tp, arrays):
    """The plain window_walk on ``arrays``, every output field held to the
    JAX walk's (its pin: tests/torch_jax_ref.check_outputs)."""
    s_ids = tp.num_tiles
    tout = twin.window_walk(tp, variant_params(tp),
                            toperands.window_in_from_numpy(arrays, "cpu"),
                            s_ids)

    def jax_out():
        J = _jax()
        return ref.fields_of(tout, _jax_walk()(
            jp, J["jax_vp"](jp), _jax_window_in(arrays), s_ids))

    ref.check_outputs(MODULE, tout, jax_out, {"params": repr(tp)}, arrays)
    return tout


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
    _walk_checked(jp, tp, arrays)


@pytest.fixture(scope="module")
def captured_windows():
    jp, tp = _params(8, {})
    return jp, tp, _capture(tp, RADIX8, 40, 60, "window")


def test_plain_walk_matches_jax_on_captured_banking_windows(
        captured_windows):
    jp, tp, recs = captured_windows
    banked = pending = 0
    for i, wi in enumerate(recs):
        arrays = {f: getattr(wi, f) for f in wi._fields}
        tout = _walk_checked(jp, tp, arrays)
        banked += int((tout.mq_count.numpy() - arrays["mq_count"]).sum())
        pending += int((arrays["mq_count"] > arrays["mq_head"]).sum())
    assert banked > 0 and pending > 0


def test_run_chain_dispatches_by_device():
    """CPU tensors take the plain step and launch nothing; the kernel
    entry point refuses anything but CUDA tensors."""
    tp = _torch_params(8, {})
    vp = variant_params(tp)
    H = max(1024, 16 * tp.num_tiles)
    si = toperands.chain_step_in_from_numpy(
        toperands.random_chain_step_arrays(tp, H, 5), "cpu")
    before = tdispatch.COUNTS["chain_classify"]
    head, out = tchain.run_chain_step(tp, vp, si, H)
    ref_head, ref = tchain.chain_step(tp, vp, si, H)
    assert tdispatch.COUNTS["chain_classify"] == before
    _assert_fields_equal(ref_head, head)
    _assert_fields_equal(ref, out)
    with pytest.raises(ValueError, match="CUDA"):
        tchain.chain_step_cuda(tp, vp, si, H)


# ------------------------------- one replay iteration from the state

def _jax_step_in(jp, arrays, H):
    """The JAX ChainIn's operands that numpy indexing builds from the
    state-level arrays, exactly as the JAX ``chain_fast_pass`` builds
    them (graphite_tpu/engine/resolve.py:264-285)."""
    J = _jax()
    jnp = J["jnp"]
    from graphite_tpu.engine import dense as jdense
    from graphite_tpu.engine import resolve as jresolve
    from graphite_tpu.engine.state import PEND_EX_REQ, PEND_IFETCH
    P, T = jp.miss_chain, jp.num_tiles
    A = jp.directory.associativity
    W = arrays["dir_sharers"].shape[0] // A
    head = arrays["head"]
    hsel = np.clip(head, 0, max(P - 1, 0))[None, :]
    req = np.take_along_axis(arrays["mq_req"], hsel, axis=0)[0]
    delta = np.take_along_axis(arrays["mq_delta"], hsel, axis=0)[0]
    extra = np.take_along_axis(arrays["mq_extra"], hsel, axis=0)[0]
    active = (~arrays["stopped"]) & (head < arrays["stop_hi"])
    kind = (req & 7).astype(np.int32)
    line = np.where(active, req >> 8, 0)
    home = np.asarray(jresolve.home_of_line(jp, jnp.asarray(line)))
    dset = np.asarray(jresolve.dir_set_of_line(jp, jnp.asarray(line)))
    fidx = (home * jp.directory.num_sets + dset).astype(np.int32)
    hidx = np.asarray((jdense.fmix64(jnp.asarray(line)) % jnp.uint64(H))
                      .astype(jnp.int32))
    drow = arrays["dir_word"][:, fidx].T
    dsharers = arrays["dir_sharers"].view(np.uint64)[:, fidx].reshape(
        W, A, T).transpose(2, 1, 0)
    return dict(
        active=active, is_ex=active & (kind == PEND_EX_REQ),
        is_if=active & (kind == PEND_IFETCH), line=line,
        issue=arrays["base"] + delta, extra=extra, home=home, dset=dset,
        fidx=fidx, hidx=hidx, drow=drow, dsharers=dsharers,
        **{f: arrays[f] for f in ("p_net", "p_dir", "p_l2", "p_l1d",
                                  "p_l1i", "p_core", "ftbl")})


STEP_CONFIGS = ("fanout_queue", "fanout_noqueue", "nofanout_queue")


def _step_checked(jp, tp, arrays, H):
    """The plain run_chain_step from the state-level ``arrays``, every
    ChainHead field held to the head the JAX pass gathers and every
    ChainOut field to the JAX chain_classify's on its ChainIn (their
    pin: tests/torch_jax_ref.check_outputs)."""
    head, out = tchain.run_chain_step(
        tp, variant_params(tp), toperands.chain_step_in_from_numpy(
            arrays, "cpu"), H)

    def jax_out():
        J = _jax()
        jin = _jax_step_in(jp, arrays, H)
        jout = _jax_classify()(jp, J["jax_vp"](jp), _jax_chain_in(jin), H)
        return dict(head={f: jin[f] for f in tchain.ChainHead._fields},
                    out=ref.fields_of(out, jout))

    ref.check_outputs(MODULE, dict(head=head, out=out), jax_out,
                      {"params": repr(tp), "H": H}, arrays)


@pytest.mark.parametrize("config", STEP_CONFIGS)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_chain_step_matches_jax(config, seed):
    """The plain run_chain_step from the state-level arrays against the
    JAX chain_classify on the ChainIn the JAX pass gathers from them:
    every ChainHead field against the gathered head, every ChainOut
    field against the JAX function's."""
    jp, tp = _params(8, CONFIGS[config])
    H = max(1024, 16 * tp.num_tiles)
    _step_checked(jp, tp, toperands.random_chain_step_arrays(tp, H, seed), H)


def _step_cases(tp, si, H, seen):
    """Add to ``seen`` how often each case of the step occurs in the
    plain step on ``si``: a directory hit, an allocation, a victim way a
    hit excludes, an election loser, an in-pass fan-out (and one whose
    invalidation targets lie both below and above tile 512, so its
    sharer set crosses word 8), an owner leg, a combining member and a
    hard stop."""
    from graphite_tpu_torch.engine import dense as tdense
    from graphite_tpu_torch.engine.ops import umod64
    from graphite_tpu_torch.engine.state import dword_stamp, dword_state
    A = tp.directory.associativity
    h, co = tchain.chain_step(tp, variant_params(tp), si, H)
    act = h.active
    # Members take their representative's way, which is their own (same
    # line, same row), so co.way is every row's way.
    way = co.way.to(torch.int64)
    drow, _ = tchain.chain_rows(si.dir_word, si.dir_sharers, h.fidx)
    fh = umod64(tdense.fmix64(h.fidx.to(torch.int64)), H)
    used = torch.zeros((H, A), dtype=torch.bool)
    used[fh[co.hit], way[co.hit]] = True
    lru = torch.argmin(torch.where(dword_state(drow) == 0, -1,
                                   dword_stamp(drow)), dim=1)
    am = (h.home.to(torch.int64) * tp.directory.num_sets + h.dset) * A + way
    wslot = tdense.elect(act, tdense.fcfs_keys(act, h.issue),
                         umod64(tdense.fmix64(am), H), H)
    seen["hit"] += int(co.hit.sum())
    seen["alloc"] += int((co.serve & ~co.hit).sum())
    seen["excluded_victim"] += int((act & ~co.hit & used[fh, lru]).sum())
    seen["election_loser"] += int((act & ~wslot).sum())
    seen["fan_out"] += int(co.fan_go.sum())
    if co.inv_bool is not None and "fan_out_past_word_8" in seen:
        ib = co.inv_bool
        seen["fan_out_past_word_8"] += int(
            (ib[:, :512].any(dim=1) & ib[:, 512:].any(dim=1)).sum())
    seen["owner_leg"] += int(co.owner_leg.sum())
    seen["member"] += int(co.member.sum())
    seen["hard_stop"] += int(co.hard_stop.sum())


def test_chain_step_operands_cover_the_cases():
    """Across the state-level sets of the parity test (T = 8, every
    configuration), each case of the step occurs: a directory hit, an
    allocation, a victim way a hit excludes, an election loser, an
    in-pass fan-out, an owner leg, a combining member and a hard stop."""
    seen = dict(hit=0, alloc=0, excluded_victim=0, election_loser=0,
                fan_out=0, owner_leg=0, member=0, hard_stop=0)
    for config in sorted(CONFIGS):
        tp = _torch_params(8, CONFIGS[config])
        H = max(1024, 16 * tp.num_tiles)
        for seed in range(3):
            _step_cases(tp, toperands.chain_step_in_from_numpy(
                toperands.random_chain_step_arrays(tp, H, seed), "cpu"), H,
                seen)
    assert all(v > 0 for v in seen.values()), seen


# T = 1024 (W = 16 sharer words, 16 ways, H = 16,384: the wide form on
# the card), on a directory of 16 sets per home so that the operands stay
# small (the default one is 2 GB of sharer words at this T).
WIDE = {"dram_directory/total_entries": 256}
WIDE_CONFIGS = ("fanout_queue", "fanout_noqueue", "nofanout_queue")


@pytest.mark.parametrize("config", ["fanout_queue", "fanout_noqueue"])
def test_plain_chain_step_matches_jax_at_1024(config):
    """The plain step against the JAX chain_classify at T = 1024, where
    the way-slot election runs its scatter-min table (T * H above the
    dense cap): every ChainHead and ChainOut field."""
    jp, tp = _params(1024, {**CONFIGS[config], **WIDE})
    H = max(1024, 16 * tp.num_tiles)
    assert tp.num_tiles * H > 1 << 22
    _step_checked(jp, tp, toperands.random_chain_step_arrays(tp, H, 0), H)


def test_chain_step_operands_cover_the_cases_at_1024():
    """The state-level sets at T = 1024 that the wide form is held to on
    the card plant every case of the step, a fan-out whose invalidation
    set crosses sharer word 8 among them."""
    seen = dict(hit=0, alloc=0, excluded_victim=0, election_loser=0,
                fan_out=0, fan_out_past_word_8=0, owner_leg=0, member=0,
                hard_stop=0)
    for config in WIDE_CONFIGS:
        tp = _torch_params(1024, {**CONFIGS[config], **WIDE})
        H = max(1024, 16 * tp.num_tiles)
        for seed in range(2):
            _step_cases(tp, toperands.chain_step_in_from_numpy(
                toperands.random_chain_step_arrays(tp, H, seed), "cpu"), H,
                seen)
    assert all(v > 0 for v in seen.values()), seen


def test_step_form_by_size():
    """The shared form while T <= 512 and its arrays fit one block's
    shared memory (T = 512 at 16 ways: 224,360 B), the wide form above
    (T = 512 at 32 ways would need 289,896 B; T = 1024 at 16 ways
    514,152 B), with the H-sized tables and the invalidation words in
    its workspace."""
    assert tchain.step_form(64, 16, 1, 1024, 8) == (False, 24552, 0)
    assert tchain.step_form(512, 16, 8, 8192, 8) == (False, 224360, 0)
    assert tchain.step_layout_bytes(512, 32, 8, 8192, 8, False)[0] \
        == 289896
    assert tchain.step_form(512, 32, 8, 8192, 8) == (True, 19560, 139264)
    assert tchain.step_layout_bytes(1024, 16, 16, 16384, 8, False)[0] \
        == 514152
    wide, smem, ws = tchain.step_form(1024, 16, 16, 16384, 8)
    assert wide and smem <= tchain.MAX_SMEM_BYTES
    assert ws == 16384 * (8 + 4 + 1) + 1024 * 16 * 8


@pytest.mark.parametrize("over,old_limit", [
    ({"dram_directory/associativity": 64}, "32 directory ways"),
    ({"general/total_cores": 2048}, "1024"),
])
def test_chain_limits_refused_at_construction_on_cuda(over, old_limit,
                                                      monkeypatch):
    """What the one-block forms cannot take (more than 32 directory ways,
    more than 1,024 tiles: ``old_limit``, the limit refused until the
    grid form) is admitted on CUDA at construction and takes the grid
    form; the one limit left, the grid form's co-residency, is refused at
    construction with the card's number (here a card that holds 4 blocks
    of 256 threads), before any round; the CPU runs everything."""
    from graphite_tpu_torch.engine.sim import check_slice
    tp = _torch_params(64, over)
    assert tp.miss_chain == 12
    T, A = tp.num_tiles, tp.directory.associativity
    W = (T + 63) // 64
    assert tchain.step_form(T, A, W, max(1024, 16 * T),
                            min(tp.max_inv_fanout_per_round, T))[0] \
        == tchain.GRID
    check_slice(tp, device=torch.device("cuda"))
    check_slice(tp, device=torch.device("cpu"))
    monkeypatch.setattr(tchain, "grid_capacity", lambda device=None: (4, 256))
    if T > 4 * 256:
        with pytest.raises(NotImplementedError,
                           match=f"needs {T // 256} blocks .* holds 4 "):
            check_slice(tp, device=torch.device("cuda"))
    else:
        check_slice(tp, device=torch.device("cuda"))
    check_slice(tp, device=torch.device("cpu"))
    tp0 = _torch_params(64, {**over, "tpu/miss_chain": 0})
    check_slice(tp0, device=torch.device("cuda"))


def test_fast_divisor_is_exact():
    """The fused kernel's division without a divide instruction (the
    magic number and shift of chain.fast_divisor, the kernel's formula
    here in Python integers) equals uint64 floor division for every
    divisor kind (1, powers of two, others) at the edges of the range."""
    rng = np.random.default_rng(0)
    xs = [0, 1, 2, 2**32 - 1, 2**32, 2**63 - 1, 2**63, 2**64 - 1] \
        + [int(x) for x in rng.integers(0, 2**64, size=1500,
                                        dtype=np.uint64)]
    for d in list(range(1, 130)) + [1000, 1024, 4096, 8192, 12289,
                                    2**31 - 1, 2**32 + 15]:
        dd, magic, shift = tchain.fast_divisor(d)
        assert dd == d and 0 <= magic < 2**64
        for x in xs + [d - 1, d, d + 1, (2**64 - 1) // d * d]:
            if dd == 1:
                q = x
            else:
                hi = (magic * x) >> 64
                q = (((x - hi) >> 1) + hi) >> shift
            assert q == x // d, (d, x)


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("T", [8, 64])
def test_step_layout_carves_disjoint_leaves(config, T):
    """The fused kernel's one output buffer: every ChainHead and ChainOut
    leaf is a view of it with the plain step's dtype and shape, the
    leaves' byte ranges are disjoint and inside the buffer, the kernel's
    offsets are theirs, and ChainOut.ftbl is the caller's table."""
    tp = _torch_params(T, CONFIGS[config])
    vp = variant_params(tp)
    H = max(1024, 16 * T)
    si = toperands.chain_step_in_from_numpy(
        toperands.random_chain_step_arrays(tp, H, 0), "cpu")
    ref_head, ref = tchain.chain_step(tp, vp, si, H)
    layout = tchain.StepLayout(tp, (T + 63) // 64)
    buf = torch.empty(layout.nbytes, dtype=torch.uint8)
    head, out = layout.carve(buf, si.ftbl)
    base = buf.data_ptr()
    spans = []
    for got_nt, ref_nt in ((head, ref_head), (out, ref)):
        for f in ref_nt._fields:
            g, r = getattr(got_nt, f), getattr(ref_nt, f)
            assert (g is None) == (r is None), f
            if g is None:
                assert f == "ftbl" or layout.offsets[f] == -1, f
                continue
            assert g.dtype == r.dtype and g.shape == r.shape, f
            if f == "ftbl":
                assert g is si.ftbl
                continue
            start = g.data_ptr() - base
            assert start == layout.offsets[f], f
            spans.append((start, start + g.numel() * g.element_size(), f))
    spans.sort()
    assert spans[0][0] >= 0 and spans[-1][1] <= layout.nbytes
    for (_, end, f), (start, _, g) in zip(spans, spans[1:]):
        assert end <= start, (f, g)
    assert {f for _, _, f in spans} == {
        n for n, o in layout.offsets.items() if o >= 0}


# ------------------------------------------------------------ on the card

@pytest.mark.gpu
@pytest.mark.parametrize("T", [8, 64])
def test_cuda_chain_kernel_matches_plain(T):
    """The fused chain_classify kernel against the plain step on the
    card, on the state-level operands: every configuration, the default
    H, a non-power-of-two H and a colliding H = 4.  The kernel writes the
    floor table in place, so it runs on a clone of the table."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU form")
    for config in sorted(CONFIGS):
        tp = _torch_params(T, CONFIGS[config])
        vp = variant_params(tp)
        for H in (max(1024, 16 * T), 1000, 4):
            for seed in range(4):
                si = toperands.chain_step_in_from_numpy(
                    toperands.random_chain_step_arrays(tp, H, seed), "cuda")
                work = si._replace(
                    ftbl=None if si.ftbl is None else si.ftbl.clone())
                before = tdispatch.COUNTS["chain_classify"]
                head, got = tchain.run_chain_step(tp, vp, work, H)
                assert tdispatch.COUNTS["chain_classify"] == before + 1
                ref_head, ref = tchain.chain_step(tp, vp, si, H)
                torch.cuda.synchronize()
                label = f"{config} H={H} {seed}"
                if work.ftbl is not None:
                    assert got.ftbl.data_ptr() == work.ftbl.data_ptr()
                _assert_fields_equal(ref_head, head, label)
                _assert_fields_equal(ref, got, label)


@pytest.mark.gpu
def test_cuda_chain_kernel_wide_form_matches_plain():
    """The wide form (T = 1024, 16 ways, 16 sharer words, H = 16,384:
    tables in the workspace, directory rows read in place) against the
    plain step on the card, on the state-level operands of every
    configuration at the default H, a non-power-of-two H and a colliding
    H = 4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU form")
    T = 1024
    for config in sorted(CONFIGS):
        tp = _torch_params(T, {**CONFIGS[config], **WIDE})
        vp = variant_params(tp)
        for H in (max(1024, 16 * T), 1000, 4):
            step = tchain.chain_step_entry(tp, vp, H, (T + 63) // 64)
            assert step.form == tchain.WIDE
            for seed in range(2):
                si = toperands.chain_step_in_from_numpy(
                    toperands.random_chain_step_arrays(tp, H, seed), "cuda")
                work = si._replace(
                    ftbl=None if si.ftbl is None else si.ftbl.clone())
                head, got = tchain.run_chain_step(tp, vp, work, H)
                ref_head, ref = tchain.chain_step(tp, vp, si, H)
                torch.cuda.synchronize()
                label = f"{config} H={H} {seed}"
                if work.ftbl is not None:
                    assert got.ftbl.data_ptr() == work.ftbl.data_ptr()
                _assert_fields_equal(ref_head, head, label)
                _assert_fields_equal(ref, got, label)


PROTOCOLS = {"mosi": "pr_l1_pr_l2_dram_directory_mosi",
             "sh_l2_msi": "pr_l1_sh_l2_msi",
             "sh_l2_mesi": "pr_l1_sh_l2_mesi"}


def _step_kernel_against_plain(tp, vp, si, H, label):
    """The fused kernel on ``si`` (the floor table on a clone) against
    the plain step: every ChainHead and ChainOut field."""
    work = si._replace(ftbl=None if si.ftbl is None else si.ftbl.clone())
    head, got = tchain.run_chain_step(tp, vp, work, H)
    ref_head, ref = tchain.chain_step(tp, vp, si, H)
    torch.cuda.synchronize()
    if work.ftbl is not None:
        assert got.ftbl.data_ptr() == work.ftbl.data_ptr()
    _assert_fields_equal(ref_head, head, label)
    _assert_fields_equal(ref, got, label)


@pytest.mark.gpu
@pytest.mark.parametrize("T", [16, 64])
def test_cuda_chain_kernel_matches_plain_under_protocols(T):
    """The fused kernel against the plain step on the card under MOSI
    and the shared-L2 protocols: every configuration, with the DRAM
    controllers on a quarter of the tiles (a shared-L2 slice miss whose
    controller is another tile), at the default H, a non-power-of-two H
    and a colliding H = 4; each protocol's own cases (O and E entries
    read and written, O victims, E grants, fan-outs)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU form")
    for proto in sorted(PROTOCOLS):
        for config in sorted(CONFIGS):
            for ctrl in ("ALL", T // 4):
                tp = _torch_params(T, {**CONFIGS[config],
                                       "caching_protocol/type":
                                       PROTOCOLS[proto],
                                       "dram/num_controllers": ctrl,
                                       "l2_cache/T1/cache_size": 64})
                vp = variant_params(tp)
                for H in (max(1024, 16 * T), 1000, 4):
                    for seed in range(2):
                        si = toperands.chain_step_in_from_numpy(
                            toperands.random_chain_step_arrays(tp, H, seed),
                            "cuda")
                        _step_kernel_against_plain(
                            tp, vp, si, H, f"{proto} {config} ctrl={ctrl} "
                            f"H={H} {seed}")


@pytest.mark.gpu
def test_cuda_chain_kernel_wide_form_under_shared_mesi():
    """The wide form at T = 1024 under shared-L2 MESI (8-way slices of
    32 sets, 16 sharer words) against the plain step on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU form")
    T = 1024
    for config in sorted(CONFIGS):
        tp = _torch_params(T, {**CONFIGS[config],
                               "caching_protocol/type": PROTOCOLS["sh_l2_mesi"],
                               "dram/num_controllers": 64,
                               "l2_cache/T1/cache_size": 16})
        vp = variant_params(tp)
        for H in (max(1024, 16 * T), 4):
            assert tchain.chain_step_entry(tp, vp, H, 16).form \
                == tchain.WIDE
            si = toperands.chain_step_in_from_numpy(
                toperands.random_chain_step_arrays(tp, H, 0), "cuda")
            _step_kernel_against_plain(tp, vp, si, H, f"{config} H={H}")


def _clone(nt):
    return type(nt)(*[t.clone() if t is not None else None for t in nt])


def _window_kernel_against_plain(tp, vp, wi, T, label):
    """window_walk's kernel on ``wi`` (which it updates in place) against
    the plain form on a clone taken first; the written leaves are the
    operands' own tensors."""
    pristine = _clone(wi)
    got = twin.run_window(tp, vp, wi, T)
    ref = twin.window_walk(tp, vp, pristine, T)
    torch.cuda.synchronize()
    for f in twin.INPLACE_FIELDS:
        if getattr(wi, f) is not None:
            assert getattr(got, f).data_ptr() == getattr(wi, f).data_ptr(), \
                (label, f)
    _assert_fields_equal(ref, got, label)


@pytest.mark.gpu
@pytest.mark.parametrize("T", [8, 64])
def test_cuda_window_kernel_matches_plain_at_p12(T):
    """window_walk's CUDA kernel against the plain form on the card with
    a pending [P, T] bank (random and seeded collision operands: a bank
    that fills, pending lines the window forwards onto or stops on), and
    on a window of the port's own radix chain-12 run."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU form")
    from graphite_tpu_torch.engine.core import window_operands
    from graphite_tpu_torch.engine.quantum import next_boundary
    from graphite_tpu_torch.engine.sim import Simulator
    from graphite_tpu_torch.events import synth
    for config in sorted(WINDOW_CONFIGS):
        tp = _torch_params(T, WINDOW_CONFIGS[config])
        vp = variant_params(tp)
        for gen in (toperands.random_window_arrays,
                    toperands.seeded_window_arrays):
            for seed in range(4):
                wi = toperands.window_in_from_numpy(
                    gen(tp, tp.block_events, seed), "cuda")
                _window_kernel_against_plain(
                    tp, vp, wi, T, f"{config} {gen.__name__} {seed}")
    tp = _torch_params(T, {})
    sim = Simulator(tp, synth.gen_radix(num_tiles=T, keys_per_tile=32,
                                        radix=16, seed=3), device="cuda")
    sim.run(max_steps=2)
    st = sim.state._replace(boundary=next_boundary(tp, sim.state))
    _, wi = window_operands(tp, st, sim.trace, sim.vp)
    _window_kernel_against_plain(tp, sim.vp, _clone(wi), T, "radix")
