"""PyTorch port, the coherence protocols (MOSI, shared-L2 MSI, shared-L2
MESI), part by part against the JAX package on the CPU:

  * ``directory.transition`` under all four protocol kinds, on random
    entries (states I/S/O/E/M, owners, sharer words with bit 63 set,
    instruction fetches that must not take E);
  * ``home_of_line``, ``dir_set_of_line`` and ``dram_site_of_line`` under
    shared L2 (the slice fold over every tile, the controller fold for
    DRAM) at 8, 64 and 1,024 tiles;
  * ``cache.raise_line_state`` and ``meta_state``;
  * the victim notifies on a seeded directory: the shared-L2 L1 victim
    notify (``_sh_l1_evict_notify``: M -> O, E -> S, the sharer bit
    cleared) and, under MOSI, the private notify's O drops;
  * the plain ``window_walk`` (K = 16 and 64, P = 0 and 12, random and
    seeded operands) and the plain chain step (state-level seeded
    operands, each protocol's own cases, a DRAM controller on another
    tile than the slice) under each new protocol;
  * whole runs of the hand-built traces of tests/test_mosi.py and
    tests/test_shared_l2.py at miss_chain 0 and 12 (an owner that
    forwards, a write to an O line, the owner's own upgrade; a slice
    hit, MESI's silent upgrade, a second reader that downgrades an E
    owner, a write that invalidates the slice's sharers, a dirty L1
    victim flushed into the slice), every SimState leaf equal, with each
    ``stall_until`` delay written as a COMPUTE block of the same length
    (STALL belongs to a later slice of the port).

The generated traces' whole runs are in test_torch_protocol_runs.py.  Every comparison is
exact (tolerance 0: the engine is all-integer; uint64 sharer words
compare as int64 bits).

The JAX package's end states come through tests/torch_jax_ref.py:
its live run on the cases in ``LIVE``, its recorded pins on the others;
so do the walk's and the chain step's outputs.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from graphite_tpu.config import load_config as jax_load_config
from graphite_tpu.engine import cache as jcache
from graphite_tpu.engine import directory as jdir
from graphite_tpu.engine import resolve as jresolve
from graphite_tpu.engine import state as jstate
from graphite_tpu.engine.kernels import chain as jchain
from graphite_tpu.engine.kernels import window as jwin
from graphite_tpu.engine.sim import Simulator as JaxSimulator
from graphite_tpu.events import schema as jax_schema
from graphite_tpu.events import synth as jax_synth
from graphite_tpu.engine.vparams import variant_params as jax_vp
from graphite_tpu.params import SimParams as JaxSimParams
from graphite_tpu_torch import convert, load_config
from graphite_tpu_torch.engine import cache as tcache
from graphite_tpu_torch.engine import dense as tdense
from graphite_tpu_torch.engine import directory as tdir
from graphite_tpu_torch.engine import resolve as tresolve
from graphite_tpu_torch.engine.kernels import chain as tchain
from graphite_tpu_torch.engine.kernels import operands as toperands
from graphite_tpu_torch.engine.kernels import window as twin
from graphite_tpu_torch.engine.sim import Simulator
from graphite_tpu_torch.events import schema as tschema
from graphite_tpu_torch.events import synth as tsynth
from graphite_tpu_torch.engine.vparams import variant_params
from graphite_tpu_torch.params import SimParams

import torch_jax_ref as ref

MODULE = "test_torch_protocols"

PROTOCOLS = {"mosi": "pr_l1_pr_l2_dram_directory_mosi",
             "sh_l2_msi": "pr_l1_sh_l2_msi",
             "sh_l2_mesi": "pr_l1_sh_l2_mesi"}
I, S, O, E, M = 0, 1, 2, 3, 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain forms are thousands of tiny ops: one intra-op thread
    per test worker is faster than contending for every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params(T, over):
    cj, ct = jax_load_config(), load_config()
    for c in (cj, ct):
        c.set("general/total_cores", T)
        for k, v in over.items():
            c.set(k, v)
    return JaxSimParams.from_config(cj), SimParams.from_config(ct)


def _np(x):
    """A leaf as numpy, uint64 words as int64 bits."""
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


# ------------------------------------------------------------ transition

@pytest.mark.parametrize("kind", ["msi", "mosi", "sh_l2_msi", "sh_l2_mesi"])
def test_transition_matches_jax(kind):
    """Random entries of every state against every request kind: owners
    from -1 (none) to the requester itself, sharer words drawn with bit
    63 set half the time (two words: requesters up to tile 127)."""
    rng = np.random.default_rng(7)
    K, W = 4096, 2
    req = rng.integers(0, 128, size=K).astype(np.int32)
    state = rng.choice([I, S, O, E, M], size=K).astype(np.int32)
    owner = np.where(rng.random(K) < 0.3, req,
                     rng.integers(-1, 128, size=K)).astype(np.int32)
    sharers = rng.integers(0, 1 << 63, size=(K, W), dtype=np.uint64) \
        | np.where(rng.random((K, W)) < 0.5, np.uint64(1 << 63),
                   np.uint64(0))
    sharers[rng.random((K, W)) < 0.2] = 0
    is_ex = rng.random(K) < 0.5
    is_if = ~is_ex & (rng.random(K) < 0.3)
    jout = jdir.transition(kind, jnp.asarray(is_ex), jnp.asarray(req),
                           jnp.asarray(state), jnp.asarray(owner),
                           jnp.asarray(sharers), W,
                           is_ifetch=jnp.asarray(is_if))
    tout = tdir.transition(kind, torch.from_numpy(is_ex),
                           torch.from_numpy(req), torch.from_numpy(state),
                           torch.from_numpy(owner),
                           torch.from_numpy(sharers.view(np.int64)), W,
                           is_ifetch=torch.from_numpy(is_if))
    _assert_fields_equal(jout, tout, kind)
    assert bool(tout.owner_leg.any()) and bool(
        (tout.inv_targets != 0).any())


# ------------------------------------------- line -> home, set, DRAM site

@pytest.mark.parametrize("T,ctrl", [(8, "ALL"), (8, 2), (64, 8),
                                    (1024, "ALL"), (1024, 32)])
def test_home_and_dir_set_of_line_under_shared_l2(T, ctrl):
    jp, tp = _params(T, {"caching_protocol/type": PROTOCOLS["sh_l2_msi"],
                         "dram/num_controllers": ctrl,
                         "l2_cache/T1/cache_size": 16})
    rng = np.random.default_rng(T)
    line = np.concatenate([rng.integers(0, 1 << 20, size=2048),
                           rng.integers(0, 1 << 31, size=2048)])
    jl, tl = jnp.asarray(line), torch.from_numpy(line)
    home = tdense.home_of_line(tp, tl)
    for jf, tf in ((jresolve.home_of_line, tdense.home_of_line),
                   (jresolve.dir_set_of_line, tdense.dir_set_of_line),
                   (jresolve.dram_site_of_line, tdense.dram_site_of_line)):
        np.testing.assert_array_equal(np.asarray(jf(jp, jl)),
                                      tf(tp, tl).numpy(), err_msg=jf.__name__)
    # Every tile hosts a slice: homes spread over the tiles, and with
    # fewer controllers than tiles the DRAM site is often another tile.
    assert len(np.unique(home.numpy())) > T // 2
    site = tdense.dram_site_of_line(tp, tl)
    assert bool((site != home).any()) == (ctrl != "ALL")


# ------------------------------------------------------- cache helpers

def test_raise_line_state_and_meta_state_match_jax():
    rng = np.random.default_rng(3)
    A, T, Sets = 4, 8, 16
    # Tags are lines of their own set (line % Sets), four per set.
    lines = rng.integers(0, 4, size=(A, T, Sets)) * Sets \
        + np.arange(Sets)[None, None, :]
    word = (lines.astype(np.int64) << 32) \
        | (rng.integers(0, 1 << 29, size=(A, T, Sets)) << 3) \
        | rng.choice([I, S, E, M], size=(A, T, Sets))
    R = 48
    tiles = rng.integers(0, T, size=R).astype(np.int32)
    sidx = rng.integers(0, Sets, size=R)
    way = rng.integers(0, A, size=R)
    # Most raised lines are resident at (tile, set), some are not.
    rl = np.where(rng.random(R) < 0.8, lines[way, tiles, sidx],
                  (4 + rng.integers(0, 4, size=R)) * Sets + sidx)
    valid = rng.random(R) < 0.9
    up = rng.choice([S, E, M], size=R).astype(np.int32)
    jc = jcache.CacheArrays(word=jnp.asarray(word),
                            rr_ptr=jnp.zeros((T, Sets), jnp.int32))
    tc = tcache.CacheArrays(word=torch.from_numpy(word),
                            rr_ptr=torch.zeros((T, Sets), dtype=torch.int32))
    jr = jcache.raise_line_state(jc, jnp.asarray(tiles), jnp.asarray(rl),
                                 jnp.asarray(valid), jnp.asarray(up), Sets)
    tr = tcache.raise_line_state(tc, torch.from_numpy(tiles),
                                 torch.from_numpy(rl),
                                 torch.from_numpy(valid),
                                 torch.from_numpy(up), Sets)
    np.testing.assert_array_equal(np.asarray(jr.word), tr.word.numpy())
    assert not np.array_equal(word, tr.word.numpy())
    np.testing.assert_array_equal(np.asarray(jcache.meta_state(jr.meta)),
                                  tcache.meta_state(tr.word).numpy())


# ----------------------------------------------------- victim notifies

def _notify_case(proto, seed):
    """A directory with planted entries and a batch of victims: several
    rows drop lines that share one entry (concurrent sharer clears), the
    owner drops its M / E / O line, others drop lines the directory does
    not hold, some rows are masked off."""
    T = 8
    jp, tp = _params(T, {"caching_protocol/type": PROTOCOLS[proto],
                         "l2_cache/T1/cache_size": 16,
                         "dram_directory/total_entries": 256})
    rng = np.random.default_rng(seed)
    st = jax.device_get(jstate.make_state(jp, has_capi=False))
    leaves = convert.leaves_to_numpy(st)
    A = jp.directory.associativity
    word = leaves["dir_word"].copy()
    sharers = leaves["dir_sharers"].copy()
    states = [S, O, M] if proto == "mosi" else [S, O, E, M]
    pool = rng.integers(0, 1 << 20, size=6)
    R = 3 * T
    tiles = np.tile(np.arange(T, dtype=np.int32), 3)
    vtag = rng.choice(pool, size=R).astype(np.int64)
    fidx = (tdense.home_of_line(tp, torch.from_numpy(pool)).numpy()
            .astype(np.int64) * tp.directory.num_sets
            + tdense.dir_set_of_line(tp, torch.from_numpy(pool)).numpy())
    for ln, f in zip(pool[:5], fidx[:5]):          # the sixth: not held
        w = int(rng.integers(0, A))
        s = int(rng.choice(states))
        own = int(rng.integers(0, T)) if s in (M, E) or (
            s == O and proto == "mosi") else -1
        bits = int(rng.integers(0, 1 << T))
        if own >= 0:
            bits = (1 << own) if s in (M, E) else bits | (1 << own)
        word[w, f] = (int(ln) << 33) | (int(rng.integers(0, 1 << 17)) << 16) \
            | ((own + 1) << 3) | s
        sharers[w, f] = np.uint64(bits)
    # Most owners drop their own line.
    dw = word.reshape(A, -1)
    for r in range(R):
        f = fidx[list(pool).index(vtag[r])]
        for w in range(A):
            if (dw[w, f] >> 33) == vtag[r] and rng.random() < 0.6:
                o = int((dw[w, f] >> 3) & 0x1FFF) - 1
                if o >= 0:
                    tiles[r] = o
    vstate = rng.choice([S, E, M] if proto != "mosi" else [S, O, M],
                        size=R).astype(np.int32)
    valid = rng.random(R) < 0.9
    leaves["dir_word"], leaves["dir_sharers"] = word, sharers
    return jp, tp, leaves, (tiles, vtag, vstate, valid)


@pytest.mark.parametrize("proto,seed", [
    ("sh_l2_msi", 0), ("sh_l2_mesi", 1), ("sh_l2_mesi", 2), ("mosi", 3),
    ("mosi", 4)])
def test_victim_notify_matches_jax(proto, seed):
    """Shared L2: the L1 victim notify; MOSI: the private notify, whose
    O drops keep the remaining sharers in S."""
    jp, tp, leaves, (tiles, vtag, vstate, valid) = _notify_case(proto,
                                                                seed)
    tst = convert.state_from_numpy(tp, leaves, "cpu")
    jst = _jax_state(jp, leaves)
    args = (jnp.asarray(tiles), jnp.asarray(vtag), jnp.asarray(vstate),
            jnp.asarray(valid))
    targs = (torch.from_numpy(tiles), torch.from_numpy(vtag),
             torch.from_numpy(vstate), torch.from_numpy(valid))
    if proto == "mosi":
        jout = jresolve._dir_evict_notify(jp, jst, *args)
        tout = tresolve._dir_evict_notify(tp, tst, *targs)
    else:
        jout = jresolve._sh_l1_evict_notify(jp, jst, *args)
        tout = tresolve._sh_l1_evict_notify(tp, tst, *targs)
    for f in ("dir_word", "dir_sharers"):
        np.testing.assert_array_equal(_np(getattr(jout, f)),
                                      _np(getattr(tout, f)), err_msg=f)
    assert not np.array_equal(_np(tout.dir_word), leaves["dir_word"]) \
        or not np.array_equal(_np(tout.dir_sharers),
                              _np(leaves["dir_sharers"]))


def _jax_state(jp, leaves):
    """The JAX SimState holding ``leaves`` (a flat numpy dict)."""
    st = jstate.make_state(jp, has_capi=False)
    out = {}
    for f, v in zip(st._fields, st):
        if isinstance(v, tuple) and hasattr(v, "_fields"):
            out[f] = type(v)(**{g: jnp.asarray(leaves[f"{f}.{g}"])
                                for g in v._fields})
        elif f in leaves:
            a = leaves[f]
            if f == "dir_sharers":
                a = np.asarray(a).view(np.uint64)
            out[f] = jnp.asarray(a)
        else:
            out[f] = v
    return type(st)(**out)


# ------------------------------------------------- plain window walk



@functools.lru_cache(maxsize=None)
def _jax_walk():
    return ref.eager(jwin.window_walk)


def _walk_checked(jp, tp, arrays, live=False):
    """The plain walk on ``arrays``, every WindowOut leaf held to the JAX
    walk's (run where ``live``, else its pin:
    tests/torch_jax_ref.check_outputs)."""
    tout = twin.window_walk(tp, variant_params(tp),
                            toperands.window_in_from_numpy(arrays, "cpu"),
                            tp.num_tiles)

    def jax_out():
        jwi = jwin.WindowIn(**{
            f: (jnp.asarray(arrays[f]) if arrays.get(f) is not None
                else None) for f in jwin.WindowIn._fields})
        return ref.fields_of(tout, _jax_walk()(jp, jax_vp(jp), jwi,
                                               tp.num_tiles))

    ref.check_outputs(MODULE, tout, jax_out, {"params": repr(tp)}, arrays,
                      live)
    return tout


@pytest.mark.parametrize("P", [0, 12])
@pytest.mark.parametrize("K", [16, 64])
@pytest.mark.parametrize("proto", sorted(PROTOCOLS))
def test_plain_walk_matches_jax(proto, K, P):
    """Random and seeded window operands (upgrades of E lines, banked
    fills of one L1 set, pending banks, cuts) under each protocol."""
    jp, tp = _params(8, {"caching_protocol/type": PROTOCOLS[proto],
                         "tpu/miss_chain": P})
    upgraded = banked = 0
    for gen in (toperands.random_window_arrays,
                toperands.seeded_window_arrays):
        for seed in range(2):
            arrays = gen(tp, K, seed)
            assert (arrays["l2_word"] is None) == tp.shared_l2
            tout = _walk_checked(jp, tp, arrays)
            if P:
                banked += int((tout.mq_count.numpy()
                               - arrays["mq_count"]).sum())
            if proto == "sh_l2_mesi":
                # touched lines that went from E to M
                before = arrays["l1d_word"] & 7
                upgraded += int(((before == E)
                                 & (tout.l1d_word.numpy() & 7 == M)).sum())
    assert banked > 0 or P == 0
    assert upgraded > 0 or proto != "sh_l2_mesi"


# ------------------------------------------------- plain chain step

@functools.lru_cache(maxsize=None)
def _jax_classify():
    return ref.eager(jchain.chain_classify)


def _jax_step_in(jp, arrays, H):
    """The JAX ChainIn the JAX ``chain_fast_pass`` gathers from the
    state-level arrays (its head and directory-row gathers)."""
    from graphite_tpu.engine import dense as jdense
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
    fields = dict(
        active=active, is_ex=active & (kind == 2), is_if=active & (kind == 3),
        line=line, issue=arrays["base"] + delta, extra=extra, home=home,
        dset=dset, fidx=fidx, hidx=hidx, drow=drow, dsharers=dsharers,
        **{f: arrays[f] for f in ("p_net", "p_dir", "p_l2", "p_l1d",
                                  "p_l1i", "p_core", "ftbl")})
    return fields, jchain.ChainIn(**{
        f: (None if v is None else jnp.asarray(v))
        for f, v in fields.items()})


STEP_CONFIGS = {
    "fanout_queue": {},
    "nofanout_noqueue": {"tpu/fanout_replay": False,
                         "dram/queue_model/enabled": False},
    # Four controllers among 16 tiles: a shared-L2 slice miss often has
    # its memory controller on another tile (the slice->controller legs).
    "fanout_noqueue_ctrl4": {"dram/queue_model/enabled": False,
                             "dram/num_controllers": 4},
}


@pytest.mark.parametrize("config", sorted(STEP_CONFIGS))
@pytest.mark.parametrize("proto", sorted(PROTOCOLS))
def test_plain_chain_step_matches_jax(proto, config):
    """One replay iteration from state-level operands (each protocol's
    own cases: O and E entries read and written, the owner's own
    upgrade, O victims dead and live, fetch and read misses): every
    ChainHead field against the JAX pass's gathers, every ChainOut field
    against the JAX chain_classify."""
    jp, tp = _params(16, {"caching_protocol/type": PROTOCOLS[proto],
                          "tpu/miss_chain": 12,
                          "l2_cache/T1/cache_size": 64,
                          **STEP_CONFIGS[config]})
    H = max(1024, 16 * tp.num_tiles)
    seen = dict(owner_leg=0, fan_go=0, evicting=0, e_grant=0, site=0)
    for seed in range(3):
        arrays = toperands.random_chain_step_arrays(tp, H, seed)
        head, out = tchain.run_chain_step(
            tp, variant_params(tp),
            toperands.chain_step_in_from_numpy(arrays, "cpu"), H)

        def jax_out():
            fields, jin = _jax_step_in(jp, arrays, H)
            return dict(head={f: fields[f] for f in tchain.ChainHead._fields},
                        out=ref.fields_of(out, _jax_classify()(
                            jp, jax_vp(jp), jin, H)))

        ref.check_outputs(MODULE, dict(head=head, out=out), jax_out,
                          {"params": repr(tp), "H": H}, arrays)
        seen["owner_leg"] += int(out.owner_leg.sum())
        seen["fan_go"] += int(out.fan_go.sum())
        seen["evicting"] += int(out.evicting.sum())
        seen["e_grant"] += int((out.serve & (out.new_state == E)).sum())
        seen["site"] += int((out.need_read & (out.from_dram_ps > 0)).sum())
    assert seen["owner_leg"] > 0 and seen["evicting"] > 0, seen
    if config != "nofanout_noqueue":
        assert seen["fan_go"] > 0, seen
    assert (seen["e_grant"] > 0) == (proto == "sh_l2_mesi"), seen
    assert (seen["site"] > 0) == (tp.shared_l2 and "ctrl4" in config), seen


# ------------------------------------------------ hand-built whole runs
# Both packages' TraceBuilders, 4 tiles, one length (so that one compiled
# JAX program serves every case of a configuration).

DELAY = 5000                 # cycles: 5 us at the default 1 GHz core


def _producer_readers(tb, synth):
    """Tile 0 dirties a line; tiles 1 and 2 read it in sequence."""
    tb.write(0, synth.SHARED_BASE, 8)
    for r in (1, 2):
        tb.compute(r, DELAY * r, 1)
        tb.read(r, synth.SHARED_BASE, 8)


def _write_after_o(tb, synth):
    a = synth.SHARED_BASE
    tb.write(0, a, 8)                 # 0: M
    tb.compute(1, DELAY, 1)
    tb.read(1, a, 8)                  # 0 -> O, forwards
    tb.compute(2, 2 * DELAY, 1)
    tb.write(2, a, 8)                 # EX on O: flush 0, invalidate 1
    tb.compute(0, 3 * DELAY, 1)
    tb.read(0, a, 8)                  # the old owner misses again


def _owner_upgrade(tb, synth):
    a = synth.SHARED_BASE
    tb.write(0, a, 8)                 # 0: M
    tb.compute(1, DELAY, 1)
    tb.read(1, a, 8)                  # 0 -> O
    tb.compute(0, 2 * DELAY, 1)
    tb.write(0, a, 8)                 # the owner upgrades O -> M


def _slice_hit(tb, synth):
    tb.read(0, synth.SHARED_BASE, 8)
    tb.compute(1, DELAY, 1)
    tb.read(1, synth.SHARED_BASE, 8)  # a slice hit: no DRAM read


def _silent_upgrade(tb, synth):
    tb.read(0, synth.SHARED_BASE, 8)  # MESI: the sole reader gets E
    tb.compute(0, 10, 5)
    tb.write(0, synth.SHARED_BASE, 8)  # E -> M with no request


def _write_invalidates(tb, synth):
    a = synth.SHARED_BASE
    tb.read(0, a, 8)
    tb.read(1, a, 8)
    tb.compute(2, DELAY, 1)
    tb.write(2, a, 8)                 # invalidate sharers {0, 1}
    tb.compute(0, 2 * DELAY, 1)
    tb.read(0, a, 8)                  # misses in its L1 again


def _dirty_l1_victim(tb, synth, nsets=128, assoc=4, line=64):
    # assoc + 1 writes to one L1D set: the first line becomes the dirty
    # victim of the last fill (default L1D: 128 sets of 4 ways).
    base = synth.SHARED_BASE
    for k in range(assoc + 1):
        tb.write(0, base + k * nsets * line, 8)
    tb.compute(1, DELAY, 1)
    tb.read(1, base, 8)               # served by the slice's O copy


MOSI, SH_MSI, SH_MESI = (PROTOCOLS["mosi"], PROTOCOLS["sh_l2_msi"],
                         PROTOCOLS["sh_l2_mesi"])
HAND_BUILT = {
    "producer_readers": (_producer_readers, (MOSI,)),
    "write_after_o": (_write_after_o, (MOSI,)),
    "owner_upgrade": (_owner_upgrade, (MOSI,)),
    "slice_hit": (_slice_hit, (SH_MSI,)),
    "silent_upgrade": (_silent_upgrade, (SH_MSI, SH_MESI)),
    "second_reader": (_slice_hit, (SH_MESI,)),
    "write_invalidates": (_write_invalidates, (SH_MSI,)),
    "dirty_l1_victim": (_dirty_l1_victim, (SH_MSI,)),
}
# The cases compared with the JAX package's live run in tier-1: MOSI's
# traces at chain 12, one JAX compile for the three (the traces are
# padded to one shape); the others with its recorded pins
# (tests/torch_jax_ref.py).
LIVE = tuple(f"{name}-{MOSI}-12" for name in ("producer_readers",
                                               "write_after_o",
                                               "owner_upgrade"))


def _hand_built(name, schema, synth):
    tb = schema.TraceBuilder(4)
    HAND_BUILT[name][0](tb, synth)
    return tb.build(min_events=16)


def _both(key, T, over, jtrace, ttrace):
    """Run the port to the end, every leaf equal to the JAX package's
    (torch_jax_pins: its pins, or its run); returns the port's
    summary."""
    jp, tp = _params(T, over)
    tsim = Simulator(tp, ttrace, device="cpu")
    s = tsim.run(max_steps=4096)
    assert bool(s.done.all())

    def jax_leaves():
        jsim = JaxSimulator(jp, jtrace())
        jsim.run(max_steps=4096)
        return convert.leaves_to_numpy(jax.device_get(jsim.state))

    ref.check("test_torch_protocols", key,
              convert.state_to_numpy(tsim.state), jax_leaves,
              ref.inputs({"general/total_cores": T, **over}, tsim.trace,
                         steps=4096), live=key in LIVE)
    return s


def _sum(s, k):
    return int(s.counters[k].sum())


@pytest.mark.parametrize("chain", [0, 12])
@pytest.mark.parametrize("name,proto", [
    (n, p) for n, (_, protos) in HAND_BUILT.items() for p in protos])
def test_hand_built_trace_matches_jax(name, proto, chain):
    s = _both(f"{name}-{proto}-{chain}", 4,
              {"caching_protocol/type": proto, "tpu/miss_chain": chain},
              lambda: _hand_built(name, jax_schema, jax_synth),
              _hand_built(name, tschema, tsynth))
    # What the JAX package's own tests of these traces hold.
    if name == "producer_readers":
        assert _sum(s, "dram_writes") == 0 and _sum(s, "dir_forwards") == 2
    elif name == "silent_upgrade":
        assert _sum(s, "dir_ex_req") == (proto == SH_MSI)
    elif name == "second_reader":
        assert _sum(s, "dir_writebacks") == 1
    elif name == "write_invalidates":
        assert _sum(s, "dir_invalidations") == 2
