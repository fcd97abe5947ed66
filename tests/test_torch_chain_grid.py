"""PyTorch port, the chain replay at the sizes of ``chain_classify``'s grid
form: more than 1,024 tiles (more than 16 sharer words) or more than 32
directory ways, which neither one-block form takes.

  * The plain step (what the CPU runs, and what the grid form is held to
    on the card) against the JAX ``chain_classify``, op by op, on
    state-level seeded sets (``operands.random_chain_step_arrays``, the
    JAX operands gathered from the same arrays by numpy indexing, as the
    JAX ``chain_fast_pass`` gathers them): T = 2,048 on a directory of 4
    sets per tile (W = 32 sharer words, H = 32,768; ``dir_sharers`` 34
    MB), and A = 64 and 128 directory ways at T = 64; under MSI and
    shared-L2 MESI; the fan-out replay on and off, the DRAM queue model
    on and off; at the engine's H and a colliding H = 4.  Across them the
    sets reach a contested election, a combining slot written by
    representatives of two lines (the last row wins), a victim scan that
    excludes a hit-held way past way 32, and a fan-out past 32 targets.
  * The grid form's choice by size and its workspace
    (``step_layout_bytes``), array by array.
  * A whole run at T = 8 with 64 directory ways at miss_chain 12, every
    SimState leaf equal to the JAX package's live run.
  * ``gpu``: the grid form against the plain step on the card, on the
    same sets, and on the wide form's T = 1,024 sets (the grid form asked
    for explicitly).

Every output field equal, value and dtype (tolerance 0: the function is
all-integer; uint64 sharer words compare as int64 bits); the plain
step's against the JAX function's outputs as recorded for the same
inputs (tests/torch_jax_ref.check_outputs).  The JAX package
is imported inside the tests that use it, so the card's tests run on a
machine without jax (``python -m pytest -m gpu --noconftest
tests/test_torch_chain_grid.py``).
"""

import functools

import numpy as np
import pytest
import torch

from graphite_tpu_torch import convert
from graphite_tpu_torch.engine.kernels import chain as tchain
from graphite_tpu_torch.engine.kernels import operands as toperands
from graphite_tpu_torch.engine.sim import Simulator
from graphite_tpu_torch.engine.vparams import variant_params
from graphite_tpu_torch.events import synth

from test_torch_chain_kernel import (_assert_fields_equal, _jax,
                                     _jax_chain_in, _jax_classify,
                                     _jax_step_in, _params, _torch_params)

import torch_jax_ref as ref

SMALL2048 = {"dram_directory/total_entries": 64}      # 4 sets of 16 ways
SH_MESI = {"caching_protocol/type": "pr_l1_sh_l2_mesi"}
NOQUEUE = {"dram/queue_model/enabled": False}
NOFAN = {"tpu/fanout_replay": False}
# name: (T, config overrides, seed); every one takes the grid form.
SETS = {
    "t2048_msi_fanout_noqueue": (2048, {**SMALL2048, **NOQUEUE}, 0),
    "t2048_msi_nofanout_queue": (2048, {**SMALL2048, **NOFAN}, 1),
    # The directory is the L2 slice: 4 KB of 8 ways, 8 sets a tile.
    "t2048_shl2_mesi_fanout_queue": (2048, {**SH_MESI,
                                            "l2_cache/T1/cache_size": 4,
                                            "dram/num_controllers": 256}, 2),
    "a64_msi_fanout_noqueue": (64, {"dram_directory/associativity": 64,
                                    **NOQUEUE}, 3),
    "a128_msi_nofanout_noqueue": (64, {"dram_directory/associativity": 128,
                                       **NOFAN, **NOQUEUE}, 4),
    # 64 KB slices of 64 ways, 16 sets; controllers on a quarter of the
    # tiles (slice misses whose controller is another tile).
    "a64_shl2_mesi_fanout_queue": (64, {**SH_MESI,
                                        "l2_cache/T1/associativity": 64,
                                        "l2_cache/T1/cache_size": 64,
                                        "dram/num_controllers": 16}, 5),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain forms are thousands of tiny ops: one intra-op thread
    per test worker is faster than contending for every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _H(T, colliding):
    return 4 if colliding else max(1024, 16 * T)


@functools.lru_cache(maxsize=None)
def _plain(name, colliding):
    """A set's params, H, state-level arrays and the plain step's
    (ChainHead, ChainOut) on them (computed once per module)."""
    T, over, seed = SETS[name]
    tp = _torch_params(T, over)
    H = _H(T, colliding)
    arrays = toperands.random_chain_step_arrays(tp, H, seed)
    si = toperands.chain_step_in_from_numpy(arrays, "cpu")
    head, out = tchain.run_chain_step(tp, variant_params(tp), si, H)
    return tp, H, arrays, head, out


@pytest.mark.parametrize("colliding", [False, True])
@pytest.mark.parametrize("name", sorted(SETS))
def test_plain_step_matches_jax_at_grid_sizes(name, colliding):
    """Every ChainHead field against the JAX pass's gathered head, every
    ChainOut field against the JAX chain_classify, on a set the grid form
    takes."""
    T, over, _ = SETS[name]
    tp, H, arrays, head, out = _plain(name, colliding)
    A, W = tp.directory.associativity, (T + 63) // 64
    KF = min(tp.max_inv_fanout_per_round, T)
    assert tchain.step_form(T, A, W, H, KF)[0] == tchain.GRID

    def jax_out():
        J = _jax()
        jp, _ = _params(T, over)
        jin = _jax_step_in(jp, arrays, H)
        jout = _jax_classify()(jp, J["jax_vp"](jp), _jax_chain_in(jin), H)
        return dict(head={f: jin[f] for f in tchain.ChainHead._fields},
                    out=ref.fields_of(out, jout))

    ref.check_outputs("test_torch_chain_grid", dict(head=head, out=out),
                      jax_out, {"params": repr(tp), "H": H}, arrays)


def _cases(tp, H, arrays, head, out):
    """How often each case the grid form must get right occurs in the
    plain step's result on one set."""
    from graphite_tpu_torch.engine import dense as tdense
    from graphite_tpu_torch.engine.ops import umod64
    from graphite_tpu_torch.engine.state import (dword_stamp, dword_state,
                                                 dword_tag)
    A = tp.directory.associativity
    si = toperands.chain_step_in_from_numpy(arrays, "cpu")
    act = head.active
    way = out.way.to(torch.int64)
    drow, _ = tchain.chain_rows(si.dir_word, si.dir_sharers, head.fidx)
    # The hit-held ways of each flat set's hash slot, and the victim scan's
    # choice before they are excluded.
    fh = umod64(tdense.fmix64(head.fidx.to(torch.int64)), H)
    used = torch.zeros((H, A), dtype=torch.bool)
    used[fh[out.hit], way[out.hit]] = True
    lru = torch.argmin(torch.where(dword_state(drow) == 0, -1,
                                   dword_stamp(drow)), dim=1)
    excluded = act & ~out.hit & used[fh, lru]
    am = (head.home.to(torch.int64) * tp.directory.num_sets + head.dset) \
        * A + way
    wslot = tdense.elect(act, tdense.fcfs_keys(act, head.issue),
                         umod64(tdense.fmix64(am), H), H)
    # Served shared-read representatives by combining slot: a slot written
    # by rows of two or more lines keeps its last row's line.
    st = dword_state(torch.gather(drow, 1, way[:, None])[:, 0])
    ent = torch.where(out.hit, st, 0)
    ok = (ent == 1) if tp.shared_l2 else ((ent == 0) | (ent == 1))
    rep = out.serve & ~head.is_ex & ok
    lines = {}
    for r in torch.nonzero(rep).flatten().tolist():
        lines.setdefault(int(head.hidx[r]), set()).add(int(head.line[r]))
    hit_way = torch.where(
        (dword_tag(drow) == head.line[:, None].to(torch.int32))
        & (dword_state(drow) != 0), torch.arange(A)[None, :], A).amin(1)
    return dict(
        contested_election=int((act & ~wslot).sum()),
        last_row_wins=sum(len(v) > 1 for v in lines.values()),
        victim_scan=int((out.serve & ~out.hit).sum()),
        excluded_victim=int(excluded.sum()),
        hit_past_way_32=int((out.hit & (hit_way >= 32)).sum()),
        excluded_past_way_32=int((excluded & (lru >= 32)).sum()),
        fan_out_past_32_targets=int((out.fan_go & (out.inv_count > 32))
                                    .sum()),
        owner_leg=int(out.owner_leg.sum()),
        member=int(out.member.sum()),
        hard_stop=int(out.hard_stop.sum()))


def test_grid_sets_cover_the_cases():
    """Across the sets of the parity test (the plain step, equal to the
    JAX function there): a contested election, a combining slot whose
    last row wins over another line's, an allocation through the victim
    scan and one whose least recently used way a hit holds, hits and
    such an exclusion past way 32 (the second hit-held word), a fan-out
    to more than 32 targets, an owner leg, a combining member and a hard
    stop; and at T = 2,048 a fan-out whose targets lie in more than one
    256-tile block."""
    seen = {}
    blocks = 0
    for name in SETS:
        for colliding in (False, True):
            tp, H, arrays, head, out = _plain(name, colliding)
            for k, v in _cases(tp, H, arrays, head, out).items():
                seen[k] = seen.get(k, 0) + v
            if out.inv_bool is not None and tp.num_tiles > 256:
                per_block = out.inv_bool.reshape(
                    out.inv_bool.shape[0], -1, 256).any(dim=2)
                blocks += int((per_block.sum(dim=1) > 1).sum())
    assert all(v > 0 for v in seen.values()), seen
    assert blocks > 0


def test_grid_form_by_size_and_workspace():
    """The grid form takes what neither one-block form does (T > 1,024,
    more than 16 sharer words, more than 32 ways) and nothing else; its
    workspace holds every array: at T = 2,048, 16 ways, H = 32,768 and 8
    fan-out slots the H-sized tables (election / floor int64, hit-held
    way words int32, exclusive flags, the combining table int32), the
    [T, W] invalidation words, the per-row arrays (FCFS key and line
    int64, flat set, home, owner, way and (x, y) int32, two flag bytes),
    the issue minimum and the per-slot row, count and cycles; with 64
    ways two hit-held words a slot."""
    assert tchain.step_form(1024, 16, 16, 16384, 8)[0] == tchain.WIDE
    assert tchain.step_form(1024, 32, 16, 16384, 8)[0] == tchain.WIDE
    assert tchain.step_form(512, 32, 8, 8192, 8)[0] == tchain.WIDE
    assert tchain.step_form(64, 16, 1, 1024, 8)[0] == tchain.SHARED
    for T, A in ((1025, 16), (2048, 16), (8191, 16), (64, 33), (8, 64),
                 (1024, 128)):
        form, smem, ws = tchain.step_form(T, A, (T + 63) // 64,
                                          max(1024, 16 * T), 8)
        assert form == tchain.GRID and smem == 0 and ws > 0, (T, A)
    T, A, W, H, KF = 2048, 16, 32, 32768, 8

    def al(x):
        return (x + 7) & ~7

    tables = 8 * H + 4 * H + H + 4 * H
    rows = 8 * T + 8 * T + 5 * 4 * T + 2 * T
    want = tables + 8 * T * W + rows + 8 + 3 * 4 * KF
    assert al(tables + 8 * T * W + rows + 8 + 3 * 4 * KF) == want
    assert tchain.step_layout_bytes(T, A, W, H, KF, tchain.GRID) \
        == (0, want) == (0, 1_159_272)
    assert tchain.step_form(T, A, W, H, KF) == (tchain.GRID, 0, want)
    # 64 ways: a second hit-held word per slot; 33 ways too.
    for A2 in (33, 64):
        assert tchain.step_layout_bytes(T, A2, W, H, KF, tchain.GRID)[1] \
            == want + 4 * H


def test_whole_run_64_ways_matches_jax():
    """gen_radix(8, keys_per_tile=64, radix=16, seed=3) at miss_chain 12
    with 64 directory ways (the grid form on the card): every SimState
    leaf and round counter equal to the JAX package's live run."""
    import jax
    from graphite_tpu.engine.sim import Simulator as JaxSimulator
    from graphite_tpu.events import synth as jax_synth
    kw = dict(num_tiles=8, keys_per_tile=64, radix=16, seed=3)
    over = {"general/total_cores": 8, "tpu/miss_chain": 12,
            "dram_directory/associativity": 64}
    jp, tp = _params(8, {"dram_directory/associativity": 64})
    assert tp.directory.associativity == 64 and tp.miss_chain == 12
    tsim = Simulator(tp, synth.gen_radix(**kw), device="cpu")
    tsim.run(max_steps=4096)
    assert bool(tsim.state.done.all())
    assert int(tsim.state.ctr_resolve) > 0

    def jax_leaves():
        jsim = JaxSimulator(jp, jax_synth.gen_radix(**kw))
        jsim.run(max_steps=4096)
        return convert.leaves_to_numpy(jax.device_get(jsim.state))

    ref.check("test_torch_chain_grid", "radix8_a64_chain12",
              convert.state_to_numpy(tsim.state), jax_leaves,
              ref.inputs(over, tsim.trace, steps=4096), live=True)


# ------------------------------------------------------------ on the card

def _grid_against_plain(tp, H, arrays, label, form=None):
    """The grid form on a set (the floor table on a clone) against the
    plain step: every ChainHead and ChainOut field."""
    si = toperands.chain_step_in_from_numpy(arrays, "cuda")
    W = si.dir_sharers.shape[0] // tp.directory.associativity
    vp = variant_params(tp)
    step = tchain.chain_step_entry(tp, vp, H, W, form)
    assert step.form == tchain.GRID, label
    work = si._replace(ftbl=None if si.ftbl is None else si.ftbl.clone())
    head, got = step(work)
    ref_head, want = tchain.chain_step(tp, vp, si, H)
    torch.cuda.synchronize()
    if work.ftbl is not None:
        assert got.ftbl.data_ptr() == work.ftbl.data_ptr()
    _assert_fields_equal(ref_head, head, label)
    _assert_fields_equal(want, got, label)


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(SETS))
def test_cuda_grid_form_matches_plain(name):
    """The grid form against the plain step on the card, on each set at
    the engine's H, a colliding H = 4 and a non-power-of-two H, two
    seeds each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU form")
    T, over, seed = SETS[name]
    tp = _torch_params(T, over)
    for H in (max(1024, 16 * T), 4, 1000):
        for s in (seed, seed + 10):
            _grid_against_plain(
                tp, H, toperands.random_chain_step_arrays(tp, H, s),
                f"{name} H={H} seed {s}")


@pytest.mark.gpu
def test_cuda_grid_form_at_1024_matches_plain():
    """The grid form asked for at T = 1,024 (where the engine runs the
    wide form) against the plain step, on the wide form's sets (16 sets
    of 16 ways a tile) of every configuration."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU form")
    for over in ({}, NOQUEUE, NOFAN, {**NOFAN, **NOQUEUE}):
        tp = _torch_params(1024, {"dram_directory/total_entries": 256,
                                  **over})
        for H in (16384, 4):
            _grid_against_plain(
                tp, H, toperands.random_chain_step_arrays(tp, H, 0),
                f"T=1024 {over} H={H}", form=tchain.GRID)
