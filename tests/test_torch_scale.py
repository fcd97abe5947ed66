"""PyTorch port at one-card scale: T = 1024 and T = 256 against the JAX
package on the CPU.

T = 1024 is the smallest tile count at which the conflict round leaves
its one-hot [T, H] tables (H = max(1024, 16 T); the dense form holds
while T * H <= 2^22, i.e. T <= 512): the per-line election goes through
``dense.elect``'s scatter-min table, the shared-read combining tables
through one ``dense.stacked_max_table`` and the floor table through
``dense.stacked_set_table``, where combined shared-read winners of one
line write one slot and the LAST row's value stays (the JAX package's
CPU scatter order).  The chain pass's plain form runs its election above
the cap too.

The tier-1 cases are cut runs (a fixed number of quanta in both
packages, every SimState leaf equal, tolerance 0: the engine is
all-integer) on a small directory, ``dram_directory/total_entries =
1024`` (64 sets of 16 ways, so ``dir_sharers`` is 128 MB at T = 1024
instead of the default 2 GB, whose every drop-scatter copy makes a CPU
round take seconds):

  * ``gen_radix(1024, keys_per_tile=1, radix=64)`` at
    ``tpu/block_events = 4``, miss_chain 0 and, on a directory of 4
    one-way sets a tile under 16 KB L2s (``dir_sharers`` is 2 MB), whose
    evictions reach the conflict rounds in the first quantum, 12;
  * ``gen_shared_readers(1024, lines=64, passes=2)``, whose conflict
    rounds write floor-table slots from two or more rows with different
    availability times, so the dense group-max form gives another table
    (the radix cut writes one such slot, from 1,024 rows whose last row
    also holds the largest time; the test counts both from the rounds'
    own masks);
  * a carry-across: the JAX state of the chain-12 cut, opened into its
    next quantum and cut after the local advance, through one resolve
    pass in both packages;
  * T = 256 on the default config (the dense tables), a few quanta;
  * the radix cut at miss_chain 12 under shared-L2 MESI, on 32-set L2
    slices (the directory is the slice: ``dir_sharers`` is 32 MB);
  * the radix cut at T = 2,048 and miss_chain 12 (32 sharer words, H =
    32,768, a 45 x 46 mesh whose last row is part empty: on the card,
    ``chain_classify``'s grid form), one quantum on a directory of 4
    one-way sets a tile and 16 KB L2s (``dir_sharers`` is 2 MB), whose
    directory evictions reach the conflict rounds in that quantum.

Under ``slow``: the whole keys-1 runs on the default directory, pinned at
the JAX package's CPU values (1,537 rounds, 57,500,000 ps at miss_chain
0; 336 rounds, 56,706,000 ps at miss_chain 12).

The JAX package's end states come through tests/torch_jax_ref.py:
its live run on the cases in ``LIVE``, its recorded pins on the others.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from graphite_tpu.config import load_config as jax_load_config
from graphite_tpu.engine import core as jcore
from graphite_tpu.engine import dense as jdense
from graphite_tpu.engine import quantum as jquantum
from graphite_tpu.engine import resolve as jresolve
from graphite_tpu.engine.sim import Simulator as JaxSimulator
from graphite_tpu.events import synth as jax_synth
from graphite_tpu.params import SimParams as JaxSimParams
from graphite_tpu_torch import convert, load_config
from graphite_tpu_torch.engine import core as tcore
from graphite_tpu_torch.engine import dense as tdense
from graphite_tpu_torch.engine import quantum as tquantum
from graphite_tpu_torch.engine import resolve as tresolve
from graphite_tpu_torch.engine.sim import Simulator, check_slice
from graphite_tpu_torch.events import synth
from graphite_tpu_torch.params import SimParams

import torch_jax_ref as ref

SMALL_DIR = {"dram_directory/total_entries": 1024}
K4 = {"tpu/block_events": 4}
# 4 one-way directory sets a tile under 16 KB L2s.
TINY_DIR = {"dram_directory/total_entries": 4,
            "dram_directory/associativity": 1, "l2_cache/T1/cache_size": 16}
RADIX1 = ("gen_radix", dict(keys_per_tile=1, radix=64, seed=0))
# name: (T, (generator, kwargs), config overrides, quanta)
CASES = {
    "radix1024_chain0": (1024, RADIX1, {**SMALL_DIR, **K4}, 4),
    # On TINY_DIR the directory evictions reach the conflict rounds in
    # the first quantum; two quanta serve chains in the replay pass and
    # run conflict rounds in each.  (On SMALL_DIR the first conflict
    # round comes in the seventh quantum, nine times the CPU time.)
    "radix1024_chain12": (1024, RADIX1, {**TINY_DIR, **K4,
                                         "tpu/miss_chain": 12}, 2),
    "shared_readers1024": (1024, ("gen_shared_readers",
                                  dict(lines=64, passes=2)),
                           SMALL_DIR, 2),
    "radix256_dense": (256, ("gen_radix", dict(keys_per_tile=8, radix=64,
                                               seed=0)), {}, 4),
    # Shared-L2 MESI on 32-set slices (16 KB of L2 a tile): the conflict
    # round's scatter forms and the chain pass's plain step at T = 1024
    # on the slice directory, with MESI's E grants and silent upgrades.
    # One quantum: by then the slices hold E, M and S lines and two
    # conflict rounds have run.
    "radix1024_shl2_mesi_chain12": (1024, RADIX1, {
        **K4, "tpu/miss_chain": 12,
        "caching_protocol/type": "pr_l1_sh_l2_mesi",
        "l2_cache/T1/cache_size": 16}, 1),
    "radix2048_chain12": (2048, RADIX1, {
        **K4, "tpu/miss_chain": 12, **TINY_DIR}, 1),
}
# The cases compared with the JAX package's live run in tier-1 (the
# others with its recorded pins: tests/torch_jax_ref.py).
LIVE = ("radix256_dense",)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The engine's CPU path is thousands of tiny ops: one intra-op
    thread per test worker is faster than contending for every core."""
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


def _assert_leaves_equal(jleaves, tleaves):
    assert set(jleaves) == set(tleaves)
    for name in sorted(jleaves):
        a, b = np.asarray(jleaves[name]), np.asarray(tleaves[name])
        assert a.dtype == b.dtype and a.shape == b.shape, \
            (name, a.dtype, b.dtype, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=name)


class _JaxCut:
    """One case: the params, and, run at the first need, the JAX
    package's simulator and its state after the case's quanta (megarun,
    jitted)."""

    def __init__(self, name):
        T, (fn, kw), over, quanta = CASES[name]
        self.name = name
        self.over = {"general/total_cores": T, **over}
        self.jp, self.tp = _params(T, over)
        self.trace_kw = (fn, dict(num_tiles=T, **kw))
        self.quanta = quanta
        self._state = None
        self._port = None

    def port(self):
        """The port's cut and its trace arrays (run once, shared)."""
        if self._port is None:
            self._port = _port_cut(self, with_trace=True)
        return self._port

    @property
    def state(self):
        if self._state is None:
            fn, kw = self.trace_kw
            self.sim = JaxSimulator(self.jp, getattr(jax_synth, fn)(**kw))
            self._state = jax.device_get(jquantum.megarun(
                self.jp, self.sim.state, self.sim.trace, self.quanta))
        return self._state

    def inputs(self, **extra):
        _, trace = self.port()
        return ref.inputs(self.over, trace, quanta=self.quanta, **extra)

    def check(self, tst):
        """Every leaf of the port's cut ``tst`` equal to the JAX
        package's (torch_jax_pins: its pins, or its run)."""
        ref.check("test_torch_scale", self.name,
                  convert.state_to_numpy(tst),
                  lambda: convert.leaves_to_numpy(self.state),
                  self.inputs(), live=self.name in LIVE)


@pytest.fixture(scope="module")
def jax_cut():
    runs = {}

    def get(name):
        if name not in runs:
            runs[name] = _JaxCut(name)
        return runs[name]
    return get


def _port_cut(cut, with_trace=False):
    fn, kw = cut.trace_kw
    tsim = Simulator(cut.tp, getattr(synth, fn)(**kw), device="cpu")
    st = tquantum.megarun(cut.tp, tsim.state, tsim.trace, cut.quanta)
    return (st, tsim.trace) if with_trace else st


@pytest.mark.parametrize("name", sorted(CASES))
def test_cut_run_matches_jax(name, jax_cut):
    cut = jax_cut(name)
    T = cut.tp.num_tiles
    H = max(1024, 16 * T)
    dense_tables = T * H <= tdense.DENSE_MAX_ELEMS
    assert dense_tables == (T <= 512)
    tst, _ = cut.port()
    assert int(tst.ctr_quantum) == cut.quanta
    assert not bool(tst.done.all())
    cut.check(tst)
    assert int(tst.ctr_conflict) > 0
    if "chain12" in name:
        assert int(tst.ctr_resolve) > 0


def test_floor_table_duplicates_take_last_row(jax_cut, monkeypatch):
    """The shared-readers cut at T = 1024 writes floor-table slots from
    two or more rows in one conflict round, and on some of them the last
    row's availability time is not the group's largest: the dense
    form's group max would leave another table.  Counted from each
    round's own (hidx, win, [line, t]) operands, on which the port's
    table must equal the JAX function's.  The table lives for one
    resolve pass, and no later round of these passes reads a slot whose
    value the order decides, so the leaves alone would not show the
    order; they must equal the JAX package's all the same."""
    cut = jax_cut("shared_readers1024")
    rounds = []
    orig = tdense.stacked_set_table

    def record(idx, mask, vals, tbl):
        out = orig(idx, mask, vals, tbl)
        rounds.append((idx, mask, vals, tbl, out))
        return out

    monkeypatch.setattr(tdense, "stacked_set_table", record)
    tst = _port_cut(cut)
    assert len(rounds) == int(tst.ctr_conflict) > 0   # one per round
    dup_slots = differ_rounds = 0
    for idx, mask, vals, tbl, out in rounds:
        slots, count = torch.unique(idx[mask], return_counts=True)
        dup_slots += int((count > 1).sum())
        # The dense form: per slot the max line and the max time of the
        # rows that write it.
        H = tbl.shape[1]
        oh = tdense.onehot(idx, H) & mask[:, None]
        group = torch.stack([
            torch.amax(torch.where(oh, vals[0][:, None], -1), dim=0),
            torch.amax(torch.where(oh, vals[1][:, None], 0), dim=0)])
        dense_tbl = torch.where(oh.any(dim=0)[None, :], group, tbl)
        differ_rounds += int(not torch.equal(dense_tbl, out))
        want = jdense.stacked_set_table(
            jnp.asarray(idx.numpy()), jnp.asarray(mask.numpy()),
            jnp.asarray(vals.numpy()), jnp.asarray(tbl.numpy()))
        np.testing.assert_array_equal(np.asarray(want), out.numpy())
    assert dup_slots > 0 and differ_rounds > 0, (dup_slots, differ_rounds)
    cut.check(tst)


def test_carry_across_resolve_t1024(jax_cut):
    """The chain-12 cut, opened into its next quantum and cut after the
    local advance (banked chains no resolve pass has served), carried
    through ``convert`` and one resolve pass: every state equal to the
    JAX package's (its pins, or its run from its own cut)."""
    cut = jax_cut("radix1024_chain12")
    jp, tp = cut.jp, cut.tp
    tcut, ttr = cut.port()
    cut.check(tcut)
    st = tcut._replace(boundary=tquantum.next_boundary(tp, tcut),
                       ctr_quantum=tcut.ctr_quantum + 1)
    tmid = tcore.local_advance(tp, st, ttr)
    assert bool((tmid.mq_count > 0).any()), "the cut holds no chain"
    jax_states = {}

    def jax_mid():
        jst = jax.device_put(cut.state)
        jst = jst._replace(boundary=jquantum.next_boundary(jp, jst),
                           ctr_quantum=jst.ctr_quantum + 1)
        jax_states["mid"] = jax.jit(
            lambda s: jcore.local_advance(jp, s, cut.sim.trace))(jst)
        return convert.leaves_to_numpy(jax.device_get(jax_states["mid"]))

    def jax_res():
        if "mid" not in jax_states:
            jax_mid()
        return convert.leaves_to_numpy(jax.device_get(jax.jit(
            lambda s: jresolve.resolve(jp, s))(jax_states["mid"])))

    leaves = ref.check("test_torch_scale", "carry_mid",
                       convert.state_to_numpy(tmid), jax_mid,
                       cut.inputs(which="mid"), live=cut.name in LIVE)
    tst = convert.state_from_numpy(tp, leaves, "cpu")
    _assert_leaves_equal(leaves, convert.state_to_numpy(tst))
    ref.check("test_torch_scale", "carry_res",
              convert.state_to_numpy(tresolve.resolve(tp, tst)), jax_res,
              cut.inputs(which="res"), live=cut.name in LIVE)


@pytest.mark.parametrize("T", [256, 512, 1024, 2048, 4096])
def test_check_slice_admits_one_card_tile_counts(T):
    """No tile cap but the directory owner field's (8,191 tiles): the
    default config at T = 256, 512, 1024, 2048 and 4096, chain replay
    off and on, on the CPU and (for the construction check alone) on
    CUDA, where past 1,024 tiles the chain replay takes
    ``chain_classify``'s grid form."""
    for chain in (0, 12):
        cfg = load_config()
        cfg.set("general/total_cores", T)
        cfg.set("tpu/miss_chain", chain)
        params = SimParams.from_config(cfg)
        for device in ("cpu", "cuda"):
            check_slice(params, device=torch.device(device))


@pytest.mark.slow
@pytest.mark.parametrize("chain,rounds,completion_ps", [
    (0, 1537, 57_500_000), (12, 336, 56_706_000)])
def test_radix1024_keys1_whole_run(chain, rounds, completion_ps):
    """The whole keys-1 run on the default directory (2 GB of sharer
    words), pinned at the JAX package's CPU values."""
    cfg = load_config()
    cfg.set("general/total_cores", 1024)
    cfg.set("tpu/block_events", 4)
    cfg.set("tpu/miss_chain", chain)
    params = SimParams.from_config(cfg)
    sim = Simulator(params, synth.gen_radix(1024, keys_per_tile=1, radix=64,
                                            seed=0), device="cpu")
    s = sim.run()
    assert bool(s.done.all())
    assert int(sim.state.round_ctr) == rounds
    assert s.completion_time_ps == completion_ps
