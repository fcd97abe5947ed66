"""PyTorch port, tile sharding with replicated state (``tpu/tile_shards`` =
S > 1): S gloo ranks on the host (parallel.mesh.launch), each holding the
whole state, walking its own T/S tiles (kernels.window's
run_window_sharded / run_fast_forward_sharded) and taking the quantum
barrier's minimum over the ranks.

The contract is the JAX package's (tests/test_sharding.py): a sharded
run ends equal to the unsharded one on every SimState leaf and round
counter, and so to the JAX package's run (tolerance 0: the engine is
all-integer).  One launch per shard count runs every case of that count
(tests/torch_shard_ranks.py), each rank with one intra-op thread and a
timeout of its own, and the ranks then share the unsharded runs:

  * fft8 at S = 8, one tile per shard (test_sharding's degenerate width);
  * radix8 at S = 2 and 4 at chain 0, and at S = 2 at chain 12;
  * radix8 at fast_forward 4, span 1000 ns, S = 2 (the sharded
    fast-forward walk);
  * radix8 under a mixed model list at S = 2, whose shards hold different
    mixes (the walk reads the iocoom mask from its slice's first tile);
  * the thread trace under ATAC on both networks at S = 2 (SPAWN landing
    legs read ATAC's tables by global tile id).

The JAX package runs fft8 at ``tile_shards = 8`` live (conftest's 8
virtual CPU devices), and the others are held to its recorded pins
(tests/torch_jax_ref.py).  Op by op: the shard-local operand slices
against the JAX functions at a concrete shard index; the refusals; the
launcher's failures; a deadlock raised on every rank;
``run_simulation`` with a group; ``cli run`` with
``--tpu/tile_shards=2 --device cpu``.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from graphite_tpu_torch import cli
from graphite_tpu_torch.engine import quantum
from graphite_tpu_torch.engine.kernels import operands as toperands
from graphite_tpu_torch.engine.kernels import window as twin
from graphite_tpu_torch.engine.sim import Simulator
from graphite_tpu_torch.events import synth
from graphite_tpu_torch.parallel import mesh

import torch_jax_ref as ref
import torch_shard_ranks as ranks

MODULE = "test_torch_sharding"
MAX_STEPS = 4096
LAUNCH_TIMEOUT_S = 300.0
RADIX8 = ("gen_radix", dict(num_tiles=8, keys_per_tile=8, radix=16,
                            seed=3))
RADIX8_FF = ("gen_radix", dict(num_tiles=8, keys_per_tile=32, radix=16,
                               seed=3))
FFT8 = ("gen_fft", dict(num_tiles=8, points_per_tile=32))
THREADS8 = ("gen_threads_oversubscribed", dict(
    num_streams=8, compute_blocks=3, cost_cycles=100, yields=2))
MIXED = {"tile/model_list": "<3,simple,T1,T1,T1>, <5,iocoom,T1,T1,T1>"}
ATAC = {"network/memory": "atac", "network/user": "atac"}

# name: (shards, (T, trace, config overrides))
CASES = {
    "fft8_s8": (8, (8, FFT8, {})),
    "radix8_s2": (2, (8, RADIX8, {})),
    "radix8_s4": (4, (8, RADIX8, {})),
    "radix8_chain12_s2": (2, (8, RADIX8, {"tpu/miss_chain": 12})),
    "radix8_ff4_span1000_s2": (2, (8, RADIX8_FF, {
        "tpu/fast_forward": 4, "tpu/fast_forward_span": 1000})),
    "radix8_mixed_s2": (2, (8, RADIX8, MIXED)),
    "threads8_atac_s2": (2, (8, THREADS8, ATAC)),
}
LIVE = ("fft8_s8",)
# The JAX package's own sharded walk cannot run a mixed model list: it
# masks the shard's T/S tiles with the whole [T] iocoom mask and raises
# (a broadcast of [T/S, K] against [T, 1]).  That case is held to the
# JAX package's unsharded run, which a sharded run must equal.
JAX_SHARDS = {"radix8_mixed_s2": 1}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# What else a shard count's launch runs on its group after its cases
# (torch_shard_ranks.run_cases): (key, function, args).
UNSPAWNED2 = (2, ("gen_unspawned", dict(num_tiles=2)), {})
EXTRAS = {
    2: (("deadlock", "deadlocks", (UNSPAWNED2, 64)),),
    4: (("summary", "summary", (CASES["radix8_s4"][1], MAX_STEPS)),),
}


@functools.lru_cache(maxsize=None)
def _sharded(shards):
    """Every case of ``shards`` shards, one launch: per rank, per case,
    the end leaves (rank 0) or their digests (the others), and the
    results of that count's ``EXTRAS``."""
    cases = {n: c for n, (s, c) in CASES.items() if s == shards}
    return mesh.launch(ranks.run_cases, shards, device="cpu",
                       timeout_s=LAUNCH_TIMEOUT_S, threads=1,
                       args=(cases, MAX_STEPS, EXTRAS.get(shards, ())))


def _solo(name):
    """The unsharded port run of case ``name``, made by one of the ranks of
    its shard count's launch after its sharded runs."""
    solo = [r["solo"][name] for r in _sharded(CASES[name][0])
            if name in r["solo"]]
    assert len(solo) == 1, name
    return solo[0]


def _leaves(name):
    shards = CASES[name][0]
    return _sharded(shards)[0][name][0]


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_run_equals_unsharded(name):
    """Every leaf and round counter of the sharded run equals the
    unsharded run's, on every rank."""
    shards = CASES[name][0]
    runs = _sharded(shards)
    leaves = runs[0][name][0]
    ref.assert_leaves_equal(_solo(name), leaves)
    want = {k: ref.digest(v) for k, v in leaves.items()}
    for rank in range(1, shards):
        assert runs[rank][name][0] == want, f"rank {rank}"
    assert int(leaves["round_ctr"]) > 0


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_run_matches_jax(name):
    """The sharded run against the JAX package's run at the same
    ``tile_shards`` (shard_map over the virtual CPU devices; unsharded
    where the JAX package cannot shard, ``JAX_SHARDS``)."""
    shards, (T, gen, over) = CASES[name]
    trace = ranks.trace(gen)
    full = {"general/total_cores": T,
            "tpu/tile_shards": JAX_SHARDS.get(name, shards), **over}

    def jax_leaves():
        import jax
        from graphite_tpu.config import load_config as jax_load_config
        from graphite_tpu.engine.sim import Simulator as JaxSimulator
        from graphite_tpu.events.schema import Trace as JTrace
        from graphite_tpu.params import SimParams as JaxSimParams
        from graphite_tpu_torch import convert
        cj = jax_load_config()
        for k, v in full.items():
            cj.set(k, str(v) if k == "tpu/tile_shards" else v)
        jsim = JaxSimulator(JaxSimParams.from_config(cj), JTrace(
            ops=trace.ops, addr=trace.addr, arg=trace.arg, arg2=trace.arg2))
        jsim.run(max_steps=MAX_STEPS)
        return convert.leaves_to_numpy(jax.device_get(jsim.state))

    ref.check(MODULE, name, _leaves(name), jax_leaves,
              ref.inputs(full, trace, steps=MAX_STEPS), live=name in LIVE)


# ------------------------------------------------ the shard-local slices

def _jax_slices(kind, arrays, shards):
    import jax.numpy as jnp
    from graphite_tpu.engine.kernels import window as jwin
    cls, fn = ((jwin.WindowIn, jwin.shard_local_window_in)
               if kind == "window" else (jwin.FFIn, jwin.shard_local_ff_in))
    jin = cls(**{f: (jnp.asarray(arrays[f]) if arrays.get(f) is not None
                     else None) for f in cls._fields})
    T = arrays["clock"].shape[0]
    return [fn(jin, i, T // shards) for i in range(shards)]


SLICE_CONFIGS = {
    "default": {},
    "p12": {"tpu/miss_chain": 12},
    "iocoom_mixed": {**MIXED, "tpu/miss_chain": 12},
    "shared_l2": {"caching_protocol/type": "pr_l1_sh_l2_msi"},
}


def _assert_fresh(cut, whole, name):
    """A cut the CUDA walk writes in place shares no memory with the
    caller's tensor (a cut along axis 0 of a contiguous tensor would
    otherwise be a view of it)."""
    if whole is None:
        return
    assert cut.untyped_storage().data_ptr() != \
        whole.untyped_storage().data_ptr(), name


@pytest.mark.parametrize("config", sorted(SLICE_CONFIGS))
@pytest.mark.parametrize("shards", [2, 8])
def test_shard_local_window_in_matches_jax(config, shards):
    """Every walk operand cut to each shard's tiles along its axis, as the
    JAX ``shard_local_window_in`` cuts it at that concrete shard index;
    the cuts are contiguous, and those the kernel writes are copies."""
    tp = ranks.params(8, 1, SLICE_CONFIGS[config])
    gen = (toperands.iocoom_window_arrays if config == "iocoom_mixed"
           else toperands.seeded_window_arrays)
    arrays = gen(tp, tp.block_events, 1)
    wi = toperands.window_in_from_numpy(arrays, "cpu")
    assert twin.WindowIn._fields == tuple(twin.WINDOW_IN_AXES)
    for i, jl in enumerate(_jax_slices("window", arrays, shards)):
        tl = twin.shard_local_window_in(wi, i, 8 // shards)
        for f in twin.WindowIn._fields:
            a, b = getattr(jl, f), getattr(tl, f)
            if a is None:
                assert b is None, f
                continue
            assert b.is_contiguous(), f
            if f in twin.INPLACE_FIELDS:
                _assert_fresh(b, getattr(wi, f), f)
            np.testing.assert_array_equal(np.asarray(a), b.numpy(),
                                          err_msg=f"{f} shard {i}")


@pytest.mark.parametrize("shards", [2, 8])
def test_shard_local_ff_in_matches_jax(shards):
    """The fast-forward operands, as :func:`test_shard_local_window_in_
    matches_jax` holds the walk's."""
    tp = ranks.params(8, 1, {"tpu/fast_forward": 4})
    arrays = toperands.random_ff_arrays(tp, 64, 2)
    fi = toperands.ff_in_from_numpy(arrays, "cpu")
    assert twin.FFIn._fields == tuple(twin.FF_IN_AXES)
    for i, jl in enumerate(_jax_slices("ff", arrays, shards)):
        tl = twin.shard_local_ff_in(fi, i, 8 // shards)
        for f in twin.FFIn._fields:
            if f in twin.FF_INPLACE_FIELDS:
                _assert_fresh(getattr(tl, f), getattr(fi, f), f)
            np.testing.assert_array_equal(
                np.asarray(getattr(jl, f)), getattr(tl, f).numpy(),
                err_msg=f"{f} shard {i}")


def test_axis_tables_are_the_jax_packages():
    from graphite_tpu.engine.kernels import window as jwin
    assert twin.WINDOW_IN_AXES == jwin.WINDOW_IN_AXES
    assert twin.WINDOW_OUT_AXES == jwin.WINDOW_OUT_AXES
    assert twin.FF_IN_AXES == jwin.FF_IN_AXES
    assert twin.FF_OUT_AXES == jwin.FF_OUT_AXES


# ------------------------------------------------------------ refusals

def _refusal(kind):
    trace = synth.gen_radix(num_tiles=8, keys_per_tile=8, radix=16, seed=0)
    cpu_group = mesh.ShardGroup(0, 2, None, "cpu")
    if kind == "resident":
        Simulator(ranks.params(8, 2, {"tpu/shard_state": "resident"}),
                  trace, device="cpu", group=cpu_group)
    elif kind == "no_group":
        Simulator(ranks.params(8, 2, {}), trace, device="cpu")
    elif kind == "group_size":
        Simulator(ranks.params(8, 4, {}), trace, device="cpu",
                  group=cpu_group)
    elif kind == "group_at_one_shard":
        Simulator(ranks.params(8, 1, {}), trace, device="cpu",
                  group=cpu_group)
    elif kind == "not_a_divisor":
        ranks.params(8, 3, {})


@pytest.mark.parametrize("kind,exc,match", [
    ("resident", NotImplementedError, "the resident slice"),
    ("no_group", ValueError, "needs a ShardGroup"),
    ("group_size", ValueError, "does not match"),
    ("group_at_one_shard", ValueError, "does not match"),
    ("not_a_divisor", Exception, "must divide the tile count"),
])
def test_refusals(kind, exc, match):
    with pytest.raises(exc, match=match):
        _refusal(kind)


def test_megarun_refuses_resident():
    p = ranks.params(8, 1, {})
    sim = Simulator(p, synth.gen_radix(num_tiles=8, keys_per_tile=8,
                                       radix=16, seed=0), device="cpu")
    with pytest.raises(ValueError, match="resident"):
        quantum.megarun(dataclasses.replace(p, shard_state="resident"),
                        sim.state, sim.trace, 1)


# ------------------------------------------------------------ the launcher

def test_launch_reports_the_failing_rank():
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed") as e:
        mesh.launch(ranks.fail_on, 2, device="cpu", timeout_s=120,
                    threads=1, args=(1,))
    assert "ArithmeticError: rank 1 fails on purpose" in str(e.value)


def test_launch_times_out():
    with pytest.raises(TimeoutError, match="did not report"):
        mesh.launch(ranks.hang, 2, device="cpu", timeout_s=1, threads=1)


def test_deadlock_raises_on_every_rank():
    """Every rank polls the same replicated state: the no-progress check
    fires on all of them alike (run by the 2-rank launch)."""
    got = [r["deadlock"] for r in _sharded(2)]
    assert got[0].startswith("DeadlockError") and got[0] == got[1]


def test_run_simulation_takes_the_group():
    """``run_simulation(..., group=...)`` on 4 ranks (run by the 4-rank
    launch): every rank's summary is the unsharded run's (host time and
    rate aside)."""
    got = [r["summary"] for r in _sharded(4)]
    want = ranks.summary(None, CASES["radix8_s4"][1], MAX_STEPS)
    assert want["all_done"] and all(g == want for g in got)


def test_cli_run_sharded_on_cpu(tmp_path, capsys):
    """``cli run --device cpu --tpu/tile_shards=2`` starts two gloo ranks;
    rank 0's summary is the unsharded run's (host time and MIPS aside)."""
    path = str(tmp_path / "t.npz")
    synth.gen_radix(num_tiles=8, keys_per_tile=8, radix=16,
                    seed=0).save(path)

    def summary(*extra):
        assert cli.main(["run", "--trace", path, "--device", "cpu",
                         *extra]) == 0
        return [ln for ln in capsys.readouterr().out.splitlines()
                if "Host Time" not in ln and "MIPS" not in ln]

    solo = summary()
    assert any("Completion Time" in ln for ln in solo)
    assert summary("--tpu/tile_shards=2") == solo
