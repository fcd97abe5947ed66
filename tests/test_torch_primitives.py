"""PyTorch port, model primitives, each against its JAX function on the
same random inputs (numpy, fixed seeds).  The engine is all-integer, so
every comparison is exact (tolerance 0), values and dtypes; ``uint64``
leaves of the JAX package are compared as int64 bit patterns.

``gpu``: the last-row-wins set on CUDA, run after run.  Run on the card
with ``python -m pytest -m gpu --noconftest tests/test_torch_primitives.py``
(the card's machine has no jax; there only the ``gpu`` tests run).
"""

import numpy as np
import pytest
import torch

try:
    import jax.numpy as jnp

    from graphite_tpu.config import load_config as jax_load_config
    from graphite_tpu.engine import cache as jcache
    from graphite_tpu.engine import dense as jdense
    from graphite_tpu.engine import directory as jdir
    from graphite_tpu.engine import noc as jnoc
    from graphite_tpu.engine import queue_models as jq
    from graphite_tpu.engine import resolve as jresolve
    from graphite_tpu.params import SimParams as JaxSimParams
except ImportError:     # the card's machine: only the gpu tests run there
    jnp = None
from graphite_tpu_torch import load_config
from graphite_tpu_torch.engine import cache as tcache
from graphite_tpu_torch.engine import dense as tdense
from graphite_tpu_torch.engine import directory as tdir
from graphite_tpu_torch.engine import noc as tnoc
from graphite_tpu_torch.engine import ops
from graphite_tpu_torch.engine import queue_models as tq
from graphite_tpu_torch.engine import resolve as tresolve
from graphite_tpu_torch.params import SimParams


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The engine's CPU path is thousands of tiny ops: one intra-op
    thread per test worker is faster than contending for every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.int64) if a.dtype == np.uint64 else a


def _eq(jx, tx, what=""):
    a, b = _np(jx), _np(tx)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b, err_msg=what)


def _t(a):
    return torch.from_numpy(np.array(a))


def _keys(rng, n):
    """int64 keys covering the whole 64-bit range, top bit included."""
    k = rng.integers(-(2**63), 2**63 - 1, size=n, dtype=np.int64)
    k[:4] = [-1, -(2**63), 2**63 - 1, 0]
    return k


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fmix64_matches_uint64(seed):
    k = _keys(np.random.default_rng(seed), 4096)
    j = jdense.fmix64(jnp.asarray(k.view(np.uint64)))
    _eq(j, tdense.fmix64(_t(k)))


@pytest.mark.parametrize("n", [1024, 1000, 4096, 3, 2**40 + 7])
def test_umod64_matches_uint64_modulo(n):
    k = _keys(np.random.default_rng(n % 97), 4096)
    j = (jdense.fmix64(jnp.asarray(k.view(np.uint64)))
         % jnp.uint64(n)).astype(jnp.int64)
    _eq(j, ops.umod64(tdense.fmix64(_t(k)), n))


@pytest.mark.parametrize("op", ["set", "add", "max", "min"])
def test_drop_scatter_matches_mode_drop(op):
    rng = np.random.default_rng(7)
    base = rng.integers(-50, 50, size=(6, 9)).astype(np.int64)
    r = rng.integers(-2, 8, size=40)
    c = rng.integers(-1, 11, size=40)
    v = rng.integers(-100, 100, size=40).astype(np.int64)
    if op == "set":      # one writer per element (the engine's contract)
        _, first = np.unique(np.where(r < 0, r + 6, r) * 100
                             + np.where(c < 0, c + 9, c), return_index=True)
        r, c, v = r[first], c[first], v[first]
    j = getattr(jnp.asarray(base).at[jnp.asarray(r), jnp.asarray(c)], op)(
        jnp.asarray(v), mode="drop")
    _eq(j, ops.scatter(_t(base), (_t(r), _t(c)), _t(v), op))


def test_elect_and_grouped_rank():
    rng = np.random.default_rng(3)
    R, size = 64, 1024
    active = rng.random(R) < 0.7
    issue = rng.integers(0, 10_000, size=R).astype(np.int64)
    idx = rng.integers(0, 40, size=R).astype(np.int32)
    jk = jdense.fcfs_keys(jnp.asarray(active), jnp.asarray(issue))
    tk = tdense.fcfs_keys(_t(active), _t(issue))
    _eq(jk, tk)
    _eq(jdense.elect(jnp.asarray(active), jk, jnp.asarray(idx), size),
        tdense.elect(_t(active), tk, _t(idx), size))
    grp = rng.integers(0, 9, size=R).astype(np.int32)
    key = rng.integers(0, 30, size=R).astype(np.int64)
    _eq(jdense.grouped_rank(jnp.asarray(grp), jnp.asarray(key),
                            jnp.asarray(active)),
        tdense.grouped_rank(_t(grp), _t(key), _t(active)))
    line = rng.integers(0, 2**31, size=R).astype(np.int64)
    _eq(jdense.home_fold(jnp.asarray(line), 64),
        tdense.home_fold(_t(line), 64))


def test_elect_above_the_dense_cap():
    """R = 1024 rows into 16,384 slots (R * size = 2^24, above the 2^22
    dense cap: the scatter-min table) with colliding slots and equal
    issue times, against the JAX election."""
    rng = np.random.default_rng(11)
    R, size = 1024, 16384
    assert R * size > tdense.DENSE_MAX_ELEMS
    active = rng.random(R) < 0.8
    issue = rng.integers(0, 50, size=R).astype(np.int64)
    idx = rng.integers(0, 300, size=R).astype(np.int32)
    idx[:40] = 7                                   # one crowded slot
    idx[-3:] = size - 1
    jk = jdense.fcfs_keys(jnp.asarray(active), jnp.asarray(issue))
    tk = tdense.fcfs_keys(_t(active), _t(issue))
    _eq(jk, tk)
    got = tdense.elect(_t(active), tk, _t(idx), size)
    _eq(jdense.elect(jnp.asarray(active), jk, jnp.asarray(idx), size), got)
    assert 0 < int(got.sum()) < int(active.sum())


def test_stacked_max_table_matches_jax():
    """Three fields over one shared index, masked rows writing the max
    identity, duplicate slots, against the JAX stacked_max_table."""
    rng = np.random.default_rng(12)
    size, R = 512, 700
    idx = rng.integers(0, 96, size=R).astype(np.int64)
    mask = rng.random(R) < 0.5
    vals = rng.integers(-1, 1 << 40, size=(3, R)).astype(np.int64)
    vals = np.where(mask[None, :], vals, -1)
    _eq(jdense.stacked_max_table(jnp.asarray(idx), jnp.asarray(vals), size,
                                 jnp.int64(-1)),
        tdense.stacked_max_table(_t(idx), _t(vals), size, -1))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scatter_last_matches_jax_set(seed):
    """The last-row-wins set against JAX's .at[].set(mode="drop") on the
    CPU, whose update order keeps the last row: many rows per element,
    negative indices that wrap, out-of-range and masked rows."""
    rng = np.random.default_rng(20 + seed)
    base = rng.integers(-50, 50, size=(6, 9)).astype(np.int64)
    n = 400
    r = rng.integers(-2, 8, size=n)
    c = rng.integers(-1, 11, size=n)
    v = rng.integers(-100, 100, size=n).astype(np.int64)
    mask = rng.random(n) < 0.7
    rr = np.where(mask, r, 6)                      # masked rows: dropped
    j = jnp.asarray(base).at[jnp.asarray(rr), jnp.asarray(c)].set(
        jnp.asarray(v), mode="drop")
    _eq(j, ops.scatter_last(_t(base), (_t(r), _t(c)), _t(v), mask=_t(mask)))


def test_stacked_set_table_takes_the_last_row_like_jax():
    """Duplicate indices among the masked rows: every field from the last
    such row, as the JAX stacked_set_table on the CPU leaves it."""
    rng = np.random.default_rng(8)
    H, R = 64, 300
    idx = rng.integers(0, 20, size=R).astype(np.int64)
    mask = rng.random(R) < 0.6
    vals = rng.integers(-5, 1 << 40, size=(2, R)).astype(np.int64)
    tbl = rng.integers(-1, 1 << 30, size=(2, H)).astype(np.int64)
    got = tdense.stacked_set_table(_t(idx), _t(mask), _t(vals), _t(tbl))
    _eq(jdense.stacked_set_table(jnp.asarray(idx), jnp.asarray(mask),
                                 jnp.asarray(vals), jnp.asarray(tbl)), got)
    last = {}
    for r in range(R):
        if mask[r]:
            last[int(idx[r])] = r
    for slot, r in last.items():
        assert got[:, slot].tolist() == vals[:, r].tolist()


@pytest.mark.gpu
def test_scatter_last_is_deterministic_on_cuda():
    """The last-row-wins set on CUDA, 100 times over heavy duplicates
    (2^16 rows into 64 elements of each of two fields): the same table
    every time, and the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(9)
    H, R = 64, 1 << 16
    idx = torch.from_numpy(rng.integers(0, H, size=R))
    mask = torch.from_numpy(rng.random(R) < 0.9)
    vals = torch.from_numpy(rng.integers(0, 1 << 40, size=(2, R)))
    tbl = torch.full((2, H), -1, dtype=torch.int64)
    want = tdense.stacked_set_table(idx, mask, vals, tbl)
    cu = [x.cuda() for x in (idx, mask, vals, tbl)]
    for _ in range(100):
        got = tdense.stacked_set_table(*cu)
        assert torch.equal(got.cpu(), want)


def _params(T=8, **over):
    cj, ct = jax_load_config(), load_config()
    for c in (cj, ct):
        c.set("general/total_cores", T)
        for k, v in over.items():
            c.set(k, v)
    return JaxSimParams.from_config(cj), SimParams.from_config(ct)


def _random_cache(rng, A, T, S, lines):
    tags = rng.choice(lines, size=(A, T, S)) % (1 << 31)
    st = rng.choice([0, 1, 2, 3, 4], size=(A, T, S))
    stamps = rng.integers(0, 1 << 29, size=(A, T, S))
    word = ((tags << 32) | (stamps << 3) | st).astype(np.int64)
    rr = rng.integers(0, A, size=(T, S)).astype(np.int32)
    return word, rr


@pytest.mark.parametrize("replacement", ["lru", "round_robin"])
def test_probe_touch_fill(replacement):
    rng = np.random.default_rng(11)
    A, T, S = 4, 8, 16
    lines = rng.integers(0, 4096, size=40).astype(np.int64)
    word, rr = _random_cache(rng, A, T, S, lines)
    jc = jcache.CacheArrays(jnp.asarray(word), jnp.asarray(rr))
    tc = tcache.CacheArrays(_t(word), _t(rr))
    # probe: [T] and [T, K]
    for shape in ((T,), (T, 5)):
        ln = rng.choice(lines, size=shape)
        jp = jcache.probe(jc, jnp.asarray(ln), S)
        tp = tcache.probe(tc, _t(ln), S)
        _eq(jp.hit, tp.hit)
        _eq(jp.way, tp.way)
        _eq(jp.state.astype(jnp.int32), tp.state)
        _eq(jp.set_idx, tp.set_idx)
        _eq(jp.row, tp.row)
    # touch ([T, K] with duplicate (way, set) pairs: scatter-max)
    ln = rng.choice(lines[:6], size=(T, 5))
    jp = jcache.probe(jc, jnp.asarray(ln), S)
    tp = tcache.probe(tc, _t(ln), S)
    act = rng.random((T, 5)) < 0.8
    stamp = (np.int32(640) + np.arange(5))[None, :]
    jt = jcache.touch(jc, jp.set_idx, jp.way, jnp.asarray(act) & jp.hit,
                      jnp.take_along_axis(jp.row, jp.way[None], 0)[0],
                      jnp.asarray(stamp))
    tt = tcache.touch(tc, tp.set_idx, tp.way, _t(act) & tp.hit,
                      tcache.row_word(tp.row, tp.way), _t(stamp))
    _eq(jt.word, tt.word)
    # fill (one per tile)
    ln = rng.choice(lines, size=T)
    ns = rng.choice([1, 4], size=T).astype(np.int32)
    act = rng.random(T) < 0.8
    jf = jcache.fill(jc, jnp.asarray(ln), jnp.asarray(ns), jnp.asarray(act),
                     S, replacement, jnp.int32(12345))
    tf = tcache.fill(tc, _t(ln), _t(ns), _t(act), S, replacement,
                     torch.tensor(12345, dtype=torch.int32))
    _eq(jf.cache.word, tf.cache.word)
    _eq(jf.cache.rr_ptr, tf.cache.rr_ptr)
    _eq(jf.way, tf.way)
    _eq(jf.victim_tag, tf.victim_tag)
    _eq(jf.victim_state, tf.victim_state)
    # coherence deliveries ([T, J] lists, lowest target wins)
    J = 6
    dl = rng.choice(lines, size=(T, J))
    dv = rng.random((T, J)) < 0.7
    dt = rng.choice([0, 1], size=(T, J)).astype(np.int32)
    _eq(jcache.invalidate_by_value(jc, jnp.asarray(dl), jnp.asarray(dv),
                                   jnp.asarray(dt)).word,
        tcache.invalidate_by_value(tc, _t(dl), _t(dv), _t(dt)).word)


@pytest.mark.parametrize("T", [8, 64, 100])
def test_msi_transition_and_bitmaps(T):
    rng = np.random.default_rng(T)
    W = (T + 63) // 64
    K = T
    is_ex = rng.random(K) < 0.5
    req = np.arange(K, dtype=np.int64)
    state = rng.choice([0, 1, 4], size=K).astype(np.int32)
    owner = np.where(state == 4, rng.integers(-1, T, size=K), -1).astype(
        np.int32)
    sh = rng.integers(-(2**63), 2**63 - 1, size=(K, W), dtype=np.int64)
    ja = jdir.msi_transition(jnp.asarray(is_ex), jnp.asarray(req),
                             jnp.asarray(state), jnp.asarray(owner),
                             jnp.asarray(sh.view(np.uint64)), W)
    ta = tdir.msi_transition(_t(is_ex), _t(req), _t(state), _t(owner),
                             _t(sh), W)
    for f in ja._fields:
        _eq(getattr(ja, f), getattr(ta, f), f)
    _eq(jdir.make_tile_bit(jnp.asarray(req), W),
        tdir.make_tile_bit(_t(req), W))
    _eq(jdir.bitmap_to_bool(jnp.asarray(sh.view(np.uint64)), T),
        tdir.bitmap_to_bool(_t(sh), T))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_fcfs_ring_and_occupy_history_tree(seed):
    rng = np.random.default_rng(seed)
    K, R, C = 32, 8, 16
    res = rng.integers(0, C, size=K).astype(np.int32)
    arr = rng.integers(0, 5000, size=K).astype(np.int64)
    svc = np.full(K, 300, dtype=np.int64)
    valid = rng.random(K) < 0.7
    rs = np.sort(rng.integers(0, 6000, size=(R, C)), axis=0).astype(np.int64)
    re = (rs + rng.integers(0, 800, size=(R, C))).astype(np.int64)
    rp = rng.integers(0, 20, size=C).astype(np.int32)
    occ_v = rng.random(K) < 0.3
    mom = np.zeros((6, C))
    jo = jq.probe("history_tree", jnp.asarray(res), jnp.asarray(arr),
                  jnp.asarray(svc), jnp.asarray(valid), jnp.asarray(rs),
                  jnp.asarray(re), jnp.asarray(rp), jnp.asarray(mom),
                  occ_res=jnp.asarray(res), occ_arr=jnp.asarray(arr),
                  occ_svc=jnp.asarray(svc), occ_valid=jnp.asarray(occ_v))
    to = tq.probe("history_tree", _t(res), _t(arr), _t(svc), _t(valid),
                  _t(rs), _t(re), _t(rp), _t(mom), occ_res=_t(res),
                  occ_arr=_t(arr), occ_svc=_t(svc), occ_valid=_t(occ_v))
    for a, b in zip(jo, to):
        _eq(a, b)
    jo = jq.occupy("history_tree", jnp.asarray(rs), jnp.asarray(re),
                   jnp.asarray(rp), jnp.asarray(mom), jnp.asarray(res),
                   jnp.asarray(arr), 300, jnp.asarray(valid))
    to = tq.occupy("history_tree", _t(rs), _t(re), _t(rp), _t(mom),
                   _t(res), _t(arr), 300, _t(valid))
    for a, b in zip(jo, to):
        _eq(a, b)
    x = rng.integers(0, 2, size=K).astype(np.int32)
    _eq(jq._cumsum_doubling(jnp.asarray(x)), tq._cumsum_doubling(_t(x)))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_fcfs_ring_record_split_matches_jax(seed):
    """record_split = 2 (the chain replay's probe): two merged busy
    intervals per controller, below and above its batch midpoint."""
    rng = np.random.default_rng(100 + seed)
    K, R, C = 32, 8, 8
    res = rng.integers(0, C, size=K).astype(np.int32)
    arr = rng.integers(0, 400_000, size=K).astype(np.int64)
    svc = np.full(K, 300, dtype=np.int64)
    valid = rng.random(K) < 0.8
    rs = np.sort(rng.integers(0, 6000, size=(R, C)), axis=0).astype(np.int64)
    re = (rs + rng.integers(0, 800, size=(R, C))).astype(np.int64)
    rp = rng.integers(0, 20, size=C).astype(np.int32)
    occ_v = rng.random(K) < 0.3
    mom = np.zeros((6, C))
    jo = jq.probe("history_tree", jnp.asarray(res), jnp.asarray(arr),
                  jnp.asarray(svc), jnp.asarray(valid), jnp.asarray(rs),
                  jnp.asarray(re), jnp.asarray(rp), jnp.asarray(mom),
                  occ_res=jnp.asarray(res), occ_arr=jnp.asarray(arr),
                  occ_svc=jnp.asarray(svc), occ_valid=jnp.asarray(occ_v),
                  record_split=2)
    to = tq.probe("history_tree", _t(res), _t(arr), _t(svc), _t(valid),
                  _t(rs), _t(re), _t(rp), _t(mom), occ_res=_t(res),
                  occ_arr=_t(arr), occ_svc=_t(svc), occ_valid=_t(occ_v),
                  record_split=2)
    for a, b in zip(jo, to):
        _eq(a, b)


def test_stacked_set_table_matches_jax():
    rng = np.random.default_rng(7)
    H, R = 64, 40
    idx = rng.permutation(H)[:R].astype(np.int32)     # one row per slot
    mask = rng.random(R) < 0.6
    vals = rng.integers(-5, 1 << 40, size=(2, R)).astype(np.int64)
    tbl = rng.integers(-1, 1 << 30, size=(2, H)).astype(np.int64)
    _eq(jdense.stacked_set_table(jnp.asarray(idx), jnp.asarray(mask),
                                 jnp.asarray(vals), jnp.asarray(tbl)),
        tdense.stacked_set_table(_t(idx).to(torch.int64), _t(mask),
                                 _t(vals), _t(tbl)))


def test_home_dset_and_noc_legs():
    jp, tp = _params(T=64)
    rng = np.random.default_rng(5)
    line = rng.integers(0, 2**31, size=256).astype(np.int64)
    _eq(jresolve.home_of_line(jp, jnp.asarray(line)),
        tresolve.home_of_line(tp, _t(line)))
    _eq(jresolve.dir_set_of_line(jp, jnp.asarray(line)),
        tresolve.dir_set_of_line(tp, _t(line)))
    src = rng.integers(0, 64, size=256)
    dst = rng.integers(0, 64, size=256).astype(np.int32)
    per = rng.integers(200, 1000, size=256).astype(np.int32)
    _eq(jnoc.unicast_ps(jp.net_memory, jnp.asarray(src), jnp.asarray(dst),
                        72, jnp.asarray(per), jp.mesh_width),
        tnoc.unicast_ps(tp.net_memory, _t(src), _t(dst), 72, _t(per),
                        tp.mesh_width))
    mask = rng.random((16, 64)) < 0.1
    _eq(jnoc.max_hop_to_mask_ps(jp.net_memory, jnp.asarray(src[:16]),
                                jnp.asarray(mask), 8, jnp.asarray(per[:16]),
                                jp.mesh_width),
        tnoc.max_hop_to_mask_ps(tp.net_memory, _t(src[:16]), _t(mask), 8,
                                _t(per[:16]), tp.mesh_width))
