"""PyTorch port, the network models against the JAX package on the CPU:
ATAC's geometry and pricing (``engine/noc_atac.py``), the exact FCFS
link queue (``queue_models.fcfs_start``), the contended hop-by-hop flight
(``engine/noc_flight.py``), and the plain chain step and window walk
under ATAC and the hop-by-hop mesh (the kernels' network branches).
Every comparison is exact (tolerance 0) on seeded numpy inputs; the
chain step's and the walk's against the JAX functions' outputs as
recorded for the same inputs, one walk case live
(tests/torch_jax_ref.check_outputs).

The ``gpu`` tests hold the CUDA kernels' network branches against the
plain forms on the card and skip here (they run there with
``python -m pytest -m gpu --noconftest tests/test_torch_noc.py``: the
JAX package is imported only inside the tests that compare against it).
"""

import collections
import functools

import numpy as np
import pytest
import torch

from graphite_tpu_torch import load_config
from graphite_tpu_torch.engine import noc, noc_atac, noc_flight, queue_models
from graphite_tpu_torch.engine.kernels import chain as tchain
from graphite_tpu_torch.engine.kernels import dispatch as tdispatch
from graphite_tpu_torch.engine.kernels import operands as toperands
from graphite_tpu_torch.engine.kernels import window as twin
from graphite_tpu_torch.engine.vparams import variant_params
from graphite_tpu_torch.params import SimParams

import torch_jax_ref as ref

MODULE = "test_torch_noc"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax():
    import jax
    import jax.numpy as jnp
    from graphite_tpu.config import load_config as jax_load_config
    from graphite_tpu.engine import noc as jnoc
    from graphite_tpu.engine import noc_atac as jatac
    from graphite_tpu.engine import noc_flight as jflight
    from graphite_tpu.engine import queue_models as jqueue
    from graphite_tpu.engine.kernels import chain as jchain
    from graphite_tpu.engine.kernels import window as jwin
    from graphite_tpu.engine.vparams import variant_params as jax_vp
    from graphite_tpu.params import SimParams as JaxSimParams
    return dict(jax=jax, jnp=jnp, jax_load_config=jax_load_config,
                jnoc=jnoc, jatac=jatac, jflight=jflight, jqueue=jqueue,
                jchain=jchain, jwin=jwin, jax_vp=jax_vp,
                JaxSimParams=JaxSimParams)


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


def _np(x):
    """A leaf as numpy, uint64 sharer words as int64 bits."""
    a = np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)
    return a.view(np.int64) if a.dtype == np.uint64 else a


def _eq(a, b, label=""):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape, (label, a.shape, b.shape)
    np.testing.assert_array_equal(a.astype(np.int64), b.astype(np.int64),
                                  err_msg=label)


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


def _atac(net="memory", cs=4, routing="cluster_based", rnet="star",
          aps=4):
    return {f"network/{net}": "atac", "network/atac/cluster_size": cs,
            "network/atac/global_routing_strategy": routing,
            "network/atac/receive_network_type": rnet,
            "network/atac/num_optical_access_points_per_cluster": aps}


# ---------------------------------------------------------- ATAC pricing

# (T, config): cluster size 4 (one access point per tile at four), one
# access point per cluster (ap_hops > 0), 16-tile clusters at T = 64
# (four access points of 2x2 sub-clusters), both routings and receive
# networks.
ATAC_VARIANTS = {
    "t16_cs4": (16, _atac()),
    "t16_cs4_ap1_btree": (16, _atac(aps=1, rnet="btree")),
    "t16_cs8_distance": (16, _atac(cs=8, routing="distance_based")),
    "t64_cs4_distance_btree": (64, _atac(routing="distance_based",
                                         rnet="btree")),
    "t64_cs16": (64, _atac(cs=16)),
    "t64_cs16_distance_ap1": (64, _atac(cs=16, routing="distance_based",
                                        aps=1)),
}


@pytest.mark.parametrize("variant", sorted(ATAC_VARIANTS))
def test_atac_pricing_matches_jax(variant):
    """geometry, unicast_ps and max_to_mask_ps on seeded tiles, periods,
    payloads and destination masks (some rows empty)."""
    J = _jax()
    jnp = J["jnp"]
    T, over = ATAC_VARIANTS[variant]
    jp, tp = _params(T, over)
    jnet, tnet = jp.net_memory, tp.net_memory
    assert tnet.atac.__dict__ == jnet.atac.__dict__
    for a, b in zip(J["jatac"].geometry(jnet.atac),
                    noc_atac.geometry(tnet.atac)):
        _eq(a, b, "geometry")
    cluster_of, ap_hops, _ = noc_atac.geometry(tnet.atac)
    if "ap1" in variant or "cs16" in variant or "cs8" in variant:
        assert int(ap_hops.max()) > 0
    rng = np.random.default_rng(T)
    K = 256
    src = rng.integers(0, T, K).astype(np.int32)
    dst = rng.integers(0, T, K).astype(np.int32)
    per = rng.choice([250, 500, 1000, 333], K).astype(np.int32)
    same = cluster_of.numpy()[src] == cluster_of.numpy()[dst]
    assert same.any() and (~same).any()
    for payload in (8, 72):
        j = J["jnoc"].unicast_ps(jnet, jnp.asarray(src), jnp.asarray(dst),
                                 payload, jnp.asarray(per), jp.mesh_width)
        t = noc.unicast_ps(tnet, torch.from_numpy(src),
                           torch.from_numpy(dst), payload,
                           torch.from_numpy(per), tp.mesh_width)
        _eq(j, t, f"unicast {payload}")
    mask = rng.random((K, T)) < rng.choice([0.0, 0.05, 0.3], K)[:, None]
    j = J["jnoc"].max_hop_to_mask_ps(jnet, jnp.asarray(src),
                                     jnp.asarray(mask), 8, jnp.asarray(per),
                                     jp.mesh_width)
    t = noc.max_hop_to_mask_ps(tnet, torch.from_numpy(src),
                               torch.from_numpy(mask), 8,
                               torch.from_numpy(per), tp.mesh_width)
    _eq(j, t, "max_to_mask")
    assert (t.numpy() == 0).any() and (t.numpy() > 0).any()


# ------------------------------------------------------ FCFS link queue

_Fcfs = collections.namedtuple("_Fcfs", "start end delay free_at")


def _fcfs(resource, arrival, service, valid, free_at):
    """The JAX package's ``fcfs`` (its FcfsResult fields) from the port's
    ``queue_models.fcfs_start``, composed as engine/noc_flight.py composes
    it: invalid rows take the resource id R, occupy nothing and get zero
    delay, and the horizon's max-scatter drops them (mode="drop")."""
    R = free_at.shape[0]
    res = torch.where(valid, resource.to(torch.int64), R)
    svc = torch.where(valid, service, 0)
    same = valid[None, :] & valid[:, None] & (res[None, :] == res[:, None])
    tie, eye = queue_models.fcfs_order(res.shape[0], res.device)
    start = queue_models.fcfs_start(
        same, arrival, svc, free_at[torch.clamp(res, max=R - 1)], tie, eye)
    end = start + svc
    lf = torch.cat([free_at, free_at.new_zeros(1)])
    lf.scatter_reduce_(0, res, torch.where(valid, end, 0), "amax")
    return _Fcfs(start=torch.where(valid, start, 0),
                 end=torch.where(valid, end, 0),
                 delay=torch.where(valid, start - arrival, 0),
                 free_at=lf[:R])


@pytest.mark.parametrize("seed", range(3))
def test_fcfs_matches_jax(seed):
    """Ties on arrival (broken by row), invalid rows (no delay, no
    occupancy, their resource ids out of range too), a carried horizon
    that some requests arrive under."""
    J = _jax()
    jnp = J["jnp"]
    rng = np.random.default_rng(seed)
    K, R = 48, 10
    res = rng.integers(0, R + 3 * (seed == 2), K).astype(np.int32)
    arr = (rng.integers(0, 8, K) * 1000).astype(np.int64)     # many ties
    svc = rng.integers(0, 3000, K).astype(np.int64)
    valid = (rng.random(K) < 0.8) & (res < R)
    free = rng.integers(0, 6000, R).astype(np.int64)
    j = J["jqueue"].fcfs(jnp.asarray(res), jnp.asarray(arr),
                         jnp.asarray(svc), jnp.asarray(valid),
                         jnp.asarray(free))
    t = _fcfs(*map(torch.from_numpy, (res, arr, svc, valid, free)))
    _assert_fields_equal(j, t, f"seed {seed}")
    assert (t.delay.numpy() > 0).any()


# ------------------------------------------------------- link flights

# (src, dst, depart, flits, mesh w, mesh h, T, active): the shapes of
# tests/test_noc_contention.py and a seeded batch
FLIGHTS = {
    "idle_mesh": ([0], [15], [0], 5, 4, 4, 16, None),
    "hotspot": ([1, 1, 1], [0, 0, 0], [0, 0, 0], 1, 2, 2, 4, None),
    "distinct_links": ([0, 5], [1, 6], [0, 0], 4, 4, 4, 16, None),
    "inactive_rows": ([1, 1, 2, 3], [0, 0, 0, 0], [0, 0, 100, 0], 2, 2, 2,
                      4, [True, False, True, True]),
}


def _fly_both(J, net_t, net_j, src, dst, dep, flits, w, h, T, active,
              lf=None):
    jnp = J["jnp"]
    K = len(src)
    active = np.ones(K, bool) if active is None else np.asarray(active)
    lf = np.zeros((4, T), np.int64) if lf is None else lf
    per = np.full(K, 500, np.int32)
    args = [np.asarray(src, np.int32), np.asarray(dst, np.int32),
            np.asarray(dep, np.int64)]
    j = J["jflight"].flight(net_j, w, h, *(jnp.asarray(a) for a in args),
                            flits, jnp.asarray(active), jnp.asarray(lf),
                            jnp.asarray(per))
    t = noc_flight.flight(net_t, w, h, *(torch.from_numpy(a) for a in args),
                          flits, torch.from_numpy(active),
                          torch.from_numpy(lf), torch.from_numpy(per))
    _assert_fields_equal(j, t)
    return t


@pytest.mark.parametrize("name", sorted(FLIGHTS) + [
    "carried_horizon", "seeded_batch", "ragged_mesh"])
def test_flight_matches_jax(name):
    """Every FlightResult field equal.  The JAX loop stops when nothing is
    in flight; the port runs its full (W - 1) + (H - 1) trips: equal
    results show that the extra trips change nothing (the hotspot and
    idle cases finish long before the bound)."""
    J = _jax()
    jp, tp = _params(16, {"network/memory": "emesh_hop_by_hop",
                          "network/emesh_hop_by_hop/queue_model/enabled":
                          True})
    nt, nj = tp.net_memory, jp.net_memory
    if name in FLIGHTS:
        t = _fly_both(J, nt, nj, *FLIGHTS[name])
        if name == "hotspot":
            assert sorted(t.arrival.tolist()) == [1000, 1500, 2000]
            assert int(t.wait_ps.sum()) == 1500
        if name in ("idle_mesh", "distinct_links"):
            assert int(t.wait_ps.sum()) == 0
        if name == "inactive_rows":
            assert int(t.arrival[1]) == 0 and int(t.wait_ps[1]) == 0
    elif name == "carried_horizon":
        r1 = _fly_both(J, nt, nj, [1], [0], [0], 8, 2, 2, 4, None)
        r2 = _fly_both(J, nt, nj, [1], [0], [0], 8, 2, 2, 4, None,
                       lf=r1.link_free.numpy())
        assert int(r2.wait_ps[0]) == 8 * 500
    else:
        # 64 tiles on 8 x 8, or 10 tiles on 3 x 4, a mesh they do not
        # fill: routes through its empty corner give link ids past 4 T,
        # which read the last horizon and write none
        T, w, h = (64, 8, 8) if name == "seeded_batch" else (10, 3, 4)
        rng = np.random.default_rng(5)
        K = 64
        t = _fly_both(J, nt, nj, rng.integers(0, T, K),
                      rng.integers(0, T, K), rng.integers(0, 4000, K),
                      5, w, h, T, rng.random(K) < 0.9,
                      lf=rng.integers(0, 3000, (4, T)))
        assert int(t.wait_ps.sum()) > 0


# ------------------------------- plain kernels' network branches vs JAX



@functools.lru_cache(maxsize=None)
def _jax_classify():
    J = _jax()
    return ref.eager(J["jchain"].chain_classify)


@functools.lru_cache(maxsize=None)
def _jax_walk():
    J = _jax()
    return ref.eager(J["jwin"].window_walk)


def _jax_step_in(J, jp, arrays, H):
    """The JAX ChainIn that the JAX chain pass gathers from the
    state-level arrays (its head and directory-row gathers)."""
    from graphite_tpu.engine import dense as jdense
    from graphite_tpu.engine import resolve as jresolve
    jnp = J["jnp"]
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
    return J["jchain"].ChainIn(**{
        f: (None if v is None else jnp.asarray(v))
        for f, v in fields.items()})


SH_MSI = "pr_l1_sh_l2_msi"
# The chain step's network configurations (T = 16): ATAC with fan-outs
# whose sharers sit in the home's cluster and in others, one access point
# per cluster; distance-based routing over 8-tile clusters under shared
# L2 with four controllers (slice misses whose controller is in another
# cluster), the DRAM queue off (the kernel's completion path); the
# hop-by-hop mesh with its queue model off.
STEP_NETS = {
    "atac_cs4_ap1": _atac(aps=1),
    "atac_cs8_distance_btree_shl2": {
        **_atac(cs=8, routing="distance_based", rnet="btree"),
        "caching_protocol/type": SH_MSI, "dram/num_controllers": 4,
        "dram/queue_model/enabled": False},
    "hbh_queue_off": {"network/memory": "emesh_hop_by_hop"},
}


def _step_params(name):
    return {"tpu/miss_chain": 12, "l2_cache/T1/cache_size": 64,
            **STEP_NETS[name]}


def _fanout_clusters(tp, head, out):
    """(same, other): fan-out targets in the home's cluster and in
    another (atac only)."""
    if tp.net_memory.model != "atac":
        return 0, 0
    cluster_of = noc_atac.geometry(tp.net_memory.atac)[0].numpy()
    same = other = 0
    inv = out.inv_bool.numpy()
    line_fr = out.line_fr.numpy()
    line, home = head.line.numpy(), head.home.numpy()
    go = out.fan_go.numpy()
    for k in range(inv.shape[0]):
        rows = np.flatnonzero(go & (line == line_fr[k]))
        if not len(rows) or not inv[k].any():
            continue
        hc = cluster_of[int(home[rows[0]])]
        same += int((cluster_of[inv[k]] == hc).sum())
        other += int((cluster_of[inv[k]] != hc).sum())
    return same, other


@pytest.mark.parametrize("name", sorted(STEP_NETS))
def test_plain_chain_step_matches_jax_under_networks(name):
    """One replay iteration from state-level operands under each network:
    every ChainOut field against the JAX chain_classify."""
    jp, tp = _params(16, _step_params(name))
    H = max(1024, 16 * tp.num_tiles)
    seen = dict(fan_same=0, fan_other=0, owner_leg=0, site=0)
    for seed in range(3):
        arrays = toperands.random_chain_step_arrays(tp, H, seed)
        head, out = tchain.run_chain_step(
            tp, variant_params(tp),
            toperands.chain_step_in_from_numpy(arrays, "cpu"), H)

        def jax_out():
            J = _jax()
            return ref.fields_of(out, _jax_classify()(
                jp, J["jax_vp"](jp), _jax_step_in(J, jp, arrays, H), H))

        ref.check_outputs(MODULE, out, jax_out, {"params": repr(tp), "H": H},
                          arrays)
        s, o = _fanout_clusters(tp, head, out)
        seen["fan_same"] += s
        seen["fan_other"] += o
        seen["owner_leg"] += int(out.owner_leg.sum())
        seen["site"] += int((out.need_read & (out.from_dram_ps > 0)).sum())
    assert seen["owner_leg"] > 0, seen
    if tp.net_memory.model == "atac":
        assert seen["fan_same"] > 0 and seen["fan_other"] > 0, seen
    if tp.shared_l2:
        assert seen["site"] > 0, seen


# The window walk's user networks (T = 16, K = 16, P = 0 and 12).
WALK_NETS = {
    "atac_cs4_ap1": _atac("user", aps=1),
    "atac_cs8_distance": _atac("user", cs=8, routing="distance_based"),
    "hbh": {"network/user": "emesh_hop_by_hop"},
}


@pytest.mark.parametrize("name,P", [(n, 0) for n in sorted(WALK_NETS)]
                         + [("atac_cs8_distance", 12)])
def test_plain_walk_spawn_leg_matches_jax(name, P):
    """The SPAWN landing leg over the user network: windows in which a
    quarter of the events spawn children on every tile, every WindowOut
    field against the JAX walk."""
    jp, tp = _params(16, {**WALK_NETS[name], "tpu/miss_chain": P})
    spawned = 0
    for seed in range(2):
        arrays = toperands.spawn_window_arrays(tp, 16, seed)
        tout = twin.window_walk(tp, variant_params(tp),
                                toperands.window_in_from_numpy(arrays,
                                                               "cpu"),
                                tp.num_tiles)

        def jax_out():
            J = _jax()
            jnp = J["jnp"]
            jwi = J["jwin"].WindowIn(**{
                f: (jnp.asarray(arrays[f]) if arrays.get(f) is not None
                    else None) for f in J["jwin"].WindowIn._fields})
            return ref.fields_of(tout, _jax_walk()(jp, J["jax_vp"](jp), jwi,
                                                   tp.num_tiles))

        ref.check_outputs(MODULE, tout, jax_out, {"params": repr(tp)},
                          arrays, live=(name, P, seed) == ("hbh", 0, 0))
        spawned += int(tout.spawn_mask.sum())
    assert spawned > 0


# ------------------------------------------------------------ on the card

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU form")


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(STEP_NETS))
@pytest.mark.parametrize("T", [16, 64])
def test_cuda_chain_kernel_matches_plain_under_networks(name, T):
    """chain_classify's network legs (both forms: the wide form by a
    1,024-tile run of the same network) against the plain step."""
    _cuda()
    tp = _torch_params(T, _step_params(name))
    vp = variant_params(tp)
    for H in (max(1024, 16 * T), 1000):
        for seed in range(3):
            si = toperands.chain_step_in_from_numpy(
                toperands.random_chain_step_arrays(tp, H, seed), "cuda")
            work = si._replace(
                ftbl=None if si.ftbl is None else si.ftbl.clone())
            before = tdispatch.COUNTS["chain_classify"]
            head, got = tchain.run_chain_step(tp, vp, work, H)
            assert tdispatch.COUNTS["chain_classify"] == before + 1
            ref_head, ref = tchain.chain_step(tp, vp, si, H)
            torch.cuda.synchronize()
            _assert_fields_equal(ref_head, head, f"{name} H={H} {seed}")
            _assert_fields_equal(ref, got, f"{name} H={H} {seed}")


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(STEP_NETS))
def test_cuda_chain_kernel_wide_form_under_networks(name):
    _cuda()
    T = 1024
    tp = _torch_params(T, _step_params(name))
    vp = variant_params(tp)
    H = 16 * T
    assert tchain.chain_step_entry(tp, vp, H, T // 64).form == tchain.WIDE
    si = toperands.chain_step_in_from_numpy(
        toperands.random_chain_step_arrays(tp, H, 0), "cuda")
    work = si._replace(ftbl=None if si.ftbl is None else si.ftbl.clone())
    head, got = tchain.run_chain_step(tp, vp, work, H)
    ref_head, ref = tchain.chain_step(tp, vp, si, H)
    torch.cuda.synchronize()
    _assert_fields_equal(ref_head, head, name)
    _assert_fields_equal(ref, got, name)


@pytest.mark.gpu
@pytest.mark.parametrize("P", [0, 12])
@pytest.mark.parametrize("name", sorted(WALK_NETS))
@pytest.mark.parametrize("T", [16, 64])
def test_cuda_walk_spawn_leg_matches_plain(name, P, T):
    """window_walk's spawn landing leg on the card, K = 16 and 64."""
    _cuda()
    tp = _torch_params(T, {**WALK_NETS[name], "tpu/miss_chain": P})
    vp = variant_params(tp)
    for K in (16, 64):
        for seed in range(2):
            arrays = toperands.spawn_window_arrays(tp, K, seed)
            ref = twin.window_walk(
                tp, vp, toperands.window_in_from_numpy(arrays, "cpu"),
                tp.num_tiles)
            got = twin.run_window(
                tp, vp, toperands.window_in_from_numpy(arrays, "cuda"),
                tp.num_tiles)
            torch.cuda.synchronize()
            _assert_fields_equal(ref, got, f"{name} K={K} {seed}")


@pytest.mark.gpu
def test_cuda_flight_graph_matches_plain():
    """The flight's CUDA graph against the plain flight on the CPU: a
    sequence of batches replayed through one captured graph, each
    carrying the last one's horizons, on 64 tiles (8 x 8) and on 10
    tiles of a 3 x 4 mesh, with both flit counts of the engine."""
    _cuda()
    tp = _torch_params(16, {"network/memory": "emesh_hop_by_hop",
                            "network/emesh_hop_by_hop/queue_model/enabled":
                            True})
    net = tp.net_memory
    for T, w, h in ((64, 8, 8), (10, 3, 4)):
        rng = np.random.default_rng(T)
        lf_cpu = torch.from_numpy(rng.integers(0, 3000, (4, T)))
        lf_gpu = lf_cpu.cuda()
        for i in range(6):
            K = 64
            ops = [torch.from_numpy(x) for x in (
                rng.integers(0, T, K).astype(np.int32),
                rng.integers(0, T, K).astype(np.int32),
                rng.integers(0, 4000 * (i + 1), K),
                rng.random(K) < 0.8,
                rng.choice([250, 500, 1000], K).astype(np.int32))]
            src, dst, dep, act, per = ops
            flits = (1, 9)[i % 2]
            ref = noc_flight.flight(net, w, h, src, dst, dep, flits, act,
                                    lf_cpu, per)
            got = noc_flight.flight(net, w, h, *(x.cuda() for x in (
                src, dst, dep)), flits, act.cuda(), lf_gpu, per.cuda())
            torch.cuda.synchronize()
            _assert_fields_equal(ref, got, f"T={T} batch {i}")
            lf_cpu, lf_gpu = ref.link_free, got.link_free
