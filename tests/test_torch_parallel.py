"""The port's distributed layer against the JAX package's, module by module.

JAX runs on the 8-device virtual CPU mesh of ``conftest.py``; the port on a
mesh of eight logical CPU shards (``["cpu"] * 8``).  Inputs are made with
numpy from a seed; sharded inputs reach JAX through ``row_sharding`` and the
port through ``shards_from_numpy`` of JAX's own shards, so both sides see
the same rows on the same shard.  Hashes, histograms, shuffled rows, group
keys, counts and integer sums must agree exactly; float sums within
``rtol=1e-12`` (summed in another order).  B5 (``radix_hist``) runs its
plain version here against the Pallas kernel in interpret mode; its
``cuda``-marked twin, the CUDA kernel against the plain version, lives in
``test_torch_kernels.py`` with the other kernels' twins, which run on a GPU
machine without JAX.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gpu_olap_tpu.ops import hashing as jhash
from gpu_olap_tpu.ops.pallas import partition as jpart
from gpu_olap_tpu.parallel import dist_ops as jdo
from gpu_olap_tpu.parallel import mesh as jmesh
from gpu_olap_tpu.parallel import shuffle as jshuffle
from gpu_olap_tpu.parallel import skew as jskew
from gpu_olap_tpu.parallel.dist_executor import np_partition_hist
from gpu_olap_tpu_torch.ops import hashing as thash
from gpu_olap_tpu_torch.ops.kernels import partition as tpart
from gpu_olap_tpu_torch.parallel import collectives as tcoll
from gpu_olap_tpu_torch.parallel import dist_executor as tdx
from gpu_olap_tpu_torch.parallel import dist_ops as tdo
from gpu_olap_tpu_torch.parallel import mesh as tmesh
from gpu_olap_tpu_torch.parallel import shuffle as tshuffle
from gpu_olap_tpu_torch.parallel import skew as tskew
from gpu_olap_tpu_torch.utils.metrics import GLOBAL_METRICS

NDEV = 8


@pytest.fixture(scope="module")
def meshes():
    return jmesh.make_mesh(NDEV), tmesh.make_mesh(NDEV, ["cpu"] * NDEV)


def _both(meshes, arr):
    """``arr`` row-sharded for JAX, and JAX's shards as the port's."""
    jm, tm = meshes
    jarr = jax.device_put(arr, jmesh.row_sharding(jm))
    shards = sorted(jarr.addressable_shards,
                    key=lambda s: s.index[0].start or 0)
    return jarr, tmesh.shards_from_numpy(tm, [np.asarray(s.data)
                                              for s in shards])


def _jax_blocks(arr):
    """A JAX row-sharded output as per-shard numpy blocks."""
    return np.asarray(arr).reshape(NDEV, -1)


def _np(parts):
    return [p.numpy() for p in parts]


def _keys64(rng, n):
    return np.concatenate([
        rng.integers(-2**63, 2**63 - 1, n, endpoint=True),
        rng.integers(-1000, 1000, n),
        [0, -1, 2**63 - 1, -2**63, 2**32, -2**32, 2**31, -2**31 - 1],
    ]).astype(np.int64)


# ---------------------------------------------------------------------------
# hashing
# ---------------------------------------------------------------------------

def test_hash32_hash64_bit_exact():
    x = _keys64(np.random.default_rng(0), 20_000)
    j32 = np.asarray(jhash.hash32(jnp.asarray(x)))
    t32 = thash.hash32(torch.from_numpy(x)).numpy()
    assert j32.dtype == np.uint32 and t32.dtype == np.int64
    np.testing.assert_array_equal(t32, j32.astype(np.int64))
    np.testing.assert_array_equal(thash.hash64(torch.from_numpy(x)).numpy(),
                                  np.asarray(jhash.hash64(jnp.asarray(x))))


@pytest.mark.parametrize("ndev", [1, 3, 8, 256])
def test_partition_of_bit_exact(ndev):
    """Against JAX's ``partition_of`` and the executor's host replica
    ``np_partition_hist``, on int64 and int32 keys."""
    rng = np.random.default_rng(ndev)
    x = _keys64(rng, 20_000)
    got = thash.partition_of(torch.from_numpy(x), ndev)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jhash.partition_of(jnp.asarray(x), ndev)))
    np.testing.assert_array_equal(np.bincount(got.numpy(), minlength=ndev),
                                  np_partition_hist(x, ndev))
    x32 = rng.integers(-2**31, 2**31 - 1, 10_000).astype(np.int32)
    np.testing.assert_array_equal(
        thash.partition_of(torch.from_numpy(x32), ndev).numpy(),
        np.asarray(jhash.partition_of(jnp.asarray(x32), ndev)))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("cap", [700, 90])  # room to spare, overflow
def test_bucket_layout_valid_slots(masked, cap):
    """Counts and overflow exactly; the gather indices on valid slots only
    (slot s < counts[b]): JAX's padding slots are a clip artifact that
    points into the next bucket."""
    rng = np.random.default_rng(3)
    n = 5000
    dest = rng.integers(0, 8, n).astype(np.int32)
    valid = rng.random(n) < 0.8 if masked else None
    jg, jc, jo = jhash.bucket_layout(
        jnp.asarray(dest), None if valid is None else jnp.asarray(valid),
        8, cap)
    tg, tc, to = thash.bucket_layout(
        torch.from_numpy(dest), None if valid is None
        else torch.from_numpy(valid), 8, cap)
    jc = np.asarray(jc)
    np.testing.assert_array_equal(tc.numpy(), jc)
    assert bool(to) == bool(jo) == (jc.max() > cap)
    live = np.arange(cap)[None, :] < np.minimum(jc, cap)[:, None]
    np.testing.assert_array_equal(tg.numpy()[live], np.asarray(jg)[live])


# ---------------------------------------------------------------------------
# B5: the radix histogram
# ---------------------------------------------------------------------------

@pytest.fixture
def interpret_mode():
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        yield


@pytest.mark.parametrize("shift", [0, 8, 24])
def test_radix_histogram_plain_matches_pallas(interpret_mode, shift):
    """Negative keys, and a length that is not a multiple of the TPU
    kernel's 16384-key block (its zero padding is subtracted again)."""
    rng = np.random.default_rng(40 + shift)
    keys = rng.integers(-2**31, 2**31 - 1, 40_001).astype(np.int32)
    keys[:3000] = -1
    exp = np.asarray(jpart.radix_histogram_i32(jnp.asarray(keys), shift))
    got = tpart.radix_histogram_i32(torch.from_numpy(keys), shift)
    assert got.dtype == torch.int64 and got.shape == (256,)
    np.testing.assert_array_equal(got.numpy(), exp)
    np.testing.assert_array_equal(
        tpart.partition_offsets(got).numpy(),
        np.asarray(jpart.partition_offsets(jnp.asarray(exp))))


def test_radix_histogram_edges():
    empty = tpart.radix_histogram_i32(torch.zeros(0, dtype=torch.int32), 31)
    np.testing.assert_array_equal(empty.numpy(), np.zeros(256, np.int64))
    keys = torch.tensor([-2**31, -1, 2**31 - 1], dtype=torch.int32)
    got = tpart.radix_histogram_i32(keys, 31).numpy()
    assert got[255] == 2 and got[0] == 1  # arithmetic shift: sign bits
    for bad in (-1, 32):
        with pytest.raises(ValueError):
            tpart.radix_histogram_i32(keys, bad)
    with pytest.raises(ValueError):
        tpart.radix_histogram_i32(keys.to(torch.int64), 0)


@pytest.mark.parametrize("n,route", [(50_000, True), (30_000, False)])
def test_partition_histogram_route(interpret_mode, n, route):
    """At least 32768 keys count on B5 (the JAX gate, ``skew.py:37``):
    the route counter moves only there, and the counts equal JAX's."""
    rng = np.random.default_rng(5)
    keys = rng.integers(0, 1 << 30, n).astype(np.int64)
    before = GLOBAL_METRICS.counters.get("torch_radix_hist_path", 0)
    hist = tskew.partition_histogram(torch.from_numpy(keys), 8)
    moved = GLOBAL_METRICS.counters.get("torch_radix_hist_path", 0) - before
    assert moved == (1 if route else 0)
    np.testing.assert_array_equal(
        hist.numpy(), np.asarray(jskew.partition_histogram(
            jnp.asarray(keys), 8)))
    np.testing.assert_array_equal(hist.numpy(), np_partition_hist(keys, 8))


# ---------------------------------------------------------------------------
# mesh and collectives
# ---------------------------------------------------------------------------

def test_make_mesh_counts_devices():
    with pytest.raises(ValueError, match="need 8 devices"):
        tmesh.make_mesh(8, ["cpu"] * 3)
    m = tmesh.make_mesh(2, ["cpu"] * 4)
    assert m.size == 2 and m.devices == (torch.device("cpu"),) * 2
    assert tmesh.AXIS == jmesh.AXIS
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tmesh.make_mesh(1, ["cuda:0"])
    tmesh.initialize_distributed(None, 1, 0)
    with pytest.raises(NotImplementedError, match="A11"):
        tmesh.initialize_distributed("localhost:1234", 2, 0)


def test_shard_rows_pads_like_the_executor():
    m = tmesh.make_mesh(3, ["cpu"] * 3)
    parts = tmesh.shard_rows(m, np.arange(7, dtype=np.int64))
    assert [p.tolist() for p in parts] == [[0, 1, 2], [3, 4, 5], [6, 0, 0]]
    mask = tmesh.shard_rows(m, np.ones(7, bool), False)
    assert [p.tolist() for p in mask][-1] == [True, False, False]


def test_collectives():
    m = tmesh.make_mesh(3, ["cpu"] * 3)
    blocks = [torch.arange(6) + 10 * s for s in range(3)]  # 3 blocks of 2
    got = tcoll.all_to_all(m, blocks)
    assert [g.tolist() for g in got] == [[0, 1, 10, 11, 20, 21],
                                         [2, 3, 12, 13, 22, 23],
                                         [4, 5, 14, 15, 24, 25]]
    parts = [torch.tensor([s, -s]) for s in range(3)]
    assert all(g.tolist() == [0, 0, 1, -1, 2, -2]
               for g in tcoll.all_gather(m, parts))
    vals = [torch.tensor(v) for v in (3, -1, 5)]
    assert (int(tcoll.psum(m, vals)), int(tcoll.pmin(m, vals)),
            int(tcoll.pmax(m, vals))) == (7, -1, 5)
    flags = [torch.tensor(False), torch.tensor(True), torch.tensor(False)]
    assert bool(tcoll.pany(m, flags)) and not bool(tcoll.pany(m, flags[::2]))
    with pytest.raises(ValueError):
        tcoll.all_to_all(m, [torch.arange(4)] * 3)


# ---------------------------------------------------------------------------
# shuffle
# ---------------------------------------------------------------------------

def test_shuffle_matches_jax_per_shard(meshes):
    """Every shard receives JAX's rows, in JAX's order (source shard, then
    row order), with the same valid slots."""
    jm, tm = meshes
    n = NDEV * 512
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 1000, n).astype(np.int64)
    vals = rng.integers(0, 10**9, n).astype(np.int64)
    valid = rng.random(n) < 0.9
    jk, tk = _both(meshes, keys)
    jv, tv = _both(meshes, valid)
    jp, tp = _both(meshes, vals)
    jrk, jrp, jrv, jof = jshuffle.make_shuffle(jm, 1, 256)(jk, jv, jp)
    trk, trp, trv, tof = tshuffle.make_shuffle(tm, 1, 256)(tk, tv, tp)
    assert int(tof) == int(np.asarray(jof).max()) == 0
    for d, (rk, rp, rv) in enumerate(zip(_np(trk), _np(trp), _np(trv))):
        jvd = _jax_blocks(jrv)[d]
        np.testing.assert_array_equal(rv, jvd)
        np.testing.assert_array_equal(rk[rv], _jax_blocks(jrk)[d][jvd])
        np.testing.assert_array_equal(rp[rv], _jax_blocks(jrp)[d][jvd])
    got = sorted(zip(np.concatenate(_np(trk))[np.concatenate(_np(trv))],
                     np.concatenate(_np(trp))[np.concatenate(_np(trv))]))
    assert got == sorted(zip(keys[valid], vals[valid]))


def test_shuffle_overflow_flag(meshes):
    jm, tm = meshes
    n = NDEV * 512
    keys = np.zeros(n, dtype=np.int64)  # every row -> one shard
    jk, tk = _both(meshes, keys)
    jv, tv = _both(meshes, np.ones(n, bool))
    *_, jof = jshuffle.make_shuffle(jm, 0, 64)(jk, jv)
    *_, tof = tshuffle.make_shuffle(tm, 0, 64)(tk, tv)
    assert int(tof) == int(np.asarray(jof).max()) == 1


# ---------------------------------------------------------------------------
# skew helpers
# ---------------------------------------------------------------------------

def test_skew_helpers_match_jax():
    rng = np.random.default_rng(4)
    keys = np.concatenate([rng.integers(0, 1000, 5000),
                           np.full(3000, 42), np.full(900, 7)]).astype(np.int64)
    for thr, max_heavy in ((500, 128), (100, 1), (10_000, 128)):
        np.testing.assert_array_equal(
            tskew.detect_heavy_keys(keys, thr, max_heavy),
            jskew.detect_heavy_keys(keys, thr, max_heavy))
    heavy = tskew.detect_heavy_keys(keys, row_threshold=500)
    assert heavy.tolist() == [7, 42]
    np.testing.assert_array_equal(
        tskew.split_by_heavy(torch.from_numpy(keys), heavy).numpy(),
        np.asarray(jskew.split_by_heavy(jnp.asarray(keys), heavy)))
    assert not tskew.split_by_heavy(torch.from_numpy(keys), heavy[:0]).any()
    hist = tskew.partition_histogram(torch.from_numpy(keys), 8).numpy()
    for ndev, headroom in ((1, 1.25), (8, 1.3), (8, 1.6)):
        assert tskew.recommend_capacity(hist, ndev, headroom) == \
            jskew.recommend_capacity(hist, ndev, headroom)


def test_shuffle_volume_scales_inverse_ndev():
    """Per-shard receive volume (ndev x bucket capacity) from the port's
    histogram shrinks about 1/ndev for a fixed table (the round-1 sizing
    bug made it constant)."""
    total = 1 << 17
    keys = torch.from_numpy(np.random.default_rng(7).integers(
        0, total // 16, total).astype(np.int64))
    recv = {}
    for ndev in (2, 4, 8):
        hist = tskew.partition_histogram(keys, ndev).numpy()
        recv[ndev] = ndev * tskew.recommend_capacity(hist, ndev, 1.25)
    assert recv[2] / recv[8] > 2.8, recv
    assert recv[2] > recv[4] > recv[8], recv


# ---------------------------------------------------------------------------
# dist_ops: every make_* against JAX on the same shards
# ---------------------------------------------------------------------------

def _groups(keys, aggs, valid):
    """Per shard: the valid groups' (key, aggs...) rows, sorted by key."""
    out = []
    for d in range(NDEV):
        v = valid[d]
        cols = [keys[d][v]] + [a[d][v] for a in aggs]
        order = np.argsort(cols[0], kind="stable")
        out.append([c[order] for c in cols])
    return out


def _assert_groups_equal(got, exp, what):
    for d, (g, e) in enumerate(zip(got, exp)):
        for j, (gc, ec) in enumerate(zip(g, e)):
            if ec.dtype.kind == "f":
                np.testing.assert_allclose(gc, ec, rtol=1e-12, atol=0,
                                           err_msg=f"{what} shard {d} col {j}")
            else:
                np.testing.assert_array_equal(
                    gc, ec, err_msg=f"{what} shard {d} col {j}")


def _jax_groups(gk, aggs, gvalid):
    return _groups(_jax_blocks(gk), [_jax_blocks(a) for a in aggs],
                   _jax_blocks(gvalid))


def _port_groups(gk, aggs, gvalid):
    return _groups(_np(gk), [_np(a) for a in aggs], _np(gvalid))


def test_dist_groupby_matches_jax(meshes):
    jm, tm = meshes
    n = NDEV * 1024
    rng = np.random.default_rng(1)
    keys = rng.integers(0, 200, n).astype(np.int64)
    vals = rng.integers(-100, 100, n).astype(np.int64)
    specs = [{"func": "sum", "acc_dtype": np.int64},
             {"func": "count", "acc_dtype": np.int64}]
    jk, tk = _both(meshes, keys)
    jv, tv = _both(meshes, np.ones(n, bool))
    jx, tx = _both(meshes, vals)
    jg, jaggs, jvalid, jn = jdo.make_dist_groupby(jm, specs, 1024, 512)(
        jk, jv, jx, jx)
    tg, taggs, tvalid, tn = tdo.make_dist_groupby(tm, specs, 1024, 512)(
        tk, tv, tx, tx)
    np.testing.assert_array_equal(np.concatenate(_np(tn)), np.asarray(jn))
    _assert_groups_equal(_port_groups(tg, taggs, tvalid),
                         _jax_groups(jg, jaggs, jvalid), "groupby")


def test_dist_join_matches_jax(meshes):
    jm, tm = meshes
    nl, nr = NDEV * 512, NDEV * 256
    rng = np.random.default_rng(2)
    lk = rng.integers(0, 300, nl).astype(np.int64)
    lv = np.arange(nl, dtype=np.int64)
    rk = rng.integers(100, 400, nr).astype(np.int64)
    rv = np.arange(nr, dtype=np.int64) + 10**6
    args = [_both(meshes, a) for a in (lk, np.ones(nl, bool), rk,
                                       np.ones(nr, bool), lv, rv)]
    jout = jdo.make_dist_join(jm, 1024, 8192, 1, 1)(*[a[0] for a in args])
    tout = tdo.make_dist_join(tm, 1024, 8192, 1, 1)(*[a[1] for a in args])
    jkey, (jlv,), (jrv,), jvalid, jtot = jout
    tkey, (tlv,), (trv,), tvalid, ttot = tout
    np.testing.assert_array_equal(np.concatenate(_np(ttot)), np.asarray(jtot))
    for d in range(NDEV):
        tvd, jvd = tvalid[d].numpy(), _jax_blocks(jvalid)[d]
        got = sorted(zip(tkey[d].numpy()[tvd], tlv[d].numpy()[tvd],
                         trv[d].numpy()[tvd]))
        exp = sorted(zip(_jax_blocks(jkey)[d][jvd], _jax_blocks(jlv)[d][jvd],
                         _jax_blocks(jrv)[d][jvd]))
        assert got == exp, f"shard {d}"


def _step_inputs(meshes, kind, seed=3):
    rng = np.random.default_rng(seed)
    nl, nr = NDEV * 512, NDEV * 128
    lk = rng.integers(0, 64, nl).astype(np.int64)
    rk = np.arange(64, dtype=np.int64).repeat(16)
    if kind == "float":
        lv, rv = rng.normal(0, 10, nl), rng.normal(5, 3, nr)
    else:
        lv = rng.integers(1, 10, nl).astype(np.int64)
        rv = rng.integers(1, 5, nr).astype(np.int64)
    return [_both(meshes, a) for a in (lk, np.ones(nl, bool), lv, rk,
                                       np.ones(nr, bool), rv)]


@pytest.mark.parametrize("kind", ["int", "float"])
def test_dist_join_groupby_matches_jax(meshes, kind):
    jm, tm = meshes
    args = _step_inputs(meshes, kind)
    cfg = dict(capacity=2048, join_capacity=65536, max_groups=256,
               agg_funcs=("sum", "count"))
    jg, jaggs, jvalid, jof = jdo.make_dist_join_groupby(jm, **cfg)(
        *[a[0] for a in args])
    tg, taggs, tvalid, tof = tdo.make_dist_join_groupby(tm, **cfg)(
        *[a[1] for a in args])
    assert not bool(tof) and not bool(np.asarray(jof))
    _assert_groups_equal(_port_groups(tg, taggs, tvalid),
                         _jax_groups(jg, jaggs, jvalid), "step")


def test_dist_join_groupby_stages_match_jax(meshes):
    """The two phases apart: the shuffle's valid rows per shard equal JAX's
    in order, and the local phase equals the fused step."""
    jm, tm = meshes
    args = _step_inputs(meshes, "int")
    cfg = dict(capacity=2048, join_capacity=65536, max_groups=256,
               agg_funcs=("sum", "count"))
    jshuf, jloc = jdo.make_dist_join_groupby_stages(jm, **cfg)
    tshuf, tloc = tdo.make_dist_join_groupby_stages(tm, **cfg)
    js = jshuf(*[a[0] for a in args])
    ts = tshuf(*[a[1] for a in args])
    assert not bool(ts[6]) and not bool(np.asarray(js[6]))
    for side in (0, 3):
        for d in range(NDEV):
            v = _jax_blocks(js[side + 2])[d]
            np.testing.assert_array_equal(ts[side + 2][d].numpy(), v)
            for lane in (side, side + 1):
                np.testing.assert_array_equal(ts[lane][d].numpy()[v],
                                              _jax_blocks(js[lane])[d][v])
    jg, jaggs, jvalid, _ = jloc(*js[:6])
    tg, taggs, tvalid, tof = tloc(*ts[:6])
    assert not bool(tof)
    _assert_groups_equal(_port_groups(tg, taggs, tvalid),
                         _jax_groups(jg, jaggs, jvalid), "stages")
    fused = tdo.make_dist_join_groupby(tm, **cfg)(*[a[1] for a in args])
    _assert_groups_equal(_port_groups(*fused[:3]),
                         _port_groups(tg, taggs, tvalid), "fused")


def _skew_inputs(meshes):
    rng = np.random.default_rng(9)
    n = NDEV * 1024
    lk = np.where(rng.random(n) < 0.6, 7, rng.integers(0, 64, n)).astype(
        np.int64)
    lv = rng.integers(1, 10, n).astype(np.int64)
    rk = np.resize(np.arange(64, dtype=np.int64).repeat(4), NDEV * 32)
    rv = rng.integers(1, 5, rk.shape[0]).astype(np.int64)
    heavy = tskew.detect_heavy_keys(lk, row_threshold=n // 10)
    args = [_both(meshes, a) for a in (lk, np.ones(n, bool), lv, rk,
                                       np.ones(rk.shape[0], bool), rv)]
    return args, heavy


def test_dist_join_groupby_skew_matches_jax(meshes):
    jm, tm = meshes
    args, heavy = _skew_inputs(meshes)
    assert heavy.tolist() == [7]
    cfg = dict(capacity=2048, join_capacity=65536, max_groups=256,
               agg_funcs=("sum", "count"), heavy_keys=heavy,
               heavy_build_cap=64)
    jg, jaggs, jvalid, jof = jdo.make_dist_join_groupby_skew(jm, **cfg)(
        *[a[0] for a in args])
    tg, taggs, tvalid, tof = tdo.make_dist_join_groupby_skew(tm, **cfg)(
        *[a[1] for a in args])
    assert not bool(tof) and not bool(np.asarray(jof))
    _assert_groups_equal(_port_groups(tg, taggs, tvalid),
                         _jax_groups(jg, jaggs, jvalid), "skew step")


def test_dist_step_overflow_flag_reports(meshes):
    """Mirror of ``test_distributed.py``'s test: every row hashes to one
    shard, so the step must report overflow instead of dropping rows."""
    _, tm = meshes
    n = NDEV * 512
    keys = tmesh.shard_rows(tm, np.zeros(n, np.int64))
    ones = tmesh.shard_rows(tm, np.ones(n, np.int64))
    valid = tmesh.shard_rows(tm, np.ones(n, bool))
    step = tdo.make_dist_join_groupby(tm, capacity=64, join_capacity=4096,
                                      max_groups=64, agg_funcs=("sum",))
    assert bool(step(keys, valid, ones, keys, valid, ones)[3])


def test_skew_step_flags_heavy_build_rows_past_cap(meshes):
    """More heavy build rows on a shard than ``heavy_build_cap``: the port
    raises the overflow flag.  JAX's step drops the extra rows without
    flagging them (ROADMAP C)."""
    jm, tm = meshes
    args, heavy = _skew_inputs(meshes)
    cfg = dict(capacity=2048, join_capacity=65536, max_groups=256,
               agg_funcs=("sum", "count"), heavy_keys=heavy,
               heavy_build_cap=1)  # one shard holds key 7's 4 build rows
    *_, tof = tdo.make_dist_join_groupby_skew(tm, **cfg)(*[a[1] for a in args])
    *_, jof = jdo.make_dist_join_groupby_skew(jm, **cfg)(*[a[0] for a in args])
    assert bool(tof)
    assert not bool(np.asarray(jof))


def test_partition_key_maps_nulls_and_floats():
    code = torch.tensor([1.5, -0.25, 3e16, 0.0], dtype=torch.float64)
    null = torch.tensor([False, False, False, True])
    got = tdx._partition_key((code, null)).tolist()
    assert got == [6144, -1024, int(3e16), -1]
