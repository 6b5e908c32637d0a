"""Float SUM and AVG per group, each group summed from its own rows.

The port sums a float group from the key-sorted rows in levels of
``segment_reduce`` (``ops/aggregate.py::_segmented_sum``): pieces cut at
every group start and every ``SUM_TILE`` items, as many levels as the row
count needs, then each group's pieces.  A
group's rounding error therefore follows its own rows only, and every
group g must lie within ``n_g * 2**-52 * sum(|x_g|)`` of ``math.fsum`` of
its values (AVG: that over its count).  The JAX package takes the
difference of one prefix sum over every group, so a group inherits the
rounding of every group sorted before it (ROADMAP.md C).

The probes (``torch_corpus.float_sum_table``): one row of 1e17 before three
rows of 1.0 and 70,000 rows of 0.25; 100,000 rows of 1e10 before 1,000
rows of cents.  Each runs grouped by an int key and by a string key on
``torch-cpu``, on the 8-shard CPU mesh (which distributes no string
column: those run on its single-device path), streamed from Parquet (the
streamer takes no NULL column, so that table has none, and no string of
the streamed table: the string key is a cached dimension's, as in a star
join) and as a grouped join aggregate.  JAX is imported only for the pin
of its answer.
"""

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import torch_corpus as corpus
from gpu_olap_tpu import EngineConfig as JaxConfig
from gpu_olap_tpu import OlapEngine
from gpu_olap_tpu_torch import EngineConfig, TorchOlapEngine
from gpu_olap_tpu_torch.ops import aggregate as tagg
from test_torch_engine import mirror_tables

T = tagg.SUM_TILE
PROBES = corpus.FLOAT_SUM_PROBES
PLAIN = "SUM({v}) AS s, AVG({v}) AS a"
DISTINCT = "SUM(DISTINCT {v}) AS s, AVG(DISTINCT {v}) AS a"
# streamed chunks: each probe's state merges at least 8 times
BATCH = 8192


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Many small torch operations: one thread is as fast alone and much
    faster beside other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dim(table):
    keys = np.unique(table.column("k").to_numpy())
    return pa.table({"k": keys, "name": [f"acct{x}" for x in keys]})


@pytest.fixture(scope="module", params=PROBES)
def probe(request, tmp_path_factory):
    name = request.param
    table = corpus.float_sum_table(name)
    plain = corpus.float_sum_table(name, nulls=0)
    path = str(tmp_path_factory.mktemp("fsum") / f"{name}.parquet")
    pq.write_table(plain, path)
    one = TorchOlapEngine(EngineConfig(enable_cache=False), device="cpu")
    mesh = TorchOlapEngine(EngineConfig(mesh_shape=(8,), enable_cache=False),
                           device="cpu", mesh_devices=["cpu"] * 8)
    streamed = TorchOlapEngine(EngineConfig(
        table_cache_threshold_rows=1000, batch_size=BATCH, max_groups=16,
        enable_cache=False), device="cpu")
    for eng in (one, mesh):
        eng.register("t", table)
        eng.register("d", _dim(table))
    streamed.load_table("t", path)
    streamed.register("d", _dim(table))
    assert not streamed.catalog.is_cached("t")
    return {"name": name, "table": table, "plain": plain,
            "engines": {"torch-cpu": one, "mesh": mesh,
                        "streamed": streamed}}


def _groups(table, key):
    """{group key value: its non-NULL values} of ``table``."""
    k = table.column(key).to_numpy(zero_copy_only=False)
    v = table.column("v").to_numpy(zero_copy_only=False)
    ok = ~np.isnan(v)
    return {g: v[(k == g) & ok] for g in np.unique(k)}


def _own(x, func, distinct):
    """(expected, bound) of one group's SUM or AVG against math.fsum."""
    if distinct:
        x = np.unique(x)
    exp, bound = corpus.own_sum(x)
    if func == "a":
        exp, bound = exp / len(x), bound / len(x)
    return exp, bound


def _hold(res, groups, key, distinct, what):
    got = res.to_pydict()
    assert sorted(got[key]) == sorted(groups), what
    for i, g in enumerate(got[key]):
        for func in ("s", "a"):
            exp, bound = _own(groups[g], func, distinct)
            gap = abs(float(got[func][i]) - exp)
            assert gap <= bound, (what, g, func, float(got[func][i]), exp,
                                  bound)


def _sql(aggs, key, join):
    if join:
        k = "d.name" if key == "g" else "t.k"
        return (f"SELECT {k} AS {key}, {aggs.format(v='t.v')} FROM t "
                f"JOIN d ON t.k = d.k GROUP BY {k}")
    return f"SELECT {key}, {aggs.format(v='v')} FROM t GROUP BY {key}"


@pytest.mark.parametrize("join", [False, True], ids=["scan", "join"])
@pytest.mark.parametrize("distinct", [False, True], ids=["all", "distinct"])
@pytest.mark.parametrize("key", ["k", "g"])
def test_probe_on_torch_cpu(probe, key, distinct, join):
    sql = _sql(DISTINCT if distinct else PLAIN, key, join)
    res = probe["engines"]["torch-cpu"].query(sql)
    assert res.metrics["backend"] == "torch-cpu"
    _hold(res, _groups(probe["table"], key), key, distinct, sql)


@pytest.mark.parametrize("distinct", [False, True], ids=["all", "distinct"])
@pytest.mark.parametrize("key", ["k", "g"])
def test_probe_on_the_mesh(probe, key, distinct):
    """The int key runs on the 8 shards and their combiner; the string key
    does not distribute and runs on the single-device path."""
    sql = _sql(DISTINCT if distinct else PLAIN, key, False)
    res = probe["engines"]["mesh"].query(sql)
    want = "torch-distributed" if key == "k" else "torch-cpu"
    assert res.metrics["backend"] == want
    _hold(res, _groups(probe["table"], key), key, distinct, sql)


@pytest.mark.parametrize("key", ["k", "g"])
def test_probe_streamed(probe, key):
    eng = probe["engines"]["streamed"]
    sql = _sql(PLAIN, key, key == "g")
    res = eng.query(sql)
    assert res.metrics["backend"] == "torch-streaming"
    assert eng._get_device_executor()._streaming.last_stream_chunks >= 8
    _hold(res, _groups(probe["plain"], key), key, False, sql)


def test_probe_values_are_the_issue_s():
    """The probes' own sums: 3.0 and 17500.0; 515.82."""
    k, v = corpus.float_sum_probe("large_first")
    assert [corpus.own_sum(v[k == g])[0] for g in (1, 2)] == [3.0, 17500.0]
    k, v = corpus.float_sum_probe("fees")
    s, bound = corpus.own_sum(v[k == 1])
    assert s == pytest.approx(515.82, abs=1e-12) and bound < 1.2e-10


def test_jax_package_sums_the_prefix():
    """The reference's device engine takes each group's sum as a difference
    of one prefix sum, so probe 1's three rows of 1.0 come back outside
    their own bound; the port's are 3.0."""
    table = corpus.float_sum_table("large_first")
    port = TorchOlapEngine(EngineConfig(), device="cpu")
    port.register("t", table)
    device = OlapEngine(JaxConfig(backend="device"))
    mirror_tables(port, device)
    sql = "SELECT k, SUM(v) AS s FROM t GROUP BY k ORDER BY k"
    exp, bound = corpus.own_sum(_groups(table, "k")[1])
    jax_s = float(device.query(sql).to_pydict()["s"][1])
    assert abs(jax_s - exp) > bound, jax_s
    assert float(port.query(sql).to_pydict()["s"][1]) == exp == 3.0


# ---------------------------------------------------------------------------
# the segmented sum alone
# ---------------------------------------------------------------------------

def _slots(sizes, max_groups, tail=0):
    """starts/ends of groups of ``sizes`` rows in ``max_groups`` slots, with
    ``tail`` rows after the last group that belong to none."""
    nval = int(sum(sizes))
    flags = np.zeros(nval + tail, bool)
    flags[np.cumsum([0] + list(sizes[:-1]))] = True
    flags[nval:] = False
    newflag = torch.from_numpy(flags)
    starts, ends, _ = tagg._dense_boundaries(
        newflag, newflag.sum(dtype=torch.int64), nval, max_groups)
    return starts, ends


def _check(values, sizes, max_groups, tail=0):
    starts, ends = _slots(sizes, max_groups, tail)
    x = torch.from_numpy(values)
    got = tagg._sum_by_boundary(x, starts, ends).numpy()
    assert got.shape == (max_groups,)
    at = 0
    for g, size in enumerate(sizes):
        exp, bound = corpus.own_sum(values[at:at + size])
        assert abs(got[g] - exp) <= bound, (g, size, got[g], exp, bound)
        at += size
    # padded and empty slots read no row
    assert (got[len(sizes):] == 0).all()
    again = tagg._sum_by_boundary(x, starts, ends).numpy()
    assert again.tobytes() == got.tobytes()
    # no thread adds more than T terms: each level's pieces, then groups
    levels, groups, _ = tagg._sum_plan(starts, ends, len(values))
    for offsets in levels + [groups]:
        assert int(torch.diff(offsets).max()) <= T
    return got


@pytest.mark.parametrize("sizes", [
    [T - 1, T, T + 1],              # around one tile
    [T // 2, 2 * T, T - 3],         # a group straddling two tiles
    [5, 9 * T, 7, 2, T // 2],       # one group of 90 % of the rows
    [1, 3, 70_000],                 # probe 1's shape
    [100_000, 1_000],               # probe 2's shape
    [7, T * T + 5, 2],              # two levels of pieces
])
def test_segmented_sum_matches_fsum(sizes):
    rng = np.random.default_rng(len(sizes) * 7 + sizes[0])
    n = sum(sizes)
    scale = 10.0 ** rng.integers(-2, 17, len(sizes))
    values = rng.normal(size=n) * np.repeat(scale, sizes)
    _check(values, sizes, len(sizes) + 4)


def test_segmented_sum_on_the_probes():
    for name in PROBES:
        k, v = corpus.float_sum_probe(name)
        sizes = list(np.bincount(k))
        got = _check(v, sizes, len(sizes) + 1)
        if name == "large_first":
            assert got[1] == 3.0 and got[2] == 17500.0


def test_segmented_sum_skips_rows_past_the_last_group():
    """Every slot holds a group, and the rows after them (masked rows,
    sorted last) hold a huge value that no group may read."""
    rng = np.random.default_rng(3)
    sizes = [T + 5, 2, 3 * T]
    values = np.concatenate([rng.normal(size=sum(sizes)),
                             np.full(T + 7, 1e300)])
    _check(values, sizes, len(sizes), tail=T + 7)


def test_segmented_sum_of_empty_slots_and_no_rows():
    starts, ends = _slots([4], 6)
    got = tagg._sum_by_boundary(torch.zeros(4, dtype=torch.float64),
                                starts, ends)
    assert got.tolist() == [0.0] * 6
    none = torch.zeros(0, dtype=torch.float64)
    s = torch.zeros(3, dtype=torch.int32)
    e = torch.full((3,), -2, dtype=torch.int32)
    assert tagg._sum_by_boundary(none, s, e).tolist() == [0.0] * 3
    no_slot = torch.zeros(0, dtype=torch.int32)
    assert tagg._sum_by_boundary(none, no_slot, no_slot).numel() == 0


def test_integer_sums_keep_the_boundary_differences():
    """int64 sums stay exact through wrapping differences."""
    sizes = [3, T + 1, 2]
    v = np.full(sum(sizes), 2 ** 62, dtype=np.int64)
    starts, ends = _slots(sizes, 4)
    got = tagg._sum_by_boundary(torch.from_numpy(v), starts, ends)
    with np.errstate(over="ignore"):
        exp = [np.int64(2 ** 62) * np.int64(s) for s in sizes]
    assert got.tolist() == [int(x) for x in exp] + [0]
