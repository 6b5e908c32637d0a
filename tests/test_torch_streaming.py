"""The port's out-of-core streamed execution against the JAX package's.

Twins of the 16 tests of ``tests/test_streaming.py``: each runs the same
query over the same Parquet files through the JAX streamed engine
(``OlapEngine``, ``backend="device"``, JAX on the CPU), through
``TorchOlapEngine(device="cpu")`` and through the NumPy oracle.  Integers
must be equal, floats within ``rtol=1e-9`` (chunked partial sums
reassociate).  Each twin asserts the port's backend label and, where the
hash-partitioned state engages, that both engines split it into the same
number of partitions.

Beyond the twins: three queries whose values pass int32 after arithmetic
on int32-staged columns (``v * 3000000``), and two streamed queries where
the JAX engine is wrong and the port is not (ROADMAP.md C).  The
hash-state twin also checks that the port returns every staging buffer to
its arena, where JAX's hash-partitioned route keeps some out.  Then
streamed star joins that group by, or take MIN/MAX of, a string column of
the cached dimension (from ``register()`` and from Parquet), which the port
answers as the oracle does and JAX cannot read back; a dictionary out of
string order; a CASE over string literals, which loads its table whole;
and streamed global MINs that JAX gives as 0.

Most twins cap ``max_groups`` at 4096 on both engines (the tables hold at
most 280 groups): the route is the same as at the default, and the merge
sorts stay small enough for the CPU.
"""

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from gpu_olap_tpu import EngineConfig, OlapEngine
from gpu_olap_tpu_torch import EngineConfig as TorchConfig
from gpu_olap_tpu_torch import TorchOlapEngine

SMALL_STATE = {"max_groups": 1 << 12}


@pytest.fixture(scope="module")
def big_parquet(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tstream") / "big.parquet")
    rng = np.random.default_rng(7)
    n = 50_000
    table = pa.table({
        "k": rng.integers(0, 100, n).astype(np.int64),
        "v": rng.integers(0, 1000, n).astype(np.int64),
        "f": rng.normal(10.0, 3.0, n),
    })
    pq.write_table(table, path)
    return path, table


def _engines(paths, batch_size=8192, **kw):
    """(port, JAX streamed engine, oracle) over the Parquet ``paths``
    (name -> path), the first two with every table uncached."""
    cfg = dict(table_cache_threshold_rows=1000, batch_size=batch_size, **kw)
    port = TorchOlapEngine(TorchConfig(**cfg), device="cpu")
    jax_eng = OlapEngine(EngineConfig(backend="device", min_shape_bucket=1024,
                                      **cfg))
    oracle = OlapEngine(EngineConfig(backend="cpu"))
    for name, path in paths.items():
        for eng in (port, jax_eng, oracle):
            eng.load_table(name, path)
        assert not port.catalog.is_cached(name)
    return port, jax_eng, oracle


def _register(engines, name, data):
    for eng in engines:
        eng.register(name, data)


def _frame(result, order):
    df = result.to_pandas()
    if order:
        df = df.sort_values(order).reset_index(drop=True)
    return df


def _same(got, exp, what):
    assert list(got.columns) == list(exp.columns), what
    assert len(got) == len(exp), f"{what}: {len(got)} vs {len(exp)} rows"
    for c in got.columns:
        g, e = got[c].to_numpy(), exp[c].to_numpy()
        if g.dtype.kind == "f" or e.dtype.kind == "f":
            np.testing.assert_allclose(g.astype(float), e.astype(float),
                                       rtol=1e-9, err_msg=f"{what} :: {c}")
        else:
            np.testing.assert_array_equal(g, e, err_msg=f"{what} :: {c}")


def _three(engines, sql, backend, order=None, jax_backend=None):
    """Run ``sql`` on the three engines: the port's rows must equal the
    JAX engine's and the oracle's, on the backends named.  Returns the
    port's frame."""
    port, jax_eng, oracle = engines
    res = port.query(sql)
    assert res.metrics["backend"] == backend, res.metrics
    jres = jax_eng.query(sql)
    assert jres.meta["backend"] == (jax_backend or backend[len("torch-"):])
    got = _frame(res, order)
    _same(got, _frame(jres, order), f"jax: {sql}")
    _same(got, _frame(oracle.query(sql), order), f"oracle: {sql}")
    return got


def _hash_parts(port, jax_eng):
    return (port._get_device_executor()._streaming.last_hash_parts,
            jax_eng._get_device_executor()._streaming.last_hash_parts)


def test_streamed_groupby_matches_oracle(big_parquet):
    path, _ = big_parquet
    sql = ("SELECT k, COUNT(*) AS n, SUM(v) AS s, AVG(f) AS a, "
           "MIN(v) AS mn, MAX(f) AS mx FROM big GROUP BY k")
    # the default group state (2M slots), as test_streaming.py runs it
    _three(_engines({"big": path}), sql, "torch-streaming", ["k"])


def test_streamed_filter_agg(big_parquet):
    path, table = big_parquet
    sql = "SELECT COUNT(*) AS n, SUM(v) AS s FROM big WHERE v > 500"
    got = _three(_engines({"big": path}, **SMALL_STATE), sql,
                 "torch-streaming")
    v = table.column("v").to_numpy()
    assert got.n[0] == (v > 500).sum() and got.s[0] == v[v > 500].sum()


def test_streamed_projection_expr(big_parquet):
    path, table = big_parquet
    sql = "SELECT k, SUM(v * 2 + 1) AS s FROM big GROUP BY k"
    got = _three(_engines({"big": path}, **SMALL_STATE), sql,
                 "torch-streaming", ["k"])
    df = pd.DataFrame({"k": table.column("k").to_numpy(),
                       "v": table.column("v").to_numpy()})
    exp = (df.v * 2 + 1).groupby(df.k).sum()
    assert got.s.tolist() == exp.tolist()


def test_non_streamable_falls_back(big_parquet):
    """ORDER BY over raw rows is no aggregation pipeline: the table loads
    whole onto the device, never onto the CPU oracle."""
    path, table = big_parquet
    sql = "SELECT v FROM big ORDER BY v DESC LIMIT 5"
    got = _three(_engines({"big": path}, **SMALL_STATE), sql, "torch-cpu",
                 jax_backend="device")
    v = np.sort(table.column("v").to_numpy())[::-1][:5]
    assert got.v.tolist() == list(v)


def test_streamed_global_agg_empty_filter(big_parquet):
    """No row passes the filter: COUNT 0 and a NULL SUM, the oracle's
    answer; JAX's streamed engine gives its empty state's SUM, 0
    (ROADMAP.md C)."""
    path, _ = big_parquet
    port, jax_eng, oracle = _engines({"big": path}, **SMALL_STATE)
    sql = "SELECT COUNT(*) AS n, SUM(v) AS s FROM big WHERE v > 100000"
    res = port.query(sql)
    assert res.metrics["backend"] == "torch-streaming"
    got = _frame(res, None)
    _same(got, _frame(oracle.query(sql), None), sql)
    assert got.n[0] == 0 and pd.isna(got.s[0])
    exp = jax_eng.query(sql).to_pydict()
    assert (list(exp["n"]), list(exp["s"])) == ([0], [0])


def test_streamed_join_aggregate(big_parquet):
    """Streamed probe join: the uncached table joins a cached dimension
    table inside the partial-aggregate pipeline."""
    path, table = big_parquet
    engines = _engines({"big": path}, **SMALL_STATE)
    dim_k = np.arange(100, dtype=np.int64)
    _register(engines, "dim", {"k": dim_k, "w": dim_k * 7 + 1})
    sql = ("SELECT d.w, COUNT(*) AS n, SUM(b.v) AS s FROM big b "
           "JOIN dim d ON b.k = d.k WHERE b.v > 100 GROUP BY d.w")
    got = _three(engines, sql, "torch-streaming", ["w"])
    v = table.column("v").to_numpy()
    assert got.n.sum() == (v > 100).sum()


def test_streamed_join_duplicate_build_keys(big_parquet):
    """Duplicate build keys expand the matches past the chunk size."""
    path, table = big_parquet
    engines = _engines({"big": path}, **SMALL_STATE)
    _register(engines, "dim", {"k": np.repeat(np.arange(50, dtype=np.int64), 3),
                               "w": np.arange(150, dtype=np.int64)})
    sql = ("SELECT COUNT(*) AS n, SUM(d.w) AS s FROM big b "
           "JOIN dim d ON b.k = d.k")
    got = _three(engines, sql, "torch-streaming")
    k = table.column("k").to_numpy()
    assert got.n[0] == 3 * (k < 50).sum()


def test_streamed_post_aggregate_ops(big_parquet):
    """HAVING / ORDER BY / LIMIT above the aggregate run on the host over
    the streamed group results."""
    path, _ = big_parquet
    sql = ("SELECT k, SUM(v) AS s FROM big GROUP BY k "
           "HAVING SUM(v) > 1000 ORDER BY s DESC LIMIT 10")
    got = _three(_engines({"big": path}, **SMALL_STATE), sql,
                 "torch-streaming")
    assert len(got) == 10 and got.s.is_monotonic_decreasing


def test_arena_staging_reuse(big_parquet):
    """Chunk staging goes through the arena: buffers are recycled across
    chunks, and every buffer is back in the pool after the stream."""
    path, _ = big_parquet
    engines = _engines({"big": path}, **SMALL_STATE)
    _three(engines, "SELECT k, SUM(v) AS s FROM big GROUP BY k",
           "torch-streaming", ["k"])
    port, jax_eng, _ = engines
    for eng in (port, jax_eng):
        arena = eng._get_device_executor()._streaming_arena_stats()
        assert arena["allocated_bytes"] > 0
        total = sum(c["allocated"] for c in arena["classes"].values())
        # 50k rows in 8192-row chunks: 7 chunks x 2 int32-staged columns
        assert total <= 2 * (eng.config.num_feed_buffers + 2)
        for cls in arena["classes"].values():
            assert cls["free"] == cls["allocated"]
    # a second query reuses the pool instead of growing it
    before = port._get_device_executor()._streaming_arena_stats()
    port.query("SELECT k, MAX(v) AS m FROM big GROUP BY k")
    assert port._get_device_executor()._streaming_arena_stats() == before


# ---------------------------------------------------------------------------
# hash-partitioned streamed group state
# ---------------------------------------------------------------------------

def test_hash_state_groupby_matches_oracle(big_parquet):
    path, _ = big_parquet
    engines = _engines({"big": path}, stream_state_partition_groups=256,
                       max_groups=4096)
    sql = ("SELECT k, COUNT(*) AS n, SUM(v) AS s, MIN(v) AS mn, "
           "MAX(v) AS mx, AVG(f) AS a FROM big GROUP BY k")
    _three(engines, sql, "torch-streaming", ["k"])
    port_parts, jax_parts = _hash_parts(*engines[:2])
    assert port_parts == jax_parts > 1
    # every staging buffer is back in the pool.  JAX's final flush of each
    # partition acquires a fresh accumulator it never releases, so its
    # arena keeps buffers out after every query
    port, jax_eng, _ = engines
    for cls in port._get_device_executor()._streaming_arena_stats()[
            "classes"].values():
        assert cls["free"] == cls["allocated"]
    jax_arena = jax_eng._get_device_executor()._streaming_arena_stats()
    assert sum(c["allocated"] - c["free"]
               for c in jax_arena["classes"].values()) > 0


def test_hash_state_overflow_retries(big_parquet):
    """Per-partition capacities below the group count grow and retry."""
    path, _ = big_parquet
    engines = _engines({"big": path}, stream_state_partition_groups=32,
                       max_groups=64)
    _three(engines, "SELECT k, SUM(v) AS s FROM big GROUP BY k",
           "torch-streaming", ["k"])
    port_parts, jax_parts = _hash_parts(*engines[:2])
    assert port_parts == jax_parts > 1


def test_hash_state_multikey_groupby(tmp_path):
    """Multi-column group keys hash-combine across the state partitions."""
    rng = np.random.default_rng(23)
    n = 40_000
    path = str(tmp_path / "mk.parquet")
    pq.write_table(pa.table({
        "g1": rng.integers(0, 40, n).astype(np.int64),
        "g2": rng.integers(0, 7, n).astype(np.int64),
        "v": rng.integers(0, 1000, n).astype(np.int64),
    }), path)
    engines = _engines({"big": path}, stream_state_partition_groups=128,
                       max_groups=2048)
    sql = ("SELECT g1, g2, COUNT(*) AS n, SUM(v) AS s, MAX(v) AS mx "
           "FROM big GROUP BY g1, g2")
    _three(engines, sql, "torch-streaming", ["g1", "g2"])
    port_parts, jax_parts = _hash_parts(*engines[:2])
    assert port_parts == jax_parts > 1


def test_streamed_nulls_fall_back_exact(tmp_path):
    """Columns with metadata-recorded nulls do not stream (staged chunks
    carry no validity): the table loads whole onto the device."""
    rng = np.random.default_rng(13)
    n = 20_000
    v = rng.normal(10.0, 3.0, n)
    v[rng.random(n) < 0.25] = np.nan
    path = str(tmp_path / "nulls.parquet")
    pq.write_table(pa.table({
        "k": rng.integers(0, 50, n).astype(np.int64),
        "v": pa.array(v, mask=np.isnan(v)),
    }), path)
    sql = "SELECT k, COUNT(v) AS c, AVG(v) AS a FROM big GROUP BY k"
    _three(_engines({"big": path}, **SMALL_STATE), sql, "torch-cpu", ["k"],
           jax_backend="device")


def test_hash_state_with_filter(big_parquet):
    """Filters between scan and aggregate are row-local: the hash split on
    unfiltered rows stays correct."""
    path, _ = big_parquet
    engines = _engines({"big": path}, stream_state_partition_groups=128,
                       max_groups=2048)
    _three(engines, "SELECT k, COUNT(*) AS n FROM big WHERE v > 500 "
           "GROUP BY k", "torch-streaming", ["k"])
    port_parts, jax_parts = _hash_parts(*engines[:2])
    assert port_parts == jax_parts > 1


# ---------------------------------------------------------------------------
# grace join: BOTH sides above the cache threshold
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def two_big_parquets(tmp_path_factory):
    d = tmp_path_factory.mktemp("tgrace")
    rng = np.random.default_rng(17)
    nl, nr = 15_000, 10_000
    lpath, rpath = str(d / "l.parquet"), str(d / "r.parquet")
    pq.write_table(pa.table({
        "k": rng.integers(0, 1250, nl).astype(np.int64),
        "v": rng.integers(0, 1000, nl).astype(np.int64),
    }), lpath)
    pq.write_table(pa.table({
        "k": rng.integers(0, 1250, nr).astype(np.int64),
        "w": rng.integers(0, 1000, nr).astype(np.int64),
    }), rpath)
    return lpath, rpath


def test_partitioned_join_aggregate_matches_oracle(two_big_parquets):
    lpath, rpath = two_big_parquets
    engines = _engines({"l": lpath, "r": rpath}, batch_size=2048,
                       **SMALL_STATE)
    sql = ("SELECT COUNT(*) AS n, SUM(l.v + r.w) AS s, MIN(r.w) AS mn "
           "FROM l JOIN r ON l.k = r.k")
    _three(engines, sql, "torch-streaming-partitioned")


def test_partitioned_join_groupby_matches_oracle(two_big_parquets):
    lpath, rpath = two_big_parquets
    engines = _engines({"l": lpath, "r": rpath}, batch_size=2048,
                       spill_partitions=4, enable_cache=False, **SMALL_STATE)
    sql = ("SELECT l.k AS k, COUNT(*) AS n, SUM(r.w) AS s "
           "FROM l JOIN r ON l.k = r.k GROUP BY l.k")
    first = _three(engines, sql, "torch-streaming-partitioned", ["k"])
    # spill partitions are cached per table version: a second query
    # partitions nothing again and gives the same rows
    port = engines[0]
    spill_dirs = dict(port._get_device_executor()._streaming.spill._dirs)
    again = port.query(sql)
    assert again.metrics["backend"] == "torch-streaming-partitioned"
    _same(_frame(again, ["k"]), first, sql)
    assert port._get_device_executor()._streaming.spill._dirs == spill_dirs


# ---------------------------------------------------------------------------
# beyond the twins
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sql,order", [
    ("SELECT k, SUM(v * 3000000) AS s FROM big GROUP BY k", ["k"]),
    ("SELECT k, MAX(v * 3000000) AS m FROM big GROUP BY k", ["k"]),
    ("SELECT SUM(v * 3000000) AS s FROM big WHERE v < 1000", None),
], ids=["sum", "max", "filtered_sum"])
def test_int32_staged_arithmetic_past_int32(big_parquet, sql, order):
    """``v`` uploads as int32 (its zone map fits), and ``v * 3000000``
    passes 2^31: the product must be taken in int64, as the oracle does."""
    path, table = big_parquet
    got = _three(_engines({"big": path}, **SMALL_STATE), sql,
                 "torch-streaming", order)
    assert got.iloc[:, -1].max() > (1 << 31)


@pytest.fixture(scope="module")
def seq_parquet(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tseq") / "seq.parquet")
    n = 50_000
    pq.write_table(pa.table({
        "k": (np.arange(n) % 7).astype(np.int64),
        "v": np.arange(n, dtype=np.int64),
        "f": np.arange(n) * 0.5,
    }), path)
    return path


def test_global_minmax_after_empty_chunks_where_jax_is_wrong(seq_parquet):
    """The first five chunks hold no row that passes the filter.  JAX's
    one-row global state turns valid after the first chunk regardless, and
    the value an empty chunk left in its MIN lane (-1) wins the MIN; the
    port's state turns valid only once it has absorbed a row."""
    port, jax_eng, oracle = _engines({"big": seq_parquet}, **SMALL_STATE)
    sql = ("SELECT MIN(v) AS mn, MAX(v) AS mx, COUNT(*) AS n FROM big "
           "WHERE v > 45000")
    res = port.query(sql)
    assert res.metrics["backend"] == "torch-streaming"
    exp = oracle.query(sql).to_pydict()
    got = res.to_pydict()
    assert {k: list(v) for k, v in got.items()} == \
        {k: list(v) for k, v in exp.items()} == \
        {"mn": [45001], "mx": [49999], "n": [4999]}
    assert jax_eng.query(sql).to_pydict()["mn"][0] != 45001


def test_float_max_first_minmax_where_jax_truncates(seq_parquet):
    """MAX over a float column as the only MIN/MAX: JAX's streamed partial
    specs carry no ``np_kind``, so the sort keys the floats as int64 and the
    maxima lose their fraction; the port passes the kind."""
    port, jax_eng, oracle = _engines({"big": seq_parquet}, **SMALL_STATE)
    sql = "SELECT k, MAX(f) AS mx FROM big GROUP BY k"
    res = port.query(sql)
    assert res.metrics["backend"] == "torch-streaming"
    got = _frame(res, ["k"])
    _same(got, _frame(oracle.query(sql), ["k"]), sql)
    assert (got.mx % 1 != 0).any()
    jax_mx = _frame(jax_eng.query(sql), ["k"]).mx
    assert (jax_mx % 1 == 0).all()


# ---------------------------------------------------------------------------
# streamed star joins over a string column of the cached dimension table
# ---------------------------------------------------------------------------

@pytest.fixture
def one_torch_thread():
    """The streamed steps over these small tables are many small torch
    operations: with one thread they take as long as with all cores alone,
    and beside other test workers several times less."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def star_tables(tmp_path_factory):
    """An uncached fact table (``k`` in 0..39) and a 40-row dimension whose
    string ``g`` takes three values; ``w`` is its one nullable-free int."""
    d = tmp_path_factory.mktemp("tstar")
    rng = np.random.default_rng(31)
    n = 12_000
    fact = str(d / "fact.parquet")
    pq.write_table(pa.table({
        "k": rng.integers(0, 48, n).astype(np.int64),
        "v": rng.integers(0, 1000, n).astype(np.int64),
    }), fact)
    dim = pa.table({
        "k": np.arange(40, dtype=np.int64),
        "g": np.array(["zeta", "alpha", "mu"] * 13 + ["beta"], dtype=object),
        "w": rng.integers(0, 100, 40).astype(np.int64),
    })
    dim_path = str(d / "dim.parquet")
    pq.write_table(dim, dim_path)
    return fact, dim, dim_path


STAR_QUERIES = {
    "group_key": "SELECT d.g, COUNT(*) AS n, SUM(b.v) AS s FROM big b "
                 "JOIN dim d ON b.k = d.k GROUP BY d.g",
    "grouped_minmax": "SELECT b.k % 4 AS m, MIN(d.g) AS lo, MAX(d.g) AS hi "
                      "FROM big b JOIN dim d ON b.k = d.k WHERE b.v > d.w "
                      "GROUP BY b.k % 4",
    "global_minmax": "SELECT MIN(d.g) AS lo, MAX(d.g) AS hi, COUNT(*) AS n "
                     "FROM big b JOIN dim d ON b.k = d.k WHERE d.g <> 'mu'",
    "key_and_minmax": "SELECT d.g, d.w, MIN(d.g) AS lo, SUM(b.v) AS s "
                      "FROM big b JOIN dim d ON b.k = d.k GROUP BY d.g, d.w",
}


@pytest.mark.parametrize("dim_from", ["register", "parquet"])
@pytest.mark.parametrize("state", ["one_state", "small_state"])
@pytest.mark.parametrize("name", sorted(STAR_QUERIES))
@pytest.mark.usefixtures("one_torch_thread")
def test_streamed_star_join_string_dimension_where_jax_raises(
        star_tables, dim_from, state, name):
    """A streamed join whose group key or MIN/MAX argument is a string
    column of the cached dimension: the port keeps the build side's
    dictionary (uploaded once, fixed for the stream) and gives the oracle's
    rows; JAX's finalized columns carry no dictionary and reading them
    raises ``IndexError``.  ``small_state`` caps the group state at 2
    slots: a streamed join keeps one state (the hash-partitioned state
    serves scans without a join), which overflows and grows."""
    fact, dim, dim_path = star_tables
    kw = ({"max_groups": 2} if state == "small_state" else SMALL_STATE)
    engines = _engines({"big": fact}, batch_size=2048, **kw)
    for eng in engines:
        if dim_from == "register":
            eng.register("dim", dim)
        else:
            eng.load_table("dim", dim_path)
    port, jax_eng, oracle = engines
    assert port.catalog.is_cached("dim")
    sql = STAR_QUERIES[name]
    res = port.query(sql)
    assert res.metrics["backend"] == "torch-streaming", res.metrics
    keys = [c for c in ("g", "w", "m") if c in res.schema.names] or None
    _same(_frame(res, keys), _frame(oracle.query(sql), keys), sql)
    with pytest.raises(IndexError):
        jax_eng.query(sql).to_pydict()


@pytest.mark.usefixtures("one_torch_thread")
def test_streamed_minmax_over_unsorted_dictionary(star_tables):
    """A registered batch may carry a dictionary out of string order: the
    build side is re-coded onto the sorted dictionary as it is uploaded, so
    MIN/MAX over codes is MIN/MAX over strings."""
    from gpu_olap_tpu_torch.interop.columnar import (Column, ColumnBatch,
                                                      DType, Field, Schema)

    fact, _, _ = star_tables
    port, _, oracle = _engines({"big": fact}, batch_size=2048, **SMALL_STATE)
    words = np.array(["mu", "zeta", "alpha", "beta"], dtype=object)
    codes = (np.arange(40) % 4).astype(np.int64)
    port.register("dim", ColumnBatch(
        Schema([Field("k", DType.INT64), Field("g", DType.STRING)]),
        [Column(np.arange(40, dtype=np.int64)), Column(codes, None, words)],
        40))
    oracle.register("dim", {"k": np.arange(40, dtype=np.int64),
                            "g": words[codes]})
    sql = ("SELECT b.k % 3 AS m, MIN(d.g) AS lo, MAX(d.g) AS hi, "
           "COUNT(*) AS n FROM big b JOIN dim d ON b.k = d.k "
           "GROUP BY b.k % 3")
    res = port.query(sql)
    assert res.metrics["backend"] == "torch-streaming"
    got = _frame(res, ["m"])
    _same(got, _frame(oracle.query(sql), ["m"]), sql)
    assert set(got.lo) == {"alpha"} and set(got.hi) == {"zeta"}


@pytest.mark.usefixtures("one_torch_thread")
def test_streamed_string_case_loads_whole(big_parquet):
    """A string value whose dictionary is not that of a build column (here
    a CASE over string literals on the streamed scan) is refused before the
    first chunk: the table loads whole onto the device and the groups are
    numpy's (the JAX package's oracle loses the CASE's dictionary,
    ROADMAP.md C)."""
    path, table = big_parquet
    port = _engines({"big": path}, **SMALL_STATE)[0]
    case = "CASE WHEN v > 500 THEN 'hi' ELSE 'lo' END"
    sql = (f"SELECT {case} AS band, COUNT(*) AS n, SUM(v) AS s FROM big "
           f"GROUP BY {case}")
    res = port.query(sql)
    assert res.metrics["backend"] == "torch-cpu"
    v = table.column("v").to_numpy()
    hi = v > 500
    exp = pd.DataFrame({"band": ["hi", "lo"], "n": [hi.sum(), (~hi).sum()],
                        "s": [v[hi].sum(), v[~hi].sum()]})
    _same(_frame(res, ["band"]), exp, sql)


@pytest.fixture(scope="module")
def ts_parquet(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tts") / "ts.parquet")
    rng = np.random.default_rng(5)
    n = 6000
    lo = np.datetime64("2020-01-01", "ms").astype(np.int64)
    hi = np.datetime64("2023-01-01", "ms").astype(np.int64)
    pq.write_table(pa.table({
        "ts": pa.array(rng.integers(lo, hi, n).astype("datetime64[ms]")),
        "k": rng.integers(0, 30, n).astype(np.int64),
        "v": (rng.integers(0, 1000, n) + 10 ** 12).astype(np.int64),
    }), path)
    return path


@pytest.mark.parametrize("sql", [
    "SELECT MIN(ts) AS mn, MAX(ts) AS mx FROM big",
    "SELECT MIN(v) AS mn, COUNT(*) AS n FROM big",
    "SELECT MIN(d.w) AS mn FROM big b JOIN dim d ON b.k = d.k",
], ids=["timestamp", "int64", "join"])
@pytest.mark.usefixtures("one_torch_thread")
def test_streamed_global_min_where_jax_gives_zero(ts_parquet, sql):
    """Every chunk holds rows, yet JAX's streamed global MIN comes back as
    0 (1970-01-01 for a timestamp): its one-row state enters the first
    merge as valid, holding 0.  The port's state turns valid only once it
    has absorbed a row."""
    engines = _engines({"big": ts_parquet}, batch_size=2048, **SMALL_STATE)
    _register(engines, "dim", {"k": np.arange(30, dtype=np.int64),
                               "w": np.arange(30, dtype=np.int64) + 8})
    port, jax_eng, oracle = engines
    res = port.query(sql)
    assert res.metrics["backend"] == "torch-streaming"
    exp = oracle.query(sql).to_pandas()
    _same(_frame(res, None), exp, sql)
    assert exp.mn.astype("int64")[0] > 0
    assert jax_eng.query(sql).to_pandas().mn.astype("int64")[0] == 0


@pytest.mark.parametrize("sql,jax_wrong", [
    ("SELECT SUM(v) AS s, MIN(v) AS mn, MAX(f) AS mx, AVG(f) AS a, "
     "COUNT(*) AS n FROM big WHERE k > 1000", True),
    ("SELECT MIN(b.v) AS mn, SUM(d.w) AS s, COUNT(*) AS n FROM big b "
     "JOIN dim d ON b.k = d.k", False),
], ids=["filter", "join"])
@pytest.mark.usefixtures("one_torch_thread")
def test_streamed_global_aggregate_over_no_rows_is_null(big_parquet, sql,
                                                        jax_wrong):
    """Every chunk streams, but no row reaches the aggregate (a filter no
    row passes; a dimension whose keys no fact row has): COUNT is 0 and
    every other aggregate NULL, as the oracle gives.  Behind the filter the
    port's one-row state used to yield its empty lanes (0), as JAX's
    streamed engine still does (its MIN reads -1); the join already gave
    NULLs in both."""
    path, _ = big_parquet
    engines = _engines({"big": path}, **SMALL_STATE)
    _register(engines, "dim", {"k": np.arange(500, 530, dtype=np.int64),
                               "w": np.arange(30, dtype=np.int64)})
    port, jax_eng, oracle = engines
    res = port.query(sql)
    assert res.metrics["backend"] == "torch-streaming"
    got = _frame(res, None)
    exp = _frame(oracle.query(sql), None)
    _same(got, exp, sql)
    assert got.n[0] == 0
    assert got.drop(columns="n").isna().all(axis=None)
    jexp = _frame(jax_eng.query(sql), None)
    if jax_wrong:
        assert (jexp.s[0], jexp.mn[0], jexp.mx[0]) == (0, -1, 0.0)
    else:
        _same(jexp, exp, sql)
