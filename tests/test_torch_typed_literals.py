"""Numbers compared with string literals, and strings with numbers, in the
port.

The port's planner types an untyped literal by the expression it is
compared with, as PostgreSQL does (``plan/physical.py::_literal_as``): a
string literal against an INT64 column must read as an integer and against
a FLOAT64 column as a finite decimal number, and becomes one; a number
against a STRING column becomes its text; anything else (``b = 'x'``,
``b > '2.5'``, a BOOL against a string, a string column against a numeric
column) raises ``PlanError``.  This holds for ``= != < <= > >=``, BETWEEN,
IN lists and JOIN ON keys.  Every backend reads the lowered plan, so each
query here must give numpy's answer on the single device (``torch-cpu``),
on the 8-shard CPU mesh and streamed from an uncached Parquet file.

The JAX package answers otherwise (ROADMAP.md C): its device engine raises
``ValueError`` and its oracle compares the decimal digits of the number
with the string, character by character.  The table and the predicate
matrix come from ``tests/torch_corpus.py`` (``typed_table``,
``TYPED_PREDICATES``).
"""

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import torch_corpus as corpus
from gpu_olap_tpu import EngineConfig as JaxConfig
from gpu_olap_tpu import OlapEngine
from gpu_olap_tpu_torch import EngineConfig, TorchOlapEngine
from gpu_olap_tpu_torch.plan.physical import PlanError
from test_torch_engine import mirror_tables

N = corpus.TYPED_ROWS
BACKENDS = ["torch-cpu", "torch-distributed", "torch-streaming"]
PREDICATES = corpus.TYPED_PREDICATES
_cols = corpus.columns


@pytest.fixture(scope="module")
def table():
    return corpus.typed_table()


@pytest.fixture(scope="module")
def dim():
    return corpus.typed_dim()


@pytest.fixture(scope="module")
def engines(table, dim, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("typedlit") / "t.parquet")
    pq.write_table(table, path)
    one = TorchOlapEngine(EngineConfig(), device="cpu")
    one.register("t", table)
    mesh = TorchOlapEngine(EngineConfig(mesh_shape=(8,)), device="cpu",
                           mesh_devices=["cpu"] * 8)
    mesh.register("t", table)
    streamed = TorchOlapEngine(EngineConfig(table_cache_threshold_rows=1000,
                                            batch_size=512), device="cpu")
    streamed.load_table("t", path)
    assert not streamed.catalog.is_cached("t")
    out = {"torch-cpu": one, "torch-distributed": mesh,
           "torch-streaming": streamed}
    for eng in out.values():
        eng.register("d", dim)
    return out


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name", sorted(PREDICATES))
def test_numeric_column_against_string_literal(table, engines, backend, name):
    pred, mask_of = PREDICATES[name]
    cols = _cols(table)
    mask = mask_of(cols)
    assert 0 < mask.sum() < N
    sql = corpus.predicate_sql(pred)
    res = engines[backend].query(sql)
    assert res.metrics["backend"] == backend, res.metrics
    got = res.to_pydict()
    assert int(got["n"][0]) == int(mask.sum()), sql
    assert int(got["s"][0]) == int(cols["v"][mask].sum()), sql


def test_seed0_table_counts(table, engines):
    """The counts of the table that found the fault (seed 0), on every
    backend: numpy's, where the port before the repair gave 182, 1818,
    1818, 182, 0, 969 and 23."""
    want = {"b = '3'": 188, "b <> '3'": 1812, "b > '5'": 824,
            "b BETWEEN '2' AND '4'": 576, "b IN ('1', '2')": 390,
            "c > '50'": 605, "i = '42'": 24}
    for backend in BACKENDS:
        for pred, n in want.items():
            got = engines[backend].query(
                f"SELECT COUNT(*) AS n FROM t WHERE {pred}").to_pydict()
            assert int(got["n"][0]) == n, (backend, pred)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("pred,want", [
    ("s = 3", 0), ("s <> 3", N), ("3 > s", 0), ("s IN (3, 4.5)", 0),
    ("s IN (3, 'x')", None), ("s = 'x' OR s = 3", None),
])
def test_string_column_against_number(table, engines, backend, pred, want):
    """A number against a string column compares with its text: no ``s``
    reads ``3``.  The mesh and the stream refuse string scan columns, so
    those engines answer on the single-device path."""
    s = _cols(table)["s"].astype(str)
    if want is None:
        want = int((s == "x").sum())
    res = engines[backend].query(f"SELECT COUNT(*) AS n FROM t WHERE {pred}")
    assert int(res.to_pydict()["n"][0]) == want
    assert res.metrics["backend"] in (backend, "torch-cpu"), res.metrics


def test_string_literals_against_string_columns_unchanged(table, engines):
    s = _cols(table)["s"].astype(str)
    for backend in BACKENDS:
        res = engines[backend].query(
            "SELECT COUNT(*) AS n FROM t WHERE s >= 'x' AND s <> '3'")
        assert int(res.to_pydict()["n"][0]) == int((s >= "x").sum())


@pytest.mark.parametrize("backend", BACKENDS)
def test_join_key_against_string_literal(table, dim, engines, backend):
    """An ON conjunct of a key and a string literal types the literal as a
    WHERE does."""
    b = _cols(table)["b"]
    sql = ("SELECT t.b, COUNT(*) AS n FROM t JOIN d ON t.b = d.k "
           "AND t.b = '4' GROUP BY t.b")
    got = engines[backend].query(sql).to_pydict()
    assert [int(x) for x in got["b"]] == [4]
    assert [int(x) for x in got["n"]] == [int((b == 4).sum())]


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("sql", [
    "SELECT COUNT(*) AS n FROM t WHERE b = 'x'",
    "SELECT COUNT(*) AS n FROM t WHERE b > '2.5'",       # not an integer
    "SELECT COUNT(*) AS n FROM t WHERE b = '99999999999999999999'",
    "SELECT COUNT(*) AS n FROM t WHERE b IN ('1', 'x')",
    "SELECT COUNT(*) AS n FROM t WHERE b BETWEEN '1' AND 'z'",
    "SELECT COUNT(*) AS n FROM t WHERE c > 'nan'",       # not finite
    "SELECT COUNT(*) AS n FROM t WHERE c < '1e999'",
    "SELECT COUNT(*) AS n FROM t WHERE c = '1,5'",
    "SELECT COUNT(*) AS n FROM t WHERE s = b",           # string vs column
    "SELECT COUNT(*) AS n FROM t WHERE c + 1 < s",
    "SELECT COUNT(*) AS n FROM t WHERE f = 'true'",      # BOOL vs string
    "SELECT COUNT(*) AS n FROM t WHERE (b > 2) = 'true'",
    "SELECT COUNT(*) AS n FROM t WHERE s = TRUE",
    "SELECT COUNT(*) AS n FROM t JOIN d ON t.b = d.ks",  # join keys
    "SELECT COUNT(*) AS n FROM t JOIN d ON t.s = d.k",
])
def test_unreadable_comparison_raises_plan_error(engines, backend, sql):
    with pytest.raises(PlanError):
        engines[backend].query(sql)


@pytest.fixture(scope="module")
def jax_engines(engines):
    device = OlapEngine(JaxConfig(backend="device"))
    oracle = OlapEngine(JaxConfig(backend="cpu"))
    mirror_tables(engines["torch-cpu"], device, oracle)
    return device, oracle


@pytest.mark.parametrize("pred", ["b = '3'", "b > '5'", "c > '50'",
                                  "i = '42'", "s = 3"])
def test_jax_device_engine_raises(jax_engines, pred):
    """JAX's device engine puts the literal's one-entry dictionary beside
    the number's missing one (``gpu_olap_tpu/executor/device.py:2231``)."""
    device, _ = jax_engines
    with pytest.raises(ValueError, match="dimension"):
        device.query(f"SELECT COUNT(*) AS n FROM t WHERE {pred}")


def test_jax_oracle_compares_digits(table, engines, jax_engines):
    """The JAX oracle compares the digits of ``c`` with ``'50'``: 318 rows,
    where numpy and the port count 605."""
    _, oracle = jax_engines
    c = _cols(table)["c"]
    assert int((c.astype(str) > "50").sum()) == 318
    sql = "SELECT COUNT(*) AS n FROM t WHERE c > '50'"
    assert int(oracle.query(sql).to_pydict()["n"][0]) == 318
    for backend in BACKENDS:
        assert int(engines[backend].query(sql).to_pydict()["n"][0]) == \
            int((c > 50).sum()) == 605
    # an IN list of strings matches no integer in the JAX oracle
    sql = "SELECT COUNT(*) AS n FROM t WHERE b IN ('1', '2')"
    assert int(oracle.query(sql).to_pydict()["n"][0]) == 0
    assert int(oracle.query("SELECT COUNT(*) AS n FROM t WHERE s = 3")
               .to_pydict()["n"][0]) == 0


@pytest.fixture(scope="module")
def streamed_groups(tmp_path_factory):
    """20,000 rows from seed 0, ``b`` in [0, 10), ``v`` in [0, 1000), in an
    uncached Parquet file, and the JAX oracle over the same rows."""
    rng = np.random.default_rng(0)
    n = 20_000
    tbl = pa.table({"b": rng.integers(0, 10, n), "v": rng.integers(0, 1000, n)})
    path = str(tmp_path_factory.mktemp("typedstream") / "g.parquet")
    pq.write_table(tbl, path)
    port = TorchOlapEngine(EngineConfig(table_cache_threshold_rows=1000,
                                        batch_size=2048), device="cpu")
    port.load_table("g", path)
    oracle = OlapEngine(JaxConfig(backend="cpu"))
    oracle.register("g", tbl)
    return tbl, port, oracle


@pytest.mark.parametrize("lit,want,jax_oracle", [("500", 9934, 11012),
                                                 ("95", 18049, 1030)])
def test_streamed_group_by_with_string_bound(streamed_groups, lit, want,
                                             jax_oracle):
    tbl, port, oracle = streamed_groups
    b = tbl.column("b").to_numpy()
    v = tbl.column("v").to_numpy()
    sql = (f"SELECT b, COUNT(*) AS n, SUM(v) AS s FROM g WHERE v > '{lit}' "
           "GROUP BY b ORDER BY b")
    res = port.query(sql)
    assert res.metrics["backend"] == "torch-streaming", res.metrics
    got = res.to_pydict()
    mask = v > int(lit)
    assert int(mask.sum()) == want
    assert [int(x) for x in got["b"]] == list(range(10))
    assert [int(x) for x in got["n"]] == \
        [int((mask & (b == k)).sum()) for k in range(10)]
    assert [int(x) for x in got["s"]] == \
        [int(v[mask & (b == k)].sum()) for k in range(10)]
    ref = oracle.query(sql).to_pydict()
    assert int(np.sum(ref["n"])) == jax_oracle


@pytest.fixture(scope="module")
def grouped():
    """40,000 keys over 200,000 rows (seed 1, the shape of the bench's
    GROUP BY), on the single device and on the JAX device engine."""
    rng = np.random.default_rng(1)
    n = 200_000
    tbl = {"k": rng.integers(0, 40_000, n).astype(np.int64),
           "v": rng.integers(0, 1_000_000, n).astype(np.int64)}
    port = TorchOlapEngine(EngineConfig(), device="cpu")
    port.register("t", tbl)
    jax_device = OlapEngine(JaxConfig(backend="device"))
    mirror_tables(port, jax_device)
    return tbl, port, jax_device


@pytest.mark.parametrize("pred,lo,hi,route", [
    ("k < '1000'", 0, 999, True),
    ("k BETWEEN '100' AND '1099'", 100, 1099, True),
    ("k < 1000", 0, 999, True),
    ("k < '10'", 0, 9, False),       # 50 rows: under the kernel's minimum
])
def test_filtered_group_by_sorts_only_its_rows(grouped, pred, lo, hi, route):
    """A GROUP BY under a WHERE takes the ``seg_agg`` route over the rows
    the mask keeps, gathered before the sort; too few rows take the general
    path.  Both equal numpy and the JAX device engine (given the bound as
    a number)."""
    tbl, port, jax_device = grouped
    k, v = tbl["k"], tbl["v"]
    sql = (f"SELECT k, SUM(v) AS s, MIN(v) AS mn, MAX(v) AS mx, COUNT(*) AS n "
           f"FROM t WHERE {pred} GROUP BY k")
    res = port.query(sql)
    assert ("torch_seg_agg_path" in res.metrics["routes"]) == route
    got = res.to_pandas().sort_values("k").reset_index(drop=True)
    m = (k >= lo) & (k <= hi)
    keys = np.unique(k[m])
    assert np.array_equal(got["k"].to_numpy(), keys)
    for col, fn in (("s", np.sum), ("mn", np.min), ("mx", np.max),
                    ("n", np.size)):
        want = np.array([fn(v[m & (k == x)]) for x in keys])
        assert np.array_equal(got[col].to_numpy(), want), col
    ref = jax_device.query(sql.replace(f"'{lo}'", str(lo))
                           .replace(f"'{hi}'", str(hi)).replace("'", ""))
    exp = ref.to_pandas().sort_values("k").reset_index(drop=True)
    for col in got.columns:
        assert np.array_equal(got[col].to_numpy(), exp[col].to_numpy()), col
