"""The port's distributed engine as a whole, on the CPU.

``TorchOlapEngine`` with ``mesh_shape=(8,)`` runs on eight logical CPU
shards (``mesh_devices=["cpu"] * 8``); JAX's distributed engine on the
8-device virtual mesh of ``conftest.py``; the NumPy oracle defines the
answers.  The three hold the same tables (``mirror_tables``).  Results compare as row multisets
(in order where the query orders them): integers exactly, floats within
``rtol=1e-12`` (aggregates are summed in another order).  Each query must
report ``backend == "torch-distributed"`` and the route counter of its
pipeline.
"""

import numpy as np
import pytest

from conftest import make_engine
from test_dist_executor import QUERIES
from test_torch_engine import mirror_tables

from gpu_olap_tpu_torch import EngineConfig, TorchOlapEngine

MESH = ["cpu"] * 8


def _port(**kwargs):
    return TorchOlapEngine(EngineConfig(mesh_shape=(8,), **kwargs),
                           device="cpu", mesh_devices=MESH)


def _frame(result, ordered):
    df = result.to_pandas()
    if not ordered and len(df.columns):
        df = df.sort_values(list(df.columns)).reset_index(drop=True)
    return df


def _assert_same(got, exp, what):
    assert list(got.columns) == list(exp.columns), what
    assert len(got) == len(exp), f"{what}: {len(got)} vs {len(exp)} rows"
    for col in got.columns:
        g, e = got[col].to_numpy(), exp[col].to_numpy()
        if g.dtype.kind == "f" or e.dtype.kind == "f":
            np.testing.assert_allclose(g.astype(float), e.astype(float),
                                       rtol=1e-12, atol=0, equal_nan=True,
                                       err_msg=f"{what} :: {col}")
        else:
            np.testing.assert_array_equal(g, e, err_msg=f"{what} :: {col}")


def _check(engines, sql, route, jax_too=True):
    port, jax_dist, cpu = engines
    got = port.query(sql)
    assert got.metrics["backend"] == "torch-distributed", (sql, got.metrics)
    assert route in got.metrics["routes"], (sql, got.metrics["routes"])
    ordered = "ORDER BY" in sql
    gdf = _frame(got, ordered)
    _assert_same(gdf, _frame(cpu.query(sql), ordered), f"oracle: {sql}")
    if jax_too:
        exp = jax_dist.query(sql)
        assert exp.metrics["backend"] == "distributed", sql
        _assert_same(gdf, _frame(exp, ordered), f"jax: {sql}")
    return got


@pytest.fixture(scope="module")
def engines():
    """The tables of ``test_dist_executor.py`` plus its join and Zipf
    tables, on the port, JAX's distributed engine and the oracle."""
    rng = np.random.default_rng(11)
    n = 40_000
    # max_groups bounds the join pipeline's group tables (1M slots per
    # shard by default), which only costs time at this size
    cfg = dict(max_groups=1 << 14)
    port = _port(**cfg)
    port.register("t", {
        "k": rng.integers(0, 500, n).astype(np.int64),
        "v": rng.integers(-50, 1000, n).astype(np.int64),
        "f": rng.normal(10.0, 5.0, n),
        "year": rng.integers(2020, 2026, n).astype(np.int64),
    })
    rng = np.random.default_rng(77)
    port.register("dim", {"k": np.arange(500, dtype=np.int64),
                          "w": rng.integers(0, 100, 500).astype(np.int64)})
    rng = np.random.default_rng(55)
    nz = 40_000
    zk = np.clip(rng.zipf(1.2, nz).astype(np.int64), 1, 400) - 1
    assert (zk == 0).sum() > nz // 10  # the skew is real
    port.register("zt", {"k": zk,
                         "v": rng.integers(0, 100, nz).astype(np.int64)})
    port.register("zdim", {"k": np.arange(400, dtype=np.int64),
                           "w": rng.integers(0, 50, 400).astype(np.int64)})
    # nulls (NaN floats), an empty table, fewer rows than shards
    rng = np.random.default_rng(5)
    nn = 20_000
    x = rng.normal(0, 10, nn)
    x[rng.random(nn) < 0.2] = np.nan
    f = np.round(rng.normal(0, 3, nn))
    f[rng.random(nn) < 0.1] = np.nan
    port.register("nt", {"g": rng.integers(0, 50, nn), "x": x, "f": f,
                         "v": rng.integers(0, 100, nn)})
    port.register("e", {"k": np.zeros(0, np.int64), "v": np.zeros(0, np.int64)})
    port.register("tiny", {"k": np.array([1, 2, 1]), "v": np.array([5, 6, 7])})
    port.register("fd", {"f": np.arange(-8, 8, dtype=float),
                         "w": np.arange(16)})
    jax_dist = make_engine("device", mesh_shape=(8,), min_shape_bucket=1024,
                           **cfg)
    cpu = make_engine("cpu")
    mirror_tables(port, jax_dist, cpu)
    return port, jax_dist, cpu


def _route(sql):
    if "DISTINCT" in sql:
        return "torch_dist_distinct"
    return "torch_dist_groupby" if "GROUP BY" in sql else "torch_dist_global"


@pytest.mark.parametrize("sql", QUERIES, ids=range(len(QUERIES)))
def test_distributed_corpus(engines, sql):
    _check(engines, sql, _route(sql))


@pytest.mark.parametrize("sql", [
    "SELECT v FROM t ORDER BY v DESC LIMIT 3",
    "SELECT k, v FROM t WHERE v > 100 ORDER BY v ASC, k DESC LIMIT 7",
    "SELECT f FROM t ORDER BY f DESC LIMIT 5 OFFSET 2",
])
def test_distributed_topk(engines, sql):
    _check(engines, sql, "torch_dist_topk")


@pytest.mark.parametrize("sql", [
    "SELECT d.w, COUNT(*) AS n, SUM(t.v) AS s FROM t JOIN dim d "
    "ON t.k = d.k GROUP BY d.w",
    "SELECT d.w, SUM(t.v) AS s FROM t JOIN dim d ON t.k = d.k "
    "WHERE t.v > 0 GROUP BY d.w HAVING s > 1000 ORDER BY s DESC LIMIT 10",
    "SELECT t.k, AVG(t.f) AS a, MIN(d.w) AS mn, COUNT(*) AS n FROM t "
    "JOIN dim d ON t.k = d.k WHERE d.w < 50 GROUP BY t.k",
])
def test_distributed_join_pipeline(engines, sql):
    got = _check(engines, sql, "torch_dist_join")
    assert "torch_dist_skew_broadcast" not in got.metrics["routes"]


def test_distributed_join_zipfian_skew(engines):
    """BASELINE config 5: the hot probe keys take the broadcast route and
    the query stays distributed."""
    sql = ("SELECT d.w, COUNT(*) AS n, SUM(t.v) AS s FROM zt t "
           "JOIN zdim d ON t.k = d.k GROUP BY d.w")
    got = _check(engines, sql, "torch_dist_skew_broadcast")
    assert "torch_dist_join" in got.metrics["routes"]


# the third field holds the case against JAX's distributed engine too; it
# is off only where JAX's group-by truncates a float MIN/MAX (see below)
@pytest.mark.parametrize("sql,route,jax_too", [
    ("SELECT g, SUM(x) AS s, COUNT(x) AS c, MIN(x) AS mn, MAX(x) AS mx, "
     "AVG(x) AS a FROM nt GROUP BY g", "torch_dist_groupby", False),
    ("SELECT f, COUNT(*) AS c, SUM(v) AS s FROM nt GROUP BY f",
     "torch_dist_groupby", True),
    ("SELECT COUNT(x) AS c, SUM(x) AS s, MIN(x) AS mn, MAX(x) AS mx, "
     "AVG(x) AS a, COUNT(*) AS n FROM nt", "torch_dist_global", True),
    ("SELECT g, COUNT(DISTINCT f) AS d FROM nt GROUP BY g",
     "torch_dist_distinct", True),
    ("SELECT v > 50 AS b, COUNT(*) AS c FROM nt GROUP BY v > 50",
     "torch_dist_groupby", True),
    ("SELECT k, SUM(v) AS s FROM e GROUP BY k", "torch_dist_groupby", True),
    ("SELECT COUNT(*) AS c, SUM(v) AS s, MIN(v) AS m FROM e",
     "torch_dist_global", True),
    ("SELECT k, SUM(v) AS s, COUNT(*) AS c FROM tiny GROUP BY k",
     "torch_dist_groupby", True),
    ("SELECT v FROM tiny ORDER BY v DESC LIMIT 2", "torch_dist_topk", True),
    ("SELECT fd.w, COUNT(*) AS c, SUM(nt.v) AS s FROM nt JOIN fd "
     "ON nt.f = fd.f GROUP BY fd.w", "torch_dist_join", True),
], ids=range(10))
def test_distributed_nulls_empty_and_tiny_tables(engines, sql, route,
                                                jax_too):
    """NULL values and NULL group keys (NaN floats), a float join key, an
    empty table and a table with fewer rows than shards, against the
    oracle and JAX's distributed engine."""
    _check(engines, sql, route, jax_too=jax_too)


def test_float_minmax_exact_where_jax_truncates(engines):
    """A float MIN/MAX through the combiner equals the oracle.  JAX's
    combiner drops the argument's kind and the sort ride truncates the
    floats to int64 (ROADMAP C); this pins both."""
    port, jax_dist, cpu = engines
    sql = "SELECT k, MAX(f) AS mx, MIN(f) AS mn FROM t GROUP BY k"
    _check(engines, sql, "torch_dist_groupby", jax_too=False)
    jx = _frame(jax_dist.query(sql), False)
    assert (jx.mx == np.trunc(jx.mx)).all()  # the JAX fault, still there


def test_non_distributable_runs_on_the_torch_device_path(engines):
    """Not the oracle: a full ORDER BY and a UNION take the single-device
    torch path."""
    port, _, cpu = engines
    for sql in ("SELECT v FROM t ORDER BY v DESC",
                "SELECT k FROM dim WHERE k < 5 UNION ALL "
                "SELECT k FROM zdim WHERE k > 395"):
        got = port.query(sql)
        assert got.metrics["backend"] == "torch-cpu", sql
        _assert_same(_frame(got, False), _frame(cpu.query(sql), False), sql)


def test_overflow_retries_stay_distributed():
    """A group table of 16 slots for 500 groups: the combiner overflows,
    grows and reruns on the mesh."""
    port = _port(max_groups=16)
    rng = np.random.default_rng(3)
    port.register("t", {"k": rng.integers(0, 500, 20_000),
                        "v": rng.integers(0, 100, 20_000)})
    cpu = make_engine("cpu")
    mirror_tables(port, cpu)
    sql = "SELECT k, SUM(v) AS s FROM t GROUP BY k"
    got = port.query(sql)
    assert got.metrics["backend"] == "torch-distributed"
    _assert_same(_frame(got, False), _frame(cpu.query(sql), False), sql)


def test_mesh_devices_are_explicit():
    with pytest.raises(ValueError, match="need 8 devices"):
        TorchOlapEngine(EngineConfig(mesh_shape=(8,)), device="cpu")
    with pytest.raises(ValueError, match="mesh_shape"):
        TorchOlapEngine(EngineConfig(), device="cpu", mesh_devices=MESH)
    eng = TorchOlapEngine(EngineConfig(mesh_shape=(2,)), device="cpu",
                          mesh_devices=MESH)
    assert eng.mesh.size == 2
