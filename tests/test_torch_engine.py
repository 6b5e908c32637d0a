"""The port's single-device SQL path as a whole, on the CPU.

Each query runs on three engines over the same tables: the port
(``TorchOlapEngine(device="cpu")``), the JAX device engine and the NumPy
oracle of the JAX package.  The port keeps its own catalog classes, so
``mirror_tables`` registers the port's tables, array for array, in the
JAX package's engines.  Results are compared as row multisets: integers exactly, floats
within ``rtol=1e-12`` (aggregates are summed in another order) and
``atol=1e-12`` (for sums near zero).  Join queries also check that the port
takes the route the JAX engine takes (streaming join, sorted-space join
aggregates), by the counters each engine bumps.  The corpus and the
fuzzer come from ``tests/torch_corpus.py``, which the GPU runs through
``tests/test_torch_card.py`` and ``chip_smoke.py``'s ``engine_corpus``.
"""

import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import test_groupjoin
from conftest import make_engine
from torch_corpus import N_QUERIES, SLICE_QUERIES, fuzz_case, populate

from gpu_olap_tpu.interop import columnar as jcol
from gpu_olap_tpu.utils.metrics import GLOBAL_METRICS as JAX_METRICS
from gpu_olap_tpu_torch import EngineConfig, TorchOlapEngine
from gpu_olap_tpu_torch.utils.metrics import GLOBAL_METRICS
from gpu_olap_tpu_torch.executor import device as tdev
from gpu_olap_tpu_torch.ops.kernels import join_stream as tjs

def _port(**kwargs):
    return TorchOlapEngine(EngineConfig(**kwargs), device="cpu")


def mirror_tables(port, *engines):
    """Register every table of the port engine ``port`` in the JAX
    package's ``engines``: the same arrays, validity masks and dictionaries
    under the JAX package's own schema classes."""
    for name in port.catalog.list_tables():
        b = port.catalog.get_table_data(name)
        schema = jcol.Schema([jcol.Field(f.name, jcol.DType(f.dtype.value),
                                         f.nullable) for f in b.schema])
        cols = [jcol.Column(c.data, c.validity, c.dictionary)
                for c in b.columns]
        for eng in engines:
            eng.catalog.register_batch(
                name, jcol.ColumnBatch(schema, cols, b.num_rows))


def _canon(result):
    df = result.to_pandas()
    if len(df.columns):
        df = df.sort_values(list(df.columns)).reset_index(drop=True)
    return df


def _assert_same_rows(got, exp, what):
    assert list(got.columns) == list(exp.columns), what
    assert len(got) == len(exp), f"{what}: {len(got)} vs {len(exp)} rows"
    for col in got.columns:
        g, e = got[col].to_numpy(), exp[col].to_numpy()
        if g.dtype.kind == "f" or e.dtype.kind == "f":
            np.testing.assert_allclose(
                g.astype(np.float64), e.astype(np.float64), rtol=1e-12,
                atol=1e-12, equal_nan=True, err_msg=f"{what} :: {col}")
        else:
            np.testing.assert_array_equal(g, e, err_msg=f"{what} :: {col}")


def _bumped(counter, fn):
    before = GLOBAL_METRICS.counters.get(counter, 0)
    out = fn()
    return out, GLOBAL_METRICS.counters.get(counter, 0) - before


@pytest.fixture(scope="module")
def engines():
    port = _port()
    populate(port, np.random.default_rng(123))
    jax_dev = make_engine("device")
    cpu = make_engine("cpu")
    mirror_tables(port, jax_dev, cpu)
    return port, jax_dev, cpu


@pytest.mark.parametrize("sql", SLICE_QUERIES, ids=range(len(SLICE_QUERIES)))
def test_port_matches_jax_and_oracle(engines, sql):
    port, jax_dev, cpu = engines
    got = port.query(sql)
    assert got.metrics["backend"] == "torch-cpu", f"fell back: {sql}"
    gdf = _canon(got)
    _assert_same_rows(gdf, _canon(cpu.query(sql)), f"oracle: {sql}")
    _assert_same_rows(gdf, _canon(jax_dev.query(sql)), f"jax: {sql}")


@pytest.mark.parametrize("seed", range(N_QUERIES))
def test_fuzz_port_matches_oracle(seed):
    """The generated queries of ``test_fuzz_parity.py``, the joins (whose
    aggregates draw on ``_AGGS_JOIN``) included."""
    t1, t2, sql = fuzz_case(seed)
    port = _port()
    port.register("t1", t1)
    port.register("t2", t2)
    cpu = make_engine("cpu")
    mirror_tables(port, cpu)
    got = port.query(sql)
    assert got.metrics["backend"] == "torch-cpu", sql
    _assert_same_rows(_canon(got), _canon(cpu.query(sql)), sql)


def test_ordered_query_preserves_order(engines):
    port, _, cpu = engines
    sql = "SELECT region, amount FROM sales ORDER BY amount DESC LIMIT 20"
    g = port.query(sql).to_pandas()
    e = cpu.query(sql).to_pandas()
    np.testing.assert_array_equal(g.amount.to_numpy(), e.amount.to_numpy())
    assert list(g.region) == list(e.region)


def test_join_runs_on_device(engines):
    shared, _, cpu = engines
    port = _port()  # a fresh result cache: the corpus ran this query
    port.catalog = shared.catalog
    sql = ("SELECT s.amount, c.customer_name FROM sales s JOIN customers c "
           "ON s.customer_id = c.customer_id WHERE s.amount > 180")
    got = port.query(sql)
    assert got.metrics["backend"] == "torch-cpu"
    _assert_same_rows(_canon(got), _canon(cpu.query(sql)), sql)


def test_all_valid_masks_drop_at_host_boundary(engines):
    port, _, _ = engines
    # every region has some non-null v, so the SUM's validity is all-True
    r = port.query("SELECT region, SUM(v) AS s FROM nullt GROUP BY region")
    assert all(c.validity is None for c in r.batch().columns)


# ---------------------------------------------------------------------------
# the two bench queries (BASELINE configs 1 and 2) at small size
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def bench_engines():
    rng = np.random.default_rng(0)
    n = 70_000  # above the filter_agg kernel's 64K-row gate
    port = _port(max_groups=1 << 23, enable_cache=False)
    port.register("fa", {"k": rng.integers(0, 1 << 20, n),
                         "v": rng.integers(0, 1000, n)})
    rng = np.random.default_rng(1)
    port.register("gb", {"k": rng.integers(0, 4000, 40_000),
                         "v": rng.integers(0, 1_000_000, 40_000)})
    jax_dev = make_engine("device", max_groups=1 << 23,
                          min_shape_bucket=1 << 16, enable_cache=False)
    cpu = make_engine("cpu")
    mirror_tables(port, jax_dev, cpu)
    return port, jax_dev, cpu


@pytest.mark.parametrize("sql,counter", [
    ("SELECT COUNT(*) AS n, SUM(v) AS s FROM fa WHERE v > 500",
     "torch_filter_agg_path"),
    ("SELECT k, SUM(v) AS s, MIN(v) AS mn, MAX(v) AS mx FROM gb GROUP BY k",
     "torch_seg_agg_path"),
])
def test_bench_queries_take_the_kernel_paths(bench_engines, sql, counter):
    port, jax_dev, cpu = bench_engines
    got, hits = _bumped(counter, lambda: port.query(sql))
    assert got.metrics["backend"] == "torch-cpu"
    assert hits == 1, f"{counter} not taken for: {sql}"
    gdf = _canon(got)
    _assert_same_rows(gdf, _canon(cpu.query(sql)), f"oracle: {sql}")
    _assert_same_rows(gdf, _canon(jax_dev.query(sql)), f"jax: {sql}")


@pytest.mark.parametrize("sql,fused", [
    ("SELECT COUNT(*) AS n, SUM(v) AS s, MIN(v) AS mn, MAX(v) AS mx, "
     "AVG(v) AS a FROM fa WHERE 500 < v", True),
    ("SELECT COUNT(k) AS c, MAX(k) AS mk FROM fa WHERE v <= 10", True),
    ("SELECT COUNT(*) AS n, MIN(v) AS mn FROM fa WHERE v > 2000000", True),
    ("SELECT COUNT(*) AS n FROM fa WHERE v + 1 > 500", False),
    ("SELECT k, COUNT(*) AS n FROM fa WHERE v > 990 GROUP BY k", False),
])
def test_filter_agg_matcher(bench_engines, sql, fused):
    port, _, cpu = bench_engines
    got, hits = _bumped("torch_filter_agg_path", lambda: port.query(sql))
    assert hits == (1 if fused else 0), sql
    _assert_same_rows(_canon(got), _canon(cpu.query(sql)), sql)


def test_use_pallas_false_still_correct(bench_engines):
    shared, _, cpu = bench_engines
    port = _port(use_pallas=False)
    port.catalog = shared.catalog
    sql = "SELECT k, SUM(v) AS s, MIN(v) AS mn FROM gb GROUP BY k"
    got, hits = _bumped("torch_seg_agg_path", lambda: port.query(sql))
    assert hits == 0
    _assert_same_rows(_canon(got), _canon(cpu.query(sql)), sql)
    sql = "SELECT COUNT(*) AS n, SUM(v) AS s FROM fa WHERE v > 500"
    got, hits = _bumped("torch_filter_agg_path", lambda: port.query(sql))
    assert hits == 0
    _assert_same_rows(_canon(got), _canon(cpu.query(sql)), sql)


@pytest.mark.parametrize("rows", [1000, 5000])  # general path, kernel path
def test_group_capacity_overflow_regrows(rows):
    port = _port(max_groups=16)
    port.register("t", {"k": np.arange(rows) % 300, "v": np.arange(rows)})
    cpu = make_engine("cpu")
    mirror_tables(port, cpu)
    sql = "SELECT k, SUM(v) AS s, MAX(v) AS mx FROM t GROUP BY k"
    got = port.query(sql)
    assert got.metrics["backend"] == "torch-cpu"
    assert got.num_rows == 300
    _assert_same_rows(_canon(got), _canon(cpu.query(sql)), sql)


def test_int64_exact_sums():
    port = _port()
    big = np.array([2**53 + 1, 2**53 + 3, 5, -7], dtype=np.int64)
    port.register("t", {"g": np.array([1, 1, 2, 2]), "a": big})
    d = port.query("SELECT g, SUM(a) AS s FROM t GROUP BY g").to_pandas()
    assert list(d.sort_values("g").s) == [2**54 + 4, -2]


@pytest.mark.parametrize("sql", [
    "SELECT k, SUM(v) AS s FROM e GROUP BY k",
    "SELECT COUNT(*) AS n, SUM(v) AS s FROM e",
    "SELECT v FROM e ORDER BY v LIMIT 3",
    "SELECT DISTINCT k FROM e",
    "SELECT MIN(v) AS mn, MAX(v) AS mx, COUNT(DISTINCT k) AS d FROM e",
    "SELECT k, v, COUNT(*) AS n FROM e WHERE v > 0 GROUP BY k, v",
    "SELECT k FROM e ORDER BY k DESC LIMIT 2 OFFSET 1",
])
def test_empty_table(sql):
    """An empty table is one row that no operator sees as valid."""
    port = _port()
    port.register("e", {"k": np.zeros(0, np.int64), "v": np.zeros(0, np.int64)})
    cpu = make_engine("cpu")
    mirror_tables(port, cpu)
    got = port.query(sql)
    assert got.metrics["backend"] == "torch-cpu"
    _assert_same_rows(_canon(got), _canon(cpu.query(sql)), sql)


# ---------------------------------------------------------------------------
# joins: the queries of test_joins.py and test_groupjoin.py, each on the
# route the JAX engine takes (JAX bumps its counters while tracing; the port
# while running)
# ---------------------------------------------------------------------------

ROUTES = {"pallas_join_stream_trace": "torch_join_stream_path",
          "sorted_global_join_agg": "torch_sorted_global_join_agg"}


def _routes_taken(fn, counters, metrics):
    """The ``counters`` of the registry ``metrics`` that ``fn`` bumped."""
    before = {c: metrics.counters.get(c, 0) for c in counters}
    out = fn()
    return out, {c for c in counters
                 if metrics.counters.get(c, 0) > before[c]}


def _check_join_query(port, jax_dev, cpu, sql, jax_routed=None):
    """The port's rows equal the oracle's and ``jax_dev``'s, and its routes
    are those the JAX engine ``jax_routed`` takes (``jax_dev`` itself
    unless given)."""
    got, port_routes = _routes_taken(lambda: port.query(sql),
                                     ROUTES.values(), GLOBAL_METRICS)
    exp, jax_routes = _routes_taken(lambda: jax_dev.query(sql), ROUTES,
                                    JAX_METRICS)
    if jax_routed is not None:
        _, jax_routes = _routes_taken(lambda: jax_routed.query(sql), ROUTES,
                                      JAX_METRICS)
    assert got.metrics["backend"] == "torch-cpu", sql
    assert port_routes == {ROUTES[r] for r in jax_routes}, sql
    # the routes the result reports are the counters the query bumped
    assert set(got.metrics["routes"]) & set(ROUTES.values()) == port_routes
    gdf = _canon(got)
    _assert_same_rows(gdf, _canon(cpu.query(sql)), f"oracle: {sql}")
    _assert_same_rows(gdf, _canon(exp), f"jax: {sql}")


GROUPJOIN_QUERIES = list(test_groupjoin.QUERIES) + [
    # test_sorted_space_global_join_agg
    "SELECT COUNT(*) AS n, SUM(l.k + r.k) AS s FROM l JOIN r ON l.k = r.k",
    "SELECT MIN(l.k) AS mn, MAX(r.k) AS mx, AVG(l.k) AS a "
    "FROM l JOIN r ON l.k = r.k",
    # test_decomposable_pair_aggregates
    "SELECT COUNT(*) AS n, SUM(l.v + r.w) AS s FROM l JOIN r ON l.k = r.k",
    "SELECT SUM(r.w) AS sw, AVG(l.v + r.w) AS a, MIN(r.w) AS mn, "
    "MAX(l.v) AS mx, COUNT(r.w) AS c FROM l JOIN r ON l.k = r.k",
    "SELECT SUM(l.v * 2 + r.w) AS s FROM l JOIN r ON l.k = r.k",
    # test_sorted_grouped_join_agg_opt_in
    "SELECT l.v AS g, COUNT(*) AS n, SUM(l.v) AS s, AVG(l.v) AS a, "
    "MIN(l.v) AS mn FROM l JOIN r ON l.k = r.k GROUP BY l.v ORDER BY g",
    # test_groupjoin_ineligible_falls_back
    "SELECT SUM(l.v * r.w) AS s FROM l JOIN r ON l.k = r.k",
]


@pytest.fixture(scope="module", params=[None, True, False],
                ids=["sorted_auto", "sorted_on", "sorted_off"])
def groupjoin_engines(request):
    """The tables of test_groupjoin.py on the port, on JAX's engine under
    one ``use_sorted_join_agg``, and on the oracle; then, where that
    setting is not JAX's default (None), a JAX engine at the default, whose
    routes the port takes: the port has the default as its one behaviour."""
    rng = np.random.default_rng(7)
    nk = 40
    lv = rng.integers(0, 100, 1500).astype(np.int64)
    tables = {
        "l": {"k": rng.integers(0, nk, 1500).astype(np.int64), "v": lv},
        "r": {"k": rng.integers(0, nk, 900).astype(np.int64),
              "w": rng.integers(0, 100, 900).astype(np.int64)},
    }
    port = _port(join_expansion=1.0)
    for name, t in tables.items():
        port.register(name, t)
    jax_cfg = dict(join_expansion=1.0, min_shape_bucket=64)
    jax_dev = make_engine("device", use_sorted_join_agg=request.param,
                          **jax_cfg)
    cpu = make_engine("cpu")
    mirror_tables(port, jax_dev, cpu)
    jax_routed = None
    if request.param is not None:
        jax_routed = make_engine("device", **jax_cfg)
        mirror_tables(port, jax_routed)
    return port, jax_dev, cpu, jax_routed


@pytest.mark.parametrize("sql", GROUPJOIN_QUERIES,
                         ids=range(len(GROUPJOIN_QUERIES)))
def test_groupjoin_queries_take_jax_routes(groupjoin_engines, sql):
    port, jax_dev, cpu, jax_routed = groupjoin_engines
    _check_join_query(port, jax_dev, cpu, sql, jax_routed)


def _joins_case(name):
    """(config, JAX's shape-bucket setting, tables, sql) of the engine tests
    in test_joins.py: ``min_shape_bucket`` sets the JAX engine's capacities
    and so its routes, and the port, which runs eagerly, has no such
    option."""
    rng = np.random.default_rng({"presorted": 31, "stream": 33,
                                 "stream_grouped": 34}[name])
    if name == "presorted":
        nb = 5000
        bk = np.sort(rng.integers(0, nb // 2, nb)).astype(np.int64)
        pk = rng.integers(0, nb // 2, 8000).astype(np.int64)
        return (dict(), dict(min_shape_bucket=256),
                {"b": {"k": bk, "w": np.arange(nb, dtype=np.int64)},
                 "p": {"k": pk}},
                "SELECT COUNT(*) AS n, SUM(b.w) AS s FROM p JOIN b "
                "ON p.k = b.k")
    if name == "stream":
        n = 40_000
        lk = rng.integers(0, n // 2, n).astype(np.int64)
        rk = rng.integers(0, n // 2, n).astype(np.int64)
        lv = rng.integers(0, 1000, n).astype(np.int64)
        rw = rng.integers(0, 1000, n).astype(np.int64)
        return (dict(join_expansion=2.5), dict(min_shape_bucket=1 << 14),
                {"l": {"k": lk, "v": lv}, "r": {"k": rk, "w": rw}},
                "SELECT COUNT(*) AS n, SUM(l.v + r.w) AS s, "
                "MIN(l.v - r.w) AS mn FROM l JOIN r ON l.k = r.k")
    nl, nr, nkeys = 25_000, 10_000, 1_750
    lk = rng.integers(0, nkeys, nl).astype(np.int64)
    rk = rng.integers(0, nkeys, nr).astype(np.int64)
    rg = rng.integers(0, 7, nr).astype(np.int64)
    return (dict(join_expansion=60.0), dict(min_shape_bucket=1 << 14),
            {"l": {"k": lk}, "r": {"k": rk, "g": rg}},
            "SELECT r.g AS g, COUNT(*) AS n FROM l JOIN r ON l.k = r.k "
            "GROUP BY r.g")


@pytest.mark.parametrize("name", ["presorted", "stream", "stream_grouped"])
def test_joins_queries_take_jax_routes(name):
    cfg, jax_buckets, tables, sql = _joins_case(name)
    port = _port(**cfg)
    for tname, t in tables.items():
        port.register(tname, t)
    jax_dev = make_engine("device", **cfg, **jax_buckets)
    cpu = make_engine("cpu")
    mirror_tables(port, jax_dev, cpu)
    _check_join_query(port, jax_dev, cpu, sql)


@pytest.mark.parametrize("use_pallas", [True, False])
def test_stream_join_engages_and_matches_oracle(monkeypatch, use_pallas):
    """Port twin of test_joins.py's test: a >= 32K-row int32-foldable inner
    join that must materialize pairs runs the streaming join, whose
    stream_compact and expand_fill take their plain versions on the CPU;
    ``use_pallas=False`` takes the general sort join instead."""
    calls = {"stream_compact_plain": 0, "expand_fill_plain": 0}
    for fn in calls:
        orig = getattr(tjs, fn)

        def counted(*args, _orig=orig, _fn=fn):
            calls[_fn] += 1
            return _orig(*args)

        monkeypatch.setattr(tjs, fn, counted)
    cfg, _, tables, sql = _joins_case("stream")
    port = _port(use_pallas=use_pallas, **cfg)
    for tname, t in tables.items():
        port.register(tname, t)
    cpu = make_engine("cpu")
    mirror_tables(port, cpu)
    got, hits = _bumped("torch_join_stream_path", lambda: port.query(sql))
    assert got.metrics["backend"] == "torch-cpu"
    assert hits == (1 if use_pallas else 0)
    # records + build rows through stream_compact, one expansion
    assert calls == ({"stream_compact_plain": 2, "expand_fill_plain": 1}
                     if use_pallas else
                     {"stream_compact_plain": 0, "expand_fill_plain": 0})
    _assert_same_rows(_canon(got), _canon(cpu.query(sql)), sql)


@pytest.mark.parametrize("n", [500, 20_000])  # general sort join, stream join
def test_join_capacity_overflow_regrows(n):
    rng = np.random.default_rng(12)
    port = _port(join_expansion=0.05)
    port.register("l", {"k": rng.integers(0, n // 4, n),
                        "v": rng.integers(0, 100, n)})
    port.register("r", {"k": rng.integers(0, n // 4, n),
                        "w": rng.integers(0, 100, n)})
    cpu = make_engine("cpu")
    mirror_tables(port, cpu)
    sql = "SELECT l.v, r.w FROM l JOIN r ON l.k = r.k"
    got, hits = _bumped("torch_join_stream_path", lambda: port.query(sql))
    assert got.metrics["backend"] == "torch-cpu"
    grown = {k: v for k, v in port._get_device_executor()._cap_override.items()
             if k[0] == "join"}
    assert grown and all(v > 2 * n * 0.05 for v in grown.values())
    assert hits > 1 if n > 10_000 else hits == 0  # one run per capacity
    _assert_same_rows(_canon(got), _canon(cpu.query(sql)), sql)


def test_join_capacity_past_int32_slots_raises():
    port = _port(join_expansion=1e6)
    port.register("l", {"k": np.arange(3000) % 10, "v": np.arange(3000)})
    port.register("r", {"k": np.arange(3000) % 10, "w": np.arange(3000)})
    with pytest.raises(RuntimeError, match="match slots"):
        port.query("SELECT l.v, r.w FROM l JOIN r ON l.k = r.k")


# ---------------------------------------------------------------------------
# device state, device choice, no JAX
# ---------------------------------------------------------------------------

def _bit_equal(a, b):
    """Same dtype, shape and bytes (NaN payloads included)."""
    return (a.dtype == b.dtype and a.shape == b.shape
            and a.numpy().tobytes() == b.numpy().tobytes())


def test_tables_from_numpy_matches_device_tables(engines):
    port, jax_dev, _ = engines
    for sql in ("SELECT * FROM nullt", "SELECT * FROM sales",
                "SELECT * FROM customers"):
        (name, jentry), = jax_dev._get_device_executor()._device_tables(
            jax_dev.plan_query(sql)).items()
        as_np = dict(jentry)
        as_np["arrays"] = [(np.asarray(d), None if v is None else np.asarray(v))
                           for d, v in jentry["arrays"]]
        as_np["narrow"] = {i: np.asarray(a) for i, a in jentry["narrow"].items()}
        as_np["dense_idx"] = {i: np.asarray(a)
                              for i, a in jentry["dense_idx"].items()}
        got = tdev.tables_from_numpy(as_np, torch.device("cpu"))
        own = port._get_device_executor()._device_tables(
            port.plan_query(sql))[name]
        for key in ("num_rows", "capacity", "int32_ok", "ranges", "uniques"):
            assert got[key] == own[key], key
        # the two packages' schema classes differ: compare field by field
        assert ([(f.name, f.dtype.value, f.nullable) for f in got["schema"]]
                == [(f.name, f.dtype.value, f.nullable)
                    for f in own["schema"]])
        assert len(got["dicts"]) == len(own["dicts"])
        for a, b in zip(got["dicts"], own["dicts"]):
            assert tdev._dicts_equal(a, b)
        for (gd, gv), (od, ov) in zip(got["arrays"], own["arrays"]):
            assert _bit_equal(gd, od)
            assert (gv is None) == (ov is None)
            if gv is not None:
                assert _bit_equal(gv, ov)
        assert sorted(got["narrow"]) == sorted(own["narrow"])
        for i in got["narrow"]:
            assert _bit_equal(got["narrow"][i], own["narrow"][i])
        # the persistent join index of unique key columns (customer_id)
        assert sorted(got["dense_idx"]) == sorted(own["dense_idx"])
        assert (name == "customers") == bool(own["dense_idx"])
        for i in got["dense_idx"]:
            assert _bit_equal(got["dense_idx"][i], own["dense_idx"][i])


def test_cuda_device_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError):
        TorchOlapEngine(device="cuda")


def test_port_never_imports_jax(tmp_path):
    code = textwrap.dedent("""
        import sys
        import numpy as np
        from gpu_olap_tpu_torch import EngineConfig, TorchOlapEngine
        from gpu_olap_tpu_torch.ops import hashing
        from gpu_olap_tpu_torch.parallel import (
            collectives, dist_executor, dist_ops, mesh, shuffle, skew)
        eng = TorchOlapEngine(EngineConfig(), device="cpu")
        eng.register("t", {"k": np.arange(5000) % 7, "v": np.arange(5000)})
        r = eng.query("SELECT k, SUM(v) AS s FROM t GROUP BY k")
        assert r.num_rows == 7 and r.metrics["backend"] == "torch-cpu"
        dist = TorchOlapEngine(EngineConfig(mesh_shape=(8,)), device="cpu",
                               mesh_devices=["cpu"] * 8)
        dist.catalog = eng.catalog
        r = dist.query("SELECT k, SUM(v) AS s FROM t GROUP BY k")
        assert r.num_rows == 7 and r.metrics["backend"] == "torch-distributed"
        assert "jax" not in sys.modules, "the port imported jax"
        print("ok")
    """)
    import os

    import gpu_olap_tpu_torch

    root = os.path.dirname(os.path.dirname(gpu_olap_tpu_torch.__file__))
    env = dict(os.environ, PYTHONPATH=root)
    res = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


@pytest.mark.parametrize("script", ["chip_smoke.py", "chip_trace.py"])
def test_chip_scripts_name_no_jax_package_module(script):
    """The chip scripts reach the engine only through the port: they import
    no ``gpu_olap_tpu`` module and no JAX by name."""
    import ast
    import os

    import gpu_olap_tpu_torch

    root = os.path.dirname(os.path.dirname(gpu_olap_tpu_torch.__file__))
    with open(os.path.join(root, script)) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module or "")
    top = {n.split(".")[0] for n in names}
    assert "gpu_olap_tpu_torch" in top
    assert not top & {"gpu_olap_tpu", "jax", "jaxlib"}, sorted(names)


def test_string_case_groups_where_jax_raises():
    """GROUP BY a string-valued CASE: each string literal is code 0 of its
    own one-entry dictionary, and the JAX package's evaluators merge those
    codes without their dictionaries (one group, then an IndexError when the
    result is read).  The port's evaluators re-code the branches onto the
    union of their dictionaries."""
    v = np.array([-1, 5, 7, -2])
    case = "CASE WHEN v > 0 THEN 'p' ELSE 'n' END"
    sql = f"SELECT {case} AS sg, COUNT(*) AS c FROM t GROUP BY {case}"
    for backend, label in (("auto", "torch-cpu"), ("cpu", "cpu")):
        port = _port(backend=backend)
        port.register("t", {"v": v})
        res = port.query(sql)
        assert res.metrics["backend"] == label
        got = res.to_pydict()
        assert dict(zip(got["sg"], got["c"])) == {"p": 2, "n": 2}
    for backend in ("device", "cpu"):
        jax_eng = make_engine(backend)
        jax_eng.register("t", {"v": v})
        with pytest.raises(IndexError):
            jax_eng.query(sql).to_pydict()


@pytest.mark.parametrize("sql,cols", [
    ("SELECT MIN(t1.s) AS lo, MAX(t1.s) AS hi, COUNT(*) AS n FROM t1 "
     "JOIN t2 ON t1.k = t2.k", ("lo", "hi", "n")),
    ("SELECT MIN(t.a) AS a, MAX(t.s) AS hi FROM t1 t JOIN t2 ON t.k = t2.k",
     ("a", "hi")),
    ("SELECT MIN(t2.g) AS glo, MAX(t2.g) AS ghi, SUM(t1.a) AS sa FROM t1 "
     "JOIN t2 ON t1.k = t2.k", ("glo", "ghi", "sa")),
    ("SELECT MAX(t1.s) AS hi, MIN(t2.g) AS glo FROM t1 JOIN t2 "
     "ON t1.k = t2.k WHERE t1.a > 50", ("hi", "glo")),
    # joined on the string itself: the key lane holds unified codes
    ("SELECT MIN(t1.s) AS lo, SUM(t2.k) AS sk FROM t1 JOIN t2 "
     "ON t1.s = t2.h", ("lo", "sk")),
    ("SELECT MAX(t2.h) AS hh, MIN(t1.s) AS lo, COUNT(*) AS n, "
     "SUM(t1.a) AS sa FROM t1 JOIN t2 ON t1.s = t2.h WHERE t1.a > 50",
     ("hh", "lo", "n", "sa")),
])
def test_global_join_string_minmax_where_jax_raises(sql, cols):
    """A global MIN/MAX of a string column over an inner join, reduced in
    the merge-sorted key space: the string lane's codes rode the sort
    without their dictionary, and reading the result raised IndexError (the
    JAX device engine still does).  The port keeps each lane's dictionary;
    joined on the string column, the column rides as a payload lane.
    Unmatched rows on both sides hold the extreme strings."""
    rng = np.random.default_rng(7)
    n, m = 3000, 120
    k1 = rng.integers(0, 100, n).astype(np.int64)
    s = np.array(["delta", "echo", "foxtrot", "golf"],
                 dtype=object)[rng.integers(0, 4, n)]
    s[k1 % 2 == 1] = np.where(rng.random(int((k1 % 2 == 1).sum())) < 0.5,
                              "alpha", "zulu")
    k2 = np.concatenate([2 * rng.integers(0, 50, m - 2), [201, 203]])
    g = np.array(["kilo", "lima", "mike", "oscar"],
                 dtype=object)[rng.integers(0, 4, m)]
    g[-2:] = ["aardvark", "zzz"]
    h = np.array(["alpha", "delta", "golf", "hotel"],
                 dtype=object)[rng.integers(0, 4, m)]
    a = rng.integers(0, 100, n).astype(np.int64)
    tables = {"t1": {"k": k1, "a": a, "s": s}, "t2": {"k": k2, "g": g, "h": h}}
    port = _port()
    for name, t in tables.items():
        port.register(name, t)
    res = port.query(sql)
    assert "torch_sorted_global_join_agg" in res.metrics["routes"]
    got = res.to_pydict()
    assert list(got) == list(cols)
    lkey, rkey = (s, h) if "t2.h" in sql else (k1, k2)
    li, rj = np.nonzero(lkey[:, None] == rkey[None, :])
    if "WHERE" in sql:
        li, rj = li[a[li] > 50], rj[a[li] > 50]
    want = {"lo": s[li].min(), "hi": s[li].max(), "n": li.size,
            "a": a[li].min(), "glo": g[rj].min(), "ghi": g[rj].max(),
            "sa": a[li].sum(), "hh": h[rj].max(), "sk": k2[rj].sum()}
    for c in cols:
        assert got[c][0] == want[c], c
    oracle, device = make_engine("cpu"), make_engine("device")
    mirror_tables(port, oracle, device)
    exp = oracle.query(sql).to_pydict()
    assert {c: list(v) for c, v in got.items()} == \
        {c: list(v) for c, v in exp.items()}
    with pytest.raises(IndexError):
        device.query(sql).to_pydict()
