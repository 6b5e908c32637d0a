"""The port's single-device SQL path as a whole, on the CPU.

Each query runs on three engines that share one ``Catalog``: the port
(``TorchOlapEngine(device="cpu")``), the JAX device engine and the NumPy
oracle.  Results are compared as row multisets: integers exactly, floats
within ``rtol=1e-12`` (aggregates are summed in another order) and
``atol=1e-12`` (for sums near zero).
"""

import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from conftest import make_engine
from test_device_parity import QUERIES, _populate
from test_fuzz_parity import N_QUERIES, _gen_query, _gen_tables

from gpu_olap_tpu import EngineConfig
from gpu_olap_tpu.utils.metrics import GLOBAL_METRICS
from gpu_olap_tpu_torch import TorchOlapEngine
from gpu_olap_tpu_torch.executor import device as tdev

SLICE_QUERIES = [q for q in QUERIES if " JOIN " not in q.upper()]


def _port(**kwargs):
    return TorchOlapEngine(EngineConfig(**kwargs), device="cpu")


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
    _populate(port, np.random.default_rng(123))
    jax_dev = make_engine("device")
    jax_dev.catalog = port.catalog
    cpu = make_engine("cpu")
    cpu.catalog = port.catalog
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
    """The generated queries of ``test_fuzz_parity.py`` without joins
    (those fall back to the oracle, so they compare nothing)."""
    rng = np.random.default_rng(1000 + seed)
    t1, t2 = _gen_tables(rng)
    sql = _gen_query(rng)
    port = _port(min_shape_bucket=256)
    port.register("t1", t1)
    port.register("t2", t2)
    cpu = make_engine("cpu")
    cpu.catalog = port.catalog
    got = port.query(sql)
    if " JOIN " in sql:
        assert got.metrics["backend"] == "cpu-fallback"
        return
    assert got.metrics["backend"] == "torch-cpu", sql
    _assert_same_rows(_canon(got), _canon(cpu.query(sql)), sql)


@pytest.mark.cuda
def test_cuda_port_matches_oracle_on_corpus():
    """The parity corpus and the fuzz queries on the GPU: every slice query
    must run on the card (``torch-cuda``) and equal the oracle."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    port = TorchOlapEngine(EngineConfig(), device="cuda")
    _populate(port, np.random.default_rng(123))
    cpu = make_engine("cpu")
    cpu.catalog = port.catalog
    for sql in SLICE_QUERIES:
        got = port.query(sql)
        assert got.metrics["backend"] == "torch-cuda", sql
        _assert_same_rows(_canon(got), _canon(cpu.query(sql)), sql)
    for seed in range(N_QUERIES):
        rng = np.random.default_rng(1000 + seed)
        t1, t2 = _gen_tables(rng)
        sql = _gen_query(rng)
        if " JOIN " in sql:
            continue
        port.register("t1", t1)
        port.register("t2", t2)
        got = port.query(sql)
        assert got.metrics["backend"] == "torch-cuda", sql
        _assert_same_rows(_canon(got), _canon(cpu.query(sql)), sql)


def test_ordered_query_preserves_order(engines):
    port, _, cpu = engines
    sql = "SELECT region, amount FROM sales ORDER BY amount DESC LIMIT 20"
    g = port.query(sql).to_pandas()
    e = cpu.query(sql).to_pandas()
    np.testing.assert_array_equal(g.amount.to_numpy(), e.amount.to_numpy())
    assert list(g.region) == list(e.region)


def test_join_falls_back_to_cpu(engines):
    port, _, cpu = engines
    sql = ("SELECT s.amount, c.customer_name FROM sales s JOIN customers c "
           "ON s.customer_id = c.customer_id WHERE s.amount > 180")
    got = port.query(sql)
    assert got.metrics["backend"] == "cpu-fallback"
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
    port = _port(max_groups=1 << 23, min_shape_bucket=1 << 16,
                 enable_cache=False)
    port.register("fa", {"k": rng.integers(0, 1 << 20, n),
                         "v": rng.integers(0, 1000, n)})
    rng = np.random.default_rng(1)
    port.register("gb", {"k": rng.integers(0, 4000, 40_000),
                         "v": rng.integers(0, 1_000_000, 40_000)})
    jax_dev = make_engine("device", max_groups=1 << 23,
                          min_shape_bucket=1 << 16, enable_cache=False)
    jax_dev.catalog = port.catalog
    cpu = make_engine("cpu")
    cpu.catalog = port.catalog
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
    _, _, cpu = bench_engines
    port = _port(use_pallas=False)
    port.catalog = cpu.catalog
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
    cpu.catalog = port.catalog
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
    cpu.catalog = port.catalog
    got = port.query(sql)
    assert got.metrics["backend"] == "torch-cpu"
    _assert_same_rows(_canon(got), _canon(cpu.query(sql)), sql)


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
        plan = port.plan_query(sql)
        (name, jentry), = jax_dev._get_device_executor()._device_tables(
            plan).items()
        as_np = dict(jentry)
        as_np["arrays"] = [(np.asarray(d), None if v is None else np.asarray(v))
                           for d, v in jentry["arrays"]]
        as_np["narrow"] = {i: np.asarray(a) for i, a in jentry["narrow"].items()}
        got = tdev.tables_from_numpy(as_np, torch.device("cpu"))
        own = port._get_device_executor()._device_tables(plan)[name]
        for key in ("num_rows", "capacity", "int32_ok", "ranges", "uniques",
                    "schema"):
            assert got[key] == own[key], key
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
        eng = TorchOlapEngine(EngineConfig(), device="cpu")
        eng.register("t", {"k": np.arange(5000) % 7, "v": np.arange(5000)})
        r = eng.query("SELECT k, SUM(v) AS s FROM t GROUP BY k")
        assert r.num_rows == 7 and r.metrics["backend"] == "torch-cpu"
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
