"""The port's host surface against the JAX package's, on the same seeded
inputs: twins of ``test_engine_cache.py``, ``test_engine_concurrent.py``,
``test_interop.py`` and ``test_native.py`` on the port's copies (the
engines on ``device="cpu"``), the binding constructor
(``EngineConfig.from_kwargs``, ``GpuOlapEngine``) and the package exports,
the restored host helpers, ``tracing.configure``/``span``, and the metrics
registry under threads that bump it while a query reads its routes."""

import ast
import asyncio
import logging
import os
import shutil
import sys
import threading
import time
from concurrent.futures import wait

import numpy as np
import pandas as pd
import pyarrow as pa
import pytest
import torch

import gpu_olap_tpu as jgot
from conftest import make_engine
from gpu_olap_tpu import native as jnative
from gpu_olap_tpu.interop import arrow as jarrow
from gpu_olap_tpu.interop import columnar as jcol
from gpu_olap_tpu.utils import tracing as jtracing
from gpu_olap_tpu.utils.metrics import MetricsRegistry as JMetricsRegistry

import gpu_olap_tpu_torch as got
from gpu_olap_tpu_torch import engine as tengine
from gpu_olap_tpu_torch import native as tnative
from gpu_olap_tpu_torch.interop import arrow as tarrow
from gpu_olap_tpu_torch.interop.columnar import (
    Column, ColumnBatch, DType, Field, Schema, concat_batches,
    dict_encode_strings,
)
from gpu_olap_tpu_torch.utils import tracing
from gpu_olap_tpu_torch.utils.metrics import MetricsRegistry


@pytest.fixture(autouse=True, scope="module")
def jax_native_loaded():
    """The JAX package's native helper, loaded before any test compares
    with it.  Its build step runs ``g++ -o _fastconv.so`` straight onto the
    final path, so a test worker that loads the file while another worker
    still writes it gets ``None`` and keeps it (ROADMAP.md C).  While the
    file is there and newer than its source, which is when the build step
    loads it without compiling, load it again until it loads, within the
    build step's own 120 s timeout.  Where the build failed and left no
    such file, or no C++ compiler exists, both packages take their NumPy
    paths."""
    def written() -> bool:
        return (os.path.exists(jnative._SO) and os.path.getmtime(jnative._SO)
                >= os.path.getmtime(jnative._SRC))

    deadline = time.monotonic() + 120
    while (jnative.get_lib() is None and shutil.which("g++") is not None
           and time.monotonic() < deadline):
        time.sleep(0.25)
        if not written():
            break
        with jnative._lock:
            jnative._tried = False


def _port(backend: str = "auto", **kwargs):
    return got.TorchOlapEngine(got.EngineConfig(backend=backend, **kwargs),
                               device="cpu")


def _same_batch(tb, jb):
    """The port's batch equals the JAX package's: names, dtypes, data,
    validity and dictionaries."""
    assert tb.num_rows == jb.num_rows
    assert tb.schema.names == jb.schema.names
    assert [f.dtype.value for f in tb.schema] == \
        [f.dtype.value for f in jb.schema]
    for tc, jc in zip(tb.columns, jb.columns):
        tc, jc = tc.to_numpy(), jc.to_numpy()
        assert tc.data.dtype == jc.data.dtype
        np.testing.assert_array_equal(tc.data, jc.data)
        assert (tc.validity is None) == (jc.validity is None)
        if tc.validity is not None:
            np.testing.assert_array_equal(tc.validity, jc.validity)
        assert (tc.dictionary is None) == (jc.dictionary is None)
        if tc.dictionary is not None:
            assert list(tc.dictionary) == list(jc.dictionary)


# ---------------------------------------------------------------------------
# the result cache (test_engine_cache.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend,label", [("cpu", "cpu"),
                                           ("auto", "torch-cpu")])
def test_result_cache_hit_and_invalidation(backend, label):
    eng = _port(backend, enable_cache=True)
    ref = make_engine("cpu", enable_cache=True)
    for e in (eng, ref):
        e.register("t", {"a": np.arange(10)})
    r1 = eng.query("SELECT SUM(a) AS s FROM t")
    assert r1.metrics["backend"] == label
    r2 = eng.query("SELECT SUM(a) AS s FROM t")
    assert r2.metrics["backend"] == "result-cache"
    assert r2.metrics["routes"] == []
    ref.query("SELECT SUM(a) AS s FROM t")
    assert ref.query("SELECT SUM(a) AS s FROM t").metrics["backend"] == \
        "result-cache"
    assert r2.to_pydict()["s"][0] == 45
    # re-registering the table invalidates
    for e in (eng, ref):
        e.register("t", {"a": np.arange(20)})
    r3 = eng.query("SELECT SUM(a) AS s FROM t")
    assert r3.metrics["backend"] == label
    assert r3.to_pydict()["s"][0] == 190 == \
        ref.query("SELECT SUM(a) AS s FROM t").to_pydict()["s"][0]


@pytest.mark.parametrize("backend,label", [("cpu", "cpu"),
                                           ("auto", "torch-cpu")])
def test_cache_disabled(backend, label):
    eng = _port(backend, enable_cache=False)
    eng.register("t", {"a": np.arange(10)})
    eng.query("SELECT SUM(a) AS s FROM t")
    r = eng.query("SELECT SUM(a) AS s FROM t")
    assert r.metrics["backend"] == label


# ---------------------------------------------------------------------------
# concurrent queries (test_engine_concurrent.py)
# ---------------------------------------------------------------------------

QUERIES = [
    "SELECT COUNT(*) AS n FROM t",
    "SELECT k, SUM(v) AS s FROM t GROUP BY k ORDER BY k",
    "SELECT COUNT(*) AS n, SUM(v) AS s FROM t WHERE v > 500",
    "SELECT t.k, SUM(t.v + u.w) AS s FROM t JOIN u ON t.k = u.k "
    "GROUP BY t.k ORDER BY t.k",
    "SELECT DISTINCT k FROM t ORDER BY k LIMIT 10",
]


@pytest.fixture(scope="module", params=["cpu", "device"])
def eng(request):
    e = _port(request.param, enable_cache=False)
    ref = make_engine("cpu")
    rng = np.random.default_rng(3)
    n = 20_000
    t = {"k": rng.integers(0, 50, n).astype(np.int64),
         "v": rng.integers(0, 1000, n).astype(np.int64)}
    u = {"k": np.arange(50, dtype=np.int64),
         "w": rng.integers(0, 10, 50).astype(np.int64)}
    for x in (e, ref):
        x.register("t", t)
        x.register("u", u)
    e.expected = {sql: ref.query(sql).to_pandas() for sql in QUERIES}
    e.label = "cpu" if request.param == "cpu" else "torch-cpu"
    yield e
    e.shutdown()


def _expected(eng):
    """The serial answers, each equal to the JAX package's oracle."""
    out = {}
    for sql in QUERIES:
        r = eng.query(sql)
        assert r.metrics["backend"] == eng.label
        out[sql] = r.to_pandas()
        pd.testing.assert_frame_equal(out[sql], eng.expected[sql],
                                      check_dtype=False)
    return out


def test_query_async_parallel_correctness(eng):
    exp = _expected(eng)
    futs = [(sql, eng.query_async(sql)) for sql in QUERIES * 6]
    done, not_done = wait([f for _, f in futs], timeout=300)
    assert not not_done
    for sql, f in futs:
        assert f.result().metrics["backend"] == eng.label
        pd.testing.assert_frame_equal(f.result().to_pandas(), exp[sql],
                                      check_dtype=False)


def test_query_async_future_api(eng):
    f = eng.query_async("SELECT COUNT(*) AS n FROM t")
    r = f.result(timeout=120)
    assert int(r.to_pydict()["n"][0]) == 20_000


def test_aquery_asyncio_gather(eng):
    exp = _expected(eng)

    async def run():
        results = await asyncio.gather(*(eng.aquery(sql) for sql in QUERIES))
        return dict(zip(QUERIES, results))

    got_ = asyncio.run(run())
    for sql, r in got_.items():
        pd.testing.assert_frame_equal(r.to_pandas(), exp[sql],
                                      check_dtype=False)


def test_concurrent_registration_and_queries(eng):
    """Catalog writes (new tables) interleaved with queries on other tables."""
    rng = np.random.default_rng(9)

    def register_and_query(i):
        name = f"side_{i}"
        eng.register(name, {"x": rng.integers(0, 5, 1000).astype(np.int64)})
        r = eng.query(f"SELECT COUNT(*) AS n FROM {name}")
        eng.drop_table(name)
        return int(r.to_pydict()["n"][0])

    futs = [eng._get_pool().submit(register_and_query, i) for i in range(8)]
    futs += [eng.query_async("SELECT COUNT(*) AS n FROM t") for _ in range(8)]
    done, not_done = wait(futs, timeout=300)
    assert not not_done
    assert [f.result() for f in futs[:8]] == [1000] * 8
    assert all(int(f.result().to_pydict()["n"][0]) == 20_000
               for f in futs[8:])


@pytest.mark.parametrize("backend", ["cpu", "auto"])
def test_result_cache_threadsafe(backend):
    e = _port(backend, enable_cache=True)
    e.register("t", {"v": np.arange(1000, dtype=np.int64)})
    sql = "SELECT SUM(v) AS s FROM t"
    futs = [e.query_async(sql) for _ in range(16)]
    done, not_done = wait(futs, timeout=120)
    assert not not_done
    vals = {int(f.result().to_pydict()["s"][0]) for f in futs}
    assert vals == {499500}
    backends = {f.result().meta["backend"] for f in futs}
    assert "result-cache" in backends  # later hits served from the cache
    e.shutdown()
    e.shutdown()  # idempotent
    assert e._pool is None


def test_shutdown_then_more_queries():
    """``shutdown`` drains the pool; a later ``query_async`` opens a new one."""
    e = _port(enable_cache=False)
    e.register("t", {"v": np.arange(10, dtype=np.int64)})
    assert int(e.query_async("SELECT SUM(v) AS s FROM t").result(
        timeout=60).to_pydict()["s"][0]) == 45
    e.shutdown()
    assert int(e.query_async("SELECT COUNT(*) AS n FROM t").result(
        timeout=60).to_pydict()["n"][0]) == 10
    e.shutdown()


def test_routes_stay_readable_while_other_threads_bump():
    """Engines on other devices bump the process-wide registry from their
    own pool threads, under their own device locks; a query reading its
    routes must neither raise ("dictionary changed size during iteration")
    nor lose a bump.  Eight threads bump fresh counter names while the main
    thread snapshots and diffs the routes, with a tiny switch interval."""
    reg = MetricsRegistry()
    stop = threading.Event()
    per_thread = 5_000

    def bumper(i):
        for j in range(per_thread):
            reg.bump(f"torch_stress_{i}_{j}")
            reg.bump("torch_shared")
            reg.record_span("span", 1e-6, rows_in=1)
        stop.wait(0)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    threads = [threading.Thread(target=bumper, args=(i,)) for i in range(8)]
    saved, tengine.GLOBAL_METRICS = tengine.GLOBAL_METRICS, reg
    try:
        for t in threads:
            t.start()
        seen = set()
        while any(t.is_alive() for t in threads):
            seen.update(tengine._routes_since(reg.snapshot()))
            seen.update(tengine._routes_since({}))
            reg.summary()
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=60)
        tengine.GLOBAL_METRICS = saved
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert "torch_shared" in seen
    assert reg.counters["torch_shared"] == 8 * per_thread
    assert reg.ops["span"].calls == reg.ops["span"].rows_in == 8 * per_thread
    assert len(reg.counters) == 8 * per_thread + 1


# ---------------------------------------------------------------------------
# the binding constructor and the package surface
# ---------------------------------------------------------------------------

def test_from_kwargs_maps_the_reference_names():
    kw = dict(max_gpu_memory=3 << 30, num_streams=3, use_unified_memory=False,
              batch_size=4096, max_groups=1 << 10)
    # use_unified_memory is accepted, and sets nothing of the port's
    cfg = got.EngineConfig.from_kwargs(**kw)
    assert (cfg.max_hbm_bytes, cfg.num_feed_buffers) == (3 << 30, 3)
    assert (cfg.batch_size, cfg.max_groups) == (4096, 1 << 10)
    assert got.EngineConfig.from_kwargs(use_unified_memory=True) == \
        got.EngineConfig()
    jcfg = jgot.EngineConfig.from_kwargs(**kw)
    assert jcfg.out_of_core is False
    # the port keeps a subset of JAX's options, under JAX's names
    fields = set(got.EngineConfig.__dataclass_fields__)
    assert fields <= set(jgot.EngineConfig.__dataclass_fields__)
    assert {f: getattr(cfg, f) for f in fields} == \
        {f: getattr(jcfg, f) for f in fields}


def test_every_engine_config_field_is_read_by_the_port():
    """Each option of the port's ``EngineConfig`` is read, as an attribute,
    by some module of the package other than ``config.py``: an option that
    no code reads is one a user sets for nothing."""
    pkg = os.path.dirname(got.__file__)
    read = set()
    for root, _dirs, files in os.walk(pkg):
        for name in files:
            path = os.path.join(root, name)
            if not name.endswith(".py") or \
                    path == os.path.join(pkg, "config.py"):
                continue
            with open(path) as f:
                tree = ast.parse(f.read())
            read |= {node.attr for node in ast.walk(tree)
                     if isinstance(node, ast.Attribute)
                     and isinstance(node.ctx, ast.Load)}
    fields = set(got.EngineConfig.__dataclass_fields__)
    assert fields - read == set()


@pytest.mark.parametrize("kw", [{"max_gpu_mem": 1}, {"num_stream": 8},
                                {"device": "cpu"}])
def test_from_kwargs_rejects_unknown_keys(kw):
    with pytest.raises(TypeError, match="Unknown EngineConfig options"):
        got.EngineConfig.from_kwargs(**kw)
    with pytest.raises(TypeError, match="Unknown EngineConfig options"):
        jgot.EngineConfig.from_kwargs(**kw)


def test_gpu_olap_engine_constructor():
    eng = got.GpuOlapEngine(device="cpu", max_gpu_memory=1 << 30,
                            num_streams=3, use_unified_memory=True)
    assert isinstance(eng, got.TorchOlapEngine)
    assert eng.device == torch.device("cpu")
    assert (eng.config.max_hbm_bytes, eng.config.num_feed_buffers) == \
        (1 << 30, 3)
    assert eng._get_pool()._max_workers == 3
    eng.shutdown()
    eng.register("t", {"k": np.arange(100) % 7, "v": np.arange(100)})
    r = eng.query("SELECT k, SUM(v) AS s FROM t GROUP BY k ORDER BY k")
    assert r.metrics["backend"] == "torch-cpu"
    assert list(r.to_pydict()["s"]) == \
        [int(np.arange(100)[np.arange(100) % 7 == k].sum()) for k in range(7)]
    with pytest.raises(TypeError, match="Unknown EngineConfig options"):
        got.GpuOlapEngine(device="cpu", max_gpu_mem=1)


def test_gpu_olap_engine_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the engine runs on it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        got.GpuOlapEngine()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        got.TpuOlapEngine(num_streams=4)


def test_gpu_olap_engine_mesh_devices_pass_through():
    eng = got.GpuOlapEngine(device="cpu", mesh_shape=(4,),
                            mesh_devices=["cpu"] * 4)
    assert eng.mesh.size == 4
    eng.register("t", {"k": np.arange(1000) % 13, "v": np.arange(1000)})
    r = eng.query("SELECT k, COUNT(*) AS n FROM t GROUP BY k")
    assert r.metrics["backend"] == "torch-distributed"
    assert sorted(r.to_pydict()["n"]) == sorted(np.bincount(
        np.arange(1000) % 13))


def test_package_exports_match_the_jax_package():
    assert set(jgot.__all__) | {"TorchOlapEngine"} == set(got.__all__)
    assert got.__version__ == jgot.__version__
    assert got.TpuOlapEngine is got.GpuOlapEngine
    assert got.OlapEngine is got.TorchOlapEngine
    assert issubclass(got.GpuOlapEngine, got.TorchOlapEngine)
    assert str(got.parse_sql("SELECT a FROM t WHERE a > 1")) == \
        str(jgot.parse_sql("SELECT a FROM t WHERE a > 1"))
    cat = got.Catalog()
    cat.register_batch("t", got.ColumnBatch.from_dict({"a": np.arange(3)}))
    assert cat.list_tables() == ["t"]


# ---------------------------------------------------------------------------
# the restored host helpers and tracing
# ---------------------------------------------------------------------------

def test_columnar_helpers_match_the_jax_package():
    for td, jd in zip(DType, jcol.DType):
        assert td.value == jd.value and td.is_numeric == jd.is_numeric
    fields = [("t.a", "INT64"), ("b", "FLOAT64"), ("c", "BOOL"),
              ("s", "STRING")]
    ts = Schema([Field(n, DType[d]) for n, d in fields])
    js = jcol.Schema([jcol.Field(n, jcol.DType[d]) for n, d in fields])
    assert ts.row_byte_width() == js.row_byte_width() == 25
    for name in ("a", "t.a", "b", "s"):
        assert ts.field_by_name(name).name == js.field_by_name(name).name
    with pytest.raises(KeyError):
        ts.field_by_name("zzz")


@pytest.mark.parametrize("validity", [None, [True, True, True],
                                      [True, False, True]])
def test_column_has_nulls(validity):
    data = np.arange(3, dtype=np.int64)
    v = None if validity is None else np.asarray(validity)
    exp = jcol.Column(data, v).has_nulls
    assert Column(data, v).has_nulls == exp
    # the port's columns may hold tensors
    tv = None if v is None else torch.from_numpy(v)
    assert Column(torch.from_numpy(data), tv).has_nulls == exp


def test_tracing_configure_and_span(caplog):
    for mod, registry in ((tracing, MetricsRegistry()),
                          (jtracing, JMetricsRegistry())):
        root = logging.getLogger()
        saved = root.handlers[:], root.level
        try:
            root.handlers = []
            mod.configure(logging.DEBUG)
            assert root.level == logging.DEBUG
            assert root.handlers
        finally:
            root.handlers, lvl = saved
            root.setLevel(lvl)
        log = mod.get_logger("span_test")
        with caplog.at_level(logging.DEBUG, logger="span_test"):
            with mod.span(log, "scan", registry, rows_in=10, rows_out=4):
                pass
            with pytest.raises(ValueError):
                with mod.span(log, "scan", registry, rows_in=5):
                    raise ValueError("the span still records")
        st = registry.ops["scan"]
        assert (st.calls, st.rows_in, st.rows_out) == (2, 15, 4)
        assert st.seconds > 0
        assert any("enter scan" in r.message for r in caplog.records)
        assert any("exit scan" in r.message for r in caplog.records)
        caplog.clear()


# ---------------------------------------------------------------------------
# Arrow / columnar interchange (test_interop.py)
# ---------------------------------------------------------------------------

def _both_from_arrow(table):
    tb, jb = tarrow.batch_from_arrow(table), jarrow.batch_from_arrow(table)
    _same_batch(tb, jb)
    return tb


def test_widening_int_types():
    table = pa.table({
        "i8": pa.array([1, 2], type=pa.int8()),
        "i16": pa.array([1, 2], type=pa.int16()),
        "i32": pa.array([1, 2], type=pa.int32()),
        "u32": pa.array([1, 2], type=pa.uint32()),
        "f32": pa.array([1.5, 2.5], type=pa.float32()),
    })
    batch = _both_from_arrow(table)
    assert all(f.dtype in (DType.INT64, DType.FLOAT64) for f in batch.schema)
    assert batch.column(0).data.dtype == np.int64
    assert batch.column(4).data.dtype == np.float64


def test_null_round_trip():
    table = pa.table({
        "x": pa.array([1, None, 3], type=pa.int64()),
        "y": pa.array([1.0, 2.0, None], type=pa.float64()),
    })
    batch = _both_from_arrow(table)
    assert list(batch.column(0).validity) == [True, False, True]
    assert batch.column(0).has_nulls
    back = tarrow.batch_to_arrow(batch)
    assert back.column("x").null_count == 1
    assert back.column("y").null_count == 1
    assert back.column("x").to_pylist() == [1, None, 3]
    assert back.equals(jarrow.batch_to_arrow(jarrow.batch_from_arrow(table)))


def test_string_dictionary_round_trip():
    table = pa.table({"s": pa.array(["b", "a", None, "b"])})
    batch = _both_from_arrow(table)
    assert batch.schema.field(0).dtype is DType.STRING
    assert batch.column(0).dictionary is not None
    back = tarrow.batch_to_arrow(batch)
    assert back.column("s").to_pylist() == ["b", "a", None, "b"]


def test_timestamp_widening():
    ts = pa.array([0, 86_400_000], type=pa.timestamp("ms"))
    batch = _both_from_arrow(pa.table({"t": ts}))
    assert batch.schema.field(0).dtype is DType.TIMESTAMP_MS
    assert batch.column(0).data.dtype == np.int64
    back = tarrow.batch_to_arrow(batch)
    assert back.column("t").type == pa.timestamp("ms")


def test_unsupported_type_rejected():
    table = pa.table({"l": pa.array([[1, 2], [3]], type=pa.list_(pa.int64()))})
    with pytest.raises(TypeError):
        tarrow.batch_from_arrow(table)
    with pytest.raises(TypeError):
        jarrow.batch_from_arrow(table)


def test_schema_resolution():
    s = Schema([Field("t.a", DType.INT64), Field("t.b", DType.INT64),
                Field("u.a", DType.INT64)])
    assert s.index_of("t.b") == 1
    assert s.index_of("b") == 1
    with pytest.raises(KeyError):
        s.index_of("a")  # ambiguous between t.a and u.a
    with pytest.raises(KeyError):
        s.index_of("zzz")


def test_schema_row_byte_width():
    s = Schema([Field("a", DType.INT64), Field("b", DType.FLOAT64),
                Field("c", DType.BOOL)])
    assert s.row_byte_width() == 17


def test_dict_encode_strings():
    arr = np.array(["x", "y", "x", None], dtype=object)
    codes, dictionary, validity = dict_encode_strings(arr)
    assert list(dictionary[codes[:3]]) == ["x", "y", "x"]
    assert validity is not None and not validity[3]
    jcodes, jdict, jvalid = jcol.dict_encode_strings(arr)
    np.testing.assert_array_equal(codes, jcodes)
    assert list(dictionary) == list(jdict)
    np.testing.assert_array_equal(validity, jvalid)


def test_from_dict_and_pandas_round_trip():
    df = pd.DataFrame({"a": [1, 2, 3], "s": ["p", "q", "p"],
                       "f": [0.5, np.nan, 1.5]})
    batch = tarrow.batch_from_pandas(df)
    _same_batch(batch, jarrow.batch_from_pandas(df))
    back = tarrow.batch_to_pandas(batch)
    assert list(back["a"]) == [1, 2, 3]
    assert list(back["s"]) == ["p", "q", "p"]
    assert np.isnan(back["f"][1])


def test_concat_batches():
    b1 = ColumnBatch.from_dict({"a": np.array([1, 2]), "s": np.array(["x", "y"])})
    b2 = ColumnBatch.from_dict({"a": np.array([3]), "s": np.array(["z"])})
    merged = concat_batches([b1, b2])
    assert merged.num_rows == 3
    d = merged.to_pydict()
    assert list(d["a"]) == [1, 2, 3]
    assert list(d["s"]) == ["x", "y", "z"]
    jmerged = jcol.concat_batches([
        jcol.ColumnBatch.from_dict({"a": np.array([1, 2]),
                                    "s": np.array(["x", "y"])}),
        jcol.ColumnBatch.from_dict({"a": np.array([3]), "s": np.array(["z"])})])
    _same_batch(merged, jmerged)


def test_parquet_round_trip(tmp_path):
    import pyarrow.parquet as pq

    table = pa.table({"k": np.arange(100, dtype=np.int64),
                      "v": np.arange(100, dtype=np.float64)})
    path = str(tmp_path / "t.parquet")
    pq.write_table(table, path)
    schema, nrows = tarrow.read_parquet_schema(path)
    assert nrows == 100 and len(schema) == 2
    batch = tarrow.read_parquet(path)
    assert batch.num_rows == 100
    _same_batch(batch, jarrow.read_parquet(path))
    chunks = list(tarrow.iter_parquet_chunks(path, batch_size=30))
    assert [c.num_rows for c in chunks] == [30, 30, 30, 10]
    # the engine's load_table over the same file
    eng = _port()
    eng.load_table("t", path)
    assert eng.get_table_schema("t").names == ["k", "v"]
    r = eng.query("SELECT SUM(k) AS s, MAX(v) AS m FROM t")
    assert r.metrics["backend"] == "torch-cpu"
    assert (int(r.to_pydict()["s"][0]), float(r.to_pydict()["m"][0])) == \
        (4950, 99.0)


# ---------------------------------------------------------------------------
# native helpers (test_native.py); skipped without a C++ toolchain
# ---------------------------------------------------------------------------

native = pytest.mark.skipif(tnative.get_lib() is None,
                            reason="native toolchain unavailable")


def _buffers(strings):
    arr = pa.array(strings, type=pa.string())
    data = np.frombuffer(arr.buffers()[2], dtype=np.uint8) \
        if arr.buffers()[2] else np.zeros(0, np.uint8)
    offsets = np.frombuffer(arr.buffers()[1], dtype=np.int32).astype(np.int64)
    return data, offsets


@native
def test_dict_encode_sorted_and_exact():
    strings = ["pear", "apple", "pear", "banana", "apple"]
    data, offsets = _buffers(strings)
    codes, dictionary = tnative.dict_encode_utf8(data, offsets, None)
    assert list(dictionary) == ["apple", "banana", "pear"]  # sorted
    assert [dictionary[c] for c in codes] == strings


@native
def test_dict_encode_matches_numpy_fallback():
    rng = np.random.default_rng(0)
    strings = [f"w{int(i):04d}" for i in rng.integers(0, 500, 10_000)]
    data, offsets = _buffers(strings)
    codes, dictionary = tnative.dict_encode_utf8(data, offsets, None)
    c2, d2, _ = dict_encode_strings(np.array(strings, dtype=object))
    assert list(dictionary) == list(d2)
    np.testing.assert_array_equal(codes, c2)
    jcodes, jdict = jnative.dict_encode_utf8(data, offsets, None)
    np.testing.assert_array_equal(codes, jcodes)
    assert list(dictionary) == list(jdict)


@native
def test_dict_encode_with_validity():
    strings = ["a", "b", "a", "c"]
    data, offsets = _buffers(strings)
    validity = np.array([1, 0, 1, 1], dtype=np.uint8)
    codes, dictionary = tnative.dict_encode_utf8(data, offsets, validity)
    assert codes[1] == 0  # null rows coded 0
    assert dictionary[codes[0]] == "a"
    assert dictionary[codes[3]] == "c"


@native
def test_fnv1a_hash_known_values():
    # FNV-1a 64-bit of "a" is 0xaf63dc4c8601ec8c; we mask the sign bit
    data, offsets = _buffers(["a", ""])
    h = tnative.fnv1a_hash64(data, offsets)
    assert h[0] == (0xAF63DC4C8601EC8C & 0x7FFFFFFFFFFFFFFF)
    assert h[1] == (0xCBF29CE484222325 & 0x7FFFFFFFFFFFFFFF)  # empty = basis
    rng = np.random.default_rng(5)
    data, offsets = _buffers([f"k{i}" for i in rng.integers(0, 10**9, 1000)])
    np.testing.assert_array_equal(tnative.fnv1a_hash64(data, offsets),
                                  jnative.fnv1a_hash64(data, offsets))


@native
def test_unpack_bitmap():
    bits = np.array([0b10110101], dtype=np.uint8)
    out = tnative.unpack_bitmap(bits, 0, 8)
    assert list(out) == [True, False, True, False, True, True, False, True]
    out = tnative.unpack_bitmap(bits, 2, 3)
    assert list(out) == [True, False, True]
    bits = np.random.default_rng(6).integers(0, 256, 64).astype(np.uint8)
    np.testing.assert_array_equal(tnative.unpack_bitmap(bits, 3, 500),
                                  jnative.unpack_bitmap(bits, 3, 500))


@native
def test_arrow_string_ingestion_uses_native_and_matches():
    table = pa.table({"s": pa.array(["z", "y", None, "z", "abc"])})
    batch = _both_from_arrow(table)
    col = batch.column(0)
    assert list(col.dictionary) == sorted(set(["z", "y", "abc"]))
    back = tarrow.batch_to_arrow(batch)
    assert back.column("s").to_pylist() == ["z", "y", None, "z", "abc"]


@native
def test_int64_minmax_matches_numpy():
    rng = np.random.default_rng(3)
    d = rng.integers(-1000, 1 << 40, 100_000).astype(np.int64)
    assert tnative.int64_minmax(d) == (int(d.min()), int(d.max())) == \
        jnative.int64_minmax(d)


@native
def test_int64_unique_bounded():
    u = np.arange(10_000, dtype=np.int64)
    np.random.default_rng(4).shuffle(u)
    assert tnative.int64_unique_bounded(u, 0, 9_999) is True
    u[7] = u[8]
    assert tnative.int64_unique_bounded(u, 0, 9_999) is False
    # span too large for a bitmap -> None (caller falls back)
    assert tnative.int64_unique_bounded(u, 0, 1 << 40) is None
    # values outside the claimed range -> not unique under that range
    assert tnative.int64_unique_bounded(np.array([5, 20], dtype=np.int64),
                                        0, 9) is False
