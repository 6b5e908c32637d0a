"""TIMESTAMP and DATE columns compared with date strings, in the port.

The port's planner lowers a string literal compared with a TIMESTAMP_MS or
DATE32 expression (``= != < <= > >=``, BETWEEN, IN) to a literal of the
column's type: milliseconds or days since the epoch, read by numpy's
``datetime64`` rules.  Every backend reads the lowered plan, so each query
here must give numpy's count and sum on the single device (``torch-cpu``),
on the 8-shard CPU mesh (``torch-distributed``) and streamed from an
uncached Parquet file (``torch-streaming``).  Literals that name no instant
and comparisons with a string column raise ``PlanError``.

The JAX package compares the two by other means, and both are wrong: its
device engine raises ``ValueError`` and its oracle compares the digits of
the integers with the string (ROADMAP.md C).  The table and the predicate
matrix come from ``tests/torch_corpus.py`` (``temporal_table``,
``TEMPORAL_PREDICATES``).
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

N = corpus.TEMPORAL_ROWS
PREDICATES = corpus.TEMPORAL_PREDICATES
_np = corpus.temporal_columns


@pytest.fixture(scope="module")
def table():
    return corpus.temporal_table()


@pytest.fixture(scope="module")
def engines(table, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ttemporal") / "t.parquet")
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
    return {"torch-cpu": one, "torch-distributed": mesh,
            "torch-streaming": streamed}


@pytest.mark.parametrize("backend", ["torch-cpu", "torch-distributed",
                                     "torch-streaming"])
@pytest.mark.parametrize("name", sorted(PREDICATES))
def test_date_string_predicate_matches_numpy(table, engines, backend, name):
    pred, mask_of = PREDICATES[name]
    mask = mask_of(_np(table))
    assert 0 < mask.sum() < N
    sql = corpus.predicate_sql(pred)
    res = engines[backend].query(sql)
    assert res.metrics["backend"] == backend, res.metrics
    got = res.to_pydict()
    v = table.column("v").to_numpy()
    assert int(got["n"][0]) == int(mask.sum()), sql
    if mask.any():
        assert int(got["s"][0]) == int(v[mask].sum()), sql


@pytest.mark.parametrize("pred", [
    "ts > '2021-13-01'",            # no such month
    "ts > 'yesterday'",
    "ts > 'NaT'",                   # names no instant
    "ts > '2021-06-01T00:00Z'",     # a time zone
    "ts > '2021-06-01T00:00:00.0005'",  # finer than milliseconds
    "d = '2021-06-01 12:00'",       # a time of day for a DATE column
    "d IN ('2021-06-01', 'x')",
    "ts > s",                       # a string column
    "s <= d",
])
def test_unreadable_date_raises_plan_error(engines, pred):
    with pytest.raises(PlanError):
        engines["torch-cpu"].query(f"SELECT COUNT(*) AS n FROM t WHERE {pred}")


def test_string_columns_still_compare_as_strings(table, engines):
    """A string column compared with a string literal is untouched."""
    s = table.column("s").to_numpy().astype(str)
    res = engines["torch-cpu"].query(
        "SELECT COUNT(*) AS n FROM t WHERE s >= '2021-06-01'")
    assert int(res.to_pydict()["n"][0]) == int((s >= "2021-06-01").sum())


@pytest.mark.parametrize("pred", ["ts > '2021-06-01'", "d >= '2021-06-01'",
                                  "d = '2021-06-01'"])
def test_jax_package_compares_otherwise(table, engines, pred):
    """The reference's answers, where the port's are numpy's: the JAX
    device engine raises and the JAX oracle counts no row."""
    sql = f"SELECT COUNT(*) AS n FROM t WHERE {pred}"
    device = OlapEngine(JaxConfig(backend="device"))
    oracle = OlapEngine(JaxConfig(backend="cpu"))
    mirror_tables(engines["torch-cpu"], device, oracle)
    with pytest.raises(ValueError, match="zero-dimensional"):
        device.query(sql)
    assert int(oracle.query(sql).to_pydict()["n"][0]) == 0
    assert int(engines["torch-cpu"].query(sql).to_pydict()["n"][0]) > 0


def test_date32_arrow_column_loads(table, tmp_path):
    """Arrow has no date32 -> int64 cast: the port reads days through
    int32, from an Arrow table and from Parquet; the JAX package's loader
    raises on both."""
    path = str(tmp_path / "d.parquet")
    pq.write_table(table, path)
    days = table.column("d").to_numpy().astype("datetime64[D]")
    for load in (lambda e: e.register("t", table),
                 lambda e: e.load_table("t", path)):
        port = TorchOlapEngine(EngineConfig(), device="cpu")
        load(port)
        got = port.catalog.get_table_data("t").columns[1].data
        assert np.array_equal(got, days.astype(np.int64))
        with pytest.raises(pa.ArrowNotImplementedError):
            load(OlapEngine(JaxConfig(backend="cpu")))
