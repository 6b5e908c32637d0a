"""The lookup join with the left side as the build, on the CPU.

A query that names a dimension first (``FROM d JOIN f ON d.dk = f.fk``,
as SSB's Q3.x and Q4.x do) has its unique key on the left.  An inner or
right join whose left key alone is unique and range-bounded looks the
right side's rows up in the left side's dense index
(``_Interpreter._try_lookup_join(..., build="left")``), counted as
``torch_join_lookup_left``; every other join keeps its route.  Each query
runs on the port (``torch-cpu``), the JAX device engine and the NumPy
oracle, and the answers are compared as row multisets; the routes are read
from the query's ``metrics["routes"]``.
"""

import numpy as np
import pyarrow as pa
import pytest

from conftest import make_engine
from test_torch_engine import _assert_same_rows, _canon, _port, mirror_tables

from gpu_olap_tpu_torch.executor import device as tdev

LEFT, STREAM = "torch_join_lookup_left", "torch_join_stream_path"
N_FACT = 40_000  # with the dimension, past the stream join's 32K rows


def _tables(fact_nulls: bool):
    rng = np.random.default_rng(23)
    nd = 1000
    d = {
        # unique keys over 100..1099, in no order
        "dk": rng.permutation(nd).astype(np.int64) + 100,
        # a second unique column, for a join after the first
        "du": rng.permutation(nd).astype(np.int64),
        "dx": rng.integers(0, 10, nd).astype(np.int64),
        "ds": pa.array([f"n{i:04d}" for i in rng.permutation(nd)]),
    }
    # fact keys: duplicates, and keys below and above the dimension's range
    fk = rng.integers(0, 1200, N_FACT).astype(np.int64)
    f = {
        "fk": pa.array(fk, mask=rng.random(N_FACT) < 0.1 if fact_nulls
                       else None),
        "fv": rng.integers(0, 1000, N_FACT).astype(np.int64),
        "fs": pa.array([f"n{i:04d}" for i in rng.integers(0, 1200, N_FACT)]),
    }
    # a second fact table whose key runs over ``du``'s values, not unique
    g = {"gk": rng.integers(0, 1000, N_FACT).astype(np.int64),
         "gw": rng.integers(0, 100, N_FACT).astype(np.int64)}
    # a second dimension with a unique key, for a join of two unique keys
    e = {"ek": rng.permutation(1200).astype(np.int64),
         "ey": rng.integers(0, 50, 1200).astype(np.int64)}
    return {"d": d, "f": f, "g": g, "e": e}


def _engines(fact_nulls=False, **cfg):
    port = _port(enable_cache=False, **cfg)
    for name, cols in _tables(fact_nulls).items():
        port.register(name, pa.table(cols))
    jax_dev = make_engine("device", **cfg)
    cpu = make_engine("cpu")
    mirror_tables(port, jax_dev, cpu)
    return port, jax_dev, cpu


def _check(engines, sql, left, stream):
    """``sql``'s answer on the port equal to the oracle's and JAX's, with
    ``torch_join_lookup_left`` bumped ``left`` times and the stream join
    taken or not."""
    from gpu_olap_tpu_torch.utils.metrics import GLOBAL_METRICS

    port, jax_dev, cpu = engines
    before = GLOBAL_METRICS.snapshot().get(LEFT, 0)
    got = port.query(sql)
    assert got.metrics["backend"] == "torch-cpu", sql
    assert GLOBAL_METRICS.snapshot().get(LEFT, 0) - before == left, sql
    assert (LEFT in got.metrics["routes"]) == (left > 0), sql
    assert (STREAM in got.metrics["routes"]) == stream, sql
    gdf = _rows(got)
    assert len(gdf) > 0, sql
    _assert_same_rows(gdf, _rows(cpu.query(sql)), f"oracle: {sql}")
    _assert_same_rows(gdf, _rows(jax_dev.query(sql)), f"jax: {sql}")
    return got


def _rows(result):
    """The answer's rows in a canonical order, a null string spelt out
    (NaN is unequal to itself in an object column)."""
    df = _canon(result)
    for col in df.columns:
        if df[col].dtype.kind not in "biuf":
            df[col] = df[col].astype(object).where(df[col].notna(), "<null>")
    return df


@pytest.fixture(scope="module")
def engines():
    return _engines()


@pytest.fixture(scope="module")
def null_engines():
    return _engines(fact_nulls=True)


SWAPPED = {
    # the dimension an unfiltered scan: its dense index from the upload
    "inner": "SELECT d.dk, d.dx, d.ds, f.fv FROM d JOIN f ON d.dk = f.fk",
    # the key in a condition written the other way round
    "flipped_on": "SELECT d.dx, f.fk, f.fv FROM d JOIN f ON f.fk = d.dk",
    # a residual on columns of both sides
    "residual": "SELECT d.dk, f.fv FROM d JOIN f "
                "ON d.dk = f.fk AND d.dx * 100 < f.fv",
    # every fact row survives, the dimension's columns null where no key
    "right": "SELECT d.dk, d.dx, d.ds, f.fk, f.fv FROM d RIGHT JOIN f "
             "ON d.dk = f.fk",
    "right_residual": "SELECT d.dk, d.dx, f.fk, f.fv FROM d RIGHT JOIN f "
                      "ON d.dk = f.fk AND d.dx * 100 < f.fv",
    # a grouped answer above the swapped join
    "grouped": "SELECT d.dx, COUNT(*) AS n, SUM(f.fv) AS s FROM d JOIN f "
               "ON d.dk = f.fk GROUP BY d.dx",
}


@pytest.mark.parametrize("name", list(SWAPPED))
def test_swapped_lookup_join(engines, name):
    _check(engines, SWAPPED[name], left=1, stream=False)


@pytest.mark.parametrize("name", ["inner", "right", "residual"])
def test_swapped_lookup_join_over_null_fact_keys(null_engines, name):
    """Fact keys with nulls (and keys outside the dimension's range): no
    null key matches, and a right join keeps their rows."""
    got = _check(null_engines, SWAPPED[name], left=1, stream=False)
    if name == "right":
        fk = got.to_pandas()["fk"]
        assert fk.isna().any()


def test_swapped_lookup_join_builds_a_filtered_dimension(engines,
                                                         monkeypatch):
    """A filtered dimension has no cached dense index: ``lookup_slots``
    builds the table from the kept rows; an unfiltered one reads the
    upload's through ``dense_probe``."""
    calls = {"lookup_slots": 0, "dense_probe": 0}
    for fn in calls:
        orig = getattr(tdev.join_ops, fn)

        def counted(*args, _orig=orig, _fn=fn):
            calls[_fn] += 1
            return _orig(*args)

        monkeypatch.setattr(tdev.join_ops, fn, counted)
    _check(engines, "SELECT d.dk, d.dx, f.fv FROM d JOIN f ON d.dk = f.fk "
           "WHERE d.dx < 4", left=1, stream=False)
    assert calls["lookup_slots"] == 1
    calls.update(lookup_slots=0, dense_probe=0)
    _check(engines, SWAPPED["inner"], left=1, stream=False)
    assert calls == {"lookup_slots": 0, "dense_probe": 1}


NOT_SWAPPED = {
    # both keys unique: the right side stays the build
    "both_unique": ("SELECT d.dk, d.dx, e.ey FROM d JOIN e ON d.dk = e.ek",
                    False),
    # the left key not unique: the stream join
    "left_not_unique": ("SELECT f.fv, g.gw FROM f JOIN g ON f.fk = g.gk "
                        "WHERE f.fv < 10 AND g.gw < 2", True),
    # a left join keeps every dimension row: never swapped
    "left_join": ("SELECT d.dk, d.dx, f.fv FROM d LEFT JOIN f "
                  "ON d.dk = f.fk", False),
    # a full join: never swapped
    "full_join": ("SELECT d.dk, f.fk FROM d FULL JOIN f ON d.dk = f.fk",
                  False),
    # a string key: no dense index
    "string_key": ("SELECT d.dk, f.fv FROM d JOIN f ON d.ds = f.fs", False),
}


@pytest.mark.parametrize("name", list(NOT_SWAPPED))
def test_join_not_swapped(engines, name):
    sql, stream = NOT_SWAPPED[name]
    _check(engines, sql, left=0, stream=stream)


def test_sort_merge_strategy_keeps_the_sorted_probe():
    """An explicit ``join_strategy="sort_merge"`` turns every lookup join
    off, the swapped one too."""
    _check(_engines(join_strategy="sort_merge"), SWAPPED["inner"], left=0,
           stream=True)


def test_swapped_join_columns_lose_uniqueness(engines):
    """After a swapped join a dimension row repeats once per fact row that
    matched it, so its unique ``du`` is no longer unique: the join on it
    that follows is not a lookup with the left side as the build (which
    would keep one row of each repeated key), but the stream join."""
    sql = ("SELECT d.dk, d.du, f.fv, g.gw FROM d JOIN f ON d.dk = f.fk "
           "JOIN g ON d.du = g.gk WHERE f.fv < 20 AND g.gw < 5")
    _check(engines, sql, left=1, stream=True)
