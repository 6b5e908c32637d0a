"""``tests/torch_corpus.py`` held to its originals, on the CPU.

``torch_corpus`` is the JAX-free copy of the corpora and generators that
the port's tests run (``corpus.py``'s ``engine_corpus`` phase runs the
same on the GPU, where there is no JAX).  Here:

- its parity corpus, tables and fuzz generators equal the originals of
  ``tests/test_device_parity.py`` and ``tests/test_fuzz_parity.py`` (and
  the typed-predicate draw of the path fuzzer) for the same seeds, and
  ``scale`` grows the fact tables only, keeping the original rows;
- the port's NumPy oracle equals the JAX package's oracle on every query
  of the phase's parts a-c at ``scale=1`` (numeric string literals written
  as numbers for JAX, whose oracle compares them by their digits); none of
  these queries meets a fault of the JAX oracle that ROADMAP.md C lists,
  so none is excepted;
- a few queries of parts a and b at the phase's scales run on
  ``torch-cpu`` against the port's oracle, so the scaled tables are
  checked before a card sees them.

Rows are compared as multisets (and under ORDER BY in order on its keys):
integers and strings exactly, floats within ``rtol = atol = 1e-12``; a
float SUM/AVG over a scaled table may be held, row by row, to its own
group's summation bound ``n_g * 2**-52 * sum(|x_g|)`` instead
(``torch_corpus.summation_bound``).
"""

import numpy as np
import pytest

import test_device_parity as parity
import test_fuzz_parity as fuzz
import test_torch_engine
import torch_corpus as corpus
from gpu_olap_tpu import EngineConfig as JaxConfig
from gpu_olap_tpu import OlapEngine
from gpu_olap_tpu_torch import EngineConfig, TorchOlapEngine
from test_torch_engine import mirror_tables

PART_A = corpus.CARD_QUERIES


def _port(**kwargs):
    return TorchOlapEngine(EngineConfig(**kwargs), device="cpu")


def _oracle(eng):
    oracle = _port(backend="cpu")
    oracle.catalog = eng.catalog
    return oracle


def _jax_oracle(port):
    oracle = OlapEngine(JaxConfig(backend="cpu"))
    mirror_tables(port, oracle)
    return oracle


def _eq(a, b):
    """Equal arrays, NaN equal to NaN in float ones."""
    return np.array_equal(a, b, equal_nan=a.dtype.kind == "f")


def _same_tables(a, b):
    """Two port catalogs hold the same tables: schemas, arrays, validity
    masks and dictionaries."""
    assert sorted(a.list_tables()) == sorted(b.list_tables())
    for name in a.list_tables():
        x, y = a.get_table_data(name), b.get_table_data(name)
        assert x.schema == y.schema, name
        assert x.num_rows == y.num_rows, name
        for f, cx, cy in zip(x.schema, x.columns, y.columns):
            what = f"{name}.{f.name}"
            assert _eq(cx.data, cy.data), what
            assert (cx.validity is None) == (cy.validity is None), what
            if cx.validity is not None:
                assert np.array_equal(cx.validity, cy.validity), what
            assert (cx.dictionary is None) == (cy.dictionary is None), what
            if cx.dictionary is not None:
                assert list(cx.dictionary) == list(cy.dictionary), what


def _values(col):
    """A column's values: strings decoded from their dictionary."""
    if col.dictionary is None:
        return col.data
    return np.asarray(col.dictionary)[col.data]


# ---------------------------------------------------------------------------
# the copies equal their originals
# ---------------------------------------------------------------------------

def test_slice_queries_extend_the_parity_corpus():
    assert corpus.QUERIES == parity.QUERIES
    assert corpus.SLICE_QUERIES[:len(parity.QUERIES)] == parity.QUERIES
    assert len(corpus.SLICE_QUERIES) == len(parity.QUERIES) + 5
    assert test_torch_engine.SLICE_QUERIES is corpus.SLICE_QUERIES
    assert not set(corpus.KERNEL_QUERIES) & set(corpus.SLICE_QUERIES)


def test_populate_registers_the_original_tables():
    ours, theirs = _port(), _port()
    corpus.populate(ours, np.random.default_rng(123))
    parity._populate(theirs, np.random.default_rng(123))
    _same_tables(ours.catalog, theirs.catalog)


def test_populate_scale_grows_the_fact_tables_only():
    one, four = _port(), _port()
    corpus.populate(one, np.random.default_rng(123))
    corpus.populate(four, np.random.default_rng(123), scale=4)
    facts = {"sales", "nullt", "order_items"}
    for name in one.catalog.list_tables():
        x = one.catalog.get_table_data(name)
        y = four.catalog.get_table_data(name)
        assert y.num_rows == x.num_rows * (4 if name in facts else 1), name
        for f, cx, cy in zip(x.schema, x.columns, y.columns):
            what = f"{name}.{f.name}"
            # the original rows first; the same key ranges and strings
            head = _values(cy)[:x.num_rows]
            orig = _values(cx)
            assert _eq(np.asarray(head), np.asarray(orig)), what
            if cx.dictionary is not None:
                assert set(cy.dictionary) == set(cx.dictionary), what
            elif name in facts and f.name != "v" and \
                    np.issubdtype(cx.data.dtype, np.integer):
                assert cy.data.min() == cx.data.min(), what
                assert cy.data.max() == cx.data.max(), what
    v = four.catalog.get_table_data("nullt").columns[1]
    assert 0.25 < 1 - v.validity.mean() < 0.35  # the null rate


@pytest.mark.parametrize("seed", range(corpus.N_QUERIES))
def test_fuzz_generator_matches_the_original(seed):
    ours = np.random.default_rng(1000 + seed)
    theirs = np.random.default_rng(1000 + seed)
    for x, y in zip(corpus.gen_tables(ours), fuzz._gen_tables(theirs)):
        assert x.keys() == y.keys()
        for k in x:
            assert _eq(x[k], y[k])
    sql = corpus.gen_query(ours)
    assert sql == fuzz._gen_query(theirs)
    t1, t2, case_sql = corpus.fuzz_case(seed)
    assert case_sql == sql
    # at the phase's scale: the same query and t2, t1 grown at its end
    s1, s2, scaled_sql = corpus.fuzz_case(seed, corpus.CORPUS_SCALE_B)
    assert scaled_sql == sql
    assert all(np.array_equal(s2[k], t2[k]) for k in t2)
    for k in t1:
        assert len(s1[k]) == len(t1[k]) * corpus.CORPUS_SCALE_B
        assert _eq(s1[k][:len(t1[k])], t1[k])


@pytest.mark.parametrize("seed", range(corpus.N_PATH_SEEDS))
def test_path_generators_match_the_original_draw(seed, monkeypatch):
    """``mesh_case``/``streamed_case`` draw what the path fuzzer drew with
    ``test_fuzz_parity._PREDS`` widened by the typed predicates."""
    monkeypatch.setattr(fuzz, "_PREDS", fuzz._PREDS + corpus.TYPED_PREDS)
    for base, case, accept, fix_c in (
            (20_000, corpus.mesh_case, corpus.distributable, False),
            (30_000, corpus.streamed_case, corpus.streamable, True)):
        rng = np.random.default_rng(base + seed)
        t1, t2 = fuzz._gen_tables(rng)
        if fix_c:
            t1["c"] = np.where(np.isnan(t1["c"]), -7.25, t1["c"])
        ok = accept if seed % 3 != 1 else (lambda s: True)
        for _ in range(30):
            sql = fuzz._gen_query(rng)
            if ok(sql):
                break
        c1, c2, csql = case(seed)
        assert csql == sql, (base, seed)
        for a, b in ((c1, t1), (c2, t2)):
            assert all(_eq(a[k], b[k]) for k in b)


# ---------------------------------------------------------------------------
# the port's oracle against the JAX package's, parts a-c at scale=1
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def corpus_engines():
    port = _port()
    corpus.populate(port, np.random.default_rng(123))
    corpus.edge_tables(port, np.random.default_rng(5))
    return _oracle(port), _jax_oracle(port)


@pytest.fixture(scope="module")
def smoke_engines():
    port = _port()
    corpus.smoke_tables(port)
    return _oracle(port), _jax_oracle(port)


@pytest.mark.parametrize("sql", PART_A, ids=range(len(PART_A)))
def test_oracles_agree_on_part_a(corpus_engines, sql):
    ours, jax = corpus_engines
    corpus.assert_same_result(ours.query(sql),
                              jax.query(corpus.as_numbers(sql)), sql, sql)


@pytest.mark.parametrize("sql", corpus.SMOKE_QUERIES,
                         ids=range(len(corpus.SMOKE_QUERIES)))
def test_oracles_agree_on_the_smoke_queries(smoke_engines, sql):
    ours, jax = smoke_engines
    corpus.assert_same_result(ours.query(sql), jax.query(sql), sql, sql)


@pytest.mark.parametrize("seed", range(corpus.N_QUERIES))
def test_oracles_agree_on_part_b(seed):
    t1, t2, sql = corpus.fuzz_case(seed)
    port = _port()
    port.register("t1", t1)
    port.register("t2", t2)
    corpus.assert_same_result(_oracle(port).query(sql),
                              _jax_oracle(port).query(sql), sql, sql)


@pytest.mark.parametrize("seed", range(corpus.N_PATH_SEEDS))
def test_oracles_agree_on_part_c(seed):
    t1, t2, sql = corpus.mesh_case(seed)
    port = _port()
    port.register("t1", t1)
    port.register("t2", t2)
    corpus.assert_same_result(_oracle(port).query(sql),
                              _jax_oracle(port).query(corpus.as_numbers(sql)),
                              sql, sql)


# ---------------------------------------------------------------------------
# the scaled tables on torch-cpu
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def scaled():
    port = _port(enable_cache=False)
    corpus.populate(port, np.random.default_rng(123),
                    corpus.CORPUS_SCALE_A)
    corpus.edge_tables(port, np.random.default_rng(5),
                       corpus.CORPUS_SCALE_A)
    return port, _oracle(port)


# the 4-way join of the reference's example, a grouped float AVG, a
# SUM(DISTINCT) of floats, each kernel route's shapes, a materializing join
# and the int32 extremes through filter_agg and seg_agg
SCALED_A = [corpus.SLICE_QUERIES[i] for i in (10, 15, 22, 39)] + \
    [corpus.KERNEL_QUERIES[i] for i in (0, 4, 10, 11, 14)] + \
    [corpus.EDGE_QUERIES[i] for i in (0, 1, 6, 8)]


@pytest.mark.parametrize("sql", SCALED_A, ids=range(len(SCALED_A)))
def test_scaled_part_a_on_torch_cpu(scaled, sql):
    port, oracle = scaled
    res = port.query(sql)
    assert res.metrics["backend"] == "torch-cpu"
    corpus.assert_same_result(
        res, oracle.query(sql), sql, sql,
        bounds=lambda col, frame: corpus.summation_bound(oracle, sql, col,
                                                         frame))


def test_scaled_sum_is_held_to_its_summation_bound(scaled):
    """The 4-way join's float SUM over 640,000 ``order_items`` rows, held
    row by row to its own group's ``n_g * 2**-52 * sum(|x_g|)`` (no
    tolerance first): ``torch-cpu`` sums each group from its own rows and
    stays far inside it."""
    port, oracle = scaled
    sql = corpus.SLICE_QUERIES[39]
    exp = oracle.query(sql)
    got = corpus.canon(port.query(sql).to_pandas())
    frame = corpus.canon(exp.to_pandas())
    col, _ = corpus.compare_frames(
        got, frame, rtol=0.0, atol=0.0,
        bounds=lambda c, f: corpus.summation_bound(oracle, sql, c, f))
    assert col is None
    bound = corpus.summation_bound(oracle, sql, "total_revenue", frame)
    gaps = corpus.float_gaps(got["total_revenue"].to_numpy(),
                             frame["total_revenue"].to_numpy())
    assert (gaps < bound / 10).all()
    # each row's bound reads its own group's rows, HAVING and ORDER BY
    # dropped
    ref = oracle.query(
        "SELECT c.region AS region, p.category AS category, COUNT(*) AS n, "
        "SUM(abs(oi.quantity * p.price)) AS s "
        "FROM orders o JOIN order_items oi ON o.order_id = oi.order_id "
        "JOIN products p ON oi.product_id = p.product_id "
        "JOIN customers c ON o.customer_id = c.customer_id "
        "WHERE o.order_date >= '2024-01-01' AND o.order_date < '2024-07-01' "
        "AND o.status = 'completed' GROUP BY c.region, p.category"
    ).to_pandas()
    frame = corpus.canon(exp.to_pandas())
    want = frame[["region", "category"]].merge(ref, on=["region",
                                                        "category"])
    assert len(want) == len(frame) > 1
    np.testing.assert_allclose(bound, want["n"] * 2.0 ** -52 * want["s"],
                               rtol=1e-9)
    # the whole query's bound, which each row met before, is far larger
    assert bound.max() < (want["n"].sum() * 2.0 ** -52 * want["s"].sum()) / 2
    assert corpus.summation_bound(oracle, sql, "num_orders", frame) is None


def test_summation_bound_refuses_the_prefix_difference_answer():
    """Probe 1 of ``tests/test_torch_float_sums.py``: before the segmented
    sum, the port gave 0.0 for both small groups (differences of one prefix
    sum after a row of 1e17), 3.0 and 17500.0 by ``math.fsum``.  Each
    group's own bound refuses that answer; the bound over every group,
    which this one replaced, admitted it."""
    port = _port(enable_cache=False)
    port.register("t", corpus.float_sum_table("large_first"))
    oracle = _oracle(port)
    sql = "SELECT k, SUM(v) AS s FROM t GROUP BY k"
    exp = corpus.canon(oracle.query(sql).to_pandas())
    assert exp["s"].tolist() == [1e17, 3.0, 17500.0]
    parent = exp.assign(s=[1e17, 0.0, 0.0])
    col, _ = corpus.compare_frames(
        parent, exp,
        bounds=lambda c, f: corpus.summation_bound(oracle, sql, c, f))
    assert col == "s"
    bound = corpus.summation_bound(oracle, sql, "s", exp)
    assert bound[1] < 1e-14 and bound[2] < 1e-6
    whole = oracle.query("SELECT COUNT(*) AS n, SUM(abs(v)) AS s FROM t")
    whole = whole.to_pydict()
    assert whole["n"][0] * 2.0 ** -52 * whole["s"][0] > 17500.0


@pytest.mark.parametrize("seed", [3, 11, 17, 42])
def test_scaled_part_b_on_torch_cpu(seed):
    t1, t2, sql = corpus.fuzz_case(seed, corpus.CORPUS_SCALE_B)
    port = _port(enable_cache=False)
    port.register("t1", t1)
    port.register("t2", t2)
    res = port.query(sql)
    assert res.metrics["backend"] == "torch-cpu"
    oracle = _oracle(port)
    corpus.assert_same_result(
        res, oracle.query(sql), sql, sql,
        bounds=lambda col, frame: corpus.summation_bound(oracle, sql, col,
                                                         frame))


def test_order_keys_and_comparison():
    cols = ["a", "b", "c"]
    assert corpus.order_keys("SELECT a FROM t", cols) == []
    assert corpus.order_keys("SELECT ... ORDER BY 2 DESC, 1 LIMIT 5",
                             cols) == ["b", "a"]
    assert corpus.order_keys("SELECT ... ORDER BY t.c DESC, a", cols) == \
        ["c", "a"]
    import pandas as pd

    got = pd.DataFrame({"a": [2, 1], "b": [0.5, np.nan]})
    exp = pd.DataFrame({"a": [1, 2], "b": [np.nan, 0.5]})
    corpus.assert_same_result(got, exp, "SELECT a, b FROM t", "multiset")
    with pytest.raises(AssertionError, match="in ORDER BY order"):
        corpus.assert_same_result(got, exp, "SELECT a, b FROM t ORDER BY a",
                                  "ordered")
    with pytest.raises(AssertionError, match="column b differs"):
        corpus.assert_same_result(got, exp.assign(b=[np.nan, 0.5 + 1e-9]),
                                  "SELECT a, b FROM t", "float")
    held = corpus.assert_same_result(
        got, exp.assign(b=[np.nan, 0.5 + 1e-9]), "SELECT a, b FROM t",
        "bounded", bounds=lambda col, frame: 1e-8)
    assert held["b"][0] == pytest.approx(1e-9)
