"""The query corpora and generators of the port's tests, without JAX.

Everything here imports numpy, pyarrow and ``gpu_olap_tpu_torch`` only, so
the same corpora run on a machine without JAX: the tests of the port on the
CPU, the ``cuda``-marked tests of ``tests/test_torch_card.py`` and
``chip_smoke.py``'s ``engine_corpus`` phase on the GPU.

- ``SLICE_QUERIES``: the parity corpus (``QUERIES``, a copy of
  ``tests/test_device_parity.py``'s) and five UNION queries, over the tables
  of ``populate``.
- ``KERNEL_QUERIES``: the shapes of the filter_agg, seg_agg and
  materializing-join kernels over the same tables.
- ``edge_tables`` / ``EDGE_QUERIES``: int32 extremes, sums near 2**62,
  -0.0 and NULL floats, empty strings, BOOL predicates, float join keys,
  ``%`` and ``/`` by negatives and by zero, LIMIT 0 and OFFSET.
- ``CARD_QUERIES``: those three lists, the one list that the card test,
  ``engine_corpus`` part a and the oracle-agreement tests run.
- ``smoke_tables`` / ``SMOKE_QUERIES``: the smoke's 17 queries.
- ``gen_tables`` / ``gen_query``: the generator of
  ``tests/test_fuzz_parity.py`` (``N_QUERIES`` seeds, ``1000 + seed``).
- ``mesh_case`` / ``streamed_case``: the mesh and streamed generators of
  ``tests/test_torch_path_fuzz.py`` (``N_PATH_SEEDS`` seeds each).
- ``star_tables`` / ``star_queries``: the streamed star joins of
  ``tests/test_torch_star_fuzz.py`` (``N_STAR_SEEDS`` seeds).
- ``typed_table`` / ``TYPED_PREDICATES`` and ``temporal_table`` /
  ``TEMPORAL_PREDICATES``: the predicate matrices of
  ``tests/test_torch_typed_literals.py`` and ``tests/test_torch_temporal.py``
  with numpy's masks.

``scale`` multiplies the rows of the fact tables only (``sales``, ``nullt``
and ``order_items`` in ``populate``, ``edge`` in ``edge_tables``, ``t1`` in
``gen_tables``).  The rows
the original draws are kept as they are and the extra rows are drawn from
the same distributions by a generator spawned from ``rng``, which leaves
``rng``'s own stream untouched: at ``scale=1`` every array is the
original's, and at any scale the dimension tables and the generated SQL are
the same as at ``scale=1``.
"""

from __future__ import annotations

import dataclasses
import math
import os
import re

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq

from gpu_olap_tpu_torch.interop.columnar import DType
from gpu_olap_tpu_torch.plan import physical as P

# ---------------------------------------------------------------------------
# the parity corpus (tests/test_device_parity.py) and the port's UNIONs
# ---------------------------------------------------------------------------

QUERIES = [
    # scans / filters / projection
    "SELECT product_id, amount FROM sales WHERE amount > 150",
    "SELECT amount * quantity AS v, amount + 1 AS a1 FROM sales WHERE product_id < 10",
    "SELECT amount FROM sales WHERE (amount > 100 AND year = 2024) OR quantity < 5",
    "SELECT quantity / 3 AS q, quantity % 7 AS m FROM sales WHERE product_id = 1",
    "SELECT amount FROM sales WHERE region = 'EU' AND year IN (2021, 2023)",
    "SELECT amount FROM sales WHERE region != 'EU' AND quantity BETWEEN 10 AND 20",
    "SELECT CASE WHEN amount > 100 THEN 1 ELSE 0 END AS flag FROM sales WHERE product_id = 3",
    "SELECT CAST(amount AS int) AS ai FROM sales WHERE product_id = 5",
    "SELECT abs(amount - 100.0) AS d FROM sales WHERE product_id = 7",
    # aggregation
    "SELECT COUNT(*) AS n, SUM(quantity) AS s, SUM(amount) AS f FROM sales",
    "SELECT region, COUNT(*) AS n, SUM(amount) AS s, AVG(amount) AS a, "
    "MIN(amount) AS mn, MAX(amount) AS mx FROM sales GROUP BY region",
    "SELECT region, year, SUM(quantity) AS q FROM sales GROUP BY region, year",
    "SELECT product_id, COUNT(DISTINCT customer_id) AS d FROM sales GROUP BY product_id",
    "SELECT product_id, SUM(DISTINCT quantity) AS sd, AVG(DISTINCT quantity) AS ad "
    "FROM sales GROUP BY product_id",
    "SELECT SUM(DISTINCT quantity) AS sd, AVG(DISTINCT quantity) AS ad, "
    "COUNT(DISTINCT quantity) AS cd FROM sales",
    "SELECT region, SUM(DISTINCT v) AS sd FROM nullt GROUP BY region",
    "SELECT region, SUM(amount) AS s FROM sales GROUP BY region HAVING s > 100000",
    "SELECT region, MAX(amount) - MIN(amount) AS spread FROM sales GROUP BY region",
    "SELECT year, COUNT(*) AS n FROM sales WHERE amount > 120 GROUP BY year",
    "SELECT MIN(region) AS mn, MAX(region) AS mx FROM sales",
    # joins
    "SELECT s.amount, c.customer_name FROM sales s JOIN customers c ON s.customer_id = c.customer_id WHERE s.amount > 180",
    "SELECT c.region, SUM(s.amount) AS t FROM sales s JOIN customers c "
    "ON s.customer_id = c.customer_id GROUP BY c.region",
    "SELECT s.amount FROM sales s JOIN customers c ON s.customer_id = c.customer_id "
    "AND s.region = c.region",
    "SELECT l.v, r.w FROM lt l LEFT JOIN rt r ON l.k = r.k",
    "SELECT l.v, r.w FROM lt l RIGHT JOIN rt r ON l.k = r.k",
    "SELECT l.v, r.w FROM lt l FULL JOIN rt r ON l.k = r.k",
    "SELECT l.v FROM lt l JOIN rt r ON l.k = r.k AND l.v > r.w",
    # sort / limit / distinct
    "SELECT amount FROM sales ORDER BY amount DESC LIMIT 10",
    "SELECT region, year, amount FROM sales ORDER BY region ASC, year DESC, amount ASC LIMIT 25",
    "SELECT a FROM seq ORDER BY a LIMIT 10 OFFSET 20",
    "SELECT DISTINCT region, year FROM sales",
    "SELECT DISTINCT product_id FROM sales WHERE product_id < 5",
    # aggregates over strings / nulls
    "SELECT region, COUNT(v) AS c, SUM(v) AS s FROM nullt GROUP BY region",
    "SELECT COUNT(*) AS n FROM nullt WHERE v IS NULL",
    "SELECT COUNT(*) AS n FROM nullt WHERE v IS NOT NULL AND v > 1",
    # derived tables
    "SELECT t.region, SUM(t.v) AS s FROM "
    "(SELECT region, amount * quantity AS v FROM sales) t GROUP BY t.region",
    # date functions
    "SELECT date_part('year', ts) AS y, date_part('month', ts) AS m, COUNT(*) AS n "
    "FROM events GROUP BY y, m",
    "SELECT date_part('day', ts) AS d, date_part('hour', ts) AS h FROM events WHERE ev = 3",
    # LIKE
    "SELECT COUNT(*) AS n FROM customers WHERE customer_name LIKE 'cust00%'",
    # the reference's example workloads
    "SELECT c.region, p.category, "
    "COUNT(DISTINCT o.order_id) AS num_orders, "
    "COUNT(DISTINCT c.customer_id) AS num_customers, "
    "SUM(oi.quantity * p.price) AS total_revenue, "
    "AVG(oi.quantity * p.price) AS avg_order_value "
    "FROM orders o "
    "JOIN order_items oi ON o.order_id = oi.order_id "
    "JOIN products p ON oi.product_id = p.product_id "
    "JOIN customers c ON o.customer_id = c.customer_id "
    "WHERE o.order_date >= '2024-01-01' AND o.order_date < '2024-07-01' "
    "AND o.status = 'completed' "
    "GROUP BY c.region, p.category "
    "HAVING total_revenue > 9000 "
    "ORDER BY total_revenue DESC",
    "SELECT date_part('year', ts) AS year, date_part('month', ts) AS month, "
    "COUNT(*) AS num_events, SUM(ev) AS total_value "
    "FROM events GROUP BY year, month ORDER BY year, month",
    # empty results
    "SELECT amount FROM sales WHERE amount > 1e18",
    "SELECT region, SUM(amount) AS s FROM sales WHERE amount > 1e18 GROUP BY region",
    "SELECT COUNT(*) AS n, SUM(amount) AS s FROM sales WHERE amount > 1e18",
]

# every query of the parity corpus, joins included, and UNION ALL (string
# columns over different dictionaries, int with float, nulls, a UNION
# under an aggregate)
SLICE_QUERIES = list(QUERIES) + [
    "SELECT region, amount FROM sales WHERE amount > 240 UNION ALL "
    "SELECT region, CAST(customer_id AS DOUBLE) FROM customers "
    "WHERE customer_id < 20",
    "SELECT k, v FROM lt UNION ALL SELECT k, w FROM rt WHERE w > 500",
    "SELECT region, v FROM nullt UNION ALL SELECT region, amount FROM sales "
    "WHERE quantity = 7",
    "SELECT k, COUNT(*) AS n, SUM(v) AS s FROM (SELECT k, v FROM lt "
    "UNION ALL SELECT k, w AS v FROM rt) u GROUP BY k",
    "SELECT a FROM seq WHERE a < 5 UNION SELECT k FROM lt WHERE k < 8",
]


# the kernels' shapes over the same tables, which the parity corpus never
# takes (on ``sales`` and ``order_items`` at ``scale >= 16``, past their
# row gates): filter_agg's global aggregates under ``<int column> <cmp>
# <int literal>`` (every operator, the literal on either side, SUM-only,
# MIN/MAX-only and AVG lanes, no row or every row kept), seg_agg's GROUP BY
# of one int key (a WHERE gathered before the sort, a string key's codes),
# inner joins of one int key that materialize their pairs against a build
# side with repeated keys (stream_compact, expand_fill) and two lookup
# joins on a unique key
KERNEL_QUERIES = [
    "SELECT COUNT(*) AS n, SUM(quantity) AS s, MIN(customer_id) AS mn, "
    "MAX(customer_id) AS mx FROM sales WHERE product_id < 10",
    "SELECT COUNT(*) AS n, AVG(quantity) AS a FROM sales WHERE year >= 2023",
    "SELECT SUM(customer_id) AS s, MAX(quantity) AS mx FROM sales "
    "WHERE 40 < product_id",
    "SELECT COUNT(*) AS n, MIN(year) AS mn FROM sales WHERE quantity = 7",
    "SELECT COUNT(*) AS n, SUM(product_id) AS s, SUM(year) AS y, "
    "MIN(quantity) AS mn, AVG(customer_id) AS a FROM sales "
    "WHERE customer_id <> 150",
    "SELECT COUNT(*) AS n, SUM(quantity) AS s, MIN(quantity) AS mn "
    "FROM sales WHERE year > 2030",
    "SELECT COUNT(*) AS n, MAX(year) AS mx FROM sales WHERE year <= 2025",
    "SELECT COUNT(*) AS n, SUM(quantity) AS s FROM sales "
    "WHERE product_id > '25'",
    "SELECT COUNT(*) AS n, SUM(quantity) AS q, MAX(order_id) AS mx "
    "FROM order_items WHERE product_id >= 25",
    "SELECT product_id, COUNT(*) AS n, SUM(quantity) AS s, "
    "MIN(quantity) AS mn, MAX(quantity) AS mx FROM sales GROUP BY product_id",
    "SELECT customer_id, SUM(quantity) AS s, COUNT(*) AS n FROM sales "
    "WHERE customer_id < 100 GROUP BY customer_id",
    "SELECT region, COUNT(*) AS n, SUM(quantity) AS s FROM sales "
    "WHERE year > 2022 GROUP BY region",
    "SELECT order_id, COUNT(*) AS n, MAX(quantity) AS mx FROM order_items "
    "GROUP BY order_id",
    "SELECT DISTINCT customer_id FROM sales WHERE quantity < 50",
    "SELECT s.quantity, l.v FROM sales s JOIN lt l ON s.product_id = l.k "
    "WHERE s.year = 2021",
    "SELECT s.region, l.v, s.customer_id FROM sales s JOIN lt l "
    "ON s.product_id = l.k WHERE s.quantity < 10",
    "SELECT oi.quantity, r.w FROM order_items oi JOIN rt r "
    "ON oi.product_id = r.k WHERE oi.quantity = 3",
    "SELECT oi.quantity, o.status FROM order_items oi JOIN orders o "
    "ON oi.order_id = o.order_id WHERE oi.quantity > 7",
    "SELECT s.quantity, c.customer_name FROM sales s JOIN customers c "
    "ON s.customer_id = c.customer_id WHERE s.year = 2021",
]


class _Rows:
    """Draws of one fact table: the first ``n`` rows from ``rng`` as the
    original draws them, then ``n * (scale - 1)`` more from a generator
    spawned from ``rng`` (spawning leaves ``rng``'s stream as it was)."""

    def __init__(self, rng, n: int, scale: int):
        self.rng, self.n, self.extra = rng, int(n), int(n) * (int(scale) - 1)
        self.more = rng.spawn(1)[0] if self.extra else None

    def __call__(self, draw):
        head = draw(self.rng, self.n)
        if not self.extra:
            return head
        return np.concatenate([head, draw(self.more, self.extra)])


def populate(eng, rng, scale: int = 1):
    """Register the parity corpus's tables in ``eng`` (a copy of
    ``test_device_parity._populate``); ``scale`` multiplies the rows of
    ``sales``, ``nullt`` and ``order_items``."""
    rows = _Rows(rng, 5000, scale)
    eng.register("sales", {
        "product_id": rows(lambda g, k: g.integers(0, 50, k)),
        "amount": rows(lambda g, k: g.normal(100.0, 50.0, k)),
        "quantity": rows(lambda g, k: g.integers(1, 100, k)),
        "customer_id": rows(lambda g, k: g.integers(0, 300, k)),
        "region": rows(lambda g, k: g.choice(["EU", "US", "APAC", "LATAM"], k)),
        "year": rows(lambda g, k: g.integers(2020, 2026, k)),
    })
    eng.register("customers", {
        "customer_id": np.arange(200),  # some sales customer_ids unmatched
        "customer_name": np.array([f"cust{i:03d}" for i in range(200)]),
        "region": rng.choice(["EU", "US", "APAC", "LATAM"], 200),
    })
    eng.register("lt", {"k": rng.integers(0, 30, 100), "v": rng.integers(0, 1000, 100)})
    eng.register("rt", {"k": rng.integers(10, 40, 80), "w": rng.integers(0, 1000, 80)})
    eng.register("seq", {"a": np.arange(100)})
    rows = _Rows(rng, 400, scale)
    vals = rows(lambda g, k: g.normal(0, 2, k))
    vals[rows(lambda g, k: g.random(k)) < 0.3] = np.nan
    eng.register("nullt", {
        "region": rows(lambda g, k: g.choice(["a", "b", "c"], k)), "v": vals})
    n_ord = 800
    months = rng.integers(1, 13, n_ord)
    eng.register("orders", {
        "order_id": np.arange(n_ord),
        "customer_id": rng.integers(0, 300, n_ord),
        "order_date": np.array([f"2024-{m:02d}-{d:02d}" for m, d in
                                zip(months, rng.integers(1, 29, n_ord))]),
        "status": rng.choice(["completed", "pending", "cancelled"], n_ord,
                             p=[0.7, 0.2, 0.1]),
    })
    rows = _Rows(rng, 2500, scale)
    eng.register("order_items", {
        "order_id": rows(lambda g, k: g.integers(0, n_ord, k)),
        "product_id": rows(lambda g, k: g.integers(0, 50, k)),
        "quantity": rows(lambda g, k: g.integers(1, 10, k)),
    })
    eng.register("products", {
        "product_id": np.arange(50),
        "category": rng.choice(["tools", "toys", "food", "books"], 50),
        "price": np.round(rng.uniform(1, 100, 50), 2),
    })
    base = np.datetime64("2023-06-01T00:00:00", "ms").astype(np.int64)
    ts = base + rng.integers(0, 400 * 24 * 3600 * 1000, 500, dtype=np.int64)
    eng.register("events", {"ts": ts.astype("datetime64[ms]"),
                            "ev": rng.integers(0, 10, 500)})


# ---------------------------------------------------------------------------
# edge values through the kernels' routes
# ---------------------------------------------------------------------------

I32_MIN, I32_MAX = -(1 << 31), (1 << 31) - 1


def edge_tables(eng, rng, scale: int = 1):
    """``edge`` (``5000 * scale`` rows): ``k`` int64 keys in [-4, 12);
    ``i`` int64 over the widest range that the executor narrows to int32
    (it keeps four values clear of each int32 extreme), a tenth of it at
    each end;
    ``x`` the same with the int32 extremes themselves (too wide to
    narrow); ``big`` int64 in [0, 2**42), so that a SUM over 1.28M rows
    nears 2**62; ``f`` float64 with a twentieth -0.0 and a twentieth 0.0 and
    a fifth NULL; ``z`` float64 in {-2.5, -0.0, 0.0, 1.5}; ``s`` a string
    with the empty string among its values; ``b`` BOOL.  ``zdim``: the
    float keys ``z`` in {0.0, 1.5, 7.0} with a payload ``w``."""
    rows = _Rows(rng, 5000, scale)

    def ints(lo, hi):
        def draw(g, n):
            x = g.integers(lo, hi, n, endpoint=True)
            pick = g.random(n)
            x[pick < 0.1] = lo
            x[pick > 0.9] = hi
            return x
        return draw

    def floats(g, n):
        x = g.normal(0.0, 50.0, n)
        pick = g.random(n)
        x[pick < 0.05] = -0.0
        x[(pick >= 0.05) & (pick < 0.1)] = 0.0
        x[pick > 0.8] = np.nan
        return x

    eng.register("edge", {
        "k": rows(lambda g, n: g.integers(-4, 12, n)),
        "i": rows(ints(I32_MIN + 5, I32_MAX - 5)),
        "x": rows(ints(I32_MIN, I32_MAX)),
        "big": rows(lambda g, n: g.integers(0, 1 << 42, n)),
        "f": rows(floats),
        "z": rows(lambda g, n: g.choice([-2.5, -0.0, 0.0, 1.5], n)),
        "s": rows(lambda g, n: g.choice(["", "a", "ab", "b"], n)),
        "b": rows(lambda g, n: g.random(n) < 0.5),
    })
    eng.register("zdim", {"z": np.array([0.0, 1.5, 7.0]),
                          "w": np.array([10, 20, 30])})


EDGE_QUERIES = [
    "SELECT k, COUNT(*) AS n, SUM(i) AS s, MIN(i) AS mn, MAX(i) AS mx "
    "FROM edge GROUP BY k",
    "SELECT COUNT(*) AS n, SUM(i) AS s, MIN(i) AS mn, MAX(i) AS mx "
    "FROM edge WHERE k >= 0",
    "SELECT COUNT(*) AS n, SUM(i) AS s FROM edge WHERE i = 2147483642",
    "SELECT COUNT(*) AS n, SUM(k) AS s, MIN(i) AS mn FROM edge "
    "WHERE i > -2147483643",
    "SELECT COUNT(*) AS n, SUM(x) AS s, MIN(x) AS mn, MAX(x) AS mx "
    "FROM edge WHERE k < 5",
    "SELECT k, SUM(x) AS s, MIN(x) AS mn, MAX(x) AS mx FROM edge "
    "GROUP BY k",
    "SELECT k, SUM(i) AS s FROM edge WHERE k < 6 GROUP BY k",
    "SELECT COUNT(*) AS n, SUM(big) AS s, MAX(big) AS mx FROM edge",
    "SELECT k, SUM(big) AS s, MIN(big) AS mn FROM edge GROUP BY k",
    "SELECT k, MIN(f) AS mn, MAX(f) AS mx, COUNT(f) AS n FROM edge "
    "GROUP BY k",
    "SELECT MIN(z) AS mn, MAX(z) AS mx, MIN(f) AS fmn, MAX(f) AS fmx "
    "FROM edge",
    "SELECT z, COUNT(*) AS n, SUM(k) AS s FROM edge GROUP BY z",
    "SELECT DISTINCT z FROM edge",
    "SELECT k % 3 AS m, k / 3 AS q, COUNT(*) AS n FROM edge "
    "GROUP BY k % 3, k / 3",
    "SELECT k, COUNT(i / 0) AS c, COUNT(k % 0) AS r FROM edge GROUP BY k",
    "SELECT s, COUNT(*) AS n, MIN(i) AS mn, MAX(k) AS mx FROM edge "
    "GROUP BY s",
    "SELECT COUNT(*) AS n FROM edge WHERE s = ''",
    "SELECT MIN(s) AS mn, MAX(s) AS mx FROM edge WHERE k > 2",
    "SELECT COUNT(*) AS n, SUM(k) AS s FROM edge WHERE b",
    "SELECT b, COUNT(*) AS n, MAX(i) AS mx FROM edge WHERE NOT b OR k > 8 "
    "GROUP BY b",
    "SELECT i, k FROM edge ORDER BY i DESC, k LIMIT 7",
    "SELECT k FROM edge ORDER BY k LIMIT 0",
    "SELECT DISTINCT k FROM edge ORDER BY k LIMIT 5 OFFSET 3",
    "SELECT e.k, COUNT(*) AS n, SUM(d.w) AS sw FROM edge e JOIN zdim d "
    "ON e.z = d.z GROUP BY e.k",
    "SELECT d.z, COUNT(e.k) AS n FROM zdim d LEFT JOIN edge e "
    "ON d.z = e.z GROUP BY d.z",
    "SELECT k, AVG(f) AS a, SUM(f) AS sf FROM edge GROUP BY k",
]

# the queries over ``populate`` and ``edge_tables``: ``engine_corpus`` part
# a, the card test and the oracle-agreement tests all run this one list
CARD_QUERIES = SLICE_QUERIES + KERNEL_QUERIES + EDGE_QUERIES

# engine_corpus's scales: the parity corpus's fact tables at 256 times
# their rows (``sales`` 1.28M rows, past filter_agg's 64K-row gate) and the
# fuzzer's ``t1`` at 64 times (12.8K-128K rows, past seg_agg's 2048-row
# gate)
CORPUS_SCALE_A = 256
CORPUS_SCALE_B = 64


# ---------------------------------------------------------------------------
# the smoke's 17 queries (engine_corpus part a, first), over smoke_tables
# ---------------------------------------------------------------------------

SMOKE_QUERIES = [
    "SELECT k, SUM(v) AS s FROM t GROUP BY k ORDER BY s DESC",
    "SELECT a, c FROM s WHERE c > 900 ORDER BY c DESC, a LIMIT 25",
    "SELECT DISTINCT a, r FROM s",
    "SELECT a, b, SUM(c) AS sc, MIN(c) AS mn, COUNT(*) AS n "
    "FROM s GROUP BY a, b",
    "SELECT COUNT(*) AS n, SUM(c) AS sc, MIN(c) AS mn, MAX(c) AS mx "
    "FROM s WHERE a >= 0",
    # joins of the parity corpus's shapes
    "SELECT l.v, r.w FROM lt l JOIN rt r ON l.k = r.k",
    "SELECT l.v, r.w FROM lt l LEFT JOIN rt r ON l.k = r.k",
    "SELECT l.v, r.w FROM lt l RIGHT JOIN rt r ON l.k = r.k",
    "SELECT l.v, r.w FROM lt l FULL JOIN rt r ON l.k = r.k",
    "SELECT l.v FROM lt l JOIN rt r ON l.k = r.k AND l.v > r.w",
    "SELECT l.v, r.w FROM lt l JOIN rt r ON l.k = r.k AND l.g = r.g",
    "SELECT l.tag, COUNT(*) AS n FROM lt l JOIN rt r ON l.tag = r.tag "
    "GROUP BY l.tag",
    "SELECT s.c, c.name FROM s JOIN cust c ON s.a = c.id WHERE s.c > 900",
    "SELECT c.region, SUM(s.c) AS t FROM s JOIN cust c ON s.a = c.id "
    "GROUP BY c.region",
    "SELECT COUNT(*) AS n, SUM(l.v) AS sv, MIN(r.w) AS mw "
    "FROM lt l JOIN rt r ON l.k = r.k",
    "SELECT c.region, COUNT(*) AS n, SUM(r.w) AS sw FROM lt l "
    "JOIN rt r ON l.k = r.k JOIN cust c ON l.k = c.id "
    "WHERE l.g = 1 GROUP BY c.region",
    # UNION ALL: strings over two dictionaries, int with float
    "SELECT r, c, a FROM s WHERE a = 3 UNION ALL "
    "SELECT region, id, v FROM cust JOIN t ON cust.id = t.k "
    "WHERE t.v < 30",
]


def smoke_tables(eng) -> None:
    """Single-table and join tables: duplicate keys on both sides, partial
    overlap, nulls, a unique key (lookup join) and string keys with
    different dictionaries."""
    g = np.random.default_rng(2)
    n = 200_000
    eng.register("t", {"k": np.arange(n) % 7, "v": np.arange(n, dtype=float)})
    eng.register("s", {"a": g.integers(-40, 40, n), "b": g.integers(0, 9, n),
                       "c": g.integers(-1000, 1000, n),
                       "r": g.choice(["EU", "US", "APAC"], n)})
    lt_v = g.normal(0, 10, 3000)
    lt_v[g.random(3000) < 0.1] = np.nan
    eng.register("lt", {"k": g.integers(0, 300, 3000),
                        "g": g.integers(0, 3, 3000), "v": lt_v,
                        "tag": g.choice(["x", "y", "z"], 3000)})
    eng.register("rt", {"k": g.integers(100, 400, 2000),
                        "g": g.integers(0, 3, 2000),
                        "w": g.integers(0, 1000, 2000),
                        "tag": g.choice(["y", "z", "q"], 2000)})
    eng.register("cust", {"id": np.arange(-40, 260),
                          "name": np.array([f"c{i:03d}" for i in range(300)]),
                          "region": g.choice(["EU", "US", "APAC"], 300)})


# ---------------------------------------------------------------------------
# the fuzzer (tests/test_fuzz_parity.py)
# ---------------------------------------------------------------------------

N_QUERIES = 60


def gen_tables(rng, scale: int = 1):
    """``t1`` (``scale`` times its rows) and ``t2``, as
    ``test_fuzz_parity._gen_tables`` draws them."""
    rows = _Rows(rng, rng.integers(200, 2000), scale)
    t1 = {
        "a": rows(lambda g, k: g.integers(-50, 50, k).astype(np.int64)),
        "b": rows(lambda g, k: g.integers(0, 10, k).astype(np.int64)),
        "c": rows(lambda g, k: g.normal(0, 100, k)),
        "s": rows(lambda g, k: g.choice(["x", "y", "z", "w"], k)),
    }
    # sprinkle nulls into the float column
    mask = rows(lambda g, k: g.random(k)) < 0.2
    t1["c"] = np.where(mask, np.nan, t1["c"])
    m = rng.integers(50, 500)
    t2 = {
        "b": rng.integers(0, 12, m).astype(np.int64),
        "w": rng.integers(0, 1000, m).astype(np.int64),
    }
    return t1, t2


AGGS = ["COUNT(*)", "SUM(t.a)", "AVG(t.c)", "MIN(t.a)", "MAX(t.c)",
        "COUNT(t.c)", "COUNT(DISTINCT t.b)", "SUM(t.a + t.b)", "MAX(t.s)",
        "SUM(DISTINCT t.a)", "AVG(DISTINCT t.b)"]
# build-side and decomposable mixed-side arguments (the sorted-space join
# aggregates)
AGGS_JOIN = ["SUM(t2.w)", "MIN(t2.w)", "SUM(t.a + t2.w)",
             "AVG(t.b + t2.w)", "MAX(t2.w)", "SUM(t.a * t2.w)"]
PREDS = ["t.a > 0", "t.b IN (1, 2, 3)", "t.c IS NOT NULL", "t.s = 'x'",
         "t.a BETWEEN -10 AND 25", "t.c > 50 OR t.b < 2", "NOT t.s = 'y'",
         "t.a % 3 = 0"]


def gen_query(rng, preds=PREDS):
    """``test_fuzz_parity._gen_query`` drawing its predicates from
    ``preds``."""
    parts = ["SELECT"]
    use_join = rng.random() < 0.35
    group = rng.random() < 0.6
    glob = not group and rng.random() < 0.4  # global aggregate shape
    sel = []
    pool = list(AGGS) + (list(AGGS_JOIN) if use_join else [])
    if group:
        keys = list(rng.choice(["b", "s"], size=rng.integers(1, 3), replace=False))
        sel += [f"t.{k}" for k in keys]
        n_aggs = rng.integers(1, 4)
        aggs = list(rng.choice(pool, size=n_aggs, replace=False))
        sel += [f"{a} AS agg{i}" for i, a in enumerate(aggs)]
    elif glob:
        n_aggs = rng.integers(1, 5)
        aggs = list(rng.choice(pool, size=n_aggs, replace=False))
        sel = [f"{a} AS agg{i}" for i, a in enumerate(aggs)]
    else:
        sel = ["t.a", "t.b", "t.c"]
    parts.append(", ".join(sel))
    if use_join:
        parts.append("FROM t1 t JOIN t2 ON t.b = t2.b")
    else:
        parts.append("FROM t1 t")
    if rng.random() < 0.7:
        n_preds = rng.integers(1, 3)
        chosen = rng.choice(preds, size=n_preds, replace=False)
        parts.append("WHERE " + " AND ".join(chosen))
    if group:
        parts.append("GROUP BY " + ", ".join(f"t.{k}" for k in keys))
        if rng.random() < 0.3:
            parts.append("HAVING COUNT(*) > 2")
    if rng.random() < 0.4:
        if rng.random() < 0.5:
            # LIMIT must have a total order to be deterministic: sort by all
            # output columns
            ordinals = ", ".join(
                str(i + 1) + (" DESC" if rng.random() < 0.5 else "")
                for i in range(len(sel)))
            parts.append("ORDER BY " + ordinals)
            parts.append(f"LIMIT {int(rng.integers(1, 50))}")
        else:
            parts.append("ORDER BY 1" + (" DESC" if rng.random() < 0.5 else ""))
    return " ".join(parts)


def fuzz_case(seed: int, scale: int = 1):
    """The tables and the query of fuzz seed ``seed``."""
    rng = np.random.default_rng(1000 + seed)
    t1, t2 = gen_tables(rng, scale)
    return t1, t2, gen_query(rng)


# ---------------------------------------------------------------------------
# the mesh and streamed generators (tests/test_torch_path_fuzz.py)
# ---------------------------------------------------------------------------

N_PATH_SEEDS = 40
TYPED_PREDS = ["t.a > '10'", "t.b = '3'", "t.b IN ('1', '2')",
               "t.c > '50.5'", "t.a BETWEEN '-10' AND '25'", "t.s <> 3"]
MESH = ("torch-distributed",)
STREAMED = ("torch-streaming", "torch-streaming-partitioned")


def draw(rng, accept):
    """``gen_query`` over the pool with the typed predicates, redrawn (up
    to 30 times) until ``accept(sql)``."""
    for _ in range(30):
        sql = gen_query(rng, PREDS + TYPED_PREDS)
        if accept(sql):
            break
    return sql


def distributable(sql):
    return "t.s" not in sql and ("GROUP BY" in sql or "LIMIT" in sql)


def streamable(sql):
    return "t.s" not in sql and "DISTINCT" not in sql and \
        not sql.startswith("SELECT t.a, t.b, t.c")


def as_numbers(sql):
    """The query with each numeric string literal written as a number."""
    return re.sub(r"'([+-]?[0-9]+(?:\.[0-9]+)?)'", r"\1", sql)


def mixed(plan):
    """Every comparison, IN list and join-key pair of a lowered plan that
    sets a STRING side against a non-STRING side."""
    found = []

    def is_str(e):
        return e.dtype is DType.STRING

    def walk(x):
        if isinstance(x, P.PhysBinary) and x.op in P._COMPARISONS:
            if is_str(x.left) != is_str(x.right):
                found.append(x)
        elif isinstance(x, P.PhysInList):
            if any(v is not None and isinstance(v, str) != is_str(x.operand)
                   for v in x.values):
                found.append(x)
        elif isinstance(x, P.TpuHashJoin):
            found.extend(pair for pair in zip(x.left_keys, x.right_keys)
                         if is_str(pair[0]) != is_str(pair[1]))
        if dataclasses.is_dataclass(x) and not isinstance(x, type):
            for f in dataclasses.fields(x):
                walk(getattr(x, f.name))
        elif isinstance(x, (tuple, list)):
            for y in x:
                walk(y)

    walk(plan)
    return found


# 4096 group slots hold every query's groups (at most 10 x 4) and keep the
# shards' padded merge sorts small
MESH_CONFIG = dict(mesh_shape=(8,), max_groups=4096)


def mesh_case(seed: int):
    """``(t1, t2, sql)`` of mesh seed ``seed``: two seeds in three redraw
    until the query groups or sorts with a LIMIT and reads no string
    column, the shapes the mesh distributes."""
    rng = np.random.default_rng(20_000 + seed)
    t1, t2 = gen_tables(rng)
    sql = draw(rng, distributable if seed % 3 != 1 else (lambda s: True))
    return t1, t2, sql


def streamed_case(seed: int):
    """``(t1, t2, sql)`` of streamed seed ``seed``: ``c`` without nulls
    (the stream refuses them); two seeds in three redraw until the query
    aggregates without DISTINCT and reads no string column."""
    rng = np.random.default_rng(30_000 + seed)
    t1, t2 = gen_tables(rng)
    t1["c"] = np.where(np.isnan(t1["c"]), -7.25, t1["c"])
    sql = draw(rng, streamable if seed % 3 != 1 else (lambda s: True))
    return t1, t2, sql


def streamed_config(seed: int) -> dict:
    """The streamed seed's engine settings: 4096 group slots, as for the
    mesh; every third seed 16, so the state overflows and grows."""
    cfg = dict(table_cache_threshold_rows=100, batch_size=256,
               max_groups=4096)
    if seed % 3 == 0:
        cfg.update(max_groups=16, stream_state_partition_groups=8)
    return cfg


# ---------------------------------------------------------------------------
# streamed star joins (tests/test_torch_star_fuzz.py)
# ---------------------------------------------------------------------------

N_STAR_SEEDS = 40
WORDS = np.array(["p", "q", "r", "s"], dtype=object)
STAR_KEYS = ["t.b", "t2.g", "t2.w", "t.a % 5"]
STAR_AGGS = ["COUNT(*)", "SUM(t.a)", "SUM(t.c)", "SUM(t2.w)", "MIN(t.a)",
             "MAX(t.c)", "MIN(t2.x)", "MAX(t2.w)", "AVG(t.c)", "AVG(t2.w)",
             "MIN(t2.g)", "MAX(t2.g)"]
STAR_PREDICATES = [None, "t2.g = 'p'", "t.c > t2.x",
                   "t2.g <> 'q' AND t.a > 20"]
STAR_FACT_ONLY = ("SELECT t.b AS k0, COUNT(*) AS m0, SUM(t.c) AS m1, "
                  "MIN(t.a) AS m2 FROM t1 t GROUP BY t.b")


def star_tables(seed: int, directory):
    """``(fact_path, dim, dim_path)``: the fact table ``t1`` written to
    ``directory/t1.parquet``; the dimension ``t2`` as an Arrow table, also
    written to ``directory/t2.parquet`` on odd seeds (else ``dim_path`` is
    None)."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(3000, 9001))
    m = int(rng.integers(20, 301))
    fact = pa.table({
        "a": rng.integers(0, 100, n).astype(np.int64),
        "b": rng.integers(0, m + m // 4, n).astype(np.int64),
        "c": rng.normal(50.0, 10.0, n),
    })
    dim = pa.table({
        # duplicate keys widen the join; keys past m find no fact row
        "b": rng.integers(0, m + m // 8, m).astype(np.int64),
        "w": rng.integers(-50, 1000, m).astype(np.int64),
        "x": rng.normal(50.0, 10.0, m),
        "g": WORDS[rng.integers(0, len(WORDS), m)],
    })
    fact_path = os.path.join(str(directory), "t1.parquet")
    pq.write_table(fact, fact_path)
    dim_path = None
    if seed % 2:
        dim_path = os.path.join(str(directory), "t2.parquet")
        pq.write_table(dim, dim_path)
    return fact_path, dim, dim_path


def star_query(rng, first):
    """One star join and the names of its group keys; the first query of a
    seed always reads ``t2.g``."""
    keys = list(rng.choice(STAR_KEYS, size=int(rng.integers(0, 3)),
                           replace=False))
    aggs = list(rng.choice(STAR_AGGS, size=int(rng.integers(1, 4)),
                           replace=False))
    if first and "t2.g" not in keys and not any("t2.g" in a for a in aggs):
        if rng.random() < 0.5:
            keys.append("t2.g")
        else:
            aggs.append(str(rng.choice(["MIN(t2.g)", "MAX(t2.g)"])))
    pred = STAR_PREDICATES[int(rng.integers(0, len(STAR_PREDICATES)))]
    names = [f"k{i}" for i in range(len(keys))]
    select = [f"{k} AS {nm}" for k, nm in zip(keys, names)] + \
        [f"{a} AS m{i}" for i, a in enumerate(aggs)]
    sql = (f"SELECT {', '.join(select)} FROM t1 t JOIN t2 "
           "ON t.b = t2.b")
    if pred:
        sql += f" WHERE {pred}"
    if keys:
        sql += f" GROUP BY {', '.join(keys)}"
    return sql, names


def star_small(seed: int) -> bool:
    """Every third seed caps the group state at 16 slots."""
    return seed % 3 == 0


def star_config(seed: int) -> dict:
    """4096 group slots hold every seed's groups; a query drawn twice must
    run twice, not come from the result cache."""
    cfg = dict(table_cache_threshold_rows=1000, batch_size=2048,
               max_groups=4096, enable_cache=False)
    if star_small(seed):
        cfg.update(max_groups=16, stream_state_partition_groups=8)
    return cfg


def star_queries(seed: int):
    """``[(sql, group key names), ...]`` of star seed ``seed``: three star
    joins, and on the small-state seeds a GROUP BY of the fact table alone
    (the hash-partitioned state)."""
    rng = np.random.default_rng(10_000 + seed)
    queries = [star_query(rng, first=i == 0) for i in range(3)]
    if star_small(seed):
        queries.append((STAR_FACT_ONLY, ["k0"]))
    return queries


# ---------------------------------------------------------------------------
# numbers against string literals (tests/test_torch_typed_literals.py)
# ---------------------------------------------------------------------------

TYPED_ROWS = 2000


def typed_table():
    """Seed 0: ``b`` int64 in [0, 10), ``c`` float64 normal(0, 100), ``i``
    int32 in [0, 100), then a string ``s`` of four letters, a BOOL ``f``
    and the row number ``v``."""
    rng = np.random.default_rng(0)
    n = TYPED_ROWS
    b = rng.integers(0, 10, n)
    c = rng.normal(0, 100, n)
    i = rng.integers(0, 100, n).astype(np.int32)
    s = rng.choice(["w", "x", "y", "z"], n).astype(object)
    return pa.table({"b": b, "c": c, "i": i, "s": s, "f": b % 2 == 0,
                     "v": np.arange(n, dtype=np.int64)})


def typed_dim():
    """A small table to join with: integer keys ``k`` and their text
    ``ks``."""
    k = np.arange(0, 10, 2, dtype=np.int64)
    return pa.table({"k": k, "ks": np.array([str(x) for x in k],
                                             dtype=object)})


def columns(table):
    """An Arrow table's columns as numpy arrays."""
    return {n: table.column(n).to_numpy(zero_copy_only=False)
            for n in table.column_names}


# (predicate, numpy mask over the table's columns)
TYPED_PREDICATES = {
    "b_eq": ("b = '3'", lambda t: t["b"] == 3),
    "b_ne": ("b <> '3'", lambda t: t["b"] != 3),
    "b_lt": ("b < ' 4 '", lambda t: t["b"] < 4),
    "b_le": ("'4' >= b", lambda t: t["b"] <= 4),
    "b_gt": ("b > '5'", lambda t: t["b"] > 5),
    "b_ge": ("b >= '+7'", lambda t: t["b"] >= 7),
    "b_between": ("b BETWEEN '2' AND '4'",
                  lambda t: (t["b"] >= 2) & (t["b"] <= 4)),
    "b_not_between": ("b NOT BETWEEN '-1' AND '6'",
                      lambda t: (t["b"] < -1) | (t["b"] > 6)),
    "b_in": ("b IN ('1', '2')", lambda t: np.isin(t["b"], [1, 2])),
    "b_not_in": ("b NOT IN ('1', 2, '03')",
                 lambda t: ~np.isin(t["b"], [1, 2, 3])),
    "c_gt": ("c > '50'", lambda t: t["c"] > 50),
    "c_lt": ("c < '-12.5'", lambda t: t["c"] < -12.5),
    "c_ge": ("'1e1' <= c", lambda t: t["c"] >= 10.0),
    "c_between": ("c BETWEEN '-1e1' AND '25.25'",
                  lambda t: (t["c"] >= -10.0) & (t["c"] <= 25.25)),
    "i_eq": ("i = '42'", lambda t: t["i"] == 42),
    "i_le": ("i <= '9'", lambda t: t["i"] <= 9),
    "i_in": ("i IN ('42', '7')", lambda t: np.isin(t["i"], [42, 7])),
    "mixed": ("b > '2' AND c >= '0' OR i = '42'",
              lambda t: ((t["b"] > 2) & (t["c"] >= 0)) | (t["i"] == 42)),
}


# ---------------------------------------------------------------------------
# TIMESTAMP and DATE against date strings (tests/test_torch_temporal.py)
# ---------------------------------------------------------------------------

TEMPORAL_ROWS = 2000
DAY_MS = 86_400_000


def temporal_table():
    """``ts`` over 2020-2022, a third of it at midnight, and six rows on
    2021-06-01 (three at midnight), so that every ``=`` meets rows; ``d``
    the same instants as days; ``v`` the row number; ``s`` the day as
    text."""
    rng = np.random.default_rng(11)
    n = TEMPORAL_ROWS
    lo = np.datetime64("2020-01-01", "D").astype(np.int64)
    hi = np.datetime64("2023-01-01", "D").astype(np.int64)
    days = rng.integers(lo, hi, n)
    days[:6] = np.datetime64("2021-06-01", "D").astype(np.int64)
    ms = days * DAY_MS + np.where(rng.random(n) < 0.3, 0,
                                  rng.integers(0, DAY_MS, n))
    ms[:3] = days[:3] * DAY_MS
    return pa.table({
        "ts": pa.array(ms.astype("datetime64[ms]")),
        "d": pa.array(days.astype(np.int32), pa.date32()),
        "v": np.arange(n, dtype=np.int64),
        "s": np.array([str(x) for x in days.astype("datetime64[D]")],
                      dtype=object),
    })


def temporal_columns(table):
    """``ts`` and ``d`` of ``temporal_table()`` as numpy datetimes."""
    ts = table.column("ts").to_numpy().astype("datetime64[ms]")
    d = table.column("d").to_numpy().astype("datetime64[D]")
    return {"ts": ts, "d": d}


D = np.datetime64
# (predicate, numpy mask over {"ts": ..., "d": ...})
TEMPORAL_PREDICATES = {
    "ts_eq": ("ts = '2021-06-01'", lambda c: c["ts"] == D("2021-06-01")),
    "ts_ne": ("ts != '2021-06-01'", lambda c: c["ts"] != D("2021-06-01")),
    "ts_lt": ("ts < '2021-06-01 12:30'",
              lambda c: c["ts"] < D("2021-06-01T12:30")),
    "ts_le": ("ts <= '2021-06-01'", lambda c: c["ts"] <= D("2021-06-01")),
    "ts_gt": ("ts > '2021-06-01'", lambda c: c["ts"] > D("2021-06-01")),
    "ts_ge": ("'2021-06-01T00:00:00.250' <= ts",
              lambda c: c["ts"] >= D("2021-06-01T00:00:00.250")),
    "ts_between": ("ts BETWEEN '2021-03' AND '2021-06-15'",
                   lambda c: (c["ts"] >= D("2021-03"))
                   & (c["ts"] <= D("2021-06-15"))),
    "ts_in": ("ts IN ('2021-06-01', '2020-02-29', '2022-12-31')",
              lambda c: np.isin(c["ts"], [D("2021-06-01", "ms"),
                                          D("2020-02-29", "ms"),
                                          D("2022-12-31", "ms")])),
    "d_eq": ("d = '2021-06-01'", lambda c: c["d"] == D("2021-06-01")),
    "d_ne": ("d <> '2021-06-01'", lambda c: c["d"] != D("2021-06-01")),
    "d_lt": ("d < '2021-06-01'", lambda c: c["d"] < D("2021-06-01")),
    "d_le": ("d <= '2021-06-01'", lambda c: c["d"] <= D("2021-06-01")),
    "d_gt": ("d > '2021'", lambda c: c["d"] > D("2021")),
    "d_ge": ("d >= '2021-06-01'", lambda c: c["d"] >= D("2021-06-01")),
    "d_between": ("d NOT BETWEEN '2020-06-01' AND '2022-06-01'",
                  lambda c: ~((c["d"] >= D("2020-06-01"))
                              & (c["d"] <= D("2022-06-01")))),
    "d_in": ("d IN ('2021-06-01', '2021-06-02')",
             lambda c: np.isin(c["d"], [D("2021-06-01"), D("2021-06-02")])),
    "range": ("ts >= '2021-01-01' AND ts < '2021-07-01' AND d > '2021-02'",
              lambda c: (c["ts"] >= D("2021-01-01"))
              & (c["ts"] < D("2021-07-01")) & (c["d"] > D("2021-02"))),
}


def predicate_sql(pred: str) -> str:
    """The count and row-number sum that both matrices ask under ``pred``."""
    return f"SELECT COUNT(*) AS n, SUM(v) AS s FROM t WHERE {pred}"


# ---------------------------------------------------------------------------
# comparing two results
# ---------------------------------------------------------------------------

#: tier-1's tolerance for float columns (aggregates are summed in another
#: order)
RTOL = ATOL = 1e-12


def order_keys(sql: str, columns) -> list:
    """The output columns that the query's last ORDER BY names, in order:
    ordinals and names (a ``t.`` qualifier dropped); [] without ORDER BY."""
    m = re.search(r"\bORDER BY\s+(.*?)(?:\s+LIMIT\b.*)?$", sql, re.S)
    if m is None:
        return []
    keys = []
    for item in m.group(1).split(","):
        name = item.split()[0]
        if name.isdigit():
            keys.append(columns[int(name) - 1])
        else:
            name = name.split(".")[-1]
            if name in columns:
                keys.append(name)
    return keys


def canon(df):
    """The rows of a frame sorted by every column (a multiset's order)."""
    cols = list(df.columns)
    return df.sort_values(cols).reset_index(drop=True) if cols else df


def float_gaps(g, e):
    """The absolute difference of two float columns row by row, NaN against
    NaN and equal infinities counted as equal (inf where only one side is
    NaN)."""
    g, e = g.astype(np.float64), e.astype(np.float64)
    gn, en = np.isnan(g), np.isnan(e)
    with np.errstate(invalid="ignore"):
        d = np.abs(g - e)
    d[(g == e) | (gn & en)] = 0.0
    d[gn != en] = np.inf
    return d


def float_gap(g, e):
    """The largest of :func:`float_gaps` (0.0 for no rows)."""
    d = float_gaps(g, e)
    return float(d.max()) if d.size else 0.0


def compare_frames(got, exp, rtol=RTOL, atol=ATOL, bounds=None):
    """Compare two frames of the same columns and row count, column by
    column: integers and strings exactly, floats within ``rtol``/``atol``
    (NaN equal to NaN).  A float column that misses that tolerance may
    instead be held, row by row, to ``bounds(col, exp)``: an absolute bound
    for each row of ``exp`` (an array, or one number for every row), or
    None for none.  Returns ``(first differing column or None, {col: (gap,
    bound)})`` for the columns held to their bounds, each with the gap and
    bound of its row nearest its bound."""
    held = {}
    for col in got.columns:
        g, e = got[col].to_numpy(), exp[col].to_numpy()
        if g.dtype.kind == "f" or e.dtype.kind == "f":
            if np.allclose(g.astype(np.float64), e.astype(np.float64),
                           rtol=rtol, atol=atol, equal_nan=True):
                continue
            bound = bounds(col, exp) if bounds is not None else None
            if bound is not None:
                gaps = float_gaps(g, e)
                bound = np.broadcast_to(np.asarray(bound, np.float64),
                                        gaps.shape)
                if (gaps <= bound).all():
                    with np.errstate(divide="ignore", invalid="ignore"):
                        share = np.where(gaps > 0, gaps / bound, 0.0)
                    i = int(np.argmax(share))
                    held[col] = (float(gaps[i]), float(bound[i]))
                    continue
        elif np.array_equal(g, e):
            continue
        return col, held
    return None, held


def assert_same_result(got, exp, sql: str, what: str, bounds=None) -> dict:
    """``got`` and ``exp`` (QueryResults or frames) hold the same rows as
    multisets and, under ORDER BY, the same ordered key columns; raises
    ``AssertionError`` naming ``what`` and the first differing column.
    ``bounds`` as for ``compare_frames``; returns the columns held to
    their bound."""
    g = got if hasattr(got, "columns") else got.to_pandas()
    e = exp if hasattr(exp, "columns") else exp.to_pandas()
    if list(g.columns) != list(e.columns) or len(g) != len(e):
        raise AssertionError(f"{what}: columns {list(g.columns)} x {len(g)} "
                             f"rows, expected {list(e.columns)} x {len(e)}")
    col, held = compare_frames(canon(g), canon(e), bounds=bounds)
    if col is None:
        keys = order_keys(sql, list(g.columns))
        if keys:
            e = e.reset_index(drop=True)
            # the bounds of the ordered rows, read from their whole rows
            ordered = None if bounds is None else (
                lambda c, _frame: bounds(c, e))
            col, more = compare_frames(g[keys].reset_index(drop=True),
                                       e[keys], bounds=ordered)
            held.update(more)
            if col is not None:
                col = f"{col} (in ORDER BY order)"
    if col is not None:
        raise AssertionError(f"{what}: column {col} differs")
    return held


# ---------------------------------------------------------------------------
# the summation bound of a float SUM or AVG
# ---------------------------------------------------------------------------

EPS = 2.0 ** -52


def _split_top(text: str, sep: str = ","):
    """``text`` split at ``sep`` outside parentheses."""
    out, depth, cur = [], 0, []
    for ch in text:
        depth += (ch == "(") - (ch == ")")
        if ch == sep and depth == 0:
            out.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    out.append("".join(cur))
    return [x.strip() for x in out]


def _top_from(sql: str) -> int:
    """Index of the first `` FROM `` outside parentheses."""
    depth = 0
    for i, ch in enumerate(sql):
        depth += (ch == "(") - (ch == ")")
        if depth == 0 and sql.startswith(" FROM ", i):
            return i
    return -1


def _output_name(item: str):
    """``(expression, output column name)`` of one SELECT item; the name is
    None for an expression without an alias."""
    m = re.fullmatch(r"(.*)\s+AS\s+(\w+)", item, re.S)
    if m:
        return m.group(1).strip(), m.group(2)
    if re.fullmatch(r"[\w.]+", item):
        return item, item.split(".")[-1]
    return item, None


def summation_bound(oracle, sql: str, column: str, frame):
    """Per-row absolute bounds on the rounding error of the float ``SUM(x)
    AS column`` of ``sql`` summed in any order, for the rows of ``frame`` (a
    result of ``sql``): each row's bound is ``n_g * 2**-52 * sum(|x_g|)`` of
    its own group g, ``n_g`` the rows the aggregate reads in g and
    ``sum(|x_g|)`` their magnitudes, both from ``oracle`` over the query's
    FROM, WHERE and GROUP BY (HAVING, ORDER BY and LIMIT dropped).  Rows
    are matched to groups on the GROUP BY expressions that the SELECT list
    outputs; a row matching several groups (the list outputs only some of
    the keys, or none) takes the largest of their bounds, never their sum.
    ``AVG(x) AS column``: each group's bound over its count of ``x``.
    ``SUM(DISTINCT x)`` / ``AVG(DISTINCT x)``: the distinct values are
    among the group's rows, so the rows' ``n_g`` and ``sum(|x_g|)`` bound
    theirs.  None for any other column or a UNION."""
    if "UNION" in sql or not sql.startswith("SELECT "):
        return None
    cut = _top_from(sql)
    if cut < 0:
        return None
    items = [_output_name(it) for it in _split_top(sql[len("SELECT "):cut])]
    item = None
    for expr, name in items:
        m = re.fullmatch(r"(SUM|AVG)\((?:DISTINCT\s+)?(.*)\)", expr, re.S)
        if m and name == column:
            item = m
    if item is None:
        return None
    func, arg = item.group(1), item.group(2)
    rest = re.split(r" (?:HAVING|ORDER BY|LIMIT) ", sql[cut:])[0]
    m = re.search(r" GROUP BY (.*)$", rest, re.S)
    group = set()
    for g in _split_top(m.group(1)) if m else []:
        if g.isdigit():
            g = items[int(g) - 1][0]
        group.add(next((e for e, nm in items if nm == g), g))
    keys = [(e, nm) for e, nm in items
            if e in group and nm is not None and nm in frame.columns]
    sel = [f"{e} AS {nm}" for e, nm in keys]
    q = (f"SELECT {', '.join(sel + [''])}COUNT(*) AS n__, "
         f"COUNT({arg}) AS c__, SUM(abs({arg})) AS s__{rest}")
    r = oracle.query(q).to_pandas()
    s = np.nan_to_num(r["s__"].to_numpy(dtype=np.float64))
    r["b__"] = r["n__"].to_numpy(np.float64) * EPS * s
    if func == "AVG":
        r["b__"] /= np.maximum(r["c__"].to_numpy(np.float64), 1.0)
    if not len(r):
        return np.zeros(len(frame))
    if not keys:
        return np.full(len(frame), float(r["b__"].max()))
    names = [nm for _, nm in keys]
    per_key = r.groupby(names, dropna=False, sort=False)["b__"].max()
    got = frame[names].merge(per_key.reset_index(), how="left", on=names)
    return got["b__"].fillna(r["b__"].max()).to_numpy(np.float64)


def own_sum(x):
    """``(math.fsum(x), len(x) * 2**-52 * sum(|x|))``: the exact sum of one
    group's values and the bound on the rounding error of any order of
    summing them.  Where ``x`` holds an infinity the sum is numpy's (inf,
    -inf or NaN) and the bound 0: only that value is right."""
    x = np.asarray(x, np.float64)
    if not np.isfinite(x).all():
        return float(np.sum(x)), 0.0
    return math.fsum(x), len(x) * EPS * math.fsum(np.abs(x))


# ---------------------------------------------------------------------------
# float group sums of unlike magnitudes (tests/test_torch_float_sums.py)
# ---------------------------------------------------------------------------

FLOAT_SUM_PROBES = ("large_first", "fees")


def float_sum_probe(name: str):
    """``(k, v)`` of a probe whose groups differ in magnitude, in key
    order.  ``large_first``: k=0 one row of 1e17, k=1 three rows of 1.0,
    k=2 70,000 rows of 0.25.  ``fees``: k=0 100,000 rows of 1e10, k=1 1,000
    rows of cents (seed 0), a ledger of a few large accounts and many small
    fees."""
    if name == "large_first":
        k = np.repeat(np.arange(3), [1, 3, 70_000])
        v = np.concatenate([[1e17], np.ones(3), np.full(70_000, 0.25)])
    elif name == "fees":
        rng = np.random.default_rng(0)
        k = np.repeat(np.arange(2), [100_000, 1_000])
        v = np.concatenate([np.full(100_000, 1e10),
                            rng.integers(1, 100, 1_000) / 100])
    else:
        raise KeyError(name)
    return k, v


def float_sum_table(name: str, nulls: int = 2):
    """The probe as a table ``t(k int64, g string, v float64)``: ``g`` is
    ``acct<k>``, each group also holds ``nulls`` NULL ``v``, and the rows
    are shuffled (seed 1)."""
    k, v = float_sum_probe(name)
    groups = np.unique(k)
    k = np.concatenate([k, np.repeat(groups, nulls)])
    v = np.concatenate([v, np.full(len(groups) * nulls, np.nan)])
    order = np.random.default_rng(1).permutation(len(k))
    k, v = k[order], v[order]
    return pa.table({"k": k, "g": np.array([f"acct{x}" for x in k]),
                     "v": pa.array(v, mask=np.isnan(v))})
