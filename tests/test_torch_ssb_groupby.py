"""SSB's grouped queries, Q2.1-Q4.3, through ``TorchOlapEngine`` on the CPU
against the benchmark's plain reference (``olapbench/reference/``).

Every one of them groups by dimension columns that an inner join gives a
validity lane, under a row mask (the WHERE and the join's matches) that
keeps a few percent of the join's capacity or less: the GROUP BY gathers
the kept rows before it sorts.  The tables are the benchmark's generator's
at scale 0.002 (240K lineorder rows); the constants are the mix's draws
from a fixed seed, plus a draw of Q3.4 whose mask keeps no row.
"""

import pathlib
import random
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from olapbench.core import cell, check, traffic  # noqa: E402
from olapbench.reference import plain  # noqa: E402

SCALE = 0.002
SEED = 2**31 + 11
GROUPED = ["q2_1", "q2_2", "q2_3", "q3_1", "q3_2", "q3_3", "q3_4", "q4_1",
           "q4_2", "q4_3"]
COUNTERS = ("torch_groupby_compact", "torch_groupby_rows_in",
            "torch_groupby_rows_kept")
ROUTES = ("torch_join_lookup_left", "torch_join_stream_path",
          "torch_groupby_rows_in")


@pytest.fixture(scope="module")
def ssb():
    c = cell.Cell("ssb_sf20.flights_all")
    bench = cell.Bench(c.config, SEED, "cpu", scale=SCALE)
    yield c, bench, plain.View(bench.tables, "cpu")
    bench.free_program()


def _draws(c, bench, q):
    rng = random.Random(f"{SEED}/{q}")
    while True:
        yield traffic.draw(c.mix["params"][q], rng, bench.domains)


def _run(ssb, q, p, counters=COUNTERS):
    """The program's answer to ``q`` with constants ``p``, held to the
    reference's; returns the reference's row count and the increments of
    ``counters``."""
    from gpu_olap_tpu_torch.utils.metrics import GLOBAL_METRICS

    c, bench, view = ssb
    before = GLOBAL_METRICS.snapshot()
    res = bench.engine.query(c.sql[q].format(**p))
    after = GLOBAL_METRICS.snapshot()
    assert res.metrics["backend"] == "torch-cpu"
    ref = c.refs[q]
    want = ref.answer(view, p, plain.PRECISIONS["exact"])
    why, gap = check.compare(check.program_columns(res), want, ref.KEYS,
                             ref.ORDER)
    assert why is None, (q, p, why)
    assert gap == 0.0, (q, p, gap)
    return (len(next(iter(want.values()))),
            [after.get(k, 0) - before.get(k, 0) for k in counters])


@pytest.mark.parametrize("q", GROUPED)
def test_grouped_query_equals_the_reference(ssb, q):
    c, bench, _ = ssb
    draws = _draws(c, bench, q)
    for _ in range(2):
        rows, (calls, rows_in, kept) = _run(ssb, q, next(draws))
        # one masked GROUP BY, which keeps at least a row of each group
        assert calls == 1 and rows <= kept < rows_in


@pytest.mark.parametrize("q", GROUPED)
def test_grouped_query_joins_by_lookup_over_the_fact_rows(ssb, q):
    """Q3.x and Q4.x name a dimension first (``FROM customer JOIN
    lineorder``): their first join looks the fact rows up in the
    dimension's dense index, not a sort-merge of ``lineorder``, so the
    GROUP BY sees ``lineorder``'s rows, not the stream join's doubled
    capacity.  Q2.x names ``lineorder`` first and builds on the right."""
    c, bench, _ = ssb
    _rows, (left, stream, rows_in) = _run(ssb, q, next(_draws(c, bench, q)),
                                          ROUTES)
    assert left == (0 if q.startswith("q2") else 1)
    assert stream == 0
    assert rows_in == bench.tables.rows("lineorder") == 240_000


def test_grouped_query_whose_mask_keeps_no_row(ssb):
    """A Q3.4 draw with no answer: the GROUP BY gets a mask that keeps no
    row, and the query answers with no row."""
    c, bench, _ = ssb
    draws = _draws(c, bench, "q3_4")
    for _ in range(50):
        p = next(draws)
        rows, (calls, rows_in, kept) = _run(ssb, "q3_4", p)
        if rows == 0:
            assert calls == 1 and rows_in > 0 and kept == 0, p
            return
    pytest.fail("no draw of 50 left Q3.4 without an answer")
