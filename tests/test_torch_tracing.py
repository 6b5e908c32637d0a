"""The port's spans (``gpu_olap_tpu_torch/utils/tracing.py``): off by
default and then free of side effects; on, nested by context with one query
id per query, closed when their body raises, mirrored as ``olap/`` ranges
of a running ``torch.profiler``; the engine's spans from ``query`` down to
each operator, the host transfer, ``register`` and the upload; the
``regrows`` counter of a rerun query."""

import logging
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gpu_olap_tpu_torch import EngineConfig, TorchOlapEngine
from gpu_olap_tpu_torch.utils import tracing
from gpu_olap_tpu_torch.utils.metrics import GLOBAL_METRICS, MetricsRegistry

LOG = logging.getLogger("tracing_test")

JOIN_GROUP_BY = ("SELECT d.w, SUM(f.v) AS s, COUNT(*) AS c FROM f JOIN d "
                 "ON f.k = d.k WHERE f.g < 5 GROUP BY d.w ORDER BY d.w")


def _engine(**kw):
    kw.setdefault("max_groups", 1 << 10)
    eng = TorchOlapEngine(EngineConfig(enable_cache=False, **kw),
                          device="cpu")
    rng = np.random.default_rng(7)
    n = 4000
    eng.register("f", {"k": rng.integers(0, 100, n), "v": rng.random(n),
                       "g": rng.integers(0, 7, n)})
    eng.register("d", {"k": np.arange(100), "w": rng.integers(0, 5, 100)})
    return eng


def _rows(res):
    d = res.to_pydict()
    return sorted(zip(*(list(d[c]) for c in res.column_names)))


def _program_ranges(prof) -> set:
    return {e.name() for e in prof.profiler.kineto_results.events()
            if e.name().startswith(tracing.PREFIX)}


def test_off_records_nothing_and_opens_no_range(monkeypatch):
    opened = []
    real = torch.autograd.profiler.record_function
    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        lambda *a, **k: opened.append(a) or real(*a, **k))
    eng = _engine()
    # the shared no-op: no clock, no range, no object per span
    assert tracing.span(LOG, "scan") is tracing.span(LOG, "join")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = eng.query(JOIN_GROUP_BY)
    assert res.num_rows == 5
    assert opened == [] and _program_ranges(prof) == set()
    tracing.annotate(route="nowhere")  # no recorder: nothing to annotate


def test_off_span_with_a_registry_still_records_into_it():
    reg = MetricsRegistry()
    with tracing.span(LOG, "upload", reg, rows_in=3):
        pass
    assert (reg.ops["upload"].calls, reg.ops["upload"].rows_in) == (1, 3)
    with tracing.record() as rec:
        with tracing.span(LOG, "upload", reg, rows_in=4, table="t"):
            pass
    assert reg.ops["upload"].calls == 2 and reg.ops["upload"].rows_in == 7
    assert [(s.name, s.fields["table"]) for s in rec.spans] == [
        ("upload", "t")]


def test_spans_nest_with_their_parent_and_query_id():
    with tracing.record() as rec:
        for qid in (101, 102):
            with tracing.span(LOG, "query", query_id=qid):
                with tracing.span(LOG, "aggregate"):
                    with tracing.span(LOG, "join"):
                        tracing.annotate(route="lookup")
                    with tracing.span(LOG, "scan"):
                        pass
    by = {(s.query_id, s.name): s for s in rec.spans}
    assert len(rec.spans) == 8 and len(by) == 8
    for qid in (101, 102):
        root, agg = by[qid, "query"], by[qid, "aggregate"]
        assert root.parent_id is None
        assert agg.parent_id == root.span_id
        assert by[qid, "join"].parent_id == agg.span_id
        assert by[qid, "scan"].parent_id == agg.span_id
        assert by[qid, "join"].fields == {"route": "lookup"}
        assert root.start_ns <= agg.start_ns <= by[qid, "join"].start_ns
        assert by[qid, "scan"].end_ns <= agg.end_ns <= root.end_ns
    # closed innermost first
    assert [s.name for s in rec.spans[:4]] == ["join", "scan", "aggregate",
                                               "query"]


def test_a_span_closes_and_records_when_its_body_raises():
    with tracing.record() as rec:
        with pytest.raises(ValueError):
            with tracing.span(LOG, "query", query_id=9):
                with tracing.span(LOG, "to_host"):
                    raise ValueError("planted")
        with tracing.span(LOG, "after"):
            pass
    names = [s.name for s in rec.spans]
    assert names == ["to_host", "query", "after"]
    assert all(s.end_ns >= s.start_ns > 0 for s in rec.spans)
    # the context unwound: the next span is a root again
    assert rec.spans[2].parent_id is None and rec.spans[2].query_id is None


def test_engine_query_yields_spans_and_profiler_ranges():
    eng = _engine()
    plain = eng.query(JOIN_GROUP_BY)
    before = GLOBAL_METRICS._stats("device_execute")
    untraced = eng.query(JOIN_GROUP_BY)
    mid = GLOBAL_METRICS._stats("device_execute")
    with tracing.record() as rec, \
            profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = eng.query(JOIN_GROUP_BY)
    after = GLOBAL_METRICS._stats("device_execute")
    assert _rows(traced) == _rows(untraced) == _rows(plain)
    # the device_execute record is the same, traced or not
    assert after.calls - mid.calls == mid.calls - before.calls == 1
    assert after.rows_in - mid.rows_in == mid.rows_in - before.rows_in
    assert after.rows_out - mid.rows_out == mid.rows_out - before.rows_out
    want = {"query", "plan", "device_execute", "join", "aggregate",
            "to_host", "scan", "filter"}
    assert {tracing.PREFIX + n for n in want} <= _program_ranges(prof)
    assert want <= {s.name for s in rec.spans}
    qid = traced.metrics["query_id"]
    assert {s.query_id for s in rec.spans} == {qid}
    assert qid != untraced.metrics["query_id"]
    root = next(s for s in rec.spans if s.name == "query")
    assert root.fields["backend"] == traced.metrics["backend"] == "torch-cpu"
    host = next(s for s in rec.spans if s.name == "to_host")
    assert host.parent_id == root.span_id
    assert host.fields["rows"] == traced.num_rows
    # three columns of at least 4 bytes a row copied back
    assert host.fields["bytes"] >= traced.num_rows * 3 * 4
    join = next(s for s in rec.spans if s.name == "join")
    assert join.fields["route"] == "lookup"


def test_query_async_keeps_each_querys_spans_apart():
    eng = _engine(num_feed_buffers=2)
    go = threading.Barrier(2)
    real_plan = eng.plan_query

    def plan_together(sql):
        go.wait(timeout=30)  # both pool threads inside a query at once
        return real_plan(sql)

    eng.plan_query = plan_together
    try:
        with tracing.record() as rec:
            futs = [eng.query_async(JOIN_GROUP_BY) for _ in range(2)]
            results = [f.result(timeout=120) for f in futs]
    finally:
        eng.shutdown()
    ids = {r.metrics["query_id"] for r in results}
    assert len(ids) == 2 and {s.query_id for s in rec.spans} == ids
    by_id = {s.span_id: s for s in rec.spans}
    for s in rec.spans:
        if s.name == "query":
            assert s.parent_id is None
        else:  # every parent chain stays inside its own query
            assert by_id[s.parent_id].query_id == s.query_id
    for qid in ids:
        names = [s.name for s in rec.spans if s.query_id == qid]
        assert names.count("query") == names.count("device_execute") == 1


def test_join_inside_a_fused_aggregate_is_named_join():
    eng = _engine()
    with tracing.record() as rec:
        res = eng.query("SELECT SUM(f.v) AS s FROM f JOIN d ON f.k = d.k "
                        "WHERE f.g < 5")
    assert res.num_rows == 1
    by_id = {s.span_id: s for s in rec.spans}
    joins = [s for s in rec.spans if s.name == "join"]
    assert joins and all(by_id[s.parent_id].name == "aggregate"
                         for s in joins)
    assert {s.fields.get("route") for s in joins} <= {
        "sorted_global", "match_counts"}
    agg = next(s for s in rec.spans if s.name == "aggregate")
    assert agg.fields["route"] == "join_aggregate"


def test_regrow_counts_and_the_rerun_carries_its_attempt():
    eng = _engine(join_expansion=0.01)
    eng.register("e", {"k": np.repeat(np.arange(50), 3),
                       "u": np.arange(150)})
    sql = "SELECT f.v, e.u FROM f JOIN e ON f.k = e.k"
    before = GLOBAL_METRICS.snapshot().get("regrows", 0)
    with tracing.record() as rec:
        res = eng.query(sql)
    assert res.metrics["regrows"] >= 1
    assert GLOBAL_METRICS.snapshot()["regrows"] - before == \
        res.metrics["regrows"]
    assert "regrows" not in res.metrics["routes"]
    attempts = [s for s in rec.spans if s.name == "device_execute"]
    assert [s.fields["attempt"] for s in attempts] == list(
        range(res.metrics["regrows"] + 1))
    assert all(s.fields["overflowed"] > 0 for s in attempts[:-1])
    assert attempts[-1].fields["overflowed"] == 0
    # the rerun's operators hang under the rerun's span
    last = attempts[-1].span_id
    by_id = {s.span_id: s for s in rec.spans}
    join = [s for s in rec.spans if s.name == "join"]
    assert len(join) == len(attempts)
    assert by_id[join[-1].parent_id].span_id == last or \
        by_id[by_id[join[-1].parent_id].parent_id].span_id == last
    # a query that fits runs once
    again = eng.query(sql)
    assert again.metrics["regrows"] == 0
    assert _rows(again) == _rows(res)


def test_register_and_upload_spans_record_into_the_registry():
    calls = {k: getattr(GLOBAL_METRICS._stats(k), "calls", 0)
             for k in ("register", "upload")}
    with tracing.record() as rec:
        eng = _engine()
        eng.query("SELECT COUNT(*) AS n FROM f")
        eng.query("SELECT COUNT(*) AS n FROM f")  # resident: no upload
    assert GLOBAL_METRICS._stats("register").calls - calls["register"] == 2
    assert GLOBAL_METRICS._stats("upload").calls - calls["upload"] == 1
    reg = [s for s in rec.spans if s.name == "register"]
    assert [(s.fields["table"], s.fields["rows"]) for s in reg] == [
        ("f", 4000), ("d", 100)]
    up = [s for s in rec.spans if s.name == "upload"]
    assert len(up) == 1 and up[0].fields["table"] == "f"
    assert up[0].fields["rows"] == 4000 and up[0].fields["bytes"] >= 3 * 8 * 4000
    # the upload runs inside the query that first reads the table
    by_id = {s.span_id: s for s in rec.spans}
    assert by_id[up[0].parent_id].name == "query"


def test_query_ids_and_regrows_in_every_result():
    eng = TorchOlapEngine(EngineConfig(enable_cache=True), device="cpu")
    eng.register("t", {"a": np.arange(10)})
    first = eng.query("SELECT SUM(a) AS s FROM t")
    hit = eng.query("SELECT SUM(a) AS s FROM t")
    assert hit.metrics["backend"] == "result-cache"
    assert first.metrics["regrows"] == hit.metrics["regrows"] == 0
    assert hit.metrics["query_id"] > first.metrics["query_id"]
    cpu = TorchOlapEngine(EngineConfig(backend="cpu"), device="cpu")
    cpu.register("t", {"a": np.arange(10)})
    res = cpu.query("SELECT SUM(a) AS s FROM t")
    assert res.metrics["regrows"] == 0 and res.metrics["query_id"] >= 1


def test_streamed_execute_is_a_span(tmp_path):
    import pyarrow as pa
    import pyarrow.parquet as pq

    path = tmp_path / "big.parquet"
    rng = np.random.default_rng(3)
    pq.write_table(pa.table({"k": rng.integers(0, 9, 3000),
                             "v": rng.integers(0, 100, 3000)}), path)
    eng = TorchOlapEngine(EngineConfig(table_cache_threshold_rows=100,
                                       batch_size=1000, enable_cache=False),
                          device="cpu")
    eng.load_table("big", str(path))
    before = GLOBAL_METRICS._stats("streamed_execute")
    with tracing.record() as rec:
        res = eng.query("SELECT k, SUM(v) AS s FROM big GROUP BY k")
    assert res.metrics["backend"] == "torch-streaming"
    assert GLOBAL_METRICS._stats("streamed_execute") == before
    (st,) = [s for s in rec.spans if s.name == "streamed_execute"]
    assert st.fields["rows_in"] == 3000 and st.fields["rows_out"] == 9
    assert st.fields["link_bytes"] > 0


def test_threads_keep_their_spans_apart_under_contention():
    """More threads than cores, switching every microsecond: every span
    keeps a unique id, its own query's id and a parent of that query."""
    import sys

    n_threads, n_queries = 16, 40
    go = threading.Barrier(n_threads)

    def work(t):
        go.wait(timeout=30)
        for q in range(n_queries):
            with tracing.span(LOG, "query", query_id=(t, q)):
                with tracing.span(LOG, "aggregate"):
                    with tracing.span(LOG, "join"):
                        tracing.annotate(thread=t)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with tracing.record() as rec:
            threads = [threading.Thread(target=work, args=(t,))
                       for t in range(n_threads)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=60)
            assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    assert len(rec.spans) == 3 * n_threads * n_queries
    by_id = {s.span_id: s for s in rec.spans}
    assert len(by_id) == len(rec.spans)
    for s in rec.spans:
        if s.name == "query":
            assert s.parent_id is None
        else:
            assert by_id[s.parent_id].query_id == s.query_id
        if s.name == "join":
            assert s.fields["thread"] == s.query_id[0]
