"""The attribution of ``olapbench/core/spans.py`` on hand-built event lists,
and the readers of the program's ``register`` and ``upload`` spans."""

import pytest

from olapbench.core import spans, spec
from olapbench.core.cell import Query, Run
from olapbench.core.spans import Event

MAIN = 7  # the querying thread


def _host(name, start, end, corr, kind="cpu_op"):
    return Event(name, kind, False, start, end, MAIN, corr)


def _range(name, start, end, corr):
    return Event(name, "user_annotation", False, start, end, MAIN, corr,
                 annotation=True)


def _kernel(start, end, linked, corr=0, kind="kernel", name="k"):
    return Event(name, kind, True, start, end, 0, corr, linked)


def _query_trace():
    """One query in a 0-1000 ns window: ``aggregate`` holds a nested
    ``join`` (one launch), then ``to_host`` holds a copy; the device idles
    from 500 to 700 inside ``to_host``, and a mirrored annotation of the
    whole query lies on the device."""
    return [
        _range("olapbench.window", 0, 1000, 1),
        _range("olapbench.query:q3", 10, 990, 2),
        _range("olap/query", 20, 980, 3),
        _range("olap/aggregate", 30, 400, 4),
        _range("olap/join", 40, 200, 5),
        _host("aten::index", 50, 60, 6),
        _host("aten::sort", 210, 220, 7),
        _range("olap/to_host", 450, 880, 8),
        _host("aten::copy_", 460, 870, 9),
        # the device: a gather launched in join, a sort in aggregate, the
        # copy in to_host
        _kernel(100, 300, 6, name="gather"),
        _kernel(300, 500, 7, name="sort"),
        _kernel(700, 800, 9, kind="gpu_memcpy", name="copy"),
        Event("olap/query", "gpu_user_annotation", True, 20, 980, 0, 0, 3,
              annotation=True),
        Event("olapbench.query:q3", "gpu_user_annotation", True, 10, 990,
              0, 0, 2, annotation=True),
    ]


def test_a_launch_inside_a_nested_join_counts_to_join():
    s = spans.summary(_query_trace())
    assert s["device_s_by_span"] == {"join": 200e-9, "aggregate": 200e-9,
                                     "to_host": 100e-9}
    assert s["unattributed_share"] == 0
    assert s["per_query_ms"] == [{"join": 200e-6, "aggregate": 200e-6,
                                  "to_host": 100e-6}]
    assert spans.median_ms(s, "join") == pytest.approx(200e-6)
    assert spans.median_ms(s, "filter") is None


def test_annotations_on_the_device_leave_busy_time_alone():
    events = _query_trace()
    s = spans.summary(events)
    # the kernels alone: 100-500 and 700-800, whatever the annotations span
    assert s["busy_s"] == pytest.approx(500e-9)
    assert s["window_s"] == pytest.approx(1000e-9)
    bare = [e for e in events if not (e.on_device and e.annotation)]
    assert spans.summary(bare)["busy_s"] == s["busy_s"]


def test_kind_filter_drops_what_the_name_filter_dropped():
    """Without the program's ranges the benchmark's own annotations are
    the only ones on the device: dropping by kind drops exactly those."""
    events = [e for e in _query_trace()
              if not e.name.startswith(spans.PROGRAM)]
    by_kind = [e for e in events if spans.is_work(e)]
    by_name = [e for e in events
               if e.on_device and not e.name.startswith(spans.BENCH)]
    assert by_kind == by_name


def test_an_idle_gap_inside_to_host_is_named_by_it():
    s = spans.summary(_query_trace())
    # gaps 500-700 (in to_host's copy), 800-1000 (after to_host), 0-100
    assert [label for label, _ in s["idle_gaps"]] == [
        "in q3: to_host > aten::copy_", "in q3: query",
        "in q3: join > aten::index"]
    assert [sec for _, sec in s["idle_gaps"]] == pytest.approx(
        [200e-9, 200e-9, 100e-9])
    # each stretch of a gap goes to the span open over it: 0-20 none, 20-30
    # query, 30-40 aggregate, 40-100 join; 500-700 to_host; 800-880
    # to_host, 880-980 query, 980-1000 none
    assert s["idle_s_by_span"] == pytest.approx(
        {"to_host": 280e-9, "query": 110e-9, "join": 60e-9,
         "aggregate": 10e-9, "(no span)": 40e-9})
    assert sum(s["idle_s_by_span"].values()) == pytest.approx(
        s["window_s"] - s["busy_s"])


def test_a_device_event_with_no_linked_launch_is_unattributed():
    events = _query_trace() + [_kernel(850, 900, 0, name="orphan"),
                               _kernel(900, 950, 2, name="bench")]
    s = spans.summary(events)
    # no link at all; linked to the benchmark's own range, under no span
    assert s["device_s_by_span"]["(unattributed)"] == pytest.approx(100e-9)
    assert s["unattributed_share"] == pytest.approx(100 / 600)


def test_a_launch_found_through_its_runtime_call():
    """Runtime calls and ops number their correlation ids apart, so the
    same number may name both (as on the card): the kernel's runtime call
    decides, not the op that shares its number."""
    events = _query_trace()[:9] + [
        Event("cudaLaunchKernel", "", False, 55, 58, MAIN, 7, 6),
        _kernel(100, 300, 0, corr=7, kind=""),
        # an op of the same number 7 (aten::sort, in aggregate) and a
        # profiler activity of another op's number
        Event("Activity Buffer Request", "", False, 600, 610, MAIN, 6)]
    s = spans.summary(events)
    assert s["device_s_by_span"] == {"join": 200e-9}


def test_a_trace_without_the_window_has_no_summary():
    assert spans.summary([_kernel(0, 10, 0)]) is None


def test_events_of_a_cpu_profile_keep_the_program_ranges():
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("olapbench.window"):
            with record_function("olap/join"):
                import torch

                torch.ones(4).sum()
    events = spans.events_of(prof)
    join = next(e for e in events if e.name == "olap/join")
    op = next(e for e in events if e.name == "aten::sum")
    assert join.annotation and not join.on_device
    assert join.thread == op.thread and join.start <= op.start <= join.end
    s = spans.summary(events)
    assert s["busy_s"] == 0 and s["device_s_by_span"] == {}


READERS = ("catalog.register_s", "executor.upload_s")


@pytest.mark.parametrize("name", READERS)
def test_reader_finds_nothing_without_the_span(name, monkeypatch):
    from gpu_olap_tpu_torch.utils import metrics

    monkeypatch.setattr(metrics, "GLOBAL_METRICS", metrics.MetricsRegistry())
    run = Run(1.0, 1.0, [Query("q", 0.1)], "cpu", None)
    assert spec.metric_reader(name)(run) is None


def test_readers_read_the_program_spans():
    import numpy as np

    from gpu_olap_tpu_torch import EngineConfig, TorchOlapEngine
    from gpu_olap_tpu_torch.utils.metrics import GLOBAL_METRICS

    def calls():
        return {k: getattr(GLOBAL_METRICS.ops.get(k), "calls", 0)
                for k in ("register", "upload")}

    before = calls()
    eng = TorchOlapEngine(EngineConfig(enable_cache=False), device="cpu")
    eng.register("t", {"a": np.arange(1000), "b": np.arange(1000.0)})
    for _ in range(3):
        eng.query("SELECT a, b FROM t WHERE a < 10")
    after = calls()
    assert {k: after[k] - before[k] for k in after} == {
        "register": 1, "upload": 1}
    run = Run(1.0, 1.0, [Query("q", 0.1)], "cpu", None)
    got = {n: spec.metric_reader(n)(run) for n in READERS}
    ops = GLOBAL_METRICS.ops
    assert got["catalog.register_s"] == ops["register"].seconds > 0
    assert got["executor.upload_s"] == ops["upload"].seconds > 0
