"""``BENCHMARK.json`` against the rules of its format, and every file each
entry names found where the harness looks for it."""

import json
import re
import statistics

import pytest

from olapbench.core import env, spec

B = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = B["end_to_end"] + B["per_layer"]


def test_keys_and_sizes():
    assert set(B) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(B)) < 64 * 1024
    assert 1 <= B["run_seconds"] <= 51 and isinstance(B["run_seconds"], int)
    assert 1 <= len(B["configs"]) <= 24 and 1 <= len(B["workloads"]) <= 24
    assert 1 <= len(B["end_to_end"]) <= 16 and 1 <= len(B["per_layer"]) <= 128
    assert B["paths"] == ["olapbench"]
    assert all(not w.startswith("/") and ".." not in w for w in B["command"])


def test_names_and_units():
    names = [m["name"] for m in METRICS] + [w["name"] for w in B["workloads"]] \
        + [c["name"] for c in B["configs"]]
    for n in names + [w["traffic"] for w in B["workloads"]] \
            + [k for c in B["configs"] for k in c["reduced"]]:
        assert NAME.match(n), n
    assert len(set(m["name"] for m in METRICS)) == len(METRICS)
    assert len({w["name"] for w in B["workloads"]}) == len(B["workloads"])
    for m in METRICS:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for text in [w["why"] for w in B["workloads"]] + \
            [m["layer"] for m in B["per_layer"]] + \
            [c["source"] for c in B["configs"]] + \
            [c["why"] for c in B["configs"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_end_to_end_metrics_and_bounds():
    names = {m["name"] for m in B["end_to_end"]}
    assert {"query_ms_p50", "query_ms_p95", "rows_per_s", "setup_s"} <= names
    for m in B["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert next(m for m in B["end_to_end"]
                if m["name"] == "setup_s")["bound"] <= 0.25


@pytest.mark.parametrize("w", B["workloads"], ids=lambda w: w["name"])
def test_each_cell_reports_what_it_moves(w):
    """Every cell reports setup_s, another end-to-end metric and a
    per-layer one; each per-layer metric it reports moves an end-to-end
    metric it reports."""
    e2e = {m["name"] for m in spec.metrics_of(w["name"], False)}
    layer = spec.metrics_of(w["name"], True)
    assert "setup_s" in e2e and len(e2e) >= 2 and layer
    for m in layer:
        assert m["moves"] in e2e, m
    assert w["chips"] == 1


@pytest.mark.parametrize("w", B["workloads"], ids=lambda w: w["name"])
def test_each_cell_finds_its_files(w):
    assert any(c["name"] == w["config"] for c in B["configs"])
    mix = spec.mix(w["config"], w["traffic"])
    assert set(mix["limits"]) >= {"failed", "wrong", "unchecked"}
    for q in mix["queries"]:
        assert spec.query_sql(w["config"], q)
        ref = spec.reference(w["config"], q)
        assert ref.READS and callable(ref.answer)
    for m in spec.metrics_of(w["name"], False) + \
            spec.metrics_of(w["name"], True):
        assert callable(spec.metric_reader(m["name"]))


def test_configs_files_and_layers():
    for c in B["configs"]:
        assert c["file"] == f"olapbench/configs/{c['name']}.json"
        cfg = spec.config(c["name"])
        for key in c["reduced"]:
            assert key in cfg, key
    layers = {m["layer"] for m in B["per_layer"]}
    assert all(len(layer.splitlines()) == 1 for layer in layers)


def test_p95_over_every_query():
    from olapbench.core.cell import Query, Run

    reader = spec.metric_reader("query_ms_p95")
    walls = list(range(1, 201))
    qs = [Query("q", w / 1e3) for w in walls]
    for n in (200, 150, 20):
        want = statistics.quantiles(walls[:n], n=100, method="inclusive")[94]
        assert reader(Run(1.0, 1.0, qs[:n], "cpu", None)) == \
            pytest.approx(want)
    assert reader(Run(1.0, 1.0, qs[:1], "cpu", None)) == pytest.approx(1.0)
    assert reader(Run(1.0, 1.0, [], "cpu", None)) is None


def test_sol_share_reads_the_traced_busy_time():
    from olapbench.core.cell import Query, Run

    reader = spec.metric_reader("ops.sol_share")
    qs = [Query("q", 0.5, device_s=0.4, bytes_needed=10**12),
          Query("q", 0.5, device_s=0.4, bytes_needed=10**12,
                error="planted")]
    rate = env.memory_rate("NVIDIA H100 80GB HBM3")
    trace = {"busy_s": 2.0, "window_s": 4.0}
    # the device_execute spans play no part: the busy seconds do
    assert reader(Run(1.0, 4.0, qs, "gpu", rate, trace)) == \
        pytest.approx(100.0 * 1e12 / (2.0 * 3.35e12))
    assert reader(Run(1.0, 4.0, qs, "gpu", None, None)) is None


def test_memory_rate_refuses_a_card_outside_the_table():
    assert env.memory_rate("NVIDIA H100 80GB HBM3") == 3.35e12
    with pytest.raises(RuntimeError, match="no memory rate"):
        env.memory_rate("NVIDIA H100 PCIe")
