"""Where the device time goes in the port's cells, on one NVIDIA GPU.

    python3 chip_trace.py      # about 3 minutes on one H100

Runs the seven queries of ``chip_smoke.py`` on its tables (same sizes,
seeds, SQL and engine settings): filter_agg, groupby, stream_join,
stream_join_grouped, join, join_lookup and sortmerge.  Each query runs once
to warm up, three times untimed by the profiler, then once under
``torch.profiler``.  One JSON line per query gives:

- ``wall_median_ms``: the median host wall of the three untraced runs;
- ``traced_wall_ms``: the host wall of the traced run;
- ``device_busy_ms``: the sum of the durations of the device-side events of
  the traced run (kernels, memcpy, memset).  Only those events count: the
  ``aten::`` rows run on the host, and their device totals repeat the
  durations of the kernels they launched;
- ``idle_share``: ``1 - device_busy_ms / wall_median_ms``;
- ``top``: the device events grouped by name, largest first.

The full grouped list of each query goes to
``chiprun_out/trace_<query>.json``.  Exits non-zero without CUDA.
"""

from __future__ import annotations

import collections
import json
import os
import sys
import time

import numpy as np
import torch

import chip_smoke as cs

OUT_DIR = "chiprun_out"
TOP = 12


def device_events(prof) -> dict:
    """Device microseconds by event name: device-side events only."""
    by_name = collections.defaultdict(float)
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CPU:
            by_name[e.name] += e.time_range.elapsed_us()
    return dict(by_name)


def trace_query(eng, name: str, sql: str, card: str) -> dict:
    from torch.profiler import ProfilerActivity, profile

    eng.query(sql)
    torch.cuda.synchronize()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        eng.query(sql)
        walls.append(time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = eng.query(sql)
        torch.cuda.synchronize()
        traced_s = time.perf_counter() - t0
    if res.metrics["backend"] != "torch-cuda":
        raise AssertionError(f"{name}: backend {res.metrics['backend']}")
    by_name = device_events(prof)
    if not by_name:
        raise AssertionError(f"{name}: the trace holds no device event")
    busy_ms = sum(by_name.values()) / 1e3
    wall_ms = float(np.median(walls)) * 1e3
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, f"trace_{name}.json"), "w") as f:
        json.dump({"query": name, "sql": sql, "card": card,
                   "device_us_by_name": dict(ranked)}, f, indent=1)
    return {"query": name, "routes": res.metrics["routes"],
            "wall_median_ms": wall_ms, "traced_wall_ms": traced_s * 1e3,
            "device_busy_ms": busy_ms, "idle_share": 1 - busy_ms / wall_ms,
            "top": [{"name": k[:100], "ms": v / 1e3,
                     "share": v / 1e3 / busy_ms} for k, v in ranked[:TOP]]}


def _say(**kv) -> None:
    print(json.dumps(kv), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_trace: CUDA is not available", file=sys.stderr)
        return 1
    from gpu_olap_tpu_torch import EngineConfig, TorchOlapEngine

    card = cs._card()
    dev = torch.device("cuda", 0)
    print(card, flush=True)

    # BASELINE configs 1 and 2, as chip_smoke._run_bench builds them
    cfg = dict(max_groups=1 << 23, min_shape_bucket=1 << 16,
               enable_cache=False)
    eng = TorchOlapEngine(EngineConfig(**cfg), device=dev)
    rng = np.random.default_rng(0)
    fk = rng.integers(0, 1 << 20, cs.FILTER_ROWS).astype(np.int64)
    eng.register("t", {"k": fk, "v": rng.integers(0, 1000, cs.FILTER_ROWS)
                       .astype(np.int64)})
    del fk
    _say(**trace_query(eng, "filter_agg", "SELECT COUNT(*) AS n, SUM(v) AS s "
                       "FROM t WHERE v > 500", card))
    eng = TorchOlapEngine(EngineConfig(**cfg), device=dev)
    torch.cuda.empty_cache()
    rng = np.random.default_rng(1)
    gk = rng.integers(0, cs.GROUPBY_GROUPS, cs.GROUPBY_ROWS).astype(np.int64)
    eng.register("t", {"k": gk, "v": rng.integers(0, 1_000_000,
                                                  cs.GROUPBY_ROWS)
                       .astype(np.int64)})
    del gk
    _say(**trace_query(eng, "groupby", "SELECT k, SUM(v) AS s, MIN(v) AS mn, "
                       "MAX(v) AS mx FROM t GROUP BY k", card))
    del eng
    torch.cuda.empty_cache()

    # the join tables, as chip_smoke._run_joins builds them
    eng = cs._join_engine(dev, 2.2)
    rng = np.random.default_rng(2)
    n = cs.JOIN_ROWS
    lk = rng.integers(0, cs.JOIN_KEYS, n).astype(np.int64)
    rk = rng.integers(0, cs.JOIN_KEYS, n).astype(np.int64)
    eng.register("l", {"k": lk, "v": rng.integers(0, 1000, n)
                       .astype(np.int64)})
    eng.register("r", {"k": rk, "w": rng.integers(0, 1000, n)
                       .astype(np.int64)})
    del lk, rk
    for name, sql in (
            ("stream_join", "SELECT COUNT(*) AS n, SUM(l.v + r.w) AS s, "
             "MIN(l.v - r.w) AS mn FROM l JOIN r ON l.k = r.k"),
            ("stream_join_grouped", "SELECT r.w AS g, COUNT(*) AS n, "
             "SUM(l.v) AS s FROM l JOIN r ON l.k = r.k GROUP BY r.w"),
            ("join", "SELECT COUNT(*) AS n, SUM(l.k + r.k) AS s "
             "FROM l JOIN r ON l.k = r.k")):
        _say(**trace_query(eng, name, sql, card))
    del eng
    torch.cuda.empty_cache()

    nl, nr = cs.LOOKUP_ROWS
    eng = cs._join_engine(dev, 1.25)
    rng = np.random.default_rng(2)
    eng.register("l", {"k": rng.integers(0, nr, nl).astype(np.int64),
                       "v": rng.integers(0, 1000, nl).astype(np.int64)})
    eng.register("r", {"k": np.arange(nr, dtype=np.int64),
                       "w": rng.integers(0, 1000, nr).astype(np.int64)})
    _say(**trace_query(eng, "join_lookup", "SELECT COUNT(*) AS n, "
                       "SUM(l.v + r.w) AS s FROM l JOIN r ON l.k = r.k", card))
    del eng
    torch.cuda.empty_cache()

    n = cs.SORTMERGE_ROWS
    eng = cs._join_engine(dev, 2.5)
    rng = np.random.default_rng(3)
    eng.register("l", {"k": rng.integers(0, n // 4, n).astype(np.int64)})
    eng.register("r", {"k": rng.integers(0, n // 4, n).astype(np.int64)})
    _say(**trace_query(eng, "sortmerge",
                       "SELECT COUNT(*) AS n FROM l JOIN r ON l.k = r.k",
                       card))
    del eng
    torch.cuda.empty_cache()

    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")
    print(card, flush=True)
    _say(ok=True, device={"platform": "gpu",
                          "kind": torch.cuda.get_device_name(0),
                          "count": torch.cuda.device_count()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
