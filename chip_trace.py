"""Where the device time goes in the port's cells, on one NVIDIA GPU.

    python3 chip_trace.py [CELL ...]   # all cells: about 4 minutes on one H100

Runs the queries of ``chip_smoke.py`` on its tables (same sizes, seeds, SQL
and engine settings): filter_agg, groupby, stream_join, stream_join_grouped,
join, join_lookup and sortmerge on one device, then the distributed cells
on the smoke's 8-shard logical mesh: dist_step (BASELINE config 5's fused
step) and dist_join (the engine's SQL join + GROUP BY on 8M rows per side),
each with uniform keys and, as dist_step_zipf and dist_join_zipf, with
Zipf(1.5) probe keys.  Naming cells runs only those (a table feeding several runs
once).  Each query runs once to warm up, three times untimed by the
profiler, then once under ``torch.profiler``.  One JSON line per query
gives:

- ``wall_median_ms``: the median host wall of the three untraced runs;
- ``traced_wall_ms``: the host wall of the traced run;
- ``device_busy_ms``: the sum of the durations of the device-side events of
  the traced run (kernels, memcpy, memset).  Only those events count: the
  ``aten::`` rows run on the host, and their device totals repeat the
  durations of the kernels they launched;
- ``idle_share``: ``1 - device_busy_ms / wall_median_ms``;
- ``peak_device_bytes``: the peak allocation over the warm and traced runs;
- ``top``: the device events grouped by name, largest first.

The full grouped list of each query goes to
``chiprun_out/trace_<query>.json``.  Exits non-zero without CUDA.
"""

from __future__ import annotations

import collections
import functools
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


def trace_run(name: str, run, card: str, what: str) -> dict:
    """Warm-up, three untraced runs and one traced run of ``run()``;
    returns the JSON line (see the module docstring)."""
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        traced_s = time.perf_counter() - t0
    by_name = device_events(prof)
    if not by_name:
        raise AssertionError(f"{name}: the trace holds no device event")
    busy_ms = sum(by_name.values()) / 1e3
    wall_ms = float(np.median(walls)) * 1e3
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, f"trace_{name}.json"), "w") as f:
        json.dump({"query": name, "what": what, "card": card,
                   "device_us_by_name": dict(ranked)}, f, indent=1)
    return out, {"query": name, "wall_median_ms": wall_ms,
                 "traced_wall_ms": traced_s * 1e3, "device_busy_ms": busy_ms,
                 "idle_share": 1 - busy_ms / wall_ms,
                 "peak_device_bytes": torch.cuda.max_memory_allocated(),
                 "top": [{"name": k[:100], "ms": v / 1e3,
                          "share": v / 1e3 / busy_ms}
                         for k, v in ranked[:TOP]]}


def trace_query(eng, name: str, sql: str, card: str,
                backend: str = "torch-cuda") -> dict:
    res, line = trace_run(name, lambda: eng.query(sql), card, sql)
    if res.metrics["backend"] != backend:
        raise AssertionError(f"{name}: backend {res.metrics['backend']}")
    return {**line, "routes": res.metrics["routes"]}


def _say(**kv) -> None:
    print(json.dumps(kv), flush=True)


def _filter_agg(dev, card):
    # BASELINE configs 1 and 2, as chip_smoke._run_bench builds them
    from gpu_olap_tpu_torch import EngineConfig, TorchOlapEngine

    eng = TorchOlapEngine(EngineConfig(**BENCH_CFG), device=dev)
    rng = np.random.default_rng(0)
    fk = rng.integers(0, 1 << 20, cs.FILTER_ROWS).astype(np.int64)
    eng.register("t", {"k": fk, "v": rng.integers(0, 1000, cs.FILTER_ROWS)
                       .astype(np.int64)})
    del fk
    _say(**trace_query(eng, "filter_agg", "SELECT COUNT(*) AS n, SUM(v) AS s "
                       "FROM t WHERE v > 500", card))


def _groupby(dev, card):
    from gpu_olap_tpu_torch import EngineConfig, TorchOlapEngine

    eng = TorchOlapEngine(EngineConfig(**BENCH_CFG), device=dev)
    rng = np.random.default_rng(1)
    gk = rng.integers(0, cs.GROUPBY_GROUPS, cs.GROUPBY_ROWS).astype(np.int64)
    eng.register("t", {"k": gk, "v": rng.integers(0, 1_000_000,
                                                  cs.GROUPBY_ROWS)
                       .astype(np.int64)})
    del gk
    _say(**trace_query(eng, "groupby", "SELECT k, SUM(v) AS s, MIN(v) AS mn, "
                       "MAX(v) AS mx FROM t GROUP BY k", card))


JOIN_SQL = {
    "stream_join": "SELECT COUNT(*) AS n, SUM(l.v + r.w) AS s, "
                   "MIN(l.v - r.w) AS mn FROM l JOIN r ON l.k = r.k",
    "stream_join_grouped": "SELECT r.w AS g, COUNT(*) AS n, SUM(l.v) AS s "
                           "FROM l JOIN r ON l.k = r.k GROUP BY r.w",
    "join": "SELECT COUNT(*) AS n, SUM(l.k + r.k) AS s "
            "FROM l JOIN r ON l.k = r.k",
}


def _joins(dev, card, names):
    """The join queries ``names`` on one set of join tables, as
    chip_smoke._run_joins builds them."""
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
    for name in names:
        _say(**trace_query(eng, name, JOIN_SQL[name], card))


def _join_lookup(dev, card):
    nl, nr = cs.LOOKUP_ROWS
    eng = cs._join_engine(dev, 1.25)
    rng = np.random.default_rng(2)
    eng.register("l", {"k": rng.integers(0, nr, nl).astype(np.int64),
                       "v": rng.integers(0, 1000, nl).astype(np.int64)})
    eng.register("r", {"k": np.arange(nr, dtype=np.int64),
                       "w": rng.integers(0, 1000, nr).astype(np.int64)})
    _say(**trace_query(eng, "join_lookup", "SELECT COUNT(*) AS n, "
                       "SUM(l.v + r.w) AS s FROM l JOIN r ON l.k = r.k", card))


def _sortmerge(dev, card):
    n = cs.SORTMERGE_ROWS
    eng = cs._join_engine(dev, 2.5)
    rng = np.random.default_rng(3)
    eng.register("l", {"k": rng.integers(0, n // 4, n).astype(np.int64)})
    eng.register("r", {"k": rng.integers(0, n // 4, n).astype(np.int64)})
    _say(**trace_query(eng, "sortmerge",
                       "SELECT COUNT(*) AS n FROM l JOIN r ON l.k = r.k",
                       card))


def _dist_step(dev, card, zipf=False):
    """chip_smoke's config-5 step on the 8-shard logical mesh."""
    name = "dist_step_zipf" if zipf else "dist_step"
    step, args, _facts, _tables = cs._config5_step(dev, zipf=zipf)
    del _tables
    out, line = trace_run(name, lambda: step(*args), card,
                          "make_dist_join_groupby%s, 8 logical shards"
                          % ("_skew" if zipf else ""))
    if bool(out[3]):
        raise AssertionError(f"{name} overflowed")
    _say(**line, logical_mesh="8 shards on one card")


def _dist_join(dev, card, zipf=False):
    """chip_smoke's SQL join + GROUP BY on the logical mesh."""
    from gpu_olap_tpu_torch import EngineConfig, TorchOlapEngine

    eng = TorchOlapEngine(EngineConfig(
        mesh_shape=(cs.DIST_SHARDS,), join_expansion=16.0,
        enable_cache=False), device=dev, mesh_devices=[dev] * cs.DIST_SHARDS)
    _nk, lk, rk, lv, rv = cs._config5_data(cs.DIST_JOIN_ROWS, zipf)
    eng.register("l", {"k": lk, "v": lv})
    eng.register("r", {"k": rk, "v": rv})
    del lk, rk, lv, rv
    _say(**trace_query(eng, "dist_join_zipf" if zipf else "dist_join",
                       cs.DIST_JOIN_SQL, card,
                       backend="torch-distributed"),
         logical_mesh="8 shards on one card")


BENCH_CFG = dict(max_groups=1 << 23, min_shape_bucket=1 << 16,
                 enable_cache=False)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_trace: CUDA is not available", file=sys.stderr)
        return 1
    card = cs._card()
    dev = torch.device("cuda", 0)
    cells = {"filter_agg": _filter_agg, "groupby": _groupby,
             **{name: None for name in JOIN_SQL},
             "join_lookup": _join_lookup, "sortmerge": _sortmerge,
             "dist_step": _dist_step,
             "dist_step_zipf": functools.partial(_dist_step, zipf=True),
             "dist_join": _dist_join,
             "dist_join_zipf": functools.partial(_dist_join, zipf=True)}
    wanted = list(dict.fromkeys(sys.argv[1:] or cells))
    unknown = set(wanted) - set(cells)
    if unknown:
        print(f"chip_trace: unknown cells {sorted(unknown)}; choose from "
              f"{list(cells)}", file=sys.stderr)
        return 2
    print(card, flush=True)
    joins = [name for name in wanted if name in JOIN_SQL]
    for name in wanted:
        if name in JOIN_SQL:
            if name != joins[0]:
                continue  # the first join cell runs all of them
            _joins(dev, card, joins)
        else:
            cells[name](dev, card)
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
