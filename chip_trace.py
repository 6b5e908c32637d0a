"""Where the device time goes in the port's cells, on one NVIDIA GPU.

    python3 chip_trace.py [CELL ...]   # all cells: about 4 minutes on one H100

Runs the queries of ``chip_smoke.py`` on its tables (same sizes, seeds, SQL
and engine settings): filter_agg, groupby, stream_join, stream_join_grouped,
join, join_lookup and sortmerge on one device, then the distributed cells
on the smoke's 8-shard logical mesh: dist_step (BASELINE config 5's fused
step) and dist_join (the engine's SQL join + GROUP BY on 8M rows per side),
each with uniform keys and, as dist_step_zipf and dist_join_zipf, with
Zipf(1.5) probe keys; then scans: the join's run fills alone at 64K and
4M elements and the `join` merge length, PyTorch's ``cummax``/``cummin`` and
the run_scan kernel, each with its CUDA-event time and the grids a
profiled call shows.  Naming cells runs only those (a table feeding several runs
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
- ``top``: the device events grouped by name, largest first, each
  kernel with the grid and block of its first launch.

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

import bench_dist_torch
import bench_torch
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


def kernel_shapes(prof) -> dict:
    """Grid and block of each kernel in the trace, by name (the first
    launch of each), from the exported Chrome trace."""
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    shapes = {}
    for e in events:
        args = e.get("args") or {}
        if e.get("cat") == "kernel" and "grid" in args:
            shapes.setdefault(e.get("name"), {"grid": args["grid"],
                                              "block": args.get("block")})
    return shapes


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
    shapes = kernel_shapes(prof)
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
                          "share": v / 1e3 / busy_ms, **shapes.get(k, {})}
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
    eng = bench_torch.make_engine(dev, 2.2)
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
    eng = bench_torch.make_engine(dev, 1.25)
    rng = np.random.default_rng(2)
    eng.register("l", {"k": rng.integers(0, nr, nl).astype(np.int64),
                       "v": rng.integers(0, 1000, nl).astype(np.int64)})
    eng.register("r", {"k": np.arange(nr, dtype=np.int64),
                       "w": rng.integers(0, 1000, nr).astype(np.int64)})
    _say(**trace_query(eng, "join_lookup", "SELECT COUNT(*) AS n, "
                       "SUM(l.v + r.w) AS s FROM l JOIN r ON l.k = r.k", card))


def _sortmerge(dev, card):
    n = cs.SORTMERGE_ROWS
    eng = bench_torch.make_engine(dev, 2.5)
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
    _nk, lk, rk, lv, rv = bench_dist_torch.config5_data(cs.DIST_JOIN_ROWS,
                                                        zipf)
    eng.register("l", {"k": lk, "v": lv})
    eng.register("r", {"k": rk, "v": rv})
    del lk, rk, lv, rv
    _say(**trace_query(eng, "dist_join_zipf" if zipf else "dist_join",
                       cs.DIST_JOIN_SQL, card,
                       backend="torch-distributed"),
         logical_mesh="8 shards on one card")


def _scans(dev, card):
    """The join's run fills alone on chip_smoke's join-shaped seeds, at
    64K and 4M elements and at the `join` merge length: PyTorch's
    ``cummax`` and flipped ``cummin`` (the plain versions), then the
    run_scan kernel in both directions.  Per call: its CUDA-event time, its
    host wall over back-to-back calls, and one profiled call's
    device events, each kernel with its grid and block (a trace may hold
    none: the line says so rather than failing)."""
    from torch.profiler import ProfilerActivity, profile

    from gpu_olap_tpu_torch.ops.kernels import run_scan as rs

    starts, ends, _uniform = cs._run_scan_inputs(dev, 2 * cs.JOIN_ROWS)
    del _uniform
    for n in (1 << 16, 1 << 22, starts.shape[0]):
        for name, fn, x, reps in (
                ("torch_cummax", rs.cummax_plain, starts[:n], 3),
                ("torch_rev_cummin", rs.rev_cummin_plain, ends[-n:], 3),
                ("run_scan_cummax", rs.cummax_i32, starts[:n], 20),
                ("run_scan_rev_cummin", rs.rev_cummin_i32, ends[-n:], 20)):
            ms = cs._cuda_ms(lambda: fn(x), reps)
            # host clock over back-to-back calls: the launch overhead that
            # short scans (streamed chunks, mesh shards) pay
            t0 = time.perf_counter()
            for _ in range(reps):
                fn(x)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) / reps * 1e3
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                fn(x)
                torch.cuda.synchronize()
            by_name = device_events(prof)
            shapes = kernel_shapes(prof)
            _say(query=f"{name}_{n}", card=card, elements=n, ms=ms,
                 wall_ms_per_call=wall_ms,
                 device_events=len(by_name),
                 kernels=[{"name": k[:100], "ms": v / 1e3,
                           **shapes.get(k, {})}
                          for k, v in sorted(by_name.items(),
                                             key=lambda kv: -kv[1])],
                 grids_in_trace={k[:100]: v for k, v in shapes.items()})


BENCH_CFG = dict(max_groups=1 << 23, enable_cache=False)


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
             "dist_join_zipf": functools.partial(_dist_join, zipf=True),
             "scans": _scans}
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
