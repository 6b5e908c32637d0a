"""Benchmark harness of the PyTorch port: ``bench.py``'s BASELINE configs on
one NVIDIA GPU, every answer checked exactly against numpy.

    python3 bench_torch.py [--quick] [--scale F] [--only NAME] [--iters N]
                           [--device cuda|cuda:N|cpu]
    python3 bench_torch.py --micro

Configs, in run order, with ``bench.py``'s seeds, SQL, sizes and engine
settings (``max_groups=1 << 23``, the result cache off, the per-config
``join_expansion``; the port has no counterpart of ``min_shape_bucket``):

- ``join``: 100M x 100M rows, keys in [0, 50M) (BASELINE config 3);
- ``groupby``: 100M rows into 4M groups, SUM/MIN/MAX (config 2);
- ``filter_agg``: COUNT/SUM WHERE v > 500 over 200M rows (config 1);
- ``sortmerge``: 25M x 25M rows, keys in [0, 6.25M) (config 4);
- ``join_lookup``: 100M x 10M rows, unique build keys;
- ``groupby_1b``: the GROUP BY over 1B rows of a Parquet file, streamed
  through the device.  ``GPU_OLAP_1B_PARQUET`` names the file (written
  there when missing, read when present); without it the file goes to a
  temporary directory and is removed.

Each config runs in a child process of its own, so a CUDA fault ends only
that process.  The child makes its tables from the seed, runs the query
once to warm up (upload, kernel build) and ``--iters`` times more (the
1B-row GROUP BY once, cold, as ``bench.py`` runs it), and checks every
answer exactly against numpy.  On CUDA the backend must be ``torch-cuda``
(``torch-streaming*`` for ``groupby_1b``), the query must take the JAX
engine's route, and filter_agg and groupby must launch their kernels.

stdout is one JSON line, ``{"metric": "<label>_rows_per_sec", "value":
rows/s, "unit": "rows/s", "vs_baseline": value / the reference's published
rate}``, for the first config that ran in run order (best of ``--iters``;
rows count both sides of a join).  Details go to stderr and to
``bench_results_torch.json`` (``bench_results_torch_quick.json`` for
``--quick`` or ``--scale``), rewritten after every config: best and median
wall, the ``device_execute`` span (the device program up to its result
count) and its bytes, the scan and speed-of-light memory rates against the
card's rate (``utils.metrics``), kernel launches, routes and peak device
bytes.  A config that fails, times out or differs from numpy makes the run
exit 1 and print no line.  Without CUDA the script exits 2 unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time
from typing import Callable, Optional

import numpy as np

RESULT_SENTINEL = "##BENCH_TORCH_CHILD_RESULT##"

BASELINES = {
    # the reference's published GPU rates (BASELINE.md), rows/s
    "join": 62.5e6,          # inner join 100M x 100M (l + r rows / time)
    "join_lookup": 62.5e6,   # asymmetric unique-build lookup shape
    "groupby": 526e6,        # GROUP BY (reference: 1B rows)
    "groupby_1b": 526e6,     # the literal 1B-row streamed workload
    "filter_agg": 526e6,     # closest published analogue
    "sortmerge": 48.8e6,     # sort-merge join
}

HEADLINE_ORDER = ["join", "groupby", "filter_agg", "sortmerge", "join_lookup"]
CONFIG_ORDER = list(HEADLINE_ORDER) + ["groupby_1b"]
LABELS = {"join": "inner_join_100Mx100M", "groupby": "groupby_100M_4Mgrp",
          "filter_agg": "filter_agg_200M", "sortmerge": "sortmerge_25Mx25M",
          "join_lookup": "inner_join_lookup_100Mx10M",
          "groupby_1b": "groupby_1B_4Mgrp"}
KERNELS = ("filter_agg", "seg_agg", "stream_compact", "expand_fill",
           "radix_hist", "run_scan")
#: a child still running after this long is killed and its config fails
CHILD_TIMEOUT_S = 3300.0
#: rows per piece of the 1B-row Parquet file (bench.py:229)
PIECE_ROWS = 50_000_000

FILTER_SQL = "SELECT COUNT(*) AS n, SUM(v) AS s FROM t WHERE v > 500"
GROUPBY_SQL = ("SELECT k, SUM(v) AS s, MIN(v) AS mn, MAX(v) AS mx FROM t "
               "GROUP BY k")
# SUM over both sides forces the pairs' keys through the join
JOIN_SQL = ("SELECT COUNT(*) AS n, SUM(l.k + r.k) AS s FROM l JOIN r "
            "ON l.k = r.k")
LOOKUP_SQL = ("SELECT COUNT(*) AS n, SUM(l.v + r.w) AS s FROM l JOIN r "
              "ON l.k = r.k")
SORTMERGE_SQL = "SELECT COUNT(*) AS n FROM l JOIN r ON l.k = r.k"


def config_sizes(quick: bool, scale: float) -> dict:
    """Each config's size arguments (bench.py:561-575)."""
    if quick:
        return {"filter_agg": (1 << 20,), "groupby": (1 << 20, 1 << 14),
                "join": (1 << 20, 1 << 20), "join_lookup": (1 << 20, 1 << 17),
                "sortmerge": (1 << 19, 1 << 17),
                "groupby_1b": (1 << 22, 1 << 14)}
    s = scale
    return {"filter_agg": (int(200e6 * s),),
            "groupby": (int(100e6 * s), int(4e6 * s)),
            "join": (int(100e6 * s), int(100e6 * s)),
            "join_lookup": (int(100e6 * s), int(10e6 * s)),
            "sortmerge": (int(25e6 * s), int(25e6 * s)),
            "groupby_1b": (int(1e9 * s), int(4e6 * s))}


# ---------------------------------------------------------------------------
# the tables: bench.py's generator calls, in its order
# ---------------------------------------------------------------------------

def filter_agg_tables(n_rows: int) -> dict:
    rng = np.random.default_rng(0)
    return {"t": {"k": rng.integers(0, 1 << 20, n_rows).astype(np.int64),
                  "v": rng.integers(0, 1000, n_rows).astype(np.int64)}}


def groupby_tables(n_rows: int, n_groups: int) -> dict:
    rng = np.random.default_rng(1)
    return {"t": {"k": rng.integers(0, n_groups, n_rows).astype(np.int64),
                  "v": rng.integers(0, 1_000_000, n_rows).astype(np.int64)}}


def join_tables(n_left: int, n_right: int) -> dict:
    """About two rows a key on the build side: the general merge probe."""
    rng = np.random.default_rng(2)
    nkeys = max(n_right // 2, 1)
    lk = rng.integers(0, nkeys, n_left).astype(np.int64)
    rk = rng.integers(0, nkeys, n_right).astype(np.int64)
    return {"l": {"k": lk}, "r": {"k": rk}}


def join_lookup_tables(n_left: int, n_right: int) -> dict:
    rng = np.random.default_rng(2)
    lk = rng.integers(0, n_right, n_left).astype(np.int64)
    lv = rng.integers(0, 1000, n_left).astype(np.int64)
    rw = rng.integers(0, 1000, n_right).astype(np.int64)
    return {"l": {"k": lk, "v": lv},
            "r": {"k": np.arange(n_right, dtype=np.int64), "w": rw}}


def sortmerge_tables(n_left: int, n_right: int) -> dict:
    """About four rows a key on each side."""
    rng = np.random.default_rng(3)
    nkeys = max(n_right // 4, 1)
    lk = rng.integers(0, nkeys, n_left).astype(np.int64)
    rk = rng.integers(0, nkeys, n_right).astype(np.int64)
    return {"l": {"k": lk}, "r": {"k": rk}}


# ---------------------------------------------------------------------------
# the exact answers, from numpy (counts and one sort; no code of the port)
# ---------------------------------------------------------------------------

def filter_agg_expected(tables: dict) -> dict:
    v = tables["t"]["v"]
    m = v > 500
    return {"n": [int(m.sum())], "s": [int(v[m].sum())]}


def groupby_expected(tables: dict) -> dict:
    """Per key: SUM from ``np.bincount``, MIN and MAX from one sort of the
    (key, value) pairs packed into one int64 (values below 2^20)."""
    k, v = tables["t"]["k"], tables["t"]["v"]
    if k.min() < 0 or k.max() >= 1 << 42 or v.min() < 0 or v.max() >= 1 << 20:
        raise ValueError("groupby_expected packs keys below 2^42 and values "
                         "below 2^20")
    packed = np.sort((k << 20) | v)
    keys = packed >> 20
    vals = packed & ((1 << 20) - 1)
    starts = np.flatnonzero(np.concatenate([[True], keys[1:] != keys[:-1]]))
    ends = np.concatenate([starts[1:], [len(keys)]]) - 1
    # a key's sum stays below 2^53: exact in float64
    sums = np.bincount(k, weights=v).astype(np.int64)
    return {"k": keys[starts], "s": sums[keys[starts]], "mn": vals[starts],
            "mx": vals[ends]}


def _key_counts(lk, rk):
    n = int(max(lk.max(initial=0), rk.max(initial=0))) + 1
    return np.bincount(lk, minlength=n), np.bincount(rk, minlength=n)


def join_expected(tables: dict) -> dict:
    cl, cr = _key_counts(tables["l"]["k"], tables["r"]["k"])
    keys = np.arange(len(cl), dtype=np.int64)
    return {"n": [int((cl * cr).sum())],
            "s": [int((2 * keys * cl * cr).sum())]}


def join_lookup_expected(tables: dict) -> dict:
    lk, lv = tables["l"]["k"], tables["l"]["v"]
    rk, rw = tables["r"]["k"], tables["r"]["w"]
    _, cr = _key_counts(lk, rk)
    sw = np.bincount(rk, weights=rw, minlength=len(cr)).astype(np.int64)
    m = cr[lk]
    return {"n": [int(m.sum())], "s": [int((lv * m).sum() + sw[lk].sum())]}


def sortmerge_expected(tables: dict) -> dict:
    cl, cr = _key_counts(tables["l"]["k"], tables["r"]["k"])
    return {"n": [int((cl * cr).sum())]}


def check_answer(what: str, result, expected: dict) -> None:
    """``result`` (a ``QueryResult``) equals ``expected`` exactly: the same
    columns, a multi-row result sorted by its first column."""
    df = result.to_pandas()
    if list(df.columns) != list(expected):
        raise AssertionError(f"{what}: columns {list(df.columns)}, expected "
                             f"{list(expected)}")
    if len(df) > 1:
        df = df.sort_values(df.columns[0])
    for col, exp in expected.items():
        got = df[col].to_numpy()
        if got.shape != np.shape(exp) or not np.array_equal(got, exp):
            raise AssertionError(f"{what}: column {col} differs from numpy")


# ---------------------------------------------------------------------------
# the 1B-row Parquet table of groupby_1b
# ---------------------------------------------------------------------------

class GroupAccumulator:
    """Per key in [0, n_groups): COUNT and SUM with ``np.bincount``, MIN and
    MAX with ``scatter_reduce_`` on ``dev``, accumulated piece by piece
    (neither shares code with the port's sort-based path)."""

    def __init__(self, n_groups: int, dev):
        import torch

        self.cnt = np.zeros(n_groups, dtype=np.int64)
        self.tot = np.zeros(n_groups, dtype=np.int64)
        self._mn = torch.full((n_groups,), 1 << 62, dtype=torch.int64,
                              device=dev)
        self._mx = torch.full((n_groups,), -(1 << 62), dtype=torch.int64,
                              device=dev)

    def add(self, k: np.ndarray, v: np.ndarray) -> None:
        import torch

        g = len(self.cnt)
        if len(k) and (k.min() < 0 or k.max() >= g):
            raise ValueError(f"keys outside [0, {g})")
        self.cnt += np.bincount(k, minlength=g)
        # a piece's per-key sum stays below 2^53: exact in float64
        self.tot += np.bincount(k, weights=v, minlength=g).astype(np.int64)
        kt = torch.from_numpy(k).to(self._mn.device)
        vt = torch.from_numpy(v).to(self._mn.device)
        self._mn.scatter_reduce_(0, kt, vt, "amin")
        self._mx.scatter_reduce_(0, kt, vt, "amax")

    def minmax(self):
        return self._mn.cpu().numpy(), self._mx.cpu().numpy()

    def expected(self) -> dict:
        """The GROUP BY's answer: the keys that occur, in order."""
        keys = np.flatnonzero(self.cnt)
        mn, mx = self.minmax()
        return {"k": keys, "s": self.tot[keys], "mn": mn[keys], "mx": mx[keys]}


def write_fact(path: str, n_rows: int, n_groups: int, dev):
    """``bench.py``'s 1B-row table (``bench_groupby_1b``): ``k`` uniform in
    [0, n_groups), ``v`` uniform in [0, 1M), seed 42, ``PIECE_ROWS`` rows a
    piece.  Each piece goes to the file on a thread of its own while the
    next is made and counted (the writer releases the interpreter lock).
    Returns the accumulated answer and the generator, which callers may
    go on drawing from."""
    from concurrent.futures import ThreadPoolExecutor

    import pyarrow as pa
    import pyarrow.parquet as pq

    rng = np.random.default_rng(42)
    acc = GroupAccumulator(n_groups, dev)
    writer = None
    try:
        with ThreadPoolExecutor(max_workers=1) as pool:
            writing = None
            for lo in range(0, n_rows, PIECE_ROWS):
                m = min(PIECE_ROWS, n_rows - lo)
                k = rng.integers(0, n_groups, m)
                v = rng.integers(0, 1_000_000, m)
                t = pa.table({"k": k, "v": v})
                if writer is None:
                    writer = pq.ParquetWriter(path, t.schema)
                if writing is not None:
                    writing.result()  # pieces go to the file in order
                writing = pool.submit(writer.write_table, t)
                acc.add(k, v)
                del k, v, t
            if writing is not None:
                writing.result()
    finally:
        if writer is not None:
            writer.close()
    return acc, rng


def read_fact(path: str, n_groups: int, dev) -> GroupAccumulator:
    """The answer over an existing file, read back piece by piece."""
    import pyarrow.parquet as pq

    acc = GroupAccumulator(n_groups, dev)
    for batch in pq.ParquetFile(path).iter_batches(batch_size=PIECE_ROWS,
                                                   columns=["k", "v"]):
        acc.add(batch.column(0).to_numpy().astype(np.int64),
                batch.column(1).to_numpy().astype(np.int64))
    return acc


# ---------------------------------------------------------------------------
# one config (in the child process)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Config:
    """An in-memory config: its tables from the size arguments, SQL, exact
    answer, the route the JAX engine takes, its speed-of-light bytes model
    and, where it has one, the kernel that must launch on CUDA."""

    tables: Callable[..., dict]
    sql: str
    expected: Callable[[dict], dict]
    route: str
    sol_bytes: Callable[..., int]
    sol_model: str
    join_expansion: float = 1.25
    kernel: Optional[str] = None


_JOIN_ROUTE = "torch_sorted_global_join_agg"
CONFIGS = {
    "filter_agg": Config(
        filter_agg_tables, FILTER_SQL, filter_agg_expected,
        "torch_filter_agg_path", lambda n: n * 4,
        "4B/row: int32 shadow of v read once (value aliases the filter "
        "column)", kernel="filter_agg"),
    "groupby": Config(
        groupby_tables, GROUPBY_SQL, groupby_expected, "torch_seg_agg_path",
        lambda n, g: n * 8 + g * 24,
        "8B/row: int32 shadows of (k, v) read once + 24B/group written once",
        kernel="seg_agg"),
    # ~2 matches a probe row, plus headroom
    "join": Config(
        join_tables, JOIN_SQL, join_expected, _JOIN_ROUTE,
        lambda nl, nr: (nl + nr) * 4,
        "4B/row: int32 shadows of both key columns read once (COUNT/SUM "
        "answer needs no output materialization)", join_expansion=2.2),
    "join_lookup": Config(
        join_lookup_tables, LOOKUP_SQL, join_lookup_expected, _JOIN_ROUTE,
        lambda nl, nr: nl * 8 + nr * 8,
        "8B/row: (k, v) / (k, w) int32 shadows read once"),
    "sortmerge": Config(
        sortmerge_tables, SORTMERGE_SQL, sortmerge_expected, _JOIN_ROUTE,
        lambda nl, nr: (nl + nr) * 4,
        "4B/row: int32 shadows of both key columns read once",
        join_expansion=2.5),
}


def make_engine(device, join_expansion: float = 1.25, **settings):
    """``bench.py``'s engine settings (``bench.py:79-97``) on ``device``."""
    from gpu_olap_tpu_torch import EngineConfig, TorchOlapEngine

    return TorchOlapEngine(EngineConfig(
        backend="device", join_expansion=join_expansion, max_groups=1 << 23,
        enable_cache=False, **settings),
        device=device)


def _span():
    from gpu_olap_tpu_torch.utils.metrics import GLOBAL_METRICS

    st = GLOBAL_METRICS.ops.get("device_execute")
    return (st.seconds, st.bytes_accessed) if st else (0.0, 0)


def _time_query(eng, sql: str, iters: int, check) -> dict:
    """One warm-up run, then ``iters`` timed runs back to back
    (``bench.py:100-120``); every answer goes through ``check`` after the
    last run, so no check stands between two timed runs."""
    t0 = time.perf_counter()
    results = [eng.query(sql)]
    cold = time.perf_counter() - t0
    walls, execs, exec_bytes = [], [], 0
    for _ in range(iters):
        s0, b0 = _span()
        t0 = time.perf_counter()
        results.append(eng.query(sql))
        walls.append(time.perf_counter() - t0)
        s1, b1 = _span()
        # the device program up to its result count: no plan, no copy out
        execs.append(s1 - s0)
        exec_bytes = b1 - b0
    for r in results:
        check(r)
    r = results[-1]
    return {"seconds": min(walls), "seconds_median": float(np.median(walls)),
            "walls": walls, "cold_seconds": cold,
            "exec_seconds": min(execs),
            "exec_seconds_median": float(np.median(execs)),
            "exec_bytes": exec_bytes, "backend": r.metrics["backend"],
            "routes": r.metrics["routes"], "result_rows": r.num_rows}


def _roofline(res: dict, model_bytes: int, model: str) -> dict:
    """``bench.py:123-160``: table bytes and the speed-of-light bytes model
    over the device program's seconds, against the card's memory rate."""
    from gpu_olap_tpu_torch.utils.metrics import GLOBAL_METRICS

    rate = GLOBAL_METRICS.hbm_bandwidth("device_execute")
    ex, by = res["exec_seconds"], res["exec_bytes"]
    res["hbm_roofline_bytes_per_sec"] = rate
    if ex and by:
        res["scan_gbps"] = by / ex / 1e9
        res["scan_roofline_frac"] = by / ex / rate
    if ex and model_bytes:
        res["sol_model"] = model
        res["sol_gbps"] = model_bytes / ex / 1e9
        res["sol_frac"] = model_bytes / ex / rate
    if ex:
        res["rows_per_sec_device"] = res["rows"] / ex
    return res


def _need(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def _device_facts(dev) -> dict:
    import torch

    from gpu_olap_tpu_torch.ops.kernels import _build

    out = {"device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                      else str(dev)),
           "launches": {k: _build.launches.get(k, 0) for k in KERNELS}}
    if dev.type == "cuda":
        out["peak_device_bytes"] = torch.cuda.max_memory_allocated(dev)
    return out


def run_config(name: str, size, iters: int, device) -> dict:
    """Run one config in this process; raises if its answer differs from
    numpy or it left the device path."""
    from gpu_olap_tpu_torch.ops.kernels import _build
    from gpu_olap_tpu_torch.utils.torchenv import resolve_device

    dev = resolve_device(device)
    if name == "groupby_1b":
        return run_groupby_1b(*size, device=dev)
    cfg = CONFIGS[name]
    tables = cfg.tables(*size)
    expected = cfg.expected(tables)
    eng = make_engine(dev, cfg.join_expansion)
    for tname, cols in tables.items():
        eng.register(tname, cols)
    rows = sum(len(next(iter(cols.values()))) for cols in tables.values())
    del tables
    _build.launches.clear()
    res = {"rows": rows, **_time_query(
        eng, cfg.sql, iters, lambda r: check_answer(name, r, expected))}
    res["rows_per_sec"] = rows / res["seconds"]
    res["exact"] = True
    res.update(_device_facts(dev))
    _need(res["backend"] == f"torch-{dev.type}",
          f"{name}: backend {res['backend']}")
    _need(cfg.route in res["routes"],
          f"{name}: route {cfg.route} not taken ({res['routes']})")
    if dev.type == "cuda" and cfg.kernel:
        _need(res["launches"][cfg.kernel] > 0,
              f"{name}: {cfg.kernel} did not launch ({res['launches']})")
    return _roofline(res, cfg.sol_bytes(*size), cfg.sol_model)


def run_groupby_1b(n_rows: int, n_groups: int, device) -> dict:
    """The 1B-row GROUP BY (``bench.py:211-286``): out-of-core, streamed
    from Parquet through the device, one cold run."""
    from gpu_olap_tpu_torch import EngineConfig
    from gpu_olap_tpu_torch.ops.kernels import _build

    path = os.environ.get("GPU_OLAP_1B_PARQUET")
    tmp = None
    t0 = time.perf_counter()
    if path and os.path.exists(path):
        acc = read_fact(path, n_groups, device)
    else:
        if not path:
            tmp = tempfile.mkdtemp(prefix="bench_torch_1b_")
            path = os.path.join(tmp, "t.parquet")
        print(f"# writing {n_rows} rows to {path} ...", file=sys.stderr)
        acc, _ = write_fact(path, n_rows, n_groups, device)
    setup_s = time.perf_counter() - t0
    try:
        expected = acc.expected()
        rows = int(acc.cnt.sum())
        del acc
        # 2M-row chunks, two feed buffers, 1M-group state partitions; the
        # table streams at every size (cached below a quarter of its rows)
        eng = make_engine(
            device, batch_size=min(1 << 21, max(n_rows // 8, 1 << 20)),
            num_feed_buffers=2, stream_state_partition_groups=1 << 20,
            table_cache_threshold_rows=min(
                EngineConfig.table_cache_threshold_rows, max(n_rows // 4, 1)))
        eng.load_table("t", path)
        _need(not eng.catalog.is_cached("t"), "groupby_1b: the table was "
              "cached, not streamed")
        _build.launches.clear()
        t0 = time.perf_counter()
        r = eng.query(GROUPBY_SQL)
        dt = time.perf_counter() - t0
        check_answer("groupby_1b", r, expected)
        backend = r.metrics["backend"]
        _need(backend.startswith("torch-streaming"),
              f"groupby_1b: backend {backend}")
        sa = eng._get_device_executor()._streaming
        out = {"rows": rows, "seconds": dt, "seconds_median": dt,
               "walls": [dt], "rows_per_sec": rows / dt,
               "groups": r.num_rows, "backend": backend,
               "routes": r.metrics["routes"], "setup_seconds": setup_s,
               "hash_state_parts": sa.last_hash_parts,
               "stream_chunks": sa.last_stream_chunks,
               "h2d_bytes": sa.last_link_bytes,
               "stream_seconds": sa.last_stream_seconds,
               "host_split_seconds": sa.last_split_seconds,
               "step_interval_seconds": sa.last_step_interval_seconds,
               "exact": True}
        if sa.last_stream_seconds:
            # the streaming window: Parquet read, hash split, upload and
            # device steps; the result's copy out excluded
            out["rows_per_sec_stream"] = rows / sa.last_stream_seconds
        if sa.last_link_bytes:
            out["h2d_gbps_effective"] = sa.last_link_bytes / dt / 1e9
        out.update(_device_facts(device))
        return out
    finally:
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)


def bench_micro(iters: int = 2000) -> dict:
    """Frontend micro-benchmarks on the port's own parser and optimizer
    (``bench.py:361-384``): microseconds a call."""
    from gpu_olap_tpu_torch.plan.optimizer import optimize
    from gpu_olap_tpu_torch.sql.parser import parse_sql

    simple = "SELECT a, b, c FROM sales WHERE revenue > 1000"
    complex_join = ("SELECT o.id, c.name, sum(o.amount) FROM orders o "
                    "JOIN customers c ON o.cust_id = c.id "
                    "WHERE o.amount > 100 GROUP BY o.id, c.name "
                    "ORDER BY o.id LIMIT 50")
    out = {}
    for name, sql in [("parse_simple_select", simple),
                      ("parse_complex_join", complex_join)]:
        t0 = time.perf_counter()
        for _ in range(iters):
            parse_sql(sql)
        out[name] = (time.perf_counter() - t0) / iters * 1e6
    plan = parse_sql("SELECT a FROM t WHERE a > 10")
    t0 = time.perf_counter()
    for _ in range(iters):
        optimize(plan)
    out["optimize_simple"] = (time.perf_counter() - t0) / iters * 1e6
    return out


# ---------------------------------------------------------------------------
# the parent: one child process a config
# ---------------------------------------------------------------------------

def _kill_group(proc) -> None:
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except OSError:
        proc.kill()
    proc.wait()


def _run_child(name: str, args):
    """Run one config in a fresh process; returns (result or None, status).
    Its stderr passes through; the result rides a sentinel line on stdout.
    The child leads its own process group, so a timeout or the parent's
    exit kills everything it started."""
    cmd = [sys.executable, os.path.abspath(__file__), "--child", name,
           "--iters", str(args.iters), "--scale", str(args.scale),
           "--device", args.device] + (["--quick"] if args.quick else [])
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=CHILD_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        _kill_group(proc)
        return None, "timeout"
    except BaseException:  # interrupted: the child must not outlive us
        _kill_group(proc)
        raise
    if proc.returncode != 0:
        return None, f"exit_{proc.returncode}"
    for line in out.decode(errors="replace").splitlines():
        if line.startswith(RESULT_SENTINEL):
            return json.loads(line[len(RESULT_SENTINEL):]), "ok"
    return None, "no_result"


def card_name(device: str):
    """``nvidia-smi``'s name and power limit of the card, or None off CUDA
    or without ``nvidia-smi``."""
    import torch

    if torch.device(device).type != "cuda":
        return None
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None


def headline(results: dict, quick: bool) -> dict:
    """The one stdout line: the first config in run order that ran."""
    name = next(n for n in CONFIG_ORDER if n in results)
    res = results[name]
    label = LABELS[name] + ("_quick" if quick else "")
    return {"metric": f"{label}_rows_per_sec",
            "value": round(res["rows_per_sec"], 1), "unit": "rows/s",
            "vs_baseline": round(res["rows_per_sec"] / BASELINES[name], 4)}


def _exit_on_signal(signum, _frame):
    sys.exit(128 + signum)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="BASELINE configs on the port")
    ap.add_argument("--quick", action="store_true", help="small sizes")
    ap.add_argument("--micro", action="store_true",
                    help="parse/optimize micro-benches only")
    ap.add_argument("--iters", type=int, default=3,
                    help="timed runs a config, after one warm-up")
    ap.add_argument("--scale", type=float, default=1.0,
                    help="scale factor on row counts")
    ap.add_argument("--only", choices=CONFIG_ORDER,
                    help="run one config (still in its own process)")
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda, cuda:N or cpu")
    ap.add_argument("--child", choices=CONFIG_ORDER, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.iters < 1:
        ap.error("--iters must be at least 1")

    if args.micro:
        micro = bench_micro()
        for k, v in micro.items():
            print(f"# {k}: {v:.3f} us", file=sys.stderr)
        print(json.dumps({"metric": "parse_simple_select_us",
                          "value": round(micro["parse_simple_select"], 3),
                          "unit": "us", "vs_baseline": 1.0}))
        return 0

    from gpu_olap_tpu_torch.utils.torchenv import resolve_device

    try:
        resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        print(f"bench_torch: {e}; pass --device cpu to run on the CPU",
              file=sys.stderr)
        return 2

    if args.child:
        size = config_sizes(args.quick, args.scale)[args.child]
        res = run_config(args.child, size, args.iters, args.device)
        print(RESULT_SENTINEL + json.dumps(res, default=str), flush=True)
        return 0

    signal.signal(signal.SIGTERM, _exit_on_signal)
    t0 = time.time()
    plan = [args.only] if args.only else list(CONFIG_ORDER)
    out_path = ("bench_results_torch_quick.json"
                if args.quick or args.scale != 1.0
                else "bench_results_torch.json")
    results, statuses = {}, {}
    card = card_name(args.device)
    for name in plan:
        res, status = _run_child(name, args)
        statuses[name] = status
        if res is None:
            print(f"# {name} FAILED: {status}", file=sys.stderr)
        else:
            res["vs_baseline"] = res["rows_per_sec"] / BASELINES[name]
            results[name] = res
            print(f"# {name}: {json.dumps(res)}", file=sys.stderr)
        with open(out_path, "w") as f:
            json.dump({"card": card, "device": args.device,
                       "total_seconds": time.time() - t0,
                       "scale": args.scale, "quick": args.quick,
                       "iters": args.iters, "statuses": statuses,
                       "results": results}, f, indent=2, default=str)
    print(f"# full results -> {out_path}", file=sys.stderr)
    failed = sorted(n for n, s in statuses.items() if s != "ok")
    if failed:
        print(f"# failed: {failed}", file=sys.stderr)
        return 1
    print(json.dumps(headline(results, args.quick)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
