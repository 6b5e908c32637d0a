"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py      # about 2.5 to 3 minutes on one H100

Phases, each printing one JSON line:

1. environment: the card (``nvidia-smi``), torch and CUDA versions; exits
   non-zero without CUDA;
2. build: compiles the CUDA kernels from ``gpu_olap_tpu_torch/csrc``;
3. kernels_edge_cases: each kernel (filter_agg, seg_agg, stream_compact,
   expand_fill) against its plain PyTorch version, exactly, on edge cases;
4. kernels_main_shapes: filter_agg and seg_agg against their plain versions
   at the bench shapes (200M rows; 100M rows x 4M groups), with both times;
5. engine_bench: ``TorchOlapEngine(device="cuda")`` runs the filter and
   GROUP BY bench queries (exact against numpy, launch counts > 0);
6. engine_join: the join path at full width, each query exact against
   numpy on the route the JAX engine takes: a materializing stream join
   and a GROUP BY over its pairs (100M x 100M), then the three bench joins
   (join 100M x 100M, join_lookup 100M x 10M, sortmerge 25M x 25M);
   stream_compact and expand_fill must launch;
7. kernels_join_shapes: stream_compact and expand_fill against their plain
   versions on the inputs the stream join gave them, with both times;
8. engine_vs_oracle: small single-table, join and UNION ALL queries against
   the CPU oracle;
9. dist_step (uniform, then Zipf): BASELINE config 5's distributed join +
   group-by step (``bench_dist.py``'s data and capacity planning, through
   ``partition_histogram`` and so the radix_hist kernel) on a mesh of eight
   logical shards on the card, 2^22 rows per shard per side, exact against
   numpy with no overflow;
10. kernels_dist_shapes: radix_hist against its plain version on 200M keys
    at shifts 0, 8, 16 and 24 and on the step's partition ids (8 and 1
    shards), with both times;
11. engine_distributed: ``TorchOlapEngine`` with ``mesh_shape=(8,)`` on the
    same logical mesh: the distributed query corpus on 1M rows against the
    CPU oracle, then a config-5 SQL join + GROUP BY on 8M rows per side
    (uniform, then Zipf keys on the skew-broadcast route), exact against
    numpy.

The eight shards on one card measure the distributed code path, not
scaling.  The line before the last is a JSON object with one entry per
kernel; the last line is ``{"ok": true, "device": {...}}``.  Any failure
raises.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from contextlib import contextmanager

import numpy as np
import torch

I32_MIN, I32_MAX = -(1 << 31), (1 << 31) - 1

# BASELINE configs 1 and 2 (bench.py:163-208) at their full size
FILTER_ROWS = 200_000_000
GROUPBY_ROWS = 100_000_000
GROUPBY_GROUPS = 4_000_000
# bench.py's join configs (bench.py:289-358) at their full size
# (bench.py:571-573); the stream-join queries use the `join` tables
JOIN_ROWS = 100_000_000            # join: l and r
JOIN_KEYS = JOIN_ROWS // 2
LOOKUP_ROWS = (100_000_000, 10_000_000)
SORTMERGE_ROWS = 25_000_000
# warm runs per bench query; the engine line reports their median
REPS = 11
# BASELINE config 5 (bench_dist.py): 8 logical shards on the card, 2^22 rows
# per shard per side; the engine's distributed corpus and SQL join sizes
DIST_SHARDS = 8
DIST_ROWS_PER_SHARD = 1 << 22
DIST_REPS = 5
DIST_CORPUS_ROWS = 1 << 20
DIST_JOIN_ROWS = 1 << 23
RADIX_ROWS = 200_000_000


def _say(phase: str, **kv) -> None:
    print(json.dumps({"phase": phase, **kv}), flush=True)


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()


def _cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` on the current stream (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _max_abs_err(a, b) -> int:
    """Largest |a - b| over tensors or nested tuples/lists of tensors."""
    if isinstance(a, (tuple, list)):
        return max((_max_abs_err(x, y) for x, y in zip(a, b)), default=0)
    if a.shape != b.shape or a.dtype != b.dtype:
        raise AssertionError(f"shape/dtype differ: {a.shape} {a.dtype} vs "
                             f"{b.shape} {b.dtype}")
    if a.numel() == 0:
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


# ---------------------------------------------------------------------------
# kernels against their plain versions
# ---------------------------------------------------------------------------

def _filter_agg_cases(dev):
    """(name, filt, op, thr, cols, n_valid, wants): edge cases of the TPU
    kernel's tests plus no-match, alias, mid-block cuts and int32 extremes."""
    g = np.random.default_rng(100)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(dev)

    v = t(g.integers(0, 1000, 100_000))
    big = t(g.integers(0, 1 << 30, 70_000))
    ext = t(np.concatenate([np.full(3000, I32_MAX), np.full(3000, I32_MIN),
                            g.integers(I32_MIN, I32_MAX, 30_001,
                                       endpoint=True)]))
    w = t(g.integers(-50, 50, 100_000))
    cases = [("n_valid_cut", v, "gt", 500, (v,), 100_000 - 5000, None),
             ("exact_2p30", big, "gt", 1 << 29, (big,), None, None),
             ("no_match", v, "gt", 5000, (v, w), None, None),
             ("alias_and_other", v, "le", 350, (v, w), None, None),
             ("n_valid_mid_block", w, "ne", 0, (w, v), 12_345, None),
             ("int32_extremes", ext, "ge", I32_MIN, (ext,), None, None),
             ("wants_dropped", v, "lt", 700, (v, w),
              None, ((True, False), (False, True))),
             ("odd_offset_view", w[1:], "gt", -10, (v[1:],), None, None)]
    for op in ("gt", "ge", "lt", "le", "eq", "ne"):
        cases.append((f"op_{op}", v, op, 500, (v, w), None, None))
    return cases


def _seg_agg_cases(dev):
    """(name, keys_sorted, vals_sorted, max_groups): the TPU kernel's test
    cases plus one group spanning everything."""
    g = np.random.default_rng(200)

    def co_sort(keys, vals):
        order = np.lexsort((vals, keys))
        return keys[order].astype(np.int32), vals[order].astype(np.int32)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    cases = []
    n = 2048
    k, v = co_sort(np.sort(g.integers(0, n // 16, n)),
                   g.integers(-1_000_000, 1_000_000, n))
    cases.append(("basic_runs", k, v, 200))
    n = 3 * 4096 + 77
    k = np.empty(n, np.int64)
    half = n // 2 + 1000
    k[:half] = 7
    k[half:] = 100 + np.arange(n - half) // 3
    cases.append(("group_across_tiles", *co_sort(k, np.arange(n) % 4096),
                  n))
    n = 10_000
    cases.append(("group_every_row", (np.arange(n) * 3 - n).astype(np.int32),
                  np.full(n, -5, np.int32), n + 4))
    n, n_valid = 16_384, 16_384 - 12_345
    k, v = co_sort(g.integers(0, 500, n_valid), g.integers(0, 1000, n_valid))
    k = np.concatenate([k, np.full(n - n_valid, I32_MAX, np.int32)])
    v = np.concatenate([v, np.zeros(n - n_valid, np.int32)])
    cases.append(("sentinel_tail", k, v, 600))
    n = 20_000
    cases.append(("overflow_max_groups_64", np.arange(n, dtype=np.int32),
                  np.ones(n, np.int32), 64))
    sizes = g.integers(1, 9, 9000)
    k = np.repeat(np.arange(len(sizes)) * 7 - 100, sizes)
    cases.append(("many_groups", *co_sort(k, g.integers(-(1 << 30), 1 << 30,
                                                        len(k))), 9010))
    n = 8 * 2048
    k = np.empty(n, np.int64)
    k[:2047] = np.arange(2047)
    k[2047:6 * 2048] = 2047
    k[6 * 2048:] = 2048 + np.arange(n - 6 * 2048) // 5
    vals = np.full(n, I32_MAX, np.int64)
    vals[::3] = I32_MIN
    cases.append(("giant_group_extremes", *co_sort(k, vals), n))
    n = 50_001
    cases.append(("one_group", np.full(n, -3, np.int32),
                  np.sort(g.integers(I32_MIN, I32_MAX, n)).astype(np.int32),
                  4))
    for trial in range(4):
        n = int(g.integers(1, 40_000))
        ng = int(g.integers(1, n + 1))
        keys = np.sort(g.integers(-(1 << 28), 1 << 28, ng))[g.integers(0, ng, n)]
        cases.append((f"fuzz_{trial}", *co_sort(
            keys, g.integers(I32_MIN, I32_MAX, n, endpoint=True)), n + 8))
    return [(name, t(k), t(v), mg) for name, k, v, mg in cases]


def _compact_cases(dev):
    """(name, mask, streams, cap): the TPU kernel's test cases (random mask
    with int32 extremes, all, none, alternating, count past cap) plus ragged
    tiles, more streams than one launch carries and a single element."""
    g = np.random.default_rng(300)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    cases = []
    n = 6 * 2048 + 123
    mask = g.random(n) < 0.3
    a = g.integers(I32_MIN, I32_MAX, n, endpoint=True).astype(np.int32)
    b = g.integers(I32_MIN, I32_MAX, n, endpoint=True).astype(np.int32)
    cases.append(("random_extremes", t(mask), [t(a), t(b)],
                  int(mask.sum()) + 8))
    n = 4 * 4096
    a = np.arange(n, dtype=np.int32)
    cases.append(("all_set", t(np.ones(n, bool)), [t(a)], n))
    cases.append(("none_set", t(np.zeros(n, bool)), [t(a)], 16))
    cases.append(("alternating", t(np.arange(n) % 2 == 0), [t(a), t(-a)],
                  n // 2))
    mask = g.random(n) < 0.6
    cases.append(("count_over_cap", t(mask), [t(a), t(a * 3)],
                  int(mask.sum()) // 2))
    n = 1_000_003
    cases.append(("eleven_streams", t(g.random(n) < 0.45),
                  [t(g.integers(-9, 9, n).astype(np.int32))
                   for _ in range(11)], n))
    cases.append(("one_element", t(np.ones(1, bool)), [t(a[:1])], 1))
    return cases


def _expand_cases(dev):
    """(name, starts, streams, cap): the TPU kernel's test cases (run
    lengths 1-5, runs spanning many blocks, one giant run) plus no live
    record, a first record past slot 0, pad records and eleven streams."""
    g = np.random.default_rng(400)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def case(name, cnts, first=0, n_pad=37, nstr=2, extra=1000):
        starts = (first + np.concatenate([[0], np.cumsum(cnts)[:-1]])
                  ).astype(np.int32) if len(cnts) else np.zeros(0, np.int32)
        m = len(starts) + n_pad
        starts = np.concatenate([starts, np.full(n_pad, I32_MAX, np.int32)])
        streams = [t(g.integers(I32_MIN, I32_MAX, m, endpoint=True)
                     .astype(np.int32)) for _ in range(nstr)]
        return (name, t(starts), streams, first + int(np.sum(cnts)) + extra)

    return [case("run_lengths_1_5", g.integers(1, 6, 3000)),
            case("long_runs_block_spans",
                 np.array([5000, 1, 1, 7000, 2048, 2, 4096])),
            case("one_giant_run", np.array([3 * 2048 + 17])),
            case("no_records", np.zeros(0, np.int64)),
            case("late_first_start", g.integers(1, 40, 5000), first=100),
            case("eleven_streams", g.integers(1, 9, 20_000), nstr=11),
            case("many_blocks", g.integers(1, 300, 200_000), n_pad=0,
                 extra=0)]


def _radix_cases(dev):
    """(name, keys): the TPU kernel's test shapes (a length off its
    16384-key block, negative keys) plus empty, one key, one bin and the
    int32 extremes."""
    g = np.random.default_rng(500)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(dev)

    rand = g.integers(I32_MIN, I32_MAX, 100_003, endpoint=True)
    return [("n_0", t(rand[:0])), ("n_1", t(rand[:1])),
            ("n_16383", t(rand[:16383])), ("n_16385", t(rand[:16385])),
            ("one_bin", t(np.full(70_001, 0x5A5A5A5A))),
            ("negative", t(-np.abs(rand) - 1)),
            ("extremes", t(np.concatenate([np.full(999, I32_MIN),
                                           np.full(1001, I32_MAX), rand]))),
            ("unaligned_view", t(rand)[3:])]


def _check_kernels(dev):
    from gpu_olap_tpu_torch.ops.kernels import join_stream as js
    from gpu_olap_tpu_torch.ops.kernels import partition as rp
    from gpu_olap_tpu_torch.ops.kernels.filter_agg import (
        filter_agg_i32, filter_agg_plain)
    from gpu_olap_tpu_torch.ops.kernels.seg_agg import (
        seg_agg_plain, seg_agg_sorted_i32)
    from gpu_olap_tpu_torch.ops.sort import lexsort

    for name, f, op, thr, cols, n_valid, wants in _filter_agg_cases(dev):
        got = filter_agg_i32(f, op, thr, cols, n_valid, wants)
        exp = filter_agg_plain(f, op, thr, cols, n_valid, wants)
        err = _max_abs_err(got, exp)
        torch.cuda.synchronize()
        if err:
            raise AssertionError(f"filter_agg case {name}: max |err| {err}")
    for name, k, v, mg in _seg_agg_cases(dev):
        got = seg_agg_sorted_i32(k, v, mg)
        exp = seg_agg_plain(k, v, mg)
        err = _max_abs_err(got, exp)
        torch.cuda.synchronize()
        if err:
            raise AssertionError(f"seg_agg case {name}: max |err| {err}")
    compact_cases = _compact_cases(dev)
    for name, mask, streams, cap in compact_cases:
        got = js.stream_compact_i32(mask, streams, cap)
        exp = js.stream_compact_plain(mask, streams, cap)
        err = _max_abs_err(got, exp)
        torch.cuda.synchronize()
        if err:
            raise AssertionError(f"stream_compact case {name}: max |err| "
                                 f"{err}")
    expand_cases = _expand_cases(dev)
    for name, starts, streams, cap in expand_cases:
        got = js.expand_fill_i32(starts, streams, cap)
        exp = js.expand_fill_plain(starts, streams, cap)
        err = _max_abs_err(got, exp)
        torch.cuda.synchronize()
        if err:
            raise AssertionError(f"expand_fill case {name}: max |err| {err}")
    radix_cases = _radix_cases(dev)
    for name, keys in radix_cases:
        for shift in (0, 8, 16, 24, 31):
            got = rp.radix_histogram_i32(keys, shift)
            exp = rp.radix_histogram_plain(keys, shift)
            err = _max_abs_err(got, exp)
            torch.cuda.synchronize()
            if err:
                raise AssertionError(f"radix_hist case {name} shift {shift}: "
                                     f"max |err| {err}")
    _say("kernels_edge_cases", filter_agg=len(_filter_agg_cases(dev)),
         seg_agg=len(_seg_agg_cases(dev)),
         stream_compact=len(compact_cases), expand_fill=len(expand_cases),
         radix_hist=5 * len(radix_cases), exact=True)
    del compact_cases, expand_cases, radix_cases

    gen = torch.Generator(device=dev).manual_seed(0)
    v = torch.randint(0, 1000, (FILTER_ROWS,), generator=gen, device=dev,
                      dtype=torch.int32)
    got = filter_agg_i32(v, "gt", 500, (v,))
    exp = filter_agg_plain(v, "gt", 500, (v,))
    fa_err = _max_abs_err(got, exp)
    torch.cuda.synchronize()
    fa_ms = _cuda_ms(lambda: filter_agg_i32(v, "gt", 500, (v,)), 20)
    fa_plain_ms = _cuda_ms(lambda: filter_agg_plain(v, "gt", 500, (v,)), 5)
    del v

    gen = torch.Generator(device=dev).manual_seed(1)
    k = torch.randint(0, GROUPBY_GROUPS, (GROUPBY_ROWS,), generator=gen,
                      device=dev, dtype=torch.int32)
    val = torch.randint(0, 1_000_000, (GROUPBY_ROWS,), generator=gen,
                        device=dev, dtype=torch.int32)
    sk, sv = lexsort([k, val], 2)
    del k, val
    mg = 1 << 23
    got = seg_agg_sorted_i32(sk, sv, mg)
    exp = seg_agg_plain(sk, sv, mg)
    sa_err = _max_abs_err(got, exp)
    n_groups = int(got[5])
    del got, exp
    torch.cuda.synchronize()
    sa_ms = _cuda_ms(lambda: seg_agg_sorted_i32(sk, sv, mg), 10)
    sa_plain_ms = _cuda_ms(lambda: seg_agg_plain(sk, sv, mg), 3)
    del sk, sv
    torch.cuda.synchronize()
    if fa_err or sa_err:
        raise AssertionError(f"kernel != plain at main-path shapes: "
                             f"filter_agg {fa_err}, seg_agg {sa_err}")
    _say("kernels_main_shapes", filter_agg_rows=FILTER_ROWS,
         filter_agg_ms=fa_ms, filter_agg_plain_ms=fa_plain_ms,
         seg_agg_rows=GROUPBY_ROWS, seg_agg_groups=n_groups,
         seg_agg_ms=sa_ms, seg_agg_plain_ms=sa_plain_ms)
    return {"filter_agg": (fa_err, fa_ms, fa_plain_ms),
            "seg_agg": (sa_err, sa_ms, sa_plain_ms)}


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def _canon(df):
    cols = list(df.columns)
    return df.sort_values(cols).reset_index(drop=True) if cols else df


def _same_frame(got, exp, what: str) -> None:
    if list(got.columns) != list(exp.columns) or len(got) != len(exp):
        raise AssertionError(f"{what}: shape {got.shape} vs {exp.shape}")
    for c in got.columns:
        g, e = got[c].to_numpy(), exp[c].to_numpy()
        if g.dtype.kind == "f" or e.dtype.kind == "f":
            # float aggregates are summed in another order: rtol 1e-12
            ok = np.allclose(g.astype(float), e.astype(float), rtol=1e-12,
                             atol=0, equal_nan=True)
        else:
            ok = np.array_equal(g, e)
        if not ok:
            raise AssertionError(f"{what}: column {c} differs")


def _timed_query(eng, sql: str, rows: int) -> dict:
    """Warm runs of ``sql``: wall seconds (median, min, max) and the median
    split from the engine's own timers: plan, the ``device_execute`` span
    (interpreter run up to the result count) and the rest of execution
    (the copy of the result to the host)."""
    walls, plans, devs, rests = [], [], [], []
    for _ in range(REPS):
        st = eng.metrics.ops.get("device_execute")
        s0 = st.seconds if st else 0.0
        t0 = time.perf_counter()
        r = eng.query(sql)
        walls.append(time.perf_counter() - t0)
        dev_s = eng.metrics.ops["device_execute"].seconds - s0
        plans.append(r.metrics["plan_seconds"])
        devs.append(dev_s)
        rests.append(r.metrics["exec_seconds"] - dev_s)
    wall = float(np.median(walls))
    dev_s = float(np.median(devs))
    return {"rows": rows, "runs": REPS, "wall_median_s": wall,
            "wall_min_s": min(walls), "wall_max_s": max(walls),
            "plan_median_s": float(np.median(plans)),
            "device_execute_median_s": dev_s,
            "host_transfer_median_s": float(np.median(rests)),
            "rows_per_s": rows / wall, "device_rows_per_s": rows / dev_s}


def _run_bench(dev, card: str):
    """The filter and GROUP BY bench queries (BASELINE configs 1 and 2)."""
    from gpu_olap_tpu_torch import EngineConfig, TorchOlapEngine
    from gpu_olap_tpu_torch.ops.kernels import _build

    # the settings and SQL of bench.py's configs 1 and 2, one engine each
    cfg = dict(max_groups=1 << 23, min_shape_bucket=1 << 16,
               enable_cache=False)
    fa_eng = TorchOlapEngine(EngineConfig(**cfg), device=dev)
    rng = np.random.default_rng(0)
    fk = rng.integers(0, 1 << 20, FILTER_ROWS).astype(np.int64)
    fv = rng.integers(0, 1000, FILTER_ROWS).astype(np.int64)
    fa_eng.register("t", {"k": fk, "v": fv})
    del fk
    gb_eng = TorchOlapEngine(EngineConfig(**cfg), device=dev)
    rng = np.random.default_rng(1)
    gk = rng.integers(0, GROUPBY_GROUPS, GROUPBY_ROWS).astype(np.int64)
    gv = rng.integers(0, 1_000_000, GROUPBY_ROWS).astype(np.int64)
    gb_eng.register("t", {"k": gk, "v": gv})
    fa_sql = "SELECT COUNT(*) AS n, SUM(v) AS s FROM t WHERE v > 500"
    gb_sql = "SELECT k, SUM(v) AS s, MIN(v) AS mn, MAX(v) AS mx FROM t GROUP BY k"

    # the main path: launch counts from this run only
    _build.launches.clear()
    t0 = time.perf_counter()
    fa_res = fa_eng.query(fa_sql)
    gb_res = gb_eng.query(gb_sql)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    launches = {k: _build.launches[k] for k in ("filter_agg", "seg_agg")}
    for r in (fa_res, gb_res):
        if r.metrics["backend"] != "torch-cuda":
            raise AssertionError(f"backend {r.metrics['backend']}")
    if not all(launches.values()):
        raise AssertionError(f"a kernel of the path did not launch: {launches}")

    # exact numpy references
    m = fv > 500
    got = fa_res.to_pydict()
    if (int(got["n"][0]), int(got["s"][0])) != (int(m.sum()),
                                                int(fv[m].sum())):
        raise AssertionError("filter_agg query result differs from numpy")
    del m
    packed = (gk << 20) | gv  # v < 2^20: (k, v) order in one int64
    packed.sort()
    keys = packed >> 20
    vals = packed & ((1 << 20) - 1)
    starts = np.flatnonzero(np.concatenate([[True], keys[1:] != keys[:-1]]))
    ends = np.concatenate([starts[1:], [len(keys)]]) - 1
    exp_s = np.bincount(gk, weights=gv)  # exact below 2^53
    present = np.bincount(gk) > 0
    del packed, gk
    out = gb_res.to_pandas().sort_values("k").reset_index(drop=True)
    ok = (np.array_equal(out["k"].to_numpy(), keys[starts])
          and np.array_equal(out["s"].to_numpy(),
                             exp_s[present].astype(np.int64))
          and np.array_equal(out["mn"].to_numpy(), vals[starts])
          and np.array_equal(out["mx"].to_numpy(), vals[ends]))
    if not ok:
        raise AssertionError("groupby query result differs from numpy")
    n_groups = len(starts)
    del keys, vals, starts, ends, exp_s, present

    _say("engine_bench", card=card, cold_seconds_both=cold_s,
         filter_agg=_timed_query(fa_eng, fa_sql, FILTER_ROWS),
         groupby={"groups": n_groups,
                  **_timed_query(gb_eng, gb_sql, GROUPBY_ROWS)},
         peak_device_bytes=torch.cuda.max_memory_allocated(),
         launches=launches, exact=True)
    del fa_eng, gb_eng, fa_res, gb_res, fv, gv
    torch.cuda.empty_cache()
    return launches


@contextmanager
def _first_call_args(module, name: str, store: dict):
    """Keep the arguments of the first call of ``module.name`` in
    ``store[name]``: the inputs the main path gives a kernel."""
    orig = getattr(module, name)

    def keep(*args):
        store.setdefault(name, args)
        return orig(*args)

    setattr(module, name, keep)
    try:
        yield
    finally:
        setattr(module, name, orig)


def _check_join_kernels(args: dict):
    """stream_compact and expand_fill against their plain versions on the
    inputs the stream join gave them: exact, with both times."""
    from gpu_olap_tpu_torch.ops.kernels import join_stream as js

    out = {}
    mask, streams, cap = args["stream_compact_i32"]
    got = js.stream_compact_i32(mask, streams, cap)
    exp = js.stream_compact_plain(mask, streams, cap)
    err = _max_abs_err(got, exp)
    n_rec = int(got[1])
    del got, exp
    torch.cuda.synchronize()
    out["stream_compact"] = (
        err, _cuda_ms(lambda: js.stream_compact_i32(mask, streams, cap), 10),
        _cuda_ms(lambda: js.stream_compact_plain(mask, streams, cap), 3))
    shapes = {"stream_compact_elements": mask.shape[0],
              "stream_compact_streams": len(streams),
              "stream_compact_cap": cap, "records": n_rec}
    del mask, streams

    starts, streams, cap = args["expand_fill_i32"]
    got = js.expand_fill_i32(starts, streams, cap)
    exp = js.expand_fill_plain(starts, streams, cap)
    err = _max_abs_err(got, exp)
    del got, exp
    torch.cuda.synchronize()
    out["expand_fill"] = (
        err, _cuda_ms(lambda: js.expand_fill_i32(starts, streams, cap), 10),
        _cuda_ms(lambda: js.expand_fill_plain(starts, streams, cap), 3))
    shapes.update(expand_fill_records=starts.shape[0],
                  expand_fill_streams=len(streams), expand_fill_slots=cap)
    del starts, streams
    torch.cuda.synchronize()
    if out["stream_compact"][0] or out["expand_fill"][0]:
        raise AssertionError(f"kernel != plain at the join's shapes: {out}")
    _say("kernels_join_shapes", **shapes,
         **{f"{k}_{f}": v[i] for k, v in out.items()
            for i, f in ((1, "ms"), (2, "plain_ms"))})
    return out


def _join_engine(dev, expansion: float):
    from gpu_olap_tpu_torch import EngineConfig, TorchOlapEngine

    # bench.py's _engine settings
    return TorchOlapEngine(EngineConfig(
        join_expansion=expansion, max_groups=1 << 23,
        min_shape_bucket=1 << 16, enable_cache=False), device=dev)


def _routed(eng, sql: str, route: str):
    """One run of ``sql`` that must take the device route ``route`` (the
    route the JAX engine takes for it) on the card."""
    res = eng.query(sql)
    torch.cuda.synchronize()
    if route not in res.metrics["routes"]:
        raise AssertionError(f"{sql}: route {route} not taken "
                             f"({res.metrics['routes']})")
    if res.metrics["backend"] != "torch-cuda":
        raise AssertionError(f"{sql}: backend {res.metrics['backend']}")
    return res


def _exact(what: str, got: dict, exp: dict) -> None:
    for k, v in exp.items():
        g = np.asarray(got[k])
        if g.shape != np.shape(v) or not np.array_equal(g, v):
            raise AssertionError(f"{what}: column {k} differs from numpy")


def _per_query(eng, sql, rows, route, extra=None) -> dict:
    torch.cuda.reset_peak_memory_stats()
    stats = _timed_query(eng, sql, rows)
    return {"route": route, **(extra or {}), **stats,
            "peak_device_bytes": torch.cuda.max_memory_allocated()}


def _run_joins(dev, card: str):
    """The join path at full width: five queries, each exact against numpy
    on the route the JAX engine takes."""
    from gpu_olap_tpu_torch.ops.kernels import _build
    from gpu_olap_tpu_torch.ops.kernels import join_stream as js

    stream_r = "torch_join_stream_path"
    sorted_r = "torch_sorted_global_join_agg"
    queries = {}

    # -- the `join` tables (bench_join, seed 2) with value columns ---------
    eng = _join_engine(dev, 2.2)
    rng = np.random.default_rng(2)
    lk = rng.integers(0, JOIN_KEYS, JOIN_ROWS).astype(np.int64)
    rk = rng.integers(0, JOIN_KEYS, JOIN_ROWS).astype(np.int64)
    lv = rng.integers(0, 1000, JOIN_ROWS).astype(np.int64)
    rw = rng.integers(0, 1000, JOIN_ROWS).astype(np.int64)
    eng.register("l", {"k": lk, "v": lv})
    eng.register("r", {"k": rk, "w": rw})
    stream_sql = ("SELECT COUNT(*) AS n, SUM(l.v + r.w) AS s, "
                  "MIN(l.v - r.w) AS mn FROM l JOIN r ON l.k = r.k")
    grouped_sql = ("SELECT r.w AS g, COUNT(*) AS n, SUM(l.v) AS s "
                   "FROM l JOIN r ON l.k = r.k GROUP BY r.w")
    join_sql = ("SELECT COUNT(*) AS n, SUM(l.k + r.k) AS s "
                "FROM l JOIN r ON l.k = r.k")

    # first run: uploads the tables and keeps the kernels' inputs
    args = {}
    t0 = time.perf_counter()
    with _first_call_args(js, "stream_compact_i32", args), \
            _first_call_args(js, "expand_fill_i32", args):
        _routed(eng, stream_sql, stream_r)
    setup_s = time.perf_counter() - t0
    kern = _check_join_kernels(args)
    del args

    # the main path: launch counts from these runs only
    _build.launches.clear()
    t0 = time.perf_counter()
    res = {sql: _routed(eng, sql, route) for sql, route in
           ((stream_sql, stream_r), (grouped_sql, stream_r),
            (join_sql, sorted_r))}
    cold_s = time.perf_counter() - t0
    launches = {k: _build.launches[k]
                for k in ("stream_compact", "expand_fill")}
    if not all(launches.values()):
        raise AssertionError(f"a kernel of the path did not launch: {launches}")

    # exact numpy references from per-key counts and sums
    cl = np.bincount(lk, minlength=JOIN_KEYS)
    cr = np.bincount(rk, minlength=JOIN_KEYS)
    suml = np.bincount(lk, weights=lv, minlength=JOIN_KEYS).astype(np.int64)
    sumw = np.bincount(rk, weights=rw, minlength=JOIN_KEYS).astype(np.int64)
    minl = np.full(JOIN_KEYS, 1 << 40)
    np.minimum.at(minl, lk, lv)
    maxw = np.full(JOIN_KEYS, -(1 << 40))
    np.maximum.at(maxw, rk, rw)
    both = (cl > 0) & (cr > 0)
    n_pairs = int((cl * cr).sum())
    _exact(stream_sql, res[stream_sql].to_pydict(), {
        "n": [n_pairs], "s": [int((cr * suml + cl * sumw).sum())],
        "mn": [int((minl - maxw)[both].min())]})
    del minl, maxw, both
    ng = np.bincount(rw, weights=cl[rk], minlength=1000).astype(np.int64)
    sg = np.bincount(rw, weights=suml[rk], minlength=1000).astype(np.int64)
    present = np.flatnonzero(ng > 0)
    out = res[grouped_sql].to_pandas().sort_values("g")
    _exact(grouped_sql, {c: out[c].to_numpy() for c in out.columns},
           {"g": present, "n": ng[present], "s": sg[present]})
    keys = np.arange(JOIN_KEYS, dtype=np.int64)
    _exact(join_sql, res[join_sql].to_pydict(), {
        "n": [n_pairs], "s": [int((2 * keys * cl * cr).sum())]})
    del res, cl, cr, suml, sumw, ng, sg, keys, lk, rk, lv, rw
    both_rows = 2 * JOIN_ROWS
    queries["stream_join"] = _per_query(eng, stream_sql, both_rows, stream_r,
                                        {"matches": n_pairs})
    queries["stream_join_grouped"] = _per_query(
        eng, grouped_sql, both_rows, stream_r,
        {"matches": n_pairs, "groups": int(len(present))})
    queries["join"] = _per_query(eng, join_sql, both_rows, sorted_r,
                                 {"matches": n_pairs})
    del eng
    torch.cuda.empty_cache()

    # -- join_lookup: unique build keys (bench_join_lookup, seed 2) ---------
    nl, nr = LOOKUP_ROWS
    eng = _join_engine(dev, 1.25)
    rng = np.random.default_rng(2)
    lk = rng.integers(0, nr, nl).astype(np.int64)
    lv = rng.integers(0, 1000, nl).astype(np.int64)
    rw = rng.integers(0, 1000, nr).astype(np.int64)
    eng.register("l", {"k": lk, "v": lv})
    eng.register("r", {"k": np.arange(nr, dtype=np.int64), "w": rw})
    sql = "SELECT COUNT(*) AS n, SUM(l.v + r.w) AS s FROM l JOIN r ON l.k = r.k"
    _exact(sql, _routed(eng, sql, sorted_r).to_pydict(), {
        "n": [nl], "s": [int(lv.sum() + rw[lk].sum())]})
    del lk, lv, rw
    queries["join_lookup"] = _per_query(eng, sql, nl + nr, sorted_r,
                                        {"matches": nl})
    del eng
    torch.cuda.empty_cache()

    # -- sortmerge: ~4 duplicates per key (bench_sortmerge, seed 3) ---------
    n = SORTMERGE_ROWS
    nkeys = n // 4
    eng = _join_engine(dev, 2.5)
    rng = np.random.default_rng(3)
    lk = rng.integers(0, nkeys, n).astype(np.int64)
    rk = rng.integers(0, nkeys, n).astype(np.int64)
    eng.register("l", {"k": lk})
    eng.register("r", {"k": rk})
    sql = "SELECT COUNT(*) AS n FROM l JOIN r ON l.k = r.k"
    n_pairs = int((np.bincount(lk, minlength=nkeys)
                   * np.bincount(rk, minlength=nkeys)).sum())
    _exact(sql, _routed(eng, sql, sorted_r).to_pydict(), {"n": [n_pairs]})
    del lk, rk
    queries["sortmerge"] = _per_query(eng, sql, 2 * n, sorted_r,
                                      {"matches": n_pairs})
    del eng
    torch.cuda.empty_cache()

    _say("engine_join", card=card, setup_seconds_join_tables=setup_s,
         cold_seconds_join_tables=cold_s, queries=queries,
         launches=launches, exact=True)
    return launches, kern


def _run_oracle(dev):
    """Small single-table and join queries against the CPU oracle."""
    from gpu_olap_tpu_torch import EngineConfig, TorchOlapEngine

    small = TorchOlapEngine(EngineConfig(enable_cache=False), device=dev)
    oracle = TorchOlapEngine(EngineConfig(backend="cpu", enable_cache=False),
                             device="cpu")
    oracle.catalog = small.catalog
    g = np.random.default_rng(2)
    n = 200_000
    small.register("t", {"k": np.arange(n) % 7, "v": np.arange(n, dtype=float)})
    small.register("s", {"a": g.integers(-40, 40, n), "b": g.integers(0, 9, n),
                         "c": g.integers(-1000, 1000, n),
                         "r": g.choice(["EU", "US", "APAC"], n)})
    # join tables: duplicate keys on both sides, partial overlap, nulls, a
    # unique key (lookup join) and string keys with different dictionaries
    lt_v = g.normal(0, 10, 3000)
    lt_v[g.random(3000) < 0.1] = np.nan
    small.register("lt", {"k": g.integers(0, 300, 3000),
                          "g": g.integers(0, 3, 3000), "v": lt_v,
                          "tag": g.choice(["x", "y", "z"], 3000)})
    small.register("rt", {"k": g.integers(100, 400, 2000),
                          "g": g.integers(0, 3, 2000),
                          "w": g.integers(0, 1000, 2000),
                          "tag": g.choice(["y", "z", "q"], 2000)})
    small.register("cust", {"id": np.arange(-40, 260),
                            "name": np.array([f"c{i:03d}" for i in range(300)]),
                            "region": g.choice(["EU", "US", "APAC"], 300)})
    queries = [
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
    for q in queries:
        r = small.query(q)
        if r.metrics["backend"] != "torch-cuda":
            raise AssertionError(f"{q}: backend {r.metrics['backend']}")
        ordered = "ORDER BY" in q
        got = r.to_pandas()
        exp = oracle.query(q).to_pandas()
        if not ordered:
            got, exp = _canon(got), _canon(exp)
        _same_frame(got, exp, q)
    torch.cuda.synchronize()
    _say("engine_vs_oracle", queries=len(queries), equal=True)


# ---------------------------------------------------------------------------
# the distributed path: BASELINE config 5 on a logical mesh
# ---------------------------------------------------------------------------

def _config5_data(n: int, zipf: bool):
    """``bench_dist.py``'s tables (seed 0, ``n_keys = n // 16``): probe keys
    uniform or Zipf(1.5), build keys uniform, values in [1, 100)."""
    rng = np.random.default_rng(0)
    n_keys = max(n // 16, 64)
    if zipf:
        # a=1.5: the hot key carries ~38 % of the probe rows
        lk = np.clip(rng.zipf(1.5, n).astype(np.int64), 1, n_keys) - 1
    else:
        lk = rng.integers(0, n_keys, n).astype(np.int64)
    rk = rng.integers(0, n_keys, n).astype(np.int64)
    lv = rng.integers(1, 100, n).astype(np.int64)
    rv = rng.integers(1, 100, n).astype(np.int64)
    return n_keys, lk, rk, lv, rv


def _per_key_join(n_keys, lk, rk, lv, rv):
    """Per join key: COUNT(*) and SUM(l.v * r.v) of the inner join, from
    each side's per-key counts and sums (exact in int64)."""
    cl = np.bincount(lk, minlength=n_keys)
    cr = np.bincount(rk, minlength=n_keys)
    sl = np.bincount(lk, weights=lv, minlength=n_keys).astype(np.int64)
    sr = np.bincount(rk, weights=rv, minlength=n_keys).astype(np.int64)
    return cl * cr, sl * sr


def _config5_step(dev, zipf: bool):
    """BASELINE config 5 on the logical mesh: ``bench_dist.py``'s tables
    and its capacity planning (``bench_dist.py:55-81``, through
    ``partition_histogram`` on the card, so radix_hist).  Returns (step,
    per-shard args, plan facts, host tables)."""
    from gpu_olap_tpu_torch.parallel import dist_ops, skew
    from gpu_olap_tpu_torch.parallel.mesh import make_mesh, shard_rows

    ndev, per = DIST_SHARDS, DIST_ROWS_PER_SHARD
    n = ndev * per
    tables = _config5_data(n, zipf)
    n_keys, lk, rk, lv, rv = tables
    mesh = make_mesh(ndev, [dev] * ndev)
    heavy = np.zeros(0, dtype=np.int64)
    rk_d = torch.from_numpy(rk).to(dev)
    if zipf:
        heavy = skew.detect_heavy_keys(lk, row_threshold=max(256, per // 4))
        lk_d = torch.from_numpy(lk[~np.isin(lk, heavy)]).to(dev)
    else:
        lk_d = torch.from_numpy(lk).to(dev)
    hist = skew.partition_histogram(lk_d, ndev).cpu().numpy()
    rhist = skew.partition_histogram(rk_d, ndev).cpu().numpy()
    del lk_d, rk_d
    capacity = max(
        skew.recommend_capacity(hist, ndev, headroom=1.6 if zipf else 1.3),
        skew.recommend_capacity(rhist, ndev, headroom=1.3))
    join_capacity = per * (32 if zipf else 24)
    max_groups = min(n_keys, 1 << 20)
    if heavy.size:
        heavy_build_cap = max(256, 4 * max(n // n_keys, 1) * int(heavy.size))
        step = dist_ops.make_dist_join_groupby_skew(
            mesh, capacity=capacity, join_capacity=join_capacity,
            max_groups=max_groups, agg_funcs=("sum", "count"),
            heavy_keys=heavy, heavy_build_cap=heavy_build_cap)
    else:
        step = dist_ops.make_dist_join_groupby(
            mesh, capacity=capacity, join_capacity=join_capacity,
            max_groups=max_groups, agg_funcs=("sum", "count"))
    valid = shard_rows(mesh, np.ones(n, bool), False)
    args = (shard_rows(mesh, lk), valid, shard_rows(mesh, lv),
            shard_rows(mesh, rk), valid, shard_rows(mesh, rv))
    facts = {"capacity": capacity, "join_capacity": join_capacity,
             "heavy_keys": int(heavy.size),
             "heavy_probe_share": float(np.isin(lk, heavy).mean())}
    return step, args, facts, tables


def _dist_step_case(dev, zipf: bool):
    """One config-5 step: planning, the fused step on the mesh, an exact
    per-key check against numpy, warm timing and peak memory."""
    ndev, per = DIST_SHARDS, DIST_ROWS_PER_SHARD
    n = ndev * per
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    step, args, facts, (n_keys, lk, rk, lv, rv) = _config5_step(dev, zipf)
    input_bytes = torch.cuda.memory_allocated() - mem0
    plan_s = time.perf_counter() - t0
    capacity, join_capacity = facts["capacity"], facts["join_capacity"]

    gkeys, (sums, counts), gvalid, overflow = step(*args)
    if bool(overflow):
        raise AssertionError(f"config-5 step overflowed (zipf={zipf}, "
                             f"capacity={capacity}, join={join_capacity})")
    got_n = np.zeros(n_keys, np.int64)
    got_s = np.zeros(n_keys, np.int64)
    for k, sm, c, v in zip(gkeys, sums, counts, gvalid):
        v = v.cpu().numpy()
        # a heavy key's groups sit on several shards: merge them
        np.add.at(got_n, k.cpu().numpy()[v], c.cpu().numpy()[v])
        np.add.at(got_s, k.cpu().numpy()[v], sm.cpu().numpy()[v])
    exp_n, exp_s = _per_key_join(n_keys, lk, rk, lv, rv)
    if not (np.array_equal(got_n, exp_n) and np.array_equal(got_s, exp_s)):
        raise AssertionError(f"config-5 step differs from numpy (zipf={zipf})")
    del gkeys, sums, counts, gvalid
    walls = []
    for _ in range(DIST_REPS):
        t1 = time.perf_counter()
        out = step(*args)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t1)
        if bool(out[3]):
            raise AssertionError("config-5 step overflowed on a warm run")
        del out
    peak = torch.cuda.max_memory_allocated() - mem0
    # reckoning: the inputs, send and receive blocks of both sides' shuffle
    # (key, value, valid), and one shard's match buffer with its int64
    # expansion temporaries (about 48 B a slot)
    shuffle_bytes = 2 * 2 * ndev * ndev * capacity * 17
    reckoned = input_bytes + shuffle_bytes + join_capacity * 48
    wall = float(np.median(walls))
    return {"zipf": zipf, "shards": ndev, "rows_per_shard_per_side": per,
            "rows_both_sides": 2 * n, "matches": int(exp_n.sum()),
            "groups": int((exp_n > 0).sum()), **facts,
            "setup_seconds": plan_s, "wall_median_s": wall,
            "wall_min_s": min(walls), "wall_max_s": max(walls),
            "runs": DIST_REPS, "rows_per_s": 2 * n / wall,
            "peak_device_bytes": peak, "input_bytes": input_bytes,
            "reckoned_peak_bytes": reckoned,
            "peak_over_reckoning": peak / reckoned,
            "overflow": False, "exact": True}, lk


def _run_dist_step(dev, card: str):
    """BASELINE config 5 at full single-card width, uniform then Zipf; the
    radix_hist launches of the capacity planning are the path's."""
    from gpu_olap_tpu_torch.ops.kernels import _build

    _build.launches.clear()
    uniform, lk = _dist_step_case(dev, zipf=False)
    torch.cuda.empty_cache()
    zipf, _ = _dist_step_case(dev, zipf=True)
    launches = {"radix_hist": _build.launches["radix_hist"]}
    if not launches["radix_hist"]:
        raise AssertionError("radix_hist did not launch on the dist path")
    for case in (uniform, zipf):
        if case["peak_device_bytes"] > 70e9:
            raise AssertionError(f"dist step peak {case['peak_device_bytes']}"
                                 " B: halve DIST_ROWS_PER_SHARD")
    _say("dist_step", card=card, logical_mesh="8 shards on one card: the "
         "code path, not scaling", uniform=uniform, zipf=zipf,
         launches=launches)
    torch.cuda.empty_cache()
    return launches, lk


def _check_dist_kernels(dev, lk: np.ndarray):
    """radix_hist against its plain version at 200M keys (shifts 0, 8, 16,
    24) and on the step's partition ids for 8 and 1 shards."""
    from gpu_olap_tpu_torch.ops.hashing import partition_of
    from gpu_olap_tpu_torch.ops.kernels import partition as rp

    out = {}
    gen = torch.Generator(device=dev).manual_seed(5)
    keys = torch.randint(I32_MIN, I32_MAX, (RADIX_ROWS,), generator=gen,
                         device=dev, dtype=torch.int32)
    err = 0
    for shift in (0, 8, 16, 24):
        err = max(err, _max_abs_err(rp.radix_histogram_i32(keys, shift),
                                    rp.radix_histogram_plain(keys, shift)))
        out[f"keys_200m_shift{shift}_ms"] = _cuda_ms(
            lambda: rp.radix_histogram_i32(keys, shift), 10)
        out[f"keys_200m_shift{shift}_plain_ms"] = _cuda_ms(
            lambda: rp.radix_histogram_plain(keys, shift), 5)
    del keys
    lk_d = torch.from_numpy(lk).to(dev)
    main = None
    for ndev in (DIST_SHARDS, 1):
        dest = partition_of(lk_d, ndev)
        err = max(err, _max_abs_err(rp.radix_histogram_i32(dest, 0),
                                    rp.radix_histogram_plain(dest, 0)))
        ms = _cuda_ms(lambda: rp.radix_histogram_i32(dest, 0), 10)
        plain_ms = _cuda_ms(lambda: rp.radix_histogram_plain(dest, 0), 5)
        out[f"config5_ndev{ndev}_ms"] = ms
        out[f"config5_ndev{ndev}_plain_ms"] = plain_ms
        if main is None:
            main = (ms, plain_ms)
        del dest
    del lk_d
    torch.cuda.synchronize()
    if err:
        raise AssertionError(f"radix_hist != plain at the dist shapes: {err}")
    _say("kernels_dist_shapes", radix_rows=RADIX_ROWS,
         config5_keys=int(lk.shape[0]), **out, exact=True)
    return {"radix_hist": (err, *main)}


# the distributed corpus of tests/test_dist_executor.py and its top-k queries
DIST_CORPUS = [
    "SELECT k, COUNT(*) AS n, SUM(v) AS s FROM t GROUP BY k",
    "SELECT k, SUM(v) AS s, MIN(v) AS mn, MAX(f) AS mx, AVG(f) AS a "
    "FROM t GROUP BY k",
    "SELECT k, SUM(v) AS s FROM t WHERE v > 100 GROUP BY k",
    "SELECT k, SUM(v * 2 + 1) AS s FROM t WHERE year = 2024 GROUP BY k",
    "SELECT COUNT(*) AS n, SUM(v) AS s FROM t WHERE v > 500",
    "SELECT k, SUM(v) AS s FROM t GROUP BY k HAVING s > 5000 "
    "ORDER BY s DESC LIMIT 20",
    "SELECT year, k, COUNT(*) AS n FROM t GROUP BY year, k",
    "SELECT k, COUNT(DISTINCT year) AS d, SUM(v) AS s FROM t GROUP BY k",
    "SELECT year, COUNT(DISTINCT k) AS d, SUM(DISTINCT v) AS sd FROM t "
    "GROUP BY year",
    "SELECT COUNT(DISTINCT k) AS d FROM t",
    "SELECT COUNT(DISTINCT k) AS d, SUM(DISTINCT k) AS sd FROM t WHERE v > 200",
    "SELECT v FROM t ORDER BY v DESC LIMIT 3",
    "SELECT k, v FROM t WHERE v > 100 ORDER BY v ASC, k DESC LIMIT 7",
    "SELECT f FROM t ORDER BY f DESC LIMIT 5 OFFSET 2",
]


# BASELINE config 5 as SQL: the join + GROUP BY of the step
DIST_JOIN_SQL = ("SELECT l.k, SUM(l.v * r.v) AS s, COUNT(*) AS n FROM l "
                 "JOIN r ON l.k = r.k GROUP BY l.k")


def _run_engine_distributed(dev, card: str):
    """``TorchOlapEngine`` with an 8-shard mesh on the card: the corpus
    against the oracle, then a config-5 SQL join + GROUP BY, uniform and
    Zipf, exact against numpy.  Prints the kernel launches of the run:
    the engine plans its shuffles on the host, so radix_hist is not among
    them."""
    from gpu_olap_tpu_torch import EngineConfig, TorchOlapEngine
    from gpu_olap_tpu_torch.ops.kernels import _build

    mesh = [dev] * DIST_SHARDS
    eng = TorchOlapEngine(EngineConfig(
        mesh_shape=(DIST_SHARDS,), join_expansion=16.0, enable_cache=False),
        device=dev, mesh_devices=mesh)
    oracle = TorchOlapEngine(EngineConfig(backend="cpu", enable_cache=False),
                             device="cpu")
    oracle.catalog = eng.catalog
    rng = np.random.default_rng(11)
    n = DIST_CORPUS_ROWS
    eng.register("t", {"k": rng.integers(0, 500, n).astype(np.int64),
                       "v": rng.integers(-50, 1000, n).astype(np.int64),
                       "f": rng.normal(10.0, 5.0, n),
                       "year": rng.integers(2020, 2026, n).astype(np.int64)})
    _build.launches.clear()
    t0 = time.perf_counter()
    routes = set()
    for q in DIST_CORPUS:
        r = eng.query(q)
        if r.metrics["backend"] != "torch-distributed":
            raise AssertionError(f"{q}: backend {r.metrics['backend']}")
        routes.update(r.metrics["routes"])
        got, exp = r.to_pandas(), oracle.query(q).to_pandas()
        if "ORDER BY" not in q:
            got, exp = _canon(got), _canon(exp)
        _same_frame(got, exp, q)
    torch.cuda.synchronize()
    corpus_s = time.perf_counter() - t0
    eng.drop_table("t")

    sql = DIST_JOIN_SQL
    joins = {}
    for zipf in (False, True):
        n_keys, lk, rk, lv, rv = _config5_data(DIST_JOIN_ROWS, zipf)
        eng.register("l", {"k": lk, "v": lv})
        eng.register("r", {"k": rk, "v": rv})
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = eng.query(sql)
        torch.cuda.synchronize()
        cold = time.perf_counter() - t0
        want = ["torch_dist_join"] + (["torch_dist_skew_broadcast"]
                                      if zipf else [])
        if res.metrics["backend"] != "torch-distributed" or \
                not set(want) <= set(res.metrics["routes"]):
            raise AssertionError(f"join zipf={zipf}: {res.metrics}")
        exp_n, exp_s = _per_key_join(n_keys, lk, rk, lv, rv)
        keys = np.flatnonzero(exp_n)
        out = res.to_pandas().sort_values("k")
        _exact(f"{sql} (zipf={zipf})",
               {c: out[c].to_numpy() for c in out.columns},
               {"k": keys, "s": exp_s[keys], "n": exp_n[keys]})
        walls = []
        for _ in range(3):
            t1 = time.perf_counter()
            eng.query(sql)
            walls.append(time.perf_counter() - t1)
        wall = float(np.median(walls))
        joins["zipf" if zipf else "uniform"] = {
            "rows_per_side": DIST_JOIN_ROWS, "matches": int(exp_n.sum()),
            "groups": int(len(keys)), "routes": res.metrics["routes"],
            "cold_seconds": cold, "wall_median_s": wall,
            "wall_min_s": min(walls), "wall_max_s": max(walls),
            "rows_per_s": 2 * DIST_JOIN_ROWS / wall,
            "peak_device_bytes": torch.cuda.max_memory_allocated()}
        eng.drop_table("l")
        eng.drop_table("r")
        del lk, rk, lv, rv, res
    _say("engine_distributed", card=card, logical_mesh="8 shards on one "
         "card: the code path, not scaling", corpus_queries=len(DIST_CORPUS),
         corpus_rows=DIST_CORPUS_ROWS, corpus_seconds=corpus_s,
         corpus_routes=sorted(routes), joins=joins,
         launches=dict(_build.launches), equal=True)
    del eng, oracle
    torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    card = _card()
    dev = torch.device("cuda", 0)
    print(card, flush=True)
    _say("environment", card=card, torch=torch.__version__,
         cuda=torch.version.cuda, device_count=torch.cuda.device_count())

    from gpu_olap_tpu_torch.ops.kernels import _build

    t0 = time.perf_counter()
    _build.load()
    _say("build", seconds=time.perf_counter() - t0,
         nvcc_seconds=_build.build_seconds, library=_build.library_path())

    kern = _check_kernels(dev)
    launches = _run_bench(dev, card)
    join_launches, join_kern = _run_joins(dev, card)
    kern.update(join_kern)
    launches.update(join_launches)
    _run_oracle(dev)
    dist_launches, lk = _run_dist_step(dev, card)
    launches.update(dist_launches)
    kern.update(_check_dist_kernels(dev, lk))
    del lk
    _run_engine_distributed(dev, card)
    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")

    replaces = {"filter_agg": "gpu_olap_tpu/ops/pallas/filter_agg.py:104",
                "seg_agg": "gpu_olap_tpu/ops/pallas/seg_agg.py:84",
                "stream_compact": "gpu_olap_tpu/ops/pallas/join_stream.py:52",
                "expand_fill": "gpu_olap_tpu/ops/pallas/join_stream.py:174",
                "radix_hist": "gpu_olap_tpu/ops/pallas/partition.py:25"}
    kernels = []
    for name in ("filter_agg", "seg_agg", "stream_compact", "expand_fill",
                 "radix_hist"):
        err, ms, plain_ms = kern[name]
        kernels.append({"name": name, "route": "cuda",
                        "source": f"gpu_olap_tpu_torch/csrc/{name}.cu",
                        "replaces": replaces[name],
                        "launches": launches[name], "max_abs_err": err,
                        "ms": ms, "plain_ms": plain_ms})
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
