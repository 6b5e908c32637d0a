"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py                      # about 12 minutes, one H100
    python3 chip_smoke.py --only multiprocess  # the build and phase 11 alone

Phases, each printing one JSON line:

1. environment: the card (``nvidia-smi``), torch and CUDA versions; exits
   non-zero without CUDA;
2. build: compiles the CUDA kernels from ``gpu_olap_tpu_torch/csrc``;
   ptxas: each kernel's registers and spill bytes;
3. kernels_edge_cases: each kernel (filter_agg, seg_agg, stream_compact,
   expand_fill, radix_hist) against its plain PyTorch version, exactly, on
   edge cases (seg_agg: groups over many tiles, one group of 3M rows with a
   sum past 2^31, a group per row, ragged and one-row inputs, max_groups
   below the group count, negative values, the INT32_MAX sentinel group,
   an unaligned view; filter_agg: every operator, 0 to 8 value columns,
   aliased and repeated columns, unaligned views, n_valid cuts, no match,
   ``wants`` masks, 5M rows over many blocks; radix_hist: one bin over
   four counter flushes of a full wave, every thread's counter at the flush
   limit in all 256 bins, views at offsets 1-3 of lengths 1-7, each case
   twice on one stream and once on a second stream);
4. kernels_main_shapes: filter_agg and seg_agg against their plain versions
   at the bench shapes (200M rows; 100M rows x 4M groups), with both times
   and the bound;
5. engine_bench: ``TorchOlapEngine(device="cuda")`` runs the filter and
   GROUP BY bench queries (exact against numpy, launch counts > 0);
6. engine_join: the join path at full width, each query exact against
   numpy on the route the JAX engine takes: a materializing stream join
   and a GROUP BY over its pairs (100M x 100M), then the three bench joins
   (join 100M x 100M, join_lookup 100M x 10M, sortmerge 25M x 25M);
   stream_compact and expand_fill must launch;
7. kernels_join_shapes: stream_compact and expand_fill against their plain
   versions on the inputs the stream join gave them, with both times, the
   bound and one PyTorch call for the same function (``x[:, mask]`` and
   ``repeat_interleave`` on the stacked streams);
8. engine_vs_oracle: small single-table, join and UNION ALL queries against
   the CPU oracle;
9. dist_step (uniform, then Zipf): BASELINE config 5's distributed join +
   group-by step (``bench_dist.py``'s data and capacity planning, through
   ``partition_histogram`` and so the radix_hist kernel) on a mesh of eight
   logical shards on the card, 2^22 rows per shard per side, exact against
   numpy with no overflow;
10. kernels_dist_shapes: radix_hist against its plain version on 200M keys
    at shifts 0, 8, 16 and 24 and on the step's partition ids (8 and 1
    shards), with both times, the bound and ``torch.bincount``'s;
11. multiprocess: config 5 again, through ``dist_ops`` over an NCCL process
    group, one rank per card (W = the card count, or its largest divisor
    of 8), the 8 shards split 8 / W to a rank; each rank is this script
    started with ``--rank`` and joins through a file store in a temporary
    directory; every rank makes the same global tables, plans with B5 over
    its own rows summed by ``psum`` (each summed histogram must equal a
    host count of every rank's rows, and the capacity the single-process
    plan's), runs the step on its shards; rank 0 gathers
    every shard's groups and checks them exact against numpy; per rank:
    warm walls, the shuffle and local stages, the bytes sent to other
    ranks, the step's all-to-all alone, peak device bytes and B5
    launches.  A rank that fails or outlives 300 s fails the phase, with
    every rank killed;
12. engine_distributed: ``TorchOlapEngine`` with ``mesh_shape=(8,)`` on the
    same logical mesh: the distributed query corpus on 1M rows against the
    CPU oracle, then a config-5 SQL join + GROUP BY on 8M rows per side
    (uniform, then Zipf keys on the skew-broadcast route), exact against
    numpy;
13. engine_streaming, one line per query: out-of-core execution through
    ``TorchOlapEngine(device="cuda")`` from Parquet files written to a
    temporary directory (removed at the end): bench.py's 1B-row table
    (``k`` in [0, 4M), ``v`` in [0, 1M), seed 42) and its GROUP BY into 4M
    groups, twice, on the hash-partitioned streamed state; a streamed join
    of those rows against a cached 4M-row dimension table; a grace join of
    two 20M-row files through spill partitions; a COUNT(DISTINCT) that
    cannot stream and loads its table whole.  Each is exact against numpy
    on its backend label; each line gives the wall, rows/s, the streamer's
    chunks, host-to-device bytes and rate, stream seconds, host split
    seconds, summed step intervals on the device (CUDA events read once;
    an upper bound on its busy time), peak device bytes and the five
    kernels' launches;
14. entry: ``gpu_olap_tpu_torch.entry.entry(device="cuda")``'s step on its
    example rows, then at the groupby bench width (100M rows, keys in
    [0, 128), values in [0, 1000), threshold 500, seed 0), exact against
    numpy; median wall of 5 runs and the kernels' launches;
15. dryrun_multichip: ``dryrun_multichip(8, devices=["cuda:0"] * 8)``: one
    distributed join + GROUP BY step (exact against numpy), the
    overflow-retry loop, the skew-broadcast parity and the shuffle/local
    split;
16. cli: ``python -m gpu_olap_tpu_torch`` over an 8,388,608-row Parquet file
    (seed 7) that the default config caches whole: a filtered aggregate
    (filter_agg must launch), a GROUP BY printing 50 rows (seg_agg must
    launch), an ``--explain``, the filter query in a fresh process, and a
    self-join GROUP BY with ``--mesh 8``; every printed row exact;
17. engine_concurrent: ``GpuOlapEngine(device="cuda")``, the five queries of
    ``tests/test_engine_concurrent.py`` over that table, each six times
    through ``query_async`` and once through ``aquery``, equal to the serial
    answers (and those to the oracle); the result cache; ``shutdown``;
18. examples: each flow of ``examples/torch_usage.py`` at full demo size,
    equal to the same flow on the oracle; then ``host_surface``, the
    seconds of phases 14-18 together;
19. standalone: neither JAX nor any module of ``gpu_olap_tpu`` was loaded.

The eight shards on one card measure the distributed code path, not
scaling; ``multiprocess`` on four cards does (``--only multiprocess`` runs
phases 1, 2, 11 and 19 and prints no kernel line).  The line before the
last is a JSON object with one entry per kernel (radix_hist's launches
include the ranks'); the last line is ``{"ok": true, "device": {...}}``.
Any failure raises.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from contextlib import contextmanager

import numpy as np
import torch

I32_MIN, I32_MAX = -(1 << 31), (1 << 31) - 1

# H100 SXM device-memory rate (NVIDIA's data sheet): a kernel's bound_ms is
# the bytes its function must move (each input read once, each output
# written once) at this rate
HBM_BYTES_PER_S = 3.35e12
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
# the multiprocess phase: every rank is killed once the phase has run this
# long (a rank's collectives give up after mesh.DEFAULT_TIMEOUT)
MP_TIMEOUT_S = 300
# out-of-core: bench.py's 1B-row GROUP BY table (bench.py:211-240), written
# in pieces; the grace join's two tables, each above the 10M-row default
# cache threshold
STREAM_ROWS = 1_000_000_000
STREAM_GROUPS = 4_000_000
STREAM_PIECE = 50_000_000
GRACE_ROWS = 20_000_000
# the entry points: entry()'s step at the groupby bench width (keys in
# [0, 128)); the CLI's Parquet table, the largest the default config caches
# whole (under its 10M-row threshold)
ENTRY_ROWS = 100_000_000
ENTRY_REPS = 5
CLI_ROWS = 8_388_608
CLI_KEYS = 262_144


def _say(phase: str, **kv) -> None:
    print(json.dumps({"phase": phase, **kv}), flush=True)


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()


#: GPU clock cycles the timing window waits behind, per call it times
#: (about 0.1 ms each at the H100's clock)
SLEEP_CYCLES_PER_CALL = 200_000


def _cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` on the current stream (CUDA events).

    The window opens behind a spin kernel long enough for the host to queue
    every call, so the host's time to reach the first launch is not counted
    against the device; a function that synchronizes still waits there."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES_PER_CALL * reps)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _bound_ms(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


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
    cols8 = [t(g.integers(-(1 << 30), 1 << 30, 100_000)) for _ in range(8)]
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
    # every number of value columns 0..8, distinct from the filter (up to
    # nine streams), then the same with the filter among them
    for k in range(9):
        cases.append((f"cols_{k}", v, "ge", 300, tuple(cols8[:k]), None, None))
        cases.append((f"cols_{k}_alias", v, "lt", 600,
                      (v,) + tuple(cols8[:max(k - 1, 0)]), None, None))
    big_n = t(g.integers(-1000, 1000, 5_000_003))
    cases += [
        ("cols_repeated", v, "ne", 7, (w, v, w, cols8[0], v), None, None),
        ("unaligned_filter_aligned_cols", v[3:], "gt", 100,
         (w[:99_997], v[3:]), None, None),
        ("unaligned_cols_5", w[1:], "le", 20,
         tuple(c[1:] for c in cols8[:5]), None, None),
        ("n_valid_1", v, "ge", 0, (v, w), 1, None),
        ("n_valid_3", w, "ne", 1000, (w,), 3, None),
        ("n_valid_4097", v, "gt", 10, (v, w), 4097, None),
        ("no_match_8_cols", v, "gt", I32_MAX, tuple(cols8), None, None),
        ("lt_int32_min", v, "lt", I32_MIN, (v,), None, None),
        ("wants_none", v, "gt", 100, (v, w),
         None, ((False, False), (False, False))),
        ("wants_mixed_alias", v, "le", 500, (v, v, w),
         None, ((True, False), (False, True), (True, True))),
        ("many_blocks", big_n, "gt", -5, (big_n, cols8[0].repeat(51)[:5_000_003]),
         None, None),
        ("many_blocks_n_valid", big_n, "eq", 3, (big_n,), 4_999_001, None)]
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
    # look-back chains: groups of 1 to 40 tiles of 4096 rows, so tiles see
    # long runs of predecessors that hold no group start
    sizes = g.integers(1, 40 * 4096, 60)
    k = np.repeat(np.arange(len(sizes)) * 11 - 300, sizes)
    cases.append(("groups_span_many_tiles",
                  *co_sort(k, g.integers(-(1 << 30), 1 << 30, len(k))), 64))
    n = 3_000_001  # one group, sum far past 2^31, count n
    cases.append(("one_group_sum_past_2p31", np.full(n, 9, np.int32),
                  np.full(n, (1 << 30) + 7, np.int32), 2))
    n = 1_000_003  # every row its own group, over 245 tiles
    cases.append(("every_row_many_tiles", np.arange(n, dtype=np.int32) - 500,
                  -np.arange(n, dtype=np.int32), n))
    cases.append(("n_1", np.array([I32_MIN], np.int32),
                  np.array([-7], np.int32), 3))
    cases.append(("n_1_max_groups_0", np.array([4], np.int32),
                  np.array([5], np.int32), 0))
    sizes = g.integers(1, 3000, 4000)  # 4000 groups over many tiles
    k = np.repeat(np.arange(len(sizes)) * 3, sizes)
    kv = co_sort(k, g.integers(I32_MIN, I32_MAX, len(k), endpoint=True))
    cases.append(("max_groups_cut_mid_tiles", *kv, 1234))
    cases.append(("max_groups_0_many_tiles", *kv, 0))
    n = 777_777  # negative keys and values, then the INT32_MAX sentinel group
    k = np.sort(g.integers(-(1 << 31), -1, n))
    k[-100_000:] = I32_MAX
    cases.append(("negative_and_sentinel",
                  *co_sort(k, g.integers(I32_MIN, 0, n)), n))
    out = [(name, t(k), t(v), mg) for name, k, v, mg in cases]
    # an unaligned view of a many-tile input: the kernel's scalar loads
    name, k, v, mg = out[-1]
    out.append(("unaligned_view", k[1:], v[1:], mg))
    return out


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
    int32 extremes; then the packed counters' edges: one bin over four
    flushes of every block of a full wave, every thread's counter at
    exactly the flush limit in all 256 bins, and views at offsets 1-3 of
    lengths 1-7 around the 16-byte vector."""
    from gpu_olap_tpu_torch.ops.kernels import _build

    g = np.random.default_rng(500)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(dev)

    rand = g.integers(I32_MIN, I32_MAX, 100_003, endpoint=True)
    base = t(rand)
    # keys a full wave counts between two flushes of every thread
    flush_keys = _build.load().olap_radix_hist_wave_flush_keys()
    cases = [("n_0", t(rand[:0])), ("n_1", t(rand[:1])),
             ("n_16383", t(rand[:16383])), ("n_16385", t(rand[:16385])),
             ("one_bin", t(np.full(70_001, 0x5A5A5A5A))),
             ("negative", t(-np.abs(rand) - 1)),
             ("extremes", t(np.concatenate([np.full(999, I32_MIN),
                                            np.full(1001, I32_MAX), rand]))),
             ("unaligned_view", base[3:]),
             ("one_bin_four_flushes", torch.full(
                 (flush_keys * 4 + 5,), 7, dtype=torch.int32, device=dev)),
             # thread t of a block loads the 16-byte words j with j % 256 ==
             # t % 256, so keys (index // 4) % 256 give each thread one bin
             ("all_bins_at_flush_limit", (torch.arange(
                 flush_keys * 2 + 3, device=dev) // 4 % 256).to(torch.int32))]
    for off in (1, 2, 3):
        cases += [(f"view_{off}_len_{n}", base[off:off + n])
                  for n in range(1, 8)]
    return cases


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
    side = torch.cuda.Stream(dev)
    for name, keys in radix_cases:
        for shift in (0, 8, 16, 24, 31):
            # twice on this stream (the block counter resets), once on another
            got = [rp.radix_histogram_i32(keys, shift),
                   rp.radix_histogram_i32(keys, shift)]
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                got.append(rp.radix_histogram_i32(keys, shift))
            torch.cuda.synchronize()
            exp = rp.radix_histogram_plain(keys, shift)
            err = _max_abs_err(got, [exp] * 3)
            if err:
                raise AssertionError(f"radix_hist case {name} shift {shift}: "
                                     f"max |err| {err}")
    _say("kernels_edge_cases", filter_agg=len(_filter_agg_cases(dev)),
         seg_agg=len(_seg_agg_cases(dev)),
         stream_compact=len(compact_cases), expand_fill=len(expand_cases),
         radix_hist=5 * len(radix_cases), radix_hist_calls_per_case=3,
         exact=True)
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
    # one stream (v is filter and value) read; count, sum, min, max written
    fa_bound = _bound_ms(FILTER_ROWS * 4 + 8 + 8 + 4 + 4)
    # keys and values read; five outputs of max_groups slots and the count
    sa_bound = _bound_ms(GROUPBY_ROWS * 8 + mg * 24 + 4)
    _say("kernels_main_shapes", filter_agg_rows=FILTER_ROWS,
         filter_agg_ms=fa_ms, filter_agg_plain_ms=fa_plain_ms,
         filter_agg_bound_ms=fa_bound,
         seg_agg_rows=GROUPBY_ROWS, seg_agg_groups=n_groups,
         seg_agg_max_groups=mg, seg_agg_ms=sa_ms,
         seg_agg_plain_ms=sa_plain_ms, seg_agg_bound_ms=sa_bound)
    # neither has one PyTorch call computing the same function
    return {"filter_agg": (fa_err, fa_ms, fa_plain_ms, fa_bound, None),
            "seg_agg": (sa_err, sa_ms, sa_plain_ms, sa_bound, None)}


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
    n, ns = mask.shape[0], len(streams)
    # library yardstick: one boolean-mask index of the stacked streams
    stacked = torch.stack(streams)
    lib_ms = _cuda_ms(lambda: stacked[:, mask], 10)
    del stacked
    out["stream_compact"] = (
        err, _cuda_ms(lambda: js.stream_compact_i32(mask, streams, cap), 10),
        _cuda_ms(lambda: js.stream_compact_plain(mask, streams, cap), 3),
        # mask and streams read; cap slots per stream and the count written
        _bound_ms(n + ns * n * 4 + ns * cap * 4 + 4), lib_ms)
    shapes = {"stream_compact_elements": n, "stream_compact_streams": ns,
              "stream_compact_cap": cap, "records": n_rec}
    del mask, streams

    starts, streams, cap = args["expand_fill_i32"]
    got = js.expand_fill_i32(starts, streams, cap)
    exp = js.expand_fill_plain(starts, streams, cap)
    err = _max_abs_err(got, exp)
    del got, exp
    torch.cuda.synchronize()
    m, ns = starts.shape[0], len(streams)
    # library yardstick: repeat_interleave of the stacked streams by each
    # record's run length inside [0, cap)
    ends = torch.cat([starts[1:], starts.new_full((1,), I32_MAX)])
    reps = (ends.clamp(max=cap) - starts.clamp(max=cap)).clamp(min=0)
    total = int(reps.sum())
    stacked = torch.stack(streams)
    lib_ms = _cuda_ms(lambda: torch.repeat_interleave(
        stacked, reps, dim=1, output_size=total), 10)
    del stacked, ends, reps
    out["expand_fill"] = (
        err, _cuda_ms(lambda: js.expand_fill_i32(starts, streams, cap), 10),
        _cuda_ms(lambda: js.expand_fill_plain(starts, streams, cap), 3),
        # starts and streams read; offsets and a stream each of cap written
        _bound_ms(m * 4 + ns * m * 4 + (ns + 1) * cap * 4), lib_ms)
    shapes.update(expand_fill_records=starts.shape[0],
                  expand_fill_streams=len(streams), expand_fill_slots=cap)
    del starts, streams
    torch.cuda.synchronize()
    if out["stream_compact"][0] or out["expand_fill"][0]:
        raise AssertionError(f"kernel != plain at the join's shapes: {out}")
    _say("kernels_join_shapes", **shapes,
         **{f"{k}_{f}": v[i] for k, v in out.items()
            for i, f in ((1, "ms"), (2, "plain_ms"), (3, "bound_ms"),
                         (4, "library_ms"))})
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


def _config5_plan(tables, zipf: bool, hist) -> dict:
    """``bench_dist.py``'s capacity planning (``bench_dist.py:55-81``):
    ``hist(keys, keep)`` is the destination histogram (numpy) of the rows
    of the global array ``keys`` that ``keep`` selects (None: every row),
    counted on the card through ``partition_histogram``, so radix_hist."""
    from gpu_olap_tpu_torch.parallel import skew

    ndev, per = DIST_SHARDS, DIST_ROWS_PER_SHARD
    n = ndev * per
    n_keys, lk, rk, _, _ = tables
    heavy = np.zeros(0, dtype=np.int64)
    light = None
    if zipf:
        heavy = skew.detect_heavy_keys(lk, row_threshold=max(256, per // 4))
        light = ~np.isin(lk, heavy)
    capacity = max(
        skew.recommend_capacity(hist(lk, light), ndev,
                                headroom=1.6 if zipf else 1.3),
        skew.recommend_capacity(hist(rk, None), ndev, headroom=1.3))
    return {"capacity": capacity,
            "join_capacity": per * (32 if zipf else 24),
            "max_groups": min(n_keys, 1 << 20), "heavy": heavy,
            "heavy_build_cap": max(256, 4 * max(n // n_keys, 1)
                                   * int(heavy.size)),
            "heavy_probe_share": float(np.isin(lk, heavy).mean())}


def _card_hist(dev):
    """The single-process planner's histogram: every selected row on the
    card at once."""
    from gpu_olap_tpu_torch.parallel import skew

    def hist(keys, keep):
        d = torch.from_numpy(keys if keep is None else keys[keep]).to(dev)
        return skew.partition_histogram(d, DIST_SHARDS).cpu().numpy()

    return hist


def _config5_program(mesh, plan: dict):
    """The config-5 step over ``mesh``: the skew step when the plan has
    heavy keys, else the fused step."""
    from gpu_olap_tpu_torch.parallel import dist_ops

    cfg = dict(capacity=plan["capacity"], join_capacity=plan["join_capacity"],
               max_groups=plan["max_groups"], agg_funcs=("sum", "count"))
    if plan["heavy"].size:
        return dist_ops.make_dist_join_groupby_skew(
            mesh, **cfg, heavy_keys=plan["heavy"],
            heavy_build_cap=plan["heavy_build_cap"])
    return dist_ops.make_dist_join_groupby(mesh, **cfg)


def _config5_args(mesh, tables):
    """The step's six per-shard arguments: this process's shards."""
    from gpu_olap_tpu_torch.parallel.mesh import shard_rows

    _, lk, rk, lv, rv = tables
    valid = shard_rows(mesh, np.ones(lk.shape[0], bool), False)
    return (shard_rows(mesh, lk), valid, shard_rows(mesh, lv),
            shard_rows(mesh, rk), valid, shard_rows(mesh, rv))


def _config5_step(dev, zipf: bool):
    """BASELINE config 5 on the logical mesh: ``bench_dist.py``'s tables
    and its capacity planning.  Returns (step, per-shard args, plan facts,
    host tables)."""
    from gpu_olap_tpu_torch.parallel.mesh import make_mesh

    tables = _config5_data(DIST_SHARDS * DIST_ROWS_PER_SHARD, zipf)
    plan = _config5_plan(tables, zipf, _card_hist(dev))
    mesh = make_mesh(DIST_SHARDS, [dev] * DIST_SHARDS)
    facts = {"capacity": plan["capacity"],
             "join_capacity": plan["join_capacity"],
             "heavy_keys": int(plan["heavy"].size),
             "heavy_probe_share": plan["heavy_probe_share"]}
    return (_config5_program(mesh, plan), _config5_args(mesh, tables), facts,
            tables)


def _merged_groups(n_keys, gkeys, sums, counts, gvalid):
    """Per join key: the pairs and the sum over every shard's groups (a
    heavy key's groups sit on several shards)."""
    got_n = np.zeros(n_keys, np.int64)
    got_s = np.zeros(n_keys, np.int64)
    for k, sm, c, v in zip(gkeys, sums, counts, gvalid):
        v = v.cpu().numpy()
        np.add.at(got_n, k.cpu().numpy()[v], c.cpu().numpy()[v])
        np.add.at(got_s, k.cpu().numpy()[v], sm.cpu().numpy()[v])
    return got_n, got_s


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
    got_n, got_s = _merged_groups(n_keys, gkeys, sums, counts, gvalid)
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
    return launches, lk, {"uniform": uniform["capacity"],
                          "zipf": zipf["capacity"]}


# ---------------------------------------------------------------------------
# the distributed path over a process group: one rank per card, NCCL
# ---------------------------------------------------------------------------

def _mp_world():
    """(ranks, cards): one rank per card, the most that divides the 8
    shards evenly."""
    cards = torch.cuda.device_count()
    return max(w for w in range(1, min(cards, DIST_SHARDS) + 1)
               if DIST_SHARDS % w == 0), cards


def _median_s(fn, mesh, reps: int):
    """Median host seconds of ``fn()`` over ``reps`` runs, every rank
    starting together (a barrier, then the card drained) and each run
    waited for on the card."""
    import torch.distributed as dist

    walls = []
    for _ in range(reps):
        dist.barrier(group=mesh.group)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        del out
    return float(np.median(walls)), walls


def _mp_case(mesh, dev, zipf: bool, single_capacity: int) -> dict:
    """One config-5 case on this rank: every rank makes the same global
    tables, plans with B5 over its own rows (summed across ranks by
    ``psum`` and checked against a host count of every rank's rows), runs
    the step on its shards; rank 0 gathers every shard's groups and checks
    them exact against numpy."""
    from gpu_olap_tpu_torch.ops.hashing import partition_of
    from gpu_olap_tpu_torch.parallel import collectives, dist_ops, skew
    from gpu_olap_tpu_torch.utils.metrics import GLOBAL_METRICS

    per = DIST_ROWS_PER_SHARD
    lo, hi = mesh.local_indices.start * per, mesh.local_indices.stop * per
    hists_exact = []

    def rank_hist(keys, keep):
        mine = keys[lo:hi] if keep is None else keys[lo:hi][keep[lo:hi]]
        h = skew.partition_histogram(torch.from_numpy(mine).to(dev),
                                     DIST_SHARDS)
        h = collectives.psum(mesh, [h]).cpu().numpy()
        # the summed histogram against a host count of every rank's rows
        sel = keys if keep is None else keys[keep]
        plain = np.bincount(partition_of(torch.from_numpy(sel),
                                         DIST_SHARDS).numpy(),
                            minlength=DIST_SHARDS)
        if not np.array_equal(h, plain):
            raise AssertionError(f"zipf={zipf}: histogram {h.tolist()} summed "
                                 f"over {mesh.world} ranks, {plain.tolist()} "
                                 "counted on the host")
        hists_exact.append(True)
        return h

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    tables = _config5_data(DIST_SHARDS * per, zipf)
    plan = _config5_plan(tables, zipf, rank_hist)
    if plan["capacity"] != single_capacity:
        raise AssertionError(f"zipf={zipf}: capacity {plan['capacity']} over "
                             f"{mesh.world} ranks, {single_capacity} in one "
                             "process")
    if hists_exact != [True, True]:
        raise AssertionError(f"zipf={zipf}: {len(hists_exact)} histograms "
                             "checked, 2 planned")
    step = _config5_program(mesh, plan)
    args = _config5_args(mesh, tables)
    gkeys, (sums, counts), gvalid, overflow = step(*args)
    if bool(overflow):
        raise AssertionError(f"config-5 step overflowed over ranks "
                             f"(zipf={zipf})")
    gathered = [collectives.all_gather(mesh, lane)[0]
                for lane in (gkeys, sums, counts, gvalid)]
    del gkeys, sums, counts, gvalid
    exact = None
    if mesh.rank == 0:
        n_keys, lk, rk, lv, rv = tables
        got_n, got_s = _merged_groups(n_keys, *[[g] for g in gathered])
        exp_n, exp_s = _per_key_join(n_keys, lk, rk, lv, rv)
        if not (np.array_equal(got_n, exp_n) and np.array_equal(got_s, exp_s)):
            raise AssertionError(f"config-5 step over ranks differs from "
                                 f"numpy (zipf={zipf})")
        exact = True
    del gathered
    bytes0 = GLOBAL_METRICS.snapshot().get(collectives.PEER_BYTES, 0)
    wall, walls = _median_s(lambda: step(*args), mesh, DIST_REPS)
    peer_bytes = (GLOBAL_METRICS.snapshot().get(collectives.PEER_BYTES, 0)
                  - bytes0) / DIST_REPS
    out = {"capacity": plan["capacity"], "single_process_capacity":
           single_capacity, "histograms_exact": len(hists_exact),
           "join_capacity": plan["join_capacity"],
           "heavy_keys": int(plan["heavy"].size), "exact": exact,
           "overflow": False, "wall_median_s": wall, "wall_min_s": min(walls),
           "wall_max_s": max(walls), "runs": DIST_REPS,
           "rows_per_s": 2 * DIST_SHARDS * per / wall,
           "peer_bytes_per_step": peer_bytes}
    if not zipf:
        shuf, local = dist_ops.make_dist_join_groupby_stages(
            mesh, capacity=plan["capacity"],
            join_capacity=plan["join_capacity"],
            max_groups=plan["max_groups"], agg_funcs=("sum", "count"))
        shuffled = shuf(*args)
        out["shuffle_s"], _ = _median_s(lambda: shuf(*args), mesh, DIST_REPS)
        out["local_s"], _ = _median_s(lambda: local(*shuffled[:6]), mesh,
                                      DIST_REPS)
        del shuffled
        # the step's exchange alone: the key and value lanes of both sides,
        # each (8 * capacity,) int64 per shard
        lanes = [torch.zeros(DIST_SHARDS * plan["capacity"], dtype=torch.int64,
                             device=dev) for _ in mesh.local_devices]
        bytes0 = GLOBAL_METRICS.snapshot().get(collectives.PEER_BYTES, 0)
        out["all_to_all_s"], _ = _median_s(
            lambda: [collectives.all_to_all(mesh, lanes) for _ in range(4)],
            mesh, DIST_REPS)
        a2a = (GLOBAL_METRICS.snapshot().get(collectives.PEER_BYTES, 0)
               - bytes0) / DIST_REPS
        out["all_to_all_peer_bytes"] = a2a
        out["all_to_all_peer_gb_per_s"] = a2a / out["all_to_all_s"] / 1e9
        del lanes
    del step, args
    out["peak_device_bytes"] = torch.cuda.max_memory_allocated() - mem0
    torch.cuda.empty_cache()
    return out


def _mp_rank(rank: int, d: str) -> int:
    """One rank of the ``multiprocess`` phase (started by the parent with
    ``--rank``): joins the NCCL group through the file store in ``d``,
    runs both config-5 cases and writes ``rank{rank}.json``."""
    import torch.distributed as dist

    from gpu_olap_tpu_torch.ops.kernels import _build
    from gpu_olap_tpu_torch.parallel.mesh import (initialize_distributed,
                                                  make_mesh)

    with open(os.path.join(d, "spec.json")) as f:
        spec = json.load(f)
    world, cards = spec["world"], torch.cuda.device_count()
    group = initialize_distributed(f"file://{d}/store", world, rank,
                                   device="cuda")
    dev = torch.device("cuda", torch.cuda.current_device())
    per_rank = DIST_SHARDS // world
    mesh = make_mesh(DIST_SHARDS, [f"cuda:{(i // per_rank) % cards}"
                                   for i in range(DIST_SHARDS)], group=group)
    _build.load()
    _build.launches.clear()
    cases = {name: _mp_case(mesh, dev, name == "zipf", spec[name])
             for name in ("uniform", "zipf")}
    launches = {"radix_hist": _build.launches["radix_hist"]}
    backend = dist.get_backend(group)
    dist.destroy_process_group()
    loaded = sorted(m for m in sys.modules if m.split(".")[0]
                    in ("jax", "jaxlib", "gpu_olap_tpu"))
    if loaded:
        raise AssertionError(f"rank {rank} loaded {loaded}")
    with open(os.path.join(d, f"rank{rank}.json"), "w") as f:
        json.dump({"rank": rank, "device": str(dev), "backend": backend,
                   "shards": list(mesh.local_indices), **cases,
                   "launches": launches}, f)
    return 0


def _run_multiprocess(card: str, capacities: dict) -> dict:
    """BASELINE config 5 over a process group, one rank per card (one rank
    holding all eight shards on a one-card machine); every rank killed if
    one fails or the phase outlives ``MP_TIMEOUT_S``.  Returns the ranks'
    radix_hist launches."""
    import shutil
    import subprocess
    import tempfile

    world, cards = _mp_world()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    d = tempfile.mkdtemp(prefix="olap_mp_")
    procs, logs = [], []
    t0 = time.perf_counter()
    try:
        with open(os.path.join(d, "spec.json"), "w") as f:
            json.dump({"world": world, **capacities}, f)
        for r in range(world):
            logs.append(open(os.path.join(d, f"rank{r}.log"), "w"))
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--rank", str(r),
                 d], stdout=logs[-1], stderr=subprocess.STDOUT,
                cwd=os.path.dirname(os.path.abspath(__file__))))
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) or \
                    time.perf_counter() - t0 > MP_TIMEOUT_S:
                break
            time.sleep(0.2)
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in logs:
            f.close()
        codes = [p.returncode for p in procs]
        if any(codes):
            for r in range(world):
                with open(os.path.join(d, f"rank{r}.log")) as f:
                    sys.stderr.write(f"--- rank {r}\n{f.read()[-6000:]}\n")
            raise AssertionError(f"multiprocess: ranks exited {codes} (killed "
                                 f"past {MP_TIMEOUT_S} s or after another "
                                 "failed)")
        ranks = []
        for r in range(world):
            with open(os.path.join(d, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(d, ignore_errors=True)
    seconds = time.perf_counter() - t0
    for r in ranks:
        if r["backend"] != "nccl" or not r["launches"]["radix_hist"]:
            raise AssertionError(f"multiprocess rank {r['rank']}: backend "
                                 f"{r['backend']}, launches {r['launches']}")
    per_case = {}
    for name in ("uniform", "zipf"):
        if any(r[name]["histograms_exact"] != 2 for r in ranks):
            raise AssertionError(f"multiprocess {name}: a rank's planning "
                                 "histograms were not both checked")
        per_case[name] = {
            "exact": ranks[0][name]["exact"],
            "capacity": ranks[0][name]["capacity"],
            "single_process_capacity": capacities[name],
            **{k: [r[name][k] for r in ranks] for k in ranks[0][name]
               if k not in ("exact", "capacity", "single_process_capacity",
                            "overflow")}}
    _say("multiprocess", card=card, backend="nccl", world=world,
         cards=cards, shards=DIST_SHARDS, shards_per_rank=DIST_SHARDS // world,
         ranks_note=(None if world == cards else
                     f"{cards} cards: {world} ranks, the largest divisor of "
                     f"{DIST_SHARDS} shards"),
         rows_per_shard_per_side=DIST_ROWS_PER_SHARD,
         devices=[r["device"] for r in ranks], **per_case,
         launches_per_rank=[r["launches"]["radix_hist"] for r in ranks],
         seconds=seconds)
    return {"radix_hist": sum(r["launches"]["radix_hist"] for r in ranks)}


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
        # library yardstick: torch.bincount of the shifted keys
        lib_ms = _cuda_ms(lambda: torch.bincount(
            ((dest >> 0) & 0xFF).long(), minlength=256), 5)
        bound = _bound_ms(dest.shape[0] * 4 + 256 * 8)
        out[f"config5_ndev{ndev}_ms"] = ms
        out[f"config5_ndev{ndev}_plain_ms"] = plain_ms
        out[f"config5_ndev{ndev}_library_ms"] = lib_ms
        out[f"config5_ndev{ndev}_bound_ms"] = bound
        if main is None:
            main = (ms, plain_ms, bound, lib_ms)
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


# ---------------------------------------------------------------------------
# out-of-core execution: Parquet tables above the cache threshold
# ---------------------------------------------------------------------------

KERNELS = ("filter_agg", "seg_agg", "stream_compact", "expand_fill",
           "radix_hist")


def _write_fact(path: str, dev):
    """bench.py's 1B-row table (``bench_groupby_1b``): ``k`` uniform in
    [0, STREAM_GROUPS), ``v`` uniform in [0, 1M), seed 42, written in
    STREAM_PIECE-row pieces.  The expected per-key COUNT and SUM accumulate
    with ``np.bincount`` and MIN and MAX with ``scatter_reduce_`` on
    ``dev``, piece by piece (neither shares code with the port's sort-based
    path).  Returns (count, sum, min, max, rng): the generator goes on to
    make the dimension table.  Each piece is written on a thread of its
    own while the next is made and counted (the writer releases the
    interpreter lock)."""
    rows = STREAM_ROWS
    from concurrent.futures import ThreadPoolExecutor

    import pyarrow as pa
    import pyarrow.parquet as pq

    g = STREAM_GROUPS
    rng = np.random.default_rng(42)
    cnt = np.zeros(g, dtype=np.int64)
    tot = np.zeros(g, dtype=np.int64)
    mn = torch.full((g,), 1 << 40, dtype=torch.int64, device=dev)
    mx = torch.full((g,), -1, dtype=torch.int64, device=dev)
    writer = None
    try:
        with ThreadPoolExecutor(max_workers=1) as pool:
            writing = None
            for lo in range(0, rows, STREAM_PIECE):
                m = min(STREAM_PIECE, rows - lo)
                k = rng.integers(0, g, m)
                v = rng.integers(0, 1_000_000, m)
                t = pa.table({"k": k, "v": v})
                if writer is None:
                    writer = pq.ParquetWriter(path, t.schema)
                if writing is not None:
                    writing.result()  # pieces go to the file in order
                writing = pool.submit(writer.write_table, t)
                cnt += np.bincount(k, minlength=g)
                # a piece's per-key sum stays below 2^53: exact in float64
                tot += np.bincount(k, weights=v, minlength=g).astype(np.int64)
                kt = torch.from_numpy(k).to(dev)
                vt = torch.from_numpy(v).to(dev)
                mn.scatter_reduce_(0, kt, vt, "amin")
                mx.scatter_reduce_(0, kt, vt, "amax")
                del k, v, t, kt, vt
            if writing is not None:
                writing.result()
    finally:
        if writer is not None:
            writer.close()
    return cnt, tot, mn.cpu().numpy(), mx.cpu().numpy(), rng


def _write_grace(d: str):
    """Two GRACE_ROWS-row tables for the grace join: ``a(k, g, x)`` and
    ``b(k, y)``, keys uniform in [0, rows) (about one match per row), group
    ids in [0, 1000), values in [0, 1000).  Returns the paths and the
    arrays."""
    rows = GRACE_ROWS
    import pyarrow as pa
    import pyarrow.parquet as pq

    rng = np.random.default_rng(43)
    a = {"k": rng.integers(0, rows, rows), "g": rng.integers(0, 1000, rows),
         "x": rng.integers(0, 1000, rows)}
    b = {"k": rng.integers(0, rows, rows), "y": rng.integers(0, 1000, rows)}
    paths = {}
    for name, cols in (("a", a), ("b", b)):
        paths[name] = f"{d}/{name}.parquet"
        pq.write_table(pa.table(cols), paths[name])
    return paths, a, b


def _streamed(eng, sql: str, rows: int, backend: str):
    """One run of ``sql`` on ``backend``: the result and its line — wall
    and rows/s, the streamer's chunks, hash parts, host-to-device bytes and
    their rate over the stream, its stream seconds, host split seconds and
    summed step intervals on the device, peak device bytes and each
    kernel's launches."""
    from gpu_olap_tpu_torch.ops.kernels import _build

    _build.launches.clear()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = eng.query(sql)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if res.metrics["backend"] != backend:
        raise AssertionError(f"{sql}: backend {res.metrics['backend']}, "
                             f"not {backend}")
    sa = eng._get_device_executor()._streaming
    stream_s = sa.last_stream_seconds
    return res, {
        "sql": sql, "backend": backend, "routes": res.metrics["routes"],
        "rows": rows, "wall_s": wall, "rows_per_s": rows / wall,
        "chunks": sa.last_stream_chunks, "hash_parts": sa.last_hash_parts,
        "h2d_bytes": sa.last_link_bytes,
        "h2d_gb_per_s": sa.last_link_bytes / stream_s / 1e9 if stream_s
        else None,
        "stream_s": stream_s, "host_split_s": sa.last_split_seconds,
        "step_interval_s": sa.last_step_interval_seconds,
        "peak_device_bytes": torch.cuda.max_memory_allocated(),
        "launches": {k: _build.launches.get(k, 0) for k in KERNELS}}


def _run_streaming(dev, card: str) -> None:
    """Out-of-core execution through ``TorchOlapEngine``: Parquet tables
    above the cache threshold, one line per query, each exact against
    numpy on the backend the JAX engine takes for it."""
    import shutil
    import tempfile

    from gpu_olap_tpu_torch import EngineConfig, TorchOlapEngine

    rows, grace_rows = STREAM_ROWS, GRACE_ROWS
    d = tempfile.mkdtemp(prefix="olap_stream_")
    try:
        t0 = time.perf_counter()
        cnt, tot, mn, mx, rng = _write_fact(f"{d}/t.parquet", dev)
        w = rng.integers(0, 1_000_000, STREAM_GROUPS)
        paths, a, b = _write_grace(d)
        write_s = time.perf_counter() - t0
        # bench.py's setting for the 1B GROUP BY (bench.py:241): the state
        # of 4M groups takes the hash-partitioned route
        eng = TorchOlapEngine(EngineConfig(
            max_groups=1 << 26, enable_cache=False, spill_dir=f"{d}/spill"),
            device=dev)
        eng.load_table("t", f"{d}/t.parquet")
        for name, path in paths.items():
            eng.load_table(name, path)
        if any(eng.catalog.is_cached(n) for n in ("t", "a", "b")):
            raise AssertionError("a streamed table was cached")
        eng.register("d", {"k": np.arange(STREAM_GROUPS, dtype=np.int64),
                           "w": w})
        common = {"card": card, "reduced": False,
                  "data_write_seconds": write_s}

        # 1. GROUP BY 1B rows into 4M groups, twice: the second run reuses
        # the staging arena's buffers
        sql = ("SELECT k, SUM(v) AS s, MIN(v) AS mn, MAX(v) AS mx FROM t "
               "GROUP BY k")
        keys = np.flatnonzero(cnt)
        exec_ = eng._get_device_executor()
        for run in (1, 2):
            res, line = _streamed(eng, sql, rows, "torch-streaming")
            out = res.to_pandas().sort_values("k")
            _exact(f"{sql} (run {run})",
                   {c: out[c].to_numpy() for c in out.columns},
                   {"k": keys, "s": tot[keys], "mn": mn[keys],
                    "mx": mx[keys]})
            del res, out
            arena = exec_._streaming_arena_stats()
            if run == 1:
                first_arena = arena
            elif arena != first_arena:
                raise AssertionError(f"the arena grew: {first_arena} -> "
                                     f"{arena}")
            # a tenth of the table's 16 B/row in device memory at most
            peak = line["peak_device_bytes"]
            if peak * 10 >= rows * 16:
                raise AssertionError(f"peak device bytes {peak} reach a "
                                     "tenth of the table's")
            _say("engine_streaming", query=f"groupby run {run}",
                 groups=int(len(keys)), arena=arena, **common, **line,
                 exact=True)

        # 2. the streamed join against the cached 4M-row dimension table
        sql = ("SELECT COUNT(*) AS n, SUM(t.v + d.w) AS s FROM t "
               "JOIN d ON t.k = d.k")
        res, line = _streamed(eng, sql, rows, "torch-streaming")
        _exact(sql, res.to_pydict(), {
            "n": [rows], "s": [int(tot.sum() + (cnt * w).sum())]})
        _say("engine_streaming", query="join cached dimension", **common,
             **line, exact=True)
        del cnt, tot, mn, mx, w, keys

        # 3. the grace join: both sides above the cache threshold
        sql = ("SELECT a.g, COUNT(*) AS n, SUM(a.x + b.y) AS s FROM a "
               "JOIN b ON a.k = b.k GROUP BY a.g")
        res, line = _streamed(eng, sql, 2 * grace_rows,
                              "torch-streaming-partitioned")
        nb = np.bincount(b["k"], minlength=grace_rows)
        yb = np.bincount(b["k"], weights=b["y"], minlength=grace_rows)
        m = nb[a["k"]]
        n_g = np.bincount(a["g"], weights=m, minlength=1000).astype(np.int64)
        s_g = np.bincount(a["g"], weights=a["x"] * m + yb[a["k"]],
                          minlength=1000).astype(np.int64)
        groups = np.flatnonzero(n_g)
        out = res.to_pandas().sort_values("g")
        _exact(sql, {c: out[c].to_numpy() for c in out.columns},
               {"g": groups, "n": n_g[groups], "s": s_g[groups]})
        _say("engine_streaming", query="grace join", matches=int(m.sum()),
             spill_partitions=exec_._streaming.last_spill_partitions,
             **common, **line, exact=True)
        del nb, yb, m, res, out

        # 4. COUNT(DISTINCT) does not merge across chunks: the table loads
        # whole onto the device
        sql = "SELECT COUNT(DISTINCT k) AS n FROM a"
        res, line = _streamed(eng, sql, grace_rows, "torch-cuda")
        _exact(sql, res.to_pydict(), {"n": [len(np.unique(a["k"]))]})
        _say("engine_streaming", query="not streamable: full load",
             **common, **line, exact=True)
        del eng, res, a, b
    finally:
        shutil.rmtree(d, ignore_errors=True)
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the entry points and the host surface
# ---------------------------------------------------------------------------

def _launches() -> dict:
    from gpu_olap_tpu_torch.ops.kernels import _build

    return {k: _build.launches.get(k, 0) for k in KERNELS}


def _need_launch(launches: dict, names, what: str) -> None:
    missing = [k for k in names if not launches[k]]
    if missing:
        raise AssertionError(f"{what}: {missing} did not launch ({launches})")


def _run_entry(dev, card: str) -> None:
    """``entry()``'s step: on its 4096 example rows, then at the groupby
    bench width (``ENTRY_ROWS`` rows, keys in [0, 128), values in [0, 1000),
    threshold 500, seed 0), exact against numpy; the median wall of
    ``ENTRY_REPS`` warm runs and the kernels' launches over them."""
    from gpu_olap_tpu_torch.entry import MAX_GROUPS, entry
    from gpu_olap_tpu_torch.ops.kernels import _build

    fn, (k, v, thr) = entry(device=dev)

    def check(what, out, keys, vals):
        gk, s, c, n = (t.cpu().numpy() for t in out)
        m = vals > thr
        uk = np.unique(keys[m])
        n = int(n)
        if n != len(uk) or n > MAX_GROUPS:
            raise AssertionError(f"{what}: {n} groups, numpy {len(uk)}")
        _exact(what, {"k": gk[:n], "s": s[:n], "c": c[:n]},
               {"k": uk, "s": np.bincount(keys[m], weights=vals[m])[uk]
                .astype(np.int64), "c": np.bincount(keys[m])[uk]})
        return n

    example_groups = check("entry() example", fn(k, v, thr), k.cpu().numpy(),
                           v.cpu().numpy())
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 128, ENTRY_ROWS).astype(np.int64)
    vals = rng.integers(0, 1000, ENTRY_ROWS).astype(np.int64)
    kd, vd = torch.from_numpy(keys).to(dev), torch.from_numpy(vals).to(dev)
    t0 = time.perf_counter()
    out = fn(kd, vd, thr)
    torch.cuda.synchronize(dev)
    cold = time.perf_counter() - t0
    _build.launches.clear()
    walls = []
    for _ in range(ENTRY_REPS):
        t0 = time.perf_counter()
        out = fn(kd, vd, thr)
        torch.cuda.synchronize(dev)
        walls.append(time.perf_counter() - t0)
    launches = _launches()
    groups = check("entry() at the bench width", out, keys, vals)
    _say("entry", card=card, example_rows=int(k.shape[0]),
         example_groups=example_groups, rows=ENTRY_ROWS, groups=groups,
         cold_s=cold, runs=ENTRY_REPS, wall_median_s=float(np.median(walls)),
         wall_min_s=min(walls), wall_max_s=max(walls),
         rows_per_s=ENTRY_ROWS / float(np.median(walls)), launches=launches,
         exact=True)
    del kd, vd, out
    torch.cuda.empty_cache()


def _run_dryrun(dev, card: str) -> None:
    """``dryrun_multichip(8)`` on eight logical shards of the card; its first
    step's groups exact against numpy's join + GROUP BY."""
    import contextlib
    import io

    from gpu_olap_tpu_torch.entry import dryrun_multichip
    from gpu_olap_tpu_torch.ops.kernels import _build

    _build.launches.clear()
    printed = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        out = dryrun_multichip(DIST_SHARDS, devices=[str(dev)] * DIST_SHARDS)
    wall = time.perf_counter() - t0
    launches = _launches()
    # the dry run's tables (seed 0, 64 rows per shard a side)
    rng = np.random.default_rng(0)
    n = DIST_SHARDS * 64
    lk, lv = rng.integers(0, 32, n), rng.integers(1, 10, n)
    rk, rv = rng.integers(0, 32, n), rng.integers(1, 10, n)
    cnt, tot = _per_key_join(32, lk, rk, lv, rv)
    exp = {int(k): (int(tot[k]), int(cnt[k])) for k in np.flatnonzero(cnt)}
    if out["group_map"] != exp:
        raise AssertionError("dryrun_multichip: first step differs from numpy")
    _say("dryrun_multichip", card=card, printed=printed.getvalue().strip(),
         wall_s=wall, **{k: v for k, v in out.items() if k != "group_map"},
         launches=launches, exact=True)


# the five queries of tests/test_engine_concurrent.py
CONCURRENT_QUERIES = [
    "SELECT COUNT(*) AS n FROM t",
    "SELECT k, SUM(v) AS s FROM t GROUP BY k ORDER BY k",
    "SELECT COUNT(*) AS n, SUM(v) AS s FROM t WHERE v > 500",
    "SELECT t.k, SUM(t.v + u.w) AS s FROM t JOIN u ON t.k = u.k "
    "GROUP BY t.k ORDER BY t.k",
    "SELECT DISTINCT k FROM t ORDER BY k LIMIT 10",
]
CLI_FILTER_SQL = "SELECT COUNT(*) AS n, SUM(v) AS s FROM t WHERE v > 500"
CLI_GROUP_SQL = ("SELECT k, SUM(v) AS s, MIN(v) AS mn, MAX(v) AS mx FROM t "
                 "GROUP BY k ORDER BY k")
CLI_JOIN_SQL = ("SELECT a.k, COUNT(*) AS n, SUM(b.v) AS s FROM t a JOIN t b "
                "ON a.k = b.k GROUP BY a.k ORDER BY a.k")


def _write_cli_table(path: str):
    """The ``cli`` phase's table: ``k`` in [0, CLI_KEYS), ``v`` in
    [0, 1000), int64, seed 7, CLI_ROWS rows (under the 10M-row cache
    threshold, so the default config caches it whole).  Returns k, v."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    rng = np.random.default_rng(7)
    k = rng.integers(0, CLI_KEYS, CLI_ROWS)
    v = rng.integers(0, 1000, CLI_ROWS)
    pq.write_table(pa.table({"k": k, "v": v}), path)
    return k, v


def _printed_rows(stdout: str, ncols: int) -> np.ndarray:
    """The rows pandas printed (index first), as numbers: the header line,
    then one line per row; a '... (N rows total)' line may follow."""
    rows = [line.split() for line in stdout.splitlines()[1:]
            if not line.startswith("...")]
    if any(len(r) != ncols + 1 for r in rows):
        raise AssertionError(f"unexpected printed rows: {stdout[:500]!r}")
    return np.array([[float(x) for x in r[1:]] for r in rows])


def _cli(argv, what: str, backend: str):
    """One in-process ``cli.main(argv)``: (stdout, wall, launches); the exit
    code must be 0 and the footer must name ``backend``."""
    import contextlib
    import io

    from gpu_olap_tpu_torch import cli
    from gpu_olap_tpu_torch.ops.kernels import _build

    out, err = io.StringIO(), io.StringIO()
    _build.launches.clear()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    wall = time.perf_counter() - t0
    if rc != 0 or (backend and f"[{backend}]" not in err.getvalue()):
        raise AssertionError(f"{what}: rc {rc}, stderr {err.getvalue()!r}")
    return out.getvalue(), wall, _launches()


def _run_cli(dev, card: str, path: str, k: np.ndarray, v: np.ndarray) -> None:
    """``python -m gpu_olap_tpu_torch`` over the cached Parquet table: a
    filtered aggregate (filter_agg), a GROUP BY printing its first 50 rows
    (seg_agg), an ``--explain``, the filter query again in a fresh process,
    and a self-join GROUP BY on eight logical shards; every printed row
    exact against numpy."""
    table = ["--device", str(dev), "--table", f"t={path}"]
    label = f"torch-{dev.type}"
    runs = {}

    m = v > 500
    exp_filter = np.array([[m.sum(), v[m].sum()]], dtype=float)
    out, wall, launches = _cli(table + [CLI_FILTER_SQL], "cli filter", label)
    if not np.array_equal(_printed_rows(out, 2), exp_filter):
        raise AssertionError(f"cli filter: printed {out!r}")
    _need_launch(launches, ["filter_agg"], "cli filter")
    runs["filter"] = {"wall_s": wall, "launches": launches}

    packed = (k << 10) | v  # v < 2^10: (k, v) order in one int64
    packed.sort()
    ks, vs = packed >> 10, packed & 1023
    starts = np.flatnonzero(np.concatenate([[True], ks[1:] != ks[:-1]]))
    ends = np.concatenate([starts[1:], [len(ks)]]) - 1
    sums = np.add.reduceat(vs, starts)
    cnt = np.diff(np.concatenate([starts, [len(ks)]]))
    del packed
    exp_group = np.stack([ks[starts], sums, vs[starts], vs[ends]],
                         axis=1)[:50].astype(float)
    out, wall, launches = _cli(table + ["--max-rows", "50", CLI_GROUP_SQL],
                               "cli group by", label)
    if not np.array_equal(_printed_rows(out, 4), exp_group) or \
            f"... ({len(starts)} rows total)" not in out:
        raise AssertionError(f"cli group by: printed {out[:2000]!r}")
    _need_launch(launches, ["seg_agg"], "cli group by")
    runs["group_by"] = {"wall_s": wall, "groups": int(len(starts)),
                        "launches": launches}

    out, wall, launches = _cli(table + ["--explain", CLI_GROUP_SQL],
                               "cli explain", "")
    if "TpuTableScan" not in out or "Aggregate" not in out:
        raise AssertionError(f"cli explain: {out!r}")
    runs["explain"] = {"wall_s": wall, "launches": launches}

    # a fresh process: it loads the kernel library the runs above built
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "gpu_olap_tpu_torch", *table, CLI_FILTER_SQL],
        capture_output=True, text=True, timeout=600, cwd=root,
        env=dict(os.environ, PYTHONPATH=root))
    wall = time.perf_counter() - t0
    if res.returncode != 0 or f"[{label}]" not in res.stderr or \
            not np.array_equal(_printed_rows(res.stdout, 2), exp_filter):
        raise AssertionError(f"cli subprocess: rc {res.returncode}, "
                             f"{res.stdout!r}, {res.stderr!r}")
    runs["subprocess_filter"] = {"wall_s": wall,
                                 "footer": res.stderr.strip()}

    # the self-join on the mesh: per key, count^2 pairs and count * SUM(v)
    mesh = ",".join([str(dev)] * DIST_SHARDS)
    out, wall, launches = _cli(
        table + ["--mesh", str(DIST_SHARDS), "--mesh-devices", mesh,
                 "--max-rows", "50", CLI_JOIN_SQL],
        "cli mesh self-join", "torch-distributed")
    exp_join = np.stack([ks[starts], cnt * cnt, cnt * sums],
                        axis=1)[:50].astype(float)
    if not np.array_equal(_printed_rows(out, 3), exp_join):
        raise AssertionError(f"cli mesh self-join: printed {out[:2000]!r}")
    runs["mesh_self_join"] = {"wall_s": wall,
                              "pairs": int((cnt * cnt).sum()),
                              "launches": launches}
    _say("cli", card=card, rows=CLI_ROWS, keys=CLI_KEYS, runs=runs,
         exact=True)


def _concurrent_expected(k: np.ndarray, v: np.ndarray, w: np.ndarray):
    """numpy's answers to CONCURRENT_QUERIES over t(k, v) and u(k, w)."""
    import pandas as pd

    cnt = np.bincount(k, minlength=CLI_KEYS)
    sums = np.bincount(k, weights=v, minlength=CLI_KEYS).astype(np.int64)
    keys = np.flatnonzero(cnt)
    joined = keys[keys < len(w)]
    m = v > 500
    frames = [{"n": [len(k)]},
              {"k": keys, "s": sums[keys]},
              {"n": [m.sum()], "s": [v[m].sum()]},
              {"k": joined, "s": sums[joined] + cnt[joined] * w[joined]},
              {"k": keys[:10]}]
    return {sql: pd.DataFrame(f) for sql, f in zip(CONCURRENT_QUERIES, frames)}


def _run_concurrent(dev, card: str, path: str, k: np.ndarray,
                    v: np.ndarray) -> None:
    """The five queries of ``tests/test_engine_concurrent.py`` on
    ``GpuOlapEngine`` over the ``cli`` table and a 50-row ``u``: each six
    times through ``query_async`` and once more through ``aquery`` under
    ``asyncio.gather``, every answer equal to the serial one (itself equal
    to numpy's); then the result cache and ``shutdown``."""
    import asyncio
    from concurrent.futures import wait

    from gpu_olap_tpu_torch import GpuOlapEngine
    from gpu_olap_tpu_torch.ops.kernels import _build

    label = f"torch-{dev.type}"
    eng = GpuOlapEngine(device=dev, enable_cache=False)
    eng.load_table("t", path)
    w = np.random.default_rng(3).integers(0, 10, 50)
    eng.register("u", {"k": np.arange(50, dtype=np.int64), "w": w})
    expected = _concurrent_expected(k, v, w)
    serial = {}
    t0 = time.perf_counter()
    for sql in CONCURRENT_QUERIES:
        r = eng.query(sql)
        if r.metrics["backend"] != label:
            raise AssertionError(f"{sql}: backend {r.metrics['backend']}")
        serial[sql] = r.to_pandas()
    serial_s = time.perf_counter() - t0
    for sql in CONCURRENT_QUERIES:
        _same_frame(serial[sql], expected[sql], sql)

    _build.launches.clear()
    t0 = time.perf_counter()
    futs = [(sql, eng.query_async(sql)) for sql in CONCURRENT_QUERIES * 6]
    _, not_done = wait([f for _, f in futs], timeout=600)
    if not_done:
        raise AssertionError(f"{len(not_done)} queries did not finish")
    async_s = time.perf_counter() - t0
    for sql, f in futs:
        r = f.result()
        if r.metrics["backend"] != label:
            raise AssertionError(f"{sql}: backend {r.metrics['backend']}")
        _same_frame(r.to_pandas(), serial[sql], f"query_async: {sql}")

    async def gather():
        return await asyncio.gather(*(eng.aquery(sql)
                                      for sql in CONCURRENT_QUERIES))

    t0 = time.perf_counter()
    results = asyncio.run(gather())
    aquery_s = time.perf_counter() - t0
    for sql, r in zip(CONCURRENT_QUERIES, results):
        _same_frame(r.to_pandas(), serial[sql], f"aquery: {sql}")
    launches = _launches()
    # the pool's threads launch on the default stream, as the main thread
    streams = {f.result() for f in [
        eng._get_pool().submit(lambda: torch.cuda.current_stream(dev)
                               .cuda_stream) for _ in range(32)]}
    eng.shutdown()
    if eng._pool is not None:
        raise AssertionError("shutdown left the pool open")

    cached = GpuOlapEngine(device=dev)
    cached.catalog = eng.catalog
    sql = CONCURRENT_QUERIES[1]
    first, second = cached.query(sql), cached.query(sql)
    if (first.metrics["backend"], second.metrics["backend"]) != \
            (label, "result-cache"):
        raise AssertionError(f"result cache: {first.metrics['backend']}, "
                             f"{second.metrics['backend']}")
    _same_frame(second.to_pandas(), serial[sql], "result cache")
    cached.shutdown()
    _say("engine_concurrent", card=card, rows=CLI_ROWS,
         queries=len(CONCURRENT_QUERIES), async_submissions=len(futs),
         serial_s=serial_s, query_async_s=async_s, aquery_gather_s=aquery_s,
         pool_workers=eng.config.num_feed_buffers,
         pool_thread_streams=sorted(streams),
         main_thread_stream=torch.cuda.current_stream(dev).cuda_stream,
         launches=launches, result_cache=True, equal=True)
    del eng, cached
    torch.cuda.empty_cache()


def _run_examples(dev, card: str) -> None:
    """Each flow of ``examples/torch_usage.py`` on the card at its full demo
    size, every result equal to the same flow on the NumPy oracle."""
    import contextlib
    import importlib.util
    import io

    root = os.path.dirname(os.path.abspath(__file__))
    spec = importlib.util.spec_from_file_location(
        "torch_usage", os.path.join(root, "examples", "torch_usage.py"))
    usage = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(usage)
    from gpu_olap_tpu_torch.ops.kernels import _build

    scale = usage.demo_scale(str(dev))
    label = f"torch-{dev.type}"
    flows = {}
    for flow in usage.FLOWS:
        _build.launches.clear()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            got = flow(usage.port_engine(str(dev)), scale)
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        launches = _launches()
        with contextlib.redirect_stdout(io.StringIO()):
            exp = flow(usage.port_engine("cpu", backend="cpu"), scale)
        if got.keys() != exp.keys():
            raise AssertionError(f"{flow.__name__}: {got.keys()} vs "
                                 f"{exp.keys()}")
        for name, r in got.items():
            if r.metrics["backend"] != label:
                raise AssertionError(f"{flow.__name__} {name}: backend "
                                     f"{r.metrics['backend']}")
            _same_frame(r.to_pandas(), exp[name].to_pandas(),
                        f"{flow.__name__} {name}")
        flows[flow.__name__] = {
            "wall_s": wall, "skipped": not got,
            "rows": {name: r.num_rows for name, r in got.items()},
            "launches": launches}
    _say("examples", card=card, scale=scale, flows=flows, equal=True)
    torch.cuda.empty_cache()


def _run_host_surface(dev, card: str) -> None:
    """The entry points and the host surface: ``entry``,
    ``dryrun_multichip``, the CLI, concurrent queries and the examples,
    then one line with the seconds these phases took together."""
    import shutil
    import tempfile

    seconds = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        fn(*args)
        seconds[name] = time.perf_counter() - t0

    timed("entry", _run_entry, dev, card)
    timed("dryrun_multichip", _run_dryrun, dev, card)
    d = tempfile.mkdtemp(prefix="olap_cli_")
    try:
        path = os.path.join(d, "t.parquet")
        t0 = time.perf_counter()
        k, v = _write_cli_table(path)
        seconds["cli_table_write"] = time.perf_counter() - t0
        timed("cli", _run_cli, dev, card, path, k, v)
        timed("engine_concurrent", _run_concurrent, dev, card, path, k, v)
        del k, v
    finally:
        shutil.rmtree(d, ignore_errors=True)
    timed("examples", _run_examples, dev, card)
    _say("host_surface", card=card, seconds=seconds,
         total_seconds=sum(seconds.values()))


def _assert_standalone() -> None:
    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")
    loaded = sorted(m for m in sys.modules
                    if m == "gpu_olap_tpu" or m.startswith("gpu_olap_tpu."))
    if loaded:
        raise AssertionError(f"the port loaded the JAX package: {loaded}")
    _say("standalone", jax_loaded=False, gpu_olap_tpu_loaded=False)


def _device_info() -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Smoke run of the port on the "
                                 "GPU (no arguments: every phase).")
    ap.add_argument("--only", choices=["multiprocess"],
                    help="run this phase alone (after the build)")
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("rank_dir", nargs="?", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    if args.rank is not None:
        return _mp_rank(args.rank, args.rank_dir)
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
    _say("ptxas", kernels=_build.ptxas_report())
    if args.only == "multiprocess":
        capacities = {
            name: _config5_plan(_config5_data(DIST_SHARDS * DIST_ROWS_PER_SHARD,
                                              name == "zipf"),
                                name == "zipf", _card_hist(dev))["capacity"]
            for name in ("uniform", "zipf")}
        _run_multiprocess(card, capacities)
        _assert_standalone()
        print(card, flush=True)
        print(json.dumps({"ok": True, "device": _device_info()}), flush=True)
        return 0

    kern = _check_kernels(dev)
    launches = _run_bench(dev, card)
    join_launches, join_kern = _run_joins(dev, card)
    kern.update(join_kern)
    launches.update(join_launches)
    _run_oracle(dev)
    dist_launches, lk, capacities = _run_dist_step(dev, card)
    launches.update(dist_launches)
    kern.update(_check_dist_kernels(dev, lk))
    del lk
    launches["radix_hist"] += _run_multiprocess(card, capacities)["radix_hist"]
    _run_engine_distributed(dev, card)
    _run_streaming(dev, card)
    _run_host_surface(dev, card)
    _assert_standalone()

    replaces = {"filter_agg": "gpu_olap_tpu/ops/pallas/filter_agg.py:104",
                "seg_agg": "gpu_olap_tpu/ops/pallas/seg_agg.py:84",
                "stream_compact": "gpu_olap_tpu/ops/pallas/join_stream.py:52",
                "expand_fill": "gpu_olap_tpu/ops/pallas/join_stream.py:174",
                "radix_hist": "gpu_olap_tpu/ops/pallas/partition.py:25"}
    kernels = []
    for name in ("filter_agg", "seg_agg", "stream_compact", "expand_fill",
                 "radix_hist"):
        err, ms, plain_ms, bound_ms, library_ms = kern[name]
        kernels.append({"name": name, "route": "cuda",
                        "source": f"gpu_olap_tpu_torch/csrc/{name}.cu",
                        "replaces": replaces[name],
                        "launches": launches[name], "max_abs_err": err,
                        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                        "bound_by": "bytes", "library_ms": library_ms})
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": _device_info()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
