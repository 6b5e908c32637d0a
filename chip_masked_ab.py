"""Times the port's masked GROUP BY shapes in two trees of the repo, in
turns, on one card.

    python3 chip_masked_ab.py OTHER_TREE [--rounds N] [--reps N]
                              [--scale F] [--device cuda|cpu]

OTHER_TREE is another checkout of the repo (for example the parent commit,
unpacked with ``git archive`` into ``.ab_old/``).  Each query below is a
GROUP BY or DISTINCT whose row mask (a WHERE, or the rows an inner join
matches) is the only operand beside one int32 key: where the ``seg_agg``
path (B2) takes the query, ``ops.aggregate.groupby_aggregate`` gathers the
rows the mask keeps before the sort; the other tree may keep the mask as a
sort operand on the general path.  Every query uses numeric literals, so
both trees plan it.

- ``gb_where_narrow`` / ``gb_where_half``: the interpreter's GROUP BY,
  ``bench_torch.py``'s groupby table (100M rows, 4M groups, SUM/MIN/MAX)
  under a WHERE that keeps 0.025 % / 50 % of the rows;
- ``distinct_where``: ``SELECT DISTINCT k`` on the same table under the
  50 % WHERE;
- ``join_gb_min``: an inner join of 8M x 8M rows grouped by the probe key
  with MIN of an int32 probe column (the grouped join aggregate).

Each tree runs in a child process of its own, with that tree first on
``sys.path``, in turns other, this, this, other, ``--rounds`` times.  A
child makes its tables from fixed seeds, runs each query once to warm up
(upload, kernel build), then ``--reps`` times more, and prints one JSON
line: per query the median and min wall milliseconds, the ``seg_agg``
launches and ``torch_seg_agg_path`` uses of one run, and a digest of the
sorted answer.  The parent fails unless every child agrees on every digest
and, on the card, every query runs on ``torch-cuda``.  The last line holds,
per query and tree, the median of the children's medians, and the median
of the rounds' this-minus-other gaps.  Prints the card's name and power
limit.  Needs one NVIDIA GPU unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

SENTINEL = "##MASKED_AB##"
GB_ROWS, GB_GROUPS = 100_000_000, 4_000_000
JOIN_ROWS, JOIN_KEYS = 1 << 23, 1 << 22

QUERIES = {
    "gb_where_narrow": ("gb", "SELECT k, SUM(v) AS s, MIN(v) AS mn, "
                        "MAX(v) AS mx FROM t WHERE k < 1000 GROUP BY k"),
    "gb_where_half": ("gb", "SELECT k, SUM(v) AS s, MIN(v) AS mn, "
                      "MAX(v) AS mx FROM t WHERE v < 500000 GROUP BY k"),
    "distinct_where": ("gb", "SELECT DISTINCT k FROM t WHERE v < 500000"),
    "join_gb_min": ("join", "SELECT l.k, MIN(l.w) AS mn FROM l JOIN r "
                    "ON l.k = r.k GROUP BY l.k"),
}


def _tables(scale: float) -> dict:
    """``bench_torch.groupby_tables``'s generator for ``t``; ``l`` and ``r``
    with about two build rows a key."""
    n, g = int(GB_ROWS * scale), max(int(GB_GROUPS * scale), 1)
    rng = np.random.default_rng(1)
    t = {"k": rng.integers(0, g, n).astype(np.int64),
         "v": rng.integers(0, 1_000_000, n).astype(np.int64)}
    nj, kj = int(JOIN_ROWS * scale), max(int(JOIN_KEYS * scale), 1)
    rng = np.random.default_rng(2)
    l = {"k": rng.integers(0, kj, nj).astype(np.int64),
         "w": rng.integers(0, 1000, nj).astype(np.int64)}
    r = {"k": rng.integers(0, kj, nj).astype(np.int64)}
    return {"gb": {"t": t}, "join": {"l": l, "r": r}}


def _digest(res) -> str:
    df = res.to_pandas()
    df = df.sort_values(list(df.columns)).reset_index(drop=True)
    h = hashlib.sha256()
    for c in df.columns:
        h.update(c.encode())
        h.update(np.ascontiguousarray(df[c].to_numpy()).tobytes())
    return h.hexdigest()[:16]


def _child(tree: str, device: str, reps: int, scale: float) -> dict:
    sys.path.insert(0, tree)
    import torch

    import gpu_olap_tpu_torch
    from gpu_olap_tpu_torch import EngineConfig, TorchOlapEngine
    from gpu_olap_tpu_torch.ops.kernels import _build
    from gpu_olap_tpu_torch.utils.metrics import GLOBAL_METRICS

    pkg = os.path.dirname(os.path.abspath(gpu_olap_tpu_torch.__file__))
    assert pkg.startswith(os.path.abspath(tree) + os.sep), pkg
    cuda = device.startswith("cuda")
    out = {}
    for group, tables in _tables(scale).items():
        # bench_torch.make_engine's settings
        eng = TorchOlapEngine(EngineConfig(
            backend="device", join_expansion=1.25, max_groups=1 << 23,
            min_shape_bucket=1 << 16, enable_cache=False), device=device)
        for name, cols in tables.items():
            eng.register(name, cols)
        for qname, (qgroup, sql) in QUERIES.items():
            if qgroup != group:
                continue
            res = eng.query(sql)  # warm: upload, kernel build
            _build.launches.clear()
            b = GLOBAL_METRICS.counters.get("torch_seg_agg_path", 0)
            res = eng.query(sql)
            seg_path = GLOBAL_METRICS.counters.get("torch_seg_agg_path", 0) - b
            launches = _build.launches.get("seg_agg", 0)
            walls = []
            for _ in range(reps):
                if cuda:
                    torch.cuda.synchronize()
                t0 = time.perf_counter()
                eng.query(sql)
                if cuda:
                    torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            out[qname] = {"backend": res.metrics["backend"],
                          "ms_median": statistics.median(walls),
                          "ms_min": min(walls), "seg_agg_launches": launches,
                          "seg_agg_path": seg_path, "digest": _digest(res)}
        del eng
        if cuda:
            torch.cuda.empty_cache()
    return out


def _card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return "not read"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("other_tree")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--child", metavar="TREE")
    args = ap.parse_args()
    if args.child:
        print(SENTINEL + json.dumps(
            _child(args.child, args.device, args.reps, args.scale)))
        return 0
    if args.device.startswith("cuda"):
        import torch
        if not torch.cuda.is_available():
            print("no CUDA device", file=sys.stderr)
            return 2
    here = os.path.dirname(os.path.abspath(__file__))
    trees = {"other": os.path.abspath(args.other_tree), "this": here}
    runs = {"other": [], "this": []}
    for rnd in range(args.rounds):
        for side in ("other", "this", "this", "other"):
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), trees[side],
                 "--child", trees[side], "--device", args.device,
                 "--reps", str(args.reps), "--scale", str(args.scale)],
                capture_output=True, text=True, cwd=trees[side])
            line = next((ln for ln in proc.stdout.splitlines()
                         if ln.startswith(SENTINEL)), None)
            if proc.returncode != 0 or line is None:
                sys.stderr.write(proc.stderr[-4000:])
                print(f"{side} child failed: rc {proc.returncode}",
                      file=sys.stderr)
                return 1
            res = json.loads(line[len(SENTINEL):])
            runs[side].append(res)
            print(json.dumps({"round": rnd, "tree": side, **res}))
    digests = {(q, r[q]["digest"]) for side in runs for r in runs[side]
               for q in r}
    if len(digests) != len(QUERIES):
        print(f"answers differ between runs: {sorted(digests)}",
              file=sys.stderr)
        return 1
    if args.device.startswith("cuda"):
        bad = [q for side in runs for r in runs[side] for q in r
               if r[q]["backend"] != "torch-cuda"]
        if bad:
            print(f"not on torch-cuda: {bad}", file=sys.stderr)
            return 1
    summary = {}
    for q in QUERIES:
        med = {side: statistics.median(r[q]["ms_median"] for r in runs[side])
               for side in runs}
        # pair each round's two runs of a tree: other, this, this, other
        gaps = [runs["this"][i][q]["ms_median"]
                - runs["other"][i][q]["ms_median"]
                for i in range(len(runs["this"]))]
        summary[q] = {"other_ms": med["other"], "this_ms": med["this"],
                      "gap_ms_median": statistics.median(gaps),
                      "this_seg_agg_launches":
                          runs["this"][0][q]["seg_agg_launches"],
                      "other_seg_agg_launches":
                          runs["other"][0][q]["seg_agg_launches"],
                      "this_seg_agg_path": runs["this"][0][q]["seg_agg_path"],
                      "other_seg_agg_path":
                          runs["other"][0][q]["seg_agg_path"]}
    print(f"card: {_card()}")
    print(json.dumps({"masked_ab": summary, "rounds": args.rounds,
                      "reps": args.reps, "scale": args.scale,
                      "equal": True}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
