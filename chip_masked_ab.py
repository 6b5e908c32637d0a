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
  with MIN of an int32 probe column (the grouped join aggregate);
- ``op_*``: ``groupby_aggregate`` called directly on the general path (the
  keys have null lanes, as a star join's dimension columns do) over 100M
  rows: one key into about 4M groups or three into about 5.6M, with
  COUNT(*), an integer SUM, a float SUM and AVG, under a mask that keeps
  90 % or every row.  Its digest holds the group count and every output of
  every group, floats bit for bit; it also gives the call's peak device
  bytes above its inputs.

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
OP_MAX_GROUPS = 1 << 23

QUERIES = {
    "gb_where_narrow": ("gb", "SELECT k, SUM(v) AS s, MIN(v) AS mn, "
                        "MAX(v) AS mx FROM t WHERE k < 1000 GROUP BY k"),
    "gb_where_half": ("gb", "SELECT k, SUM(v) AS s, MIN(v) AS mn, "
                      "MAX(v) AS mx FROM t WHERE v < 500000 GROUP BY k"),
    "distinct_where": ("gb", "SELECT DISTINCT k FROM t WHERE v < 500000"),
    "join_gb_min": ("join", "SELECT l.k, MIN(l.w) AS mn FROM l JOIN r "
                    "ON l.k = r.k GROUP BY l.k"),
}


#: (key domains, share of rows the mask keeps) of each direct call
OPS = {"op_1key_keep90": ((GB_GROUPS,), 0.9),
       "op_1key_keep100": ((GB_GROUPS,), 1.0),
       "op_3keys_keep90": ((1000, 100, 50), 0.9),
       "op_3keys_keep100": ((1000, 100, 50), 1.0)}


def _op_inputs(domains, share: float, scale: float, dev):
    """One direct call's (keys, row_valid, specs), made on ``dev`` from a
    fixed seed: each key int32 with 5 % nulls, ``v`` int32 under 1e6,
    ``f`` float64 under 1e3."""
    import torch

    n = int(GB_ROWS * scale)
    g = torch.Generator(device=dev).manual_seed(3)

    def rand():
        return torch.rand(n, generator=g, device=dev)

    keys = [(torch.randint(0, max(int(d * scale), 1), (n,), generator=g,
                           device=dev, dtype=torch.int32), rand() < 0.05)
            for d in domains]
    v = torch.randint(0, 1_000_000, (n,), generator=g, device=dev,
                      dtype=torch.int32)
    f = rand() * 1e3
    rv = rand() < share
    specs = [{"func": "count", "values": None, "valid": None,
              "distinct": False, "acc_dtype": np.dtype(np.int64)},
             {"func": "sum", "values": v, "valid": None, "distinct": False,
              "acc_dtype": np.dtype(np.int64), "np_kind": "i",
              "int32_ok": True, "arg_id": "v"},
             {"func": "sum", "values": f, "valid": None, "distinct": False,
              "acc_dtype": np.dtype(np.float64), "np_kind": "f",
              "arg_id": "f"},
             {"func": "avg", "values": f, "valid": None, "distinct": False,
              "acc_dtype": np.dtype(np.float64), "np_kind": "f",
              "arg_id": "f"}]
    return keys, rv, specs


def _op_digest(out) -> str:
    """The group count and each output of every group, bit for bit."""
    codes, results, n_groups, overflow = out
    ng = int(n_groups)
    h = hashlib.sha256(f"{ng} {bool(overflow)}".encode())
    for data, valid in list(codes) + list(results):
        for t in (data, valid):
            if t is not None:
                h.update(t[:ng].cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _ops(device: str, reps: int, scale: float) -> dict:
    import torch

    from gpu_olap_tpu_torch.ops.aggregate import groupby_aggregate

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    out = {}
    for name, (domains, share) in OPS.items():
        keys, rv, specs = _op_inputs(domains, share, scale, dev)

        def call():
            return groupby_aggregate(keys, rv, specs, OP_MAX_GROUPS,
                                     device=dev)

        res = call()  # warm
        walls = []
        for _ in range(reps):
            if cuda:
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            res = call()
            if cuda:
                torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        out[name] = {"backend": "torch-cuda" if cuda else "torch-cpu",
                     "ms_median": statistics.median(walls),
                     "ms_min": min(walls),
                     "peak_bytes_above_inputs":
                         torch.cuda.max_memory_allocated() - base
                         if cuda else None,
                     "n_groups": int(res[2]), "digest": _op_digest(res)}
        del keys, rv, specs, res
        if cuda:
            torch.cuda.empty_cache()
    return out


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
            enable_cache=False), device=device)
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
    out.update(_ops(device, reps, scale))
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
    if len(digests) != len(QUERIES) + len(OPS):
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
    for q in [*QUERIES, *OPS]:
        med = {side: statistics.median(r[q]["ms_median"] for r in runs[side])
               for side in runs}
        # pair each round's two runs of a tree: other, this, this, other
        gaps = [runs["this"][i][q]["ms_median"]
                - runs["other"][i][q]["ms_median"]
                for i in range(len(runs["this"]))]
        summary[q] = {"other_ms": med["other"], "this_ms": med["this"],
                      "gap_ms_median": statistics.median(gaps)}
        for side in runs:
            for k in ("seg_agg_launches", "seg_agg_path",
                      "peak_bytes_above_inputs"):
                if k in runs[side][0][q]:
                    summary[q][f"{side}_{k}"] = runs[side][0][q][k]
    print(f"card: {_card()}")
    print(json.dumps({"masked_ab": summary, "rounds": args.rounds,
                      "reps": args.reps, "scale": args.scale,
                      "equal": True}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
