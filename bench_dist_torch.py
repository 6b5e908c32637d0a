"""Distributed scaling harness of the PyTorch port: BASELINE config 5, the
shuffle join + GROUP BY step of ``bench_dist.py``, over 1, 2, 4 and 8
shards.

    python3 bench_dist_torch.py [--devices 1 2 4 8] [--rows-per-dev N]
        [--iters N] [--zipf] [--strong] [--oneshot N] [--ranks W]
        [--device cuda|cuda:N|cpu]

In one process a mesh of ``ndev`` shards lies on one device (``[cuda:0] *
ndev``): a logical mesh whose all-to-alls are copies on the card, so the
numbers measure the code path at each shard count, not scaling across
cards.  ``--ranks W`` runs the step over a ``torch.distributed`` group of
W processes, one a card (NCCL; gloo with ``--device cpu``), joined through
a file store in a temporary directory; each rank owns an equal block of
shards, so every ``--devices`` entry must be a multiple of W, and fewer
cards than ranks raise.  Every rank is killed if one fails or the run
outlives ``RANKS_TIMEOUT_S``.

Per mesh size, ``bench_dist.py``'s step: its tables (seed 0, ``n_keys = n
// 16``, probe keys uniform or Zipf(1.5), values in [1, 100)), its capacity
planning (heavy probe keys found on the host; partition histograms through
``skew.partition_histogram``, so the radix_hist kernel from 32768 keys,
each rank counting its own rows and the counts summed; ``recommend_
capacity`` with its headroom), then the fused step, or the skew-broadcast
step when there are heavy keys.  The first run must not overflow (that
raises) and the merged groups must equal numpy's per-key pair counts and
sums (rank 0 gathers every shard's).  Then ``--iters`` timed runs, each
waited for on the device (and behind a barrier over ranks): best and
median wall; for the uniform step also the shuffle and local stages alone.

stdout is one JSON line, ``{"metric":
"dist_join_groupby_rows_per_sec_<ndev>dev", "value": rows/s (both sides,
best run), "unit": "rows/s", "vs_baseline": the last size's weak-scaling
efficiency against the first}``; stderr has a line a size and the
speed-up and efficiency lines; ``bench_dist_torch.json``
(``bench_dist_torch_zipf.json`` with ``--zipf``) holds every size's
fields.  Without CUDA the script exits 2 unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np

from bench_torch import card_name

#: every rank is killed once a ``--ranks`` run has taken this long
RANKS_TIMEOUT_S = 1800


def config5_data(n: int, zipf: bool):
    """``bench_dist.py``'s tables (``bench_dist.py:36-50``): ``(n_keys, lk,
    rk, lv, rv)``."""
    rng = np.random.default_rng(0)
    n_keys = max(n // 16, 64)
    if zipf:
        # a=1.5: the hot key carries ~38 % of the probe rows (1 / zeta(1.5))
        raw = rng.zipf(1.5, n).astype(np.int64)
        lk = np.clip(raw, 1, n_keys) - 1
    else:
        lk = rng.integers(0, n_keys, n).astype(np.int64)
    rk = rng.integers(0, n_keys, n).astype(np.int64)
    lv = rng.integers(1, 100, n).astype(np.int64)
    rv = rng.integers(1, 100, n).astype(np.int64)
    return n_keys, lk, rk, lv, rv


def per_key_join(n_keys, lk, rk, lv, rv):
    """Per join key: COUNT(*) and SUM(l.v * r.v) of the inner join, from
    each side's per-key counts and sums (exact in int64)."""
    cl = np.bincount(lk, minlength=n_keys)
    cr = np.bincount(rk, minlength=n_keys)
    sl = np.bincount(lk, weights=lv, minlength=n_keys).astype(np.int64)
    sr = np.bincount(rk, weights=rv, minlength=n_keys).astype(np.int64)
    return cl * cr, sl * sr


def plan_capacity(tables, ndev: int, rows_per_dev: int, zipf: bool,
                  hist) -> dict:
    """``bench_dist.py``'s capacity planning (``bench_dist.py:55-86``).
    ``hist(keys, keep)`` is the destination histogram (numpy) of the rows of
    the global array ``keys`` that the mask ``keep`` selects (None: every
    row)."""
    from gpu_olap_tpu_torch.parallel import skew

    n = ndev * rows_per_dev
    n_keys, lk, rk, _, _ = tables
    heavy = np.zeros(0, dtype=np.int64)
    light = None
    if zipf:
        # heavy probe keys take the broadcast path: their build rows
        # replicate, their probe rows join where they are
        heavy = skew.detect_heavy_keys(
            lk, row_threshold=max(256, rows_per_dev // 4))
        light = ~np.isin(lk, heavy)
    # the buckets hold both shuffled sides: the (light) probe peak and the
    # about uniform build side
    capacity = max(
        skew.recommend_capacity(hist(lk, light), ndev,
                                headroom=1.6 if zipf else 1.3),
        skew.recommend_capacity(hist(rk, None), ndev, headroom=1.3))
    # about 16 matches a probe row, 1.5x headroom; a heavy key's probe rows
    # join locally, so its device's matches get the same rule
    join_capacity = rows_per_dev * (32 if zipf else 24)
    return {"capacity": capacity, "join_capacity": join_capacity,
            "max_groups": min(n_keys, 1 << 20), "heavy": heavy,
            "heavy_build_cap": max(256, 4 * max(n // n_keys, 1)
                                   * int(heavy.size)),
            "heavy_probe_mass": float(np.isin(lk, heavy).mean())}


def device_hist(dev, ndev: int):
    """The one-process planner's histogram: every selected row on ``dev``
    at once."""
    import torch

    from gpu_olap_tpu_torch.parallel import skew

    def hist(keys, keep):
        d = torch.from_numpy(keys if keep is None else keys[keep]).to(dev)
        return skew.partition_histogram(d, ndev).cpu().numpy()

    return hist


def rank_hist(mesh, dev, rows_per_dev: int):
    """The histogram over ranks: each rank counts the selected rows of its
    own shards, and ``psum`` adds the counts."""
    import torch

    from gpu_olap_tpu_torch.parallel import collectives, skew

    lo = mesh.local_indices.start * rows_per_dev
    hi = mesh.local_indices.stop * rows_per_dev

    def hist(keys, keep):
        mine = keys[lo:hi] if keep is None else keys[lo:hi][keep[lo:hi]]
        h = skew.partition_histogram(torch.from_numpy(mine).to(dev),
                                     mesh.size)
        return collectives.psum(mesh, [h]).cpu().numpy()

    return hist


def step_program(mesh, plan: dict):
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


def step_args(mesh, tables):
    """The step's six per-shard arguments: this process's shards."""
    from gpu_olap_tpu_torch.parallel.mesh import shard_rows

    _, lk, rk, lv, rv = tables
    valid = shard_rows(mesh, np.ones(lk.shape[0], bool), False)
    return (shard_rows(mesh, lk), valid, shard_rows(mesh, lv),
            shard_rows(mesh, rk), valid, shard_rows(mesh, rv))


def merged_groups(n_keys, gkeys, sums, counts, gvalid):
    """Per join key: the pairs and the sum over every shard's groups (a
    heavy key's groups sit on several shards)."""
    got_n = np.zeros(n_keys, np.int64)
    got_s = np.zeros(n_keys, np.int64)
    for k, sm, c, v in zip(gkeys, sums, counts, gvalid):
        v = v.cpu().numpy()
        np.add.at(got_n, k.cpu().numpy()[v], c.cpu().numpy()[v])
        np.add.at(got_s, k.cpu().numpy()[v], sm.cpu().numpy()[v])
    return got_n, got_s


def _mesh(ndev: int, device, group):
    """``ndev`` shards on ``device``, or split over ``group``'s ranks, each
    rank's block on its own card."""
    import torch

    from gpu_olap_tpu_torch.parallel.mesh import make_mesh

    if group is None:
        return make_mesh(ndev, [device] * ndev)
    import torch.distributed as dist

    world = dist.get_world_size(group)
    if ndev % world:
        raise ValueError(f"{ndev} shards do not split over {world} ranks")
    per = ndev // world
    if torch.device(device).type == "cuda":
        cards = torch.cuda.device_count()
        devices = [f"cuda:{(i // per) % cards}" for i in range(ndev)]
    else:
        devices = ["cpu"] * ndev
    return make_mesh(ndev, devices, group=group)


def _wall(fn, mesh, dev) -> float:
    """Host seconds of ``fn()``, waited for on the device; over ranks every
    rank starts together."""
    import torch

    if mesh.group is not None:
        import torch.distributed as dist

        dist.barrier(group=mesh.group)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    del out
    return time.perf_counter() - t0


def _check_groups(mesh, tables, gkeys, sums, counts, gvalid):
    """The step's groups against numpy: True on the process that checked
    (rank 0 gathers every rank's shards), None on the others."""
    from gpu_olap_tpu_torch.parallel import collectives

    lanes = (gkeys, sums, counts, gvalid)
    if mesh.group is not None:
        lanes = [[collectives.all_gather(mesh, lane)[0]] for lane in lanes]
        if mesh.rank != 0:
            return None
    n_keys, lk, rk, lv, rv = tables
    got_n, got_s = merged_groups(n_keys, *lanes)
    exp_n, exp_s = per_key_join(n_keys, lk, rk, lv, rv)
    if not (np.array_equal(got_n, exp_n) and np.array_equal(got_s, exp_s)):
        raise AssertionError(f"config-5 step over {mesh.size} shards differs "
                             "from numpy")
    return True


def bench_step(ndev: int, rows_per_dev: int, iters: int, zipf: bool,
               device="cuda", group=None) -> dict:
    """One mesh size: plan, run, check, time (``bench_dist.py:25-153``)."""
    import torch

    from gpu_olap_tpu_torch.ops.kernels import _build
    from gpu_olap_tpu_torch.parallel import dist_ops

    mesh = _mesh(ndev, device, group)
    dev = mesh.local_devices[0]
    n = ndev * rows_per_dev
    tables = config5_data(n, zipf)
    _build.launches.clear()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    hist = device_hist(dev, ndev) if group is None else \
        rank_hist(mesh, dev, rows_per_dev)
    plan = plan_capacity(tables, ndev, rows_per_dev, zipf, hist)
    step = step_program(mesh, plan)
    args = step_args(mesh, tables)
    gkeys, (sums, counts), gvalid, overflow = step(*args)
    # an overflowed run drops rows and would report an optimistic rate
    if bool(overflow):
        raise RuntimeError(
            f"shuffle/join capacity overflow at ndev={ndev} (capacity="
            f"{plan['capacity']}, join_capacity={plan['join_capacity']})")
    exact = _check_groups(mesh, tables, gkeys, sums, counts, gvalid)
    del gkeys, sums, counts, gvalid
    walls = [_wall(lambda: step(*args), mesh, dev) for _ in range(iters)]
    total_rows = 2 * n
    where = (f"{ndev} shards on {dev}: logical, the code path, not scaling"
             if group is None else
             f"{ndev} shards over {mesh.world} ranks, {dev} on rank "
             f"{mesh.rank}")
    out = {"ndev": ndev, "rows": total_rows, "seconds": min(walls),
           "seconds_median": float(np.median(walls)), "walls": walls,
           "rows_per_sec": total_rows / min(walls),
           "shuffle_capacity": int(plan["capacity"]),
           "join_capacity": int(plan["join_capacity"]), "exact": exact,
           "mesh": where}
    if plan["heavy"].size:
        out.update(mode="skew-broadcast", heavy_keys=int(plan["heavy"].size),
                   heavy_probe_mass=round(plan["heavy_probe_mass"], 4))
    else:
        # per-stage attribution: shuffle (all-to-all) against local work
        shuf_fn, local_fn = dist_ops.make_dist_join_groupby_stages(
            mesh, capacity=plan["capacity"],
            join_capacity=plan["join_capacity"],
            max_groups=plan["max_groups"], agg_funcs=("sum", "count"))
        shuffled = shuf_fn(*args)
        t_shuf = min(_wall(lambda: shuf_fn(*args), mesh, dev)
                     for _ in range(iters))
        t_local = min(_wall(lambda: local_fn(*shuffled[:6]), mesh, dev)
                      for _ in range(iters))
        del shuffled
        out.update(shuffle_seconds=t_shuf, local_seconds=t_local,
                   shuffle_frac=t_shuf / (t_shuf + t_local))
    out["launches"] = {"radix_hist": _build.launches["radix_hist"]}
    if dev.type == "cuda":
        out["peak_device_bytes"] = torch.cuda.max_memory_allocated(dev)
    return out


# ---------------------------------------------------------------------------
# the driver
# ---------------------------------------------------------------------------

def _rows_per_dev(args, ndev: int) -> int:
    return (max(args.rows_per_dev // ndev, 1024) if args.strong
            else args.rows_per_dev)


def _rank_main(args) -> int:
    """One rank of ``--ranks``: joins the group through the file store in
    ``args.store``, runs every size and writes ``rank{R}.json``."""
    import torch.distributed as dist

    from gpu_olap_tpu_torch.parallel.mesh import initialize_distributed

    group = initialize_distributed(f"file://{args.store}/store", args.ranks,
                                   args.rank, device=args.device)
    results = [bench_step(ndev, _rows_per_dev(args, ndev), args.iters,
                          args.zipf, args.device, group)
               for ndev in args.devices]
    dist.destroy_process_group()
    with open(os.path.join(args.store, f"rank{args.rank}.json"), "w") as f:
        json.dump(results, f)
    return 0


def _run_ranks(args, argv) -> list:
    """Every size over ``args.ranks`` processes: rank 0's results, with each
    rank's best seconds and the slowest rank's as the step's."""
    import torch

    world = args.ranks
    if torch.device(args.device).type == "cuda" and \
            torch.cuda.device_count() < world:
        raise ValueError(f"{world} ranks need {world} cards, "
                         f"{torch.cuda.device_count()} visible")
    bad = [d for d in args.devices if d % world]
    if bad:
        raise ValueError(f"--devices {bad} do not split over {world} ranks")
    d = tempfile.mkdtemp(prefix="bench_dist_torch_")
    procs, logs = [], []
    t0 = time.perf_counter()
    try:
        for r in range(world):
            logs.append(open(os.path.join(d, f"rank{r}.log"), "w"))
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), *argv,
                 "--rank", str(r), "--store", d],
                stdout=logs[-1], stderr=subprocess.STDOUT))
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) or \
                    time.perf_counter() - t0 > RANKS_TIMEOUT_S:
                break
            time.sleep(0.2)
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        codes = [p.returncode for p in procs]
        if any(codes):
            for r in range(world):
                with open(os.path.join(d, f"rank{r}.log")) as f:
                    sys.stderr.write(f"--- rank {r}\n{f.read()[-6000:]}\n")
            raise RuntimeError(f"ranks exited {codes} (killed past "
                               f"{RANKS_TIMEOUT_S} s or after another failed)")
        ranks = []
        for r in range(world):
            with open(os.path.join(d, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
        shutil.rmtree(d, ignore_errors=True)
    out = []
    for i, res in enumerate(ranks[0]):
        res["rank_seconds"] = [r[i]["seconds"] for r in ranks]
        res["rank_launches"] = [r[i]["launches"] for r in ranks]
        res["seconds"] = max(res["rank_seconds"])
        res["rows_per_sec"] = res["rows"] / res["seconds"]
        out.append(res)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="BASELINE config 5 on the port")
    ap.add_argument("--rows-per-dev", type=int, default=1 << 20)
    ap.add_argument("--devices", type=int, nargs="+", default=[1, 2, 4, 8],
                    help="mesh sizes (shards)")
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--zipf", action="store_true",
                    help="Zipfian probe keys (the skewed-join config)")
    ap.add_argument("--strong", action="store_true",
                    help="strong scaling: --rows-per-dev is the TOTAL per "
                         "side, split over the mesh")
    ap.add_argument("--oneshot", type=int, default=None,
                    help="run ONE mesh size and print its JSON line")
    ap.add_argument("--ranks", type=int, default=None,
                    help="run over a process group of this many ranks, one "
                         "a card")
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda, cuda:N or cpu")
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--store", help=argparse.SUPPRESS)
    argv = sys.argv[1:] if argv is None else list(argv)
    args = ap.parse_args(argv)
    if args.iters < 1:
        ap.error("--iters must be at least 1")
    if args.oneshot is not None:
        args.devices = [args.oneshot]

    from gpu_olap_tpu_torch.utils.torchenv import resolve_device

    try:
        resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        print(f"bench_dist_torch: {e}; pass --device cpu to run on the CPU",
              file=sys.stderr)
        return 2
    if args.rank is not None:
        return _rank_main(args)

    if args.ranks:
        # SIGTERM unwinds, so the ranks are killed on the way out
        signal.signal(signal.SIGTERM, lambda signum, _: sys.exit(128 + signum))
        results = _run_ranks(args, argv)
    else:
        results = [bench_step(ndev, _rows_per_dev(args, ndev), args.iters,
                              args.zipf, args.device)
                   for ndev in args.devices]
    if args.oneshot is not None:
        print(json.dumps(results[0]))
        return 0
    for r in results:
        print(f"# ndev={r['ndev']}: {r['rows_per_sec']:.0f} rows/s "
              f"({r['mesh']})", file=sys.stderr)
    base = results[0]
    for r in results[1:]:
        r["speedup"] = r["rows_per_sec"] / base["rows_per_sec"]
        # weak-scaling efficiency: per-shard throughput retained
        r["scaling_efficiency"] = ((r["rows_per_sec"] / r["ndev"])
                                   / (base["rows_per_sec"] / base["ndev"]))
        print(f"# ndev={r['ndev']}: speed-up {r['speedup']:.3f}x, "
              f"efficiency {r['scaling_efficiency']:.2%}", file=sys.stderr)
    path = ("bench_dist_torch_zipf.json" if args.zipf
            else "bench_dist_torch.json")
    with open(path, "w") as f:
        json.dump({"card": card_name(args.device), "device": args.device,
                   "zipf": args.zipf, "strong": args.strong,
                   "ranks": args.ranks, "rows_per_dev": args.rows_per_dev,
                   "iters": args.iters, "results": results}, f, indent=2)
    last = results[-1]
    print(json.dumps({
        "metric": f"dist_join_groupby_rows_per_sec_{last['ndev']}dev",
        "value": round(last["rows_per_sec"], 1), "unit": "rows/s",
        "vs_baseline": round(last.get("scaling_efficiency", 1.0), 4)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
