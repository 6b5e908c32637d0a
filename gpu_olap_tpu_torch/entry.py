"""Entry points of the port: the counterpart of ``__graft_entry__.py``.

``entry(device)``            — the flagship single-device query step (fused
                               filter -> grouped aggregate, BASELINE config
                               1/2 shape) and its example arguments.
``dryrun_multichip(n, devs)`` — builds an n-shard mesh and runs ONE step of
                               the distributed query pipeline (hash-partition
                               shuffle -> join -> group-by) on tiny shapes,
                               then its overflow-retry and skew-broadcast
                               checks and the shuffle/local split.

Both run on CUDA unless the caller names ``"cpu"``: ``entry()`` raises
without a GPU, and ``dryrun_multichip(n)`` raises with fewer than ``n``
visible CUDA devices (on one card pass ``devices=["cuda:0"] * n``).

    python -m gpu_olap_tpu_torch.entry [--device D] [--mesh-devices D,D,...]
"""

from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np
import torch

from .ops import aggregate as agg_ops
from .ops import filter as filter_ops
from .parallel import dist_ops
from .parallel import mesh as mesh_mod
from .utils.torchenv import resolve_device

MAX_GROUPS = 256


def query_step(keys: torch.Tensor, values: torch.Tensor, threshold):
    """``SELECT k, SUM(v), COUNT(*) FROM t WHERE v > threshold GROUP BY k``
    as the engine compiles it: the WHERE mask, then the sort-based grouped
    aggregate on the keys' device.  ``threshold`` is a Python int or a 0-d
    tensor on that device.  Returns (group keys, sums, counts, n_groups),
    ``MAX_GROUPS`` slots each."""
    dev = keys.device
    mask = filter_ops.combine_mask(None, values > threshold, None)
    specs = [
        {"func": "sum", "values": values, "valid": None, "distinct": False,
         "acc_dtype": np.int64},
        {"func": "count", "values": None, "valid": None, "distinct": False,
         "acc_dtype": np.int64},
    ]
    group_codes, results, n_groups, _ = agg_ops.groupby_aggregate(
        [(keys, torch.zeros(keys.shape, dtype=torch.bool, device=dev))], mask,
        specs, MAX_GROUPS, n_rows=keys.shape[0], device=dev)
    return group_codes[0][0], results[0][0], results[1][0], n_groups


def entry(device="cuda"):
    """Return (fn, example_args): the flagship single-device query step and
    the 4096 seed-0 rows it runs on, as tensors on ``device``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    n = 4096
    keys = rng.integers(0, 128, n).astype(np.int64)
    values = rng.integers(0, 1000, n).astype(np.int64)
    example_args = (torch.from_numpy(keys).to(dev),
                    torch.from_numpy(values).to(dev),
                    500)  # the filter threshold
    return query_step, example_args


def _host(shards) -> np.ndarray:
    """A sharded array (per-shard tensors) as one host array, in mesh order."""
    return torch.cat([s.cpu() for s in shards]).numpy()


def _group_map(gk, s, c, gvalid) -> dict:
    """key -> (sum, count) over the valid group slots of every shard.  A heavy
    key's partials may sit on several shards (the broadcast path computes
    per-shard partials); they merge by key as the engine's host merge does."""
    gk, s, c, gvalid = map(_host, (gk, s, c, gvalid))
    out = {}
    for k, sv, cv in zip(gk[gvalid], s[gvalid], c[gvalid]):
        acc = out.setdefault(int(k), [0, 0])
        acc[0] += int(sv)
        acc[1] += int(cv)
    return {k: tuple(v) for k, v in out.items()}


def dryrun_multichip(n_devices: int,
                     devices: Optional[Sequence] = None) -> dict:
    """Run one full distributed query step over an ``n_devices``-shard mesh
    of ``devices`` (default: the visible CUDA devices; fewer raise).

    Exercises the mesh's row-sharded tables, the all-to-all shuffle, the
    per-shard sort-probe join and the group-by; then an undersized join
    buffer must report overflow and the host growth loop must converge to
    the same groups, and the skew-broadcast program must equal the uniform
    one.  Prints one summary line and returns its fields, with the first
    step's ``group_map`` (key -> (sum of l.v * r.v, pairs))."""
    mesh = mesh_mod.make_mesh(n_devices, devices)
    mesh_devices = sorted({d for d in mesh.devices if d.type == "cuda"},
                          key=str)

    def sync():
        for d in mesh_devices:
            torch.cuda.synchronize(d)

    rows_per_dev = 64
    nl = n_devices * rows_per_dev
    nr = n_devices * rows_per_dev
    rng = np.random.default_rng(0)

    def shard(a):
        return mesh_mod.shard_rows(mesh, a)

    lk_host = rng.integers(0, 32, nl).astype(np.int64)
    lk = shard(lk_host)
    lv = shard(rng.integers(1, 10, nl).astype(np.int64))
    rk = shard(rng.integers(0, 32, nr).astype(np.int64))
    rv = shard(rng.integers(1, 10, nr).astype(np.int64))
    lvalid = shard(np.ones(nl, dtype=bool))
    rvalid = shard(np.ones(nr, dtype=bool))
    args6 = (lk, lvalid, lv, rk, rvalid, rv)

    def program(capacity, join_capacity):
        return dist_ops.make_dist_join_groupby(
            mesh, capacity=capacity, join_capacity=join_capacity,
            max_groups=64, agg_funcs=("sum", "count"))

    step = program(rows_per_dev * 4, rows_per_dev * 64)
    gk, (s, c), gvalid, overflow = step(*args6)
    sync()
    if bool(overflow):
        raise RuntimeError("capacity overflow in dryrun")
    group_map = _group_map(gk, s, c, gvalid)
    n_groups = len(group_map)
    if n_groups == 0:
        raise RuntimeError("distributed step produced no groups")

    # the overflow-retry path: a deliberately undersized join capacity must
    # REPORT overflow, and the host-side growth loop (the engine's
    # capacity-retry contract) must converge to the same groups
    join_cap = 4
    retries = 0
    while True:
        gk2, (s2, c2), gvalid2, of2 = program(rows_per_dev * 4, join_cap)(
            *args6)
        sync()
        if not bool(of2):
            break
        join_cap *= 4
        retries += 1
        if retries > 8:
            raise RuntimeError("overflow retry did not converge")
    if retries < 1:
        raise RuntimeError("undersized capacity never reported overflow")
    if _group_map(gk2, s2, c2, gvalid2) != group_map:
        raise RuntimeError("post-retry results differ")

    # the skew-broadcast path: heavy probe keys bypass the shuffle and their
    # build rows replicate to every shard.  Half the probe mass on one key;
    # the result must equal the uniform program's on the same inputs
    lk_skew = lk_host.copy()
    lk_skew[: nl // 2] = 7  # hot key
    lk_s = shard(lk_skew)
    skew_step = dist_ops.make_dist_join_groupby_skew(
        mesh, capacity=rows_per_dev * 4, join_capacity=rows_per_dev * 64,
        max_groups=64, agg_funcs=("sum", "count"),
        heavy_keys=np.asarray([7], dtype=np.int64),
        heavy_build_cap=rows_per_dev * n_devices)
    gk3, (s3, c3), gvalid3, of3 = skew_step(lk_s, lvalid, lv, rk, rvalid, rv)
    sync()
    if bool(of3):
        raise RuntimeError("skew program overflowed")
    # the uniform program needs a far larger buffer under this skew: the
    # hot key's whole probe mass lands on ONE shard, which is what the
    # broadcast path avoids
    gk4, (s4, c4), gvalid4, of4 = program(rows_per_dev * 8,
                                          rows_per_dev * 512)(
        lk_s, lvalid, lv, rk, rvalid, rv)
    sync()
    if bool(of4):
        raise RuntimeError("skew reference program overflowed")
    skew_map = _group_map(gk3, s3, c3, gvalid3)
    if skew_map != _group_map(gk4, s4, c4, gvalid4):
        raise RuntimeError("skew-broadcast results differ from uniform "
                           "shuffle")

    # per-stage attribution: the shuffle (all-to-all) apart from the local
    # join + aggregate, each timed warm
    shuf_fn, local_fn = dist_ops.make_dist_join_groupby_stages(
        mesh, capacity=rows_per_dev * 4, join_capacity=rows_per_dev * 64,
        max_groups=64, agg_funcs=("sum", "count"))
    shuffled = shuf_fn(*args6)
    sync()
    t0 = time.perf_counter()
    shuffled = shuf_fn(*args6)
    sync()
    t_shuf = time.perf_counter() - t0
    local_fn(*shuffled[:6])
    sync()
    t0 = time.perf_counter()
    local_fn(*shuffled[:6])
    sync()
    t_local = time.perf_counter() - t0

    sum0 = int(_host(s)[_host(gvalid)][0])
    out = {"n_devices": n_devices, "groups": n_groups, "sum0": sum0,
           "retries": retries, "final_join_cap": join_cap,
           "skew_groups": int(_host(gvalid3).sum()),
           "shuffle_ms": t_shuf * 1e3, "local_ms": t_local * 1e3,
           "shuffle_frac": t_shuf / (t_shuf + t_local),
           "group_map": group_map}
    print(f"dryrun_multichip({n_devices}): OK — {n_groups} groups, "
          f"sum[0]={sum0}, "
          f"overflow-retry OK ({retries} growths to cap {join_cap}), "
          f"skew-broadcast OK ({out['skew_groups']} groups), "
          f"shuffle {out['shuffle_ms']:.1f} ms / local "
          f"{out['local_ms']:.1f} ms "
          f"(shuffle_frac {out['shuffle_frac']:.2%})")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="gpu_olap_tpu_torch.entry")
    ap.add_argument("--device", default="cuda",
                    help="device of entry()'s step (default: cuda)")
    ap.add_argument("--mesh-devices", default=None,
                    help="comma-separated devices of the 8-shard dry run "
                         "(default: the visible CUDA devices)")
    args = ap.parse_args(argv)
    fn, fn_args = entry(args.device)
    out = fn(*fn_args)
    print("entry(): OK —", int(out[3]), "groups")
    devices = args.mesh_devices.split(",") if args.mesh_devices else None
    dryrun_multichip(len(devices) if devices else 8, devices)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
