"""Distributed operators: shuffle join and shuffle group-by over the mesh.

Port of ``gpu_olap_tpu/parallel/dist_ops.py``.  Each ``make_*`` returns a
callable over per-shard lists with the outputs of the JAX ``make_*``: per-shard
lists for sharded outputs and one tensor for a replicated one (the overflow
flag, equal on every rank).  Per-shard lists hold the calling process's
shards (all of them on a mesh without a process group), and every rank of a
mesh's group calls the step with its own.  A JAX ``shard_map`` body becomes
phases split at its collectives, each phase a loop over the local shards:
shuffle (every shard packs, the blocks cross the mesh), then the local join
and group-by one shard at a time, so a shard's match buffer and sort
scratch are freed before the next shard's exist.  The local operators are
the port's ``inner_join``, ``groupby_aggregate`` and
``compaction_indices``.

The fused steps group only the live prefix of a shard's match buffer (the
first ``min(total, join_capacity)`` pairs, which is what JAX's buffer
holds): torch runs with data-dependent sizes, so the padding past the match
count is never sorted.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..ops import aggregate as agg_ops
from ..ops import join as join_ops
from ..ops.dtypes import key_fill
from ..ops.filter import compaction_indices
from .collectives import all_gather, pany
from .mesh import Mesh
from .shuffle import shuffle_rows
from .skew import split_by_heavy


def _np_dtype(t: torch.Tensor):
    return torch.empty(0, dtype=t.dtype).numpy().dtype


def _pair_products(lkey, lval, lvalid, rkey, rval, rvalid, join_capacity):
    """Inner join of one shard's two sides: the key and ``lval * rval`` of
    each matched pair, over the live prefix of the match buffer, and the
    buffer's overflow flag."""
    li, ri, _valid, total, overflow, _cnt = join_ops.inner_join(
        [(lkey, torch.zeros_like(lvalid))], lvalid,
        [(rkey, torch.zeros_like(rvalid))], rvalid, join_capacity)
    m = min(int(total), int(join_capacity))  # the live pairs form a prefix
    li, ri = li[:m], ri[:m]
    return lkey[li], lval[li] * rval[ri], overflow


def _group(jkey, jval, max_groups, agg_funcs, device):
    """Local GROUP BY of the joined pairs by key: (gkeys, results, gvalid,
    overflow)."""
    if jkey.shape[0] == 0:  # no pair on this shard: no group
        return (torch.full((max_groups,), key_fill(jkey.dtype),
                           dtype=jkey.dtype, device=device),
                tuple(torch.zeros(max_groups, dtype=torch.int64
                                  if f == "count" else jval.dtype,
                                  device=device) for f in agg_funcs),
                torch.zeros(max_groups, dtype=torch.bool, device=device),
                torch.tensor(False, device=device))
    specs = [{"func": f, "values": jval, "valid": None, "distinct": False,
              "acc_dtype": np.int64 if f == "count" else _np_dtype(jval)}
             for f in agg_funcs]
    codes, results, n_groups, of_g = agg_ops.groupby_aggregate(
        [(jkey, None)], None, specs, max_groups, n_rows=jkey.shape[0],
        device=device)
    gvalid = torch.arange(max_groups, device=device) < n_groups
    return codes[0][0], tuple(r[0] for r in results), gvalid, of_g


def _per_shard(mesh, outs):
    """Per-shard tuples (gkeys, results, gvalid, flag) as per-output lists."""
    gkeys = [o[0] for o in outs]
    results = tuple([o[1][j] for o in outs] for j in range(len(outs[0][1])))
    gvalid = [o[2] for o in outs]
    return gkeys, results, gvalid, pany(mesh, [o[3] for o in outs])


def make_dist_groupby(mesh: Mesh, agg_specs: Sequence[dict], capacity: int,
                      max_groups: int):
    """Distributed GROUP BY: shuffle rows by key hash, then the local
    sort-based aggregation; every key lands on one shard, so local results
    are exact and disjoint.

    ``agg_specs``: [{func, acc_dtype}], one value column each.  Returns
    fn(keys, row_valid, *value_cols) -> (group_keys, (agg_results...),
    group_valid, n_groups_per_shard), per-shard lists."""
    nvals = len(agg_specs)

    def _dist_groupby(keys, row_valid, *value_cols):
        if len(value_cols) != nvals:
            raise ValueError(f"expected {nvals} value columns")
        n_local = len(mesh.local_devices)
        rk, rp, rv, _ = shuffle_rows(
            mesh, keys, [[c[i] for c in value_cols] for i in range(n_local)],
            row_valid, capacity)
        gkeys, results, gvalid, ngroups = [], [[] for _ in agg_specs], [], []
        for i, dev in enumerate(mesh.local_devices):
            specs = [{"func": s["func"], "values": v, "valid": None,
                      "distinct": False, "acc_dtype": s["acc_dtype"]}
                     for s, v in zip(agg_specs, rp[i])]
            codes, res, n_groups, _ = agg_ops.groupby_aggregate(
                [(rk[i], torch.zeros_like(rv[i]))], rv[i], specs, max_groups,
                n_rows=rk[i].shape[0], device=dev)
            gkeys.append(codes[0][0])
            for j, r in enumerate(res):
                results[j].append(r[0])
            gvalid.append(torch.arange(max_groups, device=dev) < n_groups)
            ngroups.append(n_groups.reshape(1))
        return gkeys, tuple(results), gvalid, ngroups

    return _dist_groupby


def make_dist_join(mesh: Mesh, capacity: int, join_capacity: int,
                   n_left_payloads: int, n_right_payloads: int):
    """Distributed inner equi-join: both sides shuffled by key hash, then
    the local sort-probe join per shard.

    Returns fn(lkeys, lvalid, rkeys, rvalid, *left_payloads,
    *right_payloads) -> (out_lkey, (left payloads), (right payloads),
    out_valid, match_count_per_shard), per-shard lists of
    ``join_capacity`` slots."""
    n_pay = n_left_payloads + n_right_payloads

    def _dist_join(lkeys, lvalid, rkeys, rvalid, *payloads):
        if len(payloads) != n_pay:
            raise ValueError(f"expected {n_pay} payloads")
        lpay, rpay = payloads[:n_left_payloads], payloads[n_left_payloads:]
        n_local = len(mesh.local_devices)
        slk, slp, slv, _ = shuffle_rows(
            mesh, lkeys, [[p[i] for p in lpay] for i in range(n_local)],
            lvalid, capacity)
        srk, srp, srv, _ = shuffle_rows(
            mesh, rkeys, [[p[i] for p in rpay] for i in range(n_local)],
            rvalid, capacity)
        keys, lout, rout, valid, totals = [], [], [], [], []
        for i in range(n_local):
            li, ri, out_valid, total, _of, _cnt = join_ops.inner_join(
                [(slk[i], torch.zeros_like(slv[i]))], slv[i],
                [(srk[i], torch.zeros_like(srv[i]))], srv[i], join_capacity)
            safe_l = torch.clamp(li, 0, slk[i].shape[0] - 1)
            safe_r = torch.clamp(ri, 0, srk[i].shape[0] - 1)
            keys.append(slk[i][safe_l])
            lout.append([p[safe_l] for p in slp[i]])
            rout.append([p[safe_r] for p in srp[i]])
            valid.append(out_valid)
            totals.append(total.reshape(1))
        return (keys,
                tuple([o[j] for o in lout] for j in range(n_left_payloads)),
                tuple([o[j] for o in rout] for j in range(n_right_payloads)),
                valid, totals)

    return _dist_join


def make_dist_join_groupby_skew(mesh: Mesh, capacity: int, join_capacity: int,
                                max_groups: int, agg_funcs: Sequence[str],
                                heavy_keys, heavy_build_cap: int):
    """Skew-aware fused join + group-by (BASELINE config 5, Zipfian keys):
    rows carrying a heavy key (``skew.detect_heavy_keys``) skip the hash
    shuffle.  Their build rows are replicated to every shard with
    ``all_gather`` and their probe rows join where they are, so no shard
    receives a hot key's whole probe mass; light keys take the shuffle.

    fn(lkeys, lvalid, lval, rkeys, rvalid, rval) -> (gkeys, (aggs...),
    gvalid, overflow); a key's groups may appear on several shards (the
    caller merges them).  ``overflow`` also covers heavy build rows past
    ``heavy_build_cap`` on a shard, which would otherwise be dropped."""
    heavy_keys = np.asarray(heavy_keys, dtype=np.int64)

    def _step(lkeys, lvalid, lval, rkeys, rvalid, rval):
        n_local = len(mesh.local_devices)
        lheavy = [split_by_heavy(k, heavy_keys) for k in lkeys]
        rheavy = [split_by_heavy(k, heavy_keys) for k in rkeys]

        # light keys: hash shuffle
        slk, slp, slv, of_l = shuffle_rows(
            mesh, lkeys, [[lval[i]] for i in range(n_local)],
            [lvalid[i] & ~lheavy[i] for i in range(n_local)], capacity)
        srk, srp, srv, of_r = shuffle_rows(
            mesh, rkeys, [[rval[i]] for i in range(n_local)],
            [rvalid[i] & ~rheavy[i] for i in range(n_local)], capacity)

        # heavy keys: each shard's heavy build rows, compacted, to all shards
        hb_k, hb_v, hb_valid, of_hb = [], [], [], []
        for i, dev in enumerate(mesh.local_devices):
            gidx, hb_count = compaction_indices(rvalid[i] & rheavy[i])
            slots = torch.arange(heavy_build_cap, device=dev)
            src = gidx[torch.clamp(slots, 0, gidx.shape[0] - 1)]
            hb_k.append(rkeys[i][src])
            hb_v.append(rval[i][src])
            hb_valid.append(slots < torch.clamp(
                hb_count, max=min(heavy_build_cap, gidx.shape[0])))
            of_hb.append(hb_count > heavy_build_cap)
        hb_k = all_gather(mesh, hb_k)
        hb_v = all_gather(mesh, hb_v)
        hb_valid = all_gather(mesh, hb_valid)

        outs = []
        for i, dev in enumerate(mesh.local_devices):
            lkey, lprod, of_j1 = _pair_products(
                slk[i], slp[i][0], slv[i], srk[i], srp[i][0], srv[i],
                join_capacity)
            hkey, hprod, of_j2 = _pair_products(
                lkeys[i], lval[i], lvalid[i] & lheavy[i], hb_k[i], hb_v[i],
                hb_valid[i], join_capacity)
            g = _group(torch.cat([lkey, hkey]), torch.cat([lprod, hprod]),
                       max_groups, agg_funcs, dev)
            outs.append(g[:3] + (of_l[i] | of_r[i] | of_j1 | of_j2
                                 | of_hb[i] | g[3],))
        return _per_shard(mesh, outs)

    return _step


def make_dist_join_groupby(mesh: Mesh, capacity: int, join_capacity: int,
                           max_groups: int, agg_funcs: Sequence[str]):
    """The fused step of BASELINE config 5: distributed shuffle join feeding
    a group-by on the join key.

    fn(lkeys, lvalid, lval, rkeys, rvalid, rval) -> (gkeys, (aggs...),
    gvalid, overflow), grouped by join key.  ``overflow`` is a replicated
    bool: True when any shard overflowed a shuffle bucket, its match buffer
    or its group table; results are then incomplete and the caller must
    retry with larger capacities (or fail)."""
    shuffle_fn, local_fn = make_dist_join_groupby_stages(
        mesh, capacity, join_capacity, max_groups, agg_funcs)

    def _step(lkeys, lvalid, lval, rkeys, rvalid, rval):
        *shuffled, of_s = shuffle_fn(lkeys, lvalid, lval, rkeys, rvalid, rval)
        gkeys, results, gvalid, of_l = local_fn(*shuffled)
        return gkeys, results, gvalid, of_s | of_l

    return _step


def make_dist_join_groupby_stages(mesh: Mesh, capacity: int,
                                  join_capacity: int, max_groups: int,
                                  agg_funcs: Sequence[str]):
    """The fused step as its two phases, so a harness can time the shuffle
    apart from the local join + aggregate.

    Returns (shuffle_fn, local_fn):
      shuffle_fn(lkeys, lvalid, lval, rkeys, rvalid, rval)
          -> (slk, slval, slv, srk, srval, srv, overflow)
      local_fn(slk, slval, slv, srk, srval, srv)
          -> (gkeys, (aggs...), gvalid, overflow)
    """

    def _shuffle(lkeys, lvalid, lval, rkeys, rvalid, rval):
        n_local = len(mesh.local_devices)
        slk, slp, slv, of_l = shuffle_rows(
            mesh, lkeys, [[lval[i]] for i in range(n_local)], lvalid, capacity)
        srk, srp, srv, of_r = shuffle_rows(
            mesh, rkeys, [[rval[i]] for i in range(n_local)], rvalid, capacity)
        overflow = pany(mesh, [a | b for a, b in zip(of_l, of_r)])
        return (slk, [p[0] for p in slp], slv, srk, [p[0] for p in srp], srv,
                overflow)

    def _local(slk, slval, slv, srk, srval, srv):
        outs = []
        for i, dev in enumerate(mesh.local_devices):
            jkey, jval, of_j = _pair_products(slk[i], slval[i], slv[i], srk[i],
                                              srval[i], srv[i], join_capacity)
            g = _group(jkey, jval, max_groups, agg_funcs, dev)
            outs.append(g[:3] + (of_j | g[3],))
        return _per_shard(mesh, outs)

    return _shuffle, _local
