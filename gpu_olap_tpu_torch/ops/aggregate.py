"""Sort-based grouped aggregation.

Port of ``gpu_olap_tpu/ops/aggregate.py`` on torch tensors:

1. lexicographic sort of the key columns (multi-key, nulls-as-groups);
2. run boundaries from sorted-key adjacency; group id = prefix sum of flags;
3. per-group [start, end] positions from the run-start positions;
4. integer SUM/COUNT as ``cumsum`` + boundary differences (exact for int64),
   float SUM/AVG as a segmented sum of each group's own rows;
   MIN/MAX of the primary argument ride the key sort (min at run start, max
   at start + valid_count - 1); COUNT(DISTINCT) via a secondary
   (keys, value) sort; further MIN/MAX arguments take a segmented reduction;
5. group key outputs gathered at run starts.

A row mask's kept rows are gathered before any sort.  The hot shape (one
null-free int32 key, aggregates that ride the sort) takes the ``seg_agg``
kernel after the sort (:func:`_maybe_seg_agg_path`).

Outputs are padded to ``max_groups`` with a returned group count, so the
executor's overflow -> regrow protocol is the JAX engine's.  Torch has native
int64, so integer SUMs accumulate in int64 directly: the JAX engine's
float64 exact-sum lane (``sum_f64_ok``) has no counterpart here.  An int32
SUM payload is kept where statistics prove the argument narrow, because the
``seg_agg`` kernel takes int32 lanes.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils import tracing
from ..utils.metrics import GLOBAL_METRICS
from .dtypes import key_code, key_fill, torch_dtype
from .sort import lexsort


# no thread of the segmented float sum adds more than this many terms
SUM_TILE = 1024


def _merge_tiles(s, n: int):
    """The sorted union of the nondecreasing offsets ``s`` (each in [0, n])
    and the tile starts 0, T, 2T, ... below ``n``, an offset before an
    equal tile start; returns it and each offset's position in it."""
    dev = s.device
    tiles = torch.arange(0, n, SUM_TILE, dtype=s.dtype, device=dev)
    # tile starts below each offset, and offsets at or below each tile start
    at_s = torch.arange(s.numel(), device=dev) + torch.clamp(
        (s + SUM_TILE - 1) // SUM_TILE, max=tiles.numel())
    at_t = torch.arange(tiles.numel(), device=dev) + torch.searchsorted(
        s, tiles, right=True)
    cuts = torch.empty(s.numel() + tiles.numel(), dtype=s.dtype, device=dev)
    cuts[at_s] = s
    cuts[at_t] = tiles
    return cuts, at_s


def _sum_plan(starts, ends, n: int):
    """Offsets of :func:`_segmented_sum` over ``n`` sorted rows for the
    group slots ``[starts, ends]`` of :func:`_dense_boundaries`: groups lie
    in row order, and each non-empty one ends where the next slot starts,
    the last at ``ends[-1]``.  Each level cuts its items into pieces at
    every group start and every ``SUM_TILE``-th item, so a group of ``c``
    items leaves at most ``ceil(c / SUM_TILE) + 1`` partial sums; levels
    are added (two at 100M rows) until no group leaves more than
    ``SUM_TILE``.  Fixed shapes, no host sync.  Returns (each level's piece
    offsets, group offsets into the last level's sums, non-empty)."""
    # rows past the last group fall into one extra slot that is dropped
    last = torch.where(ends[-1:] >= starts[-1:], ends[-1:] + 1,
                       starts[-1:])
    s = torch.clamp(torch.cat([starts, last]).to(torch.int64), 0, n)
    levels, items, longest = [], n, n
    while longest > SUM_TILE:
        cuts, s = _merge_tiles(s, items)
        levels.append(torch.cat([cuts, torch.full((1,), items,
                                                  dtype=cuts.dtype,
                                                  device=cuts.device)]))
        items = cuts.numel()
        longest = -(-longest // SUM_TILE) + 1
    return levels, s, ends >= starts


def _serial_sums(x, offsets):
    """``x[offsets[i]:offsets[i + 1]].sum()`` for each i.  As a column,
    ``segment_reduce`` takes one CUDA thread a segment (a 1-D input takes
    one block a segment, far slower over millions of short segments), so
    every segment here holds at most ``SUM_TILE`` items."""
    return torch.segment_reduce(x.unsqueeze(1), "sum", offsets=offsets,
                                unsafe=True).squeeze(1)


def _segmented_sum(values, plan):
    """Per-group sums of sorted float ``values``, each group summed from
    its own rows only, so its rounding error stays within ``n_g * 2**-52 *
    sum(|x_g|)`` whatever the other groups hold.  Deterministic: each sum
    is one thread's, in a fixed order, no atomics."""
    levels, groups, has = plan
    if not has.numel():
        return values.new_zeros(0)
    for offsets in levels:
        values = _serial_sums(values, offsets)
    total = _serial_sums(values, groups)
    return torch.where(has, total,
                       torch.zeros((), dtype=total.dtype, device=total.device))


def _sum_by_boundary(values, starts, ends):
    """Segment sums of a sorted array.  Integers: cumsum + boundary
    differences (exact, as int64 wraps back).  Floats: the segmented
    sum."""
    if values.dtype.is_floating_point:
        return _segmented_sum(values, _sum_plan(starts, ends,
                                                values.shape[0]))
    c = torch.cumsum(values, 0, dtype=values.dtype)
    n = values.shape[0]
    end_v = c[torch.clamp(ends, 0, n - 1)]
    start_prev = torch.where(starts > 0, c[torch.clamp(starts - 1, 0, n - 1)],
                             torch.zeros((), dtype=c.dtype, device=c.device))
    out = end_v - start_prev
    return torch.where(ends >= starts, out,
                       torch.zeros((), dtype=c.dtype, device=c.device))


def _cnt_by_boundary(flags, starts, ends):
    """Segment counts of a boolean/int mask, int64 out."""
    return _sum_by_boundary(flags.to(torch.int64), starts, ends)


def _arg_nullable(spec) -> bool:
    """Whether the ride null-flag operand is needed for this argument."""
    return spec.get("valid") is not None or spec.get("np_kind") == "f"


def _adjacent_diff(op):
    return torch.cat([torch.ones(1, dtype=torch.bool, device=op.device),
                      op[1:] != op[:-1]])


def groupby_aggregate(
    keys: Sequence[Tuple[torch.Tensor, Optional[torch.Tensor]]],  # (code, null|None)
    row_valid: Optional[torch.Tensor],                 # bool (N,) or None
    aggs: Sequence[dict],
    max_groups: int,
    n_rows: Optional[int] = None,
    allow_kernel: bool = True,
    *,
    device: torch.device,
):
    """Grouped aggregation over padded columns.

    ``keys`` entries are (code, null_flags); null_flags may be None when the
    key is statically null-free.  With a ``row_valid`` mask the rows it
    keeps are gathered first, in their order (one host sync for their
    count), and every sort runs over them alone.

    ``aggs`` entries: {func, values (tensor or None for count(*)),
    valid (tensor|None), distinct (bool), acc_dtype (np dtype), np_kind,
    arg_id, int32_ok (bool)}.  ``device`` holds every operand.

    Returns (group_codes: [(code, null)], agg_results: [(data, valid|None)],
    n_groups: int64 0-d tensor, overflow: bool 0-d tensor).
    """
    dev = device
    if keys:
        n = keys[0][0].shape[0]
    elif n_rows is not None:
        n = n_rows
    else:
        n = next(a for a in aggs if a.get("values") is not None)["values"].shape[0]

    if not keys:
        return _global_aggregate(aggs, row_valid, n, dev)

    if row_valid is not None:
        rows = torch.nonzero(row_valid).squeeze(1)
        GLOBAL_METRICS.bump("torch_groupby_compact")
        GLOBAL_METRICS.bump("torch_groupby_rows_in", n)
        GLOBAL_METRICS.bump("torch_groupby_rows_kept", rows.numel())
        tracing.annotate(rows_in=n, rows_kept=rows.numel())
        keys, aggs = _take_rows(keys, aggs, rows)
        n = rows.numel()

    # ---- key operands: each key's null flag sorts before its code ----
    key_ops: List = []
    key_slots = []  # (code slot, null slot or None) per key
    for code, null in keys:
        ns = None
        if null is not None:
            key_ops.append(null.to(torch.int32))
            ns = len(key_ops) - 1
        key_ops.append(code)
        key_slots.append((len(key_ops) - 1, ns))

    # ---- aggregate routing: primary key-ride / payload ride / fallback ----
    primary_spec = next(
        (s for s in aggs
         if s["func"] in ("min", "max") and not s.get("distinct")
         and s.get("values") is not None), None)
    primary_arg = primary_spec.get("arg_id") if primary_spec else None

    ride_ops: List = []
    ride_null_slot = ride_code_slot = None
    if primary_spec is not None:
        pv_code, pv_null = key_code(primary_spec["values"],
                                    primary_spec.get("valid"),
                                    primary_spec.get("np_kind", "i"))
        if primary_spec.get("int32_ok") and pv_code.dtype == torch.int64:
            pv_code = pv_code.to(torch.int32)
        base = len(key_ops)
        if _arg_nullable(primary_spec):
            ride_ops.append(pv_null.to(torch.int32))
            ride_null_slot = base
            base += 1
        ride_ops.append(pv_code)
        ride_code_slot = base

    def _same_arg(spec) -> bool:
        return (primary_spec is not None
                and spec.get("arg_id") is not None
                and spec.get("arg_id") == primary_arg)

    def _rides_primary(spec) -> bool:
        # reuse of the primary key-ride: exact for ints (key_code is identity);
        # floats go through payloads so NaN keeps raw-value semantics
        if spec is primary_spec:
            return True
        if not _same_arg(spec):
            return False
        if spec["func"] in ("min", "max"):
            return True
        return spec.get("np_kind", "i") != "f"

    # pre-masked payload lanes, deduplicated per (kind, argument)
    payloads: List = []
    payload_meta: List[Tuple[str, object]] = []

    def _payload_slot(kind: str, spec) -> int:
        ix = _find_payload(payload_meta, kind, spec)
        if ix is not None:
            return ix
        values, valid = spec["values"], spec.get("valid")
        if kind == "sum":
            acc = spec["acc_dtype"]
            if (spec.get("int32_ok") and np.dtype(acc).kind in "iu"
                    and values.dtype != torch.float64):
                # int32 lane: the seg_agg kernel's payload width
                mv = values.to(torch.int32)
            else:
                mv = values.to(torch_dtype(acc))
            if valid is not None:
                mv = torch.where(valid, mv, 0)
        elif kind == "fsum":
            mv = values.to(torch.float64)
            if valid is not None:
                mv = torch.where(valid, mv, 0.0)
        else:  # cnt
            mv = valid.to(torch.int32)
        payloads.append(mv)
        payload_meta.append((kind, spec.get("arg_id")))
        return len(payloads) - 1

    plans = []  # per-spec execution plan
    need_perm = False
    for spec in aggs:
        func = spec["func"]
        if spec.get("distinct") and func in ("count", "sum", "avg"):
            # DISTINCT is a no-op for min/max, which fall through
            plans.append(("distinct", None))
            continue
        if func == "count" and spec.get("values") is None:
            plans.append(("size", None))
            continue
        if _rides_primary(spec):
            plans.append(("primary", None))
            continue
        if func == "count":
            if spec.get("valid") is None:
                plans.append(("size", None))
            else:
                plans.append(("cnt", _payload_slot("cnt", spec)))
            continue
        if func == "sum":
            cs = (None if spec.get("valid") is None
                  else _payload_slot("cnt", spec))
            plans.append(("sum", (_payload_slot("sum", spec), cs)))
            continue
        if func == "avg":
            cs = (None if spec.get("valid") is None
                  else _payload_slot("cnt", spec))
            plans.append(("avg", (_payload_slot("fsum", spec), cs)))
            continue
        # min/max over a non-primary argument: permutation fallback
        need_perm = True
        plans.append(("fallback", None))

    if n == 0:
        return _no_groups(keys, aggs, plans, ride_ops, ride_null_slot,
                          max_groups, dev)
    seg = _maybe_seg_agg_path(key_ops, ride_ops, ride_null_slot, payloads,
                              need_perm, plans, aggs, n, max_groups,
                              allow_kernel)
    if seg is not None:
        return seg

    operands = key_ops + ride_ops + payloads
    if need_perm:
        operands = operands + [torch.arange(n, dtype=torch.int32, device=dev)]
    num_keys = len(key_ops) + len(ride_ops)
    sorted_ops = lexsort(operands, num_keys)

    newflag = torch.zeros(n, dtype=torch.bool, device=dev)
    for slot in range(len(key_ops)):
        newflag = newflag | _adjacent_diff(sorted_ops[slot])

    gid_raw = torch.cumsum(newflag.to(torch.int32), 0, dtype=torch.int32) - 1
    n_groups = newflag.sum(dtype=torch.int64)
    overflow = n_groups > max_groups
    gid = torch.clamp(gid_raw, 0, max_groups)

    starts, ends, exists = _dense_boundaries(newflag, n_groups, n,
                                             max_groups)
    sizes64 = torch.where(exists, (ends - starts + 1).to(torch.int64), 0)
    safe_start = torch.clamp(starts, 0, n - 1)

    # group key outputs: gather the sorted key at each run start
    group_codes = []
    for code_slot, null_slot in key_slots:
        code_s = sorted_ops[code_slot]
        out_code = torch.where(exists, code_s[safe_start],
                               key_fill(code_s.dtype))
        # statically null-free key: no flag materialized
        nf = (None if null_slot is None
              else exists & (sorted_ops[null_slot][safe_start] > 0))
        group_codes.append((out_code, nf))

    # primary key-ride state
    pv_code_s = pv_null_s = ride_cnt = None
    if primary_spec is not None:
        pv_code_s = sorted_ops[ride_code_slot]
        if ride_null_slot is not None:
            pv_null_s = sorted_ops[ride_null_slot]
            ride_cnt = _cnt_by_boundary(pv_null_s == 0, starts, ends)
        else:
            ride_cnt = sizes64

    pay_base = len(key_ops) + len(ride_ops)
    cnt_cache = {}

    def _payload_sorted(ix):
        return sorted_ops[pay_base + ix]

    def _cnt_of(ix):
        if ix not in cnt_cache:
            cnt_cache[ix] = _sum_by_boundary(
                _payload_sorted(ix).to(torch.int64), starts, ends)
        return cnt_cache[ix]

    sum_plan = None  # every float sum of the call shares one plan

    def _group_sum(values):
        nonlocal sum_plan
        if not values.dtype.is_floating_point:
            return _sum_by_boundary(values, starts, ends)
        if sum_plan is None:
            sum_plan = _sum_plan(starts, ends, n)
        return _segmented_sum(values, sum_plan)

    results = []
    for spec, (kind, slot) in zip(aggs, plans):
        acc = spec["acc_dtype"]
        if kind == "size":
            results.append((sizes64, None))
        elif kind == "distinct":
            results.append(_distinct_agg(spec, key_ops, max_groups, n))
        elif kind == "primary":
            func = spec["func"]
            # null-free argument (no ride null lane): every output group has
            # >= 1 value, so validity is statically all-true
            has = None if pv_null_s is None else (ride_cnt > 0)
            if func in ("min", "max"):
                if func == "min":
                    pos = safe_start
                else:
                    pos = torch.clamp(starts + ride_cnt - 1, 0, n - 1)
                out = pv_code_s[pos]
                # int32-narrowed values stay int32 (the host boundary widens)
                if not (out.dtype == torch.int32
                        and np.dtype(acc) == np.dtype(np.int64)):
                    out = out.to(torch_dtype(acc))
                if has is not None:
                    out = torch.where(has, out, 0)
                results.append((out, has))
            elif func == "count":
                results.append((ride_cnt, None))
            elif func == "sum":
                base_v = pv_code_s.to(torch_dtype(acc))
                if pv_null_s is not None:
                    base_v = torch.where(pv_null_s == 0, base_v, 0)
                results.append((_group_sum(base_v), has))
            else:  # avg
                base_v = pv_code_s.to(torch.float64)
                if pv_null_s is not None:
                    base_v = torch.where(pv_null_s == 0, base_v, 0.0)
                s = _group_sum(base_v)
                avg = s / torch.clamp(ride_cnt, min=1)
                if has is not None:
                    avg = torch.where(has, avg, 0.0)
                results.append((avg, has))
        elif kind == "cnt":
            results.append((_cnt_of(slot), None))
        elif kind == "sum":
            sum_ix, cnt_ix = slot
            mv = _payload_sorted(sum_ix).to(torch_dtype(acc))
            s = _group_sum(mv)
            results.append((s, None if cnt_ix is None else (_cnt_of(cnt_ix) > 0)))
        elif kind == "avg":
            fsum_ix, cnt_ix = slot
            s = _group_sum(_payload_sorted(fsum_ix))
            if cnt_ix is None:
                results.append((s / torch.clamp(sizes64, min=1), None))
            else:
                cnt = _cnt_of(cnt_ix)
                has = cnt > 0
                results.append((torch.where(has, s / torch.clamp(cnt, min=1),
                                            0.0), has))
        else:  # fallback: permutation-based segmented min/max
            perm = sorted_ops[-1]
            results.append(_agg_one_fallback(spec, perm, gid, starts, ends,
                                             n, max_groups))
    return group_codes, results, n_groups, overflow


def _maybe_seg_agg_path(key_ops, ride_ops, ride_null_slot, payloads,
                        need_perm, plans, aggs, n, max_groups: int,
                        allow_kernel: bool):
    """The ``seg_agg`` kernel after the sort, for the hot shape: ONE
    null-free int32 group key and aggregates that all ride the sort:
    COUNT(*), plus
    SUM/MIN/MAX/AVG/COUNT over one null-free int32 argument.

    Returns the standard (group_codes, results, n_groups, overflow) tuple or
    None when the shape does not match (the caller takes the general path).
    """
    from .kernels.seg_agg import MIN_ROWS, seg_agg_sorted_i32

    if not allow_kernel or need_perm:
        return None
    if len(key_ops) != 1 or key_ops[0].dtype != torch.int32:
        return None
    if n < MIN_ROWS:
        return None  # below the JAX engine's one superblock: general path
    k0 = key_ops[0]
    if len(ride_ops) == 1 and not payloads:
        # ride shape: MIN/MAX present, everything rides the (key, value) sort
        if ride_null_slot is not None or ride_ops[0].dtype != torch.int32:
            return None
        if any(kind not in ("size", "primary") for kind, _ in plans):
            return None
        val_lane = ride_ops[0]
    elif not ride_ops and len(payloads) == 1:
        # payload shape: SUM over one null-free int32 argument (+ COUNT(*))
        if payloads[0].dtype != torch.int32:
            return None
        if any(kind not in ("size", "sum") or
               (kind == "sum" and slot != (0, None))
               for kind, slot in plans):
            return None
        val_lane = payloads[0]
    elif not ride_ops and not payloads \
            and all(kind == "size" for kind, _ in plans):
        # COUNT(*)-only / DISTINCT: the sorted keys serve as the value lane
        val_lane = None
    else:
        return None
    if val_lane is None:
        (sk,) = lexsort([k0], 1)
        sv = sk
    else:
        # in-group order is free for SUM, so the payload can always serve as
        # a second sort key; for the ride shape it is one by design
        sk, sv = lexsort([k0, val_lane], 2)

    key_g, cnt_g, sum64, mn_g, mx_g, ng32 = seg_agg_sorted_i32(
        sk, sv, max_groups)
    n_groups = ng32.to(torch.int64)
    overflow = n_groups > max_groups

    g_idx = torch.arange(max_groups, dtype=torch.int32, device=k0.device)
    exists = g_idx < n_groups
    group_codes = [(torch.where(exists, key_g, key_fill(key_g.dtype)), None)]
    sizes64 = torch.where(exists, cnt_g.to(torch.int64), 0)

    results = []
    for spec, (kind, _slot) in zip(aggs, plans):
        acc = spec["acc_dtype"]
        if kind == "size" or spec["func"] == "count":
            results.append((sizes64, None))
            continue
        func = spec["func"]
        if func in ("min", "max"):
            out = torch.where(exists, mn_g if func == "min" else mx_g, 0)
            # int32 stays int32 (the host boundary widens), as on the
            # general primary path
            if np.dtype(acc) != np.dtype(np.int64):
                out = out.to(torch_dtype(acc))
            results.append((out, None))
        elif func == "sum":
            s = torch.where(exists, sum64, 0)
            if np.dtype(acc) != np.dtype(np.int64):
                s = s.to(torch_dtype(acc))
            results.append((s, None))
        else:  # avg: exact int64 sum / exact count in f64
            a = sum64.to(torch.float64) / torch.clamp(sizes64, min=1).to(
                torch.float64)
            results.append((torch.where(exists, a, 0.0), None))
    GLOBAL_METRICS.bump("torch_seg_agg_path")
    return group_codes, results, n_groups, overflow


def _take_rows(keys, aggs, rows):
    """``keys`` and ``aggs`` with each key code, null flag, aggregate value
    and validity at ``rows``; a tensor several operands share is gathered
    once."""
    taken = {}

    def take(x):
        if x is None:
            return None
        if id(x) not in taken:
            taken[id(x)] = x[rows]
        return taken[id(x)]

    return ([(take(code), take(null)) for code, null in keys],
            [dict(spec, values=take(spec.get("values")),
                  valid=take(spec.get("valid"))) for spec in aggs])


def _no_groups(keys, aggs, plans, ride_ops, ride_null_slot, max_groups: int,
               dev):
    """The result of no rows: no group and every slot padded, each output
    in the dtype and with the validity lane the general path gives it."""
    none = torch.zeros(max_groups, dtype=torch.bool, device=dev)
    group_codes = [(torch.full((max_groups,), key_fill(code.dtype),
                               dtype=code.dtype, device=dev),
                    None if null is None else none) for code, null in keys]
    results = []
    for spec, (kind, _) in zip(aggs, plans):
        func, acc = spec["func"], torch_dtype(spec["acc_dtype"])
        if func == "count":
            dtype, has = torch.int64, False
        elif kind == "primary":
            dtype, has = acc, ride_null_slot is not None
            if (func in ("min", "max") and acc == torch.int64
                    and ride_ops[-1].dtype == torch.int32):
                dtype = torch.int32  # int32-narrowed values stay int32
        else:
            dtype = torch.float64 if func == "avg" else acc
            has = (_arg_nullable(spec) if kind == "distinct"
                   else spec.get("valid") is not None)
        results.append((torch.zeros(max_groups, dtype=dtype, device=dev),
                        none if has else None))
    return (group_codes, results, torch.zeros((), dtype=torch.int64,
                                              device=dev),
            torch.zeros((), dtype=torch.bool, device=dev))


def _dense_boundaries(newflag, n_groups, nval: int, max_groups: int):
    """Per-group [start, end] run positions from the run-start flags.

    Group ids are gap-free, so the g-th set flag IS group g's start and
    ``ends[g] = starts[g+1] - 1``; the last group ends at ``nval - 1``
    (``nval`` is the number of valid rows).  Slots at or past ``n_groups``
    get an empty [nval, nval - 2] range."""
    dev = newflag.device
    pos = torch.nonzero(newflag).flatten().to(torch.int32)
    ng = pos.shape[0]
    m = min(ng, max_groups)
    g_idx = torch.arange(max_groups, dtype=torch.int32, device=dev)
    exists = g_idx < n_groups
    starts = torch.full((max_groups,), nval, dtype=torch.int32, device=dev)
    starts[:m] = pos[:m]
    nxt = torch.cat([pos[1:], torch.tensor([nval], dtype=torch.int32,
                                           device=dev)])
    ends = torch.full((max_groups,), nval - 2, dtype=torch.int32, device=dev)
    ends[:m] = nxt[:m] - 1
    return starts, ends, exists


def _find_payload(payload_meta, kind, spec):
    """Payload lanes are shared across aggregates over the same argument
    expression; arg_id None (callers that don't set it) never deduplicates."""
    arg = spec.get("arg_id")
    if arg is None:
        return None
    for i, (k, a) in enumerate(payload_meta):
        if k == kind and (a is arg or a == arg):
            return i
    return None


def _agg_one_fallback(spec, perm, gid, starts, ends, n, max_groups):
    """MIN/MAX over a non-primary argument: gather by the sort permutation and
    reduce per group (rare: needs two distinct min/max argument columns)."""
    func = spec["func"]
    values = spec.get("values")
    valid = spec.get("valid")
    acc = torch_dtype(spec["acc_dtype"])

    vals = values[perm]
    v_valid = (torch.ones(n, dtype=torch.bool, device=vals.device)
               if valid is None else valid[perm])

    if acc.is_floating_point:
        ident = float("inf") if func == "min" else float("-inf")
    else:
        # the accumulator's own bounds: MIN/MAX lanes may be int32
        ident = (torch.iinfo(acc).max if func == "min"
                 else torch.iinfo(acc).min)
    masked = torch.where(v_valid, vals.to(acc),
                         torch.tensor(ident, dtype=acc, device=vals.device))
    red = torch.full((max_groups + 1,), ident, dtype=acc, device=vals.device)
    red = red.scatter_reduce(0, gid.to(torch.int64), masked,
                             "amin" if func == "min" else "amax")
    out = red[:max_groups]
    if valid is None:
        # null-free argument: every non-empty group has a value
        return out, None
    cnt = _cnt_by_boundary(v_valid, starts, ends)
    has_any = cnt > 0
    return torch.where(has_any, out, 0), has_any


def _distinct_agg(spec, key_ops, max_groups, n):
    """COUNT/SUM/AVG(DISTINCT x): secondary sort ordered by (group keys, x),
    distinct flags from adjacency; counts as cumsum + boundary diff.  SUM/AVG
    carry the raw value as a sort payload and reduce only first
    occurrences."""
    func = spec["func"]
    values = spec["values"]
    valid = spec.get("valid")
    dev = values.device
    vcode, vnull = key_code(values, valid, spec.get("np_kind", "i"))
    nullable = _arg_nullable(spec)
    ops = list(key_ops) + ([vnull.to(torch.int32)] if nullable else []) + [vcode]
    need_payload = func in ("sum", "avg")
    if need_payload:
        pay_dtype = np.float64 if func == "avg" else spec["acc_dtype"]
        ops = ops + [values.to(torch_dtype(pay_dtype))]
    num_keys = len(ops) - (1 if need_payload else 0)
    sorted2 = lexsort(ops, num_keys)
    key_end = len(key_ops)
    newflag2 = torch.zeros(n, dtype=torch.bool, device=dev)
    for op in sorted2[:key_end]:
        newflag2 = newflag2 | _adjacent_diff(op)
    n_groups2 = newflag2.sum(dtype=torch.int64)
    starts2, ends2, _ = _dense_boundaries(newflag2, n_groups2, n, max_groups)
    null_s = sorted2[key_end] if nullable else None
    vcode_s = sorted2[key_end + (1 if nullable else 0)]
    distinct_new = newflag2 | _adjacent_diff(vcode_s)
    if nullable:
        distinct_new = distinct_new & (null_s == 0)
    cnt = _cnt_by_boundary(distinct_new, starts2, ends2)
    if func == "count":
        return cnt, None
    payload_s = sorted2[-1]
    masked = torch.where(distinct_new, payload_s, 0)
    ssum = _sum_by_boundary(masked, starts2, ends2)
    has = cnt > 0
    acc = torch_dtype(spec["acc_dtype"])
    if func == "sum":
        out = torch.where(has, ssum.to(acc), 0)
        return out, (has if _arg_nullable(spec) else None)
    avg = torch.where(has, ssum / torch.clamp(cnt, min=1).to(torch.float64),
                      0.0)
    return avg, (has if _arg_nullable(spec) else None)


def _global_aggregate(aggs, row_valid, n, device):
    """No GROUP BY: direct masked reductions, one output row."""
    rv = (torch.ones(n, dtype=torch.bool, device=device) if row_valid is None
          else row_valid)
    results = []
    for spec in aggs:
        func = spec["func"]
        values = spec.get("values")
        valid = spec.get("valid")
        if func == "count" and values is None:
            results.append((rv.sum(dtype=torch.int64).reshape(1), None))
            continue
        if spec.get("distinct") and func in ("count", "sum", "avg"):
            # global distinct: sort values, first-occurrence adjacency mask
            # (SUM/AVG ride the raw value as a payload and reduce only first
            # occurrences)
            vcode, vnull = key_code(values, valid, spec.get("np_kind", "i"))
            inv = (vnull | ~rv).to(torch.int32)
            ops = [inv, vcode]
            if func in ("sum", "avg"):
                pay_dtype = (np.float64 if func == "avg"
                             else spec["acc_dtype"])
                ops.append(values.to(torch_dtype(pay_dtype)))
            sorted_g = lexsort(ops, 2)
            s_inv, s_code = sorted_g[0], sorted_g[1]
            nv = n - int(s_inv.sum())
            arange = torch.arange(n, device=device)
            first = _adjacent_diff(s_code) & (arange < nv)
            cnt = first.sum(dtype=torch.int64)
            if func == "count":
                results.append((cnt.reshape(1), None))
                continue
            pay_s = sorted_g[2]
            ssum = torch.where(first, pay_s, 0).sum(dtype=pay_s.dtype)
            has = (cnt > 0).reshape(1)
            acc = torch_dtype(spec["acc_dtype"])
            if func == "sum":
                results.append((torch.where(cnt > 0, ssum.to(acc),
                                            0).reshape(1), has))
            else:
                avg = torch.where(cnt > 0,
                                  ssum / torch.clamp(cnt, min=1).to(
                                      torch.float64), 0.0)
                results.append((avg.reshape(1), has))
            continue
        v_valid = rv if valid is None else (rv & valid)
        if func == "count":
            results.append((v_valid.sum(dtype=torch.int64).reshape(1), None))
            continue
        cnt = v_valid.sum(dtype=torch.int64)
        has = (cnt > 0).reshape(1)
        acc = torch_dtype(spec["acc_dtype"])
        if func == "sum":
            s = torch.where(v_valid, values.to(acc), 0).sum(dtype=acc)
            results.append((s.reshape(1), has))
        elif func == "avg":
            s = torch.where(v_valid, values.to(torch.float64), 0.0).sum()
            results.append(((s / torch.clamp(cnt, min=1)).reshape(1), has))
        elif func in ("min", "max"):
            if acc.is_floating_point:
                ident = float("inf") if func == "min" else float("-inf")
            else:
                ident = (torch.iinfo(acc).max if func == "min"
                         else torch.iinfo(acc).min)
            masked = torch.where(v_valid, values.to(acc),
                                 torch.tensor(ident, dtype=acc, device=device))
            red = masked.amin() if func == "min" else masked.amax()
            results.append((torch.where(cnt > 0, red, 0).reshape(1), has))
        else:
            raise AssertionError(func)
    return ([], results, torch.tensor(1, dtype=torch.int64, device=device),
            torch.tensor(False, device=device))
