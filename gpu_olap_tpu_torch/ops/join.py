"""Equi-join operators: sort-based build and probe, match expansion, outer
extension and the sorted-space streaming join.

Port of ``gpu_olap_tpu/ops/join.py``.  The design is the JAX package's: the
build side is sorted by key, probe ranges come from one tagged co-sort of
both sides, multi-column or nullable keys are densified into one exact code
space, and matches are materialized into a fixed-capacity buffer with an
overflow flag that the executor answers by growing the capacity and
rerunning.

Multi-operand ``lax.sort`` becomes :func:`..sort.lexsort`, and the run
fills ``lax.cummax`` and the flipped ``lax.cummin`` become the ``run_scan``
kernel's :func:`cummax_i32` and :func:`rev_cummin_i32`.  Where
the JAX package avoided a scatter only because the TPU serializes them (the
inverse permutation of ``densify_keys``, the probe-order restore of
``probe_ranges_merge``, the dense fill of ``lookup_slots`` and the
right-join matched flags of ``outer_extend``), the port scatters; the
outputs are the same.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from .dtypes import INT64_MAX, key_top
from .kernels.run_scan import cummax_i32, rev_cummin_i32
from .sort import lexsort, lexsort_permutation

I32_MAX = (1 << 31) - 1


def _bool_cat_first(diff: torch.Tensor) -> torch.Tensor:
    return torch.cat([torch.ones(1, dtype=torch.bool, device=diff.device),
                      diff])


def densify_keys(
    left_keys: Sequence[Tuple[torch.Tensor, torch.Tensor]],
    left_rowvalid: Optional[torch.Tensor],
    right_keys: Sequence[Tuple[torch.Tensor, torch.Tensor]],
    right_rowvalid: Optional[torch.Tensor],
):
    """Map multi-column keys of both sides into one exact int64 code space
    (codes start at 1).  Rows that must never match (a null key or an
    invalid row) get codes disjoint across the sides.  Returns
    (left_codes, right_codes)."""
    nl = left_keys[0][0].shape[0]
    nr = right_keys[0][0].shape[0]
    dev = left_keys[0][0].device

    def side_invalid(keys, rowvalid, count):
        inv = torch.zeros(count, dtype=torch.bool, device=dev)
        for _, null in keys:
            inv = inv | null
        if rowvalid is not None:
            inv = inv | ~rowvalid
        return inv

    linv = side_invalid(left_keys, left_rowvalid, nl)
    rinv = side_invalid(right_keys, right_rowvalid, nr)
    # 0 = joinable, 1 = left-invalid, 2 = right-invalid: invalid rows of the
    # two sides land in different code groups and cannot match
    flag = torch.cat([linv.to(torch.int32), rinv.to(torch.int32) * 2])
    ops: List[torch.Tensor] = [flag]
    for (lc, _), (rc, _) in zip(left_keys, right_keys):
        ops.append(torch.cat([lc, rc]))
    # stable: equal tuples keep input order, as JAX's trailing arange key
    perm = lexsort_permutation(ops)
    newflag = torch.zeros(nl + nr, dtype=torch.bool, device=dev)
    newflag[0] = True
    for op in ops:
        s = op[perm]
        newflag[1:] |= s[1:] != s[:-1]
    code_sorted = torch.cumsum(newflag.to(torch.int64), 0)
    # the inverse permutation by a scatter (JAX re-sorts: TPU scatters
    # serialize)
    dense = torch.empty_like(code_sorted)
    dense[perm] = code_sorted
    return dense[:nl], dense[nl:]


def build_sorted(build_code: torch.Tensor, build_invalid: torch.Tensor,
                 presorted: bool = False):
    """Sort the build side by key; invalid rows sink to the tail.

    ``presorted``: catalog statistics prove the key column nondecreasing and
    null-free, with invalid rows (if any) only at the tail: the sort
    collapses to a sentinel mask.

    Returns (sorted_keys (tail = key_top sentinel), sorted_row_ids (int32),
    n_valid (int64 0-d))."""
    nb = build_code.shape[0]
    dev = build_code.device
    arange = torch.arange(nb, dtype=torch.int32, device=dev)
    top = key_top(build_code.dtype)
    nbv = nb - build_invalid.sum(dtype=torch.int64)
    if presorted:
        return torch.where(arange < nbv, build_code, top), arange, nbv
    # (invalid, key, row) in JAX: the row is the stable sort's tie order
    perm = lexsort_permutation([build_invalid.to(torch.int32), build_code])
    sk = torch.where(arange < nbv, build_code[perm], top)
    return sk, perm.to(torch.int32), nbv


def _merge_lanes(build_code, build_invalid, probe_code, probe_invalid,
                 fold_range):
    """The tagged key lane(s) of both sides, build rows first: returns
    (key_ops, fold) where ``key_ops`` are the sort keys and ``fold`` names
    the branch: "i32" (key*2 + tag folded into int32 over ``fold_range``),
    "i64" (the same in int64) or "tag" (key and tag as two sort keys)."""
    nb = build_code.shape[0]
    npr = probe_code.shape[0]
    dev = build_code.device
    inv = torch.cat([build_invalid, probe_invalid])
    both_i32 = (build_code.dtype == torch.int32
                and probe_code.dtype == torch.int32)
    # the merged key+tag lane fits int32 when 2 * span + 2 stays below the
    # sentinel
    if both_i32 and fold_range is not None and \
            2 * (int(fold_range[1]) - int(fold_range[0])) + 2 < I32_MAX - 2:
        lo32 = int(fold_range[0])
        key = (torch.cat([build_code, probe_code]) - lo32) * 2
        key = key + torch.cat([
            torch.zeros(nb, dtype=torch.int32, device=dev),
            torch.ones(npr, dtype=torch.int32, device=dev)])
        key = torch.where(inv, I32_MAX, key)
        return [key], "i32"
    if both_i32:
        # key + tag + invalid in ONE int64 lane: key*2 + is_probe,
        # invalid -> INT64_MAX
        key = torch.cat([build_code, probe_code]).to(torch.int64) * 2
        key = key + torch.cat([
            torch.zeros(nb, dtype=torch.int64, device=dev),
            torch.ones(npr, dtype=torch.int64, device=dev)])
        key = torch.where(inv, INT64_MAX, key)
        return [key], "i64"
    key = torch.cat([build_code, probe_code])
    tag = torch.cat([torch.zeros(nb, dtype=torch.int32, device=dev),
                     torch.ones(npr, dtype=torch.int32, device=dev)])
    tag = torch.where(inv, 2, tag).to(torch.int32)
    return [key, tag], "tag"


def _run_base(newflag: torch.Tensor, seen: torch.Tensor,
              is_x: torch.Tensor) -> torch.Tensor:
    """Per element, the count of ``is_x`` elements before its key run,
    carried forward through the run (a cummax of run-start seeds)."""
    seed = torch.where(newflag, seen - is_x.to(torch.int32), -1)
    return cummax_i32(seed.to(torch.int32))


def probe_ranges_merge(build_code, build_invalid, probe_code, probe_invalid,
                       fold_range=None):
    """Per-probe-row [lo, lo+cnt) match ranges by ONE tagged co-sort.

    Build and probe keys sort together with a tag that orders build rows
    before equal-keyed probe rows; a running build count and the count at
    each key run's start give, at every probe row, the number of equal
    build keys (cnt) and of valid build rows with smaller keys (lo, an index
    into :func:`build_sorted`'s row order).  Invalid rows fold into the key
    lane as a top sentinel or an extra tag value, so they never join a
    valid run.  ``fold_range``: optional (lo, hi) zone-map bound over BOTH
    sides' valid keys; with int32 headroom the merged lane stays int32.
    Returns (lo, cnt), int64 (npr,)."""
    nb = build_code.shape[0]
    npr = probe_code.shape[0]
    dev = build_code.device
    pidx = torch.cat([
        torch.full((nb,), npr, dtype=torch.int32, device=dev),  # builds last
        torch.arange(npr, dtype=torch.int32, device=dev)])
    key_ops, fold = _merge_lanes(build_code, build_invalid, probe_code,
                                 probe_invalid, fold_range)
    sorted_ = lexsort(key_ops + [pidx], len(key_ops) + 1)
    if fold == "tag":
        run_key, is_build = sorted_[0], sorted_[1] == 0
    else:
        run_key, is_build = sorted_[0] >> 1, (sorted_[0] & 1) == 0
    pidx_s = sorted_[-1]
    newflag = _bool_cat_first(run_key[1:] != run_key[:-1])
    cb = torch.cumsum(is_build.to(torch.int32), 0, dtype=torch.int32)
    run_base = _run_base(newflag, cb, is_build)
    cnt_elem = cb - run_base
    # restore probe order by a scatter (JAX sorts by pidx again: TPU scatters
    # serialize); every build element writes the spare slot npr
    lo = torch.empty(npr + 1, dtype=torch.int32, device=dev)
    cnt = torch.empty(npr + 1, dtype=torch.int32, device=dev)
    ix = pidx_s.to(torch.int64)
    lo.scatter_(0, ix, run_base)
    cnt.scatter_(0, ix, cnt_elem)
    cnt = torch.where(probe_invalid, 0, cnt[:npr])
    return lo[:npr].to(torch.int64), cnt.to(torch.int64)


def probe_counts_sorted(build_code, build_invalid, probe_code, probe_invalid,
                        fold_range=None, payloads=()):
    """Per-row match multiplicities left IN SORTED ORDER, for aggregates that
    reduce over matched pairs (a reduction needs no probe-order restore).

    ``payloads``: optional (nb+npr,) lanes in [build..., probe...] order that
    ride the sort.

    Returns (probe_ok, key_sorted, cnt_elem, build_ok, pcnt_elem,
    payloads_sorted): ``probe_ok`` marks valid probe rows, ``key_sorted`` is
    the probe key (original code space) there, ``cnt_elem`` the int32 count
    of matching valid build rows at probe elements, and ``build_ok`` /
    ``pcnt_elem`` the symmetric per-build-row count of matching probe rows.
    """
    key_ops, fold = _merge_lanes(build_code, build_invalid, probe_code,
                                 probe_invalid, fold_range)
    sorted_ = lexsort(key_ops + list(payloads), len(key_ops))
    pay_s = list(sorted_[len(key_ops):])
    key_s = sorted_[0]
    if fold == "i32":
        run_key = key_s >> 1
        is_build = (key_s & 1) == 0
        probe_ok = ((key_s & 1) == 1) & (key_s != I32_MAX)
        key_sorted = run_key + int(fold_range[0])
    elif fold == "i64":
        run_key = key_s >> 1
        is_build = (key_s & 1) == 0
        probe_ok = ((key_s & 1) == 1) & (key_s != INT64_MAX)
        key_sorted = run_key
    else:
        run_key = key_s
        is_build = sorted_[1] == 0
        probe_ok = sorted_[1] == 1
        key_sorted = key_s
    newflag = _bool_cat_first(run_key[1:] != run_key[:-1])
    cb = torch.cumsum(is_build.to(torch.int32), 0, dtype=torch.int32)
    run_base = _run_base(newflag, cb, is_build)
    cnt_elem = torch.where(probe_ok, cb - run_base, 0).to(torch.int32)

    # symmetric per-BUILD-row probe counts: probes before the run start
    # carried forward, and the run's LAST cumulative probe count filled
    # backward (run-end counts increase across runs, so the first seed at or
    # after a position is the minimum of the suffix)
    build_ok = is_build  # invalid rows sort into the tail sentinel run
    cp = torch.cumsum(probe_ok.to(torch.int32), 0, dtype=torch.int32)
    run_base_p = _run_base(newflag, cp, probe_ok)
    last_mask = torch.cat([newflag[1:], torch.ones(1, dtype=torch.bool,
                                                   device=newflag.device)])
    seed = torch.where(last_mask, cp, I32_MAX).to(torch.int32)
    run_end_cp = rev_cummin_i32(seed)
    pcnt_elem = torch.where(build_ok, run_end_cp - run_base_p,
                            0).to(torch.int32)
    return probe_ok, key_sorted, cnt_elem, build_ok, pcnt_elem, pay_s


def expand_matches(cnt, lo, sorted_rows, capacity: int):
    """Materialize (probe_row, build_row) pairs into a ``capacity``-slot
    buffer.  Slot arithmetic is int64; a total above ``capacity`` raises the
    overflow flag and the slots hold the first ``capacity`` pairs.

    Returns (probe_idx int32, build_row int32, out_valid, total int64 0-d,
    overflow)."""
    np_rows = cnt.shape[0]
    nb = sorted_rows.shape[0]
    dev = cnt.device
    cnt64 = cnt.to(torch.int64)
    ends = torch.cumsum(cnt64, 0)
    total = cnt64.sum()
    overflow = total > capacity
    slot = torch.arange(capacity, dtype=torch.int64, device=dev)
    # jnp.repeat's role: each slot's probe row is the first row whose
    # inclusive match count passes the slot
    pidx = torch.clamp(torch.searchsorted(ends, slot, right=True),
                       max=max(np_rows - 1, 0))
    out_valid = slot < total
    off = slot - (ends - cnt64)[pidx]
    bpos = torch.clamp(lo.to(torch.int64)[pidx] + off, 0, nb - 1)
    brow = sorted_rows[bpos]
    return pidx.to(torch.int32), brow, out_valid, total, overflow


def probe_counts(sorted_keys, n_build_valid, probe_code, probe_invalid):
    """Binary-search probe against :func:`build_sorted`'s keys: per probe
    row, the start ``lo`` of its match range and the match count.  The
    streamed join probes each chunk so against its resident build side.
    Returns (lo, cnt), int64."""
    nbv = torch.as_tensor(n_build_valid, dtype=torch.int64,
                          device=sorted_keys.device)
    code = probe_code.to(sorted_keys.dtype)
    lo = torch.minimum(torch.searchsorted(sorted_keys, code, side="left"), nbv)
    hi = torch.minimum(torch.searchsorted(sorted_keys, code, side="right"), nbv)
    cnt = torch.where(probe_invalid, 0, hi - lo)
    return lo, cnt


def direct_probe(sorted_keys, n_build_valid, kmin: int, kmax: int,
                 probe_code, probe_invalid):
    """Direct-address probe: zone-map statistics bound the build keys to
    [kmin, kmax], so every key's match-range start is precomputed into a
    dense offset table and a probe is two gathers instead of a binary
    search (the exact, collision-free counterpart of the reference's
    hash-table probe, ``join_kernels.cuh:115-166``).  ``kmin``/``kmax`` are
    host bounds.  Returns (lo, cnt), int64, as :func:`probe_counts`."""
    dev = sorted_keys.device
    span = int(kmax) - int(kmin) + 1
    nbv = torch.as_tensor(n_build_valid, dtype=torch.int64, device=dev)
    iota = (torch.arange(span + 1, dtype=torch.int64, device=dev)
            + int(kmin)).to(sorted_keys.dtype)
    lo_tab = torch.minimum(
        torch.searchsorted(sorted_keys, iota, side="left"), nbv)
    rel = probe_code.to(torch.int64) - int(kmin)
    in_range = (rel >= 0) & (rel < span) & ~probe_invalid
    rel_c = torch.clamp(rel, 0, span - 1)
    lo = lo_tab[rel_c]
    cnt = torch.where(in_range, lo_tab[rel_c + 1] - lo, 0)
    return lo, cnt


def dense_probe(kmin: int, kmax: int, probe_code, probe_invalid):
    """Slot positions and in-range flags for probing dense [kmin, kmax]
    tables.  Range-tests BEFORE subtracting, so no intermediate overflows."""
    span = int(kmax) - int(kmin) + 1
    if probe_code.dtype == torch.int32 and span <= I32_MAX:
        inr = (probe_code >= kmin) & (probe_code <= kmax) & ~probe_invalid
        rel_c = torch.clamp(probe_code, kmin, kmax) - kmin
    else:
        rel = probe_code.to(torch.int64) - int(kmin)
        inr = (rel >= 0) & (rel < span) & ~probe_invalid
        rel_c = torch.clamp(rel, 0, span - 1)
    return rel_c, inr


def lookup_slots(build_code, build_invalid, kmin: int, kmax: int,
                 probe_code, probe_invalid):
    """Dense key->row table and probe slot positions for a unique-key build.

    Returns (dense_row [span] int32 with -1 for an empty slot; rel_c
    [n_probe], each probe row's clipped slot; inr bool [n_probe],
    in-range-and-valid).  The table is a scatter (JAX fills it with a
    scatter-free merge probe because TPU scatters serialize); where keys
    repeat, the slot keeps the smallest build row, as the merge probe's
    first match does."""
    nb = build_code.shape[0]
    dev = build_code.device
    span = int(kmax) - int(kmin) + 1
    rel = build_code.to(torch.int64) - int(kmin)
    ok = ~build_invalid & (rel >= 0) & (rel < span)
    ix = torch.where(ok, rel, span)  # the spare slot span swallows the rest
    dense = torch.full((span + 1,), I32_MAX, dtype=torch.int32, device=dev)
    dense.scatter_reduce_(0, ix, torch.arange(nb, dtype=torch.int32,
                                              device=dev), reduce="amin")
    dense_row = torch.where(dense[:span] == I32_MAX, -1, dense[:span])
    rel_c, inr = dense_probe(kmin, kmax, probe_code, probe_invalid)
    return dense_row.to(torch.int32), rel_c, inr


def lookup_join(build_code, build_invalid, kmin: int, kmax: int,
                probe_code, probe_invalid):
    """Expansion-free join against a unique-key build side: a dense
    key->row table and one gather per probe row.
    Returns (ri, matched): per probe row the matching build row or -1."""
    dense_row, rel_c, inr = lookup_slots(
        build_code, build_invalid, kmin, kmax, probe_code, probe_invalid)
    ri = torch.where(inr, dense_row[rel_c], -1).to(torch.int32)
    return ri, ri >= 0


def inner_join(left_keys, left_rowvalid, right_keys, right_rowvalid,
               capacity: int, single_key_fast: bool = True,
               fold_range=None, build_presorted: bool = False):
    """Inner equi-join, probe = left, build = right.

    Returns (left_idx, right_idx, out_valid, total, overflow, cnt)."""
    lcode, linv, rcode, rinv = _prepare_codes(
        left_keys, left_rowvalid, right_keys, right_rowvalid, single_key_fast)
    _sk, srow, _nbv = build_sorted(rcode, rinv,
                                   presorted=build_presorted
                                   and len(right_keys) == 1)
    lo, cnt = probe_ranges_merge(rcode, rinv, lcode, linv,
                                 fold_range=fold_range)
    return expand_matches(cnt, lo, srow, capacity) + (cnt,)


def _prepare_codes(left_keys, left_rowvalid, right_keys, right_rowvalid,
                   single_key_fast):
    """One key column per side; several are densified first."""
    if single_key_fast and len(left_keys) == 1:
        lcode, lnull = left_keys[0]
        rcode, rnull = right_keys[0]
        linv = lnull if left_rowvalid is None else (lnull | ~left_rowvalid)
        rinv = rnull if right_rowvalid is None else (rnull | ~right_rowvalid)
        return lcode, linv, rcode, rinv
    lcode, rcode = densify_keys(left_keys, left_rowvalid, right_keys,
                                right_rowvalid)
    # invalidity is already folded into disjoint codes; only row validity
    # matters for emission
    dev = lcode.device
    nl, nr = lcode.shape[0], rcode.shape[0]
    linv = (torch.zeros(nl, dtype=torch.bool, device=dev)
            if left_rowvalid is None else ~left_rowvalid)
    rinv = (torch.zeros(nr, dtype=torch.bool, device=dev)
            if right_rowvalid is None else ~right_rowvalid)
    return lcode, linv, rcode, rinv


def _compact_rows(flag: torch.Tensor):
    """Row ids where ``flag`` holds, in order, as a -1-padded int64 prefix
    (a stable sort: no device sync); returns (rows, n_set)."""
    n = flag.shape[0]
    perm = torch.sort((~flag).to(torch.int8), stable=True).indices
    n_set = flag.sum(dtype=torch.int64)
    arange = torch.arange(n, device=flag.device)
    return torch.where(arange < n_set, perm, -1), n_set


def outer_extend(join_type: str, li, ri, out_valid, total, cnt,
                 left_rowvalid, right_rowvalid, nl: int, nr: int):
    """Append unmatched rows for left/right/full joins.

    The matched buffer (li, ri, out_valid) grows by ``nl`` (left/full)
    and/or ``nr`` (right/full) slots holding the unmatched rows as a
    compacted prefix; -1 marks the null-padded side.
    Returns (li int64, ri int64, out_valid, total)."""
    dev = out_valid.device
    parts_li = [li.to(torch.int64)]
    parts_ri = [ri.to(torch.int64)]
    parts_valid = [out_valid]

    if join_type in ("left", "full"):
        lvalid = (torch.ones(nl, dtype=torch.bool, device=dev)
                  if left_rowvalid is None else left_rowvalid)
        slot_rows, n_un = _compact_rows((cnt == 0) & lvalid)
        parts_li.append(slot_rows)
        parts_ri.append(torch.full((nl,), -1, dtype=torch.int64, device=dev))
        parts_valid.append(torch.arange(nl, device=dev) < n_un)
        total = total + n_un

    if join_type in ("right", "full"):
        rvalid = (torch.ones(nr, dtype=torch.bool, device=dev)
                  if right_rowvalid is None else right_rowvalid)
        # matched flags by a scatter of the emitted right rows (JAX runs a
        # merge probe: TPU scatters serialize); the spare slot nr swallows
        # empty slots
        hit = torch.zeros(nr + 1, dtype=torch.bool, device=dev)
        emitted = torch.where(out_valid, ri.to(torch.int64), nr)
        hit[emitted] = True
        slot_rows, n_un = _compact_rows(~hit[:nr] & rvalid)
        parts_li.append(torch.full((nr,), -1, dtype=torch.int64, device=dev))
        parts_ri.append(slot_rows)
        parts_valid.append(torch.arange(nr, device=dev) < n_un)
        total = total + n_un

    return (torch.cat(parts_li), torch.cat(parts_ri), torch.cat(parts_valid),
            total)


def inner_join_stream(lcode, linv, rcode, rinv, capacity: int, fold_range,
                      probe_payloads=(), emit_key: bool = False,
                      need_ri: bool = True):
    """Inner equi-join emitting pairs in merge-sorted order, on the
    ``stream_compact`` and ``expand_fill`` kernels.

    Probe row ids, the join key and int32 probe payload columns ride the
    tagged co-sort and come out of the expansion as fills; only ``need_ri``
    (a non-key build column is referenced) gathers build row ids.  Requires
    int32 keys whose ``fold_range`` folds into an int32 key+tag lane, and
    ``capacity < 2^31 - 1``.  Returns a dict: li (int32 fill), ri (int32
    gather | None), key (int32 fill | None), payloads ([int32 fills]),
    out_valid, total (int64 0-d), overflow."""
    from .kernels.join_stream import expand_fill_i32, stream_compact_i32

    capacity = int(capacity)
    if capacity >= I32_MAX:
        raise ValueError(f"join capacity {capacity} does not fit int32 slots")
    nb = rcode.shape[0]
    npr = lcode.shape[0]
    dev = lcode.device
    lo32 = int(fold_range[0])

    # ---- tagged co-sort: ONE int32 key lane + int32 payload lanes ---------
    key = (torch.cat([rcode, lcode]) - lo32) * 2
    key = key + torch.cat([torch.zeros(nb, dtype=torch.int32, device=dev),
                           torch.ones(npr, dtype=torch.int32, device=dev)])
    key = torch.where(torch.cat([rinv, linv]), I32_MAX, key)
    rowid = torch.cat([torch.arange(nb, dtype=torch.int32, device=dev),
                       torch.arange(npr, dtype=torch.int32, device=dev)])
    zb = torch.zeros(nb, dtype=torch.int32, device=dev)
    lanes = [key, rowid] + [torch.cat([zb, p]) for p in probe_payloads]
    # (key, rowid) is unique over valid elements: a total order
    sorted_lanes = lexsort(lanes, 2)
    key_s, rowid_s = sorted_lanes[0], sorted_lanes[1]
    payload_s = sorted_lanes[2:]

    valid_e = key_s != I32_MAX
    is_build = ((key_s & 1) == 0) & valid_e
    is_probe = ((key_s & 1) == 1) & valid_e
    run_key = key_s >> 1
    newflag = _bool_cat_first(run_key[1:] != run_key[:-1])
    cb = torch.cumsum(is_build.to(torch.int32), 0, dtype=torch.int32)
    run_base = _run_base(newflag, cb, is_build)
    pm = torch.where(is_probe, cb - run_base, 0).to(torch.int32)
    ends = torch.cumsum(pm, 0, dtype=torch.int64)
    total = ends[-1]
    overflow = total > capacity
    # run starts in int64, then int32: a start past 2^31 - 2 exists only when
    # the total overflows the capacity, and becomes a pad record
    starts = torch.clamp(ends - pm, max=I32_MAX).to(torch.int32)

    # ---- compact match records (+ build rows when ri is needed) -----------
    rec_streams = [starts, rowid_s]
    if emit_key:
        rec_streams.append(run_key + lo32)
    if need_ri:
        rec_streams.append(run_base)               # lo: build run start
    rec_streams.extend(payload_s)
    compacted, n_rec = stream_compact_i32(pm > 0, rec_streams, npr)
    if need_ri:
        (b_rows,), _nbv = stream_compact_i32(is_build, [rowid_s], nb)

    # records past n_rec become pads
    ridx = torch.arange(npr, dtype=torch.int32, device=dev)
    rec_start = torch.where(ridx < n_rec, compacted[0], I32_MAX)
    fills = expand_fill_i32(rec_start, compacted[1:], capacity)
    off, pid_f = fills[0], fills[1]
    pos = 2
    key_f = None
    if emit_key:
        key_f = fills[pos]
        pos += 1
    ri = None
    if need_ri:
        bpos = torch.clamp(fills[pos] + off, 0, nb - 1)
        ri = b_rows[bpos]
        pos += 1
    out_valid = torch.arange(capacity, dtype=torch.int64, device=dev) < total
    return {"li": pid_f, "ri": ri, "key": key_f, "payloads": fills[pos:],
            "out_valid": out_valid, "total": total, "overflow": overflow}
