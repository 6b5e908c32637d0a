"""Times versions of a kernel against each other in one run on one card.

    python3 chip_kernel_ab.py OLD_CSRC_DIR [--reps N]
    python3 chip_kernel_ab.py OLD_CSRC_DIR --kernel radix_hist [--reps N]

filter_agg and seg_agg (the default): OLD_CSRC_DIR holds another version's
``filter_agg.cu`` and ``seg_agg.cu`` with the C interface they had before
the one-pass redesign (outputs filled by the caller; seg_agg with two
tile-scratch arrays).  Both are built with the package's nvcc flags beside
the package's own kernels, checked against the plain versions, then timed
at the bench shapes (200M rows; 100M rows x 4M groups, max_groups 2^23) in
turns old, new, new, old, N times.

radix_hist: OLD_CSRC_DIR holds another version's ``radix_hist.cu``, with
either the C interface it had before the packed-counter redesign (keys, n,
shift, a zero-filled int64 output, stream) or the package's own (scratch
and a block counter; the file exports ``olap_radix_hist_scratch_bytes``).
It is built into its own library and timed against the package's kernel at
three shapes: BASELINE config 5's 33,554,432 partition ids over 8 shards
and over 1 shard (every key in bin 0), and 200M random int32 keys at shifts
0, 8, 16 and 24; in turns old, new, new, old, N times.  Both versions are
first checked exactly against the plain version at every shape, and each
version's ``ptxas`` line (registers, static shared memory, spills) is
printed.  The last line holds, at each shape, each version's median beside
the bound (4 bytes a key read once at the card's memory rate from
``utils.metrics``), the median gap between
its two times in one round (its spread against itself), the median of the
rounds' new-minus-old gaps, and the rounds in which new was the faster.

Times are CUDA events over repeated calls, with each version's own output
allocation and fills inside the timed call, as its wrapper does.  Prints
one JSON line per timing round and the card's name and power limit.  Needs
one NVIDIA GPU and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
import tempfile

import torch

from bench_dist_torch import config5_data
from chip_smoke import (DIST_ROWS_PER_SHARD, DIST_SHARDS, FILTER_ROWS,
                        GROUPBY_GROUPS, GROUPBY_ROWS, RADIX_ROWS, _bound_ms,
                        _card, _cuda_ms, _max_abs_err)

I32_MIN, I32_MAX = -(1 << 31), (1 << 31) - 1
MAX_GROUPS = 1 << 23


def _old_library(csrc: str, out_dir: str):
    from gpu_olap_tpu_torch.ops.kernels import _build

    so = os.path.join(out_dir, "libold.so")
    srcs = [os.path.join(csrc, f) for f in ("filter_agg.cu", "seg_agg.cu")]
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", so,
                    *srcs], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(so)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.olap_filter_agg_i32.argtypes = [p, p, i, i, i, ctypes.c_longlong,
                                        ctypes.c_uint, ctypes.c_uint,
                                        p, p, p, p, p]
    lib.olap_seg_agg_tile_rows.restype = i
    lib.olap_seg_agg_i32.argtypes = [p, p, ctypes.c_longlong, i] + [p] * 9
    return lib


def _old_filter_agg(lib, v):
    """The old wrapper: four filled outputs, then the launch."""
    dev = v.device
    count = torch.zeros(1, dtype=torch.int64, device=dev)
    sums = torch.zeros(1, dtype=torch.int64, device=dev)
    mins = torch.full((1,), I32_MAX, dtype=torch.int32, device=dev)
    maxs = torch.full((1,), I32_MIN, dtype=torch.int32, device=dev)
    ptrs = (ctypes.c_void_p * 1)(v.data_ptr())
    err = lib.olap_filter_agg_i32(
        v.data_ptr(), ptrs, 1, 0, 500, v.shape[0], 1, 1, count.data_ptr(),
        sums.data_ptr(), mins.data_ptr(), maxs.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    assert err == 0, err
    return count[0], [(sums[0], mins[0], maxs[0])]


def _old_seg_agg(lib, k, v, mg):
    """The old wrapper: zeroed outputs and tile scratch, then the launch."""
    dev = k.device
    n = k.shape[0]
    n_tiles = -(-n // lib.olap_seg_agg_tile_rows())
    scratch = torch.empty(2 * n_tiles, dtype=torch.int32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    outs = (torch.zeros(mg, **i32), torch.zeros(mg, **i32),
            torch.zeros(mg, dtype=torch.int64, device=dev),
            torch.zeros(mg, **i32), torch.zeros(mg, **i32))
    ng = torch.zeros((), **i32)
    err = lib.olap_seg_agg_i32(
        k.data_ptr(), v.data_ptr(), n, mg, scratch.data_ptr(),
        scratch[n_tiles:].data_ptr(), *[o.data_ptr() for o in outs],
        ng.data_ptr(), torch.cuda.current_stream().cuda_stream)
    assert err == 0, err
    return (*outs, ng)


def _ab_filter_seg(args, card: str) -> None:
    from gpu_olap_tpu_torch.ops.kernels import _build
    from gpu_olap_tpu_torch.ops.kernels.filter_agg import (
        filter_agg_i32, filter_agg_plain)
    from gpu_olap_tpu_torch.ops.kernels.seg_agg import (
        seg_agg_plain, seg_agg_sorted_i32)
    from gpu_olap_tpu_torch.ops.sort import lexsort

    dev = torch.device("cuda", 0)
    _build.load()
    with tempfile.TemporaryDirectory() as tmp:
        old = _old_library(args.old_csrc, tmp)
        gen = torch.Generator(device=dev).manual_seed(0)
        v = torch.randint(0, 1000, (FILTER_ROWS,), generator=gen, device=dev,
                          dtype=torch.int32)
        exp = filter_agg_plain(v, "gt", 500, (v,))
        errs = {"filter_agg_old": _max_abs_err(_old_filter_agg(old, v), exp),
                "filter_agg_new": _max_abs_err(
                    filter_agg_i32(v, "gt", 500, (v,)), exp)}
        gen = torch.Generator(device=dev).manual_seed(1)
        k = torch.randint(0, GROUPBY_GROUPS, (GROUPBY_ROWS,), generator=gen,
                          device=dev, dtype=torch.int32)
        val = torch.randint(0, 1_000_000, (GROUPBY_ROWS,), generator=gen,
                            device=dev, dtype=torch.int32)
        sk, sv = lexsort([k, val], 2)
        del k, val
        exp = seg_agg_plain(sk, sv, MAX_GROUPS)
        errs["seg_agg_old"] = _max_abs_err(
            _old_seg_agg(old, sk, sv, MAX_GROUPS), exp)
        errs["seg_agg_new"] = _max_abs_err(
            seg_agg_sorted_i32(sk, sv, MAX_GROUPS), exp)
        del exp
        torch.cuda.synchronize()
        print(json.dumps({"exact": errs}), flush=True)
        if any(errs.values()):
            raise AssertionError(f"a version differs from plain: {errs}")
        fns = {"filter_agg_old": lambda: _old_filter_agg(old, v),
               "filter_agg_new": lambda: filter_agg_i32(v, "gt", 500, (v,)),
               "seg_agg_old": lambda: _old_seg_agg(old, sk, sv, MAX_GROUPS),
               "seg_agg_new": lambda: seg_agg_sorted_i32(sk, sv, MAX_GROUPS)}
        for rnd in range(args.reps):
            row = {"round": rnd, "card": card}
            for name in ("filter_agg", "seg_agg"):
                for tag in ("old", "new", "new", "old"):
                    row.setdefault(f"{name}_{tag}_ms", []).append(
                        _cuda_ms(fns[f"{name}_{tag}"], 10))
            print(json.dumps(row), flush=True)


# ---------------------------------------------------------------------------
# radix_hist
# ---------------------------------------------------------------------------

def _radix_library(src: str, out_dir: str):
    """The old source built into its own library (its symbols stay local
    to it), with its ``ptxas`` rows; ``lib.scratch`` tells the package's C
    interface from the one before it."""
    from gpu_olap_tpu_torch.ops.kernels import _build

    nvcc = _build._nvcc()
    objs = _build._compile_objects(nvcc, [src], out_dir)
    so = os.path.join(out_dir, "libold_radix.so")
    _build._run_all([[nvcc, *_build.NVCC_FLAGS, "-shared", "-o", so, *objs]])
    lib = ctypes.CDLL(so)
    p = ctypes.c_void_p
    lib.scratch = hasattr(lib, "olap_radix_hist_scratch_bytes")
    if lib.scratch:
        lib.olap_radix_hist_scratch_bytes.restype = ctypes.c_longlong
    lib.olap_radix_hist_i32.argtypes = [p, ctypes.c_longlong, ctypes.c_int,
                                        *([p, p] if lib.scratch else []), p, p]
    lib.olap_radix_hist_i32.restype = ctypes.c_int
    return lib, _build.ptxas_report(os.path.join(out_dir, _build.PTXAS_LOG))


def _old_radix(lib, keys, shift):
    """The old wrapper: with the package's interface scratch and the
    stream's block counter, else a zero-filled output; then the launch."""
    from gpu_olap_tpu_torch.ops.kernels import _build

    if keys.dtype != torch.int32 or keys.dim() != 1 or not 0 <= shift <= 31:
        raise ValueError("radix_histogram takes int32 (n,) keys, shift 0-31")
    if not keys.is_contiguous():
        raise ValueError("radix_histogram takes a contiguous tensor")
    dev = keys.device
    with torch.cuda.device(dev):
        cur = torch.cuda.current_stream(dev)
        if lib.scratch:
            hist = torch.empty(256, dtype=torch.int64, device=dev)
            scratch = torch.empty(lib.olap_radix_hist_scratch_bytes(),
                                  dtype=torch.uint8, device=dev)
            extra = (scratch.data_ptr(),
                     _build.done_counter(dev, cur).data_ptr())
        else:
            hist = torch.zeros(256, dtype=torch.int64, device=dev)
            extra = ()
        err = lib.olap_radix_hist_i32(keys.data_ptr(), keys.shape[0], shift,
                                      *extra, hist.data_ptr(),
                                      cur.cuda_stream)
    _build.check(err, "old radix_hist launch")
    return hist


def _radix_shapes(dev):
    """(name, keys, shifts): config 5's partition ids over 1 and 8 shards
    (``chip_smoke.py``'s uniform probe keys), then 200M random keys."""
    from gpu_olap_tpu_torch.ops.hashing import partition_of

    _, lk, *_ = config5_data(DIST_SHARDS * DIST_ROWS_PER_SHARD, False)
    lk_d = torch.from_numpy(lk).to(dev)
    shapes = [("one_bin", partition_of(lk_d, 1), (0,)),
              ("eight_bins", partition_of(lk_d, DIST_SHARDS), (0,))]
    del lk_d
    gen = torch.Generator(device=dev).manual_seed(5)
    keys = torch.randint(I32_MIN, I32_MAX, (RADIX_ROWS,), generator=gen,
                         device=dev, dtype=torch.int32)
    shapes.append(("spread_200m", keys, (0, 8, 16, 24)))
    return shapes


def _ab_radix(args, card: str) -> None:
    from gpu_olap_tpu_torch.ops.kernels import _build
    from gpu_olap_tpu_torch.ops.kernels import partition as rp

    dev = torch.device("cuda", 0)
    _build.load()
    ptxas = {"new": [r for r in _build.ptxas_report()
                     if r["source"] == "radix_hist.cu"]}
    with tempfile.TemporaryDirectory() as tmp:
        old, ptxas["old"] = _radix_library(
            os.path.join(args.old_csrc, "radix_hist.cu"), tmp)
        fns = {"old": lambda k, s: _old_radix(old, k, s),
               "new": rp.radix_histogram_i32}
        print(json.dumps({"ptxas": ptxas, "old_interface": (
            "package" if old.scratch else "zero-filled output")}), flush=True)
        shapes = _radix_shapes(dev)
        errs = {}
        for shape, keys, shifts in shapes:
            for shift in shifts:
                exp = rp.radix_histogram_plain(keys, shift)
                for name, fn in fns.items():
                    # twice: the second call shows the block counter reset
                    for _ in range(2):
                        errs[name] = max(errs.get(name, 0),
                                         _max_abs_err(fn(keys, shift), exp))
        torch.cuda.synchronize()
        print(json.dumps({"exact": errs}), flush=True)
        if any(errs.values()):
            raise AssertionError(f"a version differs from plain: {errs}")
        rounds = {shape: [] for shape, _, _ in shapes}
        for rnd in range(args.reps):
            for shape, keys, shifts in shapes:
                for shift in shifts:
                    row = {"round": rnd, "card": card, "shape": shape,
                           "shift": shift, "old_ms": [], "new_ms": []}
                    for name in ("old", "new", "new", "old"):
                        row[f"{name}_ms"].append(_cuda_ms(
                            lambda: fns[name](keys, shift), 20))
                    rounds[shape].append(row)
                    print(json.dumps(row), flush=True)
        med = statistics.median
        summary = {}
        for shape, keys, _ in shapes:
            bound = _bound_ms(keys.shape[0] * 4 + 256 * 8)
            rows = rounds[shape]
            gaps = [sum(r["new_ms"]) / 2 - sum(r["old_ms"]) / 2 for r in rows]
            summary[shape] = {"keys": keys.shape[0], "bound_ms": bound,
                              "new_minus_old_median_ms": med(gaps),
                              "new_faster_rounds": sum(g < 0 for g in gaps),
                              "rounds": len(rows)}
            for name in ("old", "new"):
                times = [ms for r in rows for ms in r[f"{name}_ms"]]
                summary[shape][f"{name}_median_ms"] = med(times)
                summary[shape][f"{name}_share_of_bound"] = bound / med(times)
                summary[shape][f"{name}_self_gap_median_ms"] = med(
                    abs(r[f"{name}_ms"][0] - r[f"{name}_ms"][1]) for r in rows)
        print(card, flush=True)
        print(json.dumps({"card": card, "median": summary}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("old_csrc")
    ap.add_argument("--kernel", choices=("filter_seg", "radix_hist"),
                    default="filter_seg")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_kernel_ab: CUDA is not available", file=sys.stderr)
        return 1
    card = _card()
    print(card, flush=True)
    if args.kernel == "radix_hist":
        _ab_radix(args, card)
    else:
        _ab_filter_seg(args, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
