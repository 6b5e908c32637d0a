"""Times two versions of the filter_agg and seg_agg kernels in one run.

    python3 chip_kernel_ab.py OLD_CSRC_DIR [--reps N]

OLD_CSRC_DIR holds another version's ``filter_agg.cu`` and ``seg_agg.cu``
with the C interface they had before the one-pass redesign (outputs filled
by the caller; seg_agg with two tile-scratch arrays).  Both are built with
the package's nvcc flags beside the package's own kernels, checked against
the plain versions, then timed at the bench shapes (200M rows; 100M rows x
4M groups, max_groups 2^23) in turns old, new, new, old, N times, with
CUDA events and each version's own output allocation and fills inside the
timed call, as its wrapper does.  Prints one JSON line per timing round and
the card's name and power limit.  Needs one NVIDIA GPU and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

import torch

from chip_smoke import (FILTER_ROWS, GROUPBY_GROUPS, GROUPBY_ROWS, _card,
                        _cuda_ms, _max_abs_err)

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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("old_csrc")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_kernel_ab: CUDA is not available", file=sys.stderr)
        return 1
    from gpu_olap_tpu_torch.ops.kernels import _build
    from gpu_olap_tpu_torch.ops.kernels.filter_agg import (
        filter_agg_i32, filter_agg_plain)
    from gpu_olap_tpu_torch.ops.kernels.seg_agg import (
        seg_agg_plain, seg_agg_sorted_i32)
    from gpu_olap_tpu_torch.ops.sort import lexsort

    card = _card()
    print(card, flush=True)
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
