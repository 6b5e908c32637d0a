"""Radix histogram over int32 keys (kernel ``radix_hist``).

Port of ``gpu_olap_tpu/ops/pallas/partition.py``.  ``radix_histogram_i32``
launches ``csrc/radix_hist.cu`` for CUDA tensors; for CPU tensors it runs
``radix_histogram_plain``, the plain PyTorch version with the same output.
"""

from __future__ import annotations

import torch

from . import _build

BINS = 256


def radix_histogram_plain(keys: torch.Tensor, shift: int = 0) -> torch.Tensor:
    """Plain PyTorch version of :func:`radix_histogram_i32`."""
    return torch.bincount(((keys >> shift) & (BINS - 1)).long(),
                          minlength=BINS)


def radix_histogram_i32(keys: torch.Tensor, shift: int = 0) -> torch.Tensor:
    """256-bin histogram of ``(key >> shift) & 0xFF`` over an int32 array.

    The shift is arithmetic, as on JAX's int32, so negative keys land in a
    bin like any other.  Returns exact int64 counts (256,)."""
    if keys.dtype != torch.int32 or keys.dim() != 1:
        raise ValueError("radix_histogram takes an int32 (n,) tensor")
    shift = int(shift)
    if not 0 <= shift <= 31:
        raise ValueError(f"shift must be in [0, 31], got {shift}")
    dev = keys.device
    if dev.type == "cpu":
        return radix_histogram_plain(keys, shift)
    if dev.type != "cuda":
        raise ValueError(f"radix_histogram has no kernel for {dev}")
    if not keys.is_contiguous():
        raise ValueError("radix_histogram takes a contiguous tensor")
    n = keys.shape[0]
    if n == 0:
        return torch.zeros(BINS, dtype=torch.int64, device=dev)
    lib = _build.load()
    # nothing is pre-filled: the kernel's last block writes all 256 counts
    hist = torch.empty(BINS, dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        scratch = torch.empty(lib.olap_radix_hist_scratch_bytes(),
                              dtype=torch.uint8, device=dev)
        cur = torch.cuda.current_stream(dev)
        err = lib.olap_radix_hist_i32(keys.data_ptr(), n, shift,
                                      scratch.data_ptr(),
                                      _build.done_counter(dev, cur).data_ptr(),
                                      hist.data_ptr(), cur.cuda_stream)
    _build.check(err, "radix_hist launch")
    _build.launches["radix_hist"] += 1
    return hist


def partition_offsets(hist: torch.Tensor) -> torch.Tensor:
    """Exclusive prefix sum over bins: each partition's offset."""
    return torch.cumsum(hist, 0) - hist
