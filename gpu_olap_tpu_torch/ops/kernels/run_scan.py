"""Running max and reversed running min over int32 (kernel ``run_scan``).

The sorted-space join's run fills.  In the JAX package they are XLA scans,
not Pallas kernels: ``jax.lax.cummax`` (``gpu_olap_tpu/ops/join.py:192``,
``:278``, ``:289``, ``:578``) and ``jnp.flip(jax.lax.cummin(jnp.flip(x)))``
(``:295``).  ``cummax_i32`` and ``rev_cummin_i32`` launch
``csrc/run_scan.cu`` for CUDA tensors; for CPU tensors they run
``cummax_plain`` / ``rev_cummin_plain``, the plain PyTorch versions.
"""

from __future__ import annotations

import torch

from . import _build


def cummax_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`cummax_i32`."""
    return torch.cummax(x, 0).values


def rev_cummin_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`rev_cummin_i32`."""
    return torch.flip(torch.cummin(torch.flip(x, [0]), 0).values, [0])


def _scan(x: torch.Tensor, reverse: bool, plain, what: str) -> torch.Tensor:
    if x.dtype != torch.int32 or x.dim() != 1:
        raise ValueError(f"{what} takes an int32 (n,) tensor")
    if not x.is_contiguous():
        raise ValueError(f"{what} takes a contiguous tensor")
    dev = x.device
    if dev.type == "cpu":
        return plain(x)
    if dev.type != "cuda":
        raise ValueError(f"{what} has no kernel for {dev}")
    out = torch.empty_like(x)
    n = x.shape[0]
    if n == 0:
        return out
    lib = _build.load()
    n_tiles = -(-n // lib.olap_run_scan_tile())
    with torch.cuda.device(dev):
        # tile status words and the tile counter, all zero
        scratch = torch.zeros(n_tiles + 1, dtype=torch.int64, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.olap_run_scan_i32(x.data_ptr(), out.data_ptr(), n,
                                    int(reverse), scratch.data_ptr(), stream)
    _build.check(err, f"{what} launch")
    _build.launches["run_scan"] += 1
    return out


def cummax_i32(x: torch.Tensor) -> torch.Tensor:
    """``y[i] = max(x[0..i])`` over a contiguous int32 (n,) tensor, exact:
    ``torch.cummax(x, 0).values``."""
    return _scan(x, False, cummax_plain, "cummax_i32")


def rev_cummin_i32(x: torch.Tensor) -> torch.Tensor:
    """``y[i] = min(x[i..n-1])`` over a contiguous int32 (n,) tensor,
    exact, read from the end with no flipped copies."""
    return _scan(x, True, rev_cummin_plain, "rev_cummin_i32")
