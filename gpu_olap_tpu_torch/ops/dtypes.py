"""Device dtype helpers: order codes, sentinels, masked values.

Port of ``gpu_olap_tpu/ops/dtypes.py`` on torch tensors.  Shared by the sort
and aggregate operators.
"""

from __future__ import annotations

import numpy as np
import torch

INT64_MIN = int(np.iinfo(np.int64).min)
INT64_MAX = int(np.iinfo(np.int64).max)
_I32_MIN = int(np.iinfo(np.int32).min)
_I32_MAX = int(np.iinfo(np.int32).max)


def order_code(data: torch.Tensor, np_kind: str) -> torch.Tensor:
    """Map a column to a sort operand whose ascending order == SQL ordering.

    Floats stay float64 (the sort orders them, NaN last).  Ints are clipped
    by 2 so descending negation and null sentinels cannot overflow (the CPU
    oracle's contract); int32 operands keep their width."""
    if np_kind == "f":
        return data.to(torch.float64)
    if data.dtype == torch.int32:
        return torch.clamp(data, _I32_MIN + 2, _I32_MAX - 2)
    return torch.clamp(data.to(torch.int64), INT64_MIN + 2, INT64_MAX - 2)


def key_code(data: torch.Tensor, validity, np_kind: str):
    """Exact join/group key encoding: (operand, null_flag).

    Floats stay float64 with -0.0 normalized to 0.0 and NaN turned into a
    null (SQL: -0.0 == 0.0, NaN groups with NULL); ints widen to int64.
    Nullness is a separate flag so every value stays a legal key."""
    if np_kind == "f":
        f = data.to(torch.float64)
        f = torch.where(f == 0.0, 0.0, f)
        isnan = torch.isnan(f)
        codes = torch.where(isnan, 0.0, f)
        nulls = isnan if validity is None else (isnan | ~validity)
    else:
        codes = data.to(torch.int64)
        nulls = None if validity is None else ~validity
    if nulls is None:
        nulls = torch.zeros(data.shape, dtype=torch.bool, device=data.device)
    return codes, nulls


def key_fill(dtype) -> object:
    """Neutral fill for unused key slots, matching the operand space."""
    if dtype.is_floating_point:
        return float("-inf")
    return torch.iinfo(dtype).min


def key_top(dtype) -> object:
    """Sentinel greater than every valid key, matching the operand space."""
    if dtype.is_floating_point:
        return float("inf")
    return torch.iinfo(dtype).max


def masked_fill(data: torch.Tensor, mask: torch.Tensor, fill) -> torch.Tensor:
    """Replace entries where mask is False with ``fill``."""
    return torch.where(mask, data, torch.tensor(fill, dtype=data.dtype,
                                                device=data.device))


def torch_dtype(np_dtype) -> torch.dtype:
    """The torch dtype of a numpy dtype (the columnar layer's physical types)."""
    return {np.dtype(np.int64): torch.int64, np.dtype(np.int32): torch.int32,
            np.dtype(np.float64): torch.float64,
            np.dtype(np.bool_): torch.bool}[np.dtype(np_dtype)]
