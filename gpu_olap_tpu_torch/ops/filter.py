"""Filter helpers: row-validity masks and stable compaction.

Port of ``gpu_olap_tpu/ops/filter.py``.  Filters carry row-validity masks;
compaction to dense rows happens only at the host boundary.
"""

from __future__ import annotations

from typing import Optional

import torch


def combine_mask(row_valid: Optional[torch.Tensor], pred_data, pred_valid):
    """AND a predicate result (SQL TRUE only: value & not-null) into a row mask."""
    mask = pred_data.to(torch.bool)
    if pred_valid is not None:
        mask = mask & pred_valid
    if row_valid is not None:
        mask = mask & row_valid
    return mask


def compaction_indices(mask: torch.Tensor):
    """Stable compaction permutation: returns (gather_idx, count).

    ``gather_idx[i]`` is the source row for dense slot i; slots >= count hold
    the masked-out rows, in order."""
    inv = (~mask).to(torch.int8)
    gather_idx = torch.sort(inv, stable=True).indices
    count = mask.sum(dtype=torch.int64)
    return gather_idx, count


def compact_column(data, mask_gather_idx, count):
    """Gather a column into dense prefix order."""
    return data[mask_gather_idx]
