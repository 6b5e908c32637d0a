"""Multi-key ORDER BY and the lexicographic sort helper.

Port of ``gpu_olap_tpu/ops/sort.py``.  JAX sorts several operands at once
with ``lax.sort(..., num_keys=k)``; ``torch.sort`` takes one key, so
:func:`lexsort` builds the multi-key sort from it.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

_LOW32 = 0xFFFFFFFF
_BIAS32 = 1 << 31


def _pack_i32_pair(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """Two int32 lanes as one int64 whose signed order is the pair's
    lexicographic order.  The low word is biased (``v ^ 0x80000000``, i.e.
    ``v + 2^31``) into [0, 2^32) or negative values would mis-order."""
    return (hi.to(torch.int64) << 32) | (lo.to(torch.int64) + _BIAS32)


def _unpack_i32_pair(packed: torch.Tensor):
    hi = (packed >> 32).to(torch.int32)
    lo = ((packed & _LOW32) - _BIAS32).to(torch.int32)
    return hi, lo


def lexsort_permutation(keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """Stable permutation ordering rows by ``keys[0]``, then ``keys[1]``, ...

    Equal key tuples keep their input order.  Floats order as ``torch.sort``
    orders them: -0.0 == 0.0 and NaN after every number.  Two int32 keys
    sort as one packed int64 key; otherwise one stable pass per key, from the
    last key to the first (least-significant-digit order)."""
    n = keys[0].shape[0]
    dev = keys[0].device
    if len(keys) == 2 and all(k.dtype == torch.int32 for k in keys):
        return torch.sort(_pack_i32_pair(keys[0], keys[1]), stable=True).indices
    perm = torch.arange(n, device=dev)
    for k in reversed(keys):
        perm = perm[torch.sort(k[perm], stable=True).indices]
    return perm


def lexsort(operands: Sequence[torch.Tensor], num_keys: int):
    """Counterpart of ``lax.sort(operands, num_keys=num_keys)``: every
    operand reordered by the lexicographic order of the first ``num_keys``.

    Ties are broken by input position, so the result is a function of the
    inputs (``lax.sort(..., is_stable=False)`` leaves tie order to XLA)."""
    operands = list(operands)
    keys = operands[:num_keys]
    if (num_keys == 2 and len(operands) == 2
            and all(k.dtype == torch.int32 for k in keys)):
        # the packed key carries both lanes: no permutation gathers at all
        packed = torch.sort(_pack_i32_pair(keys[0], keys[1])).values
        return list(_unpack_i32_pair(packed))
    if num_keys == 1 and len(operands) == 1:
        return [torch.sort(keys[0], stable=True).values]
    perm = lexsort_permutation(keys)
    return [op[perm] for op in operands]


def order_by_permutation(
    keys: Sequence[dict],  # {codes: order_code'd, nulls: bool|None,
                           #  ascending: bool, nulls_last: bool}
    row_valid: Optional[torch.Tensor],
    n: int,
):
    """Return a permutation placing valid rows first in requested order;
    ties keep input order (the row index is the last key, as in JAX)."""
    ops = []
    if row_valid is not None:
        ops.append((~row_valid).to(torch.int32))
    for k in keys:
        codes = k["codes"]
        if not k["ascending"]:
            codes = -codes  # codes are clipped by order_code, negation is safe
        nulls = k.get("nulls")
        if nulls is not None:
            null_op = nulls.to(torch.int32)
            if not k.get("nulls_last", True):
                null_op = 1 - null_op
            ops.append(null_op)
        ops.append(codes)
    return lexsort_permutation(ops)


def top_k_permutation(keys, row_valid, n: int, k: int):
    """Fused ORDER BY ... LIMIT k: the first ``k`` rows of
    :func:`order_by_permutation`.  A single descending key with no nulls and
    no row mask takes a stable descending sort instead of negating codes;
    equal values keep input order, as ``lax.top_k`` keeps them."""
    if len(keys) == 1 and not keys[0]["ascending"] \
            and keys[0].get("nulls") is None and row_valid is None and k <= n:
        idx = torch.sort(keys[0]["codes"], descending=True, stable=True).indices
        return idx[:k]
    return order_by_permutation(keys, row_valid, n)[:k]
