"""Plain PyTorch building blocks of the reference answers.

The reference reads the generated tables (never anything the program made),
joins a fact row to its dimension row by the dimension's key, and groups with
``torch.unique``.  Sums accumulate in the dtype the caller gives: int64 and
exact float sums normally, int32 and float32 for the lower-precision
control.  It imports nothing of the program.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch


class View:
    """The generated tables' columns on ``device``, with key lookups."""

    def __init__(self, tables, device):
        self.tables = tables
        self.device = torch.device(device)
        self._luts: dict = {}

    def col(self, table: str, name: str) -> torch.Tensor:
        return self.tables.device(table, name, self.device)

    def _lut(self, table: str, key: str):
        """(offset, key -> row table) of ``table``'s unique key column."""
        if (table, key) not in self._luts:
            k = self.col(table, key).long()
            lo, hi = int(k.min()), int(k.max())
            lut = torch.full((hi - lo + 1,), -1, dtype=torch.long,
                             device=self.device)
            lut[k - lo] = torch.arange(len(k), device=self.device)
            if int((lut >= 0).sum()) != len(k):
                raise ValueError(f"{table}.{key} is not a unique key")
            self._luts[(table, key)] = (lo, lut)
        return self._luts[(table, key)]

    def lookup(self, table: str, key: str, attr: str,
               fk: torch.Tensor) -> torch.Tensor:
        """``table.attr`` of the row whose ``key`` equals each ``fk``
        (every ``fk`` has its row: the generated foreign keys are total)."""
        lo, lut = self._lut(table, key)
        rows = lut[fk.long() - lo]
        if bool((rows < 0).any()):
            raise ValueError(f"a foreign key has no row in {table}")
        return self.col(table, attr)[rows]

    def code(self, table: str, name: str, value: str) -> int:
        return self.tables.dictionary(table, name).index(value)

    def codes_where(self, table: str, name: str, pred) -> torch.Tensor:
        """Bool tensor over the dictionary of ``table.name``: ``pred(s)``."""
        return torch.tensor([bool(pred(s)) for s in
                             self.tables.dictionary(table, name)],
                            device=self.device)

    def decode(self, table: str, name: str, codes: torch.Tensor) -> np.ndarray:
        d = np.asarray(self.tables.dictionary(table, name), dtype=str)
        return d[codes.cpu().numpy()]


def groups(keys: Sequence[torch.Tensor], mask: torch.Tensor):
    """Distinct key tuples of the rows under ``mask`` (ascending) and each
    such row's group index."""
    ks = [k[mask].long() for k in keys]
    if len(ks) == 1:
        uniq, inv = torch.unique(ks[0], return_inverse=True)
        return [uniq], inv
    uniq, inv = torch.unique(torch.stack(ks, 1), dim=0, return_inverse=True)
    return list(uniq.unbind(1)), inv


def sum_by(inv: torch.Tensor, n: int, values: torch.Tensor,
           dtype) -> torch.Tensor:
    out = torch.zeros(n, dtype=dtype, device=values.device)
    return out.index_add_(0, inv, values.to(dtype))


def count_by(inv: torch.Tensor, n: int) -> torch.Tensor:
    return torch.bincount(inv, minlength=n)


def reduce_by(inv: torch.Tensor, n: int, values: torch.Tensor,
              how: str) -> torch.Tensor:
    """``how`` = "amax" or "amin" of ``values`` per group."""
    out = torch.zeros(n, dtype=values.dtype, device=values.device)
    return out.scatter_reduce_(0, inv, values, how, include_self=False)


def exact_float_sum(inv: torch.Tensor, n: int, micro: torch.Tensor,
                    scale: float, dtype) -> torch.Tensor:
    """Per-group sums of ``micro / scale``: exact in int64, one rounding
    to float64 at the end; in the control (``dtype`` float32) a float32
    sum of the float32 values."""
    if dtype == torch.float64:
        return sum_by(inv, n, micro, torch.int64).to(torch.float64) / scale
    return sum_by(inv, n, (micro.to(torch.float64) / scale).to(dtype), dtype)


def host(cols: Dict[str, object]) -> Dict[str, np.ndarray]:
    """The answer's columns as numpy arrays."""
    out = {}
    for k, v in cols.items():
        out[k] = v.cpu().numpy() if isinstance(v, torch.Tensor) else \
            np.asarray(v)
    return out


PRECISIONS = {
    # the configurations' own: int64 sums, float64 (exact) sums
    "exact": {"int": torch.int64, "float": torch.float64},
    # the control: the nearest precision below
    "lower": {"int": torch.int32, "float": torch.float32},
}
