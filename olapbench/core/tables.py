"""The generated tables of one run: host arrays for the program, device
columns for the reference.

A generator (``configs/<config>.py``) fills a :class:`Tables` with numpy
arrays: plain columns as int32/int64/float64 arrays, string columns as int32
dictionary codes with their dictionary.  The program gets each table as an
Arrow table (:meth:`Tables.arrow`), string columns as Arrow dictionary
arrays, as users hand tables over.  The reference reads the same arrays,
uploaded once the window has closed (:meth:`Tables.device`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class HostColumn:
    data: np.ndarray                       # values, int32 codes, or bytes
    dictionary: Optional[List[str]] = None  # set for a string column


class Tables:
    def __init__(self, widths: Dict[str, Dict[str, int]]):
        #: declared width in bytes of each column, by table
        self.widths = widths
        self.columns: Dict[str, Dict[str, HostColumn]] = {}
        self._device: dict = {}

    def add(self, table: str, name: str, data: np.ndarray,
            dictionary: Optional[List[str]] = None) -> None:
        self.columns.setdefault(table, {})[name] = HostColumn(
            np.ascontiguousarray(data), dictionary)

    def rows(self, table: str) -> int:
        return len(next(iter(self.columns[table].values())).data)

    def arrow(self, table: str):
        import pyarrow as pa

        arrays = {}
        cols = self.columns[table]
        for name in sorted(cols, key=list(self.widths[table]).index):
            col = cols[name]
            if col.data.dtype.kind == "S":  # text, one value a row
                arrays[name] = pa.array(col.data, pa.binary()).cast(
                    pa.string())
            elif col.dictionary is None:
                arrays[name] = pa.array(col.data)
            else:
                arrays[name] = pa.DictionaryArray.from_arrays(
                    pa.array(col.data.astype(np.int32, copy=False)),
                    pa.array(col.dictionary, pa.string()))
        return pa.table(arrays)

    def dictionary(self, table: str, name: str) -> List[str]:
        return self.columns[table][name].dictionary

    def device(self, table: str, name: str, device):
        """The column on ``device`` as a torch tensor (uploaded once)."""
        import torch

        key = (table, name, str(device))
        if key not in self._device:
            self._device[key] = torch.from_numpy(
                self.columns[table][name].data).to(device)
        return self._device[key]

    def drop_device(self) -> None:
        self._device.clear()
