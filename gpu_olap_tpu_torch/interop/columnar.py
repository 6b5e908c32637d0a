"""Columnar core: logical dtypes, schema, and the in-memory ColumnBatch.

The port's own copy of ``gpu_olap_tpu/interop/columnar.py``: this package imports
nothing of the JAX package, and ``tests/test_torch_standalone.py``
holds the copy against the original.

TPU-native analogue of the reference's ``arrow-interop`` crate
(``column_buffer.rs:8-110``, ``schema_utils.rs:4-59``).  Key differences by design:

* Everything is widened to 8-byte types for device execution exactly as the
  reference does (``column_buffer.rs:17-21``), but validity is kept as a separate
  boolean mask instead of being destroyed by sentinel substitution
  (fixes the null loss documented at ``arrow-interop/src/lib.rs:15-17``).
* Strings are **dictionary encoded** (codes on device, dictionary on host) rather
  than lossily FNV-hashed (``record_batch_convert.rs:93-97``) so string group-by /
  join results can be decoded back to real strings.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict, List, Optional, Sequence, Union

import numpy as np


class DType(enum.Enum):
    INT64 = "int64"
    FLOAT64 = "float64"
    BOOL = "bool"
    STRING = "string"          # dictionary-encoded: int64 codes + host dictionary
    TIMESTAMP_MS = "timestamp_ms"  # int64 milliseconds since epoch
    DATE32 = "date32"          # int64 days since epoch (widened)

    @property
    def numpy_dtype(self) -> np.dtype:
        """Physical (device) representation — 8-byte, per the interchange contract."""
        if self in (DType.INT64, DType.STRING, DType.TIMESTAMP_MS, DType.DATE32):
            return np.dtype(np.int64)
        if self is DType.FLOAT64:
            return np.dtype(np.float64)
        if self is DType.BOOL:
            return np.dtype(np.bool_)
        raise AssertionError(self)

    @property
    def is_numeric(self) -> bool:
        return self in (DType.INT64, DType.FLOAT64)

    @property
    def byte_width(self) -> int:
        return 1 if self is DType.BOOL else 8


@dataclasses.dataclass(frozen=True)
class Field:
    name: str
    dtype: DType
    nullable: bool = True

    def with_name(self, name: str) -> "Field":
        return Field(name, self.dtype, self.nullable)


def _base_name(name: str) -> str:
    return name.rsplit(".", 1)[-1]


class AmbiguousColumn(KeyError):
    pass


class UnknownColumn(KeyError):
    pass


@dataclasses.dataclass(frozen=True)
class Schema:
    """Ordered field list with qualified-name resolution.

    Field names may be qualified (``"t.a"``); lookup accepts either the exact
    name or an unqualified suffix, erroring on ambiguity — proper schema
    derivation where the reference stubbed it (``physical_plan.rs:250-265``).
    """

    fields: tuple

    def __init__(self, fields: Sequence[Field]):
        object.__setattr__(self, "fields", tuple(fields))

    def __len__(self) -> int:
        return len(self.fields)

    def __iter__(self):
        return iter(self.fields)

    @property
    def names(self) -> List[str]:
        return [f.name for f in self.fields]

    def field(self, i: int) -> Field:
        return self.fields[i]

    def index_of(self, name: str) -> int:
        # 1) exact match
        exact = [i for i, f in enumerate(self.fields) if f.name == name]
        if len(exact) == 1:
            return exact[0]
        if len(exact) > 1:
            raise AmbiguousColumn(f"Column name {name!r} is ambiguous")
        # 2) unqualified match against qualified fields (or vice versa)
        base = _base_name(name)
        if "." not in name:
            cands = [i for i, f in enumerate(self.fields) if _base_name(f.name) == base]
        else:
            cands = [i for i, f in enumerate(self.fields) if f.name == base]
        if len(cands) == 1:
            return cands[0]
        if len(cands) > 1:
            raise AmbiguousColumn(
                f"Column name {name!r} is ambiguous among {[self.fields[i].name for i in cands]}"
            )
        raise UnknownColumn(f"Unknown column {name!r}; available: {self.names}")

    def field_by_name(self, name: str) -> Field:
        return self.fields[self.index_of(name)]

    def project(self, indices: Sequence[int]) -> "Schema":
        return Schema([self.fields[i] for i in indices])

    def qualify(self, qualifier: str) -> "Schema":
        """Prefix all unqualified field names with ``qualifier.``."""
        out = []
        for f in self.fields:
            name = f.name if "." in f.name else f"{qualifier}.{f.name}"
            out.append(f.with_name(name))
        return Schema(out)

    def unqualify(self) -> "Schema":
        """Strip qualifiers where doing so stays unambiguous."""
        bases = [_base_name(f.name) for f in self.fields]
        out = []
        for f, b in zip(self.fields, bases):
            out.append(f.with_name(b) if bases.count(b) == 1 else f)
        return Schema(out)

    def row_byte_width(self) -> int:
        """Analogue of ``schema_utils.rs:20-27``."""
        return sum(f.dtype.byte_width for f in self.fields)

    def merge(self, other: "Schema") -> "Schema":
        return Schema(list(self.fields) + list(other.fields))


ArrayLike = Union[np.ndarray, "torch.Tensor"]  # noqa: F821 — torch imported lazily


@dataclasses.dataclass
class Column:
    """One column: physical data + optional validity + optional dictionary.

    ``data`` is the widened physical array (int64/float64/bool).  ``validity`` is a
    boolean mask (True = valid) or None when no nulls.  ``dictionary`` is the host
    string table for DType.STRING (data holds int64 codes indexing into it).
    """

    data: ArrayLike
    validity: Optional[ArrayLike] = None
    dictionary: Optional[np.ndarray] = None

    def __len__(self) -> int:
        return int(self.data.shape[0])

    @property
    def has_nulls(self) -> bool:
        # ``all()`` of a numpy array or a tensor on any device
        return self.validity is not None and not bool(self.validity.all())

    def to_numpy(self) -> "Column":
        val = None if self.validity is None else np.asarray(self.validity)
        return Column(np.asarray(self.data), val, self.dictionary)


class ColumnBatch:
    """A batch of rows in SoA layout — the engine's unit of exchange.

    Equivalent role to Arrow ``RecordBatch`` inside the reference executor, but the
    arrays may live on the device (torch.Tensor) or host (numpy).
    """

    def __init__(self, schema: Schema, columns: Sequence[Column], num_rows: Optional[int] = None):
        if len(schema) != len(columns):
            raise ValueError(f"schema has {len(schema)} fields but {len(columns)} columns given")
        self.schema = schema
        self.columns = list(columns)
        if num_rows is None:
            num_rows = len(columns[0]) if columns else 0
        self.num_rows = int(num_rows)
        for f, c in zip(schema, self.columns):
            if len(c) != self.num_rows:
                raise ValueError(
                    f"column {f.name!r} has {len(c)} rows, expected {self.num_rows}"
                )

    # -- constructors ------------------------------------------------------
    @classmethod
    def from_dict(cls, data: Dict[str, np.ndarray]) -> "ColumnBatch":
        """Build from a dict of numpy arrays / lists (tests + pandas path)."""
        fields, cols = [], []
        for name, arr in data.items():
            arr = np.asarray(arr)
            if arr.dtype.kind in ("U", "S", "O"):
                codes, dictionary, validity = dict_encode_strings(arr)
                fields.append(Field(name, DType.STRING))
                cols.append(Column(codes, validity, dictionary))
            elif arr.dtype.kind == "b":
                fields.append(Field(name, DType.BOOL))
                cols.append(Column(arr.astype(np.bool_)))
            elif arr.dtype.kind in ("i", "u"):
                fields.append(Field(name, DType.INT64))
                cols.append(Column(arr.astype(np.int64)))
            elif arr.dtype.kind == "f":
                validity = None
                if np.isnan(arr).any():
                    validity = ~np.isnan(arr)
                fields.append(Field(name, DType.FLOAT64))
                cols.append(Column(arr.astype(np.float64), validity))
            elif arr.dtype.kind == "M":  # datetime64
                ms = arr.astype("datetime64[ms]").astype(np.int64)
                fields.append(Field(name, DType.TIMESTAMP_MS))
                cols.append(Column(ms))
            else:
                raise TypeError(f"Unsupported numpy dtype for column {name!r}: {arr.dtype}")
        return cls(Schema(fields), cols)

    # -- access ------------------------------------------------------------
    def column(self, i: int) -> Column:
        return self.columns[i]

    def column_by_name(self, name: str) -> Column:
        return self.columns[self.schema.index_of(name)]

    def select(self, indices: Sequence[int]) -> "ColumnBatch":
        return ColumnBatch(self.schema.project(indices), [self.columns[i] for i in indices], self.num_rows)

    def to_numpy(self) -> "ColumnBatch":
        return ColumnBatch(self.schema, [c.to_numpy() for c in self.columns], self.num_rows)

    def nbytes(self) -> int:
        total = 0
        for f in self.schema:
            total += self.num_rows * f.dtype.byte_width
        return total

    # -- conversion out ----------------------------------------------------
    def to_pydict(self) -> Dict[str, np.ndarray]:
        """Decode to host-friendly arrays (strings decoded, nulls -> NaN/None)."""
        out: Dict[str, np.ndarray] = {}
        for f, c in zip(self.schema, self.columns):
            c = c.to_numpy()
            if f.dtype is DType.STRING:
                decoded = np.asarray(c.dictionary, dtype=object)[np.clip(c.data, 0, None)]
                if c.validity is not None:
                    decoded = decoded.copy()
                    decoded[~c.validity] = None
                out[f.name] = decoded
            elif f.dtype is DType.FLOAT64:
                vals = c.data.astype(np.float64)
                if c.validity is not None:
                    vals = vals.copy()
                    vals[~c.validity] = np.nan
                out[f.name] = vals
            elif f.dtype is DType.TIMESTAMP_MS:
                vals = c.data.astype("datetime64[ms]")
                out[f.name] = vals
            else:
                vals = c.data
                if c.validity is not None and f.dtype is DType.INT64:
                    fv = vals.astype(np.float64)
                    fv[~c.validity] = np.nan
                    vals = fv
                out[f.name] = vals
        return out

    def __repr__(self) -> str:
        cols = ", ".join(f"{f.name}:{f.dtype.value}" for f in self.schema)
        return f"ColumnBatch[{self.num_rows} rows]({cols})"


def dict_encode_strings(arr: np.ndarray):
    """Dictionary-encode a string/object array -> (int64 codes, dictionary, validity)."""
    arr = np.asarray(arr, dtype=object)
    validity = np.array([x is not None and x == x for x in arr], dtype=bool)
    filler = ""
    safe = np.where(validity, arr, filler)
    dictionary, codes = np.unique(safe.astype(str), return_inverse=True)
    codes = codes.astype(np.int64)
    if validity.all():
        validity_out = None
    else:
        validity_out = validity
        codes = np.where(validity, codes, np.int64(0))
    return codes, dictionary, validity_out


def concat_batches(batches: Sequence[ColumnBatch]) -> ColumnBatch:
    """Concatenate host batches with the same schema (dictionaries re-unified)."""
    if not batches:
        raise ValueError("concat_batches needs at least one batch")
    if len(batches) == 1:
        return batches[0]
    schema = batches[0].schema
    ncols = len(schema)
    out_cols = []
    for i in range(ncols):
        field = schema.field(i)
        cols = [b.column(i).to_numpy() for b in batches]
        if field.dtype is DType.STRING:
            # Re-unify dictionaries.
            all_vals = []
            for c in cols:
                vals = np.asarray(c.dictionary, dtype=object)[c.data]
                if c.validity is not None:
                    vals = vals.copy()
                    vals[~c.validity] = None
                all_vals.append(vals)
            merged = np.concatenate(all_vals)
            codes, dictionary, validity = dict_encode_strings(merged)
            out_cols.append(Column(codes, validity, dictionary))
        else:
            data = np.concatenate([c.data for c in cols])
            if any(c.validity is not None for c in cols):
                validity = np.concatenate(
                    [c.validity if c.validity is not None else np.ones(len(c), dtype=bool) for c in cols]
                )
            else:
                validity = None
            out_cols.append(Column(data, validity))
    return ColumnBatch(schema, out_cols)
