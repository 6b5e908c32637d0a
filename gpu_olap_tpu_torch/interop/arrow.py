"""Arrow / pandas interchange.

The port's own copy of ``gpu_olap_tpu/interop/arrow.py``: this package imports
nothing of the JAX package, and ``tests/test_torch_standalone.py``
holds the copy against the original.

TPU-native analogue of ``arrow-interop/src/record_batch_convert.rs``: every Arrow
numeric type is widened to int64/float64 (``:35-100``), timestamps/dates become
int64 (``column_buffer.rs:24-47``), and strings are dictionary-encoded (we keep a
real dictionary instead of the reference's lossy FNV-1a hash at ``:93-97,123-130``).
Nulls are carried as separate validity masks (``:36-40``) and restored on the way
out (``gpu_buffers_to_record_batch``, ``:140-178``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import pyarrow as pa

from .columnar import Column, ColumnBatch, DType, Field, Schema, dict_encode_strings

_ARROW_INT_TYPES = (
    pa.int8(), pa.int16(), pa.int32(), pa.int64(),
    pa.uint8(), pa.uint16(), pa.uint32(), pa.uint64(),
)


def dtype_from_arrow(at: pa.DataType) -> DType:
    """Arrow type -> engine logical dtype (mapping of ``column_buffer.rs:24-47``)."""
    if at in _ARROW_INT_TYPES or pa.types.is_boolean(at) is False and pa.types.is_integer(at):
        return DType.INT64
    if pa.types.is_floating(at):
        return DType.FLOAT64
    if pa.types.is_boolean(at):
        return DType.BOOL
    if pa.types.is_timestamp(at):
        return DType.TIMESTAMP_MS
    if pa.types.is_date(at):
        return DType.DATE32
    if pa.types.is_string(at) or pa.types.is_large_string(at):
        return DType.STRING
    if pa.types.is_dictionary(at):
        return dtype_from_arrow(at.value_type)
    raise TypeError(f"Arrow type {at} is not supported on device "
                    "(matches reference is_gpu_compatible, schema_utils.rs:29-33)")


def schema_from_arrow(aschema: pa.Schema) -> Schema:
    return Schema([Field(f.name, dtype_from_arrow(f.type), f.nullable) for f in aschema])


def _validity_from_chunked(arr: pa.ChunkedArray) -> Optional[np.ndarray]:
    if arr.null_count == 0:
        return None
    return ~np.asarray(arr.is_null())


def _native_dict_encode(arr: pa.ChunkedArray, validity):
    """Dictionary-encode via the native C++ kernel on raw Arrow buffers;
    returns None to fall back to the NumPy path."""
    try:
        from .. import native
    except Exception:
        return None
    combined = arr.combine_chunks()
    if isinstance(combined, pa.ChunkedArray):
        if combined.num_chunks != 1:
            return None
        combined = combined.chunk(0)
    if combined.offset != 0:
        combined = pa.concat_arrays([combined])  # re-materialize at offset 0
    bufs = combined.buffers()
    if len(bufs) < 3 or bufs[1] is None or bufs[2] is None:
        return None
    if pa.types.is_large_string(combined.type):
        offsets = np.frombuffer(bufs[1], dtype=np.int64)[: len(combined) + 1]
    else:
        offsets = np.frombuffer(bufs[1], dtype=np.int32).astype(np.int64)[: len(combined) + 1]
    data = np.frombuffer(bufs[2], dtype=np.uint8)
    vbytes = None
    if validity is not None:
        vbytes = validity.astype(np.uint8)
    res = native.dict_encode_utf8(data, offsets, vbytes)
    return res


def column_from_arrow(arr: pa.ChunkedArray, dtype: DType) -> Column:
    validity = _validity_from_chunked(arr)
    if dtype is DType.STRING:
        if pa.types.is_dictionary(arr.type):
            arr = arr.cast(arr.type.value_type)
        native_res = _native_dict_encode(arr, validity)
        if native_res is not None:
            codes, dictionary = native_res
            return Column(codes, validity, dictionary)
        host = arr.to_numpy(zero_copy_only=False)
        codes, dictionary, v2 = dict_encode_strings(host)
        if validity is None:
            validity = v2
        return Column(codes, validity, dictionary)
    if dtype is DType.TIMESTAMP_MS:
        arr = arr.cast(pa.timestamp("ms"))
        data = arr.to_numpy(zero_copy_only=False).astype("datetime64[ms]").astype(np.int64)
    elif dtype is DType.DATE32:
        # days pass through int32: Arrow has no date32 -> int64 cast
        data = arr.cast(pa.int32()).fill_null(0).to_numpy(
            zero_copy_only=False).astype(np.int64)
    elif dtype is DType.BOOL:
        data = arr.to_numpy(zero_copy_only=False)
        if data.dtype == object:
            data = np.array([bool(x) if x is not None else False for x in data])
        data = data.astype(np.bool_)
    else:
        np_target = dtype.numpy_dtype
        data = arr.to_numpy(zero_copy_only=False)
        if validity is not None and data.dtype.kind == "f" and dtype is DType.INT64:
            # ints with nulls come back as float; sentinel-fill then mask
            data = np.where(np.isnan(data), 0, data)
        if data.dtype.kind == "f" and np.isnan(data).any() and validity is None:
            validity = ~np.isnan(data)
        data = np.nan_to_num(data, nan=0.0).astype(np_target) if data.dtype.kind == "f" and dtype is DType.INT64 else data.astype(np_target)
    return Column(np.ascontiguousarray(data), validity)


def batch_from_arrow(table: pa.Table) -> ColumnBatch:
    """Arrow Table -> ColumnBatch (``record_batch_to_gpu_buffers``, ``:22-33``)."""
    schema = schema_from_arrow(table.schema)
    cols = [column_from_arrow(table.column(i), schema.field(i).dtype) for i in range(len(schema))]
    return ColumnBatch(schema, cols, table.num_rows)


def batch_to_arrow(batch: ColumnBatch) -> pa.Table:
    """ColumnBatch -> Arrow Table (``gpu_buffers_to_record_batch``, ``:140-178``)."""
    batch = batch.to_numpy()
    arrays, names = [], []
    for f, c in zip(batch.schema, batch.columns):
        mask = None if c.validity is None else ~np.asarray(c.validity)
        if f.dtype is DType.STRING:
            values = np.asarray(c.dictionary, dtype=object)[np.clip(c.data, 0, None)]
            if mask is not None:
                values = values.copy()
                values[mask] = None
            arrays.append(pa.array(values, type=pa.string()))
        elif f.dtype is DType.TIMESTAMP_MS:
            arrays.append(pa.array(c.data, type=pa.timestamp("ms"), mask=mask))
        elif f.dtype is DType.DATE32:
            arrays.append(pa.array(c.data.astype(np.int32), type=pa.date32(), mask=mask))
        elif f.dtype is DType.BOOL:
            arrays.append(pa.array(c.data, type=pa.bool_(), mask=mask))
        elif f.dtype is DType.INT64:
            arrays.append(pa.array(c.data, type=pa.int64(), mask=mask))
        else:
            arrays.append(pa.array(c.data, type=pa.float64(), mask=mask))
        names.append(f.name)
    return pa.table(arrays, names=names)


def batch_from_pandas(df) -> ColumnBatch:
    return batch_from_arrow(pa.Table.from_pandas(df, preserve_index=False))


def batch_to_pandas(batch: ColumnBatch):
    return batch_to_arrow(batch).to_pandas()


def read_parquet_schema(path: str):
    import pyarrow.parquet as pq

    pf = pq.ParquetFile(path)
    return schema_from_arrow(pf.schema_arrow), pf.metadata.num_rows


def parquet_column_stats(path: str) -> dict:
    """Zone-map (min, max) per integer column from PARQUET METADATA only —
    no data read.  Out-of-core tables get real statistics this way, which
    drives int32 narrowing of streamed chunks (halves host->device bytes on
    the slow link) and keeps the streamed programs in int32 space.  Columns
    missing min/max in any row group are omitted."""
    import pyarrow.parquet as pq

    md = pq.ParquetFile(path).metadata
    ncols = md.num_columns
    names = [md.schema.column(i).name for i in range(ncols)]
    mins = [None] * ncols
    maxs = [None] * ncols
    bad = [False] * ncols
    nulls = [0] * ncols          # None = unknown in any row group
    for rg in range(md.num_row_groups):
        row_group = md.row_group(rg)
        for i in range(ncols):
            st = row_group.column(i).statistics
            if nulls[i] is not None:
                nc = None if st is None else st.null_count
                nulls[i] = None if nc is None else nulls[i] + int(nc)
            if bad[i]:
                continue
            if st is None or not st.has_min_max \
                    or not isinstance(st.min, (int,)) \
                    or not isinstance(st.max, (int,)) \
                    or isinstance(st.min, bool):
                bad[i] = True
                continue
            mins[i] = st.min if mins[i] is None else min(mins[i], st.min)
            maxs[i] = st.max if maxs[i] is None else max(maxs[i], st.max)
    out = {names[i]: (int(mins[i]), int(maxs[i]))
           for i in range(ncols)
           if not bad[i] and mins[i] is not None}
    # per-column metadata null counts (None = writer did not record them):
    # the streaming matcher rejects columns with KNOWN nulls — staged chunk
    # uploads carry data lanes only, so nulls cannot ride the streamed path
    out["__nulls__"] = {names[i]: nulls[i] for i in range(ncols)}
    return out


def read_parquet(path: str, columns=None) -> ColumnBatch:
    import pyarrow.parquet as pq

    table = pq.read_table(path, columns=columns)
    return batch_from_arrow(table)


def iter_parquet_chunks(path: str, batch_size: int, columns=None):
    """Streamed chunked scan for out-of-core execution (catalog.rs streaming role)."""
    import pyarrow.parquet as pq

    pf = pq.ParquetFile(path)
    for record_batch in pf.iter_batches(batch_size=batch_size, columns=columns):
        yield batch_from_arrow(pa.Table.from_batches([record_batch]))
