"""Host-side grace-join spill partitioning (out-of-core joins where BOTH
sides exceed the memory threshold).

The port's own copy of ``gpu_olap_tpu/executor/spill.py`` (NumPy and
PyArrow only): this package imports nothing of the JAX package.

The reference documents streaming partitions through join passes for
out-of-core joins (``PROJECT_SUMMARY.md:24,115-118``, ``README.md:338-352``)
— the radix partition lifted from the GPU kernel (``join_kernels.cuh:45-76``)
to the host/disk level.  Each input is hash-partitioned by join key into k
Parquet spill partitions; rows with equal keys land in the same partition
index on both sides, so partition pair i joins independently with a
device-resident build side.

Partitioning is pure host work (NumPy hash + PyArrow writers) overlapping
the table scan; spill directories are cached per (table, version, key, k)
so repeated queries repartition nothing.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import List, Optional

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq

from ..utils.tracing import get_logger

logger = get_logger(__name__)


def spill_hash(keys: np.ndarray) -> np.ndarray:
    """SplitMix64 finalizer over int64/int32 keys -> uint64 hash.

    Same role as the reference's MurmurHash3 finalizer
    (``join_kernels.cuh:26-41``); only cross-side consistency matters."""
    h = keys.astype(np.int64).view(np.uint64).copy()
    h ^= h >> np.uint64(30)
    h *= np.uint64(0xBF58476D1CE4E5B9)
    h ^= h >> np.uint64(27)
    h *= np.uint64(0x94D049BB133111EB)
    h ^= h >> np.uint64(31)
    return h


def choose_partitions(build_rows: int, target_rows: int) -> int:
    """Smallest power of two k with build_rows / k <= target_rows."""
    k = 1
    while build_rows > target_rows * k and k < 1 << 10:
        k *= 2
    return k


class SpillStore:
    """Spill-partition manager with per-(table, version, key, k) caching."""

    def __init__(self, spill_dir: Optional[str] = None):
        self._root = spill_dir
        self._dirs: dict = {}

    def _mkdir(self) -> str:
        if self._root is not None:
            os.makedirs(self._root, exist_ok=True)
            return tempfile.mkdtemp(prefix="part_", dir=self._root)
        return tempfile.mkdtemp(prefix="gpu_olap_spill_")

    def cleanup(self) -> None:
        for d in self._dirs.values():
            shutil.rmtree(d, ignore_errors=True)
        self._dirs.clear()

    def partition_table(self, catalog, table_name: str, key_name: str,
                        k: int, chunk_rows: int,
                        columns: Optional[List[str]] = None) -> List[str]:
        """Hash-partition a table by ``key_name`` into k Parquet files.

        Returns the k file paths (missing file = empty partition).  Null
        keys land in partition 0 — they never match, but inner-join
        filtering happens on device, so they just ride along."""
        cache_key = (table_name, catalog.get_version(table_name),
                     key_name, k, tuple(columns or ()))
        if cache_key in self._dirs:
            d = self._dirs[cache_key]
            return [os.path.join(d, f"p{p}.parquet") for p in range(k)]
        d = self._mkdir()
        writers: List[Optional[pq.ParquetWriter]] = [None] * k
        paths = [os.path.join(d, f"p{p}.parquet") for p in range(k)]
        n_rows = 0
        for batch in catalog.iter_table_chunks(table_name, chunk_rows,
                                               columns=columns):
            names = [f.name for f in batch.schema]
            ki = names.index(key_name)
            kc = batch.columns[ki]
            keys = np.asarray(kc.data)
            if keys.dtype.kind == "f":
                # float keys: hash the raw bits (exact-equality semantics)
                keys = keys.astype(np.float64).view(np.int64)
            pid = (spill_hash(keys) % np.uint64(k)).astype(np.int64)
            if kc.validity is not None:
                pid[~kc.validity] = 0
            arrays = []
            for c in batch.columns:
                data = np.asarray(c.data)
                if c.dictionary is not None:
                    arrays.append((data, c.validity, c.dictionary))
                else:
                    arrays.append((data, c.validity, None))
            for p in range(k):
                sel = pid == p
                if not sel.any():
                    continue
                cols = {}
                for name, (data, validity, dictionary) in zip(names, arrays):
                    if dictionary is not None:
                        vals = dictionary[data[sel]]
                        mask = (None if validity is None
                                else ~validity[sel])
                        cols[name] = pa.array(vals, mask=mask)
                    else:
                        mask = None if validity is None else ~validity[sel]
                        cols[name] = pa.array(data[sel], mask=mask)
                t = pa.table(cols)
                if writers[p] is None:
                    writers[p] = pq.ParquetWriter(paths[p], t.schema)
                writers[p].write_table(t)
            n_rows += batch.num_rows
        for w in writers:
            if w is not None:
                w.close()
        self._dirs[cache_key] = d
        logger.info("spill-partitioned %r (%d rows) into %d parts at %s",
                    table_name, n_rows, k, d)
        return paths
