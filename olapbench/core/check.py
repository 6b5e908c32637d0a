"""The comparison that decides ``correct``: a program's answer against the
reference's, column by column.

Keys, counts, integer sums and strings must be equal; float columns give
their worst relative gap, which the run holds to the cell's limit.  Rows
are matched by the reference's key columns (a GROUP BY's output has no
order of its own); where the query has an ORDER BY, the program's rows must
also come in that order, ties in any order.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np


def program_columns(result) -> Dict[str, np.ndarray]:
    """The program's answer (a ``QueryResult``) as numpy columns, strings as
    numpy unicode arrays, a column with nulls as an object array."""
    import pyarrow as pa

    table = result.to_arrow()
    out = {}
    for name, col in zip(table.column_names, table.columns):
        if col.null_count:
            out[name] = np.array(col.to_pylist(), dtype=object)
        elif pa.types.is_string(col.type) or pa.types.is_large_string(col.type):
            out[name] = np.asarray(col.to_numpy(zero_copy_only=False),
                                   dtype=str)
        else:
            out[name] = col.to_numpy()
    return out


def _order_violations(cols: Dict[str, np.ndarray],
                      order: List[Tuple[str, str]]) -> int:
    """Adjacent row pairs out of the ORDER BY's order."""
    if not order or len(next(iter(cols.values()))) < 2:
        return 0
    tied = None
    bad = 0
    for name, direction in order:
        a = cols[name]
        prev, nxt = a[:-1], a[1:]
        later = (nxt < prev) if direction == "asc" else (nxt > prev)
        equal = nxt == prev
        if tied is None:
            tied = np.ones(len(prev), dtype=bool)
        bad += int((tied & later).sum())
        tied &= equal
    return bad


def _rel_gap(p: np.ndarray, r: np.ndarray) -> float:
    p = p.astype(np.float64)
    r = r.astype(np.float64)
    if not (np.isfinite(p).all() and np.isfinite(r).all()):
        return float("inf")
    scale = np.where(r != 0, np.abs(r), 1.0)
    return float((np.abs(p - r) / scale).max(initial=0.0))


def compare(program: Dict[str, np.ndarray], reference: Dict[str, np.ndarray],
            keys: List[str], order: List[Tuple[str, str]]
            ) -> Tuple[Optional[str], float]:
    """(what differs exactly, or None; the worst relative gap of the float
    columns)."""
    if list(program) != list(reference):
        return f"columns {list(program)} != {list(reference)}", 0.0
    n_p = len(next(iter(program.values())))
    n_r = len(next(iter(reference.values())))
    if n_p != n_r:
        return f"{n_p} rows != {n_r}", 0.0
    bad = _order_violations(program, order)
    if bad:
        return f"{bad} row pairs out of ORDER BY order", 0.0
    if keys:
        p_idx = np.lexsort([program[k] for k in reversed(keys)])
        r_idx = np.lexsort([reference[k] for k in reversed(keys)])
    else:
        p_idx = r_idx = np.arange(n_p)
    gap = 0.0
    for name in program:
        p, r = program[name][p_idx], reference[name][r_idx]
        if r.dtype.kind == "f" and p.dtype.kind in "fiu":
            gap = max(gap, _rel_gap(p, r))
        elif r.dtype == object or p.dtype == object:
            if list(p) != list(r):
                return f"column {name} differs", gap
        elif not np.array_equal(p, r):
            first = int(np.flatnonzero(p != r)[0])
            return (f"column {name} differs at row {first}: "
                    f"{p[first]!r} != {r[first]!r}"), gap
    return None, gap
