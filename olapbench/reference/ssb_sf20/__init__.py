"""Reference answers of the SSB queries, one module per query.

Each module gives ``READS`` (the columns the query reads, by table),
``KEYS`` (the result columns that identify a row), ``ORDER`` (the ORDER BY,
as (column, "asc"|"desc") pairs) and ``answer(view, p, acc)``: the result
columns in the query's output order, from the generated tables alone.
"""

import torch

from olapbench.reference import plain


def date_attr(v: plain.View, attr: str) -> torch.Tensor:
    """``date.attr`` of each lineorder row, by ``lo_orderdate``."""
    return v.lookup("date", "d_datekey", attr, v.col("lineorder", "lo_orderdate"))


def dim(v: plain.View, table: str, attr: str) -> torch.Tensor:
    """``table.attr`` of each lineorder row, by its foreign key."""
    key = {"customer": "custkey", "supplier": "suppkey", "part": "partkey"}[table]
    return v.lookup(table, f"{table[0]}_{key}", attr, v.col("lineorder", f"lo_{key}"))


def q1(v: plain.View, mask: torch.Tensor, acc) -> dict:
    """Flight 1's one-row answer: SUM(lo_extendedprice * lo_discount)."""
    lo = lambda c: v.col("lineorder", c)  # noqa: E731
    prod = (lo("lo_extendedprice") * lo("lo_discount"))[mask]
    if len(prod) == 0:
        return {"revenue": [None]}
    return plain.host({"revenue": prod.sum(dtype=acc["int"]).reshape(1)})


def grouped_sum(v: plain.View, keys: dict, values: torch.Tensor, mask, acc,
                out: list, sum_name: str) -> dict:
    """GROUP BY ``keys`` (name -> (table, column, codes or values)) with one
    SUM of ``values``; columns in the order ``out``."""
    uniq, inv = plain.groups([k[2] for k in keys.values()], mask)
    sums = plain.sum_by(inv, len(uniq[0]), values[mask], acc["int"])
    cols = {sum_name: sums}
    for (name, (table, column, _)), u in zip(keys.items(), uniq):
        cols[name] = (u if v.tables.dictionary(table, column) is None
                      else v.decode(table, column, u))
    return plain.host({c: cols[c] for c in out})
