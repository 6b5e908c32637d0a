"""Reference answers of the db-benchmark group-by questions, one module per
question (the interface of ``reference/ssb_sf20/__init__.py``).  ``v3`` is
summed from its integer micro-units (table ``x_exact``): exact, rounded once
to float64; the control sums float32 values in float32."""

import torch

from olapbench.reference import plain


def grouped(v: plain.View, keys, acc):
    """Group every row of ``x`` by the columns ``keys``: (key columns for
    the answer, group index of each row, number of groups, row counts)."""
    cols = [v.col("x", k) for k in keys]
    mask = torch.ones(len(cols[0]), dtype=torch.bool, device=v.device)
    uniq, inv = plain.groups(cols, mask)
    out = {}
    for k, u in zip(keys, uniq):
        out[k] = (u if v.tables.dictionary("x", k) is None
                  else v.decode("x", k, u))
    n = len(uniq[0])
    return out, inv, n, plain.count_by(inv, n)


def int_sum(v, inv, n, col, acc):
    return plain.sum_by(inv, n, v.col("x", col), acc["int"])


def v3_sum(v, inv, n, acc):
    return plain.exact_float_sum(inv, n, v.col("x_exact", "v3_micro"), 1e6,
                                 acc["float"])


def mean(total, count, acc):
    return total.to(acc["float"]) / count.to(acc["float"])
