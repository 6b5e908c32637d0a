"""q7: MAX(v1) - MIN(v2) by id3."""

from olapbench.reference.h2o_groupby_1e8 import grouped
from olapbench.reference import plain

READS = {"x": ["id3", "v1", "v2"]}
KEYS = ["id3"]
ORDER: list = []


def answer(v, p, acc):
    out, inv, n, _ = grouped(v, ["id3"], acc)
    hi = plain.reduce_by(inv, n, v.col("x", "v1"), "amax")
    lo = plain.reduce_by(inv, n, v.col("x", "v2"), "amin")
    out["range_v1_v2"] = hi.to(acc["int"]) - lo.to(acc["int"])
    return plain.host(out)
