"""q3: SUM(v1), AVG(v3) by id3."""

from olapbench.reference.h2o_groupby_1e8 import grouped, int_sum, mean, v3_sum
from olapbench.reference import plain

READS = {"x": ["id3", "v1", "v3"]}
KEYS = ["id3"]
ORDER: list = []


def answer(v, p, acc):
    out, inv, n, count = grouped(v, ["id3"], acc)
    out["v1"] = int_sum(v, inv, n, "v1", acc)
    out["v3"] = mean(v3_sum(v, inv, n, acc), count, acc)
    return plain.host(out)
