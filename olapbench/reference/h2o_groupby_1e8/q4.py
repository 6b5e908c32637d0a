"""q4: AVG(v1), AVG(v2), AVG(v3) by id4."""

from olapbench.reference.h2o_groupby_1e8 import grouped, int_sum, mean, v3_sum
from olapbench.reference import plain

READS = {"x": ["id4", "v1", "v2", "v3"]}
KEYS = ["id4"]
ORDER: list = []


def answer(v, p, acc):
    out, inv, n, count = grouped(v, ["id4"], acc)
    out["v1"] = mean(int_sum(v, inv, n, "v1", acc), count, acc)
    out["v2"] = mean(int_sum(v, inv, n, "v2", acc), count, acc)
    out["v3"] = mean(v3_sum(v, inv, n, acc), count, acc)
    return plain.host(out)
