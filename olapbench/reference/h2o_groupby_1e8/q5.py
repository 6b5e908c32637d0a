"""q5: SUM(v1), SUM(v2), SUM(v3) by id6."""

from olapbench.reference.h2o_groupby_1e8 import grouped, int_sum, v3_sum
from olapbench.reference import plain

READS = {"x": ["id6", "v1", "v2", "v3"]}
KEYS = ["id6"]
ORDER: list = []


def answer(v, p, acc):
    out, inv, n, _ = grouped(v, ["id6"], acc)
    out["v1"] = int_sum(v, inv, n, "v1", acc)
    out["v2"] = int_sum(v, inv, n, "v2", acc)
    out["v3"] = v3_sum(v, inv, n, acc)
    return plain.host(out)
