"""q2: SUM(v1) by id1, id2."""

from olapbench.reference.h2o_groupby_1e8 import grouped, int_sum
from olapbench.reference import plain

READS = {"x": ["id1", "id2", "v1"]}
KEYS = ["id1", "id2"]
ORDER: list = []


def answer(v, p, acc):
    out, inv, n, _ = grouped(v, ["id1", "id2"], acc)
    out["v1"] = int_sum(v, inv, n, "v1", acc)
    return plain.host(out)
