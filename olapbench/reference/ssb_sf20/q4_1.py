"""Q4.1: SUM(lo_revenue - lo_supplycost) by year and customer nation;
customer and supplier in one region, two manufacturers."""

from olapbench.reference.ssb_sf20 import date_attr, dim, grouped_sum

READS = {"lineorder": ["lo_orderdate", "lo_custkey", "lo_suppkey", "lo_partkey",
                       "lo_revenue", "lo_supplycost"],
         "date": ["d_datekey", "d_year"],
         "customer": ["c_custkey", "c_region", "c_nation"],
         "supplier": ["s_suppkey", "s_region"],
         "part": ["p_partkey", "p_mfgr"]}
KEYS = ["d_year", "c_nation"]
ORDER = [("d_year", "asc"), ("c_nation", "asc")]


def answer(v, p, acc):
    mfgr = v.codes_where("part", "p_mfgr", lambda s: s in p["mfgrs"])
    mask = (dim(v, "customer", "c_region") == v.code("customer", "c_region", p["region"])) \
        & (dim(v, "supplier", "s_region") == v.code("supplier", "s_region", p["region"])) \
        & mfgr[dim(v, "part", "p_mfgr").long()]
    keys = {"d_year": ("date", "d_year", date_attr(v, "d_year")),
            "c_nation": ("customer", "c_nation", dim(v, "customer", "c_nation"))}
    profit = v.col("lineorder", "lo_revenue") - v.col("lineorder", "lo_supplycost")
    return grouped_sum(v, keys, profit, mask, acc, ["d_year", "c_nation", "profit"], "profit")
