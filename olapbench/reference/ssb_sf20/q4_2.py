"""Q4.2: the same by year, supplier nation and part category, in two years."""

from olapbench.reference.ssb_sf20 import date_attr, dim, grouped_sum

READS = {"lineorder": ["lo_orderdate", "lo_custkey", "lo_suppkey", "lo_partkey",
                       "lo_revenue", "lo_supplycost"],
         "date": ["d_datekey", "d_year"],
         "customer": ["c_custkey", "c_region"],
         "supplier": ["s_suppkey", "s_region", "s_nation"],
         "part": ["p_partkey", "p_mfgr", "p_category"]}
KEYS = ["d_year", "s_nation", "p_category"]
ORDER = [("d_year", "asc"), ("s_nation", "asc"), ("p_category", "asc")]


def answer(v, p, acc):
    mfgr = v.codes_where("part", "p_mfgr", lambda s: s in p["mfgrs"])
    year = date_attr(v, "d_year")
    mask = (dim(v, "customer", "c_region") == v.code("customer", "c_region", p["region"])) \
        & (dim(v, "supplier", "s_region") == v.code("supplier", "s_region", p["region"])) \
        & ((year == p["year"]) | (year == p["year_next"])) \
        & mfgr[dim(v, "part", "p_mfgr").long()]
    keys = {"d_year": ("date", "d_year", year),
            "s_nation": ("supplier", "s_nation", dim(v, "supplier", "s_nation")),
            "p_category": ("part", "p_category", dim(v, "part", "p_category"))}
    profit = v.col("lineorder", "lo_revenue") - v.col("lineorder", "lo_supplycost")
    return grouped_sum(v, keys, profit, mask, acc,
                       ["d_year", "s_nation", "p_category", "profit"],
                       "profit")
