"""Q4.3: the same by year, supplier city and brand; supplier in one
nation, one category, two years."""

from olapbench.reference.ssb_sf20 import date_attr, dim, grouped_sum

READS = {"lineorder": ["lo_orderdate", "lo_custkey", "lo_suppkey", "lo_partkey",
                       "lo_revenue", "lo_supplycost"],
         "date": ["d_datekey", "d_year"],
         "customer": ["c_custkey", "c_region"],
         "supplier": ["s_suppkey", "s_nation", "s_city"],
         "part": ["p_partkey", "p_category", "p_brand1"]}
KEYS = ["d_year", "s_city", "p_brand1"]
ORDER = [("d_year", "asc"), ("s_city", "asc"), ("p_brand1", "asc")]


def answer(v, p, acc):
    year = date_attr(v, "d_year")
    mask = (dim(v, "customer", "c_region") == v.code("customer", "c_region", p["region"])) \
        & (dim(v, "supplier", "s_nation") == v.code("supplier", "s_nation", p["nation"])) \
        & ((year == p["year"]) | (year == p["year_next"])) \
        & (dim(v, "part", "p_category") == v.code("part", "p_category", p["category"]))
    keys = {"d_year": ("date", "d_year", year),
            "s_city": ("supplier", "s_city", dim(v, "supplier", "s_city")),
            "p_brand1": ("part", "p_brand1", dim(v, "part", "p_brand1"))}
    profit = v.col("lineorder", "lo_revenue") - v.col("lineorder", "lo_supplycost")
    return grouped_sum(v, keys, profit, mask, acc,
                       ["d_year", "s_city", "p_brand1", "profit"], "profit")
