"""Q3.1: SUM(lo_revenue) by customer nation, supplier nation and year,
both in one region, 1992-1997."""

from olapbench.reference.ssb_sf20 import date_attr, dim, grouped_sum

READS = {"lineorder": ["lo_custkey", "lo_suppkey", "lo_orderdate", "lo_revenue"],
         "customer": ["c_custkey", "c_region", "c_nation"],
         "supplier": ["s_suppkey", "s_region", "s_nation"],
         "date": ["d_datekey", "d_year"]}
KEYS = ["c_nation", "s_nation", "d_year"]
ORDER = [("d_year", "asc"), ("revenue", "desc")]


def answer(v, p, acc):
    def side(table, p_):
        return dim(v, table, f"{p_}_region") == v.code(table, f"{p_}_region", p["region"])
    dmask = date_attr(v, "d_year") <= 1997
    mask = side("customer", "c") & side("supplier", "s") & dmask
    keys = {"c_nation": ("customer", "c_nation", dim(v, "customer", "c_nation")),
            "s_nation": ("supplier", "s_nation", dim(v, "supplier", "s_nation")),
            "d_year": ("date", "d_year", date_attr(v, "d_year"))}
    return grouped_sum(v, keys, v.col("lineorder", "lo_revenue"), mask, acc,
                       ["c_nation", "s_nation", "d_year", "revenue"], "revenue")
