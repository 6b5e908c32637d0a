"""Q3.2: the same by city, both in one nation, 1992-1997."""

from olapbench.reference.ssb_sf20 import date_attr, dim, grouped_sum

READS = {"lineorder": ["lo_custkey", "lo_suppkey", "lo_orderdate", "lo_revenue"],
         "customer": ["c_custkey", "c_nation", "c_city"],
         "supplier": ["s_suppkey", "s_nation", "s_city"],
         "date": ["d_datekey", "d_year"]}
KEYS = ["c_city", "s_city", "d_year"]
ORDER = [("d_year", "asc"), ("revenue", "desc")]


def answer(v, p, acc):
    def side(table, p_):
        return dim(v, table, f"{p_}_nation") == v.code(table, f"{p_}_nation", p["nation"])
    dmask = date_attr(v, "d_year") <= 1997
    mask = side("customer", "c") & side("supplier", "s") & dmask
    keys = {"c_city": ("customer", "c_city", dim(v, "customer", "c_city")),
            "s_city": ("supplier", "s_city", dim(v, "supplier", "s_city")),
            "d_year": ("date", "d_year", date_attr(v, "d_year"))}
    return grouped_sum(v, keys, v.col("lineorder", "lo_revenue"), mask, acc,
                       ["c_city", "s_city", "d_year", "revenue"], "revenue")
