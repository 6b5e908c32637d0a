"""Q3.4: the same by city, both among two cities, in one month."""

from olapbench.reference.ssb_sf20 import date_attr, dim, grouped_sum

READS = {"lineorder": ["lo_custkey", "lo_suppkey", "lo_orderdate", "lo_revenue"],
         "customer": ["c_custkey", "c_city"],
         "supplier": ["s_suppkey", "s_city"],
         "date": ["d_datekey", "d_year", "d_yearmonth"]}
KEYS = ["c_city", "s_city", "d_year"]
ORDER = [("d_year", "asc"), ("revenue", "desc")]


def answer(v, p, acc):
    def side(table, p_):
        ok = v.codes_where(table, f"{p_}_city", lambda s: s in p["cities"])
        return ok[dim(v, table, f"{p_}_city").long()]
    dmask = date_attr(v, "d_yearmonth") == v.code("date", "d_yearmonth", p["month"][1])
    mask = side("customer", "c") & side("supplier", "s") & dmask
    keys = {"c_city": ("customer", "c_city", dim(v, "customer", "c_city")),
            "s_city": ("supplier", "s_city", dim(v, "supplier", "s_city")),
            "d_year": ("date", "d_year", date_attr(v, "d_year"))}
    return grouped_sum(v, keys, v.col("lineorder", "lo_revenue"), mask, acc,
                       ["c_city", "s_city", "d_year", "revenue"], "revenue")
