"""Q2.2: the same over a run of eight brands (a string BETWEEN), one supplier region."""

from olapbench.reference.ssb_sf20 import date_attr, dim, grouped_sum

READS = {"lineorder": ["lo_orderdate", "lo_partkey", "lo_suppkey", "lo_revenue"],
         "date": ["d_datekey", "d_year"],
         "part": ["p_partkey", "p_brand1"],
         "supplier": ["s_suppkey", "s_region"]}
KEYS = ["d_year", "p_brand1"]
ORDER = [("d_year", "asc"), ("p_brand1", "asc")]


def answer(v, p, acc):
    lo_b, hi_b = f"{p['category']}{p['brand_lo']}", f"{p['category']}{p['brand_hi']}"
    brands = v.codes_where("part", "p_brand1", lambda s: lo_b <= s <= hi_b)
    pmask = brands[dim(v, "part", "p_brand1").long()]
    mask = pmask & (dim(v, "supplier", "s_region")
                    == v.code("supplier", "s_region", p["region"]))
    keys = {"d_year": ("date", "d_year", date_attr(v, "d_year")),
            "p_brand1": ("part", "p_brand1", dim(v, "part", "p_brand1"))}
    return grouped_sum(v, keys, v.col("lineorder", "lo_revenue"), mask, acc,
                       ["revenue", "d_year", "p_brand1"], "revenue")
