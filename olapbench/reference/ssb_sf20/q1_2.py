"""Q1.2: the same in one month, a discount band and a quantity band."""

from olapbench.reference.ssb_sf20 import date_attr, q1

READS = {"lineorder": ["lo_orderdate", "lo_quantity", "lo_discount",
                       "lo_extendedprice"],
         "date": ["d_datekey", "d_yearmonthnum"]}
KEYS: list = []
ORDER: list = []


def answer(v, p, acc):
    def lo(c):
        return v.col("lineorder", c)

    mask = (date_attr(v, "d_yearmonthnum") == p["month"][0]) \
        & (lo("lo_discount") >= p["discount_lo"]) \
        & (lo("lo_discount") <= p["discount_hi"]) \
        & ((lo("lo_quantity") >= p["quantity_lo"]) & (lo("lo_quantity") <= p["quantity_hi"]))
    return q1(v, mask, acc)
