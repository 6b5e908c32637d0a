"""Q1.1: SUM(lo_extendedprice * lo_discount) in one year, a discount band, quantity under 25."""

from olapbench.reference.ssb_sf20 import date_attr, q1

READS = {"lineorder": ["lo_orderdate", "lo_quantity", "lo_discount",
                       "lo_extendedprice"],
         "date": ["d_datekey", "d_year"]}
KEYS: list = []
ORDER: list = []


def answer(v, p, acc):
    def lo(c):
        return v.col("lineorder", c)

    mask = (date_attr(v, "d_year") == p["year"]) \
        & (lo("lo_discount") >= p["discount_lo"]) \
        & (lo("lo_discount") <= p["discount_hi"]) \
        & (lo("lo_quantity") < 25)
    return q1(v, mask, acc)
