"""The reference answers against answers worked out by hand on tables of a
few rows."""

import numpy as np
import pytest

from olapbench.core import spec
from olapbench.core.check import compare
from olapbench.core.tables import Tables
from olapbench.reference import plain

I = np.int32  # noqa: E741


def _ssb():
    cfg = spec.config("ssb_sf20")
    t = Tables({n: {c: w for c, (_, w) in cfg[n]["columns"].items()}
                for n in cfg["tables"]})
    t.add("date", "d_datekey", np.array([19930101, 19930108, 19940101], I))
    t.add("date", "d_year", np.array([1993, 1993, 1994], I))
    t.add("date", "d_yearmonthnum", np.array([199301, 199301, 199401], I))
    t.add("date", "d_yearmonth", np.array([0, 0, 1], I), ["Jan1993", "Jan1994"])
    t.add("date", "d_weeknuminyear", np.array([1, 2, 1], I))
    for table, p in (("customer", "c"), ("supplier", "s")):
        key = "custkey" if p == "c" else "suppkey"
        t.add(table, f"{p}_{key}", np.array([1, 2], I))
        t.add(table, f"{p}_city", np.array([0, 1], I),
              ["CANADA   1", "JAPAN    5"])
        t.add(table, f"{p}_nation", np.array([0, 1], I), ["CANADA", "JAPAN"])
        t.add(table, f"{p}_region", np.array([0, 1], I), ["AMERICA", "ASIA"])
    t.add("part", "p_partkey", np.array([1, 2, 3], I))
    t.add("part", "p_mfgr", np.array([0, 1, 1], I), ["MFGR#1", "MFGR#2"])
    t.add("part", "p_category", np.array([0, 1, 1], I), ["MFGR#12", "MFGR#22"])
    t.add("part", "p_brand1", np.array([0, 1, 2], I),
          ["MFGR#1221", "MFGR#2225", "MFGR#2229"])
    lo = {"lo_orderdate": [19930101, 19930108, 19940101, 19930101, 19930108],
          "lo_custkey": [1, 2, 1, 2, 1], "lo_partkey": [1, 2, 3, 2, 2],
          "lo_suppkey": [1, 2, 1, 2, 1], "lo_quantity": [10, 30, 20, 24, 40],
          "lo_discount": [2, 5, 3, 1, 6],
          "lo_extendedprice": [1000, 2000, 3000, 4000, 500],
          "lo_revenue": [980, 1900, 2910, 3960, 470],
          "lo_supplycost": [300, 500, 700, 900, 100]}
    for c, v in lo.items():
        t.add("lineorder", c, np.array(v, I))
    return plain.View(t, "cpu")


def _h2o():
    t = Tables({"x": {}, "x_exact": {}})
    ids = [f"id{i:010d}" for i in (1, 2, 3)]
    t.add("x", "id1", np.array([0, 1, 0, 1, 0, 0], I), ["id001", "id002"])
    t.add("x", "id2", np.array([0, 0, 1, 1, 0, 0], I), ["id001", "id002"])
    t.add("x", "id3", np.array([0, 1, 0, 1, 2, 0], I), ids)
    t.add("x", "id4", np.array([1, 2, 1, 2, 1, 1], I))
    t.add("x", "id6", np.array([3, 3, 1, 2, 1, 3], I))
    t.add("x", "v1", np.array([1, 2, 3, 4, 5, 1], I))
    t.add("x", "v2", np.array([10, 1, 7, 3, 2, 15], I))
    micro = np.array([1500000, 2250000, 500000, 1000000, 3000000, 1])
    t.add("x", "v3", micro / 1e6)
    t.add("x_exact", "v3_micro", micro)
    return plain.View(t, "cpu")


S = np.array
CASES = [
    ("ssb_sf20", "q1_1", {"year": 1993, "discount_lo": 1, "discount_hi": 3},
     {"revenue": S([6000])}),
    ("ssb_sf20", "q2_2", {"category": "MFGR#22", "brand_lo": 21,
                          "brand_hi": 28, "region": "ASIA"},
     {"revenue": S([5860]), "d_year": S([1993]), "p_brand1": S(["MFGR#2225"])}),
    ("ssb_sf20", "q3_3", {"cities": ["CANADA   1", "JAPAN    5"]},
     {"c_city": S(["JAPAN    5", "CANADA   1", "CANADA   1"]),
      "s_city": S(["JAPAN    5", "CANADA   1", "CANADA   1"]),
      "d_year": S([1993, 1993, 1994]), "revenue": S([5860, 1450, 2910])}),
    ("ssb_sf20", "q4_2", {"region": "AMERICA", "year": 1993, "year_next": 1994,
                          "mfgrs": ["MFGR#1", "MFGR#2"]},
     {"d_year": S([1993, 1993, 1994]),
      "s_nation": S(["CANADA", "CANADA", "CANADA"]),
      "p_category": S(["MFGR#12", "MFGR#22", "MFGR#22"]),
      "profit": S([680, 370, 2210])}),
    ("h2o_groupby_1e8", "q1", {}, {"id1": S(["id001", "id002"]),
                                   "v1": S([10, 6])}),
    ("h2o_groupby_1e8", "q3", {},
     {"id3": S(["id0000000001", "id0000000002", "id0000000003"]),
      "v1": S([5, 6, 5]), "v3": S([2.000001 / 3, 1.625, 3.0])}),
    ("h2o_groupby_1e8", "q5", {},
     {"id6": S([1, 2, 3]), "v1": S([8, 4, 4]), "v2": S([9, 3, 26]),
      "v3": S([3.5, 1.0, 3.750001])}),
    ("h2o_groupby_1e8", "q7", {},
     {"id3": S(["id0000000001", "id0000000002", "id0000000003"]),
      "range_v1_v2": S([-4, 3, 3])}),
]


@pytest.mark.parametrize("config,query,params,want", CASES,
                         ids=[f"{c}.{q}" for c, q, _, _ in CASES])
def test_reference_against_hand_worked_answers(config, query, params, want):
    view = _ssb() if config == "ssb_sf20" else _h2o()
    ref = spec.reference(config, query)
    got = ref.answer(view, params, plain.PRECISIONS["exact"])
    assert list(got) == list(want)
    # the hand-worked rows are in the query's ORDER BY order
    why, gap = compare(want, got, ref.KEYS, ref.ORDER)
    assert why is None and gap < 1e-15, (why, gap)


def test_lower_precision_wraps_int_sums():
    """The control's int32 sums wrap where int64 sums do not."""
    import torch

    inv = torch.tensor([0, 0, 1])
    v = torch.tensor([2**30, 2**30, 5], dtype=torch.int32)
    assert plain.sum_by(inv, 2, v, torch.int64).tolist() == [2**31, 5]
    assert plain.sum_by(inv, 2, v, torch.int32).tolist() == [-2**31, 5]
