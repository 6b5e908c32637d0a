"""Each generator's sizes and domains at a tiny scale, and that a seed
fixes its tables."""

import numpy as np
import pytest
from conftest import SCALES

from olapbench.core import spec


def _make(config, seed=2**31 + 11):
    cfg = spec.config(config)
    return cfg, spec.generator(config).generate(cfg, seed, "cpu",
                                                SCALES[config])


def test_ssb_sizes_and_domains():
    cfg, t = _make("ssb_sf20")
    scale = SCALES["ssb_sf20"]
    for table in cfg["tables"]:
        assert t.arrow(table).column_names == list(cfg[table]["columns"])
        want = 2556 if table == "date" else round(cfg[table]["rows"] * scale)
        assert t.rows(table) == want
    d = {c: t.columns["date"][c].data for c in t.columns["date"]}
    assert d["d_datekey"][0] == 19920101 and d["d_datekey"][-1] == 19981230
    assert set(d["d_year"]) == set(range(1992, 1999))
    assert d["d_weeknuminyear"].min() == 1 and d["d_weeknuminyear"].max() == 53
    assert np.array_equal(d["d_yearmonthnum"], d["d_datekey"] // 100)
    months = t.dictionary("date", "d_yearmonth")
    assert len(months) == 84 and months[0] == "Jan1992"
    assert months[d["d_yearmonth"][-1]] == "Dec1998"
    assert np.array_equal(d["d_daynuminmonth"], d["d_datekey"] % 100)
    assert d["d_holidayfl"].sum() == 7 * 3  # Jan 1, Jul 4, Dec 25 a year

    lo = {c: t.columns["lineorder"][c].data for c in t.columns["lineorder"]}
    assert all(a.dtype == np.int32 for a in lo.values())
    assert np.isin(lo["lo_orderdate"], d["d_datekey"]).all()
    for fk, dim in (("lo_custkey", "customer"), ("lo_suppkey", "supplier"),
                    ("lo_partkey", "part")):
        assert lo[fk].min() >= 1 and lo[fk].max() <= t.rows(dim)
    assert lo["lo_quantity"].min() == 1 and lo["lo_quantity"].max() == 50
    assert lo["lo_discount"].min() == 0 and lo["lo_discount"].max() == 10
    pk = lo["lo_partkey"].astype(np.int64)
    price = 90000 + (pk // 10) % 20001 + 100 * (pk % 1000)
    assert np.array_equal(lo["lo_extendedprice"], lo["lo_quantity"] * price)
    assert np.array_equal(lo["lo_revenue"], lo["lo_extendedprice"].astype(
        np.int64) * (100 - lo["lo_discount"]) // 100)
    assert np.array_equal(lo["lo_supplycost"], 6 * price // 10)
    assert np.array_equal(lo["lo_orderkey"], np.arange(len(pk)) // 4 + 1)
    assert (lo["lo_commitdate"] > lo["lo_orderdate"]).all()
    total = np.bincount(lo["lo_orderkey"], weights=lo["lo_revenue"].astype(
        np.int64) * (100 + lo["lo_tax"]) // 100)
    assert np.array_equal(lo["lo_ordtotalprice"], total[lo["lo_orderkey"]])
    names = t.arrow("customer").column("c_name").to_pylist()
    assert names[0] == "Customer#000000001" and len(set(names)) == len(names)
    phones = t.arrow("supplier").column("s_phone").to_pylist()
    assert all(len(x) == 15 and x[2] == x[6] == x[10] == "-" for x in phones)

    for table, p in (("customer", "c"), ("supplier", "s")):
        cols = t.columns[table]
        nations = cols[f"{p}_nation"].dictionary
        cities = cols[f"{p}_city"].dictionary
        regions = cols[f"{p}_region"].dictionary
        assert len(nations) == 25 and len(cities) == 250 and len(regions) == 5
        for n, c, r in zip(cols[f"{p}_nation"].data, cols[f"{p}_city"].data,
                           cols[f"{p}_region"].data):
            assert cfg["nations"][nations[n]] == regions[r]
            assert cities[c][:9].rstrip() == nations[n][:9].rstrip()
    part = t.columns["part"]
    for m, c, b in zip(part["p_mfgr"].data, part["p_category"].data,
                       part["p_brand1"].data):
        brand = part["p_brand1"].dictionary[b]
        category = part["p_category"].dictionary[c]
        assert brand.startswith(category)
        assert category.startswith(part["p_mfgr"].dictionary[m])
        assert 1 <= int(brand[len(category):]) <= 40


def test_h2o_sizes_and_domains():
    cfg, t = _make("h2o_groupby_1e8")
    n = round(cfg["x"]["rows"] * SCALES["h2o_groupby_1e8"])
    x = t.columns["x"]
    assert set(x) == set(cfg["x"]["columns"]) and t.rows("x") == n
    assert x["id1"].dictionary[0] == "id001" and len(x["id1"].dictionary) == 100
    assert x["id3"].dictionary[0] == "id0000000001"
    assert len(x["id3"].dictionary) == n // 100
    assert x["id3"].data.max() < n // 100
    for c, hi in (("id4", 100), ("id5", 100), ("id6", n // 100), ("v1", 5),
                  ("v2", 15)):
        assert x[c].data.min() == 1 and x[c].data.max() == hi, c
    micro = t.columns["x_exact"]["v3_micro"].data
    assert np.array_equal(x["v3"].data, micro / 1e6)
    assert 0 <= x["v3"].data.min() and x["v3"].data.max() < 100
    assert np.array_equal(np.round(x["v3"].data, 6), x["v3"].data)


@pytest.mark.parametrize("config", sorted(SCALES))
def test_seed_fixes_the_tables(config):
    _, a = _make(config, 5)
    _, b = _make(config, 5)
    _, c = _make(config, 6)
    same = differ = True
    for table, cols in a.columns.items():
        for name, col in cols.items():
            same &= np.array_equal(col.data, b.columns[table][name].data)
    differ = any(not np.array_equal(col.data, c.columns[table][name].data)
                 for table, cols in a.columns.items()
                 for name, col in cols.items())
    assert same and differ
