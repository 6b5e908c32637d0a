"""Tables of the Star Schema Benchmark, made on the device from the seed.

Values follow the SSB specification and dbgen's formulas; each departure is
listed under ``assumed`` in ``ssb_sf20.json``.  Every column of the five
tables is made.  ``generate`` draws every random column with one
``torch.Generator`` on ``device`` in a few large calls, then copies the
columns to the host, where the program and the reference take them.
"""

from __future__ import annotations

import datetime

import numpy as np
import torch

from olapbench.core.tables import Tables

MONTHS = ["Jan", "Feb", "Mar", "Apr", "May", "Jun", "Jul", "Aug", "Sep",
          "Oct", "Nov", "Dec"]
# TPC-H's word lists, which SSB's dbgen shares
COLORS = (
    "almond antique aquamarine azure beige bisque black blanched blue blush "
    "brown burlywood burnished chartreuse chiffon chocolate coral cornflower "
    "cornsilk cream cyan dark deep dim dodger drab firebrick floral forest "
    "frosted gainsboro ghost goldenrod green grey honeydew hot indian ivory "
    "khaki lace lavender lawn lemon light lime linen magenta maroon medium "
    "metallic midnight mint misty moccasin navajo navy olive orange orchid "
    "pale papaya peach peru pink plum powder puff purple red rose rosy royal "
    "saddle salmon sandy seashell sienna sky slate smoke snow spring steel "
    "tan thistle tomato turquoise violet wheat white yellow").split()
TYPES = [f"{a} {b} {c}" for a in ("STANDARD", "SMALL", "MEDIUM", "LARGE",
                                  "ECONOMY", "PROMO")
         for b in ("ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED")
         for c in ("TIN", "NICKEL", "BRASS", "STEEL", "COPPER")]
CONTAINERS = [f"{a} {b}" for a in ("SM", "LG", "MED", "JUMBO", "WRAP")
              for b in ("CASE", "BOX", "BAG", "JAR", "PKG", "PACK", "CAN",
                        "DRUM")]
SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY", "HOUSEHOLD"]
PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]
SHIPMODES = ["REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB"]
SEASONS = ["Christmas", "Fall", "Spring", "Summer", "Winter"]
HOLIDAYS = {(1, 1), (7, 4), (12, 25)}


def _names(cfg):
    nations = sorted(cfg["nations"])
    cities = [f"{n[:9]:<9}{d}" for n in nations for d in range(10)]
    mfgrs = [f"MFGR#{m}" for m in range(1, 6)]
    categories = [f"{m}{c}" for m in mfgrs for c in range(1, 6)]
    brands = [f"{c}{b}" for c in categories for b in range(1, 41)]
    return nations, cities, mfgrs, categories, brands


def _days(cfg, extra: int = 0):
    """dbgen's calendar: ``date.rows`` days from January 1 of the first
    year (2,556 days end on 1998-12-30), and ``extra`` days after them."""
    first = datetime.date(cfg["first_year"], 1, 1)
    return [first + datetime.timedelta(i)
            for i in range(cfg["date"]["rows"] + extra)]


def _key(d: datetime.date) -> int:
    return d.year * 10000 + d.month * 100 + d.day


def _season(d: datetime.date) -> str:
    return ("Christmas" if d.month == 12 else "Winter" if d.month <= 2 else
            "Spring" if d.month <= 5 else "Summer" if d.month <= 8 else
            "Fall")


def _coded(values):
    """(codes, dictionary) of a list of strings."""
    dictionary = sorted(set(values))
    index = {v: i for i, v in enumerate(dictionary)}
    return np.array([index[v] for v in values], np.int32), dictionary


def _text(g, device, n: int, width: int) -> np.ndarray:
    """``n`` strings of ``width`` random capital letters, as bytes."""
    letters = torch.randint(65, 91, (n, width), generator=g, device=device,
                            dtype=torch.uint8)
    return letters.cpu().numpy().view(f"S{width}").reshape(n)


def _phones(g, device, nation: np.ndarray) -> np.ndarray:
    """TPC-H's phone numbers: the nation's code (10-34), then 3, 3 and 4
    random digits."""
    n = len(nation)
    digits = torch.randint(48, 58, (n, 15), generator=g, device=device,
                           dtype=torch.uint8).cpu().numpy()
    code = nation.astype(np.int64) + 10
    digits[:, 0] = 48 + code // 10
    digits[:, 1] = 48 + code % 10
    digits[:, [2, 6, 10]] = ord("-")
    return digits.view("S15").reshape(n)


def domains(cfg) -> dict:
    """The value lists a mix draws query constants from."""
    nations, cities, mfgrs, categories, _ = _names(cfg)
    years = list(range(cfg["first_year"], cfg["first_year"] + cfg["years"]))
    return {
        "regions": list(cfg["regions"]),
        "nations_of": {r: [n for n in nations if cfg["nations"][n] == r]
                       for r in cfg["regions"]},
        "cities_of": {n: cities[i * 10:(i + 1) * 10]
                      for i, n in enumerate(nations)},
        "mfgrs": mfgrs,
        "categories": categories,
        "years": years,
        "yearmonths": [[y * 100 + m + 1, f"{MONTHS[m]}{y}"] for y in years
                       for m in range(12)],
    }


def _rows(cfg, table, scale):
    return max(1, int(round(cfg[table]["rows"] * scale)))


def generate(cfg, seed: int, device, scale: float = 1.0) -> Tables:
    t = Tables({name: {c: w for c, (_, w) in cfg[name]["columns"].items()}
                for name in ("lineorder", "date", "customer", "supplier",
                             "part")})
    nations, cities, mfgrs, categories, brands = _names(cfg)
    region_of = np.array([cfg["regions"].index(cfg["nations"][n])
                          for n in nations], dtype=np.int32)
    g = torch.Generator(device=device)
    g.manual_seed(seed)

    def randint(lo, hi, n):  # uniform over [lo, hi]
        return torch.randint(lo, hi + 1, (n,), generator=g, device=device,
                             dtype=torch.int32)

    def host(x):
        return x.cpu().numpy()

    # date: the calendar, one row a day
    days = _days(cfg)
    datekey = np.array([_key(d) for d in days], dtype=np.int32)

    def ints(f):
        return np.array([f(d) for d in days], np.int32)

    t.add("date", "d_datekey", datekey)
    t.add("date", "d_date", *_coded(
        [f"{d:%B} {d.day}, {d.year}" for d in days]))
    t.add("date", "d_dayofweek", *_coded([f"{d:%A}" for d in days]))
    t.add("date", "d_month", *_coded([f"{d:%B}" for d in days]))
    t.add("date", "d_year", ints(lambda d: d.year))
    t.add("date", "d_yearmonthnum", ints(lambda d: d.year * 100 + d.month))
    yearmonths = [ym for _, ym in domains(cfg)["yearmonths"]]
    t.add("date", "d_yearmonth",
          ints(lambda d: (d.year - cfg["first_year"]) * 12 + d.month - 1),
          yearmonths)
    t.add("date", "d_daynuminweek", ints(lambda d: (d.weekday() + 1) % 7 + 1))
    t.add("date", "d_daynuminmonth", ints(lambda d: d.day))
    t.add("date", "d_daynuminyear", ints(lambda d: d.timetuple().tm_yday))
    t.add("date", "d_monthnuminyear", ints(lambda d: d.month))
    # dbgen: (day of year - 1) / 7 + 1
    t.add("date", "d_weeknuminyear",
          ints(lambda d: (d.timetuple().tm_yday - 1) // 7 + 1))
    t.add("date", "d_sellingseason", *_coded([_season(d) for d in days]))
    t.add("date", "d_lastdayinweekfl", ints(lambda d: int(d.weekday() == 5)))
    t.add("date", "d_lastdayinmonthfl", ints(
        lambda d: int((d + datetime.timedelta(1)).month != d.month)))
    t.add("date", "d_holidayfl", ints(lambda d: int((d.month, d.day)
                                                     in HOLIDAYS)))
    t.add("date", "d_weekdayfl", ints(lambda d: int(d.weekday() < 5)))

    # customer and supplier: nation uniform, city a digit of that nation
    for table, p, word in (("customer", "c", "Customer"),
                           ("supplier", "s", "Supplier")):
        n = _rows(cfg, table, scale)
        nation = host(randint(0, len(nations) - 1, n))
        city = nation * 10 + host(randint(0, 9, n))
        keys = np.arange(1, n + 1, dtype=np.int32)
        t.add(table, f"{p}_{'custkey' if p == 'c' else 'suppkey'}", keys)
        t.add(table, f"{p}_name",
              np.char.add(f"{word}#".encode(), np.char.zfill(
                  keys.astype("S9"), 9)))
        t.add(table, f"{p}_address", _text(g, device, n, 25))
        t.add(table, f"{p}_city", city, cities)
        t.add(table, f"{p}_nation", nation, nations)
        t.add(table, f"{p}_region", region_of[nation], list(cfg["regions"]))
        t.add(table, f"{p}_phone", _phones(g, device, nation))
        if p == "c":
            t.add(table, "c_mktsegment", host(randint(0, 4, n)),
                  sorted(SEGMENTS))

    # part: mfgr, category of the mfgr, brand of the category
    n_part = _rows(cfg, "part", scale)
    mfgr = host(randint(0, 4, n_part))
    category = mfgr * 5 + host(randint(0, 4, n_part))
    t.add("part", "p_partkey", np.arange(1, n_part + 1, dtype=np.int32))
    # two distinct colour words
    first = host(randint(0, len(COLORS) - 1, n_part))
    second = (first + host(randint(1, len(COLORS) - 1, n_part))) % len(COLORS)
    t.add("part", "p_name", first * len(COLORS) + second,
          [f"{a} {b}" for a in COLORS for b in COLORS])
    t.add("part", "p_mfgr", mfgr, mfgrs)
    t.add("part", "p_category", category, categories)
    t.add("part", "p_brand1", category * 40 + host(randint(0, 39, n_part)),
          brands)
    t.add("part", "p_color", host(randint(0, len(COLORS) - 1, n_part)), COLORS)
    t.add("part", "p_type", host(randint(0, len(TYPES) - 1, n_part)), TYPES)
    t.add("part", "p_size", host(randint(1, 50, n_part)))
    t.add("part", "p_container",
          host(randint(0, len(CONTAINERS) - 1, n_part)), CONTAINERS)

    # lineorder: orders of four lines
    n = _rows(cfg, "lineorder", scale)
    row = torch.arange(n, device=device, dtype=torch.int32)
    t.add("lineorder", "lo_orderkey", host(row // 4 + 1))
    t.add("lineorder", "lo_linenumber", host(row % 4 + 1))
    del row
    dk = torch.from_numpy(np.array([_key(d) for d in _days(cfg, 90)],
                                   np.int32)).to(device)
    day = randint(0, len(days) - 1, n).long()
    t.add("lineorder", "lo_orderdate", host(dk[day]))
    t.add("lineorder", "lo_commitdate", host(dk[day + randint(30, 90, n)]))
    del dk, day
    t.add("lineorder", "lo_custkey",
          host(randint(1, t.rows("customer"), n)))
    t.add("lineorder", "lo_orderpriority", host(randint(0, 4, n)),
          PRIORITIES)
    t.add("lineorder", "lo_shippriority", np.zeros(n, np.int32), ["0"])
    t.add("lineorder", "lo_shipmode", host(randint(0, len(SHIPMODES) - 1, n)),
          sorted(SHIPMODES))
    partkey = randint(1, n_part, n)
    t.add("lineorder", "lo_partkey", host(partkey))
    t.add("lineorder", "lo_suppkey", host(randint(1, t.rows("supplier"), n)))
    quantity = randint(1, 50, n)
    t.add("lineorder", "lo_quantity", host(quantity))
    discount = randint(0, 10, n)
    t.add("lineorder", "lo_discount", host(discount))
    # TPC-H's retail price in cents
    price = 90000 + torch.remainder(partkey // 10, 20001) \
        + 100 * torch.remainder(partkey, 1000)
    del partkey
    ext = quantity * price
    del quantity
    t.add("lineorder", "lo_extendedprice", host(ext))
    revenue = ext * (100 - discount) // 100
    t.add("lineorder", "lo_revenue", host(revenue))
    del ext, discount
    tax = randint(0, 8, n)
    t.add("lineorder", "lo_tax", host(tax))
    line_total = (revenue.long() * (100 + tax)) // 100
    order = torch.arange(n, device=device) // 4
    total = torch.zeros((n + 3) // 4, dtype=torch.long, device=device)
    total.index_add_(0, order, line_total)
    t.add("lineorder", "lo_ordtotalprice", host(total[order].int()))
    del revenue, tax, line_total, order, total
    t.add("lineorder", "lo_supplycost", host(6 * price // 10))
    return t
