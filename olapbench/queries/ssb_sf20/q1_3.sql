SELECT SUM(lo_extendedprice * lo_discount) AS revenue
FROM lineorder JOIN date ON lo_orderdate = d_datekey
WHERE d_weeknuminyear = {week} AND d_year = {year} AND lo_discount BETWEEN {discount_lo} AND {discount_hi}
  AND lo_quantity BETWEEN {quantity_lo} AND {quantity_hi}
