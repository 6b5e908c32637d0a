SELECT SUM(lo_extendedprice * lo_discount) AS revenue
FROM lineorder JOIN date ON lo_orderdate = d_datekey
WHERE d_yearmonthnum = {month[0]} AND lo_discount BETWEEN {discount_lo} AND {discount_hi}
  AND lo_quantity BETWEEN {quantity_lo} AND {quantity_hi}
