SELECT c_city, s_city, d_year, SUM(lo_revenue) AS revenue
FROM customer JOIN lineorder ON lo_custkey = c_custkey
  JOIN supplier ON lo_suppkey = s_suppkey JOIN date ON lo_orderdate = d_datekey
WHERE (c_city = '{cities[0]}' OR c_city = '{cities[1]}') AND (s_city = '{cities[0]}' OR s_city = '{cities[1]}')
  AND d_yearmonth = '{month[1]}'
GROUP BY c_city, s_city, d_year
ORDER BY d_year ASC, revenue DESC
