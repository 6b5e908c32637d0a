SELECT d_year, s_nation, p_category, SUM(lo_revenue - lo_supplycost) AS profit
FROM date JOIN lineorder ON lo_orderdate = d_datekey JOIN customer ON lo_custkey = c_custkey
  JOIN supplier ON lo_suppkey = s_suppkey JOIN part ON lo_partkey = p_partkey
WHERE c_region = '{region}' AND s_region = '{region}' AND (d_year = {year} OR d_year = {year_next})
  AND (p_mfgr = '{mfgrs[0]}' OR p_mfgr = '{mfgrs[1]}')
GROUP BY d_year, s_nation, p_category
ORDER BY d_year, s_nation, p_category
