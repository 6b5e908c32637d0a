SELECT d_year, c_nation, SUM(lo_revenue - lo_supplycost) AS profit
FROM date JOIN lineorder ON lo_orderdate = d_datekey JOIN customer ON lo_custkey = c_custkey
  JOIN supplier ON lo_suppkey = s_suppkey JOIN part ON lo_partkey = p_partkey
WHERE c_region = '{region}' AND s_region = '{region}' AND (p_mfgr = '{mfgrs[0]}' OR p_mfgr = '{mfgrs[1]}')
GROUP BY d_year, c_nation
ORDER BY d_year, c_nation
