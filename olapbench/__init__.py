"""The port's benchmark: cells, configurations, mixes and metrics named in
BENCHMARK.json; run one cell with ``python3 olapbench/run.py``."""
