"""Shared set-up of the benchmark's tests: the checkout's root on
``sys.path`` (the benchmark imports ``olapbench.*`` and the port from
there), and tiny scales that a CPU test run holds."""

import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: per configuration, the scale a CPU test uses: 240K lineorder rows (every
#: SSB query has rows, and flight 1's sums pass 2^31), 100K rows of x
SCALES = {"ssb_sf20": 0.002, "h2o_groupby_1e8": 0.001}


def pytest_configure(config):
    # one thread a test process: several workers on the CPU would otherwise
    # oversubscribe its cores and starve the timed windows
    import torch

    torch.set_num_threads(1)
