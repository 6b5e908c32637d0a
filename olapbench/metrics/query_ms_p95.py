"""95th percentile of the same wall over every query of the window (ms),
Python's inclusive quantiles; however few queries the window completes, so
that a slower program reads a higher tail and never a missing one."""

import statistics


def read(run):
    walls = [q.wall_s * 1e3 for q in run.queries if q.error is None]
    if len(walls) < 2:
        return walls[0] if walls else None
    return statistics.quantiles(walls, n=100, method="inclusive")[94]
