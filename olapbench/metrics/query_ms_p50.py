"""Median host wall of a query, ``query()`` call to the returned host
result, over every query completed in the window (ms)."""

import statistics


def read(run):
    walls = [q.wall_s * 1e3 for q in run.queries if q.error is None]
    return statistics.median(walls) if walls else None
