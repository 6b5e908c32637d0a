"""Median of the program's ``QueryResult.metrics["plan_seconds"]`` (ms):
parse, optimize and physical plan."""

import statistics


def read(run):
    plans = [q.plan_s * 1e3 for q in run.queries if q.plan_s is not None]
    return statistics.median(plans) if plans else None
