"""Median per query of ``exec_seconds`` less that query's
``device_execute`` span (ms): the result's copy to the host and its host
columns, plus any capacity regrow's rerun."""

import statistics


def read(run):
    rest = [(q.exec_s - q.device_s) * 1e3 for q in run.queries
            if q.device_s is not None and q.exec_s is not None]
    return statistics.median(rest) if rest else None
