"""Median per query of the program's ``device_execute`` span (ms): the
interpreter from its first op to the result count read back."""

import statistics


def read(run):
    spans = [q.device_s * 1e3 for q in run.queries if q.device_s is not None]
    return statistics.median(spans) if spans else None
