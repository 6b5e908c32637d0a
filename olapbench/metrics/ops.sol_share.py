"""Share of the card's memory rate (%): the bytes the window's queries need
(each column a query reads once at its declared width, plus its result
once), summed, over the traced window's device-busy seconds (the union of
the device events' intervals) times the card's data-sheet rate.  None
without a trace."""


def read(run):
    t = run.trace
    if not t or t["busy_s"] <= 0:
        return None
    needed = sum(q.bytes_needed for q in run.queries if q.error is None)
    return 100.0 * needed / (t["busy_s"] * run.memory_rate)
