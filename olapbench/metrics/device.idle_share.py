"""Share of the traced window (%) in which no device event ran: one less
the union of the device events' intervals over the window's wall, both
from the same traced run."""


def read(run):
    t = run.trace
    if not t or t["busy_s"] <= 0 or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
