"""Input rows of every query completed in the window (every row of every
table a query reads, both sides of a join) over the window's seconds."""


def read(run):
    rows = sum(q.rows_in for q in run.queries if q.error is None)
    return rows / run.window_s if rows else None
