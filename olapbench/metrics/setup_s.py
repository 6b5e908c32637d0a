"""Seconds from process start to the first timed query: imports, making
the tables, ``register``, the upload and one run of each query (and, in a
checkout's first run, the kernels' build)."""


def read(run):
    return run.setup_s
