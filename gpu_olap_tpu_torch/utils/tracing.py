"""Tracing / logging of the port.

Copy of ``gpu_olap_tpu/utils/tracing.py`` (less its write-only
``_CONFIGURED`` flag): stdlib logging with a span helper that records
wall-clock per operator, feeding the metrics registry.
"""

from __future__ import annotations

import contextlib
import logging
import time


def configure(level: int = logging.INFO) -> None:
    """Initialize log output (application-side, like ``rust_usage.rs:8-11``)."""
    logging.basicConfig(
        level=level,
        format="%(asctime)s %(levelname)-5s %(name)s: %(message)s",
    )


def get_logger(name: str) -> logging.Logger:
    return logging.getLogger(name)


@contextlib.contextmanager
def span(logger: logging.Logger, label: str, metrics=None, **fields):
    """Operator-level span: debug log on entry, timing on exit."""
    start = time.perf_counter()
    logger.debug("enter %s %s", label, fields or "")
    try:
        yield
    finally:
        elapsed = time.perf_counter() - start
        logger.debug("exit %s in %.3f ms", label, elapsed * 1e3)
        if metrics is not None:
            metrics.record_span(label, elapsed, **fields)
