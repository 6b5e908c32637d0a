"""Tracing / logging of the port.

From ``gpu_olap_tpu/utils/tracing.py`` (less its write-only ``_CONFIGURED``
flag): stdlib logging with a span helper that times an operator and feeds
the metrics registry.  The port adds a process-wide span recorder, off by
default:

    with tracing.record() as rec:
        engine.query(sql)
    rec.spans   # every span closed while it was open

Off, ``span`` makes one global check and returns a shared no-op context:
no clock reading, no profiler range, nothing allocated, nothing logged
unless the logger is at DEBUG.  A span handed a ``metrics`` registry still
records into it, on or off, as the JAX package's does.

On, each span keeps its name, its query id, its parent's id, its host start
and end (``time.perf_counter_ns``) and its fields.  Nesting follows a
``contextvars`` variable, so the pool threads of ``query_async`` keep their
queries apart; a ``query`` span given ``query_id=`` starts a query, and the
spans under it carry that id.  While ``torch.profiler`` also runs, each span
opens a ``record_function`` range named ``PREFIX + label``, so the trace
stamps the program's spans and the device's events on one timeline.  The
recorder is the one switch: a profiler without it sees no program ranges.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import itertools
import logging
import time
from typing import Iterator, List, Optional

#: the name prefix of the program's ``record_function`` ranges
PREFIX = "olap/"

#: the open recorder, or None (every span's one check)
_RECORDER: Optional["Recorder"] = None
#: the innermost open recorded span of this context
_CURRENT: contextvars.ContextVar = contextvars.ContextVar(
    "olap_span", default=None)
_QUERY_IDS = itertools.count(1)


def configure(level: int = logging.INFO) -> None:
    """Initialize log output (application-side, like ``rust_usage.rs:8-11``)."""
    logging.basicConfig(
        level=level,
        format="%(asctime)s %(levelname)-5s %(name)s: %(message)s",
    )


def get_logger(name: str) -> logging.Logger:
    return logging.getLogger(name)


def next_query_id() -> int:
    """A process-wide query id (``QueryResult.metrics["query_id"]``)."""
    return next(_QUERY_IDS)


@dataclasses.dataclass
class Span:
    name: str
    span_id: int
    parent_id: Optional[int]
    query_id: Optional[int]
    start_ns: int
    end_ns: int = 0
    fields: dict = dataclasses.field(default_factory=dict)

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


class Recorder:
    """The spans closed while it was open, in the order they closed."""

    def __init__(self):
        self.spans: List[Span] = []
        self._ids = itertools.count(1)


@contextlib.contextmanager
def record() -> Iterator[Recorder]:
    """Record every span closed inside the block, in memory."""
    global _RECORDER
    rec = Recorder()
    prev, _RECORDER = _RECORDER, rec
    try:
        yield rec
    finally:
        _RECORDER = prev


def annotate(**fields) -> None:
    """Add ``fields`` to the innermost open recorded span (a route taken, a
    count known only at its end); nothing when the recorder is off."""
    if _RECORDER is None:
        return
    cur = _CURRENT.get()
    if cur is not None:
        cur.fields.update(fields)


class _Off:
    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Timed:
    """A span that times (and logs) its body, records into ``metrics``
    where given and, with a recorder, into it and the profiler."""

    def __init__(self, logger, label, metrics, fields, rec):
        self.logger, self.label, self.metrics = logger, label, metrics
        self.fields, self.rec = fields, rec
        self.span = self.token = self.range = None

    def __enter__(self):
        self.logger.debug("enter %s %s", self.label, self.fields or "")
        rec = self.rec
        if rec is not None:
            parent = _CURRENT.get()
            qid = self.fields.get("query_id",
                                  parent.query_id if parent else None)
            self.span = Span(self.label, next(rec._ids),
                             parent.span_id if parent else None, qid, 0,
                             fields=self.fields)
            self.token = _CURRENT.set(self.span)
            import torch.autograd.profiler as prof

            if prof._is_profiler_enabled:
                self.range = prof.record_function(PREFIX + self.label)
                self.range.__enter__()
        self.start = time.perf_counter_ns()
        if self.span is not None:
            self.span.start_ns = self.start
        return None

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        elapsed = (end - self.start) / 1e9
        if self.range is not None:
            self.range.__exit__(None, None, None)
        if self.span is not None:
            self.span.end_ns = end
            _CURRENT.reset(self.token)
            self.rec.spans.append(self.span)
        self.logger.debug("exit %s in %.3f ms", self.label, elapsed * 1e3)
        if self.metrics is not None:
            self.metrics.record_span(self.label, elapsed, **self.fields)
        return False


def span(logger: logging.Logger, label: str, metrics=None, **fields):
    """Operator-level span: debug log on entry, timing on exit; records into
    ``metrics`` where given and into the open recorder, if any."""
    rec = _RECORDER
    if rec is None and metrics is None \
            and not logger.isEnabledFor(logging.DEBUG):
        return _OFF
    return _Timed(logger, label, metrics, fields, rec)
