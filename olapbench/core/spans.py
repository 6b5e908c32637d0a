"""Device time and idle gaps of one ``torch.profiler`` trace, attributed to
the program's own spans (``gpu_olap_tpu_torch/utils/tracing.py``: with its
recorder open, each span is a ``record_function`` range named ``olap/...``,
so Kineto stamps the spans and the device's events on one timeline).

- device work: every device-side event but the user annotations, which are
  the host's ranges mirrored onto the device and no work of the card; told
  apart by their kind, not their name;
- attribution: a device event is linked to the runtime call that launched
  it by the correlation id the two share (else to the host op it links
  to); the innermost program span open at that launch, on its thread, owns
  the event's time.  An event with no linked launch, or launched under no
  program span, is unattributed;
- idle time: the window less the union of the device work, split over
  the innermost program span open over each stretch of it; the ten longest
  gaps are named by their query, the innermost program span and the
  innermost other host op open at their middle.

Everything here works on :class:`Event` lists, so the tests build them by
hand; :func:`events_of` reads them from a finished profiler.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import statistics
from typing import Dict, Iterable, List, Optional, Sequence

#: the program's span prefix (``tracing.PREFIX``), written out so that
#: reading a trace needs no import of the program
PROGRAM = "olap/"
BENCH = "olapbench."
QUERY = BENCH + "query:"
TOP = 10


@dataclasses.dataclass(frozen=True)
class Event:
    name: str
    #: Kineto's activity type: ``kernel``, ``gpu_memcpy``, ``gpu_memset``,
    #: ``gpu_user_annotation``, ``cuda_runtime``, ``cuda_driver``,
    #: ``cpu_op``, ``user_annotation`` ...
    kind: str
    on_device: bool
    start: int          # ns, one clock for host and device
    end: int
    thread: int = 0
    corr: int = 0       # the event's correlation id
    linked: int = 0     # the correlation id of the host op it links to
    annotation: bool = False


def events_of(prof) -> List[Event]:
    """The events of a finished ``torch.profiler.profile``."""
    import torch

    cpu = torch.autograd.DeviceType.CPU
    out = []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        kind = e.activity_type() if hasattr(e, "activity_type") else ""
        out.append(Event(e.name(), str(kind), e.device_type() != cpu, start,
                         start + e.duration_ns(), e.start_thread_id(),
                         e.correlation_id(), e.linked_correlation_id(),
                         bool(e.is_user_annotation())))
    return out


def is_runtime(e: Event) -> bool:
    """A CUDA runtime or driver call on the host.  Where the profiler names
    no kinds, such a call is the host event that links to an op: an op of
    its own links to nothing."""
    return not e.on_device and (e.kind in ("cuda_runtime", "cuda_driver")
                                or (not e.kind and e.linked != 0))


def is_work(e: Event) -> bool:
    """A device-side event that is the card's work, not a mirrored range."""
    return e.on_device and not (e.annotation or "user_annotation" in e.kind)


def clip(events: Iterable[Event], w0: int, w1: int) -> List[Event]:
    return [dataclasses.replace(e, start=max(e.start, w0), end=min(e.end, w1))
            for e in events if e.end > w0 and e.start < w1]


def union(work: Sequence[Event], w0: int, w1: int):
    """(busy ns, idle gaps) of device work clipped to ``[w0, w1]``."""
    busy, gaps, cursor = 0, [], w0
    for e in sorted(work, key=lambda e: (e.start, e.end)):
        if e.start > cursor:
            gaps.append((cursor, e.start))
        if e.end > cursor:
            busy += e.end - max(e.start, cursor)
            cursor = e.end
    if cursor < w1:
        gaps.append((cursor, w1))
    return busy, gaps


def span_name(e: Event) -> str:
    return e.name[len(PROGRAM):]


def attribute(events: Sequence[Event], w0: int, w1: int) -> dict:
    """Device ns of the window's work by owning program span, and each
    event's owner: ``{"work": [...], "owners": [name or None, ...],
    "anchors": [host ns of the launching op or None, ...]}``."""
    work = [e for e in clip(events, w0, w1) if is_work(e)]
    host = [e for e in events if not e.on_device]
    # ops and runtime calls number their correlation ids apart
    ops = {e.corr: e for e in host if e.corr and not is_runtime(e)}
    runtime = {e.corr: e for e in host if e.corr and is_runtime(e)}
    # the launching runtime call, else the op the event links to
    anchors: List[Optional[Event]] = [
        runtime.get(e.corr) or (ops.get(e.linked) if e.linked else None)
        for e in work]
    by_thread: Dict[int, list] = collections.defaultdict(list)
    for j, op in enumerate(anchors):
        if op is not None:
            by_thread[op.thread].append(j)
    spans = collections.defaultdict(list)
    for e in host:
        if e.name.startswith(PROGRAM):
            spans[e.thread].append(e)
    owners: List[Optional[str]] = [None] * len(work)
    for thread, idx in by_thread.items():
        ranges = spans.get(thread, [])
        inner = _innermost(ranges, [anchors[j].start for j in idx])
        for j, k in zip(idx, inner):
            if k is not None:
                owners[j] = span_name(ranges[k])
    return {"work": work, "owners": owners,
            "anchors": [None if a is None else a.start for a in anchors]}


def _segments(ranges: Sequence[Event]) -> list:
    """The time line as ``(start, end, index)`` pieces, each with the
    latest-started range of ``ranges`` open over it; none where none is."""
    marks = sorted([(r.start, 0, i) for i, r in enumerate(ranges)]
                   + [(r.end, 2, i) for i, r in enumerate(ranges)])
    stack: list = []
    out = []
    prev = None
    for t, what, i in marks:
        if stack and t > prev:
            out.append((prev, t, stack[-1]))
        prev = t
        if what == 0:
            stack.append(i)
        elif stack and stack[-1] == i:
            stack.pop()
        elif i in stack:
            stack.remove(i)
    return out


def _innermost(ranges: Sequence[Event], points: Sequence[int]) -> list:
    """For each time in ``points``, the index of the latest-started range
    of ``ranges`` open at it, or None: on one thread, whose ranges nest,
    the innermost.  A point on a range's edge lies inside it."""
    segs = _segments(ranges)
    starts = [seg[0] for seg in segs]
    out = []
    for t in points:
        i = bisect.bisect_right(starts, t) - 1
        out.append(segs[i][2] if i >= 0 and t <= segs[i][1] else None)
    return out


def idle_by_span(gaps, spans) -> Dict[str, int]:
    """Idle ns by the innermost program span open over each stretch of each
    gap; ``(no span)`` where none is."""
    segs = _segments(spans)
    out: Dict[str, int] = collections.defaultdict(int)
    j = 0
    for g0, g1 in sorted(gaps):
        while j < len(segs) and segs[j][1] <= g0:
            j += 1
        covered = 0
        k = j
        while k < len(segs) and segs[k][0] < g1:
            part = min(g1, segs[k][1]) - max(g0, segs[k][0])
            if part > 0:
                out[span_name(spans[segs[k][2]])] += part
                covered += part
            k += 1
        if g1 - g0 > covered:
            out["(no span)"] += g1 - g0 - covered
    return out


def gap_labels(gaps, queries, spans, ops) -> list:
    """(label, program span or None) of each idle gap, by what the host was
    in at its middle (the latest-started query, program span and other host
    op open there): ``in q3: to_host > aten::copy_``."""
    mids = [(g[0] + g[1]) // 2 for g in gaps]
    q_at, s_at, op_at = (_innermost(r, mids) for r in (queries, spans, ops))
    out = []
    for qi, si, oi in zip(q_at, s_at, op_at):
        where = "between queries" if qi is None else \
            f"in {queries[qi].name[len(QUERY):]}"
        parts = [] if si is None else [span_name(spans[si])]
        if oi is not None:
            parts.append(ops[oi].name)
        if not parts:
            out.append((f"{where}: host code outside any op", None))
        else:
            out.append((f"{where}: {' > '.join(parts)}"[:100],
                        None if si is None else span_name(spans[si])))
    return out


def summary(events: Sequence[Event]) -> Optional[dict]:
    """The window's busy and idle time, attributed.  None without the
    benchmark's ``olapbench.window`` range."""
    window = [e for e in events if not e.on_device
              and e.name == BENCH + "window"]
    if not window:
        return None
    w0, w1 = window[0].start, window[0].end
    att = attribute(events, w0, w1)
    work, owners = att["work"], att["owners"]
    busy, gaps = union(work, w0, w1)
    host = [e for e in events if not e.on_device]
    queries = [e for e in host if e.name.startswith(QUERY)]
    spans = [e for e in host if e.name.startswith(PROGRAM)]
    ops = [e for e in host if not e.name.startswith((PROGRAM, BENCH))]
    device_by_span: Dict[str, int] = collections.defaultdict(int)
    for e, o in zip(work, owners):
        device_by_span[o or "(unattributed)"] += e.end - e.start
    # per query, device ns by owning span, placed by the launching op
    q_sorted = sorted(queries, key=lambda e: e.start)
    starts = [q.start for q in q_sorted]
    per_query = [collections.defaultdict(int) for _ in q_sorted]
    for e, o, t in zip(work, owners, att["anchors"]):
        if t is None or o is None:
            continue
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t <= q_sorted[i].end:
            per_query[i][o] += e.end - e.start
    top = sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]
    labels = gap_labels(top, queries, spans, ops)
    idle = idle_by_span(gaps, spans)
    total = sum(e.end - e.start for e in work)
    return {
        "busy_s": busy / 1e9,
        "window_s": (w1 - w0) / 1e9,
        "queries": len(queries),
        "device_s_by_span": {k: v / 1e9 for k, v in sorted(
            device_by_span.items(), key=lambda kv: -kv[1])},
        "idle_s_by_span": {k: v / 1e9 for k, v in sorted(
            idle.items(), key=lambda kv: -kv[1])},
        "unattributed_share": (device_by_span.get("(unattributed)", 0)
                               / total) if total else None,
        "idle_gaps": [[label, (g[1] - g[0]) / 1e9]
                      for (label, _), g in zip(labels, top)],
        "per_query_ms": [{k: v / 1e6 for k, v in d.items()}
                         for d in per_query],
    }


def median_ms(summary_: dict, span: str) -> Optional[float]:
    """Median per query of the device ms owned by ``span``, over the
    queries with such time."""
    vals = [d[span] for d in summary_["per_query_ms"] if d.get(span)]
    return statistics.median(vals) if vals else None
