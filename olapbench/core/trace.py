"""The traced window: ``torch.profiler`` over the whole window, read back
into the device's busy time, its idle gaps and the device ops that took
the most time.

- busy: the union of the device-side events' intervals (kernels, copies,
  fills) within the window, so overlapping events count once;
- idle gaps: the window less that union; each named by what the host was
  doing at its middle: the query it belongs to (or ``between queries``)
  and the innermost host event open then;
- queries whose range holds no device event are counted: the profiler has
  been seen to drop a call's device events on the card.
"""

from __future__ import annotations

import collections
from typing import Optional

import numpy as np

PREFIX = "olapbench."
WINDOW = PREFIX + "window"
QUERY = PREFIX + "query:"
TOP = 10


class Tracer:
    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])

    def __enter__(self):
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        return self._prof.__exit__(*exc)

    @staticmethod
    def range(name: str):
        from torch.profiler import record_function

        return record_function(name)

    def summary(self) -> Optional[dict]:
        """Busy and window seconds, top device ops, top idle gaps."""
        import torch

        cpu_dev = torch.autograd.DeviceType.CPU
        dev, host = [], []
        for e in self._prof.profiler.kineto_results.events():
            start = e.start_ns()
            item = (start, start + e.duration_ns(), e.name())
            if e.device_type() == cpu_dev:
                host.append(item)
            elif not e.name().startswith(PREFIX):
                # the ranges below are also mirrored as device-side
                # annotations, which are no device work
                dev.append(item)
        window = [h for h in host if h[2] == WINDOW]
        if not window:
            return None
        w0, w1, _ = window[0]
        dev = [(max(s, w0), min(t, w1), n) for s, t, n in dev
               if t > w0 and s < w1]
        by_name: dict = collections.defaultdict(int)
        for s, t, n in dev:
            by_name[n] += t - s
        # union of the device intervals, and the gaps between
        busy, gaps, cursor = 0, [], w0
        for s, t, _ in sorted(dev):
            if s > cursor:
                gaps.append((cursor, s))
            if t > cursor:
                busy += t - max(s, cursor)
                cursor = t
        if cursor < w1:
            gaps.append((cursor, w1))
        queries = [h for h in host if h[2].startswith(QUERY)]
        starts = np.array(sorted(s for s, _, _ in dev), dtype=np.int64)
        silent = sum(
            1 for s, t, _ in queries
            if np.searchsorted(starts, t) - np.searchsorted(starts, s) == 0)
        others = [h for h in host if h[2] != WINDOW
                  and not h[2].startswith(QUERY)]
        h_start = np.array([h[0] for h in others], dtype=np.int64)
        h_end = np.array([h[1] for h in others], dtype=np.int64)
        top_gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]
        ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
        return {
            "busy_s": busy / 1e9,
            "window_s": (w1 - w0) / 1e9,
            "queries": len(queries),
            "queries_without_device_events": silent,
            "device_ops": [[n[:120], ns / 1e9] for n, ns in ranked],
            "idle_gaps": [[self._label(g, queries, others, h_start, h_end),
                           (g[1] - g[0]) / 1e9] for g in top_gaps],
        }

    @staticmethod
    def _label(gap, queries, others, h_start, h_end) -> str:
        mid = (gap[0] + gap[1]) // 2
        query = next((q[2][len(QUERY):] for q in queries
                      if q[0] <= mid <= q[1]), None)
        where = "between queries" if query is None else f"in {query}"
        open_ = np.flatnonzero((h_start <= mid) & (h_end >= mid))
        if len(open_) == 0:
            return f"{where}: host code outside any op"
        inner = open_[np.argmax(h_start[open_])]
        return f"{where}: {others[inner][2][:100]}"
