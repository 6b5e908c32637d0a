"""Metrics / observability of the port.

Copy of ``gpu_olap_tpu/utils/metrics.py`` kept inside this package, so that
the port has its own registry: per-operator wall clock, rows in/out and bytes
touched (``record_span``), and the route counters (``bump``) that
``TorchOlapEngine`` reports as ``metrics["routes"]``.  The reference's
roofline fraction is left out: it needs a memory rate of the device, which
this registry does not measure.  Every method takes the registry's lock:
engines on other devices, each under its own device lock, bump counters
from their pool threads while another engine reads them.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Dict, List


@dataclasses.dataclass
class OpStats:
    calls: int = 0
    seconds: float = 0.0
    rows_in: int = 0
    rows_out: int = 0
    bytes_accessed: int = 0

    @property
    def rows_per_sec(self) -> float:
        return self.rows_in / self.seconds if self.seconds > 0 else 0.0


class MetricsRegistry:
    def __init__(self):
        self.ops: Dict[str, OpStats] = collections.defaultdict(OpStats)
        self.counters: Dict[str, float] = collections.defaultdict(float)
        self._lock = threading.Lock()

    def record_span(self, label: str, seconds: float, rows_in: int = 0,
                    rows_out: int = 0, bytes_accessed: int = 0, **_):
        with self._lock:
            st = self.ops[label]
            st.calls += 1
            st.seconds += seconds
            st.rows_in += rows_in
            st.rows_out += rows_out
            st.bytes_accessed += bytes_accessed

    def bump(self, name: str, value: float = 1.0):
        with self._lock:
            self.counters[name] += value

    def snapshot(self) -> Dict[str, float]:
        """A copy of the counters, taken under the lock."""
        with self._lock:
            return dict(self.counters)

    def summary(self) -> List[dict]:
        with self._lock:
            ops = sorted((label, dataclasses.replace(st))
                         for label, st in self.ops.items())
        out = []
        for label, st in ops:
            out.append({
                "op": label,
                "calls": st.calls,
                "seconds": round(st.seconds, 6),
                "rows_in": st.rows_in,
                "rows_out": st.rows_out,
                "bytes": st.bytes_accessed,
                "rows_per_sec": round(st.rows_per_sec, 1),
            })
        return out

    def reset(self):
        with self._lock:
            self.ops.clear()
            self.counters.clear()


GLOBAL_METRICS = MetricsRegistry()


class Timer:
    def __enter__(self):
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self.start
        return False
