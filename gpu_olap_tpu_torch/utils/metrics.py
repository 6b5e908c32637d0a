"""Metrics / observability of the port.

Copy of ``gpu_olap_tpu/utils/metrics.py`` kept inside this package, so that
the port has its own registry: per-operator wall clock, rows in/out and bytes
touched (``record_span``), the route counters (``bump``) that
``TorchOlapEngine`` reports as ``metrics["routes"]``, and the roofline
fraction of an operator: its bytes per second over the memory rate of the
device that ran it.  Every method takes the registry's lock: engines on
other devices, each under its own device lock, bump counters from their
pool threads while another engine reads them.

The registry is process-wide and serves engines on several devices, so the
rate is not one property of the registry as in the JAX package: each span
names the device it ran on (``record_span(..., device=...)``; the device
and streaming executors pass their own), and ``hbm_bandwidth(label)`` is
the rate of the device that recorded ``label``'s spans.  A label whose
spans name no device, or devices of different rates, has no single rate:
``roofline_fraction`` raises for it and ``summary`` reports None.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Dict, FrozenSet, List, Optional

import torch

#: device-memory rate (bytes/s) by device name, lower-cased substrings of
#: what ``torch.cuda.get_device_name`` and ``nvidia-smi`` print; NVIDIA's
#: data sheets.  ``"cpu"`` is the JAX package's host figure.
HBM_BW_BY_PLATFORM = {
    "h100 80gb hbm3": 3.35e12,   # H100 SXM5, 80 GB HBM3
    "h100 pcie": 2.0e12,         # H100 PCIe, 80 GB HBM2e
    "h100 nvl": 3.9e12,          # H100 NVL, 94 GB HBM3
    "cpu": 5.0e10,
}


def hbm_bandwidth_of(name: str) -> float:
    """The rate of the card called ``name``; raises for a card that is not
    in :data:`HBM_BW_BY_PLATFORM` (never a guess)."""
    low = name.lower()
    for key, bw in HBM_BW_BY_PLATFORM.items():
        if key != "cpu" and key in low:
            return bw
    raise LookupError(f"no memory rate for the card {name!r}: add it to "
                      "HBM_BW_BY_PLATFORM")


def detect_hbm_bandwidth(device) -> float:
    """Memory rate (bytes/s) of ``device`` ("cpu", "cuda", "cuda:N" or a
    ``torch.device``): the CPU entry for the CPU, the card's data-sheet rate
    for a CUDA device."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return HBM_BW_BY_PLATFORM["cpu"]
    if dev.type == "cuda":
        return hbm_bandwidth_of(torch.cuda.get_device_name(dev))
    raise ValueError(f"no memory rate for device type {dev.type!r}")


@dataclasses.dataclass
class OpStats:
    calls: int = 0
    seconds: float = 0.0
    rows_in: int = 0
    rows_out: int = 0
    bytes_accessed: int = 0
    #: the devices the spans ran on (replaced, never mutated, so a copy
    #: taken under the lock stays valid)
    devices: FrozenSet[str] = frozenset()

    @property
    def rows_per_sec(self) -> float:
        return self.rows_in / self.seconds if self.seconds > 0 else 0.0


class MetricsRegistry:
    def __init__(self):
        self.ops: Dict[str, OpStats] = collections.defaultdict(OpStats)
        self.counters: Dict[str, float] = collections.defaultdict(float)
        self._lock = threading.Lock()

    def record_span(self, label: str, seconds: float, rows_in: int = 0,
                    rows_out: int = 0, bytes_accessed: int = 0,
                    device=None, **_):
        dev = None if device is None else str(torch.device(device))
        with self._lock:
            st = self.ops[label]
            st.calls += 1
            st.seconds += seconds
            st.rows_in += rows_in
            st.rows_out += rows_out
            st.bytes_accessed += bytes_accessed
            if dev is not None and dev not in st.devices:
                st.devices = st.devices | {dev}

    def bump(self, name: str, value: float = 1.0):
        with self._lock:
            self.counters[name] += value

    def snapshot(self) -> Dict[str, float]:
        """A copy of the counters, taken under the lock."""
        with self._lock:
            return dict(self.counters)

    def _stats(self, label: str) -> Optional[OpStats]:
        with self._lock:
            st = self.ops.get(label)
            return None if st is None else dataclasses.replace(st)

    @staticmethod
    def _rate(label: str, st: Optional[OpStats]) -> float:
        devices = st.devices if st is not None else frozenset()
        rates = {detect_hbm_bandwidth(d) for d in devices}
        if len(rates) != 1:
            raise ValueError(f"spans of {label!r} ran on {sorted(devices)}: "
                             "no single memory rate")
        return rates.pop()

    def hbm_bandwidth(self, label: str) -> float:
        """Memory rate (bytes/s) of the device that ran ``label``'s spans."""
        return self._rate(label, self._stats(label))

    def _fraction(self, label: str, st: Optional[OpStats]) -> float:
        if st is None or st.seconds == 0:
            return 0.0
        return (st.bytes_accessed / st.seconds) / self._rate(label, st)

    def roofline_fraction(self, label: str) -> float:
        """Achieved memory-rate fraction for an operator."""
        return self._fraction(label, self._stats(label))

    def summary(self) -> List[dict]:
        with self._lock:
            ops = sorted((label, dataclasses.replace(st))
                         for label, st in self.ops.items())
        out = []
        for label, st in ops:
            try:
                frac = round(self._fraction(label, st), 4)
            except ValueError:  # no device, or devices of different rates
                frac = None
            out.append({
                "op": label,
                "calls": st.calls,
                "seconds": round(st.seconds, 6),
                "rows_in": st.rows_in,
                "rows_out": st.rows_out,
                "bytes": st.bytes_accessed,
                "rows_per_sec": round(st.rows_per_sec, 1),
                "hbm_roofline_frac": frac,
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
