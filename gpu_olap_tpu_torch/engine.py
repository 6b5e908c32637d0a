"""Engine entry point of the PyTorch port.

``TorchOlapEngine`` keeps ``OlapEngine``'s surface (``register``,
``load_table``, ``query``, ``query_pandas``, ``explain``, the result cache
and the device lock) and replaces its execution with the torch device
executor on one explicit device.  Plans the torch path does not cover
(UNION, cross joins, out-of-core tables, multi-device meshes) run on the CPU
oracle and say so in ``metrics["backend"] == "cpu-fallback"``.
``metrics["routes"]`` names the device routes the query took: the
``torch_*`` counters of ``GLOBAL_METRICS`` that its execution bumped.
"""

from __future__ import annotations

from typing import Optional

from gpu_olap_tpu.config import EngineConfig
from gpu_olap_tpu.engine import OlapEngine
from gpu_olap_tpu.executor.cpu import CpuExecutor
from gpu_olap_tpu.executor.result import QueryResult
from gpu_olap_tpu.utils.metrics import GLOBAL_METRICS, Timer
from gpu_olap_tpu.utils.tracing import get_logger

from .executor.device import DeviceExecutor, DeviceUnsupported
from .utils.torchenv import resolve_device

logger = get_logger(__name__)


class TorchOlapEngine(OlapEngine):
    """SQL engine whose device backend is PyTorch on ``device`` ("cuda",
    "cuda:N" or "cpu").  ``"cuda"`` without a GPU raises."""

    def __init__(self, config: Optional[EngineConfig] = None,
                 device="cuda"):
        super().__init__(config)
        self.device = resolve_device(device)

    def execute_query(self, sql: str) -> QueryResult:
        with Timer() as t_plan:
            physical = self.plan_query(sql)
        cache_key = None
        if self.config.enable_cache:
            tables = self._referenced_tables(physical)
            cache_key = (sql, tuple((t, self.catalog.get_version(t))
                                    for t in tables))
            with self._cache_lock:
                hit = self._result_cache.get(cache_key)
            if hit is not None:
                return QueryResult(hit, {"plan_seconds": t_plan.seconds,
                                         "exec_seconds": 0.0,
                                         "backend": "result-cache",
                                         "routes": []})
        backend = self._resolve_backend()
        routes = []
        with Timer() as t_exec:
            if backend == "cpu":
                batch = CpuExecutor(self.catalog, self.config).execute(physical)
            else:
                try:
                    if self.config.mesh_shape and self.config.mesh_shape[0] > 1:
                        raise DeviceUnsupported(
                            "distributed execution is not ported")
                    dev = self._get_device_executor()
                    # one accelerator: queries serialize on it (the executor
                    # also mutates its table cache)
                    with self._device_lock:
                        before = dict(GLOBAL_METRICS.counters)
                        batch = dev.execute(physical)
                        backend = dev.last_backend
                        routes = _routes_since(before)
                except DeviceUnsupported as e:
                    logger.info("device path unsupported (%s); CPU fallback", e)
                    backend = "cpu-fallback"
                    batch = CpuExecutor(self.catalog, self.config).execute(physical)
        logger.info("query executed: plan %.2f ms, exec %.2f ms, %d rows",
                    t_plan.seconds * 1e3, t_exec.seconds * 1e3, batch.num_rows)
        if cache_key is not None:
            with self._cache_lock:
                if len(self._result_cache) >= self._result_cache_max:
                    self._result_cache.pop(next(iter(self._result_cache)))
                self._result_cache[cache_key] = batch
        return QueryResult(batch, {
            "plan_seconds": t_plan.seconds,
            "exec_seconds": t_exec.seconds,
            "backend": backend,
            "routes": routes,
        })

    def _resolve_backend(self) -> str:
        # "auto" means the torch device path: torch is this package's
        # dependency, so there is nothing to probe
        return "cpu" if self.config.backend == "cpu" else "device"

    def _get_device_executor(self):
        if self._device_executor is None:
            with self._exec_init_lock:
                if self._device_executor is None:
                    self._device_executor = DeviceExecutor(
                        self.catalog, self.config, self.device)
        return self._device_executor


def _routes_since(before: dict) -> list:
    """The ``torch_*`` route counters bumped since the snapshot ``before``."""
    return sorted(k for k, v in GLOBAL_METRICS.counters.items()
                  if k.startswith("torch_") and v > before.get(k, 0))
