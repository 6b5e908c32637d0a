"""gpu_olap_tpu_torch — the SQL engine's device path on PyTorch and CUDA.

The host layers (SQL parser, planner, optimizer, catalog, Arrow interop and
the NumPy oracle) come from ``gpu_olap_tpu`` and import no JAX; this package
owns the device side: the torch executor, its operators and the hand-written
CUDA kernels under ``csrc/``.  It never imports JAX.
"""

from gpu_olap_tpu.config import EngineConfig
from gpu_olap_tpu.executor.result import QueryResult

from .engine import TorchOlapEngine

__all__ = ["EngineConfig", "QueryResult", "TorchOlapEngine"]
