"""gpu_olap_tpu_torch — the SQL engine on PyTorch and CUDA.

The package stands alone: it keeps its own copies of the host layers (SQL
parser, optimizer, planner, catalog, Arrow interop, the NumPy oracle) at the
same relative paths as in ``gpu_olap_tpu``, and owns the device side: the
torch executor, its operators and the hand-written CUDA kernels under
``csrc/``.  It imports neither JAX nor anything of ``gpu_olap_tpu``.
"""

from .catalog import Catalog
from .config import EngineConfig
from .engine import GpuOlapEngine, OlapEngine, TorchOlapEngine, TpuOlapEngine
from .executor.result import QueryResult
from .interop.columnar import Column, ColumnBatch, DType, Field, Schema
from .sql.parser import parse_sql

__version__ = "0.1.0"

__all__ = [
    "Catalog", "Column", "ColumnBatch", "DType", "EngineConfig", "Field",
    "GpuOlapEngine", "OlapEngine", "QueryResult", "Schema", "TorchOlapEngine",
    "TpuOlapEngine", "parse_sql",
]
