"""Engine entry point of the PyTorch port.

``TorchOlapEngine`` owns the catalog and the config and drives parse ->
optimize -> physical plan -> execute, with the surface of
``gpu_olap_tpu.engine.OlapEngine`` (``register``, ``load_table``,
``plan_query``, ``explain``, ``query``, ``query_async``/``aquery``/
``shutdown``, ``query_pandas``, ``query_polars``, the result cache and the
locks) and the torch executors in place of the JAX ones.
With ``config.mesh_shape[0] > 1`` a distributable plan runs on the
``DistributedExecutor`` over a mesh of explicit devices
(``metrics["backend"] == "torch-distributed"``); any other plan runs on the
single-device torch executor (``torch-cuda`` or ``torch-cpu``).  A plan
over an uncached (out-of-core) Parquet table streams its chunks through the
device (``torch-streaming``; ``torch-streaming-partitioned`` for the grace
join of two uncached tables), or, when the streamer cannot take it, loads
the table whole onto the device (``torch-cuda`` / ``torch-cpu``).  Only
plans the torch path does not cover (cross joins) run on the CPU oracle and
say so in ``metrics["backend"] == "cpu-fallback"``.
``metrics["routes"]`` names the device routes the query took: the
``torch_*`` counters of ``GLOBAL_METRICS`` that its execution bumped.
``metrics["regrows"]`` counts the capacity-overflow reruns of the query on
the single-device path (0 when none): a query that reads above 0 ran its
plan more than once, and a larger ``join_expansion`` or ``max_groups``
would spare the reruns.  ``metrics["query_id"]`` is the process-wide id
that the query's spans carry (``utils/tracing.py``).
``GpuOlapEngine`` (alias ``TpuOlapEngine``) is the binding-style
constructor of ``gpu_olap_tpu``: ``EngineConfig.from_kwargs`` over its
keywords.
"""

from __future__ import annotations

import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Optional, Sequence

from .catalog import Catalog
from .config import EngineConfig
from .executor.cpu import CpuExecutor
from .executor.device import DeviceExecutor, DeviceUnsupported, _Interpreter
from .executor.result import QueryResult
from .interop.columnar import ColumnBatch
from .parallel.dist_executor import DistributedExecutor, NotDistributable
from .parallel.mesh import make_mesh, visible_devices
from .plan.optimizer import optimize
from .plan.physical import TpuTableScan, create_physical_plan
from .sql.parser import parse_sql
from .utils.metrics import GLOBAL_METRICS, Timer
from .utils.torchenv import resolve_device
from .utils import tracing
from .utils.tracing import get_logger

logger = get_logger(__name__)


class TorchOlapEngine:
    """SQL engine whose device backend is PyTorch on ``device`` ("cuda",
    "cuda:N" or "cpu").  ``"cuda"`` without a GPU raises.

    ``config.mesh_shape = (n,)`` with ``n > 1`` adds a mesh of ``n`` shards
    over ``mesh_devices`` (default: the first ``n`` visible devices of
    ``device``'s type; fewer raise).  A device may repeat:
    ``mesh_devices=["cuda:0"] * 8`` is eight logical shards on one card."""

    def __init__(self, config: Optional[EngineConfig] = None,
                 device="cuda", mesh_devices: Optional[Sequence] = None):
        self.config = config or EngineConfig()
        self.catalog = Catalog(self.config.table_cache_threshold_rows)
        self.metrics = GLOBAL_METRICS
        # result cache keyed by (sql, referenced table versions)
        self._result_cache: dict = {}
        self._result_cache_max = 128
        # planning runs concurrently; device work serializes on _device_lock;
        # the CPU oracle runs fully concurrent
        self._cache_lock = threading.Lock()
        self._exec_init_lock = threading.Lock()
        self._device_lock = threading.Lock()
        self._df_lock = threading.Lock()
        self._pool: Optional[ThreadPoolExecutor] = None
        self._device_executor = None
        self.device = resolve_device(device)
        self.mesh = None
        shape = self.config.mesh_shape
        if shape and shape[0] > 1:
            self.mesh = make_mesh(shape[0], visible_devices(self.device.type)
                                  if mesh_devices is None else mesh_devices)
        elif mesh_devices is not None:
            raise ValueError("mesh_devices needs config.mesh_shape = (n,) "
                             "with n > 1")
        self._dist_executor = None

    # -- tables --------------------------------------------------------------
    def load_table(self, name: str, path: str) -> None:
        self.catalog.load_table(name, path)

    def register(self, name: str, data) -> None:
        """Register in-memory data: pandas DataFrame, Arrow Table, dict of
        arrays or a ``ColumnBatch``."""
        with tracing.span(logger, "register", self.metrics, table=name):
            if isinstance(data, ColumnBatch):
                self.catalog.register_batch(name, data)
            elif isinstance(data, dict):
                self.catalog.register_batch(name, ColumnBatch.from_dict(data))
            elif type(data).__module__.startswith("pandas"):
                self.catalog.register_pandas(name, data)
            elif type(data).__module__.startswith("pyarrow"):
                self.catalog.register_arrow(name, data)
            else:
                raise TypeError(f"Cannot register {type(data)}")
            tracing.annotate(rows=self.catalog.get_row_count(name))

    def get_table_schema(self, name: str):
        return self.catalog.get_schema(name)

    def drop_table(self, name: str) -> None:
        self.catalog.drop_table(name)

    # -- planning ------------------------------------------------------------
    def plan_query(self, sql: str):
        """SQL -> optimized physical plan."""
        return create_physical_plan(optimize(parse_sql(sql)), self.catalog,
                                    self.config)

    def explain(self, sql: str) -> str:
        logical = parse_sql(sql)
        optimized = optimize(logical)
        physical = create_physical_plan(optimized, self.catalog, self.config)
        return (
            "== Logical ==\n" + str(logical)
            + "\n== Optimized ==\n" + str(optimized)
            + "\n== Physical ==\n" + str(physical)
        )

    # -- execution -----------------------------------------------------------
    def execute_query(self, sql: str) -> QueryResult:
        query_id = tracing.next_query_id()
        with tracing.span(logger, "query", query_id=query_id):
            res = self._execute_query(sql)
            res.metrics["query_id"] = query_id
            tracing.annotate(backend=res.metrics["backend"])
        return res

    def _execute_query(self, sql: str) -> QueryResult:
        with tracing.span(logger, "plan"), Timer() as t_plan:
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
                                         "routes": [], "regrows": 0})
        backend = self._resolve_backend()
        routes = []
        regrows = 0
        with Timer() as t_exec:
            if backend == "cpu":
                batch = CpuExecutor(self.catalog, self.config).execute(physical)
            else:
                batch = None
                if self.mesh is not None:
                    try:
                        with self._device_lock:
                            before = GLOBAL_METRICS.snapshot()
                            batch = self._get_distributed_executor().execute(
                                physical)
                            routes = _routes_since(before)
                        backend = "torch-distributed"
                    except (NotDistributable, DeviceUnsupported) as e:
                        logger.info("plan not distributable (%s); "
                                    "single-device path", e)
                if batch is None:
                    try:
                        dev = self._get_device_executor()
                        # one accelerator: queries serialize on it (the
                        # executor also mutates its table cache)
                        with self._device_lock:
                            before = GLOBAL_METRICS.snapshot()
                            batch = dev.execute(physical)
                            backend = dev.last_backend
                            routes = _routes_since(before)
                            regrows = int(GLOBAL_METRICS.snapshot().get(
                                "regrows", 0) - before.get("regrows", 0))
                    except DeviceUnsupported as e:
                        logger.info("device path unsupported (%s); CPU "
                                    "fallback", e)
                        backend = "cpu-fallback"
                        batch = CpuExecutor(self.catalog,
                                            self.config).execute(physical)
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
            "regrows": regrows,
        })

    def query(self, sql: str) -> QueryResult:
        return self.execute_query(sql)

    def query_async(self, sql: str) -> "Future[QueryResult]":
        """Submit a query to the engine's thread pool and return a
        ``concurrent.futures.Future``.  Pool width follows
        ``num_feed_buffers``."""
        return self._get_pool().submit(self.execute_query, sql)

    async def aquery(self, sql: str) -> QueryResult:
        """asyncio coroutine form of :meth:`query_async`."""
        import asyncio

        return await asyncio.wrap_future(self.query_async(sql))

    def shutdown(self) -> None:
        """Drain and close the concurrent-query pool (idempotent)."""
        with self._exec_init_lock:
            pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown(wait=True)

    def _get_pool(self) -> ThreadPoolExecutor:
        if self._pool is None:
            with self._exec_init_lock:
                if self._pool is None:
                    self._pool = ThreadPoolExecutor(
                        max_workers=max(self.config.num_feed_buffers, 1),
                        thread_name_prefix="olap-query")
        return self._pool

    def query_pandas(self, df, sql: str) -> QueryResult:
        """Query a pandas DataFrame registered as table ``df``; concurrent
        frame queries serialize on the fixed name."""
        with self._df_lock:
            self.catalog.register_pandas("df", df)
            try:
                return self.execute_query(sql)
            finally:
                self.catalog.drop_table("df")

    def query_polars(self, df, sql: str) -> QueryResult:
        """Query a polars DataFrame (through Arrow) registered as ``df``."""
        with self._df_lock:
            self.catalog.register_arrow("df", df.to_arrow())
            try:
                return self.execute_query(sql)
            finally:
                self.catalog.drop_table("df")

    # -- internals -----------------------------------------------------------
    @staticmethod
    def _referenced_tables(physical) -> list:
        names = set()

        def walk(p):
            if isinstance(p, TpuTableScan):
                names.add(p.table_name)
            for k in p.inputs():
                walk(k)

        walk(physical)
        return sorted(names)

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

    def _get_distributed_executor(self):
        if self._dist_executor is None:
            with self._exec_init_lock:
                if self._dist_executor is None:
                    self._dist_executor = DistributedExecutor(
                        self.catalog, self.config, _Interpreter, self.mesh)
        return self._dist_executor


class GpuOlapEngine(TorchOlapEngine):
    """Binding-style constructor accepting the reference's kwargs
    (``gpu_olap_py.GpuOlapEngine(max_gpu_memory=..., num_streams=...,
    use_unified_memory=...)``, README.md:260-270) and any field of the
    port's ``EngineConfig``; ``use_unified_memory`` is accepted and sets
    nothing (see ``EngineConfig.from_kwargs``).  ``device`` and
    ``mesh_devices`` go to ``TorchOlapEngine``."""

    def __init__(self, *, device="cuda",
                 mesh_devices: Optional[Sequence] = None, **kwargs):
        super().__init__(EngineConfig.from_kwargs(**kwargs), device=device,
                         mesh_devices=mesh_devices)


# the names of ``gpu_olap_tpu``: code written against it changes only its
# import line
TpuOlapEngine = GpuOlapEngine
OlapEngine = TorchOlapEngine


def _routes_since(before: dict) -> list:
    """The ``torch_*`` route counters bumped since the snapshot ``before``."""
    return sorted(k for k, v in GLOBAL_METRICS.snapshot().items()
                  if k.startswith("torch_") and v > before.get(k, 0))
