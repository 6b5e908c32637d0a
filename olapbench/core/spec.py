"""Finds what belongs to a cell by the names in ``BENCHMARK.json``.

- configuration ``C``: ``configs/C.json`` (its sizes, engine settings and
  guarantees) and ``configs/C.py`` (its generator: ``generate`` and
  ``domains``);
- traffic ``T`` of ``C``: ``mixes/C/T.json``;
- query ``Q`` of ``C``: ``queries/C/Q.sql`` (the SQL, constants as
  ``{name}`` fields) and ``reference/C/Q.py`` (its plain answer);
- metric ``M``: ``metrics/M.py`` (``read(run)``, the value or None).

Nothing here names a configuration, a mix or a metric: adding one is adding
its files and its entries in ``BENCHMARK.json``.
"""

from __future__ import annotations

import functools
import importlib
import importlib.util
import json
import pathlib
from typing import List

BENCH_DIR = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


@functools.lru_cache(maxsize=None)
def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def workload(name: str) -> dict:
    for w in benchmark()["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str) -> dict:
    return json.loads((BENCH_DIR / "configs" / f"{name}.json").read_text())


def generator(name: str):
    return importlib.import_module(f"olapbench.configs.{name}")


def mix(config_name: str, traffic: str) -> dict:
    return json.loads(
        (BENCH_DIR / "mixes" / config_name / f"{traffic}.json").read_text())


def query_sql(config_name: str, query: str) -> str:
    return (BENCH_DIR / "queries" / config_name / f"{query}.sql").read_text()


def reference(config_name: str, query: str):
    return importlib.import_module(f"olapbench.reference.{config_name}.{query}")


def _load_file(path: pathlib.Path):
    spec = importlib.util.spec_from_file_location(
        f"olapbench_metric_{path.stem.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@functools.lru_cache(maxsize=None)
def metric_reader(name: str):
    return _load_file(BENCH_DIR / "metrics" / f"{name}.py").read


def metrics_of(cell: str, trace: bool) -> List[dict]:
    """The metrics a run of ``cell`` reports: the end-to-end ones untraced,
    the per-layer ones traced; a metric with ``workloads`` only in those."""
    kind = "per_layer" if trace else "end_to_end"
    return [m for m in benchmark()[kind]
            if "workloads" not in m or cell in m["workloads"]]
