"""Generated queries on the port's mesh and streamed paths, against the JAX
package's NumPy oracle.

``tests/test_fuzz_parity.py``'s generator (``_gen_tables``, ``_gen_query``)
draws the tables and the SQL, with typed-literal predicates added to its
pool: numbers compared with string literals and a string column compared
with a number.  The JAX oracle compares such literals by their digits, so
the expected answer is the oracle's answer to the same query with each
numeric string literal written as a number (a string column against a
number compares with its text in both).  Integers and strings must be
equal, floats within ``rtol=1e-9`` (sums reassociate over shards and
chunks).

- **Mesh:** 40 seeds on the 8-shard CPU mesh (``mesh_devices=["cpu"] *
  8``).  Two seeds in three redraw until the query groups or sorts with a
  LIMIT and reads no string column, the shapes the mesh distributes; at
  least a third of the seeds must run on ``torch-distributed``.
- **Streamed:** 40 seeds with ``t1`` written to Parquet (``c`` without
  nulls, which the stream refuses) and left uncached, ``t2`` registered.
  Every third seed caps the group state at 16 slots.  Two seeds in three
  (those with the 16 slots among them) redraw until the query aggregates without DISTINCT and reads no string
  column; at least
  a third must run on ``torch-streaming`` or
  ``torch-streaming-partitioned``.

Every lowered plan must keep the planner's rule: no comparison, IN list or
join key has a STRING side facing a non-STRING side.
"""

import dataclasses
import re

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import test_fuzz_parity as fuzz
from gpu_olap_tpu import EngineConfig as JaxConfig
from gpu_olap_tpu import OlapEngine
from gpu_olap_tpu_torch import EngineConfig, TorchOlapEngine
from gpu_olap_tpu_torch.interop.columnar import DType
from gpu_olap_tpu_torch.plan import physical as P
from test_torch_engine import mirror_tables

N_SEEDS = 40
TYPED_PREDS = ["t.a > '10'", "t.b = '3'", "t.b IN ('1', '2')",
               "t.c > '50.5'", "t.a BETWEEN '-10' AND '25'", "t.s <> 3"]
MESH = ("torch-distributed",)
STREAMED = ("torch-streaming", "torch-streaming-partitioned")
# seed -> backend, per path (filled by the seeds' tests, completed by the
# share tests when run alone)
_BACKENDS = {"mesh": {}, "streamed": {}}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Many small torch operations: one thread is as fast alone and much
    faster beside other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _draw(rng, accept):
    """``_gen_query`` over the pool with the typed predicates, redrawn (up
    to 30 times) until ``accept(sql)``."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fuzz, "_PREDS", fuzz._PREDS + TYPED_PREDS)
        for _ in range(30):
            sql = fuzz._gen_query(rng)
            if accept(sql):
                break
    return sql


def _distributable(sql):
    return "t.s" not in sql and ("GROUP BY" in sql or "LIMIT" in sql)


def _streamable(sql):
    return "t.s" not in sql and "DISTINCT" not in sql and \
        not sql.startswith("SELECT t.a, t.b, t.c")


def _as_numbers(sql):
    """The query with each numeric string literal written as a number."""
    return re.sub(r"'([+-]?[0-9]+(?:\.[0-9]+)?)'", r"\1", sql)


def _mixed(plan):
    """Every comparison, IN list and join-key pair of a lowered plan that
    sets a STRING side against a non-STRING side."""
    found = []

    def is_str(e):
        return e.dtype is DType.STRING

    def walk(x):
        if isinstance(x, P.PhysBinary) and x.op in P._COMPARISONS:
            if is_str(x.left) != is_str(x.right):
                found.append(x)
        elif isinstance(x, P.PhysInList):
            if any(v is not None and isinstance(v, str) != is_str(x.operand)
                   for v in x.values):
                found.append(x)
        elif isinstance(x, P.TpuHashJoin):
            found.extend(pair for pair in zip(x.left_keys, x.right_keys)
                         if is_str(pair[0]) != is_str(pair[1]))
        if dataclasses.is_dataclass(x) and not isinstance(x, type):
            for f in dataclasses.fields(x):
                walk(getattr(x, f.name))
        elif isinstance(x, (tuple, list)):
            for y in x:
                walk(y)

    walk(plan)
    return found


def _same_rows(got, exp, what):
    g, e = got.to_pandas(), exp.to_pandas()
    assert list(g.columns) == list(e.columns), what
    cols = list(g.columns)
    g = g.sort_values(cols).reset_index(drop=True)
    e = e.sort_values(cols).reset_index(drop=True)
    assert len(g) == len(e), f"{what}: {len(g)} vs {len(e)} rows"
    for col in cols:
        gv, ev = g[col].to_numpy(), e[col].to_numpy()
        if gv.dtype.kind == "f" or ev.dtype.kind == "f":
            np.testing.assert_allclose(gv.astype(float), ev.astype(float),
                                       rtol=1e-9, equal_nan=True,
                                       err_msg=f"{what} :: {col}")
        else:
            np.testing.assert_array_equal(gv, ev, err_msg=f"{what} :: {col}")


def _check(port, oracle, sql, what):
    assert not _mixed(port.plan_query(sql)), what
    res = port.query(sql)
    _same_rows(res, oracle.query(_as_numbers(sql)), what)
    return res.metrics["backend"]


def _run_mesh(seed):
    rng = np.random.default_rng(20_000 + seed)
    t1, t2 = fuzz._gen_tables(rng)
    sql = _draw(rng, _distributable if seed % 3 != 1 else (lambda s: True))
    # 4096 group slots hold every query's groups (at most 10 x 4) and keep
    # the shards' padded merge sorts small on the CPU
    port = TorchOlapEngine(EngineConfig(mesh_shape=(8,), max_groups=4096),
                           device="cpu", mesh_devices=["cpu"] * 8)
    port.register("t1", t1)
    port.register("t2", t2)
    oracle = OlapEngine(JaxConfig(backend="cpu"))
    mirror_tables(port, oracle)
    _BACKENDS["mesh"][seed] = _check(port, oracle, sql,
                                     f"mesh seed {seed}: {sql}")


def _run_streamed(seed, tmp_path):
    rng = np.random.default_rng(30_000 + seed)
    t1, t2 = fuzz._gen_tables(rng)
    t1["c"] = np.where(np.isnan(t1["c"]), -7.25, t1["c"])
    sql = _draw(rng, _streamable if seed % 3 != 1 else (lambda s: True))
    path = str(tmp_path / f"t1_{seed}.parquet")
    pq.write_table(pa.table(t1), path)
    # 4096 group slots, as for the mesh; 16 make the state overflow and grow
    cfg = dict(table_cache_threshold_rows=100, batch_size=256,
               max_groups=4096)
    if seed % 3 == 0:
        cfg.update(max_groups=16, stream_state_partition_groups=8)
    port = TorchOlapEngine(EngineConfig(**cfg), device="cpu")
    oracle = OlapEngine(JaxConfig(backend="cpu"))
    for eng in (port, oracle):
        eng.load_table("t1", path)
        eng.register("t2", t2)
    assert not port.catalog.is_cached("t1")
    _BACKENDS["streamed"][seed] = _check(port, oracle, sql,
                                         f"streamed seed {seed}: {sql}")


@pytest.mark.parametrize("seed", range(N_SEEDS))
def test_mesh_matches_oracle(seed):
    _run_mesh(seed)


@pytest.mark.parametrize("seed", range(N_SEEDS))
def test_streamed_matches_oracle(seed, tmp_path):
    _run_streamed(seed, tmp_path)


def test_mesh_seeds_reach_the_distributed_path():
    for seed in set(range(N_SEEDS)) - set(_BACKENDS["mesh"]):
        _run_mesh(seed)
    hits = sum(b in MESH for b in _BACKENDS["mesh"].values())
    assert 3 * hits >= N_SEEDS, _BACKENDS["mesh"]


def test_streamed_seeds_reach_the_streamed_path(tmp_path):
    for seed in set(range(N_SEEDS)) - set(_BACKENDS["streamed"]):
        _run_streamed(seed, tmp_path)
    hits = sum(b in STREAMED for b in _BACKENDS["streamed"].values())
    assert 3 * hits >= N_SEEDS, _BACKENDS["streamed"]


def test_typed_predicates_are_drawn():
    """The typed predicates reach the generated queries of both paths."""
    drawn = []
    for base in (20_000, 30_000):
        for seed in range(N_SEEDS):
            rng = np.random.default_rng(base + seed)
            fuzz._gen_tables(rng)
            drawn.append(_draw(rng, lambda s: True))
    for pred in TYPED_PREDS:
        assert any(pred in sql for sql in drawn), pred
