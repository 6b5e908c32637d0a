"""Generated queries on the port's mesh and streamed paths, against the JAX
package's NumPy oracle.

``tests/torch_corpus.py``'s copy of ``tests/test_fuzz_parity.py``'s
generator (``gen_tables``, ``gen_query``, ``mesh_case``, ``streamed_case``)
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

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import torch_corpus as corpus
from gpu_olap_tpu import EngineConfig as JaxConfig
from gpu_olap_tpu import OlapEngine
from gpu_olap_tpu_torch import EngineConfig, TorchOlapEngine
from test_torch_engine import mirror_tables
from torch_corpus import (MESH, MESH_CONFIG, STREAMED, TYPED_PREDS, as_numbers,
                          draw, mixed)

N_SEEDS = corpus.N_PATH_SEEDS
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
    assert not mixed(port.plan_query(sql)), what
    res = port.query(sql)
    _same_rows(res, oracle.query(as_numbers(sql)), what)
    return res.metrics["backend"]


def _run_mesh(seed):
    t1, t2, sql = corpus.mesh_case(seed)
    port = TorchOlapEngine(EngineConfig(**MESH_CONFIG), device="cpu",
                           mesh_devices=["cpu"] * 8)
    port.register("t1", t1)
    port.register("t2", t2)
    oracle = OlapEngine(JaxConfig(backend="cpu"))
    mirror_tables(port, oracle)
    _BACKENDS["mesh"][seed] = _check(port, oracle, sql,
                                     f"mesh seed {seed}: {sql}")


def _run_streamed(seed, tmp_path):
    t1, t2, sql = corpus.streamed_case(seed)
    path = str(tmp_path / f"t1_{seed}.parquet")
    pq.write_table(pa.table(t1), path)
    port = TorchOlapEngine(EngineConfig(**corpus.streamed_config(seed)),
                           device="cpu")
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
            corpus.gen_tables(rng)
            drawn.append(draw(rng, lambda s: True))
    for pred in TYPED_PREDS:
        assert any(pred in sql for sql in drawn), pred
