"""Streamed star joins of the port against the JAX package's NumPy oracle.

Each of 40 seeds writes an uncached fact table ``t1`` (``a, b`` int64, ``c``
float64, null-free, 3k-9k rows) to Parquet and a cached dimension table
``t2`` (20-300 rows: ``b, w`` int64, ``x`` float64 and a string ``g`` of
four values), registered on even seeds and loaded from a small Parquet file
on odd ones.  Three star joins per seed group by up to two of ``t.b``,
``t2.g``, ``t2.w`` and ``t.a % 5`` and take COUNT(*), SUM/MIN/MAX/AVG of
fact and dimension columns and MIN/MAX of ``t2.g``, under a predicate on
the dimension (``t2.g = 'p'``) or across both sides (``t.c > t2.x``).  The
first of them always reads ``t2.g``.

Every query must run on ``torch-streaming`` and give the oracle's rows:
integers and strings exactly, floats within ``rtol=1e-9`` (chunked sums
reassociate).  Every third seed caps the group state at 16 slots, so the
streamed join's one state overflows and grows, and also runs a GROUP BY of
the fact table alone on the hash-partitioned state (the route a streamed
join never takes).
"""

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from gpu_olap_tpu import EngineConfig as JaxConfig
from gpu_olap_tpu import OlapEngine
from gpu_olap_tpu_torch import EngineConfig, TorchOlapEngine

N_SEEDS = 40
WORDS = np.array(["p", "q", "r", "s"], dtype=object)
KEYS = ["t.b", "t2.g", "t2.w", "t.a % 5"]
AGGS = ["COUNT(*)", "SUM(t.a)", "SUM(t.c)", "SUM(t2.w)", "MIN(t.a)",
        "MAX(t.c)", "MIN(t2.x)", "MAX(t2.w)", "AVG(t.c)", "AVG(t2.w)",
        "MIN(t2.g)", "MAX(t2.g)"]
PREDICATES = [None, "t2.g = 'p'", "t.c > t2.x", "t2.g <> 'q' AND t.a > 20"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The streamed steps over these small tables are many small torch
    operations: with one thread they take as long as with all cores alone,
    and beside other test workers several times less."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tables(seed, tmp_path):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(3000, 9001))
    m = int(rng.integers(20, 301))
    fact = pa.table({
        "a": rng.integers(0, 100, n).astype(np.int64),
        "b": rng.integers(0, m + m // 4, n).astype(np.int64),
        "c": rng.normal(50.0, 10.0, n),
    })
    dim = pa.table({
        # duplicate keys widen the join; keys past m find no fact row
        "b": rng.integers(0, m + m // 8, m).astype(np.int64),
        "w": rng.integers(-50, 1000, m).astype(np.int64),
        "x": rng.normal(50.0, 10.0, m),
        "g": WORDS[rng.integers(0, len(WORDS), m)],
    })
    fact_path = str(tmp_path / "t1.parquet")
    pq.write_table(fact, fact_path)
    dim_path = None
    if seed % 2:
        dim_path = str(tmp_path / "t2.parquet")
        pq.write_table(dim, dim_path)
    return fact_path, dim, dim_path


def _query(rng, first):
    keys = list(rng.choice(KEYS, size=int(rng.integers(0, 3)), replace=False))
    aggs = list(rng.choice(AGGS, size=int(rng.integers(1, 4)), replace=False))
    if first and "t2.g" not in keys and not any("t2.g" in a for a in aggs):
        if rng.random() < 0.5:
            keys.append("t2.g")
        else:
            aggs.append(str(rng.choice(["MIN(t2.g)", "MAX(t2.g)"])))
    pred = PREDICATES[int(rng.integers(0, len(PREDICATES)))]
    names = [f"k{i}" for i in range(len(keys))]
    select = [f"{k} AS {nm}" for k, nm in zip(keys, names)] + \
        [f"{a} AS m{i}" for i, a in enumerate(aggs)]
    sql = (f"SELECT {', '.join(select)} FROM t1 t JOIN t2 "
           "ON t.b = t2.b")
    if pred:
        sql += f" WHERE {pred}"
    if keys:
        sql += f" GROUP BY {', '.join(keys)}"
    return sql, names


def _rows(result, order):
    df = result.to_pandas()
    if order:
        df = df.sort_values(order).reset_index(drop=True)
    return df


def _same(got, exp, what):
    assert list(got.columns) == list(exp.columns), what
    assert len(got) == len(exp), f"{what}: {len(got)} vs {len(exp)} rows"
    for col in got.columns:
        g, e = got[col].to_numpy(), exp[col].to_numpy()
        if g.dtype.kind == "f" or e.dtype.kind == "f":
            np.testing.assert_allclose(g.astype(float), e.astype(float),
                                       rtol=1e-9, err_msg=f"{what} :: {col}")
        else:
            np.testing.assert_array_equal(g, e, err_msg=f"{what} :: {col}")


@pytest.mark.parametrize("seed", range(N_SEEDS))
def test_streamed_star_join_matches_oracle(seed, tmp_path):
    fact_path, dim, dim_path = _tables(seed, tmp_path)
    small = seed % 3 == 0
    # 4096 group slots hold every seed's groups (the route is the one the
    # default state takes, and the merge sorts stay small for the CPU); a
    # query drawn twice must run twice, not come from the result cache
    cfg = dict(table_cache_threshold_rows=1000, batch_size=2048,
               max_groups=4096, enable_cache=False)
    if small:
        cfg.update(max_groups=16, stream_state_partition_groups=8)
    port = TorchOlapEngine(EngineConfig(**cfg), device="cpu")
    oracle = OlapEngine(JaxConfig(backend="cpu"))
    for eng in (port, oracle):
        eng.load_table("t1", fact_path)
        if dim_path is None:
            eng.register("t2", dim)
        else:
            eng.load_table("t2", dim_path)
    assert not port.catalog.is_cached("t1")
    assert port.catalog.is_cached("t2")

    rng = np.random.default_rng(10_000 + seed)
    queries = [_query(rng, first=i == 0) for i in range(3)]
    if small:
        queries.append(("SELECT t.b AS k0, COUNT(*) AS m0, SUM(t.c) AS m1, "
                        "MIN(t.a) AS m2 FROM t1 t GROUP BY t.b", ["k0"]))
    for sql, order in queries:
        res = port.query(sql)
        assert res.metrics["backend"] == "torch-streaming", (sql, res.metrics)
        _same(_rows(res, order), _rows(oracle.query(sql), order),
              f"seed {seed}: {sql}")
    if small:
        assert port._get_device_executor()._streaming.last_hash_parts > 1
