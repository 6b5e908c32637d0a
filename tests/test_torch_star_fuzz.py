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
import pytest
import torch

import torch_corpus as corpus
from gpu_olap_tpu import EngineConfig as JaxConfig
from gpu_olap_tpu import OlapEngine
from gpu_olap_tpu_torch import EngineConfig, TorchOlapEngine

N_SEEDS = corpus.N_STAR_SEEDS


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The streamed steps over these small tables are many small torch
    operations: with one thread they take as long as with all cores alone,
    and beside other test workers several times less."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
    fact_path, dim, dim_path = corpus.star_tables(seed, tmp_path)
    small = corpus.star_small(seed)
    port = TorchOlapEngine(EngineConfig(**corpus.star_config(seed)),
                           device="cpu")
    oracle = OlapEngine(JaxConfig(backend="cpu"))
    for eng in (port, oracle):
        eng.load_table("t1", fact_path)
        if dim_path is None:
            eng.register("t2", dim)
        else:
            eng.load_table("t2", dim_path)
    assert not port.catalog.is_cached("t1")
    assert port.catalog.is_cached("t2")

    queries = corpus.star_queries(seed)
    for sql, order in queries:
        res = port.query(sql)
        assert res.metrics["backend"] == "torch-streaming", (sql, res.metrics)
        _same(_rows(res, order), _rows(oracle.query(sql), order),
              f"seed {seed}: {sql}")
    if small:
        assert port._get_device_executor()._streaming.last_hash_parts > 1
