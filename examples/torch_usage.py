"""gpu_olap_tpu_torch — Python usage examples.

The five flows of ``examples/python_usage.py`` on the PyTorch port: engine
construction with the reference's memory/stream kwargs, Parquet loading,
SQL queries, pandas/polars integration, multi-join analytics and a join
micro-benchmark.

    PYTHONPATH=. python examples/torch_usage.py [--device cuda|cuda:N|cpu]

(from the repository root, or after ``pip install -e .``).  The queries run
on ``--device`` (default ``cuda``; without a GPU the script fails).  The
demo tables are full size on a GPU and a twentieth of it on the CPU.  Each
flow takes the engine constructor it builds its engines with (called with
``EngineConfig`` keywords) and returns its ``QueryResult``s by name, so a
caller can run the same seeded flow on another engine (the NumPy oracle,
``gpu_olap_tpu``) and hold the results against each other; a flow that
raises fails the script.
"""

from __future__ import annotations

import argparse
import functools
import os
import tempfile
import time

import numpy as np
import pandas as pd
import torch

import gpu_olap_tpu_torch as got

#: divisor of the demo sizes on a CPU device (full size on a GPU)
CPU_SCALE = 20


def demo_scale(device) -> int:
    return 1 if torch.device(device).type == "cuda" else CPU_SCALE


def port_engine(device, **kwargs):
    """The flows' engine constructor: ``gpu_olap_tpu_torch.GpuOlapEngine`` on
    ``device``, with ``kwargs`` (e.g. ``backend="cpu"``) on every engine."""
    return functools.partial(got.GpuOlapEngine, device=device, **kwargs)


def _rows(full: int, scale: int) -> int:
    return max(full // scale, 10_000)


def example_basic_queries(new_engine, scale=1) -> dict:
    """Basic SQL query examples (reference python_usage.py:15-69)."""
    print("=== Basic Queries ===\n")
    import pyarrow as pa
    import pyarrow.parquet as pq

    rng = np.random.default_rng(0)
    n = _rows(1_000_000, scale)
    out = {}
    with tempfile.TemporaryDirectory(prefix="olap_demo_") as tmpdir:
        pq.write_table(pa.table({
            "product_id": rng.integers(0, 1000, n),
            "amount": np.abs(rng.normal(500, 400, n)),
            "customer_id": rng.integers(0, 10_000, n),
            "region": rng.choice(["EU", "US", "APAC"], n),
            "year": rng.integers(2020, 2026, n),
        }), os.path.join(tmpdir, "sales.parquet"))
        pq.write_table(pa.table({
            "customer_id": np.arange(10_000),
            "customer_name": [f"cust{i}" for i in range(10_000)],
            "region": rng.choice(["EU", "US", "APAC"], 10_000),
        }), os.path.join(tmpdir, "customers.parquet"))

        # reference-compatible constructor kwargs
        engine = new_engine(
            max_gpu_memory=8 * 1024**3,
            num_streams=8,
            use_unified_memory=True,
        )
        engine.load_table("sales", os.path.join(tmpdir, "sales.parquet"))
        engine.load_table("customers",
                          os.path.join(tmpdir, "customers.parquet"))

        print("1. Simple SELECT with WHERE:")
        out["select_where"] = engine.query("""
            SELECT product_id, amount, customer_id
            FROM sales
            WHERE amount > 1000
            LIMIT 10
        """)
        print(out["select_where"].to_pandas())

        print("\n2. GROUP BY aggregation:")
        out["group_by"] = engine.query("""
            SELECT
                region,
                COUNT(*) as num_sales,
                SUM(amount) as total_amount,
                AVG(amount) as avg_amount
            FROM sales
            GROUP BY region
            ORDER BY total_amount DESC
        """)
        print(out["group_by"].to_pandas())

        print("\n3. JOIN with customers:")
        out["join"] = engine.query("""
            SELECT
                c.region,
                SUM(s.amount) as total_purchases,
                COUNT(*) as num_purchases
            FROM sales s
            JOIN customers c ON s.customer_id = c.customer_id
            WHERE s.year = 2024
            GROUP BY c.region
            ORDER BY total_purchases DESC
            LIMIT 20
        """)
        print(out["join"].to_pandas())
    return out


def example_pandas_integration(new_engine, scale=1) -> dict:
    """Pandas DataFrame integration (reference python_usage.py:72-135)."""
    print("\n=== Pandas Integration ===\n")
    engine = new_engine()
    rng = np.random.default_rng(1)
    n = _rows(1_000_000, scale)
    df = pd.DataFrame({
        "id": range(n),
        "category": rng.choice(["A", "B", "C", "D"], n),
        "value": rng.standard_normal(n) * 100,
        "quantity": rng.integers(1, 100, n),
    })

    start = time.time()
    result = engine.query_pandas(df, """
        SELECT
            category,
            COUNT(*) as count,
            SUM(value * quantity) as total_value,
            AVG(value) as avg_value,
            MAX(quantity) as max_quantity
        FROM df
        WHERE value > 0
        GROUP BY category
        ORDER BY total_value DESC
    """)
    elapsed = time.time() - start
    print(result.to_pandas())
    print(f"\nQuery time: {elapsed*1000:.2f}ms "
          f"(backend: {result.metrics['backend']})")
    return {"categories": result}


def example_polars_integration(new_engine, scale=1) -> dict:
    """Polars via Arrow (reference python_usage.py:138-208); gated on import."""
    try:
        import polars as pl
    except ImportError:
        print("\n=== Polars not installed; skipping ===")
        return {}
    print("\n=== Polars Integration ===\n")
    engine = new_engine()
    rng = np.random.default_rng(2)
    df = pl.DataFrame({
        "sensor_id": rng.integers(1, 100, 8760),
        "temperature": rng.standard_normal(8760) * 10 + 20,
        "humidity": rng.standard_normal(8760) * 15 + 60,
    })
    result = engine.query_polars(df, """
        SELECT sensor_id, COUNT(*) as readings,
               AVG(temperature) as avg_temp,
               MAX(temperature) - MIN(temperature) as temp_range
        FROM df GROUP BY sensor_id
        HAVING avg_temp > 20 ORDER BY temp_range DESC LIMIT 10
    """)
    print(pl.from_arrow(result.to_arrow()))
    return {"sensors": result}


def example_complex_analytics(new_engine, scale=1) -> dict:
    """HAVING / COUNT(DISTINCT) / multi-join (reference python_usage.py:211-258)."""
    print("\n=== Complex Analytics ===\n")
    engine = new_engine()
    rng = np.random.default_rng(1)
    n_orders, n_items = _rows(200_000, scale), _rows(600_000, scale)
    n_products, n_customers = 1000, 5000
    engine.register("orders", {
        "order_id": np.arange(n_orders),
        "customer_id": rng.integers(0, n_customers, n_orders),
        "status": rng.choice(["completed", "pending", "cancelled"], n_orders,
                             p=[0.8, 0.15, 0.05]),
    })
    engine.register("order_items", {
        "order_id": rng.integers(0, n_orders, n_items),
        "product_id": rng.integers(0, n_products, n_items),
        "quantity": rng.integers(1, 10, n_items),
    })
    engine.register("products", {
        "product_id": np.arange(n_products),
        "category": rng.choice(["tools", "toys", "food", "books"], n_products),
        "price": np.round(np.abs(rng.normal(30, 20, n_products)), 2),
    })
    engine.register("customers", {
        "customer_id": np.arange(n_customers),
        "region": rng.choice(["EU", "US", "APAC"], n_customers),
    })

    query = """
    SELECT
        c.region,
        p.category,
        COUNT(DISTINCT o.order_id) as num_orders,
        SUM(oi.quantity * p.price) as total_revenue,
        AVG(oi.quantity * p.price) as avg_order_value
    FROM orders o
    JOIN order_items oi ON o.order_id = oi.order_id
    JOIN products p ON oi.product_id = p.product_id
    JOIN customers c ON o.customer_id = c.customer_id
    WHERE o.status = 'completed'
    GROUP BY c.region, p.category
    HAVING total_revenue > 100000
    ORDER BY total_revenue DESC
    """
    start = time.time()
    result = engine.query(query)
    elapsed = time.time() - start
    print(result.to_pandas())
    print(f"\nQuery processed in {elapsed:.2f}s; rows: {result.num_rows}")
    return {"revenue": result}


def benchmark_join_performance(new_engine, scale=1) -> dict:
    """Join scaling micro-benchmark (reference python_usage.py:289-327)."""
    print("\n=== Join Performance Benchmark ===\n")
    # the result cache off: the timed run repeats the warm one's SQL
    engine = new_engine(enable_cache=False)
    out = {}
    for size in [10_000, 100_000, _rows(1_000_000, scale)]:
        rng = np.random.default_rng(size)
        left = pd.DataFrame({
            "key": rng.integers(0, size // 2, size),
            "left_value": rng.standard_normal(size),
        })
        right = pd.DataFrame({
            "key": rng.integers(0, size // 2, size),
            "right_value": rng.standard_normal(size),
        })
        engine.register("lhs", left)
        engine.register("rhs", right)
        sql = "SELECT COUNT(*) AS n FROM lhs JOIN rhs ON lhs.key = rhs.key"
        engine.query(sql)  # warm
        start = time.time()
        out[f"count_{size}"] = engine.query(sql)
        t_engine = time.time() - start
        start = time.time()
        _ = left.merge(right, on="key")
        t_pandas = time.time() - start
        print(f"  {size:>9,} rows: engine {t_engine*1000:8.2f}ms  "
              f"pandas {t_pandas*1000:8.2f}ms  speedup {t_pandas/t_engine:5.2f}x")
    return out


FLOWS = (example_basic_queries, example_pandas_integration,
         example_polars_integration, example_complex_analytics,
         benchmark_join_performance)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device of the engines: cuda, cuda:N or cpu")
    args = ap.parse_args(argv)
    print("gpu_olap_tpu_torch — Python Examples")
    print("=" * 60)
    scale = demo_scale(args.device)
    for fn in FLOWS:
        fn(port_engine(args.device), scale)
    print("\n" + "=" * 60)
    print("Examples completed!")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
