"""Command-line SQL runner of the port — the counterpart of
``gpu_olap_tpu/cli.py`` (engine construction, table loading, query
execution, error surfacing, timing) on ``TorchOlapEngine``.

Usage:
    python -m gpu_olap_tpu_torch --table sales=data/sales.parquet \
        "SELECT region, SUM(amount) FROM sales GROUP BY region"
    python -m gpu_olap_tpu_torch --table t=data.parquet          # REPL
    python -m gpu_olap_tpu_torch --mesh 8 \
        --mesh-devices cuda:0,cuda:0,cuda:0,cuda:0,cuda:0,cuda:0,cuda:0,cuda:0 \
        --table t=data.parquet "SELECT k, COUNT(*) FROM t GROUP BY k"

Queries run on ``--device`` (default ``cuda``); without a GPU the runner
exits with status 2 and says so, unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="gpu_olap_tpu_torch")
    ap.add_argument("sql", nargs="?", help="SQL to run (omit for a REPL)")
    ap.add_argument("--table", action="append", default=[],
                    metavar="NAME=PATH", help="load a Parquet table")
    ap.add_argument("--backend", default="auto",
                    choices=["auto", "device", "cpu"])
    ap.add_argument("--explain", action="store_true",
                    help="print plans instead of executing")
    ap.add_argument("--mesh", type=int, default=None,
                    help="distributed mesh size (devices)")
    ap.add_argument("--max-rows", type=int, default=50,
                    help="max rows to print")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the engine: cuda, cuda:N or cpu")
    ap.add_argument("--mesh-devices", default=None, metavar="D,D,...",
                    help="comma-separated devices of the --mesh shards "
                         "(default: the first n visible devices of --device's "
                         "type); a device may repeat")
    args = ap.parse_args(argv)

    from . import EngineConfig, OlapEngine

    cfg = EngineConfig(backend=args.backend)
    if args.mesh:
        cfg.mesh_shape = (args.mesh,)
    mesh_devices = args.mesh_devices.split(",") if args.mesh_devices else None
    try:
        engine = OlapEngine(cfg, device=args.device, mesh_devices=mesh_devices)
    except (RuntimeError, ValueError) as e:  # no such device, or a bad mesh
        print(f"error: {e}", file=sys.stderr)
        return 2

    for spec in args.table:
        if "=" not in spec:
            print(f"--table expects NAME=PATH, got {spec!r}", file=sys.stderr)
            return 2
        name, path = spec.split("=", 1)
        try:
            engine.load_table(name, path)
        except Exception as e:  # noqa: BLE001 — CLI error surface
            print(f"error loading {name!r} from {path}: {e}", file=sys.stderr)
            return 2

    def run_one(sql: str) -> None:
        sql = sql.strip()
        if not sql:
            return
        if args.explain:
            print(engine.explain(sql))
            return
        t0 = time.perf_counter()
        try:
            result = engine.query(sql)
        except Exception as e:  # noqa: BLE001 — graceful SQL error surfacing
            print(f"error: {e}", file=sys.stderr)
            return
        dt = time.perf_counter() - t0
        df = result.to_pandas()
        with_trunc = len(df) > args.max_rows
        print(df.head(args.max_rows).to_string())
        if with_trunc:
            print(f"... ({len(df)} rows total)")
        print(f"-- {result.num_rows} rows in {dt*1e3:.1f} ms "
              f"[{result.metrics.get('backend')}]", file=sys.stderr)

    if args.sql:
        run_one(args.sql)
        return 0

    # REPL
    print(f"gpu_olap_tpu_torch SQL shell — tables: "
          f"{engine.catalog.list_tables()}")
    print("end statements with ';', \\q to quit")
    buf: list = []
    while True:
        try:
            prompt = "sql> " if not buf else "...> "
            line = input(prompt)
        except (EOFError, KeyboardInterrupt):
            print()
            return 0
        if line.strip() in ("\\q", "exit", "quit"):
            return 0
        buf.append(line)
        if line.rstrip().endswith(";"):
            run_one(" ".join(buf).rstrip(";"))
            buf = []


if __name__ == "__main__":
    raise SystemExit(main())
