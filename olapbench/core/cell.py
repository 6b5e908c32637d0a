"""One run of one cell: set-up, the measured window, the check.

Set-up makes the configuration's tables from the seed, hands them to the
program as Arrow tables through ``TorchOlapEngine.register`` and runs each
query of the mix once (the first query of a table uploads it).  The window
is a closed loop with one client: the next query is sent when the answer
of the last has come back to the host, until ``seconds`` have passed; the
query then in flight completes and closes the window.  A sample of the
answers, drawn from the seed per query, is kept; once the window has
closed and the program is freed, the reference answers the sampled
queries from the same tables and :mod:`.check` compares them.
"""

from __future__ import annotations

import collections
import dataclasses
import gc
import random
import statistics
import sys
import time
from typing import Callable, Dict, List, Optional

from olapbench.core import check, env, spec, traffic


@dataclasses.dataclass
class Query:
    """One query of the window, as the metric readers see it."""
    name: str
    wall_s: float
    plan_s: Optional[float] = None
    exec_s: Optional[float] = None
    device_s: Optional[float] = None   # its ``device_execute`` span
    rows_in: int = 0
    bytes_needed: int = 0
    backend: Optional[str] = None
    error: Optional[str] = None


@dataclasses.dataclass
class Run:
    """What a run measured; ``metrics/<name>.py`` reads it."""
    setup_s: float
    window_s: float
    queries: List[Query]
    card: str
    memory_rate: Optional[float]
    trace: Optional[dict] = None


class Sample:
    """A reservoir of ``k`` answers per query name, drawn from the seed."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = random.Random(f"{seed}/check")
        self.seen: collections.Counter = collections.Counter()
        self.kept: Dict[str, list] = collections.defaultdict(list)

    def offer(self, name: str, item) -> None:
        self.seen[name] += 1
        kept = self.kept[name]
        if len(kept) < self.k:
            kept.append(item)
        else:
            j = self.rng.randrange(self.seen[name])
            if j < self.k:
                kept[j] = item


@dataclasses.dataclass
class Window:
    queries: List[Query]
    sample: Sample
    window_s: float
    trace: Optional[dict]


def default_engine(cfg: dict, device):
    from gpu_olap_tpu_torch import EngineConfig, TorchOlapEngine

    return TorchOlapEngine(EngineConfig(**cfg["engine"]), device=device)


def _span_state(metrics) -> tuple:
    st = metrics.ops.get("device_execute")
    return (0, 0.0) if st is None else (st.calls, st.seconds)


def say(msg: str) -> None:
    print(f"[olapbench] {msg}", file=sys.stderr, flush=True)


class Cell:
    """A cell's configuration, mix, queries and references, found by name."""

    def __init__(self, name: str):
        self.workload = spec.workload(name)
        self.name = name
        self.config = self.workload["config"]
        self.mix = spec.mix(self.config, self.workload["traffic"])
        self.sql = {q: spec.query_sql(self.config, q)
                    for q in self.mix["queries"]}
        self.refs = {q: spec.reference(self.config, q)
                     for q in self.mix["queries"]}

    def needs(self, tables, q: str, result_rows: int, result_cols: int):
        """(input rows, needed bytes) of query ``q``: every row of every
        table it reads; each column it reads once at its declared width,
        plus its result once at 8 bytes a value."""
        rows = sum(tables.rows(t) for t in self.refs[q].READS)
        nbytes = sum(tables.rows(t) * sum(tables.widths[t][c] for c in cols)
                     for t, cols in self.refs[q].READS.items())
        return rows, nbytes + result_rows * result_cols * 8


class Bench:
    """One configuration's tables, made from one seed, registered with the
    program."""

    def __init__(self, config: str, seed: int, device, scale: float = 1.0,
                 make_engine: Callable = default_engine):
        import torch

        self.seed = seed
        self.device = device
        self.cuda = torch.device(device).type == "cuda"
        self.cfg = spec.config(config)
        gen = spec.generator(config)
        self.domains = gen.domains(self.cfg)
        t0 = time.monotonic()
        self.tables = gen.generate(self.cfg, seed, device, scale)
        if self.cuda:
            torch.cuda.synchronize()
        t1 = time.monotonic()
        self.engine = make_engine(self.cfg, device)
        for t in self.cfg["tables"]:
            self.engine.register(t, self.tables.arrow(t))
        say(f"generate {t1 - t0:.3f} s, register "
            f"{time.monotonic() - t1:.3f} s")

    def warm(self, cell: Cell) -> None:
        """Every query of the mix once; the first of a table uploads it."""
        import torch

        warm = traffic.stream(cell.mix, self.seed, self.domains, "warm")
        for _ in cell.mix["queries"]:
            q, p = next(warm)
            t_q = time.monotonic()
            res = self.engine.query(cell.sql[q].format(**p))
            say(f"warm {q}: {time.monotonic() - t_q:.3f} s, "
                f"backend {res.metrics.get('backend')}")
        if self.cuda:
            torch.cuda.synchronize()
        gc.collect()

    def window(self, cell: Cell, seconds: float, trace: bool) -> Window:
        eng = self.engine
        sample = Sample(cell.mix["check_per_query"], self.seed)
        queries: List[Query] = []
        stream = traffic.stream(cell.mix, self.seed, self.domains)
        tracer = None
        if trace:
            from olapbench.core.trace import Tracer

            tracer = Tracer().__enter__()
        window = tracer.range("olapbench.window").__enter__() \
            if tracer else None
        w0 = time.perf_counter()
        deadline = w0 + seconds
        while time.perf_counter() < deadline:
            q, p = next(stream)
            sql = cell.sql[q].format(**p)
            before = _span_state(eng.metrics)
            rng = tracer.range(f"olapbench.query:{q}").__enter__() \
                if tracer else None
            ts = time.perf_counter()
            try:
                res = eng.query(sql)
                err = None
            except Exception as e:  # noqa: BLE001 -- a failed query counts
                res, err = None, f"{type(e).__name__}: {e}"
            wall = time.perf_counter() - ts
            if rng is not None:
                rng.__exit__(None, None, None)
            rec = Query(q, wall, error=err)
            if res is not None:
                rec.plan_s = res.metrics.get("plan_seconds")
                rec.exec_s = res.metrics.get("exec_seconds")
                rec.backend = res.metrics.get("backend")
                calls, secs = _span_state(eng.metrics)
                if calls == before[0] + 1:
                    rec.device_s = secs - before[1]
                rec.rows_in, rec.bytes_needed = cell.needs(
                    self.tables, q, res.num_rows, len(res.column_names))
                if rec.backend == "cpu-fallback":
                    rec.error = "answered by the CPU oracle (cpu-fallback)"
                else:
                    sample.offer(q, (p, res))
            queries.append(rec)
        window_s = time.perf_counter() - w0
        summary = None
        if tracer is not None:
            window.__exit__(None, None, None)
            tracer.__exit__(None, None, None)
            summary = tracer.summary()
        return Window(queries, sample, window_s, summary)

    def free_program(self) -> None:
        import torch

        self.engine = None
        gc.collect()
        if self.cuda:
            torch.cuda.empty_cache()

    def check(self, cell: Cell, sample: Sample,
              controls=()) -> Dict[str, dict]:
        """The compared numbers of the program's sampled answers and of the
        reference in each precision of ``controls`` put in its place."""
        from olapbench.reference import plain

        t0 = time.monotonic()
        view = plain.View(self.tables, self.device)
        sources = ("program",) + tuple(controls)
        readings = {s: {"wrong": 0, "float_gap": 0.0, "notes": []}
                    for s in sources}
        for q, kept in sorted(sample.kept.items()):
            ref = cell.refs[q]
            for p, res in kept:
                want = ref.answer(view, p, plain.PRECISIONS["exact"])
                for source in sources:
                    got = (check.program_columns(res) if source == "program"
                           else ref.answer(view, p, plain.PRECISIONS[source]))
                    why, g = check.compare(got, want, ref.KEYS, ref.ORDER)
                    r = readings[source]
                    r["float_gap"] = max(r["float_gap"], g)
                    if why is not None:
                        r["wrong"] += 1
                        r["notes"].append(f"{q} {p}: {why}")
        self.tables.drop_device()
        say(f"check {time.monotonic() - t0:.3f} s over "
            f"{sum(len(k) for k in sample.kept.values())} answers")
        return readings


def checks_of(cell: Cell, w: Window, program: dict) -> Dict[str, dict]:
    """Each compared number beside its limit (the mix's ``limits``)."""
    values = {"failed": sum(r.error is not None for r in w.queries),
              "wrong": program["wrong"], "float_gap": program["float_gap"],
              "unchecked": len(set(cell.mix["queries"]) - set(w.sample.kept))}
    return {k: {"value": values[k], "limit": lim}
            for k, lim in cell.mix["limits"].items()}


def run(cell_name: str, seed: int, seconds: float, trace: bool, device,
        t_start: float, scale: float = 1.0,
        make_engine: Callable = default_engine) -> dict:
    """One run of the cell; returns the result line and what goes to
    standard error beside it."""
    import torch

    cell = Cell(cell_name)
    cuda = torch.device(device).type == "cuda"
    card = torch.cuda.get_device_name(0) if cuda else "cpu"
    rate = env.memory_rate(card) if trace else None
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    bench = Bench(cell.config, seed, device, scale, make_engine)
    bench.warm(cell)
    from gpu_olap_tpu_torch.ops.kernels import _build

    setup_s = time.monotonic() - t_start
    say(f"set-up {setup_s:.3f} s, of which kernel build "
        f"{_build.build_seconds:.3f} s")
    launches0 = dict(_build.launches)
    w = bench.window(cell, seconds, trace)
    launches = {k: v - launches0.get(k, 0)
                for k, v in sorted(_build.launches.items())
                if v > launches0.get(k, 0)}
    if cuda:
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    forbidden = env.forbidden_loaded()
    bench.free_program()
    readings = bench.check(cell, w.sample)
    checks = checks_of(cell, w, readings["program"])
    correct = all(c["value"] <= c["limit"] for c in checks.values()) \
        and not forbidden

    measured = Run(setup_s, w.window_s, w.queries, card, rate, w.trace)
    out_metrics = {}
    for m in spec.metrics_of(cell_name, trace):
        value = spec.metric_reader(m["name"])(measured)
        if value is not None:
            out_metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev_info = {"platform": "gpu" if cuda else "cpu", "kind": card,
                "count": 1, "memory_peak_bytes": peak}
    line = {"correct": correct, "attempted": len(w.queries),
            "failed": sum(r.error is not None for r in w.queries),
            "metrics": out_metrics, "device": dev_info}
    if w.trace is not None:
        dev_info["busy_s"] = w.trace["busy_s"]
        dev_info["window_s"] = w.trace["window_s"]
        line["breakdown"] = {k: w.trace[k]
                             for k in ("device_ops", "idle_gaps")}
    line["checks"] = checks
    walls = collections.defaultdict(list)
    for r in w.queries:
        walls[r.name].append(r.wall_s * 1e3)
    spans = [(r.device_s, r.wall_s - r.device_s) for r in w.queries
             if r.device_s is not None]
    info = {
        "window_s": w.window_s,
        "kernel_launches": launches,
        "median_ms_by_query": {q: statistics.median(v)
                               for q, v in sorted(walls.items())},
        "queries_by_name": {q: len(v) for q, v in sorted(walls.items())},
        # where a run's walls move: inside the device_execute span or
        # outside it (planning, the host transfer)
        "median_device_execute_ms": statistics.median(
            d for d, _ in spans) * 1e3 if spans else None,
        "median_outside_device_execute_ms": statistics.median(
            o for _, o in spans) * 1e3 if spans else None,
        "checked_by_name": {q: len(k)
                            for q, k in sorted(w.sample.kept.items())},
        "failures": [f"{r.name}: {r.error}" for r in w.queries
                     if r.error is not None][:5],
        "wrong_answers": readings["program"]["notes"][:5],
        "forbidden_modules": forbidden,
    }
    if w.trace is not None:
        info["trace"] = {k: w.trace[k] for k in
                         ("queries", "queries_without_device_events")}
    return {"line": line, "info": info}
