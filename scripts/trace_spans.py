"""Device time and idle gaps of benchmark cells by the program's own spans,
in traced windows with the program's span recorder on and off.

    python3 scripts/trace_spans.py --cells CELL [CELL ...] --seed N \
        --seconds S [--modes off,on,on,off] [--scale 1.0] [--device cuda] \
        [--out FILE]

The cells must share one configuration.  Set-up (the tables, ``register``,
the upload, each cell's warm-up) runs once, under the recorder, which gives
the set-up spans.  Then each cell runs one ``olapbench`` window under
``torch.profiler`` per mode: ``on`` with the recorder open, so that the
program's spans are ``olap/...`` ranges of the trace, ``off`` without.
Each window prints one JSON line: the median query wall, the trace's busy
seconds by kind (every device event but the user annotations) beside the
benchmark's own (its name filter), device and idle seconds by program span
(``olapbench/core/spans.py``), the unattributed share, the ten longest
gaps, per query the median device ms of ``join``, ``aggregate`` and
``filter`` spans, the ``to_host`` span's median host ms, the regrows, the
window's GROUP BY and join-route counters (``torch_join_lookup_left``: the
joins that built on their left side) and, with the recorder on, per query
of the mix the rows its masked GROUP BYs were handed and kept.
"""

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import collections  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:] = [p for p in sys.path
               if pathlib.Path(p or ".").resolve() != ROOT / "scripts"]
sys.path.insert(0, str(ROOT))

from olapbench.core import env  # noqa: E402

env.use_checkout_caches(ROOT)


COUNTERS = ("torch_groupby_compact", "torch_groupby_rows_in",
            "torch_groupby_rows_kept", "torch_seg_agg_path",
            "torch_join_lookup_left", "torch_join_stream_path")


def _median(xs):
    return statistics.median(xs) if xs else None


def _links(events, work, owners, spans) -> dict:
    """How the device work links to host ops, and what the unattributed
    work is: its names, and whether a runtime call or op was found."""
    ops = {e.corr: e for e in events if not e.on_device and e.corr
           and not spans.is_runtime(e)}
    runtime = {e.corr: e for e in events if spans.is_runtime(e)}
    threads = {e.thread for e in events if not e.on_device
               and e.name.startswith(spans.PROGRAM)}
    lost = collections.Counter()
    for e, o in zip(work, owners):
        if o is None:
            call = runtime.get(e.corr)
            op = ops.get(e.linked)
            lost[(e.name[:60], None if call is None else call.name,
                  None if call is None else call.thread in threads,
                  None if op is None else op.name[:40])] += e.end - e.start
    return {
        "work": len(work),
        "linked_to_op": sum(e.linked in ops for e in work),
        "corr_in_runtime": sum(e.corr in runtime for e in work),
        "unattributed": [[list(k), v / 1e9] for k, v in lost.most_common(8)],
    }


def window(bench, cell, seconds, mode, keep, spans):
    from gpu_olap_tpu_torch.utils import tracing
    from gpu_olap_tpu_torch.utils.metrics import GLOBAL_METRICS

    before = GLOBAL_METRICS.snapshot()
    ctx = tracing.record() if mode == "on" else contextlib.nullcontext()
    with ctx as rec:
        w = bench.window(cell, seconds, trace=True)
    after = GLOBAL_METRICS.snapshot()
    counted = {k: after.get(k, 0) - before.get(k, 0)
               for k in ("regrows", *COUNTERS)}
    t0 = time.monotonic()
    events = spans.events_of(keep.last._prof)
    keep.last = None
    s = spans.summary(events)
    window = next(e for e in events if e.name == spans.BENCH + "window")
    att = spans.attribute(events, window.start, window.end)
    walls = [q.wall_s * 1e3 for q in w.queries if q.error is None]
    host_ms = [(q.exec_s - q.device_s) * 1e3 for q in w.queries
               if q.device_s is not None and q.exec_s is not None]
    line = {
        "cell": cell.name, "mode": mode,
        "queries": len(w.queries),
        "failed": sum(q.error is not None for q in w.queries),
        "query_ms_p50": _median(walls),
        "window_s": s["window_s"],
        "busy_s": s["busy_s"],
        "busy_s_name_filter": w.trace["busy_s"],
        "idle_share": 100.0 * (1 - s["busy_s"] / s["window_s"]),
        "idle_share_name_filter": 100.0 * (
            1 - w.trace["busy_s"] / w.trace["window_s"]),
        "unattributed_share": s["unattributed_share"],
        "device_s_by_span": s["device_s_by_span"],
        "idle_s_by_span": s["idle_s_by_span"],
        "idle_gaps": s["idle_gaps"],
        "ops_ms": {n: spans.median_ms(s, n)
                   for n in ("join", "aggregate", "filter")},
        "host_ms": _median(host_ms),
        "regrows": counted.pop("regrows"),
        "counters": counted,
        "links": _links(events, att["work"], att["owners"], spans),
    }
    if rec is not None:
        line["to_host_ms"] = _median([x.seconds * 1e3 for x in rec.spans
                                      if x.name == "to_host"])
        line["spans"] = len(rec.spans)
        # one client: the window's queries in the order of their ids
        name_of = dict(zip(sorted(x.query_id for x in rec.spans
                                  if x.name == "query"),
                           (q.name for q in w.queries)))
        kept = collections.defaultdict(lambda: [0, 0])
        for x in rec.spans:
            if "rows_kept" in x.fields:
                k = kept[name_of.get(x.query_id)]
                k[0] += x.fields["rows_in"]
                k[1] += x.fields["rows_kept"]
        line["rows_in_kept_by_query"] = dict(sorted(kept.items()))
    line["read_s"] = time.monotonic() - t0
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cells", nargs="+", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--modes", default="off,on,on,off")
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    from gpu_olap_tpu_torch.utils import tracing
    from olapbench.core import cell as C
    from olapbench.core import spans
    from olapbench.core import trace as trace_mod

    class Keep(trace_mod.Tracer):
        """The benchmark's tracer, keeping its profiler for a second read."""
        last = None

        def summary(self):
            Keep.last = self
            return super().summary()

    trace_mod.Tracer = Keep
    said = []
    say = C.say
    C.say = lambda msg: (said.append(msg), say(msg))

    cells = [C.Cell(c) for c in args.cells]
    configs = {c.config for c in cells}
    if len(configs) != 1:
        raise SystemExit(f"cells of several configurations: {configs}")
    card = torch.cuda.get_device_name(0) if args.device == "cuda" else "cpu"
    head = {"card": card, "power_limit": env.power_limit(),
            "torch": torch.__version__, "seed": args.seed,
            "seconds": args.seconds}
    with tracing.record() as setup:
        bench = C.Bench(cells[0].config, args.seed, args.device, args.scale)
        for c in cells:
            bench.warm(c)
    by = collections.defaultdict(float)
    for x in setup.spans:
        by[x.name] += x.seconds
    lines = [dict(head, setup=True, register_s=by["register"],
                  upload_s=by["upload"], setup_s=time.monotonic() - T_START,
                  said=[m for m in said if m.startswith("generate")])]
    print(json.dumps(lines[-1]), flush=True)
    for c in cells:
        for mode in args.modes.split(","):
            lines.append(dict(head, **window(bench, c, args.seconds, mode,
                                             Keep, spans)))
            print(json.dumps(lines[-1]), flush=True)
    bench.free_program()
    if args.out:
        out = pathlib.Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        with out.open("a") as f:
            for ln in lines:
                f.write(json.dumps(ln) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
