"""The readings that the limits of ``correct`` are set from: the program's
compared numbers and the control's, over many seeds, in one process.

    python3 olapbench/readings.py --cells CELL [CELL ...] --seeds N [N ...] --seconds S

The cells must share one configuration: each seed makes its tables once,
then every cell warms up and runs a window of ``S`` seconds.  Once the
program is freed, each cell's sampled answers are compared twice against
the reference: the program's own, and the reference's in the precision
below the configuration's (int32 and float32 sums: the control), put in
the program's place.  One JSON line per cell and seed on standard output.
The benchmark's runs never run this.
"""

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
# the checkout's root, not this script's folder, is where imports start
sys.path[:] = [p for p in sys.path
               if pathlib.Path(p or ".").resolve() != ROOT / "olapbench"]
sys.path.insert(0, str(ROOT))

from olapbench.core import env  # noqa: E402

env.use_checkout_caches(ROOT)


def readings(cells, seeds, seconds, device="cuda", scale=1.0):
    """Yields one dict per cell and seed."""
    from olapbench.core import cell as C

    cells = [C.Cell(c) for c in cells]
    configs = {c.config for c in cells}
    if len(configs) != 1:
        raise ValueError(f"cells of several configurations: {configs}")
    config = configs.pop()
    for seed in seeds:
        bench = C.Bench(config, seed, device, scale)
        windows = []
        for c in cells:
            bench.warm(c)
            windows.append(bench.window(c, seconds, trace=False))
        bench.free_program()
        for c, w in zip(cells, windows):
            r = bench.check(c, w.sample, controls=("lower",))
            program = C.checks_of(c, w, r["program"])
            control = C.checks_of(c, w, r["lower"])
            yield {"cell": c.name, "seed": seed, "attempted": len(w.queries),
                   "program": {k: v["value"] for k, v in program.items()},
                   "control": {k: v["value"] for k, v in control.items()},
                   "program_correct": all(v["value"] <= v["limit"]
                                          for v in program.values()),
                   "control_correct": all(v["value"] <= v["limit"]
                                          for v in control.values()),
                   "notes": r["program"]["notes"][:3],
                   "control_notes": r["lower"]["notes"][:3]}
        del bench


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cells", nargs="+", required=True)
    ap.add_argument("--seeds", nargs="+", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 2
    print(f"[olapbench] card {torch.cuda.get_device_name(0)}, power limit "
          f"{env.power_limit()}", file=sys.stderr)
    for line in readings(args.cells, args.seeds, args.seconds):
        print(json.dumps(line), flush=True)
    if env.forbidden_loaded():
        print(f"readings: loaded {env.forbidden_loaded()}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
