"""Runs one cell of the port's benchmark once, on the machine it starts on.

    python3 olapbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Measures ``gpu_olap_tpu_torch`` (the PyTorch and CUDA port) through
``TorchOlapEngine.query``, with the cells, configurations, mixes and
metrics named in ``BENCHMARK.json`` (see ``olapbench/core/spec.py`` for
where each lives).  Prints the compared numbers beside their limits as
the last lines of standard error, and one JSON line as the last line of
standard output: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
end-to-end metrics untraced, the per-layer ones with ``--trace 1``),
``device``, with ``--trace 1`` ``breakdown``, and ``checks`` last.  Exits
non-zero, printing no result, without as many CUDA devices as the cell
asks for, or when JAX or the JAX package was loaded.
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from olapbench.core import cell, spec

    chips = spec.workload(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"olapbench: the cell needs {chips} CUDA device(s); "
              f"torch.cuda.is_available() = {torch.cuda.is_available()}",
              file=sys.stderr)
        return 2
    print(f"[olapbench] card {torch.cuda.get_device_name(0)}, power limit "
          f"{env.power_limit()}, torch {torch.__version__}", file=sys.stderr)
    out = cell.run(args.workload, args.seed, args.seconds, bool(args.trace),
                   "cuda", T_START)
    info, line = out["info"], out["line"]
    print(json.dumps({"olapbench_info": info}), file=sys.stderr)
    forbidden = sorted(set(info["forbidden_modules"]) | set(
        env.forbidden_loaded()))
    if forbidden:
        print(f"olapbench: the process loaded {forbidden}", file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
