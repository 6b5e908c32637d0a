"""What the benchmark loads, checked in a fresh process by whole top-level
module names: the port's name begins with the JAX package's, so a prefix
test would not do."""

import json
import subprocess
import sys

from conftest import ROOT

CHECK = """
import json, sys
sys.path.insert(0, {root!r})
{body}
print(json.dumps(sorted({{m.split(".", 1)[0] for m in sys.modules}})))
"""


def _top_level(body: str) -> set:
    out = subprocess.run([sys.executable, "-c", CHECK.format(
        root=str(ROOT), body=body)], capture_output=True, text=True,
        timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_and_a_run_load_no_jax():
    loaded = _top_level(
        "import importlib.util, time\n"
        "spec = importlib.util.spec_from_file_location('run', "
        f"{str(ROOT / 'olapbench' / 'run.py')!r})\n"
        "run = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(run)\n"
        "from olapbench.core import cell, check, env, spec, trace, traffic\n"
        "cell.run('ssb_sf20.flight1', 3, 0.5, False, 'cpu', time.monotonic(),"
        " scale=0.0005)\n")
    assert "gpu_olap_tpu_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "gpu_olap_tpu"}, loaded


def test_reference_loads_neither_jax_nor_the_port():
    loaded = _top_level(
        "import importlib, pkgutil, olapbench.reference as r\n"
        "for m in pkgutil.walk_packages(r.__path__, 'olapbench.reference.'):\n"
        "    importlib.import_module(m.name)\n")
    assert "olapbench" in loaded and "torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "gpu_olap_tpu",
                         "gpu_olap_tpu_torch"}, loaded
