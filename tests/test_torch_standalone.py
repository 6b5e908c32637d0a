"""The port stands alone: it imports neither JAX nor the JAX package.

(a) No ``.py`` file of ``gpu_olap_tpu_torch``, no bench or chip script,
    not ``examples/torch_usage.py`` and neither ``tests/torch_corpus.py``
    nor ``tests/test_torch_card.py`` (which the GPU runs) imports
    ``jax``, ``gpu_olap_tpu`` or a submodule of either (names match
    exactly, so ``gpu_olap_tpu_torch`` itself is allowed).
(b) With ``jax`` and ``gpu_olap_tpu`` blocked from import, the port answers
    a filtered aggregate, a GROUP BY, a join and a UNION ALL on the CPU, as
    numpy does, its entry points and CLI run, the bench scripts run a
    config and a config-5 step exact, and two ranks of a gloo group run a
    distributed join + GROUP BY step as numpy does.
(c) The port's own parser, optimizer and planner give the JAX package's
    ``explain`` text for every query of the port's parity corpus.
"""

import ast
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from conftest import make_engine
from test_torch_engine import mirror_tables
from torch_corpus import SLICE_QUERIES, populate

import gpu_olap_tpu_torch
from gpu_olap_tpu_torch import EngineConfig, TorchOlapEngine

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(
    gpu_olap_tpu_torch.__file__)))
PKG = os.path.join(ROOT, "gpu_olap_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "gpu_olap_tpu")


def _sources():
    out = []
    for dirpath, _, files in os.walk(PKG):
        out += [os.path.relpath(os.path.join(dirpath, f), ROOT)
                for f in files if f.endswith(".py")]
    return sorted(out) + ["bench_torch.py", "bench_dist_torch.py",
                          "chip_smoke.py", "chip_trace.py",
                          "chip_kernel_ab.py", "examples/torch_usage.py",
                          "tests/torch_corpus.py", "tests/test_torch_card.py"]


def _imported_modules(path):
    """Absolute names of every module ``path`` imports, relative imports
    resolved against its package."""
    rel = os.path.relpath(path, ROOT)
    package = os.path.dirname(rel).replace(os.sep, ".")
    with open(os.path.join(ROOT, path)) as f:
        tree = ast.parse(f.read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                parts = package.split(".")
                base = parts[:len(parts) - node.level + 1]
                mod = ".".join(base + ([node.module] if node.module else []))
            else:
                mod = node.module
            names.append(mod)
            # ``from pkg import sub`` may import a submodule
            names += [f"{mod}.{a.name}" for a in node.names]
    return names


def _forbidden(name):
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


@pytest.mark.parametrize("path", _sources())
def test_no_import_of_jax_or_the_jax_package(path):
    bad = sorted({n for n in _imported_modules(path) if _forbidden(n)})
    assert not bad, f"{path} imports {bad}"


def test_the_ast_check_catches_a_forbidden_import():
    """The matcher itself: exact names, and the port's name allowed."""
    assert _forbidden("gpu_olap_tpu") and _forbidden("gpu_olap_tpu.sql.parser")
    assert _forbidden("jax.numpy") and _forbidden("jax")
    assert not _forbidden("gpu_olap_tpu_torch")
    assert not _forbidden("gpu_olap_tpu_torch.plan.physical")
    assert not _forbidden("jaxtyping")
    names = _imported_modules("gpu_olap_tpu_torch/engine.py")
    assert "gpu_olap_tpu_torch.plan.physical" in names


_BLOCKER = textwrap.dedent("""
    import sys

    class _Block:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib", "gpu_olap_tpu"):
                raise ImportError(f"blocked: {name}")
            return None

    sys.meta_path.insert(0, _Block())
""")

# one rank of a 2-rank gloo group: a make_dist_join_groupby step over 8
# shards, each rank's groups summed across ranks and held against numpy
_RANK_RUN = _BLOCKER + textwrap.dedent("""
    import numpy as np
    import torch
    import torch.distributed as dist
    from gpu_olap_tpu_torch.parallel import collectives, dist_ops, mesh

    def run_rank(d, rank):
        group = mesh.initialize_distributed(f"file://{d}/store", 2, rank,
                                            device="cpu")
        m = mesh.make_mesh(8, ["cpu"] * 8, group=group)
        rng = np.random.default_rng(0)
        lk, rk = rng.integers(0, 40, 4096), rng.integers(0, 40, 1024)
        lv, rv = rng.integers(1, 9, 4096), rng.integers(1, 9, 1024)
        step = dist_ops.make_dist_join_groupby(
            m, capacity=1024, join_capacity=65536, max_groups=64,
            agg_funcs=("sum", "count"))
        gk, (s, c), gv, of = step(
            mesh.shard_rows(m, lk), mesh.shard_rows(m, np.ones(4096, bool)),
            mesh.shard_rows(m, lv), mesh.shard_rows(m, rk),
            mesh.shard_rows(m, np.ones(1024, bool)), mesh.shard_rows(m, rv))
        assert len(gk) == 4 and not bool(of)
        per_key = torch.zeros((2, 40), dtype=torch.int64)
        for k, sv, cv, v in zip(gk, s, c, gv):
            per_key[0].index_add_(0, k[v], sv[v])
            per_key[1].index_add_(0, k[v], cv[v])
        total = collectives.psum(m, [per_key]).numpy()
        cl, cr = np.bincount(lk, minlength=40), np.bincount(rk, minlength=40)
        sl = np.bincount(lk, weights=lv, minlength=40).astype(np.int64)
        sr = np.bincount(rk, weights=rv, minlength=40).astype(np.int64)
        assert (total[0] == sl * sr).all() and (total[1] == cl * cr).all()
        dist.destroy_process_group()

    if len(sys.argv) == 3:
        run_rank(sys.argv[1], int(sys.argv[2]))
""")

_BLOCKED_RUN = _BLOCKER + textwrap.dedent("""

    import numpy as np
    from gpu_olap_tpu_torch import EngineConfig, TorchOlapEngine
    from gpu_olap_tpu_torch import cli, entry

    rng = np.random.default_rng(0)
    n = 70_000
    k = rng.integers(0, 300, n)
    v = rng.integers(-1000, 1000, n)
    eng = TorchOlapEngine(EngineConfig(), device="cpu")
    eng.register("t", {"k": k, "v": v})
    eng.register("d", {"k": np.arange(200), "w": np.arange(200) * 3})

    def run(sql):
        r = eng.query(sql)
        assert r.metrics["backend"] == "torch-cpu", (sql, r.metrics)
        return r.to_pandas()

    # filtered global aggregate
    df = run("SELECT COUNT(*) AS n, SUM(v) AS s, MIN(v) AS mn, MAX(v) AS mx "
             "FROM t WHERE v > 100")
    m = v > 100
    assert df.n[0] == m.sum() and df.s[0] == v[m].sum()
    assert df.mn[0] == v[m].min() and df.mx[0] == v[m].max()

    # GROUP BY
    df = run("SELECT k, COUNT(*) AS c, SUM(v) AS s FROM t GROUP BY k")
    df = df.sort_values("k").reset_index(drop=True)
    uk, inv = np.unique(k, return_inverse=True)
    assert (df.k.to_numpy() == uk).all()
    assert (df.c.to_numpy() == np.bincount(inv)).all()
    assert (df.s.to_numpy() == np.bincount(inv, weights=v).astype(np.int64)).all()

    # join + aggregate
    df = run("SELECT COUNT(*) AS c, SUM(t.v + d.w) AS s FROM t JOIN d "
             "ON t.k = d.k")
    j = k < 200
    assert df.c[0] == j.sum() and df.s[0] == (v[j] + 3 * k[j]).sum()

    # UNION ALL
    df = run("SELECT k FROM t WHERE v > 990 UNION ALL "
             "SELECT k FROM d WHERE w < 30")
    exp = np.sort(np.concatenate([k[v > 990], np.arange(10)]))
    assert (np.sort(df.k.to_numpy()) == exp).all()

    # the entry points (their own output kept off this run's)
    import contextlib
    import io
    fn, args = entry.entry("cpu")
    assert int(fn(*args)[3]) == 128
    with contextlib.redirect_stdout(io.StringIO()):
        assert entry.dryrun_multichip(4, ["cpu"] * 4)["retries"] >= 1
    assert cli.main(["--device", "cpu", "SELEC 1"]) == 0

    # the bench surface: a config checked against numpy, a config-5 step
    import bench_dist_torch
    import bench_torch
    res = bench_torch.run_config("filter_agg", (70_000,), 1, "cpu")
    assert res["exact"] and res["backend"] == "torch-cpu", res
    res = bench_dist_torch.bench_step(2, 4096, 1, False, device="cpu")
    assert res["exact"] is True and res["ndev"] == 2, res

    # a 2-rank gloo group: this process is rank 0, a blocked peer rank 1
    import subprocess
    import tempfile
    d = tempfile.mkdtemp(dir=".")
    peer = subprocess.Popen([sys.executable, "-c", RANK_RUN, d, "1"])
    try:
        exec(RANK_RUN)
        run_rank(d, 0)
        assert peer.wait(timeout=60) == 0
    finally:
        peer.kill()

    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "gpu_olap_tpu"))
    assert not loaded, loaded
    print("ok")
""")


def test_port_runs_with_the_jax_package_blocked(tmp_path):
    env = dict(os.environ, PYTHONPATH=ROOT)
    script = f"RANK_RUN = {_RANK_RUN!r}\n" + _BLOCKED_RUN
    res = subprocess.run([sys.executable, "-c", script], cwd=tmp_path,
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


@pytest.fixture(scope="module")
def explain_engines():
    port = TorchOlapEngine(EngineConfig(), device="cpu")
    populate(port, np.random.default_rng(123))
    ref = make_engine("auto")
    mirror_tables(port, ref)
    return port, ref


@pytest.mark.parametrize("sql", SLICE_QUERIES, ids=range(len(SLICE_QUERIES)))
def test_explain_matches_the_jax_package(explain_engines, sql):
    port, ref = explain_engines
    assert port.explain(sql) == ref.explain(sql)
