"""The port's bench surface, ``bench_torch.py`` and ``bench_dist_torch.py``,
on the CPU against ``bench.py``, ``bench_dist.py`` and the JAX package.

- Each config's tables equal the arrays of ``bench.py``'s generator calls
  (copied here), and its answer equals numpy and
  ``gpu_olap_tpu.OlapEngine(backend="device")`` on the same tables.
- ``bench_dist_torch.bench_step`` on ``["cpu"] * ndev`` plans the capacity
  that ``bench_dist.py``'s planner (copied here, on JAX's ``skew``) plans
  for the same keys, and its groups equal numpy (checked inside).
- The roofline helpers of ``utils/metrics.py`` equal JAX's for the CPU
  entry; H100 names map to their rates; an unknown card raises.
- The scripts as a user runs them: one JSON line with ``bench.py``'s keys,
  exit 2 naming CUDA without a card, exit 1 when a config fails, and the
  distributed step over two gloo ranks.
"""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import jax.numpy as jnp

import gpu_olap_tpu_torch
from gpu_olap_tpu import EngineConfig as JaxEngineConfig
from gpu_olap_tpu import OlapEngine as JaxOlapEngine
from gpu_olap_tpu.parallel import skew as jax_skew
from gpu_olap_tpu.utils import metrics as jax_metrics
from gpu_olap_tpu_torch.utils import metrics as torch_metrics

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(
    gpu_olap_tpu_torch.__file__)))


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod  # dataclasses look their module up by name
    spec.loader.exec_module(mod)
    return mod


bench_torch = _load("bench_torch")
bench_dist_torch = _load("bench_dist_torch")

# small sizes that still take each config's route (filter_agg engages from
# 65536 rows)
SIZES = {"filter_agg": (70_000,), "groupby": (70_000, 3_000),
         "join": (40_000, 40_000), "join_lookup": (40_000, 4_000),
         "sortmerge": (20_000, 20_000)}


def bench_py_tables(name, *size):
    """``bench.py``'s generator calls and registrations (``bench.py:163-358``),
    copied."""
    if name == "filter_agg":
        (n_rows,) = size
        rng = np.random.default_rng(0)
        return {"t": {"k": rng.integers(0, 1 << 20, n_rows).astype(np.int64),
                      "v": rng.integers(0, 1000, n_rows).astype(np.int64)}}
    if name == "groupby":
        n_rows, n_groups = size
        rng = np.random.default_rng(1)
        return {"t": {"k": rng.integers(0, n_groups, n_rows).astype(np.int64),
                      "v": rng.integers(0, 1_000_000, n_rows).astype(np.int64)}}
    n_left, n_right = size
    if name == "join":
        rng = np.random.default_rng(2)
        nkeys = max(n_right // 2, 1)
        return {"l": {"k": rng.integers(0, nkeys, n_left).astype(np.int64)},
                "r": {"k": rng.integers(0, nkeys, n_right).astype(np.int64)}}
    if name == "join_lookup":
        rng = np.random.default_rng(2)
        lk = rng.integers(0, n_right, n_left).astype(np.int64)
        return {"l": {"k": lk, "v": rng.integers(0, 1000, n_left).astype(np.int64)},
                "r": {"k": np.arange(n_right, dtype=np.int64),
                      "w": rng.integers(0, 1000, n_right).astype(np.int64)}}
    assert name == "sortmerge"
    rng = np.random.default_rng(3)
    nkeys = max(n_right // 4, 1)
    return {"l": {"k": rng.integers(0, nkeys, n_left).astype(np.int64)},
            "r": {"k": rng.integers(0, nkeys, n_right).astype(np.int64)}}


def bench_py_fact(path, n_rows, n_groups, chunk):
    """``bench.py:228-240``'s 1B-row file, ``chunk`` rows a piece."""
    rng = np.random.default_rng(42)
    writer = None
    for lo in range(0, n_rows, chunk):
        m = min(chunk, n_rows - lo)
        t = pa.table({"k": rng.integers(0, n_groups, m),
                      "v": rng.integers(0, 1_000_000, m)})
        if writer is None:
            writer = pq.ParquetWriter(path, t.schema)
        writer.write_table(t)
    writer.close()


def _same_tables(got, exp):
    assert list(got) == list(exp)
    for t in exp:
        assert list(got[t]) == list(exp[t])
        for c in exp[t]:
            assert got[t][c].dtype == exp[t][c].dtype
            assert np.array_equal(got[t][c], exp[t][c]), (t, c)


@pytest.mark.parametrize("name", sorted(SIZES))
def test_tables_equal_bench_py(name):
    _same_tables(bench_torch.CONFIGS[name].tables(*SIZES[name]),
                 bench_py_tables(name, *SIZES[name]))


def test_quick_and_full_sizes_are_bench_py_s():
    quick = bench_torch.config_sizes(True, 1.0)
    full = bench_torch.config_sizes(False, 1.0)
    assert quick == {"filter_agg": (1 << 20,), "groupby": (1 << 20, 1 << 14),
                     "join": (1 << 20, 1 << 20),
                     "join_lookup": (1 << 20, 1 << 17),
                     "sortmerge": (1 << 19, 1 << 17),
                     "groupby_1b": (1 << 22, 1 << 14)}
    assert full == {"filter_agg": (200_000_000,),
                    "groupby": (100_000_000, 4_000_000),
                    "join": (100_000_000, 100_000_000),
                    "join_lookup": (100_000_000, 10_000_000),
                    "sortmerge": (25_000_000, 25_000_000),
                    "groupby_1b": (1_000_000_000, 4_000_000)}
    assert bench_torch.config_sizes(False, 0.5)["join"] == (50_000_000,) * 2


def _jax_engine(join_expansion):
    """``bench.py``'s ``_engine`` settings on the JAX package."""
    return JaxOlapEngine(JaxEngineConfig(
        backend="device", join_expansion=join_expansion, max_groups=1 << 23,
        min_shape_bucket=1 << 16, enable_cache=False))


def _frame(result):
    df = result.to_pandas()
    return df.sort_values(list(df.columns)).reset_index(drop=True)


@pytest.mark.parametrize("name", sorted(SIZES))
def test_answer_equals_numpy_and_the_jax_engine(name):
    cfg = bench_torch.CONFIGS[name]
    tables = cfg.tables(*SIZES[name])
    expected = cfg.expected(tables)
    port = bench_torch.make_engine("cpu", cfg.join_expansion)
    ref = _jax_engine(cfg.join_expansion)
    for t, cols in tables.items():
        port.register(t, cols)
        ref.register(t, cols)
    got, exp = port.query(cfg.sql), ref.query(cfg.sql)
    bench_torch.check_answer(name, got, expected)
    bench_torch.check_answer(name, exp, expected)
    assert _frame(got).equals(_frame(exp))
    # the harness: the same answer, on the JAX engine's route, timed
    res = bench_torch.run_config(name, SIZES[name], 2, "cpu")
    assert res["exact"] and res["backend"] == "torch-cpu"
    assert cfg.route in res["routes"] and len(res["walls"]) == 2
    assert res["rows_per_sec"] == res["rows"] / res["seconds"]
    assert res["hbm_roofline_bytes_per_sec"] == 5.0e10
    assert res["sol_frac"] == cfg.sol_bytes(*SIZES[name]) / \
        res["exec_seconds"] / 5.0e10


def test_groupby_1b_file_answer_and_jax(tmp_path, monkeypatch):
    n, g, piece = 150_000, 2_000, 64_000
    monkeypatch.setattr(bench_torch, "PIECE_ROWS", piece)
    ours, theirs = tmp_path / "ours.parquet", tmp_path / "bench.parquet"
    acc, _ = bench_torch.write_fact(str(ours), n, g, "cpu")
    bench_py_fact(str(theirs), n, g, piece)
    got, exp = pq.read_table(ours), pq.read_table(theirs)
    assert got.schema == exp.schema and got.equals(exp)

    k, v = got.column("k").to_numpy(), got.column("v").to_numpy()
    expected = acc.expected()
    keys = np.unique(k)
    assert np.array_equal(expected["k"], keys)
    assert np.array_equal(expected["s"], [v[k == x].sum() for x in keys])
    assert np.array_equal(expected["mn"], [v[k == x].min() for x in keys])
    assert np.array_equal(expected["mx"], [v[k == x].max() for x in keys])
    again = bench_torch.read_fact(str(ours), g, "cpu").expected()
    assert all(np.array_equal(again[c], expected[c]) for c in expected)

    ref = JaxOlapEngine(JaxEngineConfig(backend="device",
                                        enable_cache=False))
    ref.load_table("t", str(ours))
    bench_torch.check_answer("groupby_1b (JAX)",
                             ref.query(bench_torch.GROUPBY_SQL), expected)
    # the harness: streamed, exact, once writing the file and once reading it
    path = tmp_path / "named.parquet"
    monkeypatch.setenv("GPU_OLAP_1B_PARQUET", str(path))
    for _ in range(2):
        res = bench_torch.run_config("groupby_1b", (n, g), 3, "cpu")
        assert res["exact"] and res["backend"].startswith("torch-streaming")
        assert res["rows"] == n and res["groups"] == len(keys)
        assert res["stream_chunks"] >= 1 and len(res["walls"]) == 1
    assert path.exists()


def test_check_answer_rejects_a_difference():
    class R:
        def __init__(self, d):
            self.d = d

        def to_pandas(self):
            import pandas as pd

            return pd.DataFrame(self.d)

    bench_torch.check_answer("ok", R({"k": [2, 1], "s": [5, 4]}),
                             {"k": [1, 2], "s": [4, 5]})
    with pytest.raises(AssertionError, match="column s"):
        bench_torch.check_answer("off by one", R({"k": [1, 2], "s": [4, 6]}),
                                 {"k": [1, 2], "s": [4, 5]})
    with pytest.raises(AssertionError, match="columns"):
        bench_torch.check_answer("renamed", R({"n": [1]}), {"m": [1]})


def test_micro_runs_on_the_port_s_frontend():
    micro = bench_torch.bench_micro(iters=20)
    assert sorted(micro) == ["optimize_simple", "parse_complex_join",
                             "parse_simple_select"]
    assert all(v > 0 for v in micro.values())


# ---------------------------------------------------------------------------
# bench_dist_torch
# ---------------------------------------------------------------------------

def bench_dist_py_data(n, zipf):
    """``bench_dist.py:36-50``, copied."""
    rng = np.random.default_rng(0)
    n_keys = max(n // 16, 64)
    if zipf:
        raw = rng.zipf(1.5, n).astype(np.int64)
        lk = np.clip(raw, 1, n_keys) - 1
    else:
        lk = rng.integers(0, n_keys, n).astype(np.int64)
    rk = rng.integers(0, n_keys, n).astype(np.int64)
    lv = rng.integers(1, 100, n).astype(np.int64)
    rv = rng.integers(1, 100, n).astype(np.int64)
    return n_keys, lk, rk, lv, rv


def bench_dist_py_plan(lk, rk, ndev, rows_per_dev, zipf):
    """``bench_dist.py:55-86`` on JAX's ``skew``, copied."""
    heavy = np.zeros(0, dtype=np.int64)
    if zipf:
        heavy = jax_skew.detect_heavy_keys(lk, row_threshold=max(
            256, rows_per_dev // 4))
        light_mask = ~np.isin(lk, heavy)
        hist = np.asarray(jax_skew.partition_histogram(
            jnp.asarray(lk[light_mask]), ndev))
    else:
        hist = np.asarray(jax_skew.partition_histogram(jnp.asarray(lk), ndev))
    rhist = np.asarray(jax_skew.partition_histogram(jnp.asarray(rk), ndev))
    capacity = max(
        jax_skew.recommend_capacity(hist, ndev, headroom=1.6 if zipf else 1.3),
        jax_skew.recommend_capacity(rhist, ndev, headroom=1.3))
    join_capacity = rows_per_dev * 24
    if zipf:
        join_capacity = rows_per_dev * 32
    return capacity, join_capacity, heavy


# 2 x 20000 keys reach the radix-histogram path (32768 keys) in both packages
ROWS_PER_DEV = 20_000


@pytest.mark.parametrize("zipf", [False, True], ids=["uniform", "zipf"])
def test_config5_data_equals_bench_dist_py(zipf):
    got = bench_dist_torch.config5_data(40_000, zipf)
    exp = bench_dist_py_data(40_000, zipf)
    assert got[0] == exp[0]
    assert all(np.array_equal(a, b) and a.dtype == b.dtype
               for a, b in zip(got[1:], exp[1:]))


@pytest.mark.parametrize("ndev", [1, 2])
@pytest.mark.parametrize("zipf", [False, True], ids=["uniform", "zipf"])
def test_bench_step_plans_as_jax_and_matches_numpy(ndev, zipf):
    res = bench_dist_torch.bench_step(ndev, ROWS_PER_DEV, 1, zipf,
                                      device="cpu")
    _, lk, rk, _, _ = bench_dist_py_data(ndev * ROWS_PER_DEV, zipf)
    capacity, join_capacity, heavy = bench_dist_py_plan(
        lk, rk, ndev, ROWS_PER_DEV, zipf)
    assert (res["shuffle_capacity"], res["join_capacity"]) == \
        (capacity, join_capacity)
    assert res["exact"] is True and res["ndev"] == ndev
    assert res["rows"] == 2 * ndev * ROWS_PER_DEV
    if heavy.size:
        assert res["mode"] == "skew-broadcast"
        assert res["heavy_keys"] == heavy.size
    else:
        assert "mode" not in res and 0 < res["shuffle_frac"] < 1
    assert res["launches"] == {"radix_hist": 0}  # CPU tensors never launch


def test_bench_step_overflow_raises(monkeypatch):
    real = bench_dist_torch.plan_capacity

    def tight(*args):
        return {**real(*args), "capacity": 128}

    monkeypatch.setattr(bench_dist_torch, "plan_capacity", tight)
    with pytest.raises(RuntimeError, match="overflow at ndev=2"):
        bench_dist_torch.bench_step(2, 4096, 1, False, device="cpu")


# ---------------------------------------------------------------------------
# the roofline helpers of utils/metrics.py
# ---------------------------------------------------------------------------

SPANS = [("scan", 0.5, 100, 10, 4_000_000_000), ("scan", 0.25, 50, 5, 10 ** 9),
         ("join", 1.0, 10, 1, 2 * 10 ** 10), ("idle", 0.0, 0, 0, 0)]


def test_roofline_helpers_equal_jax_for_the_cpu():
    jr, tr = jax_metrics.MetricsRegistry(), torch_metrics.MetricsRegistry()
    for span in SPANS:
        jr.record_span(*span)
        tr.record_span(*span, device="cpu")
    assert torch_metrics.detect_hbm_bandwidth("cpu") == \
        jax_metrics.detect_hbm_bandwidth() == \
        jax_metrics.HBM_BW_BY_PLATFORM["cpu"] == \
        torch_metrics.HBM_BW_BY_PLATFORM["cpu"]
    for label in ("scan", "join", "idle", "never_recorded"):
        assert tr.roofline_fraction(label) == jr.roofline_fraction(label)
    for label in ("scan", "join"):
        assert tr.hbm_bandwidth(label) == jr.hbm_bandwidth
    assert tr.summary() == jr.summary()


@pytest.mark.parametrize("name,rate", [("NVIDIA H100 80GB HBM3", 3.35e12),
                                       ("NVIDIA H100 PCIe", 2.0e12),
                                       ("NVIDIA H100 NVL", 3.9e12)])
def test_h100_names_map_to_their_rates(name, rate, monkeypatch):
    assert torch_metrics.hbm_bandwidth_of(name) == rate
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda dev=None: name)
    assert torch_metrics.detect_hbm_bandwidth("cuda:0") == rate
    reg = torch_metrics.MetricsRegistry()
    reg.record_span("device_execute", 0.5, bytes_accessed=10 ** 12,
                    device=torch.device("cuda", 0))
    assert reg.hbm_bandwidth("device_execute") == rate
    assert reg.roofline_fraction("device_execute") == 2 * 10 ** 12 / rate


def test_an_unknown_card_raises_and_never_takes_the_cpu_rate(monkeypatch):
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda dev=None: "NVIDIA A100-SXM4-80GB")
    with pytest.raises(LookupError, match="A100-SXM4-80GB"):
        torch_metrics.detect_hbm_bandwidth("cuda")
    reg = torch_metrics.MetricsRegistry()
    reg.record_span("device_execute", 0.5, bytes_accessed=100, device="cuda:0")
    with pytest.raises(LookupError, match="A100"):
        reg.roofline_fraction("device_execute")
    with pytest.raises(LookupError, match="A100"):
        reg.summary()


def test_a_span_without_one_device_has_no_rate(monkeypatch):
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda dev=None: "NVIDIA H100 80GB HBM3")
    reg = torch_metrics.MetricsRegistry()
    reg.record_span("mixed", 1.0, bytes_accessed=100, device="cpu")
    reg.record_span("mixed", 1.0, bytes_accessed=100, device="cuda:0")
    reg.record_span("unplaced", 1.0, bytes_accessed=100)
    for label in ("mixed", "unplaced"):
        with pytest.raises(ValueError, match="no single memory rate"):
            reg.roofline_fraction(label)
    assert [r["hbm_roofline_frac"] for r in reg.summary()] == [None, None]


# ---------------------------------------------------------------------------
# the scripts as a user runs them
# ---------------------------------------------------------------------------

def _run(script, args, cwd, env=None, timeout=240):
    return subprocess.run(
        [sys.executable, os.path.join(ROOT, script), *args], cwd=cwd,
        env=dict(os.environ, **(env or {})), capture_output=True, text=True,
        timeout=timeout)


def test_bench_torch_prints_one_json_line(tmp_path):
    res = _run("bench_torch.py", ["--quick", "--device", "cpu", "--only",
                                  "filter_agg", "--iters", "2"], tmp_path)
    assert res.returncode == 0, res.stderr
    lines = res.stdout.splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert list(line) == ["metric", "value", "unit", "vs_baseline"]
    assert line["metric"] == "filter_agg_200M_quick_rows_per_sec"
    assert line["unit"] == "rows/s" and line["value"] > 0
    with open(tmp_path / "bench_results_torch_quick.json") as f:
        saved = json.load(f)
    assert saved["statuses"] == {"filter_agg": "ok"}
    got = saved["results"]["filter_agg"]
    assert got["exact"] and got["rows"] == 1 << 20 and len(got["walls"]) == 2
    assert line["vs_baseline"] == round(got["rows_per_sec"] / 526e6, 4)


def test_bench_torch_failed_config_exits_1_with_no_line(tmp_path):
    bad = tmp_path / "bad.parquet"
    bad.write_bytes(b"not parquet")
    res = _run("bench_torch.py", ["--quick", "--device", "cpu", "--only",
                                  "groupby_1b"], tmp_path,
               {"GPU_OLAP_1B_PARQUET": str(bad)})
    assert res.returncode == 1 and res.stdout == ""
    assert "groupby_1b FAILED: exit_1" in res.stderr
    with open(tmp_path / "bench_results_torch_quick.json") as f:
        saved = json.load(f)
    assert saved["statuses"] == {"groupby_1b": "exit_1"}
    assert saved["results"] == {}


@pytest.mark.parametrize("script", ["bench_torch.py", "bench_dist_torch.py"])
def test_without_a_card_the_scripts_exit_2_naming_cuda(script, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    res = _run(script, [], tmp_path)
    assert res.returncode == 2 and res.stdout == ""
    assert "CUDA" in res.stderr and "--device cpu" in res.stderr


def test_bench_dist_torch_over_two_gloo_ranks(tmp_path):
    res = _run("bench_dist_torch.py",
               ["--device", "cpu", "--ranks", "2", "--devices", "2", "4",
                "--rows-per-dev", "4096", "--iters", "1"], tmp_path,
               {"OMP_NUM_THREADS": "1"})
    assert res.returncode == 0, res.stderr
    line = json.loads(res.stdout)
    assert line["metric"] == "dist_join_groupby_rows_per_sec_4dev"
    with open(tmp_path / "bench_dist_torch.json") as f:
        saved = json.load(f)
    assert saved["ranks"] == 2
    for r, ndev in zip(saved["results"], (2, 4)):
        assert r["ndev"] == ndev and r["exact"] is True
        assert len(r["rank_seconds"]) == 2
        assert r["seconds"] == max(r["rank_seconds"])
        assert "over 2 ranks" in r["mesh"]
    # the ranks plan the capacity one process plans
    one = bench_dist_torch.bench_step(4, 4096, 1, False, device="cpu")
    assert saved["results"][1]["shuffle_capacity"] == one["shuffle_capacity"]
    assert saved["results"][1]["scaling_efficiency"] > 0
