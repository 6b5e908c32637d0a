"""The port's CLI (``python -m gpu_olap_tpu_torch``): the five cases of
``tests/test_cli.py`` with ``--device cpu``, driven in-process through
``cli.main`` and held against the JAX package's CLI on the same file, plus
the mesh flags, the REPL, and the default device: without a GPU the CLI
exits non-zero and names CUDA."""

import subprocess
import sys

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from gpu_olap_tpu import cli as jcli
from gpu_olap_tpu_torch import cli as tcli


@pytest.fixture(scope="module")
def parquet(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("cli") / "t.parquet")
    pq.write_table(pa.table({"k": np.arange(100) % 5,
                             "v": np.arange(100, dtype=np.float64)}), path)
    return path


def _run(capsys, *args, device="cpu"):
    rc = tcli.main(["--device", device, *args])
    out = capsys.readouterr()
    return rc, out.out, out.err


def test_cli_one_shot(parquet, capsys):
    sql = "SELECT k, SUM(v) AS s FROM t GROUP BY k ORDER BY k"
    rc, out, err = _run(capsys, "--table", f"t={parquet}", sql)
    assert rc == 0, err
    assert "950" in out  # k=0 sum: 0+5+...+95
    assert "rows in" in err and "[torch-cpu]" in err
    # the same table as the JAX package's CLI prints on its oracle
    assert jcli.main(["--backend", "cpu", "--table", f"t={parquet}", sql]) == 0
    assert capsys.readouterr().out == out


def test_cli_explain(parquet, capsys):
    sql = "SELECT v FROM t WHERE v > 10"
    rc, out, _ = _run(capsys, "--table", f"t={parquet}", "--explain", sql)
    assert rc == 0
    assert "TpuTableScan" in out and "Filter" in out
    assert jcli.main(["--table", f"t={parquet}", "--explain", sql]) == 0
    assert capsys.readouterr().out == out


def test_cli_sql_error(parquet, capsys):
    rc, _, err = _run(capsys, "--table", f"t={parquet}", "SELEC v FROM t")
    assert rc == 0
    assert "error:" in err


def test_cli_bad_table_spec(capsys):
    rc, _, err = _run(capsys, "--table", "nopath", "SELECT 1 FROM t")
    assert rc == 2
    assert "NAME=PATH" in err


def test_cli_missing_file(capsys):
    rc, _, err = _run(capsys, "--table", "t=/nonexistent/file.parquet",
                      "SELECT 1 FROM t")
    assert rc == 2
    assert "error loading" in err


def test_cli_max_rows_and_cpu_backend(parquet, capsys):
    rc, out, err = _run(capsys, "--backend", "cpu", "--max-rows", "3",
                        "--table", f"t={parquet}",
                        "SELECT k, v FROM t ORDER BY v")
    assert rc == 0
    assert "... (100 rows total)" in out
    assert len(out.splitlines()) == 1 + 3 + 1  # header, 3 rows, footer
    assert "[cpu]" in err


def test_cli_mesh_devices(parquet, capsys):
    rc, out, err = _run(capsys, "--mesh", "8", "--mesh-devices",
                        ",".join(["cpu"] * 8), "--table", f"t={parquet}",
                        "SELECT k, SUM(v) AS s FROM t GROUP BY k ORDER BY k")
    assert rc == 0, err
    assert "950" in out
    assert "[torch-distributed]" in err


def test_cli_mesh_devices_without_mesh(parquet, capsys):
    rc, _, err = _run(capsys, "--mesh-devices", "cpu,cpu",
                      "--table", f"t={parquet}", "SELECT k FROM t")
    assert rc == 2
    assert "error:" in err and "mesh_shape" in err


def test_cli_repl(parquet, capsys, monkeypatch):
    lines = iter(["SELECT COUNT(*) AS n", "FROM t;", "\\q"])
    monkeypatch.setattr("builtins.input", lambda prompt="": next(lines))
    rc, out, err = _run(capsys, "--table", f"t={parquet}")
    assert rc == 0
    assert "tables: ['t']" in out and "100" in out
    assert "[torch-cpu]" in err


def test_cli_defaults_to_cuda(parquet):
    """``python -m gpu_olap_tpu_torch`` without ``--device`` runs on CUDA:
    without a GPU it exits 2 and names CUDA, and runs nothing on the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the CLI runs on it")
    r = subprocess.run(
        [sys.executable, "-m", "gpu_olap_tpu_torch", "--table",
         f"t={parquet}", "SELECT COUNT(*) AS n FROM t"],
        capture_output=True, text=True, timeout=120)
    assert r.returncode == 2
    assert "CUDA is not available" in r.stderr
    assert r.stdout == ""
