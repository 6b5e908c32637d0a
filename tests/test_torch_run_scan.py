"""The join path's run scans (kernel ``run_scan``) against JAX's.

``cummax_i32`` / ``rev_cummin_i32`` (``gpu_olap_tpu_torch/ops/kernels/
run_scan.py``) stand in for ``jax.lax.cummax`` and
``jnp.flip(jax.lax.cummin(jnp.flip(x)))`` of ``gpu_olap_tpu/ops/join.py``.
Inputs are made with numpy from a seed and go through both; on CPU tensors
the wrappers run their plain versions, which must equal JAX exactly.  The
``cuda``-marked twin runs the kernel against the plain version on a GPU and
skips without one (``python -m pytest --noconftest
tests/test_torch_run_scan.py -m cuda`` runs it without JAX).
"""

import ast
import os
import zlib

import numpy as np
import pytest
import torch

from gpu_olap_tpu_torch.ops import join as tj
from gpu_olap_tpu_torch.ops.kernels import _build
from gpu_olap_tpu_torch.ops.kernels import run_scan as rs

I32_MIN, I32_MAX = -(1 << 31), (1 << 31) - 1
LENGTHS = (1, 1023, 1024, 1025, 4097, 100_003)
KINDS = ("join_seeds", "uniform_extremes", "all_equal", "descending")
SCANS = ("cummax", "rev_cummin")
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(rs.__file__)))))


def _input(kind: str, n: int, scan: str) -> np.ndarray:
    """int32 (n,) from a seed.  ``join_seeds`` are the join's: a key run's
    seed ascending at its start (cummax) or end (rev_cummin) and -1 or
    INT32_MAX elsewhere, over sorted keys with runs of 1 to about 8."""
    rng = np.random.default_rng(zlib.crc32(f"{kind}/{n}/{scan}".encode()))
    if kind == "join_seeds":
        keys = np.sort(rng.integers(0, max(n // 4, 1), n))
        cuts = np.flatnonzero(np.diff(keys)) + 1
        seen = np.cumsum(rng.random(n) < 0.5).astype(np.int32)
        if scan == "cummax":
            at = np.concatenate([[0], cuts])
            out = np.full(n, -1, np.int32)
        else:
            at = np.concatenate([cuts - 1, [n - 1]])
            out = np.full(n, I32_MAX, np.int32)
        out[at] = seen[at]
        return out
    if kind == "uniform_extremes":
        out = rng.integers(I32_MIN, I32_MAX, n, endpoint=True).astype(np.int32)
        out[rng.integers(0, n, 2)] = (I32_MIN, I32_MAX)
        return out
    if kind == "all_equal":
        return np.full(n, int(rng.integers(I32_MIN, I32_MAX)), np.int32)
    return (1_000_000 - 3 * np.arange(n)).astype(np.int32)  # descending


def _jax_scan(scan: str, x: np.ndarray) -> np.ndarray:
    import jax
    import jax.numpy as jnp

    a = jnp.asarray(x)
    if scan == "cummax":
        return np.asarray(jax.lax.cummax(a))
    return np.asarray(jnp.flip(jax.lax.cummin(jnp.flip(a))))


def _wrapper(scan: str):
    return rs.cummax_i32 if scan == "cummax" else rs.rev_cummin_i32


def _plain(scan: str):
    return rs.cummax_plain if scan == "cummax" else rs.rev_cummin_plain


@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("scan", SCANS)
def test_run_scan_matches_jax(scan, kind, n):
    x = _input(kind, n, scan)
    exp = _jax_scan(scan, x)
    before = _build.launches["run_scan"]
    got = _wrapper(scan)(torch.from_numpy(x))
    plain = _plain(scan)(torch.from_numpy(x))
    assert got.dtype == torch.int32 and got.shape == (n,)
    np.testing.assert_array_equal(got.numpy(), exp)
    np.testing.assert_array_equal(plain.numpy(), exp)
    assert _build.launches["run_scan"] == before  # CPU tensors never launch


@pytest.mark.parametrize("scan", SCANS)
@pytest.mark.parametrize("bad", ["int64", "2d", "non_contiguous"])
def test_run_scan_rejects(scan, bad):
    x = torch.arange(64, dtype=torch.int32)
    arg = {"int64": x.to(torch.int64), "2d": x.reshape(8, 8),
           "non_contiguous": x[::2]}[bad]
    with pytest.raises(ValueError):
        _wrapper(scan)(arg)


@pytest.mark.parametrize("scan", SCANS)
def test_run_scan_empty(scan):
    got = _wrapper(scan)(torch.zeros(0, dtype=torch.int32))
    assert got.dtype == torch.int32 and got.shape == (0,)


# (operator, cummax calls, rev_cummin calls) per call of the operator
ROUTES = {"probe_ranges_merge": (1, 0), "probe_counts_sorted": (2, 1),
          "inner_join_stream": (1, 0)}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_join_scans_go_through_run_scan(route, monkeypatch):
    """Every run fill of the join operators calls the ``run_scan`` wrappers,
    and no ``torch.cummax``/``torch.cummin`` runs outside them."""
    calls = {"cummax_i32": 0, "rev_cummin_i32": 0, "cummax": 0, "cummin": 0}

    def counted(module, name):
        orig = getattr(module, name)

        def call(*args, **kw):
            calls[name] += 1
            return orig(*args, **kw)
        monkeypatch.setattr(module, name, call)

    counted(tj, "cummax_i32")
    counted(tj, "rev_cummin_i32")
    counted(torch, "cummax")
    counted(torch, "cummin")
    rng = np.random.default_rng(17)
    lc = torch.from_numpy(rng.integers(0, 300, 2000).astype(np.int32))
    rc = torch.from_numpy(rng.integers(50, 350, 1500).astype(np.int32))
    linv = torch.from_numpy(rng.random(2000) < 0.05)
    rinv = torch.from_numpy(rng.random(1500) < 0.05)
    fold = (0, 349)
    if route == "probe_ranges_merge":
        _lo, cnt = tj.probe_ranges_merge(rc, rinv, lc, linv, fold_range=fold)
        total = int(cnt.sum())
    elif route == "probe_counts_sorted":
        out = tj.probe_counts_sorted(rc, rinv, lc, linv, fold_range=fold)
        total = int(out[2].sum())
        assert int(out[4].sum()) == total  # per-build counts: the same pairs
    else:
        res = tj.inner_join_stream(lc, linv, rc, rinv, 1 << 16, fold)
        total = int(res["total"])
    assert total > 0
    want_max, want_min = ROUTES[route]
    assert (calls["cummax_i32"], calls["rev_cummin_i32"]) == (want_max,
                                                             want_min)
    # each wrapper call on the CPU is one plain scan, and nothing else scans
    assert (calls["cummax"], calls["cummin"]) == (want_max, want_min)


def test_no_torch_scan_outside_the_plain_versions():
    """``torch.cummax``/``torch.cummin`` appear in the port only inside
    ``cummax_plain`` and ``rev_cummin_plain``."""
    found = set()

    def visit(node, path, owner):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            owner = node.name
        if isinstance(node, ast.Attribute) and \
                node.attr in ("cummax", "cummin"):
            found.add((path, owner, node.attr))
        for child in ast.iter_child_nodes(node):
            visit(child, path, owner)

    for root, _dirs, files in os.walk(os.path.join(ROOT,
                                                   "gpu_olap_tpu_torch")):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(root, f)
                with open(path) as fh:
                    visit(ast.parse(fh.read(), path),
                          os.path.relpath(path, ROOT), None)
    scan_py = "gpu_olap_tpu_torch/ops/kernels/run_scan.py"
    assert found == {(scan_py, "cummax_plain", "cummax"),
                     (scan_py, "rev_cummin_plain", "cummin")}


@pytest.mark.cuda
@pytest.mark.parametrize("scan", SCANS)
def test_run_scan_cuda_matches_plain(scan):
    """The kernel against its plain version on the card: every kind and
    length above, tile edges (4096 - 1, 4096, 4096 + 1, many tiles) and
    views at offsets 1-3 (scalar loads); each call counts one launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    dev = torch.device("cuda", 0)
    tile = _build.load().olap_run_scan_tile()
    cases = [_input(kind, n, scan) for kind in KINDS for n in LENGTHS]
    cases += [_input("uniform_extremes", n, scan)
              for n in (tile - 1, tile, tile + 1, 1000 * tile + 5)]
    wrapper, plain = _wrapper(scan), _plain(scan)
    for x in cases:
        xd = torch.from_numpy(x).to(dev)
        before = _build.launches["run_scan"]
        got = wrapper(xd)
        assert _build.launches["run_scan"] == before + 1
        torch.cuda.synchronize()
        assert torch.equal(got, plain(xd))
        for off in (1, 2, 3):
            view = xd[off:]
            if view.numel():
                assert torch.equal(wrapper(view), plain(view))
    assert wrapper(torch.zeros(0, dtype=torch.int32, device=dev)).numel() == 0
