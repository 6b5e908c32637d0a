"""``examples/torch_usage.py``: every flow on ``device="cpu"`` at a reduced
size, each result held against the same seeded flow on the JAX package's
``GpuOlapEngine`` (its device path) and on the NumPy oracle
(``backend="cpu"``), and the script's ``main``."""

import functools
import importlib.util
import os

import numpy as np
import pytest

import gpu_olap_tpu as jgot

_PATH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "examples", "torch_usage.py")
_spec = importlib.util.spec_from_file_location("torch_usage", _PATH)
torch_usage = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(torch_usage)

#: a fortieth of the demo sizes (at least 10,000 rows a table)
SCALE = 40

_ENGINES = {
    "port": torch_usage.port_engine("cpu"),
    "oracle": torch_usage.port_engine("cpu", backend="cpu"),
    "jax": functools.partial(jgot.GpuOlapEngine, backend="device"),
}


@functools.cache
def _run(flow, engine: str) -> dict:
    """``flow``'s results on one of ``_ENGINES``, run once per module."""
    return flow(_ENGINES[engine], SCALE)


def _same_frame(got, exp, what):
    assert list(got.columns) == list(exp.columns), what
    assert len(got) == len(exp), what
    for c in got.columns:
        g, e = got[c].to_numpy(), exp[c].to_numpy()
        if g.dtype.kind == "f" or e.dtype.kind == "f":
            # float aggregates are summed in another order
            np.testing.assert_allclose(g.astype(float), e.astype(float),
                                       rtol=1e-12, atol=0, err_msg=what)
        else:
            np.testing.assert_array_equal(g, e, err_msg=what)


def _check_flow(flow, reference: str):
    got, exp = _run(flow, "port"), _run(flow, reference)
    assert got.keys() == exp.keys()
    if flow is torch_usage.example_polars_integration and \
            importlib.util.find_spec("polars") is None:
        assert got == {}  # gated on the import, as in the JAX example
        return
    assert got, "the flow returned no result"
    for name, r in got.items():
        assert r.metrics["backend"] == "torch-cpu", (name, r.metrics)
        _same_frame(r.to_pandas(), exp[name].to_pandas(), name)
    return exp


_FLOWS = pytest.mark.parametrize("flow", torch_usage.FLOWS,
                                 ids=[f.__name__ for f in torch_usage.FLOWS])


@_FLOWS
def test_flow_matches_jax(flow):
    _check_flow(flow, "jax")


@_FLOWS
def test_flow_matches_the_oracle(flow):
    exp = _check_flow(flow, "oracle")
    for r in (exp or {}).values():
        assert r.metrics["backend"] == "cpu"


def test_demo_scale_follows_the_device():
    assert torch_usage.demo_scale("cuda") == torch_usage.demo_scale(
        "cuda:0") == 1
    assert torch_usage.demo_scale("cpu") == torch_usage.CPU_SCALE


def test_main_on_cpu(capsys):
    assert torch_usage.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    for header in ("=== Basic Queries ===", "=== Pandas Integration ===",
                   "=== Complex Analytics ===",
                   "=== Join Performance Benchmark ===",
                   "Examples completed!"):
        assert header in out
