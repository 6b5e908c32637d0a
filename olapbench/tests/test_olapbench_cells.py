"""Each cell driven on the CPU at a tiny scale: the port on ``device="cpu"``
against the reference for every query of every mix; the control (the
reference in the precision below, in the program's place) and the faults a
query engine can have must come out not correct; a cell on the card."""

import time

import numpy as np
import pytest
from conftest import SCALES

from olapbench.core import cell, spec

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


def _seconds(name):
    """A window long enough here for every query of the mix to run."""
    return max(2.0, 0.8 * len(cell.Cell(name).mix["queries"]))


def _run(name, make_engine=cell.default_engine, seed=2**32 + 7):
    scale = SCALES[spec.workload(name)["config"]]
    return cell.run(name, seed, _seconds(name), False, "cpu",
                    time.monotonic(), scale=scale, make_engine=make_engine)


@pytest.mark.parametrize("name", CELLS)
def test_port_on_cpu_equals_the_reference(name):
    out = _run(name)
    line, info = out["line"], out["info"]
    assert line["correct"], info
    assert line["failed"] == 0 and line["attempted"] > 0
    mix = cell.Cell(name).mix
    assert set(info["checked_by_name"]) == set(mix["queries"])
    assert list(line)[-1] == "checks"
    assert {m["name"] for m in spec.metrics_of(name, False)} <= set(
        line["metrics"])


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    """The reference in int32 and float32 in the program's place fails a
    compared number of every cell."""
    from olapbench.readings import readings

    lines = list(readings([name], [2**31 + 3], _seconds(name), "cpu",
                          SCALES[spec.workload(name)["config"]]))
    assert lines[0]["program_correct"], lines[0]
    assert not lines[0]["control_correct"], lines[0]


class _Wrapped:
    """The program, with a fault planted where answers are produced."""

    def __init__(self, cfg, device, fault, warm):
        self.eng = cell.default_engine(cfg, device)
        self.metrics = self.eng.metrics
        self.fault = fault
        self.warm = warm  # queries of the set-up, which must answer
        self.calls = 0

    def register(self, name, table):
        if self.fault == "half_rows":
            table = table.slice(0, table.num_rows // 2)
        self.eng.register(name, table)

    def query(self, sql):
        res = self.eng.query(sql)
        if self.fault == "altered_answer" and res.num_rows:
            col = res.batch().columns[-1]
            col.data = np.array(col.data, copy=True)
            col.data[0] += 1
        self.calls += 1
        if self.fault == "raises" and self.calls > self.warm:
            raise RuntimeError("planted")
        return res


@pytest.mark.parametrize("fault", ["altered_answer", "half_rows", "raises"])
@pytest.mark.parametrize("name", CELLS)
def test_planted_fault_is_not_correct(name, fault):
    warm = len(cell.Cell(name).mix["queries"])
    out = _run(name, lambda cfg, dev: _Wrapped(cfg, dev, fault, warm))
    assert not out["line"]["correct"], out


@pytest.mark.cuda
def test_cell_on_the_card():
    """One short run of the first cell through ``run.py``'s path."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = cell.run(CELLS[0], 2**31 + 5, 3.0, False, "cuda", time.monotonic())
    assert out["line"]["correct"], out["info"]
