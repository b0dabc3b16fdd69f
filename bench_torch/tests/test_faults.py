"""The check catches what it has to, on the CPU at the small size of
`small.py` with each cell's own limits: a run with the timed path broken
underneath (every fault of `faults.py` the cell's kind can have) comes out
not correct, and so does the control, the reference put in the program's
place at the precision below the configuration's. The harness's look for a
card is skipped; the rest of a run is the benchmark's own
(`harness.execute`)."""
import pytest
import torch

from bench_torch import faults, harness
from bench_torch.tests.small import context, small_cell

CELLS = [w["name"] for w in harness.benchmark()["workloads"]]
CASES = [(c, f) for c in CELLS
         for f in faults.BY_KIND[harness.resolve(c).traffic["kind"]]]


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cell, fault", CASES)
def test_fault_is_not_correct(cell, fault):
    c = small_cell(cell)
    line = harness.execute(context(c, fault=faults.BY_KIND[c.traffic["kind"]][fault]))
    assert line["correct"] is False, line["check"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    c = small_cell(cell)
    ctx = context(c)
    kind = harness.kind_module(c.traffic["kind"])
    outcome = kind.run(ctx)
    numbers = kind.compare(ctx, outcome.check, control=c.config["control"])
    ok, check = harness.judge(numbers, c.limits)
    assert not ok, check


@pytest.mark.parametrize("cell", [c for c in CELLS if c.startswith("barf_dense_400")])
def test_sound_fp32_run_is_correct(cell):
    """At fp32 the program's plain path on the CPU and the reference agree
    to rounding, so an unbroken run reads correct; this also holds the
    reference's semantics to the program's."""
    line = harness.execute(context(small_cell(cell)))
    assert line["correct"] is True, line["check"]
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "check"]


def test_traced_line_keys():
    line = harness.execute(context(small_cell(CELLS[0]), trace=True))
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "breakdown",
                          "check"]
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert {"busy_s", "window_s"} <= set(line["device"])
