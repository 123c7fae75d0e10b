"""The check's control on the card comes out not correct, where the
program as configured comes out correct: at each cell's own size, with a
short window (about half a minute a case). The control is the program
with its TF32 products switched on (``stheno_torch.config.
set_matmul_precision("high")``, the nearest precision below the float32
the configurations state). The readings over many seeds that set the
limits are in PERF.md (``gpbench/tools/readings.py``)."""

import pytest

from gpbench.harness import bench

CELLS = ["mf262k-train", "n2000-adam"]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("control", [False, True], ids=["program", "control"])
def test_the_control_comes_out_not_correct(card, cell, control):
    res = bench.run_cell(cell, 2_700_000_003, 2.0, False, control=control, device=card)
    assert res["correct"] is (not control), res["checks"]
