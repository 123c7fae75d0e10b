"""A whole run with the look for a card skipped (on the CPU, the program's
plain kernels, small sizes where the cell's cannot run here): a sound run
comes out correct, and one with the timed path broken underneath comes
out not correct, once for each fault the cell can have. None of the cells
spans chips, so none has an exchange between chips to leave out."""

import pytest

from gpbench.harness import bench

MF = {"n": 512, "precond_rank": 16, "block": 256}
CASES = {
    "mf262k-train": (MF, {"check_units": 2}, ["half_batch", "answer_altered"]),
    "n2000-adam": ({}, {"steps_per_call": 1}, ["state_unchanged", "half_batch"]),
}
RUNS = [(cell, f) for cell, (_, _, faults) in CASES.items() for f in [None, *faults]]


@pytest.mark.parametrize("cell,fault", RUNS, ids=[f"{c}-{f or 'sound'}" for c, f in RUNS])
def test_a_fault_comes_out_not_correct(cpu_program, cell, fault):
    overrides, traffic, _ = CASES[cell]
    res = bench.run_cell(cell, 2_200_000_017, 0.5, False, fault=fault, device="cpu",
                         overrides=overrides, traffic_overrides=traffic, require_card=False)
    assert res["correct"] is (fault is None), res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0


def test_a_traced_run_reads_its_layers(cpu_program):
    overrides, traffic, _ = CASES["mf262k-train"]
    res = bench.run_cell("mf262k-train", 5, 0.5, True, device="cpu", overrides=overrides,
                         traffic_overrides={**traffic, "trace_units": 3}, require_card=False)
    assert res["correct"]
    assert res["metrics"]["cg_iters_per_step"]["value"] >= 1
    assert res["device"]["window_s"] > 0 and "breakdown" in res
    assert list(res)[-1] == "checks"
