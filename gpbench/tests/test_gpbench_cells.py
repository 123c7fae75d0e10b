"""Every cell that ``BENCHMARK.json`` names loads from its files, and the
file keeps to the benchmark's contract."""

import importlib
import importlib.util
import json
import re

import pytest

from gpbench.harness import bench

BENCH = bench.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "gpbench/run.py"]
    assert BENCH["paths"] == ["gpbench"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len((bench.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_lines():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append((group, e["name"]))
            for key in ("why", "layer", "source"):
                if key in e:
                    assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
    assert len(set(n for _, n in names if _ in ("end_to_end", "per_layer"))) == \
        len(BENCH["end_to_end"]) + len(BENCH["per_layer"])


def test_entry_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("gpbench/")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_setup_s_and_every_cell_reports_enough():
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}
    for cell in CELLS:
        e2e = {m["name"] for m in bench.cell_metrics(BENCH, cell, False)}
        layer = bench.cell_metrics(BENCH, cell, True)
        assert "setup_s" in e2e and len(e2e) >= 2 and layer
        for m in layer:
            assert m["moves"] in e2e, (cell, m["name"])


def test_layers_are_spelled_alike():
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert layers <= {"entry", "opt", "iterative", "matrix", "kernels", "device"}


def test_rooflines_have_an_mfu_beside_them():
    for m in BENCH["per_layer"]:
        if m["name"].endswith("_roofline") or ".roofline" in m["name"] or "_roofline." in m["name"]:
            mfus = [x for x in BENCH["per_layer"] if "mfu" in x["name"]
                    and x["moves"] == m["moves"] and set(m["workloads"]) <= set(x["workloads"])]
            assert mfus, m["name"]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_loads_from_its_files(cell):
    w, config, traffic, limits = bench.load_cell(cell)
    assert config["name"] == w["config"]
    for kind in ("paths", "reference", "work"):
        assert (bench.PKG / kind / f"{config['path']}.py").exists()
    importlib.import_module(f"gpbench.reference.{config['path']}")
    importlib.import_module(f"gpbench.work.{config['path']}")
    assert limits and all(v > 0 for v in limits.values())
    for m in bench.cell_metrics(BENCH, cell, False) + bench.cell_metrics(BENCH, cell, True):
        path = bench.PKG / "metrics" / f"{m['name']}.py"
        spec = importlib.util.spec_from_file_location(m["name"], path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        assert callable(mod.read)


def test_configurations_state_sources_and_cuts():
    for c in BENCH["configs"]:
        cfg = json.loads((bench.ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"] == []
        assert cfg["dtype"] == "float32" and cfg["matmul_precision"] == "highest"
        assert cfg["assumed"] and cfg["source"]
