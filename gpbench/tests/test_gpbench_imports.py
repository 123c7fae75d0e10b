"""Nothing a run loads for any cell pulls in JAX or the JAX package, and
the plain references load nothing of the program. Names are compared by
their whole top-level part: ``stheno_torch`` is not ``stheno_tpu``."""

import json
import os
import subprocess
import sys

from gpbench.harness import bench
from gpbench.harness.imports import forbidden_loaded

CHILD = r"""
import importlib, importlib.util, json, sys
sys.path.insert(0, {root!r})
from gpbench.harness import bench
b = bench.load_benchmark()
mods = {mods!r}
for m in mods:
    importlib.import_module(m)
if {metrics!r}:
    for m in b["end_to_end"] + b["per_layer"]:
        path = bench.PKG / "metrics" / (m["name"] + ".py")
        spec = importlib.util.spec_from_file_location(m["name"], path)
        spec.loader.exec_module(importlib.util.module_from_spec(spec))
print(json.dumps(sorted({{k.split(".", 1)[0] for k in sys.modules}})))
"""


def _loaded(mods, metrics=False):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", CHILD.format(root=str(bench.ROOT), mods=mods, metrics=metrics)],
        capture_output=True, text=True, env=env, check=True, timeout=300).stdout
    return set(json.loads(out.strip().splitlines()[-1]))


def _paths():
    b = bench.load_benchmark()
    return sorted({json.loads((bench.ROOT / c["file"]).read_text())["path"] for c in b["configs"]})


def test_forbidden_loaded_compares_whole_top_level_names():
    assert forbidden_loaded(["stheno_torch.ops", "jaxtyping", "stheno"]) == []
    assert forbidden_loaded(["stheno_tpu.ops", "jax.numpy", "jaxlib", "flax.linen"]) == \
        ["flax", "jax", "jaxlib", "stheno_tpu"]


def test_a_run_loads_no_jax_for_any_cell():
    mods = ["gpbench.harness.bench", "gpbench.harness.trace", "gpbench.tools.readings"]
    for p in _paths():
        mods += [f"gpbench.paths.{p}", f"gpbench.reference.{p}", f"gpbench.work.{p}"]
    loaded = _loaded(mods, metrics=True)
    assert "stheno_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "stheno_tpu"}, sorted(loaded)


def test_the_references_load_nothing_of_the_program():
    mods = [f"gpbench.reference.{p}" for p in _paths()]
    loaded = _loaded(mods)
    assert "torch" in loaded
    assert not loaded & {"stheno_torch", "jax", "jaxlib", "flax", "stheno_tpu"}, sorted(loaded)
