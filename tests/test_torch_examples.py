"""Smoke-run every script in ``examples_torch/``, the port's counterparts
of ``examples/``: each runs end to end on the CPU (the scripts use the
default device, which the tests set to the CPU) and prints. The
statistical outcomes of the same workflows, held against the JAX
package's, are in ``tests/test_torch_readme_examples.py``. The scripts
import neither JAX nor the JAX package."""

import ast
import pathlib
import runpy

import pytest

from tests.test_torch_helpers import torch_cpu  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent
EXAMPLES = sorted(
    (ROOT / "examples_torch").glob("example*.py"),
    key=lambda p: int("".join(c for c in p.stem.split("_")[0] if c.isdigit())),
)


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module or ""


def test_one_port_example_per_jax_example():
    jax_names = sorted(p.name for p in (ROOT / "examples").glob("example*.py"))
    assert sorted(p.name for p in EXAMPLES) == jax_names and len(EXAMPLES) == 16


@pytest.mark.parametrize("path", EXAMPLES, ids=lambda p: p.stem)
def test_example_runs(path, capsys):
    bad = [m for m in _imports(path) if m.split(".")[0] in ("jax", "optax", "stheno_tpu")]
    assert not bad, f"{path.name} imports {bad}"
    assert '"cuda"' not in path.read_text()
    runpy.run_path(str(path), run_name="__main__")
    out = capsys.readouterr().out
    assert out.strip(), f"{path.name} printed nothing"
