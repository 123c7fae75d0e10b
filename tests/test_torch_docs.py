"""Executes every ```python block of ``docs/manual_torch.md``, the port's
manual, and of ``docs/scaling_torch.md``, its scaling guide, in order, in
one shared namespace per file, on the CPU (the blocks use the default
device; the guide's meshes span a process group of one gloo rank): the
port's counterpart of ``tests/test_docs.py``. Each file has one block for
each of its JAX counterpart's (``docs/manual.md``, ``docs/scaling.md``)."""

import pathlib
import re
import textwrap

from tests.test_torch_helpers import torch_cpu  # noqa: F401

DOCS = pathlib.Path(__file__).resolve().parent.parent / "docs"

_BLOCK_RE = re.compile(r"```python\n(.*?)```", re.DOTALL)


def _blocks(name):
    return [textwrap.dedent(b) for b in _BLOCK_RE.findall((DOCS / name).read_text())]


def _run_blocks(name, blocks):
    ns = {}
    for i, block in enumerate(blocks):
        assert "jax" not in block and '"cuda"' not in block, f"block {i}"
        try:
            exec(compile(block, f"{name}[block {i}]", "exec"), ns)
        except Exception as e:  # pragma: no cover - diagnostic
            raise AssertionError(f"{name} block {i} failed: {e}\n--- block ---\n{block}") from e


def test_manual_blocks_run():
    blocks = _blocks("manual_torch.md")
    assert len(blocks) == len(_blocks("manual.md")) == 27
    try:
        _run_blocks("manual_torch.md", blocks)
    finally:
        from stheno_torch.matrix import clear_rules

        clear_rules()


def test_scaling_blocks_run():
    from stheno_torch import config

    blocks = _blocks("scaling_torch.md")
    assert len(blocks) == len(_blocks("scaling.md")) == 17
    prev = config.matmul_precision
    try:
        _run_blocks("scaling_torch.md", blocks)
    finally:
        config.set_matmul_precision(prev)
