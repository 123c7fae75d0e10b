"""Executes every ```python block of ``docs/manual_torch.md``, the port's
manual, in order, in one shared namespace, on the CPU (the blocks use the
default device): the port's counterpart of ``tests/test_docs.py``. The
manual has one block for each of ``docs/manual.md``'s."""

import pathlib
import re
import textwrap

from tests.test_torch_helpers import torch_cpu  # noqa: F401

DOCS = pathlib.Path(__file__).resolve().parent.parent / "docs"

_BLOCK_RE = re.compile(r"```python\n(.*?)```", re.DOTALL)


def _blocks(name):
    return [textwrap.dedent(b) for b in _BLOCK_RE.findall((DOCS / name).read_text())]


def test_manual_blocks_run():
    blocks = _blocks("manual_torch.md")
    assert len(blocks) == len(_blocks("manual.md")) == 27
    ns = {}
    try:
        for i, block in enumerate(blocks):
            assert "jax" not in block and '"cuda"' not in block, f"block {i}"
            try:
                exec(compile(block, f"manual_torch.md[block {i}]", "exec"), ns)
            except Exception as e:  # pragma: no cover - diagnostic
                raise AssertionError(
                    f"manual_torch.md block {i} failed: {e}\n--- block ---\n{block}"
                ) from e
    finally:
        from stheno_torch.matrix import clear_rules

        clear_rules()
