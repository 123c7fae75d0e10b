"""The one general traffic generator. A traffic mix is a JSON file of
parameters in ``traffic/``; ``kind`` says which of the two loops it
drives and the rest are that loop's parameters:

- ``steps``: training steps back to back; step ``i`` draws its probes from
  its own seed. Nothing is generated ahead.
- ``adam``: calls of ``steps_per_call`` optimiser steps back to back, after
  ``check_steps`` steps in set-up.
"""

import json
from pathlib import Path

from . import seeds

__all__ = ["load", "probe_seed"]

KINDS = ("steps", "adam")


def load(path):
    """The traffic file at ``path``, checked for its kind."""
    spec = json.loads(Path(path).read_text())
    if spec.get("kind") not in KINDS:
        raise ValueError(f"{path}: unknown traffic kind {spec.get('kind')!r}")
    return spec


def probe_seed(seed, step):
    """The seed of training step ``step``'s probe generator."""
    return seeds.derive(seed, "probes", step)
