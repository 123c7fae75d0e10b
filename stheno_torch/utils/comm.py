"""Per-rank communication volume of the distributed paths.

Counterpart of ``stheno_tpu/utils/comm.py:collective_traffic``. The JAX
package reads the collectives that XLA emitted out of the compiled HLO and
counts loop trips from its call graph. The port issues every collective by
hand, in ``stheno_torch/parallel/_comm.py``, and that module records each
one here while a :func:`collective_traffic` context is open: its call site,
its kind, its operand bytes and its group size. Equal records are counted,
so a collective issued once per panel of a loop shows up as one
instruction with as many executions as the loop had panels.

Ring cost model (per rank, ``g`` = group size, ``s`` = operand bytes), as
in the JAX package's:

- ``all-gather``: ``(g-1)/g * s``, ``s`` the gathered output's bytes (the
  rank's own block is local);
- ``all-reduce``: ``2 (g-1)/g * s`` (reduce-scatter, then all-gather);
- ``all-to-all``: ``(g-1)/g * s``, ``s`` the rank's input bytes;
- ``reduce`` and ``broadcast`` (the JAX package has neither: XLA lowers
  its masked ``psum`` instead): ``(g-1)/g * s``, a pipelined chain in
  which every rank but one receives ``s`` once.

A collective that ``_comm.py`` copies through host memory (gloo on CUDA
tensors, where gloo has no CUDA form of it) is counted the same way: the
model counts what crosses between ranks, not the copies.
"""

import contextlib
import threading
from collections import Counter

__all__ = ["collective_traffic"]

KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all", "collective-permute",
         "reduce", "broadcast")

_RING_FACTOR = {"all-gather": 1.0, "all-reduce": 2.0, "all-to-all": 1.0, "reduce": 1.0,
                "broadcast": 1.0}

_lock = threading.Lock()
_open = []


def record(site, kind, nbytes, group_size):
    """Count one collective in every open :func:`collective_traffic`
    context. Called by ``parallel/_comm.py`` only."""
    with _lock:
        for counter in _open:
            counter[(site, kind, int(nbytes), int(group_size))] += 1


def _fold(counter):
    totals = {k: 0.0 for k in KINDS}
    instructions = []
    for (site, kind, nbytes, g), executions in counter.items():
        per_exec = _RING_FACTOR[kind] * (g - 1) / g * nbytes
        totals[kind] += per_exec * executions
        instructions.append((site, kind, per_exec, executions))
    totals["total"] = sum(totals[k] for k in KINDS)
    totals["instructions"] = instructions
    return totals


@contextlib.contextmanager
def collective_traffic():
    """Context manager: the collectives that this process issues inside
    it, as the JAX function's dict. It yields an empty dict and fills it
    on exit with per-kind byte totals, ``"total"`` (bytes per rank) and
    ``"instructions"``, a list of ``(site, kind, bytes_per_execution,
    executions)`` with ``site`` the ``file:line (function)`` that issued
    the collective (a backward pass's collective names the forward call
    that set it up). Contexts may nest; each counts what was issued while
    it was open, from any thread (backward passes on the card run on
    autograd's device thread)."""
    counter = Counter()
    traffic = {}
    with _lock:
        _open.append(counter)
    try:
        yield traffic
    finally:
        with _lock:
            _open.remove(counter)
        traffic.update(_fold(counter))
