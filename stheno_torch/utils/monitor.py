"""Structured step metrics and profiling helpers.

Counterpart of ``stheno_tpu/utils/monitor.py``:

- :class:`StepMetrics`: per-step records of the objective, the gradient
  norm, the wall time and the achieved TFLOP rate, with a compact line
  printer;
- :func:`trace`: a context manager around ``torch.profiler`` that writes a
  Chrome trace into a directory;
- :func:`exact_gp_flops`: the FLOP model of an exact-GP NLML step (Gram,
  Cholesky, solves), the normaliser of the reported TFLOP/s.
"""

import contextlib
import os
import time

import torch
from torch.utils._pytree import tree_leaves

__all__ = ["StepMetrics", "trace", "exact_gp_flops"]


def exact_gp_flops(n, d=1, grad=True):
    """FLOPs of an exact-GP NLML step at ``n`` points: Gram (2n^2 d),
    Cholesky (n^3/3), triangular solves (2n^2); the gradient adds a
    triangular inversion and a product (n^3/2 + n^3). The count of the
    standard dense algorithms, a fixed normaliser: the structure-aware
    triangular products (``ops/trimul.py``) execute fewer operations."""
    fwd = 2 * n * n * d + n**3 / 3 + 2 * n * n
    if grad:
        fwd += n**3 / 2 + n**3  # L^{-1} by blocked solve + K^{-1} matmul.
    return fwd


class StepMetrics:
    """Accumulates per-step records; ``log`` returns (and optionally
    prints) a dict of step metrics."""

    def __init__(self, flops_per_step=None, print_every=0):
        self.flops_per_step = flops_per_step
        self.print_every = print_every
        self.records = []
        self._last = time.perf_counter()

    def log(self, step, objective, grads=None, **extra):
        """Record one step. ``grads`` is any pytree of tensors; its norm
        costs one host sync (one ``.item()`` of the stacked squared sums),
        whatever the number of leaves."""
        now = time.perf_counter()
        dt = now - self._last
        self._last = now
        rec = {"step": int(step), "objective": float(objective), "step_time_s": dt}
        if grads is not None:
            leaves = [torch.as_tensor(g) for g in tree_leaves(grads)]
            if leaves:
                sq = torch.stack([torch.sum(g.float() ** 2).to(leaves[0].device)
                                  for g in leaves]).sum()
                rec["grad_norm"] = sq.item() ** 0.5
            else:
                rec["grad_norm"] = 0.0
        if self.flops_per_step:
            rec["tflops_per_s"] = self.flops_per_step / dt / 1e12
        rec.update(extra)
        self.records.append(rec)
        if self.print_every and step % self.print_every == 0:
            print(
                "  ".join(
                    f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
                    for k, v in rec.items()
                )
            )
        return rec


@contextlib.contextmanager
def trace(log_dir):
    """Profile the enclosed block with ``torch.profiler`` (the host, and
    the card where there is one) and write its Chrome trace,
    ``trace.json``, into ``log_dir``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    try:
        with prof:
            try:
                yield
            finally:
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
    finally:
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
