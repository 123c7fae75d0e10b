"""What several metric readers share: the kernels' device names, a
kernel's roofline share per launch, the idle share and the traced units.

A reader that finds nothing to read returns ``None``, and the harness
leaves that metric out of the result line."""

from . import stats
from ..work import least_time, share

__all__ = ["KERNELS", "roofline_per_launch", "idle_share", "traced_units", "step_share",
           "window_rate"]

#: Device names of the port's kernels: ``(launches, every kernel of a
#: launch)``. A launch of K3 or of the fused Gram-gradient kernel may add a
#: reduction kernel, which is part of its time.
KERNELS = {
    "gram_matvec": ({"gmv_kernel", "gmv_mma_kernel", "gmv_dmma_kernel"},
                    {"gmv_kernel", "gmv_mma_kernel", "gmv_dmma_kernel", "gmv_split_v",
                     "gmv_reduce"}),
    "gram_matvec_vjp": ({"gmv_vjp_kernel", "gmv_vjp_dmma_kernel"},
                        {"gmv_vjp_kernel", "gmv_vjp_dmma_kernel", "gmv_vjp_reduce"}),
    "chol_tile": ({"finalize"}, {"factor_panel", "trailing", "finalize", "join_product"}),
}


def roofline_per_launch(run, kernel, work):
    """The least time of ``work`` (one launch's) over the kernel's device
    time per launch in the trace, in percent; ``None`` where the trace has
    no launch of it."""
    if run.trace is None:
        return None
    launches, names = KERNELS[kernel]
    count = run.trace.launches(launches)
    if count == 0:
        return None
    return share(work, run.trace.device_time(names) / count)


def idle_share(run):
    """The share of the traced window in which no operation ran on the
    device, in percent."""
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)


def traced_units(run):
    """Steps or calls' steps that the traced window holds."""
    return sum(r["n_units"] for r in run.records)


def step_share(run, work_per_unit):
    """The least time of the traced units' work over the traced window, in
    percent: the whole step's share of the chip's peak."""
    if run.trace is None or not run.records:
        return None
    return 100.0 * sum(least_time(work_per_unit(r)) for r in run.records) / run.trace.window_s


def window_rate(run, key):
    """Sum of ``key`` over the window's records per second of window."""
    return stats.rate(sum(r[key] for r in run.records), run.window_s)
