"""chol_tile_roofline: K2 (``ops/chol_tile.py``) in the training step: the
least time of factoring and inverting the step's base tiles
(``work/dense.py:chol_tiles``) over K2's device time per step (all its
kernels), in percent. Device trace."""

from gpbench.harness.readers import KERNELS, traced_units
from gpbench.work import share


def read(run):
    if run.trace is None:
        return None
    seconds = run.trace.device_time(KERNELS["chol_tile"][1])
    steps = traced_units(run)
    if seconds <= 0 or steps == 0:
        return None
    return share(run.work.chol_tiles(run.config), seconds / steps)
