"""step_mfu.adam: the whole Adam step's share of the chip's peak: the least
time of a step's necessary work (``work/<path>.py:step``) times the traced
steps, over the traced window, in percent. Device trace."""

from gpbench.harness.readers import step_share


def read(run):
    work = run.work.step(run.config)
    return step_share(run, lambda r: work * r["n_units"])
