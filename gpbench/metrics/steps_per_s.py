"""steps_per_s: training steps completed over the whole window (host
clock; the window ends in a synchronise). A step is one value and
gradient of the objective, with the optimiser's update where the traffic
has one."""

from gpbench.harness.readers import window_rate


def read(run):
    return window_rate(run, "n_units")
