"""adam_steps_per_s: Adam steps completed over the whole window (host
clock; each call ends in a synchronise). A step is one value and gradient
of the objective and the optimiser's update, replayed as one captured
graph."""

from gpbench.harness.readers import window_rate


def read(run):
    return window_rate(run, "n_units")
