"""idle_share.train: the share of the traced training window in which no
kernel, copy or set ran on the device (the union of their intervals),
in percent. Device trace."""

from gpbench.harness.readers import idle_share


def read(run):
    return idle_share(run)
