"""gram_matvec_roofline: K3 (``ops/gram_matvec.py``, any route) in the
training step: the least time of one launch's ``K V`` at the solve's
shape over its device time per launch (its split and reduction
included), in percent. Device trace."""

from gpbench.harness.readers import roofline_per_launch


def read(run):
    return roofline_per_launch(run, "gram_matvec", run.work.gram_matvec_launch(run.config))
