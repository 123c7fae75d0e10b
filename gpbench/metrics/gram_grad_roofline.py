"""gram_grad_roofline: the fused Gram-gradient kernel (K3's backward,
``ops/gram_matvec_vjp.py``): the least time of one launch's work (the
surrogate gradient over the unordered pairs, ``work/gram.py``) over its
device time per launch (its reduction included), in percent. Device
trace."""

from gpbench.harness.readers import roofline_per_launch


def read(run):
    return roofline_per_launch(run, "gram_matvec_vjp", run.work.gram_grad_launch(run.config))
