"""cg_iters_per_step: the forward solve's CG iterations per training step,
as ``iterative_nlml(..., return_info=True)`` returns them, averaged over
the traced steps. A count: it repeats for the same seed."""


def read(run):
    iters = [r["cg_iters"] for r in run.records if "cg_iters" in r]
    return sum(iters) / len(iters) if iters else None
