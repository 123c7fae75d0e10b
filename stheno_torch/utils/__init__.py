"""Training utilities: checkpoints, resumable optimisation with rollback,
step metrics and rendering. Counterpart of ``stheno_tpu/utils``; its
``collective_traffic`` (``comm.py``) comes with the distributed paths
(``ROADMAP.md``, item 12)."""

from .checkpoint import load_pytree, load_vars, save_pytree, save_vars
from .monitor import StepMetrics, exact_gp_flops, trace
from .resilience import resumable_minimise

__all__ = [
    "resumable_minimise",
    "save_pytree",
    "load_pytree",
    "save_vars",
    "load_vars",
    "StepMetrics",
    "exact_gp_flops",
    "trace",
]
