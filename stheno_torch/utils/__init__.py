"""Training utilities: checkpoints, resumable optimisation with rollback,
step metrics and rendering, and the distributed paths' communication
volume (``comm.py``). Counterpart of ``stheno_tpu/utils``."""

from .checkpoint import load_pytree, load_vars, save_pytree, save_vars
from .comm import collective_traffic
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
    "collective_traffic",
]
