"""stheno_torch: the PyTorch/CUDA port of stheno_tpu for the NVIDIA H100.

The same ``Measure``/``GP`` algebra over structured matrices as
``stheno_tpu``, in PyTorch: plain torch on tensors,
``torch.autograd.Function`` where the JAX package has a ``custom_vjp``,
and hand-written CUDA kernels (``ops/csrc``) where it has Pallas kernels.
Entry points run on the card unless the CPU is asked for
(``config.set_default_device("cpu")``). Ported so far: the exact-GP
training-and-prediction step, the matrix-free (iterative) exact-GP path
of ``stheno_torch.iterative``, the optimisers and samplers of
``stheno_torch.opt`` (Adam captured in a CUDA graph on the card, L-BFGS,
HMC, NUTS and their diagnostics), the pseudo-point path (VFE, FITC and
DTC with their ELBO and posterior, several observed processes through
``combine`` and the cross process, sampling), and the rest of the
modelling DSL (input transforms and derivatives of processes, Delta and
the other kernels and means, ``Normal``'s divergences and affine
arithmetic, the Woodbury and Kronecker closed forms), and stochastic
variational GPs (SVGP), random-feature maps and pathwise posterior draws,
the structured-grid, Kronecker and compensated iterative paths, the
training utilities of ``stheno_torch.utils`` (checkpoints, resumable
optimisation with rollback, step metrics), the LAB-compatible ``B``
namespace and the ``stheno_torch.torch`` import shim; ``ROADMAP.md`` lists
what is still to be ported.
"""

from . import config
from .matrix import *  # noqa: F401,F403
from .kernels import *  # noqa: F401,F403
from .dist import *  # noqa: F401,F403
from .lazy import LazyMatrix, LazyVector
from .mo import *  # noqa: F401,F403
from .model import *  # noqa: F401,F403
from . import opt
from .b import B  # noqa: F401  (LAB-compatible op namespace)


class BreakingChangeWarning(UserWarning):
    """A breaking change."""


__version__ = "0.1.0"

import sys as _sys

__all__ = [
    n for n in dir(_sys.modules[__name__])
    if not n.startswith("_") and n not in ("config",)
] + ["config"]
