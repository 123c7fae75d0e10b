"""Import shim mirroring the reference's backend modules (``from
stheno.torch import GP, EQ``): counterpart of ``stheno_tpu/jax.py``. The
port is PyTorch-native, so the shim re-exports the package.

Inside the package every import is absolute, so this module never hides
the real ``torch`` from the package's own modules; only a ``sys.path``
entry pointing into ``stheno_torch/`` itself would."""

from stheno_torch import *  # noqa: F401,F403
from stheno_torch import __all__  # noqa: F401
