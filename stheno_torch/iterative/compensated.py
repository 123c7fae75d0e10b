"""The small-noise policy of the two-float compensated matvec.

Counterpart of the host-side policy in
``stheno_tpu/iterative/compensated.py`` (``AUTO_WALL_FACTOR``,
``plain_noise_wall``, ``resolve_compensated``). The two-float arithmetic
itself is not ported yet (``ROADMAP.md``): wherever the policy resolves to
``True``, the port raises ``NotImplementedError`` and never runs the plain
path instead.

In torch every call is eager, so ``"auto"`` always decides by value (the
JAX package decides by value only when called eagerly; under ``jax.jit``
its decision is undecidable and comes out ``False``).
"""

import math

import torch

__all__ = ["AUTO_WALL_FACTOR", "plain_noise_wall", "resolve_compensated"]

#: ``"auto"`` switches to the compensated matvec below this fraction of
#: the plain noise wall ``||K|| * eps * sqrt(n)`` (the JAX package's
#: constant: the formula's coherent worst case overstates the practical
#: boundary).
AUTO_WALL_FACTOR = 1.0 / 64.0


def plain_noise_wall(lam_max, n, dtype):
    """The plain noise validity floor ``||K|| * eps * sqrt(n)``, with
    ``lam_max`` (e.g. the top Ritz value of an eig-preconditioner state)
    standing in for ``||K||``."""
    return float(lam_max) * math.sqrt(float(n)) * float(torch.finfo(dtype).eps)


def resolve_compensated(compensated, noise, lam, n, dtype, have_comp_mv):
    """Resolve a ``compensated`` policy (``"auto"`` | ``True`` | ``False``)
    to a bool. ``"auto"`` is ``True`` when ``noise < AUTO_WALL_FACTOR *
    plain_noise_wall(max(lam), n, dtype)``. Explicit ``True`` without a
    compensated matvec on the path raises ``ValueError``."""
    if compensated is True:
        if not have_comp_mv:
            raise ValueError(
                "compensated=True but no compensated matvec is available on this path."
            )
        return True
    if compensated in (False, None):
        return False
    if compensated != "auto":
        raise ValueError(f"compensated must be 'auto', True or False, got {compensated!r}")
    if not have_comp_mv:
        return False
    lam = torch.as_tensor(lam).detach()
    lam_max = torch.max(lam) if lam.numel() else 0.0
    noise = float(torch.as_tensor(noise).detach())
    return noise < AUTO_WALL_FACTOR * plain_noise_wall(lam_max, n, dtype)
