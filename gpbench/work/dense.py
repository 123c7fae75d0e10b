"""Work counts of the dense exact GP (``configs/eq-n2000.json``).

- The training step (value and gradient of the NLML, then the optimiser's
  update): the Cholesky factor ``n^3 / 3`` flops, the triangular inverse
  ``n^3 / 3`` and the product ``K^-1 = L^-T L^-1`` that the trace term of
  the gradient needs, ``n^3 / 3``; all products. Beside them the
  symmetric Gram (its ``n (n + 1) / 2`` entries) and its backward (per
  pair ``Kbar_ij K_ij`` and ``Kbar_ij K_ij d^2``, three instructions).
  This replaces ``stheno_torch/utils/monitor.py:exact_gp_flops``'s
  ``n^3 / 3 + 1.5 n^3``: ``ops/trimul.py``'s triangular products execute
  fewer operations than that, so a share of it could read above 100%.
- K2 in the step: each base tile ``t`` of the Cholesky recursion (the
  split of ``stheno_torch/ops/chol.py``: halves rounded up to multiples of
  1024; at n = 2000, tiles of 1024 and 976) factored and inverted,
  ``2 t^3 / 3`` flops; its ``t^2`` floats read and two written.
"""

from . import Work
from . import gram

F32 = 4
_BASE = 1024


def tiles(n):
    """The base tiles of the Cholesky recursion of an ``n x n`` matrix."""
    if n <= _BASE:
        return [n]
    half = (n + 1) // 2
    m = ((half + _BASE - 1) // _BASE) * _BASE
    m = half if m >= n else m
    return tiles(m) + tiles(n - m)


def step(config):
    n = config["n"]
    pairs = n * (n + 1) / 2
    return (Work(products=n ** 3, bytes=F32 * (2 * n + n * n))
            + Work(ops=gram.ENTRY_OPS * pairs + 3 * pairs, exps=pairs))


def chol_tiles(config):
    """K2's work in one step: every base tile factored and inverted."""
    total = Work()
    for t in tiles(config["n"]):
        total = total + Work(products=2 * t ** 3 / 3, bytes=F32 * 3 * t * t)
    return total
