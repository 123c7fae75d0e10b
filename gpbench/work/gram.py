"""Work of the EQ kernel's Gram passes, from their shapes.

An EQ entry ``s2 exp(-(x_i - y_j)^2 / (2 ell^2))`` at D = 1 costs three
FP32 instructions (the difference, then ``(d c) d`` with ``c = -log2(e) /
(2 ell^2)``, two multiplies) and one exp; ``s2`` folds into the other
operand. Where ``x is y`` the Gram is symmetric: one entry serves the
unordered pair, so entries are counted over the ``n (n + 1) / 2`` pairs,
while the products stay those of all ``n^2`` ordered pairs (each row needs
its own sum).
"""

from . import Work

ENTRY_OPS = 3
F32 = 4


def entries(n, m, symmetric):
    return n * (n + 1) / 2 if symmetric else n * m


def matvec(n, m, p, symmetric=False):
    """``K(x, y) V`` for ``x (n,)``, ``y (m,)``, ``V (m, p)``: the Gram's
    entries and ``2 n m p`` flops of products; ``x``, ``y`` and ``V`` read,
    ``K V`` written."""
    e = entries(n, m, symmetric)
    return Work(products=2 * n * m * p, ops=ENTRY_OPS * e, exps=e,
                bytes=F32 * (n + m + m * p + n * p))


def surrogate_grad(n, q):
    """The value and the hyperparameter gradient of the Hutchinson surrogate
    ``S = sum_ij K_ij c_ij`` with ``c_ij = A_i . V_j``, ``A``, ``V`` of
    ``q`` columns, ``x is y``: per unordered pair ``c_ij + c_ji`` (a
    ``2q``-wide dot of ``[A_i, V_i]`` and ``[V_j, A_j]``, ``4q`` flops of
    products), then ``K s`` (1), its sum into ``S`` (1) and into ``sum K s
    d^2`` for d/d log ell (1), beside the entry (3) and its exp; ``x``,
    ``A``, ``V`` read. d/d log s2 is ``S`` itself, and no gradient of
    ``x`` is needed."""
    pairs = n * (n + 1) / 2
    return Work(products=4 * q * pairs, ops=(ENTRY_OPS + 3) * pairs, exps=pairs,
                bytes=F32 * (n + 2 * n * q))
