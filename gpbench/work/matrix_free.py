"""Work counts of the matrix-free exact GP (``configs/eq-mf262k.json``).

- The training step: the surrogate gradient's pass over the unordered
  pairs with its ``q = num_probes + 1`` columns, plus one pass of ``K V``
  over all pairs with the solve's ``q`` right-hand sides, the least that
  any solve of them makes (CG's iteration count is not used: a solver
  that needs fewer passes is better). The preconditioner's products are
  ``O(n r q)``, under 0.1% of these, and left out.
- One launch of K3 in the step: ``K V`` at ``(n, n, q)``, ``x is y``.
- One launch of the fused Gram-gradient kernel: the surrogate gradient.
"""

from . import gram



def _q(config):
    return config["num_probes"] + 1


def step(config):
    n, q = config["n"], _q(config)
    return gram.surrogate_grad(n, q) + gram.matvec(n, n, q, symmetric=True)


def gram_matvec_launch(config):
    n = config["n"]
    return gram.matvec(n, n, _q(config), symmetric=True)


def gram_grad_launch(config):
    return gram.surrogate_grad(config["n"], _q(config))
