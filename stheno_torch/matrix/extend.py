"""User extension registry for the structured-matrix algebra.

Counterpart of ``stheno_tpu/matrix/extend.py``. The core ops (``dense``,
``diag_of``, ``transpose``, ``scale``, ``add``, ``multiply``, ``matmul``,
``cholesky``, ``solve``, ``logdet``) consult :func:`dispatch_extension`
before their built-in chains, so a registered ``(predicate,
implementation)`` rule can both enable a new matrix type and specialise a
fast path. Later registrations win. A new type subclasses
:class:`~stheno_torch.matrix.types.AbstractMatrix` and defines ``shape``,
``dtype`` and ``device``; unlike the JAX package it needs no pytree
registration (the JAX package's ``register_matrix_type`` has no
counterpart).
"""

__all__ = [
    "register_rule",
    "extension_rule",
    "dispatch_extension",
    "clear_rules",
]

# op name -> list of (predicate, impl), most recent first.
_RULES = {}

EXTENDABLE_OPS = (
    "dense",
    "diag_of",
    "transpose",
    "scale",
    "add",
    "multiply",
    "matmul",
    "cholesky",
    "solve",
    "logdet",
)


def register_rule(op, predicate, impl=None):
    """Register ``impl(*args, **kwargs)`` for ``op`` whenever
    ``predicate(*operands)`` holds. Usable as a decorator (``impl=None``)."""
    if op not in EXTENDABLE_OPS:
        raise ValueError(f"Op {op!r} is not extendable; choose from {EXTENDABLE_OPS}.")
    if impl is None:
        return lambda f: register_rule(op, predicate, f)
    _RULES.setdefault(op, []).insert(0, (predicate, impl))
    return impl


def extension_rule(op, predicate):
    """Decorator form: ``@extension_rule("add", lambda a, b: ...)``."""
    return register_rule(op, predicate)


def dispatch_extension(op, *args, **kwargs):
    """Try user rules for ``op``; ``NotImplemented`` when none matches."""
    for predicate, impl in _RULES.get(op, ()):
        if predicate(*args):
            return impl(*args, **kwargs)
    return NotImplemented


def clear_rules(op=None):
    """Remove registered rules (all ops, or one op)."""
    if op is None:
        _RULES.clear()
    else:
        _RULES.pop(op, None)
