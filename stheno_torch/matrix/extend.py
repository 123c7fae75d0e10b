"""User extension registry for the structured-matrix algebra.

Counterpart of ``stheno_tpu/matrix/extend.py``. The core ops (``dense``,
``diag_of``, ``transpose``, ``scale``, ``add``, ``multiply``, ``matmul``,
``cholesky``, ``solve``, ``logdet``) consult :func:`dispatch_extension`
before their built-in chains, so a registered ``(predicate,
implementation)`` rule can both enable a new matrix type and specialise a
fast path. Later registrations win. A new type subclasses
:class:`~stheno_torch.matrix.types.AbstractMatrix`, defines ``shape`` and
``dtype``, and is registered with :func:`register_matrix_type` under the
JAX package's name. In torch that makes no pytree: it records which
attributes hold the type's tensors and which its static structure, and
gives the type a ``device`` (that of its first tensor) where it defines
none, so the code above the core ops (which places new tensors on a
matrix's ``device``) sees it as it sees the built-in types.
"""

import torch

__all__ = [
    "register_matrix_type",
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


def _first_tensor_device(self):
    for name in type(self)._leaf_names:
        leaf = getattr(self, name)
        if isinstance(leaf, torch.Tensor):
            return leaf.device
    raise TypeError(f"{type(self).__name__} holds no tensor to take a device from.")


def register_matrix_type(cls, leaf_names, aux_names=()):
    """Register a user :class:`AbstractMatrix` subclass.

    ``leaf_names``: the attributes holding its tensors; ``aux_names``: those
    holding static structure (shapes, flags), kept on the class as
    ``_leaf_names`` and ``_aux_names``. Where ``cls`` defines no ``device``,
    it gets the device of its first tensor leaf. Returns ``cls``;
    registering a class again replaces its names."""
    cls._leaf_names = tuple(leaf_names)
    cls._aux_names = tuple(aux_names)
    if not hasattr(cls, "device"):
        cls.device = property(_first_tensor_device)
    return cls


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
