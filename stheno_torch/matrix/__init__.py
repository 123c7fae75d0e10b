from .types import (
    AbstractMatrix,
    Constant,
    Dense,
    Diagonal,
    Kronecker,
    LowRank,
    LowerTriangular,
    UpperTriangular,
    Woodbury,
    Zero,
    is_structured,
)
from .extend import (
    clear_rules,
    dispatch_extension,
    extension_rule,
    register_matrix_type,
    register_rule,
)
from .ops import *  # noqa: F401,F403
from .ops import __all__ as _ops_all

__all__ = [
    "AbstractMatrix",
    "Constant",
    "Dense",
    "Diagonal",
    "Kronecker",
    "LowRank",
    "LowerTriangular",
    "UpperTriangular",
    "Woodbury",
    "Zero",
    "is_structured",
    "register_matrix_type",
    "register_rule",
    "extension_rule",
    "dispatch_extension",
    "clear_rules",
] + list(_ops_all)
