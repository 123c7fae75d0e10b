from .core import (
    AmbiguousDimensionalityKernel,
    MultiOutputKernel,
    MultiOutputMean,
    dimensionality,
    infer_size,
    num_elements,
)

__all__ = [
    "AmbiguousDimensionalityKernel",
    "MultiOutputKernel",
    "MultiOutputMean",
    "dimensionality",
    "infer_size",
    "num_elements",
]
