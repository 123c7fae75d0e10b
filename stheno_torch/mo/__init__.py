from .core import dimensionality, infer_size, num_elements

__all__ = ["dimensionality", "infer_size", "num_elements"]
