"""Input-handling helpers shared by kernels and means."""

from .. import config

__all__ = ["uprank", "num_elements_arr", "as_fn_output"]


def uprank(x, rank=2):
    """Promote an input/output array to at least ``rank`` dims, mirroring the
    reference's ``B.uprank``: scalars -> (1, 1), vectors (n,) -> (n, 1)."""
    x = config.as_tensor(x)
    while x.ndim < rank:
        x = x[None] if x.ndim == 0 else x[..., None]
    return x


def num_elements_arr(x):
    """Number of input points in an array input (the size of the -2 axis after
    upranking)."""
    shape = getattr(x, "shape", None)
    if shape is None:
        shape = config.as_tensor(x).shape
    if len(shape) == 0:
        return 1
    if len(shape) == 1:
        return shape[0]
    return shape[-2]


def as_fn_output(y, n):
    """Normalise a user function's output to a column ``(..., n, 1)``.

    Accepted shapes: scalar (broadcast over the n points), ``(..., n)``, or
    ``(..., n, 1)``."""
    y = config.as_tensor(y)
    if y.ndim == 0:
        return y.expand(n, 1)
    if y.ndim >= 2 and y.shape[-1] == 1 and y.shape[-2] == n:
        return y
    if y.shape[-1] == n:
        return y[..., None]
    raise ValueError(f"Cannot interpret function output of shape {tuple(y.shape)}.")
