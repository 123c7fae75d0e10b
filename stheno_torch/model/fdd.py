"""Finite-dimensional distributions.

Counterpart of ``stheno_tpu/model/fdd.py``. ``FDD(p, x, noise)`` is
process ``p`` at inputs ``x`` plus additive noise: a :class:`Normal`
whose mean/variance thunks are all lazy, with the fused
``var_diag``/``mean_var``/``mean_var_diag`` paths.
"""

import numpy as np
import torch

from .. import config
from ..dist import Normal
from ..kernels import elwise, mean_eval, mean_var, mean_var_diag, pairwise
from ..matrix import Dense, Diagonal, Zero, add, diag_of, fill_diag, is_structured, submatrix
from ..mo import infer_size
from ..utils.display import indented_kv

__all__ = ["FDD", "noise_as_matrix", "take"]


def noise_as_matrix(noise, dtype, n, device):
    """Promote noise to a structured matrix: ``None`` -> Zero, scalar ->
    scaled identity, vector -> Diagonal, matrix -> Dense. Raw (non-tensor)
    noise takes the inputs' dtype and device; a raw scalar is filled in on
    the device (no host copy, so a CUDA graph can capture it)."""
    if noise is None:
        return Zero(dtype, n, n, device=device)
    if is_structured(noise):
        return noise
    if not isinstance(noise, torch.Tensor):
        noise = (
            config.as_scalar(noise, dtype, device)
            if np.ndim(noise) == 0
            else torch.as_tensor(noise, dtype=dtype, device=device)
        )
    if noise.ndim == 0:
        return fill_diag(noise, n)
    if noise.ndim == 1:
        return Diagonal(noise)
    return Dense(noise)


def _input(x):
    """Place a raw input on the default device; tensors, tagged inputs and
    tuples of inputs (the multi-output form) pass through."""
    return x if isinstance(x, (FDD, tuple)) else config.as_tensor(x)


def _first_array(x):
    """The first array of an input, through tuples and tags: the source of
    its dtype and device."""
    if isinstance(x, tuple):
        return _first_array(x[0])
    if isinstance(x, FDD):
        return _first_array(x.x)
    return x


class FDD(Normal):
    """Finite-dimensional distribution of a process at inputs ``x``."""

    def __init__(self, p, x, noise=None):
        from .gp import GP

        self.p = p
        self.x = x = _input(x)
        if not isinstance(p, GP):
            # Input-tagging wrapper: `p` is a process id used in lazy rules.
            self.noise = None
            return

        kernel = p.kernel
        mean = p.mean
        like = _first_array(x)
        self.noise = noise_as_matrix(noise, like.dtype, infer_size(kernel, x), like.device)

        def construct_mean():
            return mean_eval(mean, x)

        def construct_var():
            return add(pairwise(kernel, x), self.noise)

        def construct_var_diag():
            return elwise(kernel, x) + diag_of(self.noise)[..., :, None]

        def construct_mean_var():
            m, v = mean_var(mean, kernel, x)
            return m, add(v, self.noise)

        def construct_mean_var_diag():
            m, vd = mean_var_diag(mean, kernel, x)
            return m, vd + diag_of(self.noise)[..., :, None]

        Normal.__init__(
            self,
            construct_mean,
            construct_var,
            var_diag=construct_var_diag,
            mean_var=construct_mean_var,
            mean_var_diag=construct_mean_var_diag,
        )

    def _render(self, fmt):
        return (
            "<FDD:\n"
            + indented_kv("process", fmt(self.p), suffix=",\n")
            + indented_kv("input", fmt(self.x), suffix=",\n")
            + indented_kv("noise", fmt(self.noise), suffix=">")
        )


def _take_x(kernel, x, mask):
    """Subset inputs by a boolean mask, recursing through tuples."""
    from ..mo import MultiOutputKernel

    if isinstance(x, tuple):
        i, taken = 0, ()
        for xi in x:
            n = infer_size(kernel, xi)
            taken += (_take_x(kernel, xi, mask[i:i + n]),)
            i += n
        return taken
    if isinstance(x, FDD):
        if isinstance(kernel, MultiOutputKernel) and x.p not in kernel.ps:
            raise ValueError(f"Process {x.p} is not part of the multi-output kernel.")
        return FDD(x.p, _take_x(kernel, x.x, mask), submatrix(x.noise, mask))
    idx = mask.nonzero().flatten().to(x.device)
    return x[..., idx] if x.ndim == 1 else x[..., idx, :]


def take(fdd: FDD, mask):
    """Subset an FDD (inputs and noise) by a boolean mask: the
    missing-data path."""
    mask = torch.as_tensor(mask).cpu()
    if mask.dtype != torch.bool:
        raise AssertionError(
            "Can only take from finite-dimensional distributions according to a mask."
        )
    return FDD(fdd.p, _take_x(fdd.p.kernel, fdd.x, mask), submatrix(fdd.noise, mask))
