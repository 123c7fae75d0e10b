"""Random-feature expansions of kernel expressions.

Counterpart of ``stheno_tpu/kernels/features.py``: a finite feature map
``phi`` with ``phi(x) @ phi(y).T ~= k(x, y)`` for

- the stationary family by random Fourier features: EQ (Gaussian
  spectrum), Matern-1/2, 3/2 and 5/2 (multivariate-t spectra with 2 nu
  degrees of freedom), RQ (a Gamma scale mixture of EQ), closed under
  scaling, symmetric stretch and shift and products (the frequencies of
  the factors add);
- exact finite features for ``Linear`` (the input itself), ``OneKernel``
  and ``ZeroKernel``;
- sums (the features side by side) and symmetric input warps
  (``periodic``, ``select``, ``transform``) by recursion on the warped
  space.

The paired cos/sin construction is used: ``m`` frequency rows give ``2 m``
features. Frequencies are drawn from a ``torch.Generator`` where the JAX
package splits a key. Drawing is kept apart from building (``_plan``
returns both halves), so the same frequencies can be handed to either.
"""

import torch

from .. import config
from .kernel import (
    EQ,
    Kernel,
    Linear,
    Matern12,
    Matern32,
    Matern52,
    OneKernel,
    ProductKernel,
    RQ,
    ScaledKernel,
    ShiftedKernel,
    StretchedKernel,
    SumKernel,
    ZeroKernel,
    _InputWrappedKernel,
)

__all__ = ["feature_map"]


def _randn(gen, shape, dtype):
    return torch.randn(shape, generator=gen, dtype=dtype, device=gen.device)


def _gamma(gen, shape_param, size, dtype):
    """Gamma(``shape_param``, rate 1) draws of shape ``size``."""
    conc = torch.full(size, float(shape_param), dtype=dtype, device=gen.device)
    return torch._standard_gamma(conc, generator=gen)


def _matern_sampler(dof):
    def sample(gen, m, d, dtype):
        z = _randn(gen, (m, d), dtype)
        # A chi-square with dof degrees of freedom is 2 Gamma(dof / 2).
        u = 2 * _gamma(gen, dof / 2, (m, 1), dtype)
        return z * torch.sqrt(dof / torch.clamp_min(u, 1e-30))

    return sample


def _freq_sampler(k):
    """Spectral-measure sampler for stationary kernels, or ``None``.

    Returns ``(sampler(gen, m, d, dtype) -> (m, d) frequencies,
    amplitude)`` such that ``k(x, y) = amplitude * E[cos(w^T (x - y))]``."""
    if isinstance(k, EQ):
        return (lambda gen, m, d, dtype: _randn(gen, (m, d), dtype)), 1.0
    if isinstance(k, Matern12):
        return _matern_sampler(1.0), 1.0
    if isinstance(k, Matern32):
        return _matern_sampler(3.0), 1.0
    if isinstance(k, Matern52):
        return _matern_sampler(5.0), 1.0
    if isinstance(k, RQ):
        alpha = k.alpha

        def sample_rq(gen, m, d, dtype):
            z = _randn(gen, (m, d), dtype)
            # RQ(r) = E_{g ~ Gamma(alpha, rate=alpha)} [exp(-g r^2 / 2)]:
            # given g the kernel is EQ with inverse length sqrt(g).
            g = _gamma(gen, alpha, (m, 1), dtype) / alpha
            return z * torch.sqrt(g)

        return sample_rq, 1.0
    if isinstance(k, ScaledKernel):
        inner = _freq_sampler(k.k)
        if inner is None:
            return None
        sampler, amp = inner
        return sampler, amp * k.scale
    if isinstance(k, StretchedKernel) and k._sym:
        inner = _freq_sampler(k.k)
        if inner is None:
            return None
        sampler, amp = inner
        s = k.s1
        return (
            lambda gen, m, d, dtype: sampler(gen, m, d, dtype)
            / torch.as_tensor(s, dtype=dtype, device=gen.device)
        ), amp
    if isinstance(k, ShiftedKernel) and k._sym:
        # A shared shift cancels in x - y.
        return _freq_sampler(k.k)
    if isinstance(k, ProductKernel):
        left, right = _freq_sampler(k.k1), _freq_sampler(k.k2)
        if left is None or right is None:
            return None
        (s1, a1), (s2, a2) = left, right

        # Spectra convolve under kernel products: add the frequencies.
        def sample_prod(gen, m, d, dtype):
            return s1(gen, m, d, dtype) + s2(gen, m, d, dtype)

        return sample_prod, a1 * a2
    return None


def _warped_dim(k, d, dtype, device):
    return k._warp(torch.zeros((1, d), dtype=dtype, device=device), 1).shape[-1]


def _constant_features(n_feat, dtype, fill):
    return lambda x: torch.full(x.shape[:-1] + (n_feat,), fill, dtype=dtype, device=x.device)


def _plan(k, d, budget, dtype, device):
    """``(n_features, draw, build)`` for kernel expression ``k`` on
    ``d``-dimensional inputs, spending about ``budget`` features:
    ``draw(gen)`` draws what the map needs (the frequencies of each spectral
    block, nested as the expression nests its sums; ``None`` for an exact
    block) and ``build(draws) -> phi`` makes the map from them."""
    if isinstance(k, ZeroKernel):
        return 0, lambda gen: None, lambda draws: _constant_features(0, dtype, 0.0)
    if isinstance(k, OneKernel):
        return 1, lambda gen: None, lambda draws: _constant_features(1, dtype, 1.0)
    if isinstance(k, Linear):
        return d, lambda gen: None, lambda draws: (lambda x: x.to(dtype))
    if isinstance(k, SumKernel):
        n1, draw1, build1 = _plan(k.k1, d, max(2, budget // 2), dtype, device)
        n2, draw2, build2 = _plan(k.k2, d, max(2, budget // 2), dtype, device)

        def build_sum(draws):
            p1, p2 = build1(draws[0]), build2(draws[1])
            return lambda x: torch.cat([p1(x), p2(x)], dim=-1)

        return n1 + n2, lambda gen: (draw1(gen), draw2(gen)), build_sum
    spectral = _freq_sampler(k)
    if spectral is None and isinstance(k, ScaledKernel):
        # A non-spectral inner kernel (e.g. a scaled Linear): scale its features.
        n, draw, build = _plan(k.k, d, budget, dtype, device)
        scale = k.scale

        def build_scaled(draws):
            p = build(draws)
            root = torch.sqrt(torch.as_tensor(scale, dtype=dtype, device=device))
            return lambda x: p(x) * root

        return n, draw, build_scaled
    if spectral is not None:
        sampler, amp = spectral
        m = max(1, budget // 2)

        def build_rff(freqs):
            coeff = torch.sqrt(torch.as_tensor(amp, dtype=dtype, device=device) / m)

            def phi(x):
                proj = x.to(dtype) @ freqs.T  # (n, m)
                return coeff * torch.cat([torch.cos(proj), torch.sin(proj)], dim=-1)

            return phi

        return 2 * m, lambda gen: sampler(gen, m, d, dtype), build_rff
    if isinstance(k, _InputWrappedKernel) and k._sym:
        # A symmetric warp: k(x, y) = k_base(warp(x), warp(y)), so recurse
        # on the warped space (periodic: the torus embedding; select: a
        # subset; transform: f(x)).
        n, draw, build = _plan(k.k, _warped_dim(k, d, dtype, device), budget, dtype, device)

        def build_warp(draws):
            p = build(draws)
            return lambda x: p(k._warp(x, 1))

        return n, draw, build_warp
    raise ValueError(
        f"No random-feature expansion for kernel expression {k!r}. "
        "Supported: EQ/Matern/RQ (+ scale/stretch/shift/product), sums, "
        "Linear, constants, and symmetric input warps thereof."
    )


def _checked_plan(k, num_features, d, dtype, device):
    if not isinstance(k, Kernel):
        raise TypeError(f"Expected a kernel expression, got {type(k)}.")
    return _plan(k, int(d), int(num_features), dtype, device)


def _feature_map_from_draws(k, draws, num_features, d, dtype, device):
    """``(phi, n_features)`` of :func:`feature_map` from given draws (the
    nesting of ``_plan``'s ``draw``)."""
    n_feat, _, build = _checked_plan(k, num_features, d, dtype, device)
    # phi's products run when the caller calls it, outside this function:
    # pin them there.
    return config.pin_matmul_precision(build(draws)), n_feat


@config.pin_matmul_precision
def feature_map(k, generator, num_features, d, dtype=None):
    """Build a random feature map for kernel expression ``k``.

    Args:
        k: kernel expression.
        generator: ``torch.Generator`` for the frequencies; the map lives on
            its device.
        num_features: approximate feature budget (a spectral block uses
            ``2 * (budget // 2)`` features; exact blocks use what they need).
        d: input dimensionality.
        dtype: feature dtype (default: torch's default dtype).

    Returns:
        ``(phi, n_features)``: ``phi`` maps ``(..., n, d)`` tensors to
        ``(..., n, n_features)`` and ``phi(x) @ phi(y).T ~= k(x, y)``.
    """
    dtype = torch.get_default_dtype() if dtype is None else dtype
    n_feat, draw, build = _checked_plan(k, num_features, d, dtype, generator.device)
    return config.pin_matmul_precision(build(draw(generator))), n_feat
