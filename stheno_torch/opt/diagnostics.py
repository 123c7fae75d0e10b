"""MCMC convergence diagnostics: split-R-hat and effective sample size.

Host-side (NumPy) post-processing of chain outputs from
:func:`stheno_torch.opt.sample_hmc` / :func:`sample_nuts` — the standard
Stan/Vehtari et al. (2021, "Rank-normalization, folding, and localization:
An improved R-hat") formulations of the classic diagnostics:

- :func:`potential_scale_reduction` — split-chain R-hat: each chain is
  halved so within-chain non-stationarity shows up as between-chain
  variance; values near 1 indicate mixing (common gate: < 1.01 strict,
  < 1.1 loose).
- :func:`effective_sample_size` — multi-chain ESS with the mean
  cross-chain autocovariance and Geyer's initial-monotone-sequence
  truncation.

The port's own copy of ``stheno_tpu/opt/diagnostics.py`` (numpy only), so
that it imports nothing of the JAX package. Tensors are taken too: they are
copied to the host first.
"""

import numpy as np

__all__ = ["potential_scale_reduction", "effective_sample_size"]


def _as_chains(x):
    """Normalise to ``(chains, samples)`` float64."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    x = np.asarray(x, dtype=np.float64)
    if x.ndim == 1:
        x = x[None, :]
    if x.ndim != 2:
        raise ValueError(
            f"Expected (chains, samples) or (samples,); got shape {x.shape}."
        )
    return x


def potential_scale_reduction(x):
    """Split-chain R-hat of scalar chain draws ``x (chains, samples)``."""
    x = _as_chains(x)
    c, n = x.shape
    half = n // 2
    if half < 2:
        raise ValueError("Need at least 4 draws per chain for split R-hat.")
    x = x[:, : 2 * half].reshape(2 * c, half)
    chain_means = x.mean(axis=1)
    W = x.var(axis=1, ddof=1).mean()
    B = half * chain_means.var(ddof=1)
    var_plus = (half - 1) / half * W + B / half
    if W == 0:
        # Zero within-chain variance: chains stuck at different values is
        # the WORST case (R-hat -> inf), not perfect mixing; all chains
        # stuck at the same constant is undiagnosable (NaN — any
        # ``rhat < gate`` check then fails loudly rather than passing).
        return float("inf") if B > 0 else float("nan")
    return float(np.sqrt(var_plus / W))


def effective_sample_size(x):
    """Multi-chain ESS of scalar chain draws ``x (chains, samples)``
    (Geyer initial monotone sequence on the mean autocovariance)."""
    x = _as_chains(x)
    c, n = x.shape
    if n < 4:
        raise ValueError("Need at least 4 draws per chain for ESS.")
    chain_means = x.mean(axis=1, keepdims=True)
    centered = x - chain_means
    # Per-chain autocovariances via FFT, biased (divide by n) as in Stan.
    m = 1
    while m < 2 * n:
        m *= 2
    f = np.fft.rfft(centered, m, axis=1)
    acov = np.fft.irfft(f * np.conj(f), m, axis=1)[:, :n].real / n
    mean_acov = acov.mean(axis=0)  # (n,)
    W = x.var(axis=1, ddof=1).mean()
    B = n * x.mean(axis=1).var(ddof=1) if c > 1 else 0.0
    var_plus = (n - 1) / n * W + (B / n if c > 1 else mean_acov[0] / n)
    if var_plus == 0:
        return float(c * n)
    # rho_t = 1 - (W - mean_acov_t) / var_plus.
    rho = 1.0 - (W - mean_acov) / var_plus
    rho[0] = 1.0
    # Geyer initial positive + monotone sequence on the EVEN-ODD pairs
    # P_k = rho_{2k} + rho_{2k+1} (so P_0 = 1 + rho_1 >= 0 always):
    # sum pairs while positive with non-increasing enforcement, then
    # tau = -1 + 2 sum_k P_k. The off-by-one pairing (rho_1 + rho_2, ...)
    # breaks Geyer's positivity guarantee — an oscillating chain's first
    # pair can be negative, truncating at tau = 0 and overestimating ESS
    # ~2x.
    pair_sum = 0.0
    prev_pair = np.inf
    t = 0
    while t + 1 < n:
        pair = rho[t] + rho[t + 1]
        if pair < 0:
            break
        pair = min(pair, prev_pair)
        pair_sum += pair
        prev_pair = pair
        t += 2
    tau = max(-1.0 + 2.0 * pair_sum, 1.0 / (c * n))
    ess = c * n / tau
    return float(min(ess, c * n))
