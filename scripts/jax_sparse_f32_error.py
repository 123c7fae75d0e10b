"""The JAX package's own float32 error on the sparse (VFE) ELBO and its
gradient, on the CPU: the number that sets the tolerance of the N=10^6
gate of ``chip_smoke.py``'s phase ``sparse_path``.

    JAX_PLATFORMS=cpu python3 scripts/jax_sparse_f32_error.py [N ...]

For each N (default 2000 with M=100, then 62,500, 125,000 and 250,000
with M=512), the data of ``bench.py``: at M=100 ``bench_vfe_n2000``'s
(x, z on linspace(0, 10), y = sin x + 0.3 cos 3.2x), at M=512
``bench_dist_elbo_1m``'s (``RandomState(1)``, sorted uniform x on
[0, 10), y = sin x + 0.1 noise, z = linspace(0, 10, 512)), built in
float32. ``stheno_tpu``'s ``PseudoObs(f(z), (f(x, noise), y)).elbo`` with
``f = GP(EQ().stretch(ell))``, ell = 1, noise = 0.1, and its gradient with
respect to (log ell, log noise, z) run in float32 and, on the same
numbers cast up, in float64, both with the jitter that the adaptive probe
picks for the float32 inducing Gram (so the two runs factor the same
matrix and differ only by rounding); and the posterior marginals at 4096
points on linspace(0, 10) after pseudo-conditioning. Under that fixed
jitter the float32 posterior variance is NaN: the re-whitened subspace
matrix ``S = L_z A L_z^T`` (``obs.A``) is indefinite in float32. So the
variance is also taken as the port's sparse entry points take it, in
float32 under the adaptive jitter (each factorisation probes up from
float32's default, which gives the inducing Gram the same jitter), against
the float64 run with the fixed jitter; and, to part the jitter from the
rounding, against that float64 variance with ``S`` jittered as much as the
float32 probe jitters it. Prints one JSON line per N: the jitter, the
float64 values, the ELBO's relative error, each gradient component's, the
whole gradient's normwise relative error, the largest error of the
posterior mean and variance over the largest float64 value (``var_rel``
under the fixed jitter, ``var_rel_adaptive`` under the adaptive one,
``s_jitter`` the float32 probe's jitter of ``S``, ``var_rel_same_s_jitter``
against float64 with that jitter on ``S``), and the process's peak
resident memory so far.
"""

import json
import os
import resource
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from stheno_tpu import EQ, GP, PseudoObs, config, dense, pairwise  # noqa: E402
from stheno_tpu.matrix import adaptive_jitter_eps, iqf_diag  # noqa: E402


def inputs(n):
    """float32 numpy ``(x, y, z)`` as ``bench.py`` builds them."""
    if n == 2000:
        x = np.linspace(0.0, 10.0, n, dtype=np.float32)
        y = np.sin(x) + np.float32(0.3) * np.cos(np.float32(3.2) * x)
        return x, y.astype(np.float32), np.linspace(0.0, 10.0, 100, dtype=np.float32)
    r = np.random.RandomState(1)
    x = np.sort(r.rand(n).astype(np.float32)) * 10
    y = np.sin(x) + np.float32(0.1) * r.randn(n).astype(np.float32)
    return x, y.astype(np.float32), np.linspace(0.0, 10.0, 512, dtype=np.float32)


def value_and_grad(x, y, z, dtype):
    x, y, z = (jnp.asarray(a, dtype) for a in (x, y, z))

    def elbo(log_ell, log_noise, z):
        f = GP(EQ().stretch(jnp.exp(log_ell)))
        return PseudoObs(f(z), (f(x, jnp.exp(log_noise)), y)).elbo(f.measure)

    zero = jnp.zeros((), dtype)
    v, g = jax.jit(jax.value_and_grad(elbo, argnums=(0, 1, 2)))(
        zero, jnp.asarray(np.log(0.1), dtype), z)
    return float(v), np.concatenate([np.asarray(g[0], np.float64)[None],
                                     np.asarray(g[1], np.float64)[None],
                                     np.asarray(g[2], np.float64)])


def marginals(x, y, z, dtype):
    """The posterior marginals at 4096 points, and the observations' ``S``
    and the inducing-by-new Gram."""
    x, y, z = (jnp.asarray(a, dtype) for a in (x, y, z))
    f = GP(EQ())
    obs = PseudoObs(f(z), (f(x, jnp.asarray(0.1, dtype)), y))
    x_new = jnp.linspace(0.0, 10.0, 4096, dtype=dtype)
    out = [np.asarray(a, np.float64) for a in (f | obs)(x_new).marginals()]
    return out, dense(obs.A(f.measure)), dense(pairwise(EQ(), z, x_new))


def rel(a, b):
    return float(np.linalg.norm(np.atleast_1d(a - b)) / np.linalg.norm(np.atleast_1d(b)))


def main(ns):
    for n in ns:
        x, y, z = inputs(n)
        eps = float(adaptive_jitter_eps(dense(pairwise(EQ(), jnp.asarray(z))),
                                        config.jitter(jnp.float32)))
        config.set_epsilon(eps)
        v32, g32 = value_and_grad(x, y, z, jnp.float32)
        v64, g64 = value_and_grad(x, y, z, jnp.float64)
        (p32, _, _), (p64, s64, k64) = (marginals(x, y, z, jnp.float32),
                                        marginals(x, y, z, jnp.float64))
        # The float64 variance with S jittered by s_eps (the fixed jitter
        # adds eps to S; add the rest).
        config.set_adaptive_jitter(True)
        config.set_epsilon(None)
        (_, var_ad), s32, _ = marginals(x, y, z, jnp.float32)
        s_eps = float(adaptive_jitter_eps(s32, config.jitter(jnp.float32)))
        config.set_adaptive_jitter(False)
        config.set_epsilon(eps)
        eye = jnp.eye(s64.shape[0], dtype=s64.dtype)
        var_same = p64[1] + np.asarray(iqf_diag(s64 + (s_eps - eps) * eye, k64)
                                       - iqf_diag(s64, k64), np.float64)
        config.set_epsilon(None)
        err = lambda a, b: float(np.abs(a - b).max() / np.abs(b).max())  # noqa: E731
        pred = {f"{name}_rel": err(a, b) for name, a, b in zip(("mean", "var"), p32, p64)}
        pred.update(var_rel_adaptive=err(var_ad, p64[1]), s_jitter=s_eps,
                    var_rel_same_s_jitter=err(var_ad, var_same))
        print(json.dumps({
            "n": n, "m": len(z), "jitter": eps, "elbo_f64": v64, "elbo_rel": rel(v32, v64),
            "grad_f64": {"log_ell": g64[0], "log_noise": g64[1],
                         "z_norm": float(np.linalg.norm(g64[2:]))},
            "grad_log_ell_rel": rel(g32[0], g64[0]), "grad_log_noise_rel": rel(g32[1], g64[1]),
            "grad_z_rel": rel(g32[2:], g64[2:]), "grad_rel": rel(g32, g64), **pred,
            "platform": jax.devices()[0].platform,
            "peak_rss_gib": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20,
        }), flush=True)


if __name__ == "__main__":
    main([int(a) for a in sys.argv[1:]] or [2000, 62_500, 125_000, 250_000])
