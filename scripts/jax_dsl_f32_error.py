"""The JAX package's own float32 error on the modelling DSL's two large
runs, on the CPU: the numbers that set the tolerances of the 1024 x 1024
Kronecker gates of ``chip_smoke.py``'s phase ``dsl_path``, and that show
how far float32 holds the N=10^6 Bayesian linear regression (which that
phase holds to the main path's gates and to its information form).

    JAX_PLATFORMS=cpu python3 scripts/jax_dsl_f32_error.py [blr N ...] [predict N ...] [kron]

Each run builds its data as ``stheno_torch.entry`` does (in numpy: float64
cast to float32, or float32 directly where the entry point does), runs
``stheno_tpu`` in float32 and, on the same numbers cast up, in float64, and
prints one JSON line:

- ``blr N`` (default N = 10^6): example 6's Bayesian linear regression
  (``slope * x + intercept + sqrt(noise) GP(Delta())``, x on
  linspace(0, 10), y = 0.8x + 4 + 0.2 eps from ``RandomState(4)``,
  (log s_slope, log s_intercept, log noise) = (0, log 5, log 0.04)): the log
  marginal likelihood's relative error and its gradient's normwise
  relative error with respect to the three log-parameters. The variance
  is a rank-2 Woodbury, so this is cheap at N = 10^6.
- ``predict N`` (default N = 250,000, where the 1024-point cross Gram is
  2 GB in float64 and the run peaks at 8.4 GiB; at N = 10^6 the cross
  Gram alone takes 8 GB a copy):
  the posterior marginals of the slope and the intercept at one point and
  of ``f`` at 1024 points on linspace(0, 10). With ``K_x = D + L M L^T``
  (a Woodbury) and ``K`` the cross Gram, the mean is ``K^T K_x^{-1} y`` and
  the variance ``k_jj - K^T K_x^{-1} K``; the Woodbury identity forms
  each as the difference of a term ``K^T D^{-1} b`` and a correction of
  nearly its size, which cancel to a part in about N / noise: float32
  keeps no digit of the result at these N. So each is reported twice:
  ``*_rel``, the largest error over the largest float64 value (O(1) and
  more, in both packages), and ``*_scaled``, the largest error over the
  largest magnitude of those terms (``sum_i |K_ij| |y_i| / d_i`` for the
  mean, ``k_jj + sum_i K_ij^2 / d_i`` for the variance): the error
  against what float32 resolves in the difference, one that does not
  grow with N as the terms do.
- ``kron``: ``Normal(0, Kronecker(A + 0.1 I, B + 0.1 I)).logpdf(y)`` on
  ``bench.py``'s 1024 x 1024 grid (A, B the Grams of EQ().stretch(1) on
  linspace(0, 10) and linspace(0, 8), y from ``RandomState(1)``), unmasked
  and under the mask of ``entry.kronecker_inputs`` (10% of each axis
  dropped, from ``RandomState(2)``): the value's relative error and the
  gradient's normwise relative error with respect to (log ell1, log ell2).

Each line carries the process's peak resident memory so far.
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

import stheno_tpu.matrix as M  # noqa: E402
from stheno_tpu import EQ, GP, Delta, Measure, Normal, pairwise  # noqa: E402

BLR_LOG_PARAMS = (0.0, float(np.log(5.0)), float(np.log(0.04)))


def rel(a, b):
    a, b = np.atleast_1d(np.asarray(a, np.float64)), np.atleast_1d(np.asarray(b, np.float64))
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def peak_gib():
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20


def blr_data(n):
    x = np.linspace(0.0, 10.0, n)
    y = 0.8 * x + 4.0 + 0.2 * np.random.RandomState(4).randn(n)
    return x.astype(np.float32), y.astype(np.float32)


def blr_model(log_params):
    ls, lb, ln = log_params
    with Measure() as prior:
        slope = GP(jnp.exp(ls))
        intercept = GP(jnp.exp(lb))
        f = slope * (lambda z: z) + intercept
        y = f + jnp.exp(0.5 * ln) * GP(Delta())
    return prior, slope, intercept, f, y


def blr_value_and_grad(x, y, dtype):
    x, y = jnp.asarray(x, dtype), jnp.asarray(y, dtype)

    def lml(ls, lb, ln):
        prior, _, _, _, y_p = blr_model((ls, lb, ln))
        return prior.logpdf(y_p(x), y)

    args = [jnp.asarray(p, dtype) for p in BLR_LOG_PARAMS]
    v, g = jax.jit(jax.value_and_grad(lml, argnums=(0, 1, 2)))(*args)
    return float(v), np.asarray([float(t) for t in g])


def run_blr(n):
    x, y = blr_data(n)
    v32, g32 = blr_value_and_grad(x, y, jnp.float32)
    v64, g64 = blr_value_and_grad(x, y, jnp.float64)
    return {"run": "blr", "n": n, "value_f64": v64, "grad_f64": g64.tolist(),
            "value_rel": rel(v32, v64), "grad_rel": rel(g32, g64),
            "grad_rel_each": [rel(a, b) for a, b in zip(g32, g64)]}


def blr_predict(x, y, dtype):
    x, y = jnp.asarray(x, dtype), jnp.asarray(y, dtype)
    prior, slope, intercept, f, y_p = blr_model([jnp.asarray(p, dtype) for p in BLR_LOG_PARAMS])
    post = prior | (y_p(x), y)
    zero = jnp.zeros(1, dtype)
    x_new = jnp.linspace(0.0, 10.0, 1024, dtype=dtype)
    out = {}
    d = post.means[slope].K_z.diag.diag
    for name, p, xs in (("slope", slope, zero), ("intercept", intercept, zero), ("f", f, x_new)):
        mean, var = post(p)(xs).marginals()
        if dtype == jnp.float64:
            K = M.dense(pairwise(prior.kernels[y_p, p], x, xs))
            mean_scale = jnp.abs(K).T @ (jnp.abs(y) / d)
            var_scale = prior(p)(xs).marginals()[1] + (K * K).T @ (1 / d)
            del K
        else:
            mean_scale = var_scale = mean
        out[name] = [np.asarray(a, np.float64) for a in (mean, var, mean_scale, var_scale)]
    return out


def run_predict(n):
    x, y = blr_data(n)
    p32, p64 = blr_predict(x, y, jnp.float32), blr_predict(x, y, jnp.float64)
    out = {"run": "blr_predict", "n": n}
    for name in p64:
        (m32, v32, _, _), (m64, v64, ms64, vs64) = p32[name], p64[name]
        for q, a, b, scale in (("mean", m32, m64, ms64), ("var", v32, v64, vs64)):
            err = float(np.abs(a - b).max())
            # The float64 variance of the slope can round to 0 (clamped).
            out[f"{name}_{q}_rel"] = err / max(float(np.abs(b).max()), 1e-300)
            out[f"{name}_{q}_scaled"] = err / float(np.abs(scale).max())
            out[f"{name}_{q}_f64_max"] = float(np.abs(b).max())
            out[f"{name}_{q}_scale_max"] = float(np.abs(scale).max())
    return out


def kron_data(n1=1024, n2=1024, seed=1, drop=0.1):
    ax1 = np.linspace(0.0, 10.0, n1).astype(np.float32)
    ax2 = np.linspace(0.0, 8.0, n2).astype(np.float32)
    y = np.random.RandomState(seed).randn(n1 * n2).astype(np.float32)
    r = np.random.RandomState(seed + 1)
    masks = []
    for n in (n1, n2):
        m = np.ones(n, dtype=bool)
        m[r.choice(n, int(drop * n), replace=False)] = False
        masks.append(m)
    return ax1, ax2, y, tuple(masks)


def kron_value_and_grad(ax1, ax2, y, mask, dtype):
    ax1, ax2, y = (jnp.asarray(a, dtype) for a in (ax1, ax2, y))

    def lp(l1, l2):
        factors = [
            M.Dense(M.dense(pairwise(EQ().stretch(jnp.exp(l)), ax))
                    + 0.1 * jnp.eye(ax.shape[0], dtype=dtype))
            for l, ax in ((l1, ax1), (l2, ax2))
        ]
        m = None if mask is None else tuple(jnp.asarray(a) for a in mask)
        return Normal(M.Kronecker(*factors)).logpdf(y, mask=m)

    zero = jnp.zeros((), dtype)
    v, g = jax.jit(jax.value_and_grad(lp, argnums=(0, 1)))(zero, zero)
    return float(v), np.asarray([float(t) for t in g])


def run_kron():
    ax1, ax2, y, masks = kron_data()
    out = {"run": "kron", "shape": [len(ax1), len(ax2)]}
    for tag, mask in (("unmasked", None), ("masked", masks)):
        v32, g32 = kron_value_and_grad(ax1, ax2, y, mask, jnp.float32)
        v64, g64 = kron_value_and_grad(ax1, ax2, y, mask, jnp.float64)
        out[tag] = {"value_f64": v64, "grad_f64": g64.tolist(), "value_rel": rel(v32, v64),
                    "grad_rel": rel(g32, g64)}
    return out


def main(argv):
    runs, i = [], 0
    while i < len(argv):
        name, i = argv[i], i + 1
        ns = []
        while i < len(argv) and argv[i].isdigit():
            ns.append(int(argv[i]))
            i += 1
        runs.append((name, ns))
    if not runs:
        runs = [("blr", []), ("predict", []), ("kron", [])]
    for name, ns in runs:
        if name == "kron":
            outs = [run_kron()]
        elif name == "blr":
            outs = [run_blr(n) for n in ns or [1_000_000]]
        elif name == "predict":
            outs = [run_predict(n) for n in ns or [250_000]]
        else:
            raise SystemExit(f"unknown run {name!r}")
        for out in outs:
            out.update(platform=jax.devices()[0].platform, peak_rss_gib=peak_gib())
            print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
