"""The JAX package's own float32 error on the pathwise draws and on SVGP,
on the CPU: the numbers that set the tolerances of ``chip_smoke.py``'s
phase ``item8_path`` (``JAX_F32_ITEM8``).

    JAX_PLATFORMS=cpu python3 scripts/jax_item8_f32_error.py [pathwise N] [svgp N ...]

Without arguments: ``pathwise 262144 svgp 125000 250000``.

``pathwise N``: ``bench.py:bench_pathwise_262k``'s data at N (``RandomState(0)``,
sorted uniform x on [0, 10], y = sin x + 0.1 noise, float32) and its
build (EQ, noise 0.1, 8 draws, 2048 features, the whitened CG at tol
1e-4, at most 200 iterations, preconditioner rank 64), run in float32
and in float64 from the same draws: the frequencies, ``w`` and ``eps``
that ``stheno_tpu.pathwise_sampler`` draws in float32 from
``PRNGKey(0)``, cast up for the float64 run. The build is
``pathwise_sampler``'s own steps on ``stheno_tpu``'s ``kernel_matvec``
and ``make_whitened_solver``; at N=2000 the float32 run is first held to
``pathwise_sampler`` itself. It reports the largest error of the draws at
``bench.py``'s 4096 evaluation points (linspace(-1, 11)) over the largest
float64 draw, and each run's CG iterations and residual.

``svgp N ...``: ``bench_dist_elbo_1m``'s data (``RandomState(1)``,
sorted uniform x on [0, 10), y = sin x + 0.1 noise, z = linspace(0, 10,
512)), the kernel ``exp(log_s2) EQ().stretch(exp(log_ell))`` at 0, 0 and
noise 0.1, with the jitter that the adaptive probe picks for the float32
inducing Gram in both dtypes. First the minibatch at N=10^6, as the card
runs it: the state is one ``rho = 1`` natural-gradient step from
``svgp_init`` on a minibatch of 4096 (``RandomState(0).choice``, as
``stheno_torch.entry`` draws it), in float64, cast down for the float32
run; on that minibatch, the ELBO's relative error and the relative error
of its gradient with respect to log s2, log ell and z (z's and the whole
gradient's normwise). Then, for each N, the data cut to N at full batch:
from ``svgp_init``, one ``rho = 1`` step and the ELBO in both dtypes, its
relative error (``nan`` where float32 is not finite), and the float64
ELBO against the collapsed VFE bound (the identity that the step
reaches; the jitter of ``S``, 1e-2 times the configured one, moves it).

Each line is one JSON object and states the run's seconds and the
process's peak resident memory so far. The products run in row blocks of
512 (the sums do not depend on it): at 8192 a float64 block of the
N=262,144 Gram would take 17 GB.
"""

import json
import os
import resource
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from stheno_tpu import (  # noqa: E402
    EQ,
    GP,
    PseudoObs,
    config,
    dense,
    pairwise,
    pathwise_sampler,
    svgp_elbo,
    svgp_init,
    svgp_natgrad_step,
)
from stheno_tpu.iterative.matvec import kernel_matvec  # noqa: E402
from stheno_tpu.iterative.pchol import make_whitened_solver  # noqa: E402
from stheno_tpu.matrix import adaptive_jitter_eps  # noqa: E402

BLOCK = 512
NOISE = 0.1
SAMPLES, FEATURES = 8, 2048


def peak_gib():
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20


def pathwise_data(n):
    r = np.random.RandomState(0)
    x = np.sort(r.rand(n).astype(np.float32)) * 10
    y = np.sin(x) + np.float32(0.1) * r.randn(n).astype(np.float32)
    return x, y.astype(np.float32)


def pathwise_draws(n):
    """``pathwise_sampler``'s float32 draws from ``PRNGKey(0)``: the EQ
    frequencies ``(1024, 1)``, ``w (2048, 8)`` and the unit ``eps (n, 8)``."""
    _, k_feat, k_w, k_eps = jax.random.split(jax.random.PRNGKey(0), 4)
    freqs = jax.random.normal(k_feat, (FEATURES // 2, 1), jnp.float32)
    w = jax.random.normal(k_w, (FEATURES, SAMPLES), jnp.float32)
    eps = jax.random.normal(k_eps, (n, SAMPLES), jnp.float32)
    return freqs, w, eps


def pathwise_build(x, y, draws, dtype, x_new):
    """``pathwise_sampler``'s CG build and its evaluation at ``x_new``, in
    ``dtype``, from ``draws``: ``(draws at x_new, cg_info)``."""
    x2, y, xn = jnp.asarray(x, dtype)[:, None], jnp.asarray(y, dtype), jnp.asarray(x_new, dtype)
    freqs, w, eps = (jnp.asarray(a, dtype) for a in draws)
    n = x2.shape[0]
    noise = jnp.asarray(NOISE, dtype)

    def phi(t):
        proj = t @ freqs.T
        return jnp.sqrt(jnp.asarray(1.0, dtype) / freqs.shape[0]) * jnp.concatenate(
            [jnp.cos(proj), jnp.sin(proj)], axis=-1)

    resid = y[:, None] - phi(x2) @ w - jnp.sqrt(noise) * eps
    mv = jax.jit(lambda u: kernel_matvec(EQ(), x2, u, block=BLOCK))
    mv_comp = lambda u: kernel_matvec(EQ(), x2, u, block=BLOCK, compensated=True)  # noqa: E731
    solve = make_whitened_solver(mv, n, noise, 64, dtype=dtype, mv_raw_comp=mv_comp,
                                 compensated="auto")
    v, info = solve(resid, tol=1e-4, max_iters=200)
    out = phi(xn[:, None]) @ w + kernel_matvec(EQ(), xn[:, None], v, block=BLOCK, x_cols=x2)
    return np.asarray(out, np.float64), {"iters": int(info["iters"]),
                                         "rel_residual": float(info["rel_residual"])}


def run_pathwise(n):
    t0 = time.perf_counter()
    x, y = pathwise_data(n)
    x_new = np.linspace(-1.0, 11.0, 4096, dtype=np.float32)
    draws = pathwise_draws(n)
    out = {"what": "pathwise", "n": n}
    d32, out["cg_f32"] = pathwise_build(x, y, draws, jnp.float32, x_new)
    if n <= 2000:
        fn, _, _ = pathwise_sampler(
            EQ(), jnp.asarray(x), jnp.asarray(y), NOISE, jax.random.PRNGKey(0),
            num_samples=SAMPLES, num_features=FEATURES, solver="cg", cg_tol=1e-4,
            max_cg_iters=200, precond_rank=64, block=BLOCK, return_info=True)
        ref = np.asarray(fn(jnp.asarray(x_new)), np.float64)
        out["steps_vs_pathwise_sampler_max_abs"] = float(np.max(np.abs(ref - d32)))
    d64, out["cg_f64"] = pathwise_build(x, y, draws, jnp.float64, x_new)
    out["draws_max_abs_f64"] = float(np.max(np.abs(d64)))
    out["draws_rel"] = float(np.max(np.abs(d32 - d64)) / out["draws_max_abs_f64"])
    out["seconds"], out["peak_rss_gib"] = time.perf_counter() - t0, peak_gib()
    print(json.dumps(out), flush=True)


def svgp_data(n):
    r = np.random.RandomState(1)
    x = np.sort(r.rand(n).astype(np.float32)) * 10
    y = np.sin(x) + np.float32(0.1) * r.randn(n).astype(np.float32)
    return x, y.astype(np.float32), np.linspace(0.0, 10.0, 512, dtype=np.float32)


def kernel(theta):
    return jnp.exp(theta["log_s2"]) * EQ().stretch(jnp.exp(theta["log_ell"]))


def rel(a, b):
    return float(abs(a - b) / abs(b))


def _jitter32(z):
    eps = float(adaptive_jitter_eps(dense(pairwise(EQ(), jnp.asarray(z))),
                                    config.jitter(jnp.float32)))
    config.set_epsilon(eps)
    return eps


def run_svgp_minibatch(n=1_000_000, batch=4096):
    t0 = time.perf_counter()
    x, y, z = svgp_data(n)
    out = {"what": "svgp_minibatch", "n": n, "m": 512, "batch": batch, "jitter": _jitter32(z)}
    idx = np.random.RandomState(0).choice(n, size=batch, replace=False)
    theta64 = {"log_s2": jnp.zeros((), jnp.float64), "log_ell": jnp.zeros((), jnp.float64)}
    xb64, yb64 = jnp.asarray(x[idx], jnp.float64)[:, None], jnp.asarray(y[idx], jnp.float64)
    state64 = svgp_natgrad_step(kernel(theta64), svgp_init(EQ(), jnp.asarray(z, jnp.float64)),
                                xb64, yb64, NOISE, n, 1.0)

    def value_grad(dtype):
        cast = lambda t: jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), t)  # noqa: E731
        theta, state = cast(theta64), cast(state64)
        xb, yb = jnp.asarray(x[idx], dtype)[:, None], jnp.asarray(y[idx], dtype)

        def f(theta, zz):
            return svgp_elbo(kernel(theta), {**state, "z": zz}, xb, yb, NOISE, n)

        v, (gt, gz) = jax.value_and_grad(f, argnums=(0, 1))(theta, state["z"])
        g = np.concatenate([[float(gt["log_s2"]), float(gt["log_ell"])],
                            np.asarray(gz, np.float64).ravel()])
        return float(v), g

    v32, g32 = value_grad(jnp.float32)
    v64, g64 = value_grad(jnp.float64)
    out.update({
        "elbo_f64": v64, "elbo_rel": rel(v32, v64),
        "grad_f64": g64[:2].tolist(), "grad_z_f64_norm": float(np.linalg.norm(g64[2:])),
        "grad_log_s2_rel": rel(g32[0], g64[0]), "grad_log_ell_rel": rel(g32[1], g64[1]),
        "grad_z_rel": float(np.linalg.norm(g32[2:] - g64[2:]) / np.linalg.norm(g64[2:])),
        "grad_rel": float(np.linalg.norm(g32 - g64) / np.linalg.norm(g64)),
    })
    config.set_epsilon(None)
    out["seconds"], out["peak_rss_gib"] = time.perf_counter() - t0, peak_gib()
    print(json.dumps(out), flush=True)


def run_svgp_full(n):
    t0 = time.perf_counter()
    x, y, z = svgp_data(n)
    out = {"what": "svgp_full_batch", "n": n, "m": 512, "jitter": _jitter32(z)}

    def full(dtype):
        theta = {k: jnp.asarray(0.0, dtype) for k in ("log_s2", "log_ell")}
        xx, yy = jnp.asarray(x, dtype)[:, None], jnp.asarray(y, dtype)
        p = svgp_natgrad_step(kernel(theta), svgp_init(EQ(), jnp.asarray(z, dtype)), xx, yy,
                              NOISE, n, 1.0)
        return float(svgp_elbo(kernel(theta), p, xx, yy, NOISE, n))

    e32, e64 = full(jnp.float32), full(jnp.float64)
    f = GP(EQ())
    x64, y64 = jnp.asarray(x, jnp.float64), jnp.asarray(y, jnp.float64)
    vfe = float(PseudoObs(f(jnp.asarray(z, jnp.float64)), (f(x64, NOISE), y64)).elbo(f.measure))
    out.update({"elbo_f64": e64, "elbo_f32": e32,
                "elbo_rel": rel(e32, e64) if np.isfinite(e32) else float("nan"),
                "vfe_f64": vfe, "identity_rel_f64": rel(e64, vfe)})
    config.set_epsilon(None)
    out["seconds"], out["peak_rss_gib"] = time.perf_counter() - t0, peak_gib()
    print(json.dumps(out), flush=True)


def main(argv):
    args = argv or ["pathwise", "262144", "svgp", "125000", "250000"]
    what, minibatch_done = None, False
    for a in args:
        if a in ("pathwise", "svgp"):
            what = a
        elif what == "pathwise":
            run_pathwise(int(a))
        elif what == "svgp":
            if not minibatch_done:
                run_svgp_minibatch()
                minibatch_done = True
            run_svgp_full(int(a))
        else:
            raise SystemExit(f"usage: {__doc__.splitlines()[3].strip()}")


if __name__ == "__main__":
    main(sys.argv[1:])
