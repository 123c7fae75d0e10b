"""The JAX package's own float32 error on the structured-grid paths, on the
CPU: the numbers that set the tolerances of ``chip_smoke.py``'s phase
``item9_path`` (``JAX_F32_ITEM9``).

    JAX_PLATFORMS=cpu python3 scripts/jax_item9_f32_error.py [grid N] [kron N1 N2] [gridpost N]

Without arguments: ``grid 1048576 kron 1024 1024 gridpost 1048576``.

``grid N``: ``bench.py:bench_structured_grids``'s circulant step at N
points: the axis linspace(0, 100, N), y = sin(axis) + 0.1 noise
(``RandomState(0)``), the kernel ``exp(log_s2) EQ().stretch(exp(log_ell))``
at 0, 0, noise 0.1, 8 probes, CG tol 1e-2 and at most 100 iterations, 20
SLQ steps, preconditioner rank 64. The NLML value and its gradient with
respect to (log s2, log ell), by ``grid_iterative_nlml``'s own core
(``nlml._nlml`` with the FFT ``matvec_fn``), in float32 and in float64
from the same probes: those ``grid_iterative_nlml`` draws from
``PRNGKey(0)``, drawn in float64 and cast down for the float32 run. It
reports the value's relative error and the gradient's normwise and
per-entry relative errors.

``kron N1 N2``: the Kronecker step on the N1 x N2 grid (axes linspace(0,
10, N1) and linspace(0, 8, N2), y standard normal from ``RandomState(1)``,
per-axis kernels ``exp(log_s2) EQ().stretch(exp(log_ell1))`` and
``EQ().stretch(exp(log_ell2))`` at 0, noise 0.1): ``kron_nlml``'s value
and gradient with respect to (log s2, log ell1, log ell2) in float32 and
float64, their relative errors.

``gridpost N``: the posterior on grid N's data at ``stheno_torch.entry``'s
``grid_posterior_1m`` settings (CG tol 1e-5, at most 300 iterations,
rank 256, blocks of 8192): ``grid_posterior_mean`` at 4096 points and
``grid_posterior_var`` at 512 points of linspace(0, 100) (in chunks of 64:
the chunk changes only the solve's stopping, not what it solves), in
float32 and float64; the largest error of each over the largest float64
value.

Each line is one JSON object with the run's seconds and the process's
peak resident memory so far.
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

from stheno_tpu import EQ  # noqa: E402
from stheno_tpu.iterative import kron_nlml  # noqa: E402
from stheno_tpu.iterative import nlml as jnlml  # noqa: E402
from stheno_tpu.iterative import toeplitz as jtoe  # noqa: E402

NOISE = 0.1


def _peak_gib():
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20


def _errors(v32, g32, v64, g64, keys):
    a = np.array([float(g32[k]) for k in keys])
    b = np.array([float(g64[k]) for k in keys])
    return {
        "value_f64": float(v64),
        "value_rel": abs(float(v32) - float(v64)) / abs(float(v64)),
        "grad_f64": dict(zip(keys, b.tolist())),
        "grad_rel": float(np.linalg.norm(a - b) / np.linalg.norm(b)),
        "grad_rel_each": {k: abs(x - y) / abs(y) for k, x, y in zip(keys, a, b)},
    }


def grid(n):
    t0 = time.time()
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    u64 = jax.random.normal(k1, (n, 8), jnp.float64)
    om64 = jax.random.normal(k2, (n, 64), jnp.float64)
    eps = np.random.RandomState(0).randn(n)

    def kf(p):
        return jnp.exp(p["log_s2"]) * EQ().stretch(jnp.exp(p["log_ell"]))

    def mv(k, xx, v, nz):
        return jtoe.grid_matvec(k, jtoe._axes_from_coords(xx, (n,)), v, noise=nz)

    out = {}
    for dt in (jnp.float32, jnp.float64):
        axis = jnp.linspace(0.0, 100.0, n, dtype=dt)
        y = jnp.sin(axis) + 0.1 * jnp.asarray(eps.astype(dt))
        x = jtoe.grid_coords((axis,))
        params = {"log_s2": jnp.asarray(0.0, dt), "log_ell": jnp.asarray(0.0, dt)}

        def value(p):
            return jnlml._nlml(p, y, jnp.asarray(NOISE, dt), x, u64.astype(dt), om64.astype(dt),
                               None, kf, mv, None, 1e-2, 100, 20, 64, "eig", 1, None)[0]

        out[dt] = jax.jit(jax.value_and_grad(value))(params)
    (v32, g32), (v64, g64) = out[jnp.float32], out[jnp.float64]
    return {"grid_n": n, **_errors(v32, g32, v64, g64, ["log_s2", "log_ell"]),
            "seconds": time.time() - t0, "peak_rss_gib": _peak_gib()}


def kron(n1, n2):
    t0 = time.time()
    y = np.random.RandomState(1).randn(n1 * n2)

    def kfs(p):
        return (jnp.exp(p["log_s2"]) * EQ().stretch(jnp.exp(p["log_ell1"])),
                EQ().stretch(jnp.exp(p["log_ell2"])))

    out = {}
    for dt in (jnp.float32, jnp.float64):
        ax = (jnp.linspace(0.0, 10.0, n1, dtype=dt), jnp.linspace(0.0, 8.0, n2, dtype=dt))
        params = {k: jnp.asarray(0.0, dt) for k in ("log_s2", "log_ell1", "log_ell2")}
        yy = jnp.asarray(y.astype(dt))
        out[dt] = jax.jit(jax.value_and_grad(lambda p: kron_nlml(kfs, p, ax, yy, NOISE)))(params)
    (v32, g32), (v64, g64) = out[jnp.float32], out[jnp.float64]
    return {"kron_n": [n1, n2], **_errors(v32, g32, v64, g64, ["log_s2", "log_ell1", "log_ell2"]),
            "seconds": time.time() - t0, "peak_rss_gib": _peak_gib()}


def gridpost(n):
    from stheno_tpu.iterative import grid_posterior_mean, grid_posterior_var

    t0 = time.time()
    eps = np.random.RandomState(0).randn(n)

    def kf(p):
        return jnp.exp(p["log_s2"]) * EQ().stretch(jnp.exp(p["log_ell"]))

    out = {}
    for dt in (jnp.float32, jnp.float64):
        axis = jnp.linspace(0.0, 100.0, n, dtype=dt)
        y = jnp.sin(axis) + 0.1 * jnp.asarray(eps.astype(dt))
        params = {"log_s2": jnp.asarray(0.0, dt), "log_ell": jnp.asarray(0.0, dt)}
        opts = dict(cg_tol=1e-5, max_cg_iters=300, precond_rank=256, block=8192)
        mean, info = grid_posterior_mean(kf, params, axis, y, NOISE,
                                         jnp.linspace(0.0, 100.0, 4096, dtype=dt), **opts)
        var = grid_posterior_var(kf, params, axis, y, NOISE,
                                 jnp.linspace(0.0, 100.0, 512, dtype=dt), chunk=64, **opts)
        out[dt] = (np.asarray(mean, np.float64), np.asarray(var, np.float64),
                   int(info["iters"]), float(info["rel_residual"]))
    (m32, v32, i32, r32), (m64, v64, i64, r64) = out[jnp.float32], out[jnp.float64]
    return {"gridpost_n": n, "mean_rel": float(np.abs(m32 - m64).max() / np.abs(m64).max()),
            "var_rel": float(np.abs(v32 - v64).max() / np.abs(v64).max()),
            "mean_f64_max": float(np.abs(m64).max()), "var_f64_max": float(np.abs(v64).max()),
            "mean_cg": {"float32": [i32, r32], "float64": [i64, r64]},
            "seconds": time.time() - t0, "peak_rss_gib": _peak_gib()}


def main(argv):
    argv = argv or ["grid", "1048576", "kron", "1024", "1024", "gridpost", "1048576"]
    i = 0
    while i < len(argv):
        if argv[i] == "grid":
            print(json.dumps(grid(int(argv[i + 1]))), flush=True)
            i += 2
        elif argv[i] == "gridpost":
            print(json.dumps(gridpost(int(argv[i + 1]))), flush=True)
            i += 2
        elif argv[i] == "kron":
            print(json.dumps(kron(int(argv[i + 1]), int(argv[i + 2]))), flush=True)
            i += 3
        else:
            raise SystemExit(f"unknown argument {argv[i]!r}")


if __name__ == "__main__":
    main(sys.argv[1:])
