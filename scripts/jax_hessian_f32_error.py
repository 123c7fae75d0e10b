"""The JAX package's own float32 error on the Hessian of the flagship NLML,
on the CPU: the number that sets ``chip_smoke.py``'s float32 gate on
``entry.flagship_hessian`` (``JAX_F32_HESSIAN``).

    JAX_PLATFORMS=cpu python3 scripts/jax_hessian_f32_error.py [N ...]

Without arguments: N = 2000. The model of ``stheno_torch/entry.py``'s
``flagship_hessian`` and ``flagship_n2000_inputs``: ``x`` linspace(0, 10,
N), ``y = sin x + 0.3 cos 3.2x``, the NLML of ``GP(exp(log_s2)
EQ().stretch(exp(log_ell)))`` with noise ``exp(log_noise)`` at
``(log_ell, log_s2, log_noise) = (0, 0, -2)``. ``jax.hessian`` of it with
respect to the three, in float32 and in float64 (the same inputs, cast
down). It prints one JSON line per N: the float64 Hessian, the normwise
relative error (Frobenius) and the largest entry's error over the largest
float64 entry (``max_rel``, the measure the gate uses), the run's seconds.
"""

import json
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import stheno_tpu as sj  # noqa: E402

P0 = (0.0, 0.0, -2.0)  # log ell, log s2, log noise


def hessian(n, dtype):
    x = jnp.linspace(0.0, 10.0, n, dtype=jnp.float64)
    y = jnp.sin(x) + 0.3 * jnp.cos(3.2 * x)
    x, y = x.astype(dtype), y.astype(dtype)

    def nlml(p):
        f = sj.GP(jnp.exp(p[1]) * sj.EQ().stretch(jnp.exp(p[0])))
        return -f.measure.logpdf(f(x, jnp.exp(p[2])), y)

    return np.asarray(jax.jit(jax.hessian(nlml))(jnp.asarray(P0, dtype=dtype)), np.float64)


def main(sizes):
    for n in sizes:
        t0 = time.perf_counter()
        h64 = hessian(n, jnp.float64)
        h32 = hessian(n, jnp.float32)
        print(json.dumps({
            "n": n, "hessian_f64": h64.tolist(), "hessian_f32": h32.tolist(),
            "rel": float(np.linalg.norm(h32 - h64) / np.linalg.norm(h64)),
            "max_rel": float(np.abs(h32 - h64).max() / np.abs(h64).max()),
            "seconds": time.perf_counter() - t0,
        }), flush=True)


if __name__ == "__main__":
    main([int(a) for a in sys.argv[1:]] or [2000])
