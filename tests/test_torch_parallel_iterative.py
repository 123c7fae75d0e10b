"""Parity of the port's sharded matrix-free path
(``stheno_torch/parallel/iterative.py``) with ``stheno_tpu.parallel.iterative``,
mirroring the iterative tests of ``tests/parallel/test_distributed.py``
(``:117-220``, ``:645-700``).

The port runs at D = 1 in this process and at D = 2 and 4 in the suite
``parallel``'s gloo worker pools (``tests/torch_parallel_worker.py``, cases
``iter_*``); the JAX side runs here on the 8-device CPU mesh. Both take the
same numpy float64 inputs. The matvecs match to 1e-8 (the JAX test's
tolerance). The NLML core with the sharded hooks (the sharded matvec and
the sharded surrogate gradient), fed the same numpy probes, matches the
JAX core with its sharded hooks to 1e-10 in its value and 1e-8 in every
gradient (parameters, noise, ``x``, ``y``), relative to the largest entry
of the JAX result. ``sharded_iterative_nlml`` draws its probes from a
``torch.Generator`` where the JAX function splits a key, so it is held to
the dense NLML at the JAX tests' own tolerances. Every rank's copy of every
result is the same to the bit."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stheno_tpu as sj
import tests.torch_parallel_worker as W
from stheno_tpu.iterative import nlml as jnlml
from stheno_tpu.parallel import iterative as jpi
from stheno_tpu.parallel import make_data_mesh
from tests.test_torch_helpers import torch_cpu  # noqa: F401

DS = (1, 2, 4)
VALUE_RTOL = 1e-10
GRAD_RTOL = 1e-8


def close(got, want, rtol, what=""):
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)
    assert err <= rtol, f"{what}: relative error {err:.3e} > {rtol:.0e}"


def replicated(res, key):
    """A replicated result, after checking that every rank holds the same."""
    for r in res[1:]:
        np.testing.assert_array_equal(r[key], res[0][key], err_msg=key)
    return res[0][key]


def port(case, D, tmp_path_factory):
    return W.iter_results(f"iter_{case}", D, tmp_path_factory)


@functools.cache
def jmesh():
    return make_data_mesh(8)


def _kf(p):
    return jnp.exp(p["log_s2"]) * sj.EQ().stretch(jnp.exp(p["log_ell"]))


def _dense_nlml(k, x, y, noise):
    f = sj.GP(k)
    return -f.measure.logpdf(f(x, noise), y)


# ---------------------------------------------------------------------------
# The JAX side.


@functools.cache
def jax_matvec():
    r = np.random.RandomState(7)
    x, v = jnp.asarray(np.sort(r.rand(100))), jnp.asarray(r.randn(100, 3))
    xn = jnp.asarray(np.linspace(-0.5, 1.5, 37))
    return {
        "mv": np.asarray(jpi.sharded_kernel_matvec(sj.EQ(), x, v, jmesh(), noise=0.1, block=16)),
        "mv_vec": np.asarray(jpi.sharded_kernel_matvec(sj.EQ(), x, v[:, 0], jmesh(), block=16)),
        "cross": np.asarray(jpi._cross_matvec_sharded(
            sj.EQ().stretch(0.3), xn[:, None], x[:, None], v, jmesh(), block=8)),
        "single": np.asarray(sj.iterative.kernel_matvec(sj.EQ(), x, v, noise=0.1, block=16)),
    }


@functools.cache
def jax_core():
    x, y, u, om = W.iter_core_inputs()
    *_, block = W.ITER_CORE
    mesh = jmesh()

    def mv(k, xx, v, nz):
        return jpi.sharded_kernel_matvec(k, xx, v, mesh, noise=nz, block=block)

    def value(p, noise, xx, yy):
        return jnlml._nlml(p, yy, noise, xx, jnp.asarray(u), jnp.asarray(om), None, _kf, mv,
                           jpi.make_sharded_surrogate_grad(_kf, mesh, block=block), 1e-12, 400,
                           60, om.shape[1], "eig", 1, None)

    (v, info), g = jax.value_and_grad(value, argnums=(0, 1, 2, 3), has_aux=True)(
        {k: jnp.asarray(t) for k, t in W.ITER_PARAMS.items()}, jnp.asarray(0.1),
        jnp.asarray(x)[:, None], jnp.asarray(y))
    out = {"value": np.asarray(v), "iters": int(info["cg_iters"]),
           "grad_noise": np.asarray(g[1]), "grad_x": np.asarray(g[2]), "grad_y": np.asarray(g[3])}
    out.update({f"grad_{k}": np.asarray(t) for k, t in g[0].items()})
    return out


@functools.cache
def dense_refs():
    """The dense NLMLs and gradients the JAX tests hold the sharded path to."""
    out = {}
    x, y = W.iter_data(96, 8, noise=0.0)
    out["value"] = float(_dense_nlml(sj.EQ(), jnp.asarray(x), jnp.asarray(y), 0.1))
    x, y = (jnp.asarray(a) for a in W.iter_data(96, 9))
    params = {"log_ell": jnp.asarray(0.1), "log_s2": jnp.asarray(0.2)}
    gp, gn = jax.grad(lambda p, nz: _dense_nlml(_kf(p), x, y, nz), argnums=(0, 1))(
        params, jnp.asarray(0.1))
    out.update({"grad_log_ell": float(gp["log_ell"]), "grad_log_s2": float(gp["log_s2"]),
                "grad_noise": float(gn)})
    xa, ya, B = (jnp.asarray(a) for a in W.icm_inputs())
    k = sj.EQ().select([0]) * sj.kernels.Coregion(B).select([1])
    out["icm"] = float(_dense_nlml(k, xa, ya, 0.1))
    return out


# ---------------------------------------------------------------------------
# The tests.


@pytest.mark.parametrize("D", DS)
def test_sharded_kernel_matvec(D, tmp_path_factory):
    """n=100 (padded at D = 8 on the JAX side): the row-sharded matvec, its
    vector form and the cross matvec against the JAX package's sharded
    functions, and the matvec against the single-device one (rtol 1e-8)."""
    res, ref = port("matvec", D, tmp_path_factory), jax_matvec()
    for key in ("mv", "mv_vec", "cross"):
        np.testing.assert_allclose(replicated(res, key), ref[key], rtol=1e-8, err_msg=key)
    np.testing.assert_allclose(res[0]["mv"], ref["single"], rtol=1e-8)


@pytest.mark.parametrize("D", DS)
def test_nlml_core_with_sharded_hooks_matches_jax(D, tmp_path_factory):
    """The port's ``_nlml`` with the sharded matvec and surrogate against the
    JAX ``_nlml`` with ``sharded_kernel_matvec`` and
    ``make_sharded_surrogate_grad`` on the same numpy probes."""
    res, ref = port("core", D, tmp_path_factory), jax_core()
    assert int(replicated(res, "iters")) == ref["iters"]
    close(replicated(res, "value"), ref["value"], VALUE_RTOL, "value")
    for key in ("grad_log_s2", "grad_log_ell", "grad_noise", "grad_x", "grad_y"):
        close(replicated(res, key), ref[key], GRAD_RTOL, key)


@pytest.mark.parametrize("D", DS)
def test_sharded_iterative_nlml(D, tmp_path_factory):
    val = float(replicated(port("nlml", D, tmp_path_factory), "value"))
    ref = dense_refs()["value"]
    assert abs(val - ref) < 1.5, (val, ref)


@pytest.mark.parametrize("D", DS)
def test_sharded_iterative_nlml_grad_parity(D, tmp_path_factory):
    """The gradients in ``log_ell``, ``log_s2`` and the noise against the
    dense NLML's (the stochastic estimator's tolerance)."""
    res, ref = port("nlml", D, tmp_path_factory), dense_refs()
    for key in ("grad_log_ell", "grad_log_s2", "grad_noise"):
        np.testing.assert_allclose(float(replicated(res, key)), ref[key], rtol=0.25, atol=0.5,
                                   err_msg=key)


@pytest.mark.parametrize("D", DS)
def test_sharded_iterative_training_loop(D, tmp_path_factory):
    vals = replicated(port("nlml", D, tmp_path_factory), "loop")
    assert np.all(np.isfinite(vals)) and vals[-1] < vals[0], vals


@pytest.mark.parametrize("D", DS)
def test_sharded_iterative_nlml_return_info(D, tmp_path_factory):
    res = port("nlml", D, tmp_path_factory)
    iters, _, converged = replicated(res, "info")
    assert np.isfinite(replicated(res, "info_value"))
    assert converged == 1.0 and iters >= 1


@pytest.mark.parametrize("D", DS)
def test_sharded_iterative_nlml_multioutput_icm(D, tmp_path_factory):
    val = float(replicated(port("nlml", D, tmp_path_factory), "icm"))
    ref = dense_refs()["icm"]
    assert abs(val - ref) < 1.0, (val, ref)


def test_sharded_matvec_is_forward_only():
    """A gradient through the matvec would cross its all-gather, which has
    no autograd kernel: it raises rather than cutting the gradient."""
    from stheno_torch import EQ
    from stheno_torch.parallel import make_data_mesh as tmesh
    from stheno_torch.parallel import sharded_kernel_matvec

    x = torch.linspace(0.0, 1.0, 8, dtype=torch.float64, requires_grad=True)
    with pytest.raises(RuntimeError, match="no autograd kernel"):
        sharded_kernel_matvec(EQ(), x, torch.ones(8, dtype=torch.float64), tmesh())


def test_sharded_entry_matches_the_single_device_step():
    """``entry.sharded_iterative_262k`` at N=300 in float64 on one rank
    against ``entry.iterative_step`` from the same generator seed: the
    same probes, the same stop, the value and gradients to 1e-10."""
    from stheno_torch import entry as E
    from stheno_torch.parallel import make_data_mesh as tmesh

    kw = dict(precond_rank=16, block=64)
    v, g, info = E.sharded_iterative_262k(tmesh(), torch.Generator().manual_seed(4), n=300,
                                          dtype=torch.float64, **kw)
    x, y, params = E.iterative_inputs(300, device="cpu", dtype=torch.float64)
    rv, rg, rinfo = E.iterative_step(x, y, params, torch.Generator().manual_seed(4), **kw)
    assert info["cg_iters"] == rinfo["cg_iters"]
    close(v, rv, VALUE_RTOL, "value")
    for k in rg:
        close(g[k], rg[k], VALUE_RTOL, k)
