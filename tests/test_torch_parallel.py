"""Parity of the port's distributed 1-D paths (``stheno_torch.parallel``)
with the JAX package's (``stheno_tpu.parallel``), mirroring the 1-D tests of
``tests/parallel/test_distributed.py``.

The port runs at D = 1 in this process and at D = 2 and 4 in spawned gloo
workers (``tests/torch_parallel_worker.py``, one pool per D for the whole
session, which imports neither ``jax`` nor ``stheno_tpu``). The JAX side
runs here on the 8-device CPU mesh of ``tests/conftest.py``. Both take the
same numpy float64 inputs. Values match to 1e-10 and gradients to 1e-8,
relative to the largest entry of the JAX result; every rank's copy of a
replicated result (a value, a gradient) is the same to the bit.

The last section holds the public factor's, solve's and posteriors'
gradients (F5 in ``ROADMAP.md``) to ``jax.grad`` of the JAX functions, and
the collectives to raising under a gradient."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import stheno_tpu as sj
import stheno_tpu.parallel as jp
import stheno_tpu.parallel.cholesky as jpc
import tests.torch_parallel_worker as W
from tests.test_torch_helpers import torch_cpu  # noqa: F401

DS = (1, 2, 4)
VALUE_RTOL = 1e-10
GRAD_RTOL = 1e-8
METHODS = ("vfe", "fitc", "dtc")


@functools.cache
def _local():
    import stheno_torch.parallel as P

    return {k: [v] for k, v in W.run_suite("parallel", P.make_data_mesh()).items()}


def port(case, D, tmp_path_factory):
    """``[rank 0's dict, ...]`` of ``case`` at ``D`` ranks."""
    if D == 1:
        return _local()[case]
    return W.results("parallel", D, tmp_path_factory)[case]


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


@functools.cache
def jmesh():
    return jp.make_data_mesh(8)


class _RecBase:
    def __init__(self, n):
        self.n = n

    def __enter__(self):
        self.prev, jpc._REC_BASE = jpc._REC_BASE, self.n

    def __exit__(self, *exc):
        jpc._REC_BASE = self.prev


def _eq(log_ell, log_s2=None):
    k = sj.EQ().stretch(jnp.exp(log_ell))
    return k if log_s2 is None else jnp.exp(log_s2) * k


# ---------------------------------------------------------------------------
# The JAX side.


@functools.cache
def jax_factors():
    mesh = jmesh()
    chol = lambda b: jax.jit(lambda K: jp.dist_cholesky(K, mesh, block=b))  # noqa: E731
    out = {}
    for key, n, seed, block in (("128_b16", 128, 0, 16), ("64_b256", 64, 0, 256),
                                ("1024_b32", 1024, 11, 32), ("1100_b32", 1100, 12, 32),
                                ("1101_b32", 1101, 13, 32)):
        out[f"chol_{key}"] = np.asarray(chol(block)(jnp.asarray(W.psd(n, seed))))
    out["chol_5"] = np.asarray(jp.dist_cholesky(jnp.asarray(W.psd(5)), mesh))
    L, Linv = jax.jit(lambda K: jp.dist_cholesky_with_inv(K, mesh, block=8))(
        jnp.asarray(W.psd(192, 27)))
    out["with_inv_L"], out["with_inv_Linv"] = np.asarray(L), np.asarray(Linv)
    L = np.linalg.cholesky(W.psd(128, 1))
    B = np.random.RandomState(2).randn(128, 5)
    out["solve"] = np.asarray(jp.dist_solve_lower(jnp.asarray(L), jnp.asarray(B), mesh, block=16))
    with _RecBase(64):
        out["rec_chol"] = np.asarray(chol(8)(jnp.asarray(W.psd(128, 7))))
        L = np.linalg.cholesky(W.psd(128, 11))
        B = np.random.RandomState(12).randn(128, 7)
        out["rec_solve"] = np.asarray(jax.jit(
            lambda L, B: jp.dist_solve_lower(L, B, mesh, block=8))(jnp.asarray(L), jnp.asarray(B)))
        L, Linv = jax.jit(lambda K: jp.dist_cholesky_with_inv(K, mesh, block=8))(
            jnp.asarray(W.psd(128, 28)))
        out["rec_with_inv_L"], out["rec_with_inv_Linv"] = np.asarray(L), np.asarray(Linv)
        out["rec_chol_196"] = np.asarray(chol(8)(jnp.asarray(W.psd(196, 29))))
    return out


def _jax_nlml(x, y, block, noise=0.1):
    mesh = jmesh()

    def f(log_ell, log_s2=None):
        K = jp.sharded_gram(_eq(log_ell, log_s2), jnp.asarray(x)[:, None], mesh, noise=noise)
        return jp.dist_nlml(K, jnp.asarray(y), mesh, block=block)

    return f


@functools.cache
def jax_nlml():
    out = {}
    for key, n, seed, block, rec in (("64", 64, None, 8, 2048), ("1024", 1024, 3, 32, 2048),
                                     ("rec128", 128, None, 8, 64)):
        x, y = W.nlml_data(n, seed)
        with _RecBase(rec):
            v, g = jax.jit(jax.value_and_grad(_jax_nlml(x, y, block)))(0.3)
        out[f"value_{key}"], out[f"grad_{key}"] = np.asarray(v), np.asarray(g)
    x, y = W.nlml_data(64)
    v, g = jax.jit(jax.value_and_grad(_jax_nlml(x, y, 8), argnums=(0, 1)))(0.1, 0.2)
    out["step_value"], out["step_grads"] = np.asarray(v), np.asarray(g)
    x, y = W.nlml_data(64, 4)

    def every(log_ell, log_s2, noise, x, y):
        K = jp.sharded_gram(_eq(log_ell, log_s2), x[:, None], jmesh(), noise=noise)
        return jp.dist_nlml(K, y, jmesh(), block=8)

    v, gs = jax.jit(jax.value_and_grad(every, argnums=(0, 1, 2, 3, 4)))(
        0.3, 0.2, 0.1, jnp.asarray(x), jnp.asarray(y))
    out["all_value"] = np.asarray(v)
    for name, g in zip(("ell", "s2", "noise", "x", "y"), gs):
        out[f"all_grad_{name}"] = np.asarray(g)
    return out


# ---------------------------------------------------------------------------
# Factorisations and solves.


@pytest.mark.parametrize("D", DS)
@pytest.mark.parametrize("key", ["chol_128_b16", "chol_64_b256"])
def test_dist_cholesky_parity(D, key, tmp_path_factory):
    """Against the JAX factor; the 64-row case clips block 256 to N/D."""
    res = port("factors", D, tmp_path_factory)
    close(W.rows(res, f"rows:{key}"), jax_factors()[key], VALUE_RTOL, key)


@pytest.mark.parametrize("D", DS)
def test_dist_solve_parity(D, tmp_path_factory):
    res = port("factors", D, tmp_path_factory)
    close(W.rows(res, "rows:solve"), jax_factors()["solve"], VALUE_RTOL)


@pytest.mark.parametrize("D", DS)
def test_dist_cholesky_recursive_parity(D, tmp_path_factory):
    """The divide-and-conquer path (``_REC_BASE`` 64 at N = 128) and, at
    N = 196 (h = 98), one more level at D = 2 and the loop fallback at D = 4
    (98 % 4 != 0)."""
    res = port("factors", D, tmp_path_factory)
    for key in ("rec_chol", "rec_chol_196"):
        close(W.rows(res, f"rows:{key}"), jax_factors()[key], VALUE_RTOL, key)


@pytest.mark.parametrize("D", DS)
def test_dist_solve_lower_recursive_parity(D, tmp_path_factory):
    res = port("factors", D, tmp_path_factory)
    close(W.rows(res, "rows:rec_solve"), jax_factors()["rec_solve"], VALUE_RTOL)


@pytest.mark.parametrize("D", DS)
@pytest.mark.parametrize("rec", ["loop", "recursion"])
def test_dist_cholesky_with_inv_parity(D, rec, tmp_path_factory):
    res = port("factors", D, tmp_path_factory)
    pre = "" if rec == "loop" else "rec_"
    L, Linv = W.rows(res, f"rows:{pre}with_inv_L"), W.rows(res, f"rows:{pre}with_inv_Linv")
    close(L, jax_factors()[f"{pre}with_inv_L"], VALUE_RTOL, "L")
    close(Linv, jax_factors()[f"{pre}with_inv_Linv"], VALUE_RTOL, "Linv")
    np.testing.assert_allclose(Linv @ L, np.eye(L.shape[0]), atol=1e-10)


@pytest.mark.parametrize("D", (2, 4))
def test_dist_solve_untileable_raises(D, tmp_path_factory):
    """N = 5 over D = 2 or 4 ranks cannot be tiled (at D = 1 it can)."""
    assert "Cannot tile" in str(port("untileable", D, tmp_path_factory)[0]["raised"])


@pytest.mark.parametrize("D", DS)
def test_dist_cholesky_untileable_pads(D, tmp_path_factory):
    """N = 5: identity-padded to a multiple of D * block (D = 2, 4); the
    factor is exact."""
    res = port("factors", D, tmp_path_factory)
    close(replicated(res, "chol_5"), jax_factors()["chol_5"], VALUE_RTOL)


@pytest.mark.parametrize("D", DS)
def test_dist_cholesky_adaptive_jitter(D, tmp_path_factory):
    """``config.set_adaptive_jitter(True)`` reaches the panel factorisation:
    a rank-4 float32 Gram of large norm factorises finitely."""
    assert all(bool(r["finite"]) for r in port("jitter", D, tmp_path_factory))


@pytest.mark.parametrize("D", DS)
def test_dist_cholesky_realistic_shape(D, tmp_path_factory):
    """N = 1024, block 32: 32 panels, several row blocks per rank."""
    res = port("factors", D, tmp_path_factory)
    close(W.rows(res, "rows:chol_1024_b32"), jax_factors()["chol_1024_b32"], VALUE_RTOL)


@pytest.mark.parametrize("D", DS)
def test_dist_cholesky_nondivisible_n(D, tmp_path_factory):
    """N = 1100 (divisible by D = 2 and 4 but by no D * 32: the block halves
    down) and N = 1101 (by no D > 1: identity padding)."""
    res = port("factors", D, tmp_path_factory)
    close(W.rows(res, "rows:chol_1100_b32"), jax_factors()["chol_1100_b32"], VALUE_RTOL)
    close(replicated(res, "chol_1101_b32"), jax_factors()["chol_1101_b32"], VALUE_RTOL)


# ---------------------------------------------------------------------------
# The NLML and the posterior.


@pytest.mark.parametrize("D", DS)
@pytest.mark.parametrize("key", ["64", "1024", "rec128"])
def test_dist_nlml_parity_and_grad(D, key, tmp_path_factory):
    """Value and gradient in log ell through ``sharded_gram`` at N = 64, at
    the realistic N = 1024 (block 32) and through the recursion
    (``_REC_BASE`` 64 at N = 128); the value-only call equals the value."""
    res = port("nlml", D, tmp_path_factory)
    j = jax_nlml()
    close(replicated(res, f"value_{key}"), j[f"value_{key}"], VALUE_RTOL, "value")
    close(replicated(res, f"grad_{key}"), j[f"grad_{key}"], GRAD_RTOL, "grad")
    close(replicated(res, f"value_only_{key}"), j[f"value_{key}"], VALUE_RTOL, "value only")


@pytest.mark.parametrize("D", DS)
def test_dist_training_step(D, tmp_path_factory):
    """The dryrun_multichip step: value and gradient in log ell and log s2."""
    res = port("nlml", D, tmp_path_factory)
    close(replicated(res, "step_value_a"), jax_nlml()["step_value"], VALUE_RTOL)
    close(replicated(res, "step_grads_a"), jax_nlml()["step_grads"], GRAD_RTOL)


@pytest.mark.parametrize("D", DS)
def test_distributed_nlml_deterministic(D, tmp_path_factory):
    """Two identical value-and-gradient runs agree to the bit."""
    for r in port("nlml", D, tmp_path_factory):
        np.testing.assert_array_equal(r["step_value_a"], r["step_value_b"])
        np.testing.assert_array_equal(r["step_grads_a"], r["step_grads_b"])


@pytest.mark.parametrize("D", DS)
@pytest.mark.parametrize("name", ["ell", "s2", "noise", "x", "y"])
def test_dist_nlml_every_gradient(D, name, tmp_path_factory):
    """The gradient in each replicated input (the stretch, the scale, the
    noise, ``x``, ``y``): the sum of the ranks' shares, the same on every
    rank, equal to the JAX package's."""
    res = port("nlml", D, tmp_path_factory)
    close(replicated(res, "all_value"), jax_nlml()["all_value"], VALUE_RTOL, "value")
    close(replicated(res, f"all_grad_{name}"), jax_nlml()[f"all_grad_{name}"], GRAD_RTOL, name)


@functools.cache
def jax_nlml_matrix():
    mesh = jmesh()
    K = jnp.asarray(W.psd(64, 5))
    y1 = jnp.asarray(np.random.RandomState(6).randn(64))
    out = {"y1_grad": np.asarray(jax.grad(lambda y: jp.dist_nlml(K, y, mesh, block=8))(y1))}
    K = jnp.asarray(W.psd(64, 7))
    Y = jnp.asarray(np.random.RandomState(8).randn(64, 3))
    v, g = jax.value_and_grad(lambda K: jp.dist_nlml(K, Y, mesh, block=8))(K)
    out["joint_value"], out["joint_grad"] = np.asarray(v), np.asarray(g)
    return out


@pytest.mark.parametrize("D", DS)
def test_dist_nlml_1d_y_gradient_shape(D, tmp_path_factory):
    """The y-gradient has the primal's shape, (n,) or (n, 1), and equals
    ``K^{-1} y`` as the JAX package's does."""
    res = port("nlml_matrix", D, tmp_path_factory)
    g1, g2 = replicated(res, "y1_grad"), replicated(res, "y2_grad")
    assert g1.shape == (64,) and g2.shape == (64, 1)
    np.testing.assert_array_equal(g1, g2[:, 0])
    close(g1, jax_nlml_matrix()["y1_grad"], GRAD_RTOL)


@pytest.mark.parametrize("D", DS)
def test_dist_nlml_multi_column_semantics(D, tmp_path_factory):
    """(n, m) y is the sum of m per-column NLMLs sharing K: value and
    K-gradient (K replicated, its gradient summed over the ranks)."""
    res = port("nlml_matrix", D, tmp_path_factory)
    j = jax_nlml_matrix()
    close(replicated(res, "joint_value"), j["joint_value"], VALUE_RTOL)
    close(replicated(res, "cols_value"), j["joint_value"], VALUE_RTOL)
    close(replicated(res, "joint_grad"), j["joint_grad"], GRAD_RTOL)
    close(replicated(res, "cols_grad"), j["joint_grad"], GRAD_RTOL)


@pytest.mark.parametrize("D", DS)
def test_dist_nlml_multi_output(D, tmp_path_factory):
    """A multi-output kernel's (2 N) x (2 N) block Gram, its rows sharded."""
    m = sj.Measure()
    f1 = sj.GP(sj.EQ(), measure=m)
    f2 = sj.GP(sj.EQ().stretch(0.5), measure=m) + 0.3 * f1
    x = jnp.linspace(0.0, 10.0, 32)
    K = jp.sharded_gram(sj.MultiOutputKernel(m, f1, f2), x, jmesh(), noise=0.1)
    want = jp.dist_nlml(K, jnp.concatenate([jnp.sin(x), jnp.cos(x)]), jmesh(), block=8)
    res = port("multi_output", D, tmp_path_factory)
    assert tuple(res[0]["shape"]) == (64, 64)
    close(replicated(res, "value"), want, VALUE_RTOL)


@functools.cache
def jax_posterior():
    out = {}
    for key, n, seed, m, block in (("64", 64, None, 17, 8), ("1024", 1024, 5, 256, 32)):
        x, y = W.nlml_data(n, seed)
        xn = np.linspace(0.0, 10.0, m) if n == 64 else np.linspace(-0.5, 10.5, m)
        mean, var = jax.jit(lambda x, y, xn, block=block: jp.dist_posterior_predict(
            sj.EQ(), x, y, xn, 0.1, jmesh(), block=block))(
            jnp.asarray(x)[:, None], jnp.asarray(y), jnp.asarray(xn)[:, None])
        out[f"mean_{key}"], out[f"var_{key}"] = np.asarray(mean), np.asarray(var)
    return out


@pytest.mark.parametrize("D", DS)
@pytest.mark.parametrize("key", ["64", "1024"])
def test_dist_posterior_parity(D, key, tmp_path_factory):
    """Posterior mean and variance at N = 64 and the realistic N = 1024."""
    res = port("posterior", D, tmp_path_factory)
    close(replicated(res, f"mean_{key}"), jax_posterior()[f"mean_{key}"], VALUE_RTOL, "mean")
    close(replicated(res, f"var_{key}"), jax_posterior()[f"var_{key}"], VALUE_RTOL, "var")


# ---------------------------------------------------------------------------
# The sparse path.


@functools.cache
def jax_elbo():
    mesh = jmesh()
    out = {}
    x, y, z = W.elbo_data(64, 9)
    noise = 0.05 + 0.02 * np.cos(x) ** 2
    xs = np.linspace(0.0, 10.0, 64)
    for method in METHODS:
        out[f"elbo_{method}"] = np.asarray(jp.dist_elbo(
            1.3 * sj.EQ().stretch(0.7), jnp.asarray(z)[:, None], jnp.asarray(x)[:, None],
            jnp.asarray(y), jnp.asarray(noise), mesh, method=method))
        mean, var = jp.dist_sparse_posterior(
            sj.EQ().stretch(0.8), jnp.asarray(z)[:, None], jnp.asarray(xs)[:, None],
            jnp.sin(jnp.asarray(xs)), 0.1, jnp.linspace(-1.0, 11.0, 17)[:, None], mesh,
            method=method)
        out[f"post_mean_{method}"], out[f"post_var_{method}"] = np.asarray(mean), np.asarray(var)
    x, y, z = W.elbo_data(48, 7)
    for method in METHODS:
        def elbo(log_ell, log_s2, log_noise, z, y, method=method):
            return jp.dist_elbo(_eq(log_ell, log_s2), z[:, None], jnp.asarray(x)[:, None], y,
                                jnp.exp(log_noise), mesh, method=method)

        v, gs = jax.jit(jax.value_and_grad(elbo, argnums=(0, 1, 2, 3, 4)))(
            0.2, 0.1, np.log(0.1), jnp.asarray(z), jnp.asarray(y))
        out[f"grad_value_{method}"] = np.asarray(v)
        for name, g in zip(("ell", "s2", "noise", "z", "y"), gs):
            out[f"grad_{method}_{name}"] = np.asarray(g)
    x, y, z = W.elbo_data(53, 7)
    out["elbo_53"] = np.asarray(jp.dist_elbo(
        sj.EQ().stretch(0.8), jnp.asarray(z)[:, None], jnp.asarray(x)[:, None],
        jnp.sin(jnp.asarray(x)), 0.1, mesh))
    return out


@pytest.mark.parametrize("D", DS)
@pytest.mark.parametrize("method", METHODS)
def test_dist_elbo_parity(D, method, tmp_path_factory):
    """VFE, FITC and DTC with a heteroscedastic diagonal noise."""
    res = port("elbo", D, tmp_path_factory)
    close(replicated(res, f"elbo_{method}"), jax_elbo()[f"elbo_{method}"], VALUE_RTOL)


@pytest.mark.parametrize("D", DS)
@pytest.mark.parametrize("method", METHODS)
def test_dist_elbo_grad_parity(D, method, tmp_path_factory):
    """The gradient in log ell, log s2, log noise, z and y."""
    res = port("elbo", D, tmp_path_factory)
    j = jax_elbo()
    close(replicated(res, f"grad_value_{method}"), j[f"grad_value_{method}"], VALUE_RTOL)
    for name in ("ell", "s2", "noise", "z", "y"):
        key = f"grad_{method}_{name}"
        close(replicated(res, key), j[key], GRAD_RTOL, key)


@pytest.mark.parametrize("D", DS)
@pytest.mark.parametrize("method", METHODS)
def test_dist_sparse_posterior_parity(D, method, tmp_path_factory):
    res = port("elbo", D, tmp_path_factory)
    for part in ("mean", "var"):
        key = f"post_{part}_{method}"
        close(replicated(res, key), jax_elbo()[key], VALUE_RTOL, key)


@pytest.mark.parametrize("D", DS)
def test_dist_elbo_n_not_divisible(D, tmp_path_factory):
    """N = 53: masked padding at D = 2 and 4."""
    res = port("elbo", D, tmp_path_factory)
    close(replicated(res, "elbo_53"), jax_elbo()["elbo_53"], VALUE_RTOL)


# ---------------------------------------------------------------------------
# Meshes, work balance, pruning and memory.


@pytest.mark.parametrize("D", DS)
def test_hybrid_mesh_chain_by_data(D, tmp_path_factory):
    """``make_hybrid_mesh(chains=2)`` (chains=1 at D = 1): each chain's NLML
    shards its Gram over ``data``; ``chains=3`` raises."""
    res = port("hybrid", D, tmp_path_factory)
    chains = 2 if D % 2 == 0 else 1
    assert tuple(res[0]["shape"]) == (chains, D // chains)
    x, y = W.nlml_data(32)
    K = jp.sharded_gram(sj.EQ(), jnp.asarray(x)[:, None], jmesh(), noise=0.1)
    want = jp.dist_nlml(K, jnp.asarray(y), jmesh(), block=8)
    close(replicated(res, "value"), want, VALUE_RTOL)
    assert "does not divide" in str(res[0]["raised"])


def test_initialize_hosts_single_process_noop():
    """With no cluster (or a group that exists already) it returns; twice."""
    from stheno_torch.parallel import initialize_hosts

    initialize_hosts()
    initialize_hosts()


@pytest.mark.parametrize("D", (2, 4))
def test_dist_work_balance(D, tmp_path_factory):
    """Each rank's matmul FLOPs (``FlopCounterMode``) in the Cholesky and in
    the NLML value and gradient at N = 512 are at most ``1/D + 0.05`` of the
    D = 1 count (0.3 at D = 4): the math is spread, not serialised."""
    one = port("flops", 1, tmp_path_factory)[0]
    for r in port("flops", D, tmp_path_factory):
        for key in ("cholesky", "value_grad"):
            assert r[key] <= (1 / D + 0.05) * one[key], (key, int(r[key]), int(one[key]))


@pytest.mark.parametrize("D", DS)
def test_dist_nlml_value_only_prunes_inverse(D, tmp_path_factory):
    """Under ``torch.no_grad()`` the NLML computes no ``L^{-1}``: its
    matmul FLOPs are at most 1.25 times the factorisation's (the inverse
    would about triple them)."""
    for r in port("flops", D, tmp_path_factory):
        assert r["value_only"] <= 1.25 * r["cholesky"], (int(r["value_only"]), int(r["cholesky"]))


@pytest.mark.parametrize("D", DS)
def test_no_rank_holds_an_n_by_n_array(D, tmp_path_factory):
    """The largest tensor a rank creates in an NLML value and gradient at
    N = 512 (block 32, through the recursion and its loop) stays below
    ``N^2 w / D * 1.5 + N block w * 4`` bytes."""
    N, block, w = 512, 32, 8
    for r in port("memory", D, tmp_path_factory):
        assert int(r["numel"]) * w < N * N * w / D * 1.5 + N * block * w * 4, (
            int(r["numel"]), str(r["op"]))


# ---------------------------------------------------------------------------
# The entry points.


@functools.cache
def jax_entries():
    """``bench.py``'s models through the JAX package's distributed
    functions at the entry points' small sizes."""
    mesh = jmesh()
    x = jnp.linspace(0.0, 10.0, 256)
    y = jnp.sin(x) + 0.3 * jnp.cos(3.2 * x)

    def nlml(ell):
        K = jp.sharded_gram(sj.EQ().stretch(ell), x[:, None], mesh, noise=0.1)
        return jp.dist_nlml(K, y, mesh)

    out = dict(zip(("nlml", "nlml_grad"), jax.jit(jax.value_and_grad(nlml))(2.0)))
    r = np.random.RandomState(1)
    xs = np.sort(r.rand(5000)) * 10
    ys = np.sin(xs) + 0.1 * r.randn(5000)
    z = jnp.linspace(0.0, 10.0, 16)[:, None]
    out["elbo"], out["elbo_grad"] = jax.jit(jax.value_and_grad(lambda ell: jp.dist_elbo(
        sj.EQ().stretch(ell), z, jnp.asarray(xs)[:, None], jnp.asarray(ys), 0.1, mesh)))(1.0)
    out["mean"], out["var"] = jax.jit(lambda x, y, xn: jp.dist_posterior_predict(
        sj.EQ().stretch(2.0), x, y, xn, 0.1, mesh))(
        x[:, None], y, jnp.linspace(0.0, 10.0, 64)[:, None])
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("D", DS)
def test_entry_points_match_the_jax_functions(D, tmp_path_factory):
    """``entry.dist_nlml_16k``, ``dist_elbo_1m`` and ``dist_predict_16k`` at
    small sizes against the JAX package's distributed functions on
    ``bench.py``'s models (``sparse_1m_inputs``' data is ``bench_dist_elbo_1m``'s
    recipe at N = 5000, M = 16)."""
    res = port("entries", D, tmp_path_factory)
    j = jax_entries()
    close(replicated(res, "nlml"), j["nlml"], VALUE_RTOL, "nlml")
    close(replicated(res, "nlml_value_only"), j["nlml"], VALUE_RTOL, "nlml value only")
    close(replicated(res, "nlml_grad"), j["nlml_grad"], GRAD_RTOL, "nlml grad")
    close(replicated(res, "elbo"), j["elbo"], VALUE_RTOL, "elbo")
    close(replicated(res, "elbo_grad"), j["elbo_grad"], GRAD_RTOL, "elbo grad")
    close(replicated(res, "mean"), j["mean"], VALUE_RTOL, "mean")
    close(replicated(res, "var"), j["var"], VALUE_RTOL, "var")


# ---------------------------------------------------------------------------
# F5: the gradients of the public factor, solve and posteriors.


def sym(a):
    """The symmetric part: the Cholesky's derivative is defined on symmetric
    directions. The port's adjoint is the symmetric one (Murray's); the
    JAX package's loops put theirs on the entries they read, which agrees
    with it on every symmetric direction."""
    a = np.asarray(a)
    return 0.5 * (a + a.T)


@functools.cache
def jax_f5():
    mesh = jmesh()
    out = {}
    for key, n, seed, block, rec in W.F5_FACTORS:
        W1, W2 = W.weights(n, n, seed + 100), W.weights(n, n, seed + 200)
        K = jnp.asarray(W.psd(n, seed))
        L = jnp.asarray(np.linalg.cholesky(W.psd(n, seed)))
        B = jnp.asarray(W.weights(n, 5, seed + 300))
        with _RecBase(rec):
            out[f"chol_{key}"] = sym(jax.jit(jax.grad(
                lambda K: jnp.sum(W1 * jp.dist_cholesky(K, mesh, block=block))))(K))

            def with_inv(K):
                L, Linv = jp.dist_cholesky_with_inv(K, mesh, block=block)
                return jnp.sum(W1 * L) + jnp.sum(W2 * Linv)

            out[f"inv_{key}"] = sym(jax.jit(jax.grad(with_inv))(K))
            gL, gB = jax.jit(jax.grad(lambda L, B: jnp.sum(
                W1[:, :5] * jp.dist_solve_lower(L, B, mesh, block=block)), argnums=(0, 1)))(L, B)
            out[f"solve_L_{key}"], out[f"solve_B_{key}"] = np.asarray(gL), np.asarray(gB)
    out["chol_pad"] = sym(jax.jit(jax.grad(lambda K: jnp.sum(
        W.weights(5, 5, 133) * jp.dist_cholesky(K, mesh, block=8))))(jnp.asarray(W.psd(5, 33))))
    x, y = W.nlml_data(64)

    def post(s, noise, y, xn):
        mean, var = jp.dist_posterior_predict(sj.EQ().stretch(s), jnp.asarray(x)[:, None], y,
                                              xn[:, None], noise, mesh, block=8)
        return jnp.sum(mean) + jnp.sum(var)

    gs = jax.jit(jax.grad(post, argnums=(0, 1, 2, 3)))(
        1.3, 0.1, jnp.asarray(y), jnp.linspace(0.0, 10.0, 17))
    for name, g in zip(("s", "noise", "y", "x_new"), gs):
        out[f"post_{name}"] = np.asarray(g)
    x, y, z = W.elbo_data(64, 8)
    for method in METHODS:
        def sparse(s, z, noise, method=method):
            mean, var = jp.dist_sparse_posterior(
                sj.EQ().stretch(s), z[:, None], jnp.asarray(x)[:, None], jnp.asarray(y), noise,
                jnp.linspace(-1.0, 11.0, 17)[:, None], mesh, method=method)
            return jnp.sum(mean) + jnp.sum(var)

        gs = jax.jit(jax.grad(sparse, argnums=(0, 1, 2)))(1.3, jnp.asarray(z), 0.1)
        for name, g in zip(("s", "z", "noise"), gs):
            out[f"sparse_{method}_{name}"] = np.asarray(g)
    return out


@pytest.mark.parametrize("D", DS)
@pytest.mark.parametrize("key", ["loop", "rec"])
@pytest.mark.parametrize("what", ["chol", "inv", "solve_L", "solve_B"])
def test_dist_factor_and_solve_gradients(D, key, what, tmp_path_factory):
    """F5: the gradients of ``dist_cholesky`` (of ``sum(W o L)``),
    ``dist_cholesky_with_inv`` (of ``sum(W1 o L) + sum(W2 o L^{-1})``),
    both in the replicated ``K``, and of ``dist_solve_lower`` (of ``sum(V o
    X)``) in ``L`` and ``B``, through the panel loop and the recursion
    (``_REC_BASE`` 64), against ``jax.grad`` of the JAX functions."""
    res = port("f5", D, tmp_path_factory)
    close(replicated(res, f"{what}_{key}"), jax_f5()[f"{what}_{key}"], GRAD_RTOL, what)


@pytest.mark.parametrize("D", DS)
def test_dist_cholesky_padded_gradient(D, tmp_path_factory):
    """F5 through the identity padding: N = 5 at D = 2 and 4, the factor
    gathered whole by ``gather_from_mesh``."""
    res = port("f5", D, tmp_path_factory)
    close(replicated(res, "chol_pad"), jax_f5()["chol_pad"], GRAD_RTOL)


@pytest.mark.parametrize("D", DS)
@pytest.mark.parametrize("name", ["s", "noise", "y", "x_new"])
def test_dist_posterior_gradient(D, name, tmp_path_factory):
    """F5: d/d(s, noise, y, x_new) of ``sum(mean) + sum(var)`` for an EQ
    stretched by s = 1.3 at n = 64 and 17 points, against ``jax.grad``
    (d/ds: -0.12473, as the single-device posterior's)."""
    res = port("f5", D, tmp_path_factory)
    close(replicated(res, f"post_{name}"), jax_f5()[f"post_{name}"], GRAD_RTOL, name)


@pytest.mark.parametrize("D", DS)
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("name", ["s", "z", "noise"])
def test_dist_sparse_posterior_gradient(D, method, name, tmp_path_factory):
    """F5: the same for the sparse posterior with 8 inducing points, VFE,
    FITC and DTC."""
    res = port("f5", D, tmp_path_factory)
    key = f"sparse_{method}_{name}"
    close(replicated(res, key), jax_f5()[key], GRAD_RTOL, key)


@pytest.mark.parametrize("D", DS)
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("name", ["mean", "var", "s", "z", "noise", "x_new"])
def test_sparse_posterior_replicated_by_construction(D, method, name, tmp_path_factory):
    """F6: the sparse posterior's outputs and gradients are rank 0's on
    every rank, bit for bit, also where every rank but 0 rounds its own
    replicated work differently (case ``f6``: a nudged triangular solve);
    and the nudge moves them by no more than rounding."""
    res = port("f6", D, tmp_path_factory)
    key = f"{method}_{name}"
    plain, nudged = replicated(res, f"plain_{key}"), replicated(res, f"nudged_{key}")
    close(nudged, plain, 1e-12, key)


@pytest.mark.parametrize("D", DS)
def test_inplace_collective_under_gradient_raises(D, tmp_path_factory):
    """A collective on an operand that requires a gradient raises instead
    of cutting or corrupting the gradient."""
    for r in port("f5", D, tmp_path_factory):
        assert "no autograd kernel" in str(r["inplace_raised"])


def test_every_collective_refuses_a_gradient():
    """Each collective of ``_comm.py`` raises under a gradient, and runs
    under ``torch.no_grad()``."""
    import torch

    import stheno_torch.parallel as P
    from stheno_torch.parallel import _comm

    ax = _comm.MeshAxis(P.make_data_mesh(), "data")
    calls = (lambda t: _comm.all_reduce(t, ax), lambda t: _comm.reduce_to(t, 0, ax),
             lambda t: _comm.broadcast_from(t, 0, ax), lambda t: _comm.all_gather_rows(t, ax),
             lambda t: _comm.all_to_all_rows(t, ax))
    for call in calls:
        t = torch.ones(2, 3, dtype=torch.float64, requires_grad=True) * 1.0
        with pytest.raises(RuntimeError, match="no autograd kernel"):
            call(t)
        with torch.no_grad():
            call(t.clone())
