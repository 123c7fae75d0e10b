"""Parity of the port's 2-D block-cyclic path
(``stheno_torch/parallel/cholesky2d.py``) with the JAX package's
(``stheno_tpu/parallel/cholesky2d.py``), mirroring
``tests/parallel/test_cholesky2d.py`` and the 2-D test of
``tests/parallel/test_distributed.py``.

The port runs on the 1 x 1 grid in this process, on 1 x 2 in the two-rank
pool and on 1 x 4 and 2 x 2 in the four-rank pool of
``tests/torch_parallel_worker.py`` (suite ``parallel``), and on 2 x 4, the
one shape where ``c / r > 1`` and ``r > 1``, in an eight-rank pool (suite
``grid8``). The 2 x 4 grid runs the cases whose code depends on that
(``SHORT_GRID`` there: the relayout, the loop's re-index, the recursion's
transposes and SUMMA products, the factor's and the NLML's gradients, the
entry point); the clipped block, the realistic NLML, the solves at N =
512, the FLOP counts and the largest tensor run on the other grids. The
JAX side runs here once per reference, on the 2 x 4 grid of the 8-device
CPU mesh of ``tests/conftest.py``, and every grid is held to it: values to
1e-10 and gradients to 1e-8 relative to the largest entry, every rank's
replicated results the same to the bit."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import stheno_tpu as sj
import stheno_tpu.parallel as jp
import stheno_tpu.parallel.cholesky2d as c2d
import tests.torch_parallel_worker as W
from tests.test_torch_helpers import torch_cpu  # noqa: F401
from tests.test_torch_parallel import GRAD_RTOL, VALUE_RTOL, _RecBase, close, jax_f5, replicated

GRIDS = ("1x1", "1x2", "1x4", "2x2", "2x4")
#: The grids that run every case (all but ``W.SHORT_GRID``).
FULL_GRIDS = GRIDS[:-1]


@functools.cache
def _local():
    import stheno_torch.parallel as P

    mesh = P.make_data_mesh()
    return {k: [W.SUITES["parallel"][k](mesh)] for k in ("grid", "grid_entries")}


def port(case, grid, tmp_path_factory):
    """``[rank 0's dict, ...]`` of ``case`` on ``grid``."""
    r, c = W.grid_of(grid)
    if r * c == 1:
        return _local()[case]
    suite = "grid8" if r * c == 8 else "parallel"
    return W.results(suite, r * c, tmp_path_factory)[case]


@functools.cache
def jmesh():
    return c2d.make_grid_mesh(2, 4)


class _RecBase2d(_RecBase):
    def __enter__(self):
        self.prev, c2d._REC_BASE = c2d._REC_BASE, self.n

    def __exit__(self, *exc):
        c2d._REC_BASE = self.prev


def _eq_gram(x, ell):
    return jnp.asarray(sj.dense(sj.pairwise(sj.EQ().stretch(ell), x[:, None]))) + 0.1 * jnp.eye(
        x.shape[0])


@functools.cache
def jax_2d():
    """The JAX references, each computed once, on the 2 x 4 grid."""
    mesh = jmesh()
    out = {}
    K = jnp.asarray(np.random.RandomState(3).randn(64, 64))
    out["cyclic"] = np.asarray(c2d._to_cyclic(c2d._to_cyclic(K, 16, 2, 0), 16, 4, 1))
    loop = jax.jit(lambda K: c2d._dist_cholesky_2d_loop(K, mesh, "rows", "cols", 8))
    for r, c in ((1, 1), (1, 2), (1, 4), (2, 2), (2, 4)):
        out[f"loop_{r}x{c}"] = np.asarray(loop(jnp.asarray(W.psd(96, r * 10 + c))))
    out["clip"] = np.asarray(jax.jit(lambda K: jp.dist_cholesky_2d(K, mesh, block=256))(
        jnp.asarray(W.psd(64, 5))))
    _, n, seed, block, rec = W.F5_FACTORS[1]
    W1 = W.weights(n, n, seed + 100)
    with _RecBase2d(rec):
        out["rec"] = np.asarray(jax.jit(lambda K: jp.dist_cholesky_2d(K, mesh, block=8))(
            jnp.asarray(W.psd(128, 7))))
        L, Linv = jax.jit(lambda K: jp.dist_cholesky_2d_with_inv(K, mesh, block=8))(
            jnp.asarray(W.psd(128, 11)))
        out["inv_L"], out["inv_Linv"] = np.asarray(L), np.asarray(Linv)
        g = jax.jit(jax.grad(lambda K: jnp.sum(W1 * jp.dist_cholesky_2d(K, mesh, block=block))))(
            jnp.asarray(W.psd(n, seed)))
        out["chol_grad"] = 0.5 * (np.asarray(g) + np.asarray(g).T)
        # Every array enters the jitted functions as an argument: a program
        # that closed over the device array K once deadlocked XLA's CPU
        # collectives (devices waiting at different collectives).
        x = jnp.linspace(0.0, 10.0, 128)

        def nlml(log_ell, y, x):
            return jp.dist_nlml_2d(_eq_gram(x, jnp.exp(log_ell)), y, mesh, block=8)

        v, (ge, gy) = jax.jit(jax.value_and_grad(nlml, argnums=(0, 1)))(0.3, jnp.sin(x), x)
        out["nlml_value"], out["nlml_grad_ell"], out["nlml_grad_y"] = (
            np.asarray(a) for a in (v, ge, gy))
        K = _eq_gram(x, jnp.exp(0.3))
        gK = jax.jit(jax.grad(lambda K, y: jp.dist_nlml_2d(K, y, mesh, block=8)))(K, jnp.sin(x))
        out["nlml_grad_K"] = np.asarray(gK)
        v, gY = jax.jit(jax.value_and_grad(lambda Y, K: jp.dist_nlml_2d(K, Y, mesh, block=8)))(
            jnp.asarray(W.weights(128, 3, 35)), K)
        out["nlml_cols_value"], out["nlml_cols_grad_y"] = np.asarray(v), np.asarray(gY)
    x = jnp.linspace(0.0, 10.0, 1024)
    y = jnp.sin(x) + 0.1 * jnp.asarray(np.random.RandomState(4).randn(1024))
    out["realistic"] = np.asarray(jax.jit(lambda K, y: jp.dist_nlml_2d(K, y, mesh, block=32))(
        _eq_gram(x, 1.3), y))
    L = jnp.asarray(np.linalg.cholesky(W.psd(512, 21)))
    rhs = jnp.asarray(W.weights(512, 8, 22))
    solve = jax.jit(lambda L, B: c2d._solve_lower_2d(L, B, mesh, "rows", "cols", 64))
    for key, B in (("wide", rhs), ("thin", rhs[:, :1])):
        out[f"solve_{key}"] = np.asarray(solve(L, B))
    out["solve_untileable"] = np.asarray(c2d._solve_lower_2d(
        jnp.asarray(np.linalg.cholesky(W.psd(5, 23))), jnp.asarray(W.weights(5, 4, 24)), mesh,
        "rows", "cols", 256))
    return out


def _key(res, grid, name):
    """The ``grid:``/``gridrows:`` key of ``name`` in the ranks' results."""
    for pre in ("grid:", "gridrows:"):
        if f"{pre}{grid}/{name}" in res[0]:
            return f"{pre}{grid}/{name}"
    raise KeyError(name)


def sharded(res, grid, name):
    return W.grid(res, _key(res, grid, name))


# ---------------------------------------------------------------------------
# Layout and factor.


@pytest.mark.parametrize("grid", GRIDS)
def test_cyclic_relayout_roundtrip(grid, tmp_path_factory):
    """Block order to cyclic tiles (``_retile`` over each axis) and back
    gives the matrix to the bit; the cyclic tiles equal those indexed out
    of a replicated matrix, and the JAX package's ``_to_cyclic`` over both
    axes, blocked over the grid."""
    res = port("grid", grid, tmp_path_factory)
    r, c = W.grid_of(grid)
    for x in res:
        assert bool(x[f"{grid}/relayout_back"]) and bool(x[f"{grid}/relayout_index"])
    K = np.random.RandomState(3).randn(64, 64)
    want = c2d._to_cyclic(c2d._to_cyclic(jnp.asarray(K), 16, r, 0), 16, c, 1)
    np.testing.assert_array_equal(sharded(res, grid, "cyclic"), np.asarray(want))


@pytest.mark.parametrize("grid", GRIDS)
def test_dist_cholesky_2d_loop_parity(grid, tmp_path_factory):
    """The block-cyclic loop alone at N = 96, block 8."""
    res = port("grid", grid, tmp_path_factory)
    close(sharded(res, grid, "loop"), jax_2d()[f"loop_{grid}"], VALUE_RTOL)


@pytest.mark.parametrize("grid", FULL_GRIDS)
def test_dist_cholesky_2d_uneven_block_clips(grid, tmp_path_factory):
    """Block 256 at N = 64 clips to fit the grid."""
    res = port("grid", grid, tmp_path_factory)
    close(sharded(res, grid, "clip"), jax_2d()["clip"], VALUE_RTOL)


@pytest.mark.parametrize("grid", GRIDS)
def test_dist_cholesky_2d_recursive_parity(grid, tmp_path_factory):
    """One level of the recursion (``_REC_BASE`` 64 at N = 128, block 8)."""
    res = port("grid", grid, tmp_path_factory)
    close(sharded(res, grid, "rec"), jax_2d()["rec"], VALUE_RTOL)


def test_dist_cholesky_2d_rejects_bad_mesh(tmp_path_factory):
    """A 2 x 1 grid (rows not dividing columns) raises the JAX function's
    ``ValueError``."""
    res = W.results("parallel", 2, tmp_path_factory)["grid"]
    for x in res:
        assert "multiple" in str(x["bad_mesh_raised"])


@pytest.mark.parametrize("grid", FULL_GRIDS[1:])
def test_dist_cholesky_2d_work_balance(grid, tmp_path_factory):
    """Each rank's matmul FLOPs (``FlopCounterMode``) in the loop at N = 512,
    block 64, are at most ``1/(r c) + 0.05`` of the 1 x 1 grid's."""
    one = float(port("grid", "1x1", tmp_path_factory)[0]["1x1/flops_loop"])
    r, c = W.grid_of(grid)
    for x in port("grid", grid, tmp_path_factory):
        assert float(x[f"{grid}/flops_loop"]) <= (1 / (r * c) + 0.05) * one


@pytest.mark.parametrize("grid", GRIDS)
def test_dist_cholesky_2d_with_inv_parity(grid, tmp_path_factory):
    res = port("grid", grid, tmp_path_factory)
    L, Linv = sharded(res, grid, "inv_L"), sharded(res, grid, "inv_Linv")
    close(L, jax_2d()["inv_L"], VALUE_RTOL, "L")
    close(Linv, jax_2d()["inv_Linv"], VALUE_RTOL, "Linv")
    np.testing.assert_allclose(Linv @ L, np.eye(128), atol=1e-10)


@pytest.mark.parametrize("grid", GRIDS)
def test_dist_cholesky_2d_gradients(grid, tmp_path_factory):
    """The factor's gradient (Murray's adjoint) against ``jax.grad`` of
    ``dist_cholesky_2d``, and the factor-and-inverse's against ``jax.grad``
    of the 1-D ``dist_cholesky_with_inv`` on the same matrix and weights,
    both through the recursion (symmetric parts, as in F5's tests)."""
    res = port("grid", grid, tmp_path_factory)
    close(replicated(res, f"{grid}/chol_grad"), jax_2d()["chol_grad"], GRAD_RTOL, "chol")
    close(replicated(res, f"{grid}/inv_grad"), jax_f5()["inv_rec"], GRAD_RTOL, "with inv")


# ---------------------------------------------------------------------------
# The NLML and the solve.


@pytest.mark.parametrize("grid", GRIDS)
def test_dist_nlml_2d_parity_and_grad(grid, tmp_path_factory):
    """Value and gradients in log ell and y (``_REC_BASE`` 64, N = 128,
    block 8), from a replicated Gram; and from the Gram as a DTensor in
    block order, its gradient coming back through the relayout."""
    res = port("grid", grid, tmp_path_factory)
    j = jax_2d()
    close(replicated(res, f"{grid}/nlml_value"), j["nlml_value"], VALUE_RTOL, "value")
    close(replicated(res, f"{grid}/nlml_grad_ell"), j["nlml_grad_ell"], GRAD_RTOL, "ell")
    close(replicated(res, f"{grid}/nlml_grad_y"), j["nlml_grad_y"], GRAD_RTOL, "y")
    close(replicated(res, f"{grid}/nlml_dtensor_value"), j["nlml_value"], VALUE_RTOL, "DTensor")
    close(sharded(res, grid, "nlml_dtensor_grad_K"), j["nlml_grad_K"], GRAD_RTOL, "K")


@pytest.mark.parametrize("grid", GRIDS)
def test_dist_nlml_2d_multi_column(grid, tmp_path_factory):
    """``y`` of three columns: the sum of three NLMLs sharing ``K``, value
    and gradient in ``y``."""
    res = port("grid", grid, tmp_path_factory)
    j = jax_2d()
    close(replicated(res, f"{grid}/nlml_cols_value"), j["nlml_cols_value"], VALUE_RTOL, "value")
    close(replicated(res, f"{grid}/nlml_cols_grad_y"), j["nlml_cols_grad_y"], GRAD_RTOL, "y")


@pytest.mark.parametrize("grid", FULL_GRIDS)
def test_dist_nlml_2d_value_only_prunes_inverse(grid, tmp_path_factory):
    """Under ``torch.no_grad()`` at N = 256, block 16, the NLML's matmul
    FLOPs are at most 1.3 times the loop's, and the value and gradient's
    more than twice the value's: it pays for the inverse."""
    for x in port("grid", grid, tmp_path_factory):
        loop, val = float(x[f"{grid}/flops_loop_256"]), float(x[f"{grid}/flops_value"])
        assert val <= 1.3 * loop, (val, loop)
        assert float(x[f"{grid}/flops_value_grad"]) > 2.0 * val


@pytest.mark.parametrize("grid", FULL_GRIDS)
@pytest.mark.parametrize("key", ["wide", "thin"])
def test_solve_lower_2d_parity(grid, key, tmp_path_factory):
    """``_solve_lower_2d`` at N = 512, block 64, with 8 right-hand sides and
    with one (zero-padded to the column axis)."""
    res = port("grid", grid, tmp_path_factory)
    close(sharded(res, grid, f"solve_{key}"), jax_2d()[f"solve_{key}"], VALUE_RTOL)


@pytest.mark.parametrize("grid", GRIDS)
def test_solve_lower_2d_untileable(grid, tmp_path_factory):
    """N = 5, which no tile of the grid fits (the JAX function's: no row
    block of the 2 x 4 grid): ``L`` replicated."""
    res = port("grid", grid, tmp_path_factory)
    close(replicated(res, f"{grid}/solve_untileable"), jax_2d()["solve_untileable"], VALUE_RTOL)


@pytest.mark.parametrize("grid", FULL_GRIDS)
def test_dist_nlml_2d_realistic(grid, tmp_path_factory):
    """N = 1024, block 32: a 32 x 32 tile grid."""
    res = port("grid", grid, tmp_path_factory)
    close(replicated(res, f"{grid}/realistic"), jax_2d()["realistic"], VALUE_RTOL)


@pytest.mark.parametrize("grid", FULL_GRIDS)
def test_no_rank_holds_an_n_by_n_array_2d(grid, tmp_path_factory):
    """The largest tensor a rank creates in a value and gradient through
    ``cyclic_gram`` at N = 512 (block 32, through the recursion and its
    loop) stays below ``1.5 N^2 w / (r c) + 4 N block w`` bytes."""
    N, block, w = 512, 32, 8
    r, c = W.grid_of(grid)
    for x in port("grid", grid, tmp_path_factory):
        assert int(x[f"{grid}/largest"]) * w < 1.5 * N * N * w / (r * c) + 4 * N * block * w, (
            int(x[f"{grid}/largest"]), str(x[f"{grid}/largest_op"]))


@functools.cache
def jax_entry_2d():
    """``bench.py``'s dense NLML model through the JAX package's
    ``dist_nlml_2d`` at N = 256 (``__graft_entry__.py``'s ``train_step_2d``
    on this model)."""
    x = jnp.linspace(0.0, 10.0, 256)
    y = jnp.sin(x) + 0.3 * jnp.cos(3.2 * x)

    def nlml(ell, x, y):
        K = jnp.asarray(sj.dense(sj.pairwise(sj.EQ().stretch(ell), x[:, None])))
        return jp.dist_nlml_2d(K + 0.1 * jnp.eye(256), y, jmesh())

    return tuple(np.asarray(a) for a in jax.jit(jax.value_and_grad(nlml))(2.0, x, y))


@pytest.mark.parametrize("grid", GRIDS)
def test_entry_point_matches_the_jax_function(grid, tmp_path_factory):
    """``entry.dist_nlml_2d_16k`` at N = 256 (the Gram's tiles built on each
    rank's cyclic points) against the JAX package's ``dist_nlml_2d`` on the
    same model; the value-only call equals the value."""
    res = port("grid_entries", grid, tmp_path_factory)
    v, g = jax_entry_2d()
    close(replicated(res, f"{grid}/value"), v, VALUE_RTOL, "value")
    close(replicated(res, f"{grid}/value_only"), v, VALUE_RTOL, "value only")
    close(replicated(res, f"{grid}/grad"), g, GRAD_RTOL, "grad")
