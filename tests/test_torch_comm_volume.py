"""The port's communication volume (``stheno_torch.utils.comm``), mirroring
the 1-D half of ``tests/parallel/test_comm_volume.py``'s
``test_comm_volume_matches_model_8dev``: at D = 4, N = 256 and block 32,
the bytes that ``collective_traffic`` records for the panel loop's
collectives equal the ring model ``nb (D - 1)/D N b w`` exactly, and equal
what the JAX package's ``collective_traffic`` reads out of the compiled
loop on a 4-device mesh. The port runs in four spawned gloo workers
(``tests/torch_parallel_worker.py``, suite ``comm``).

The 2-D half: the block-cyclic loop's recorded bytes at N = 256, block
32, equal the 2-D ring model of ``tests/parallel/test_comm_volume.py``'s
``_models`` exactly on a 2 x 4 grid (the eight-rank pool, suite ``grid8``)
and a 2 x 2 grid (suite ``comm``), and the JAX package's HLO-measured
bytes on the same grids. The 32-rank ``test_comm_volume_4x8_pod_shape``
is not mirrored: 32 gloo processes on this CPU do not fit the test run's
clock.

The sharded matvec (``parallel/iterative.py``): at D = 4, N = 256, p = 4,
float64, one all-gather of the ``(N, p)`` result per call,
``(D - 1)/D N p w`` bytes a rank, for a terminal call too, where the JAX
package moves none for a terminal call and one gather for two chained
calls (its test of the same name, here at 4 devices)."""

import jax
import jax.numpy as jnp
import numpy as np

import pytest

import stheno_tpu.parallel.cholesky as c1d
import stheno_tpu.parallel.cholesky2d as c2d
import tests.torch_parallel_worker as W
from stheno_tpu.parallel import make_data_mesh
from stheno_tpu.utils.comm import collective_traffic
from tests.parallel.test_comm_volume import _models

N, B, D, W_BYTES = 256, 32, 4, 8


def _loop_bytes(traffic):
    """Bytes from collectives run more than once (the per-panel cost)."""
    return sum(b * m for _, _, b, m in traffic["instructions"] if m > 1)


def test_comm_volume_matches_model_4dev(tmp_path_factory):
    model = (N // B) * (D - 1) / D * N * B * W_BYTES
    res = W.results("comm", D, tmp_path_factory)["comm_volume"]
    for r in res:
        assert float(r["loop_bytes"]) == model, (float(r["loop_bytes"]), model)
        # One all-gather per panel, from one site, and nothing else.
        (only,) = r["instructions"]
        site, kind, per_exec, executions = str(only).split("|")
        assert "_dist_cholesky_loop" in site and kind == "all-gather"
        assert int(executions) == N // B and float(per_exec) * (N // B) == model
        assert float(r["total"]) == model
    mesh = make_data_mesh(D)
    K = jnp.asarray(W.psd(N))
    compiled = jax.jit(lambda K: c1d._dist_cholesky_loop(K, mesh, "data", B)).lower(K).compile()
    np.testing.assert_allclose(_loop_bytes(collective_traffic(compiled)), model, rtol=1e-12)


@pytest.mark.parametrize("r,c,suite", [(2, 4, "grid8"), (2, 2, "comm")])
def test_comm_volume_2d_matches_model(r, c, suite, tmp_path_factory):
    """The 2-D loop: per panel, the diagonal tile all-reduced over the row
    axis and then the column axis, ``P_rows`` over the column axis and
    ``Q_full`` over the row axis, each from its own site, and nothing
    else; every rank's loop bytes equal ``_models(N, b, D, r, c)[1]``
    exactly, and the JAX package's HLO-measured bytes to 1e-6."""
    D = r * c
    model = _models(N, B, D, r, c)[1]
    for x in W.results(suite, D, tmp_path_factory)["comm_volume_2d"]:
        assert tuple(x["grid"]) == (r, c)
        assert float(x["loop_bytes"]) == model, (float(x["loop_bytes"]), model)
        sites = [str(i).split("|") for i in x["instructions"]]
        assert len(sites) == 4 and all(
            "_cyclic_loop" in s and k == "all-reduce" and int(n) == N // B for s, k, _, n in sites)
    K = jnp.asarray(W.psd(N))
    mesh = c2d.make_grid_mesh(r, c)
    compiled = jax.jit(lambda K: c2d._dist_cholesky_2d_loop(K, mesh, "rows", "cols", B)).lower(
        K).compile()
    np.testing.assert_allclose(_loop_bytes(collective_traffic(compiled)), model, rtol=1e-6)


def test_sharded_matvec_comm_matches_model(tmp_path_factory):
    """The port's model: every call of ``sharded_kernel_matvec`` gathers
    once, ``(D - 1)/D N p w`` bytes a rank, so one call costs the model and
    two chained calls twice it, all in all-gathers. The JAX package's
    compiled matvec: a terminal call moves nothing, two chained calls the
    model once."""
    from stheno_tpu import EQ
    from stheno_tpu.parallel import sharded_kernel_matvec

    n, p = 256, 4
    model = (D - 1) / D * n * p * W_BYTES
    for r in W.results("comm", D, tmp_path_factory)["comm_matvec"]:
        assert float(r["one"]) == float(r["one_gather"]) == model, (float(r["one"]), model)
        assert float(r["two"]) == 2 * model
        assert set(str(k) for k in r["kinds"]) == {"all-gather"}
    x = jnp.linspace(0.0, 10.0, n)
    v = jnp.asarray(np.random.RandomState(1).randn(n, p))
    mesh = make_data_mesh(D)

    def mv(x, vv):
        return sharded_kernel_matvec(EQ(), x, vv, mesh, noise=0.1, block=64)

    assert collective_traffic(jax.jit(mv).lower(x, v).compile())["total"] == 0.0
    t2 = collective_traffic(jax.jit(lambda x, v: mv(x, mv(x, v))).lower(x, v).compile())
    np.testing.assert_allclose(t2["total"], model, rtol=1e-6)
