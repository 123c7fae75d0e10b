"""The port's communication volume (``stheno_torch.utils.comm``), mirroring
the 1-D half of ``tests/parallel/test_comm_volume.py``'s
``test_comm_volume_matches_model_8dev``: at D = 4, N = 256 and block 32,
the bytes that ``collective_traffic`` records for the panel loop's
collectives equal the ring model ``nb (D - 1)/D N b w`` exactly, and equal
what the JAX package's ``collective_traffic`` reads out of the compiled
loop on a 4-device mesh. The port runs in four spawned gloo workers
(``tests/torch_parallel_worker.py``, suite ``comm``). The 2-D and matvec
halves wait for ``ROADMAP.md`` item 12b."""

import jax
import jax.numpy as jnp
import numpy as np

import stheno_tpu.parallel.cholesky as c1d
import tests.torch_parallel_worker as W
from stheno_tpu.parallel import make_data_mesh
from stheno_tpu.utils.comm import collective_traffic

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
