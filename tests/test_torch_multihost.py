"""Two-process smoke test of the port's process groups, mirroring the first
half of ``tests/parallel/test_multihost.py``: two spawned processes
(``tests/torch_parallel_worker.py``, suite ``multihost``) join one gloo group
through ``initialize_hosts`` over a ``FileStore`` (no port), call it again
(a no-op), check that an explicit two-process cluster which cannot form
raises, build ``make_hybrid_mesh(chains=2)`` and sum across the process
boundary over the chain axis. The iterative half: on a data mesh over the
two processes, the row-sharded matvec against a dense numpy product
(1e-8) and the stochastic NLML (``sharded_iterative_nlml``, its row blocks
split across the process boundary) converged and within one nat of the
dense NLML, both the same on the two processes."""

import numpy as np

import tests.torch_parallel_worker as W


def test_two_process_distributed_smoke(tmp_path_factory):
    res = W.results("multihost", 2, tmp_path_factory)["multihost"]
    assert len(res) == 2
    for r in res:
        assert int(r["world"]) == 2
        assert tuple(r["names"]) == ("chain", "data") and tuple(r["shape"]) == (2, 1)
        # The chain axis spans the two processes: [0, 1] + [10, 11].
        np.testing.assert_array_equal(r["sum"], [[10.0], [12.0]])


def test_two_process_iterative_path(tmp_path_factory):
    res = W.results("multihost", 2, tmp_path_factory)["multihost"]
    x, v, y = W.multihost_iterative_data()
    K = np.exp(-0.5 * (x[:, None] - x[None, :]) ** 2) + 0.1 * np.eye(x.shape[0])
    _, logdet = np.linalg.slogdet(K)
    nlml_ref = 0.5 * (logdet + y @ np.linalg.solve(K, y) + x.shape[0] * np.log(2 * np.pi))
    for key in ("matvec", "nlml", "converged"):
        np.testing.assert_array_equal(res[1][key], res[0][key], err_msg=key)
    r = res[0]
    assert np.linalg.norm(r["matvec"] - K @ v) < 1e-8
    assert bool(r["converged"])
    assert abs(float(r["nlml"]) - nlml_ref) < 1.0, (float(r["nlml"]), nlml_ref)
