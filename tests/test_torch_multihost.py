"""Two-process smoke test of the port's process groups, mirroring the first
half of ``tests/parallel/test_multihost.py``: two spawned processes
(``tests/torch_parallel_worker.py``, suite ``multihost``) join one gloo group
through ``initialize_hosts`` over a ``FileStore`` (no port), call it again
(a no-op), check that an explicit two-process cluster which cannot form
raises, build ``make_hybrid_mesh(chains=2)`` and sum across the process
boundary over the chain axis. The iterative half waits for
``ROADMAP.md`` item 12b."""

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
