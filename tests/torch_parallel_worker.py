"""Worker processes of the distributed port's CPU tests
(``tests/test_torch_parallel.py``, ``test_torch_multihost.py`` and
``test_torch_comm_volume.py``). It imports neither ``jax`` nor
``stheno_tpu``; the tests hold what the workers return to the JAX package.

    python -m tests.torch_parallel_worker SUITE RANK WORLD STORE OUT

Each worker joins a gloo group of WORLD ranks through ``initialize_hosts``
over a ``FileStore`` at STORE (no port), runs every case of SUITE on a
data mesh of the group, and writes each case's result, a dict of numpy
arrays, to ``OUT/<case>.<RANK>.npz``. A failing case writes
``OUT/error.<RANK>.txt`` and exits 1. A key starting with ``rows:`` holds
this rank's row block of a row-sharded result; any other key a replicated
one.

:func:`results` runs a suite's pools (one per world size, all at once) once
per test session (under pytest-xdist one worker runs them and the others
wait on a lock and read their files) and :func:`run_suite` runs a suite in
the calling process at D=1.
"""

import contextlib
import datetime
import fcntl
import os
import pathlib
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]

#: Seconds a collective may wait before the group fails it.
COLLECTIVE_TIMEOUT_S = 60
#: Seconds a pool may take.
POOL_TIMEOUT_S = 240


def psd(n, seed=0):
    """``a a^T + n I`` for a standard normal ``a``, as the JAX tests make it."""
    r = np.random.RandomState(seed)
    a = r.randn(n, n)
    return a @ a.T + n * np.eye(n)


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def _np(t):
    """A result as numpy: a DTensor's local block, a tensor's values."""
    from torch.distributed.tensor import DTensor

    if isinstance(t, DTensor):
        t = t.to_local()
    return t.detach().cpu().numpy()


def _grads(val, leaves):
    return torch.autograd.grad(val, leaves)


@contextlib.contextmanager
def _rec_base(n):
    import stheno_torch.parallel.cholesky as pc

    prev = pc._REC_BASE
    pc._REC_BASE = n
    try:
        yield
    finally:
        pc._REC_BASE = prev


# ---------------------------------------------------------------------------
# The inputs shared with the JAX side.


def nlml_data(n, seed=None):
    """``x = linspace(0, 10, n)`` and ``y = sin x`` (plus ``0.1`` normal noise
    from ``RandomState(seed)`` when given)."""
    x = np.linspace(0.0, 10.0, n)
    y = np.sin(x)
    if seed is not None:
        y = y + 0.1 * np.random.RandomState(seed).randn(n)
    return x, y


def elbo_data(n, m):
    x = np.linspace(0.0, 10.0, n)
    return x, np.sin(x) + 0.1 * np.cos(5 * x), np.linspace(0.0, 10.0, m)


# ---------------------------------------------------------------------------
# Suite "parallel": tests/parallel/test_distributed.py's 1-D tests.


def _eq(log_ell, log_s2=None):
    from stheno_torch import EQ

    k = EQ().stretch(torch.exp(log_ell))
    return k if log_s2 is None else torch.exp(log_s2) * k


def case_factors(mesh):
    import stheno_torch.parallel as P

    out = {}
    for key, n, seed, block in (("128_b16", 128, 0, 16), ("64_b256", 64, 0, 256),
                                ("1024_b32", 1024, 11, 32), ("1100_b32", 1100, 12, 32)):
        out[f"rows:chol_{key}"] = _np(P.dist_cholesky(_t(psd(n, seed)), mesh, block=block))
    # N % D != 0 at D = 2 and 4: identity padding, the factor comes back whole.
    out["chol_1101_b32"] = _np(P.dist_cholesky(_t(psd(1101, 13)), mesh, block=32))
    out["chol_5"] = _np(P.dist_cholesky(_t(psd(5)), mesh))
    L, Linv = P.dist_cholesky_with_inv(_t(psd(192, 27)), mesh, block=8)
    out["rows:with_inv_L"], out["rows:with_inv_Linv"] = _np(L), _np(Linv)
    L = np.linalg.cholesky(psd(128, 1))
    B = np.random.RandomState(2).randn(128, 5)
    out["rows:solve"] = _np(P.dist_solve_lower(_t(L), _t(B), mesh, block=16))
    with _rec_base(64):
        out["rows:rec_chol"] = _np(P.dist_cholesky(_t(psd(128, 7)), mesh, block=8))
        L = np.linalg.cholesky(psd(128, 11))
        B = np.random.RandomState(12).randn(128, 7)
        out["rows:rec_solve"] = _np(P.dist_solve_lower(_t(L), _t(B), mesh, block=8))
        L, Linv = P.dist_cholesky_with_inv(_t(psd(128, 28)), mesh, block=8)
        out["rows:rec_with_inv_L"], out["rows:rec_with_inv_Linv"] = _np(L), _np(Linv)
        # h = 98: D = 2 halves once more, D = 4 falls back to the loop.
        out["rows:rec_chol_196"] = _np(P.dist_cholesky(_t(psd(196, 29)), mesh, block=8))
    return out


def case_untileable(mesh):
    import stheno_torch.parallel as P

    try:
        P.dist_solve_lower(torch.eye(5, dtype=torch.float64),
                           torch.ones(5, 1, dtype=torch.float64), mesh, block=8)
    except ValueError as e:
        return {"raised": np.array(str(e))}
    return {"raised": np.array("")}


def _nlml(log_ell, x, y, mesh, block, log_s2=None):
    import stheno_torch.parallel as P

    K = P.sharded_gram(_eq(log_ell, log_s2), _t(x)[:, None], mesh, noise=0.1)
    return P.dist_nlml(K, _t(y), mesh, block=block)


def case_nlml(mesh):
    import stheno_torch.parallel as P

    out = {}
    for key, n, seed, block, rec in (("64", 64, None, 8, None), ("1024", 1024, 3, 32, None),
                                     ("rec128", 128, None, 8, 64)):
        x, y = nlml_data(n, seed)
        p = torch.tensor(0.3, dtype=torch.float64, requires_grad=True)
        with _rec_base(rec or 2048):
            v = _nlml(p, x, y, mesh, block)
            (g,) = _grads(v, [p])
            with torch.no_grad():
                out[f"value_only_{key}"] = _np(_nlml(p, x, y, mesh, block))
        out[f"value_{key}"], out[f"grad_{key}"] = _np(v), _np(g)
    # The training step: value and gradient in log_ell and log_s2, twice
    # (the two runs must agree bitwise).
    x, y = nlml_data(64)
    for run in ("a", "b"):
        ps = [torch.tensor(v, dtype=torch.float64, requires_grad=True) for v in (0.1, 0.2)]
        v = _nlml(ps[0], x, y, mesh, 8, log_s2=ps[1])
        gs = _grads(v, ps)
        out[f"step_value_{run}"] = _np(v)
        out[f"step_grads_{run}"] = np.array([_np(g) for g in gs])
    # Every input's gradient: ell, s2, noise, x and y.
    x, y = nlml_data(64, 4)
    leaves = [_t(a).requires_grad_(True) for a in (0.3, 0.2, 0.1, x, y)]
    k = torch.exp(leaves[1]) * _eq(leaves[0])
    K = P.sharded_gram(k, leaves[3][:, None], mesh, noise=leaves[2])
    v = P.dist_nlml(K, leaves[4], mesh, block=8)
    out["all_value"] = _np(v)
    for name, g in zip(("ell", "s2", "noise", "x", "y"), _grads(v, leaves)):
        out[f"all_grad_{name}"] = _np(g)
    return out


def case_nlml_matrix(mesh):
    import stheno_torch.parallel as P

    K = _t(psd(64, 5)).requires_grad_(True)
    y1 = _t(np.random.RandomState(6).randn(64)).requires_grad_(True)
    out = {}
    (out["y1_grad"],) = (_np(g) for g in _grads(P.dist_nlml(K.detach(), y1, mesh, block=8), [y1]))
    y2 = y1.detach()[:, None].requires_grad_(True)
    (out["y2_grad"],) = (_np(g) for g in _grads(P.dist_nlml(K.detach(), y2, mesh, block=8), [y2]))
    K = _t(psd(64, 7)).requires_grad_(True)
    Y = _t(np.random.RandomState(8).randn(64, 3))
    v = P.dist_nlml(K, Y, mesh, block=8)
    out["joint_value"], out["joint_grad"] = _np(v), _np(_grads(v, [K])[0])
    v = sum(P.dist_nlml(K, Y[:, j], mesh, block=8) for j in range(3))
    out["cols_value"], out["cols_grad"] = _np(v), _np(_grads(v, [K])[0])
    return out


def case_multi_output(mesh):
    import stheno_torch.parallel as P
    from stheno_torch import EQ, GP, Measure, MultiOutputKernel

    n = 32
    x = _t(np.linspace(0.0, 10.0, n))
    m = Measure()
    f1 = GP(EQ(), measure=m)
    f2 = GP(EQ().stretch(0.5), measure=m) + 0.3 * f1
    K = P.sharded_gram(MultiOutputKernel(m, f1, f2), x, mesh, noise=0.1)
    y = torch.cat([torch.sin(x), torch.cos(x)])
    return {"shape": np.array(K.shape), "value": _np(P.dist_nlml(K, y, mesh, block=8))}


def case_posterior(mesh):
    import stheno_torch.parallel as P
    from stheno_torch import EQ

    out = {}
    for key, n, seed, m, block in (("64", 64, None, 17, 8), ("1024", 1024, 5, 256, 32)):
        x, y = nlml_data(n, seed)
        xn = np.linspace(0.0, 10.0, m) if n == 64 else np.linspace(-0.5, 10.5, m)
        mean, var = P.dist_posterior_predict(EQ(), _t(x)[:, None], _t(y), _t(xn)[:, None], 0.1,
                                             mesh, block=block)
        out[f"mean_{key}"], out[f"var_{key}"] = _np(mean), _np(var)
    return out


def case_elbo(mesh):
    import stheno_torch.parallel as P
    from stheno_torch import EQ

    out = {}
    x, y, z = elbo_data(64, 9)
    noise = 0.05 + 0.02 * np.cos(x) ** 2
    for method in ("vfe", "fitc", "dtc"):
        e = P.dist_elbo(1.3 * EQ().stretch(0.7), _t(z)[:, None], _t(x)[:, None], _t(y),
                        _t(noise), mesh, method=method)
        out[f"elbo_{method}"] = _np(e)
        xs = np.linspace(0.0, 10.0, 64)
        mean, var = P.dist_sparse_posterior(
            EQ().stretch(0.8), _t(z)[:, None], _t(xs)[:, None], _t(np.sin(xs)), 0.1,
            _t(np.linspace(-1.0, 11.0, 17))[:, None], mesh, method=method)
        out[f"post_mean_{method}"], out[f"post_var_{method}"] = _np(mean), _np(var)
    # Gradients: VFE, FITC and DTC in log_ell, log_s2, log_noise, z and y.
    x, y, z = elbo_data(48, 7)
    for method in ("vfe", "fitc", "dtc"):
        leaves = [_t(a).requires_grad_(True) for a in (0.2, 0.1, np.log(0.1), z, y)]
        k = torch.exp(leaves[1]) * _eq(leaves[0])
        e = P.dist_elbo(k, leaves[3][:, None], _t(x)[:, None], leaves[4],
                        torch.exp(leaves[2]), mesh, method=method)
        out[f"grad_value_{method}"] = _np(e)
        for name, g in zip(("ell", "s2", "noise", "z", "y"), _grads(e, leaves)):
            out[f"grad_{method}_{name}"] = _np(g)
    # N = 53: masked padding at D = 2 and 4.
    x, y, z = elbo_data(53, 7)
    out["elbo_53"] = _np(P.dist_elbo(EQ().stretch(0.8), _t(z)[:, None], _t(x)[:, None],
                                     _t(np.sin(x)), 0.1, mesh))
    return out


def case_hybrid(mesh):
    import torch.distributed as dist

    import stheno_torch.parallel as P
    from stheno_torch import EQ

    world = dist.get_world_size()
    chains = 2 if world % 2 == 0 else 1
    hybrid = P.make_hybrid_mesh(chains=chains)
    x, y = nlml_data(32)
    K = P.sharded_gram(EQ(), _t(x)[:, None], hybrid, noise=0.1)
    out = {"shape": np.array(hybrid.mesh.shape),
           "value": _np(P.dist_nlml(K, _t(y), hybrid, block=8))}
    try:
        P.make_hybrid_mesh(chains=3)
        out["raised"] = np.array("")
    except ValueError as e:
        out["raised"] = np.array(str(e))
    return out


def case_jitter(mesh):
    import stheno_torch.parallel as P
    from stheno_torch import config

    U = np.random.RandomState(9).randn(64, 4)
    K = torch.as_tensor((U @ U.T) * 1e4, dtype=torch.float32)
    config.set_adaptive_jitter(True)
    try:
        L = P.dist_cholesky(K, mesh, block=8)
    finally:
        config.set_adaptive_jitter(False)
    return {"finite": np.array(bool(torch.isfinite(L.to_local()).all()))}


def case_entries(mesh):
    """The entry points at small sizes: ``dist_nlml_16k`` at N=256,
    ``dist_elbo_1m`` on ``sparse_1m_inputs`` at N=5000, M=16 (more rows a
    rank than one chunk of the ELBO's chunked products at D = 1 and 2),
    and ``dist_predict_16k`` at N=256, 64 points."""
    from stheno_torch import entry as E

    ell = torch.tensor(2.0, dtype=torch.float64)
    v, g = E.dist_nlml_16k(mesh, ell, grad=True, n=256)
    inputs = E.sparse_1m_inputs(torch.float64, n=5000, m=16)
    ev, eg = E.dist_elbo_1m(mesh, torch.tensor(1.0, dtype=torch.float64), grad=True,
                            inputs=inputs)
    mean, var = E.dist_predict_16k(mesh, ell, 64, n=256)
    return {"nlml": _np(v), "nlml_grad": _np(g),
            "nlml_value_only": _np(E.dist_nlml_16k(mesh, ell, n=256)),
            "elbo": _np(ev), "elbo_grad": _np(eg), "mean": _np(mean), "var": _np(var)}


def _flops(fn):
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


def case_flops(mesh):
    import stheno_torch.parallel as P

    N = 512
    K = _t(psd(N, 23))
    y = _t(np.random.RandomState(24).randn(N))

    def chol():
        P.dist_cholesky(K, mesh, block=64)

    def value_grad():
        Kg = K.clone().requires_grad_(True)
        _grads(P.dist_nlml(Kg, y, mesh, block=64), [Kg])

    def value_only():
        with torch.no_grad():
            P.dist_nlml(K, y, mesh, block=64)

    return {"cholesky": np.array(_flops(chol)), "value_grad": np.array(_flops(value_grad)),
            "value_only": np.array(_flops(value_only))}


def case_memory(mesh):
    """The largest tensor one rank creates in an NLML value and gradient
    through ``sharded_gram`` at N=512, through the recursion
    (``_REC_BASE`` 128) and its base loop."""
    from tests.test_torch_helpers import LargestTensor

    x, y = nlml_data(512, 7)
    p = torch.tensor(0.3, dtype=torch.float64, requires_grad=True)
    with _rec_base(128), LargestTensor() as big:
        _grads(_nlml(p, x, y, mesh, 32), [p])
    return {"numel": np.array(big.numel), "op": np.array(big.op)}


# ---------------------------------------------------------------------------
# Suite "comm": tests/parallel/test_comm_volume.py's 1-D half.


def case_comm_volume(mesh):
    from stheno_torch.parallel._comm import MeshAxis
    from stheno_torch.parallel.cholesky import _dist_cholesky_loop, local_rows
    from stheno_torch.utils.comm import collective_traffic

    ax = MeshAxis(mesh, "data")
    K_local = local_rows(_t(psd(256)), ax)
    with collective_traffic() as traffic:
        _dist_cholesky_loop(K_local, ax, 32)
    out = {"total": np.array(traffic["total"]),
           "loop_bytes": np.array(sum(b * m for _, _, b, m in traffic["instructions"] if m > 1)),
           "instructions": np.array([f"{s}|{k}|{b}|{m}" for s, k, b, m in traffic["instructions"]])}
    return out


# ---------------------------------------------------------------------------
# Suite "multihost": tests/parallel/test_multihost.py's first half.


def case_multihost(mesh):
    import torch.distributed as dist

    import stheno_torch.parallel as P
    from stheno_torch.parallel._comm import MeshAxis, all_reduce

    hybrid = P.make_hybrid_mesh(chains=2)
    ax = MeshAxis(hybrid, "chain")
    pid = dist.get_rank()
    got = all_reduce(torch.arange(2.0).reshape(2, 1) + 10.0 * pid, ax)
    return {"world": np.array(dist.get_world_size()), "shape": np.array(hybrid.mesh.shape),
            "names": np.array(hybrid.mesh_dim_names), "sum": _np(got)}


SUITES = {
    "parallel": {f.__name__[5:]: f for f in (
        case_factors, case_untileable, case_nlml, case_nlml_matrix, case_multi_output,
        case_posterior, case_elbo, case_hybrid, case_jitter, case_entries, case_flops,
        case_memory)},
    "comm": {"comm_volume": case_comm_volume},
    "multihost": {"multihost": case_multihost},
}


def _setup_cpu():
    from stheno_torch import config

    torch.set_num_threads(1)
    config.set_default_device("cpu")


def run_suite(suite, mesh):
    """Every case of ``suite`` on ``mesh`` in this process: ``{case: dict}``."""
    return {name: fn(mesh) for name, fn in SUITES[suite].items()}


def main(suite, rank, world, store, out):
    _setup_cpu()
    from stheno_torch.parallel import initialize_hosts, make_data_mesh

    rank, world = int(rank), int(world)
    out = pathlib.Path(out)
    try:
        if suite == "multihost":
            # A cluster of more than one process that cannot form raises:
            # nothing listens on port 1 of this host.
            try:
                initialize_hosts("127.0.0.1:1", num_processes=2, process_id=1,
                                 timeout=datetime.timedelta(seconds=1))
            except RuntimeError:
                pass
            else:
                raise AssertionError("an explicit cluster that cannot form did not raise")
        timeout = datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S)
        for _ in range(2):  # the second call is a no-op
            initialize_hosts(f"file://{store}", num_processes=world, process_id=rank,
                             backend="gloo", timeout=timeout)
        mesh = make_data_mesh()
        for name, res in run_suite(suite, mesh).items():
            np.savez(out / f"{name}.{rank}.npz", **res)
    except BaseException:
        (out / f"error.{rank}.txt").write_text(traceback.format_exc())
        raise
    finally:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()


def run_pools(suite, worlds, base):
    """Run ``suite`` at each world size of ``worlds`` at once, in as many
    worker processes, each pool writing to ``base/<world>``; raise with the
    failed workers' output if one fails or the pools outlast
    ``POOL_TIMEOUT_S``."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")}
    procs = []
    for world in worlds:
        out = pathlib.Path(base) / str(world)
        out.mkdir(parents=True, exist_ok=True)
        procs += [((world, r), subprocess.Popen(
            [sys.executable, "-m", "tests.torch_parallel_worker", suite, str(r), str(world),
             str(out / "store"), str(out)],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
            for r in range(world)]
    deadline = time.monotonic() + POOL_TIMEOUT_S
    logs = {}
    try:
        for key, p in procs:
            logs[key] = p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0]
    except subprocess.TimeoutExpired:
        pass
    finally:
        for _, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [key for key, p in procs if p.returncode != 0 or key not in logs]
    if failed:
        raise RuntimeError(f"{suite}: workers (D, rank) {failed} failed or timed out:\n" + "\n".join(
            f"--- {key}:\n{logs.get(key, '')}" for key in failed))


def _load(out, suite, world):
    res = {}
    for name in SUITES[suite]:
        res[name] = []
        for r in range(world):
            with np.load(pathlib.Path(out) / f"{name}.{r}.npz") as f:
                res[name].append({k: f[k] for k in f.files})
    return res


#: The world sizes each suite's pools run at.
WORLDS = {"parallel": (2, 4), "comm": (4,), "multihost": (2,)}


def results(suite, world, tmp_path_factory):
    """``{case: [rank 0's dict, ...]}`` of ``suite`` at ``world`` ranks. The
    suite's pools (``WORLDS``) run together, once per test session: under
    pytest-xdist, in the session's shared directory behind a file lock."""
    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent
    out = base / f"torch_parallel_{suite}"
    with open(base / f"torch_parallel_{suite}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not (out / "done").exists():
                run_pools(suite, WORLDS[suite], out)
                (out / "done").write_text("")
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return _load(out / str(world), suite, world)


def rows(res, key):
    """A row-sharded result assembled from the ranks' blocks."""
    return np.concatenate([r[key] for r in res])


if __name__ == "__main__":
    main(*sys.argv[1:])
