"""Worker processes of the distributed port's CPU tests
(``tests/test_torch_parallel.py``, ``test_torch_cholesky2d.py``,
``test_torch_parallel_iterative.py``, ``test_torch_multihost.py``,
``test_torch_comm_volume.py``, and the mesh cases of
``test_torch_nuts.py``, ``test_torch_pathwise.py`` and
``test_torch_svgp.py``). It imports neither ``jax`` nor
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
wait on a lock and read their files), :func:`run_suite` runs a suite in
the calling process at D=1, and :func:`iter_results` reads one case of
item 12b's second half at any D (at D=1 running that case alone here).
"""

import contextlib
import datetime
import fcntl
import functools
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
def _rec_base(n, module="cholesky"):
    import importlib

    pc = importlib.import_module(f"stheno_torch.parallel.{module}")
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


def weights(n, m, seed):
    """Standard normal weights of a loss ``sum(W o X)``."""
    return np.random.RandomState(seed).randn(n, m)


#: The factorisations whose gradients F5's cases take: (key, N, seed of
#: the matrix, block, ``_REC_BASE``): the panel loop, and the recursion.
F5_FACTORS = (("loop", 128, 31, 16, 2048), ("rec", 128, 32, 8, 64))


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


def _row_loss(X, W, ax):
    """``sum(W o X)`` for a row-sharded ``X`` and the whole weights ``W``,
    summed over the ranks through ``reduce_from_mesh``."""
    from stheno_torch.parallel._comm import reduce_from_mesh

    X = X.to_local()
    n = X.shape[0]
    return reduce_from_mesh((_t(W)[ax.rank * n:(ax.rank + 1) * n] * X).sum(), ax)


def case_f5(mesh):
    """F5: the gradients of the public factor, solve and posteriors, and an
    in-place collective under a gradient."""
    from torch.distributed.tensor import DTensor

    import stheno_torch.parallel as P
    from stheno_torch import EQ
    from stheno_torch.parallel._comm import MeshAxis, all_reduce

    ax = MeshAxis(mesh, "data")
    out = {}
    for key, n, seed, block, rec in F5_FACTORS:
        W1, W2 = weights(n, n, seed + 100), weights(n, n, seed + 200)
        with _rec_base(rec):
            K = _t(psd(n, seed)).requires_grad_(True)
            L = P.dist_cholesky(K, mesh, block=block)
            out[f"chol_{key}"] = _np(_grads(_row_loss(L, W1, ax), [K])[0])
            L, Linv = P.dist_cholesky_with_inv(K, mesh, block=block)
            out[f"inv_{key}"] = _np(_grads(_row_loss(L, W1, ax) + _row_loss(Linv, W2, ax), [K])[0])
            Lf = _t(np.linalg.cholesky(psd(n, seed))).requires_grad_(True)
            B = _t(weights(n, 5, seed + 300)).requires_grad_(True)
            X = P.dist_solve_lower(Lf, B, mesh, block=block)
            gL, gB = _grads(_row_loss(X, W1[:, :5], ax), [Lf, B])
            out[f"solve_L_{key}"], out[f"solve_B_{key}"] = _np(gL), _np(gB)
    # N = 5: padded with an identity block at D = 2 and 4, the factor
    # gathered whole (gather_from_mesh).
    K = _t(psd(5, 33)).requires_grad_(True)
    L = P.dist_cholesky(K, mesh, block=8)
    L = L.to_local() if isinstance(L, DTensor) else L
    out["chol_pad"] = _np(_grads((_t(weights(5, 5, 133)) * L).sum(), [K])[0])
    x, y = nlml_data(64)
    leaves = [_t(a).requires_grad_(True) for a in (1.3, 0.1, y, np.linspace(0.0, 10.0, 17))]
    mean, var = P.dist_posterior_predict(EQ().stretch(leaves[0]), _t(x)[:, None], leaves[2],
                                         leaves[3][:, None], leaves[1], mesh, block=8)
    for name, g in zip(("s", "noise", "y", "x_new"), _grads(mean.sum() + var.sum(), leaves)):
        out[f"post_{name}"] = _np(g)
    x, y, z = elbo_data(64, 8)
    xn = _t(np.linspace(-1.0, 11.0, 17))[:, None]
    for method in ("vfe", "fitc", "dtc"):
        leaves = [_t(a).requires_grad_(True) for a in (1.3, z, 0.1)]
        mean, var = P.dist_sparse_posterior(EQ().stretch(leaves[0]), leaves[1][:, None],
                                            _t(x)[:, None], _t(y), leaves[2], xn, mesh,
                                            method=method)
        for name, g in zip(("s", "z", "noise"), _grads(mean.sum() + var.sum(), leaves)):
            out[f"sparse_{method}_{name}"] = _np(g)
    try:
        all_reduce(torch.ones(3, dtype=torch.float64, requires_grad=True) * 2.0, ax)
        out["inplace_raised"] = np.array("")
    except RuntimeError as e:
        out["inplace_raised"] = np.array(str(e))
    return out


def case_f6(mesh):
    """F6: the sparse posterior's mean, variance and gradients with respect
    to (s, z, noise, x_new), VFE, FITC and DTC, at n = 64 and 8 inducing
    points, computed as in case ``f5`` (``plain_*``) and again with every
    rank but 0 nudging each triangular solve of ``parallel/sparse.py`` by
    one part in 2^52 (``nudged_*``): the work after the reduction, which
    each rank runs on its own, then rounds differently on each rank, as
    another summation order would. Its results are rank 0's on every rank
    by construction, so both sets hold the same bits on every rank."""
    import stheno_torch.parallel as P
    import stheno_torch.parallel.sparse as S
    from stheno_torch import EQ
    from stheno_torch.parallel._comm import MeshAxis

    rank = MeshAxis(mesh, "data").rank
    solve = S._solve_tri
    x, y, z = elbo_data(64, 8)
    xn = np.linspace(-1.0, 11.0, 17)
    out = {}
    for tag in ("plain", "nudged"):
        if tag == "nudged" and rank != 0:
            S._solve_tri = lambda L, b: solve(L, b) * (1.0 + 2.0**-52)
        try:
            for method in ("vfe", "fitc", "dtc"):
                leaves = [_t(a).requires_grad_(True) for a in (1.3, z, 0.1, xn)]
                mean, var = P.dist_sparse_posterior(
                    EQ().stretch(leaves[0]), leaves[1][:, None], _t(x)[:, None], _t(y),
                    leaves[2], leaves[3][:, None], mesh, method=method)
                grads = _grads(mean.sum() + var.sum(), leaves)
                out[f"{tag}_{method}_mean"], out[f"{tag}_{method}_var"] = _np(mean), _np(var)
                for name, g in zip(("s", "z", "noise", "x_new"), grads):
                    out[f"{tag}_{method}_{name}"] = _np(g)
        finally:
            S._solve_tri = solve
    return out


# ---------------------------------------------------------------------------
# The 2-D block-cyclic path (tests/parallel/test_cholesky2d.py and the 2-D
# tests of test_distributed.py), on every grid of the world size.

#: The grids each world size runs.
GRIDS = {1: ((1, 1),), 2: ((1, 2),), 4: ((1, 4), (2, 2)), 8: ((2, 4),)}
#: The grid that runs only the cases whose code depends on ``s = c / r >
#: 1`` with ``r > 1`` (the loop's re-index ``d0``, ``_transpose``, SUMMA,
#: the relayout, the NLML's parts): the only such grid of the tests.
SHORT_GRID = (2, 4)


def grid_of(key):
    """``(r, c)`` from a ``"RxC/..."`` key."""
    r, c = key.split("/")[0].split("x")
    return int(r), int(c)


def _grid_loss(X, W, g):
    """``sum(W o X)`` for ``X`` sharded over the grid in block order and the
    whole weights ``W``, summed over both axes."""
    from stheno_torch.parallel._comm import reduce_from_mesh

    X = X.to_local()
    nr, nc = X.shape
    i, j = g.ax_r.rank, g.ax_c.rank
    part = (_t(W)[i * nr:(i + 1) * nr, j * nc:(j + 1) * nc] * X).sum()
    return reduce_from_mesh(reduce_from_mesh(part, g.ax_r), g.ax_c)


def _grid_nlml(log_ell, x, y, mesh, block):
    import stheno_torch.parallel as P
    from stheno_torch import EQ
    from stheno_torch.kernels import pairwise
    from stheno_torch.matrix import dense

    xt = _t(x)[:, None]
    K = dense(pairwise(EQ().stretch(torch.exp(log_ell)), xt)) + 0.1 * torch.eye(
        len(x), dtype=torch.float64)
    return K, P.dist_nlml_2d(K, y, mesh, block=block)


def _grid_block_dtensor(K, g):
    """The replicated ``K`` as a DTensor placed ``Shard(0)``, ``Shard(1)`` on
    the grid, each rank taking its block (differentiable)."""
    from torch.distributed.tensor import DTensor

    from stheno_torch.parallel.cholesky2d import _placements

    N = K.shape[0]
    i, j = g.ax_r.rank, g.ax_c.rank
    nr, nc = N // g.r, N // g.c
    local = K[i * nr:(i + 1) * nr, j * nc:(j + 1) * nc]
    return DTensor.from_local(local, g.mesh, _placements(g), shape=(N, N), stride=(N, 1))


def _grid_cases(mesh, r, c):
    """The 2-D cases on an ``r x c`` grid; on ``SHORT_GRID``, without the
    clipped block, the realistic NLML, the solves at N = 512, the FLOP
    counts and the largest tensor."""
    import stheno_torch.parallel as P
    import stheno_torch.parallel.cholesky2d as c2d
    from stheno_torch.parallel._comm import MeshAxis

    p = f"{r}x{c}/"
    out = {}
    ax_r, ax_c = MeshAxis(mesh, "rows"), MeshAxis(mesh, "cols")
    g64 = c2d.Grid(ax_r, ax_c, 4, 64, "cpu")
    # The relayout: block order to cyclic and back, and the same tiles by index.
    K = _t(np.random.RandomState(3).randn(64, 64))
    with torch.no_grad():
        cyc = c2d._to_cyclic(_grid_block_dtensor(K, g64).to_local(), g64)
        back = c2d._from_cyclic(cyc, g64)
    out[f"grid:{p}cyclic"] = _np(cyc)
    out[f"{p}relayout_back"] = np.array(bool(torch.equal(
        back, _grid_block_dtensor(K, g64).to_local())))
    out[f"{p}relayout_index"] = np.array(bool(torch.equal(cyc, c2d.cyclic_local(K, g64))))
    out[f"grid:{p}loop"] = _np(c2d._dist_cholesky_2d_loop(_t(psd(96, r * 10 + c)), mesh, block=8))
    _, n, seed, block, rec = F5_FACTORS[1]
    W1, W2 = weights(n, n, seed + 100), weights(n, n, seed + 200)
    with _rec_base(rec, "cholesky2d"):
        out[f"grid:{p}rec"] = _np(P.dist_cholesky_2d(_t(psd(128, 7)), mesh, block=8))
        L, Linv = P.dist_cholesky_2d_with_inv(_t(psd(128, 11)), mesh, block=8)
        out[f"grid:{p}inv_L"], out[f"grid:{p}inv_Linv"] = _np(L), _np(Linv)
        # Gradients: through the factor, the factor and its inverse, the NLML.
        g = c2d.grid(mesh, n, block=block, device="cpu")
        K = _t(psd(n, seed)).requires_grad_(True)
        L = P.dist_cholesky_2d(K, mesh, block=block)
        out[f"{p}chol_grad"] = _np(_grads(_grid_loss(L, W1, g), [K])[0])
        L, Linv = P.dist_cholesky_2d_with_inv(K, mesh, block=block)
        out[f"{p}inv_grad"] = _np(_grads(_grid_loss(L, W1, g) + _grid_loss(Linv, W2, g), [K])[0])
        x = np.linspace(0.0, 10.0, 128)
        leaves = [_t(0.3).requires_grad_(True), _t(np.sin(x)).requires_grad_(True)]
        K, v = _grid_nlml(leaves[0], x, leaves[1], mesh, 8)
        out[f"{p}nlml_value"] = _np(v)
        out[f"{p}nlml_grad_ell"], out[f"{p}nlml_grad_y"] = (_np(t) for t in _grads(v, leaves))
        # The same NLML from a DTensor in block order: the gradient goes back
        # through the relayout.
        Kd = K.detach().requires_grad_(True)
        gk = c2d.grid(mesh, 128, block=8, device="cpu")
        v = P.dist_nlml_2d(_grid_block_dtensor(Kd, gk), leaves[1].detach(), mesh, block=8)
        out[f"{p}nlml_dtensor_value"] = _np(v)
        out[f"grid:{p}nlml_dtensor_grad_K"] = _np(
            _grid_block_dtensor(_grads(v, [Kd])[0], gk).to_local())
        # y of three columns: the sum of three NLMLs sharing K.
        Y = _t(weights(128, 3, 35)).requires_grad_(True)
        v = P.dist_nlml_2d(K.detach(), Y, mesh, block=8)
        out[f"{p}nlml_cols_value"], out[f"{p}nlml_cols_grad_y"] = _np(v), _np(_grads(v, [Y])[0])
    # N = 5, which no tile fits on the grid: L replicated.
    X = c2d._solve_lower_2d(_t(np.linalg.cholesky(psd(5, 23))), _t(weights(5, 4, 24)), mesh)
    out[f"{p}solve_untileable"] = _np(X.full_tensor() if hasattr(X, "full_tensor") else X)
    if (r, c) == SHORT_GRID:
        return out
    out[f"grid:{p}clip"] = _np(P.dist_cholesky_2d(_t(psd(64, 5)), mesh, block=256))
    # N = 1024, block 32 (tests/parallel/test_distributed.py's realistic case).
    x = np.linspace(0.0, 10.0, 1024)
    y = np.sin(x) + 0.1 * np.random.RandomState(4).randn(1024)
    from stheno_torch import EQ
    from stheno_torch.kernels import pairwise
    from stheno_torch.matrix import dense

    K = dense(pairwise(EQ().stretch(_t(1.3)), _t(x)[:, None])) + 0.1 * torch.eye(
        1024, dtype=torch.float64)
    out[f"{p}realistic"] = _np(P.dist_nlml_2d(K, _t(y), mesh, block=32))
    # The triangular solve, a thin and a wide right-hand side.
    Lr = _t(np.linalg.cholesky(psd(512, 21)))
    rhs = weights(512, 8, 22)
    for key, B in (("wide", rhs), ("thin", rhs[:, :1])):
        X = c2d._solve_lower_2d(Lr, _t(B), mesh, block=64)
        out[f"{'grid' if B.shape[1] % c == 0 else 'gridrows'}:{p}solve_{key}"] = _np(X)
    # Per-rank matmul FLOPs: the loop at N=512 (block 64); the NLML at N=256
    # (block 16) value only and value and gradient.
    K = _t(psd(512, 9))
    out[f"{p}flops_loop"] = np.array(_flops(lambda: c2d._dist_cholesky_2d_loop(
        K, mesh, block=64)))
    K = _t(psd(256, 13))
    y = _t(np.random.RandomState(14).randn(256))
    out[f"{p}flops_loop_256"] = np.array(_flops(lambda: c2d._dist_cholesky_2d_loop(
        K, mesh, block=16)))

    def value_only():
        with torch.no_grad():
            P.dist_nlml_2d(K, y, mesh, block=16)

    def value_grad():
        Kg = K.clone().requires_grad_(True)
        _grads(P.dist_nlml_2d(Kg, y, mesh, block=16), [Kg])

    out[f"{p}flops_value"] = np.array(_flops(value_only))
    out[f"{p}flops_value_grad"] = np.array(_flops(value_grad))
    # The largest tensor of a value and gradient through the Gram of the
    # entry point at N=512, block 32, through the recursion (``_REC_BASE``
    # 128) and its loop.
    from tests.test_torch_helpers import LargestTensor

    x, y = nlml_data(512, 7)
    with _rec_base(128, "cholesky2d"), LargestTensor() as big:
        g = c2d.grid(mesh, 512, block=32, device="cpu")
        ell = _t(2.0).requires_grad_(True)
        K = c2d.cyclic_gram(EQ().stretch(ell), _t(x)[:, None], g, noise=0.1)
        _grads(c2d.nlml_cyclic(K, _t(y), g), [ell])
    out[f"{p}largest"] = np.array(big.numel)
    out[f"{p}largest_op"] = np.array(big.op)
    return out


def case_grid(mesh):
    """Every 2-D case on each grid of the world size (``GRIDS``), and at two
    ranks, a 2 x 1 grid raising the JAX function's ``ValueError``."""
    import torch.distributed as dist

    import stheno_torch.parallel as P

    world = dist.get_world_size()
    out = {}
    for r, c in GRIDS[world]:
        out.update(_grid_cases(P.make_grid_mesh(r, c), r, c))
    if world == 2:
        try:
            P.dist_cholesky_2d(_t(psd(48)), P.make_grid_mesh(2, 1), block=8)
            out["bad_mesh_raised"] = np.array("")
        except ValueError as e:
            out["bad_mesh_raised"] = np.array(str(e))
    return out


def case_grid_entries(mesh):
    """``entry.dist_nlml_2d_16k`` at N=256 on each grid (value, value only,
    gradient)."""
    import torch.distributed as dist

    import stheno_torch.parallel as P
    from stheno_torch import entry as E

    out = {}
    ell = torch.tensor(2.0, dtype=torch.float64)
    for r, c in GRIDS[dist.get_world_size()]:
        m = P.make_grid_mesh(r, c)
        v, g = E.dist_nlml_2d_16k(m, ell, grad=True, n=256)
        p = f"{r}x{c}/"
        out[f"{p}value"], out[f"{p}grad"] = _np(v), _np(g)
        out[f"{p}value_only"] = _np(E.dist_nlml_2d_16k(m, ell, n=256))
    return out


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


def case_comm_matvec(mesh):
    """The sharded matvec's recorded bytes at N=256, p=4, float64: one
    call, and two chained (the second's right-hand sides the first's
    output)."""
    from stheno_torch import EQ
    from stheno_torch.parallel import sharded_kernel_matvec
    from stheno_torch.utils.comm import collective_traffic

    n, p = 256, 4
    x = _t(np.linspace(0.0, 10.0, n))
    v = _t(np.random.RandomState(1).randn(n, p))

    def mv(vv):
        return sharded_kernel_matvec(EQ(), x, vv, mesh, noise=0.1, block=64)

    with collective_traffic() as one:
        mv(v)
    with collective_traffic() as two:
        mv(mv(v))
    return {"one": np.array(one["total"]), "two": np.array(two["total"]),
            "one_gather": np.array(one["all-gather"]),
            "kinds": np.array([k for _, k, _, _ in two["instructions"]])}


def case_comm_volume_2d(mesh):
    """The 2-D panel loop's recorded bytes at N=256, block 32, on the last
    grid of the world size (2 x 2 at four ranks, 2 x 4 at eight)."""
    import torch.distributed as dist

    import stheno_torch.parallel as P
    import stheno_torch.parallel.cholesky2d as c2d
    from stheno_torch.utils.comm import collective_traffic

    r, c = GRIDS[dist.get_world_size()][-1]
    m = P.make_grid_mesh(r, c)
    g = c2d.grid(m, 256, block=32, device="cpu")
    K = c2d.cyclic_local(_t(psd(256)), g)
    with collective_traffic() as traffic:
        c2d._cyclic_loop(K, g)
    return {"grid": np.array([r, c]), "total": np.array(traffic["total"]),
            "loop_bytes": np.array(sum(b * k for _, _, b, k in traffic["instructions"] if k > 1)),
            "instructions": np.array([f"{s}|{k}|{b}|{n}"
                                      for s, k, b, n in traffic["instructions"]])}


# ---------------------------------------------------------------------------
# Suite "parallel", item 12b's second half: the sharded matrix-free path
# (tests/test_torch_parallel_iterative.py) and the samplers', pathwise's and
# SVGP's meshes (test_torch_nuts.py, test_torch_pathwise.py,
# test_torch_svgp.py).

#: The NLML core's shared case: n, probes, preconditioner rank, seed, block.
ITER_CORE = (100, 6, 30, 3, 16)
ITER_PARAMS = {"log_s2": 0.2, "log_ell": -0.1}


def iter_data(n, seed, noise=0.1):
    """``x``: ``n`` sorted uniform points on [0, 10] and ``y = sin x`` plus
    ``noise`` standard normals, from ``RandomState(seed)``."""
    r = np.random.RandomState(seed)
    x = np.sort(r.rand(n) * 10)
    return x, np.sin(x) + (noise * r.randn(n) if noise else 0.0)


def iter_core_inputs():
    """The core case's data and probes ``(x, y, u, om)``."""
    n, p, rank, seed, _ = ITER_CORE
    x, y = iter_data(n, seed)
    r = np.random.RandomState(seed + 1)
    return x, y, r.randn(n, p), r.randn(n, rank)


def icm_inputs():
    """``tests/parallel/test_distributed.py``'s ICM case: ``(xa, ya, B)``."""
    rng = np.random.RandomState(4)
    nx, t = 24, 2
    x = np.sort(rng.rand(nx)) * 5
    xa = np.stack([np.repeat(x, t), np.tile(np.arange(t, dtype=x.dtype), nx)], axis=1)
    return xa, rng.randn(nx * t), np.array([[1.0, 0.5], [0.5, 0.8]])


def _kf(p):
    return _eq(p["log_ell"], p["log_s2"])


def case_iter_matvec(mesh):
    from stheno_torch import EQ
    from stheno_torch.parallel import sharded_kernel_matvec
    from stheno_torch.parallel.iterative import _cross_matvec_sharded

    r = np.random.RandomState(7)
    x, v = np.sort(r.rand(100)), r.randn(100, 3)  # 100 rows: padded at D = 8
    xn = np.linspace(-0.5, 1.5, 37)
    return {
        "mv": _np(sharded_kernel_matvec(EQ(), _t(x), _t(v), mesh, noise=0.1, block=16)),
        "mv_vec": _np(sharded_kernel_matvec(EQ(), _t(x), _t(v[:, 0]), mesh, block=16)),
        "cross": _np(_cross_matvec_sharded(EQ().stretch(0.3), _t(xn)[:, None], _t(x)[:, None],
                                           _t(v), mesh, block=8)),
    }


def case_iter_core(mesh):
    """The NLML core with the sharded hooks on numpy probes: its value and
    its gradients in the parameters, the noise, ``x`` and ``y``."""
    from stheno_torch.iterative.nlml import _nlml
    from stheno_torch.parallel import sharded_kernel_matvec
    from stheno_torch.parallel.iterative import make_sharded_surrogate_grad

    x, y, u, om = iter_core_inputs()
    *_, block = ITER_CORE
    leaves = {k: _t(v).requires_grad_(True) for k, v in ITER_PARAMS.items()}
    ins = [_t(0.1), _t(x)[:, None], _t(y)]
    noise, xt, yt = (t.requires_grad_(True) for t in ins)

    def mv(k, xx, v, nz):
        return sharded_kernel_matvec(k, xx, v, mesh, noise=nz, block=block)

    val, info = _nlml(leaves, yt, noise, xt, _t(u), _t(om), None, _kf, 1e-12, 400, 60,
                      om.shape[1], "eig", 1, block=block, matvec_fn=mv,
                      surrogate_grad_fn=make_sharded_surrogate_grad(_kf, mesh, block=block))
    grads = _grads(val, [*leaves.values(), noise, xt, yt])
    out = {"value": _np(val), "iters": np.array(info["cg_iters"])}
    for name, g in zip([*leaves, "noise", "x", "y"], grads):
        out[f"grad_{name}"] = _np(g)
    return out


def case_iter_nlml(mesh):
    """``sharded_iterative_nlml`` on ``tests/parallel/test_distributed.py``'s
    cases: the value, the gradients, a 4-step training loop,
    ``return_info`` and the ICM model."""
    from stheno_torch import EQ
    from stheno_torch.kernels import Coregion
    from stheno_torch.parallel import sharded_iterative_nlml as nlml

    out = {}
    x, y = iter_data(96, 8, noise=0.0)
    out["value"] = _np(nlml(lambda p: EQ(), None, _t(x), _t(y), 0.1,
                            torch.Generator().manual_seed(0), mesh, num_probes=16, cg_tol=1e-8,
                            slq_steps=20, precond_rank=30, block=12))
    x, y = iter_data(96, 9)
    leaves = {"log_ell": _t(0.1).requires_grad_(True), "log_s2": _t(0.2).requires_grad_(True)}
    noise = _t(0.1).requires_grad_(True)
    v = nlml(_kf, leaves, _t(x), _t(y), noise, torch.Generator().manual_seed(1), mesh,
             num_probes=32, cg_tol=1e-8, slq_steps=25, precond_rank=40, block=12)
    for name, g in zip(["log_ell", "log_s2", "noise"], _grads(v, [*leaves.values(), noise])):
        out[f"grad_{name}"] = _np(g)
    x, y = iter_data(96, 11)
    p = {"log_ell": _t(0.0), "log_s2": _t(0.0)}
    gen = torch.Generator().manual_seed(2)
    vals = []
    for _ in range(4):
        leaves = {k: t.requires_grad_(True) for k, t in p.items()}
        v = nlml(_kf, leaves, _t(x), _t(y), 0.05, gen, mesh, num_probes=8, cg_tol=1e-8,
                 slq_steps=15, precond_rank=30, block=12)
        gs = _grads(v, list(leaves.values()))
        p = {k: (t - 0.02 * g).detach() for (k, t), g in zip(leaves.items(), gs)}
        vals.append(float(v.detach()))
    out["loop"] = np.array(vals)
    x = np.linspace(0.0, 10.0, 96)
    v, info = nlml(lambda q: torch.exp(q["log_s2"]) * EQ(), {"log_s2": _t(0.1)}, _t(x),
                   _t(np.sin(x)), 0.1, torch.Generator().manual_seed(0), mesh, num_probes=4,
                   cg_tol=1e-6, precond_rank=16, block=32, return_info=True)
    out["info_value"] = _np(v)
    out["info"] = np.array([info["cg_iters"], float(info["cg_rel_residual"]),
                            info["cg_converged"]], dtype=np.float64)
    xa, ya, B = icm_inputs()
    k = EQ().select([0]) * Coregion(_t(B)).select([1])
    out["icm"] = _np(nlml(lambda q: k, None, _t(xa), _t(ya), 0.1,
                          torch.Generator().manual_seed(0), mesh, num_probes=24, cg_tol=1e-9,
                          slq_steps=40, precond_rank=24, block=8))
    return out


#: The SVGP case (``tests/model/test_svgp.py``'s problem): N, the batch
#: (its first ``SVGP_B`` points), M, the noise.
SVGP_CASE = (60, 40, 12, 0.05)
SVGP_THETA = {"log_s2": float(np.log(1.3)), "log_ell": float(np.log(0.9))}


def svgp_data():
    n, _, m, _ = SVGP_CASE
    r = np.random.RandomState(0)
    x = np.sort(r.rand(n) * 8.0)
    return x, np.sin(x) + 0.2 * r.randn(n), np.linspace(0.0, 8.0, m)


def case_iter_svgp(mesh):
    """SVGP's sharded batch: the batch's rows as ``DTensor``s placed
    ``Shard(0)``; the ELBO, its gradient and a natural-gradient step."""
    from stheno_torch import EQ, svgp_elbo, svgp_init, svgp_natgrad_step
    from stheno_torch.parallel._comm import MeshAxis
    from stheno_torch.parallel.cholesky import sharded

    n, b, _, noise = SVGP_CASE
    x, y, z = svgp_data()
    ax = MeshAxis(mesh, "data")
    rows = slice(ax.rank * b // ax.size, (ax.rank + 1) * b // ax.size)
    xs, ys = sharded(_t(x[:b])[rows][:, None], ax, b), sharded(_t(y[:b])[rows], ax, b)
    k0 = 1.3 * EQ().stretch(0.9)
    params = svgp_natgrad_step(k0, svgp_init(k0, _t(z)), _t(x)[:, None], _t(y), noise, n,
                               rho=1.0)
    theta = {k: _t(v).requires_grad_(True) for k, v in SVGP_THETA.items()}
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    e = svgp_elbo(_kf(theta), leaves, xs, ys, noise, n)
    out = {"elbo": _np(e)}
    for name, g in zip([*theta, *leaves], _grads(e, [*theta.values(), *leaves.values()])):
        out[f"grad_{name}"] = _np(g)
    with torch.no_grad():
        step = svgp_natgrad_step(_kf(theta), params, xs, ys, noise, n, rho=0.4)
    out.update({f"step_{k}": _np(v) for k, v in step.items()})
    return out


def case_iter_pathwise(mesh):
    """``pathwise_sampler(mesh=...)``: the draws at 50 points under both
    solvers, and the refusal of ``compensated=True``."""
    from stheno_torch import EQ, pathwise_sampler

    x = np.linspace(0.0, 10.0, 64)
    xn = _t(np.linspace(-1.0, 11.0, 50))
    out = {}
    for solver in ("cg", "chol"):
        fn, _, info = pathwise_sampler(EQ(), _t(x), _t(np.sin(x)), 0.1,
                                       torch.Generator().manual_seed(3), num_samples=4,
                                       num_features=256, solver=solver, block=16, cg_tol=1e-10,
                                       max_cg_iters=500, precond_rank=16, mesh=mesh,
                                       return_info=True)
        out[f"draws_{solver}"] = _np(fn(xn))
    try:
        pathwise_sampler(EQ(), _t(x), _t(np.sin(x)), 0.1, torch.Generator(), solver="cg",
                         mesh=mesh, compensated=True)
        out["raised"] = np.array("")
    except ValueError as e:
        out["raised"] = np.array(str(e))
    return out


#: The chains' case: their number, and each sampler's settings.
CHAINS = 4
NUTS_KW = dict(num_samples=12, num_warmup=12, num_chains=CHAINS, max_depth=4)
HMC_KW = dict(num_samples=10, num_warmup=10, num_chains=CHAINS, n_leapfrog=4)


def chain_target():
    """A correlated Gaussian over ``w`` (2,), and the start."""
    prec = torch.linalg.inv(_t([[1.0, 0.6], [0.6, 1.0]]))

    def lp(p):
        return -0.5 * p["w"] @ prec @ p["w"]

    return lp, {"w": torch.zeros(2, dtype=torch.float64)}


def run_samplers(mesh=None, axis="chains"):
    """NUTS's and HMC's samples, NUTS's and HMC's accept rates and HMC's
    log-densities with the chains over ``mesh``'s ``axis`` (or in turn)."""
    from stheno_torch.opt import sample_hmc, sample_nuts

    lp, init = chain_target()
    sn, an = sample_nuts(lp, init, torch.Generator().manual_seed(5), mesh=mesh,
                         chain_axis=axis, **NUTS_KW)
    sh, lph, ah = sample_hmc(lp, init, torch.Generator().manual_seed(6), mesh=mesh,
                             chain_axis=axis, **HMC_KW)
    return {"nuts": _np(sn["w"]), "nuts_accept": np.array(an), "hmc": _np(sh["w"]),
            "hmc_logps": _np(lph), "hmc_accept": np.array(ah)}


def case_iter_chains(mesh):
    """The samplers' chains over the data mesh and over the hybrid mesh's
    chain axis, each beside the same run with no mesh."""
    import torch.distributed as dist

    import stheno_torch.parallel as P

    hybrid = P.make_hybrid_mesh(chains=2 if dist.get_world_size() % 2 == 0 else 1)
    out = {f"free_{k}": v for k, v in run_samplers().items()}
    out.update({f"data_{k}": v for k, v in run_samplers(mesh, "data").items()})
    out.update({f"hybrid_{k}": v for k, v in run_samplers(hybrid, "chain").items()})
    from stheno_torch.opt import sample_nuts

    lp, init = chain_target()
    try:  # 3 chains do not divide over 2 or 4 ranks.
        sample_nuts(lp, init, torch.Generator(), mesh=mesh, chain_axis="data", num_samples=2,
                    num_warmup=2, num_chains=3)
        out["raised"] = np.array("")
    except ValueError as e:
        out["raised"] = np.array(str(e))
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
    out = {"world": np.array(dist.get_world_size()), "shape": np.array(hybrid.mesh.shape),
           "names": np.array(hybrid.mesh_dim_names), "sum": _np(got)}
    # The iterative half: the row-sharded matvec and the stochastic NLML
    # with the row blocks split across the process boundary.
    from stheno_torch import EQ

    x, v, y = multihost_iterative_data()
    out["matvec"] = _np(P.sharded_kernel_matvec(EQ(), _t(x), _t(v), mesh, noise=0.1, block=8))
    val, info = P.sharded_iterative_nlml(
        lambda p: torch.exp(p["log_s2"]) * EQ(), {"log_s2": _t(0.0)}, _t(x), _t(y), 0.1,
        torch.Generator().manual_seed(0), mesh, num_probes=16, cg_tol=1e-8, precond_rank=16,
        block=8, return_info=True)
    out["nlml"], out["converged"] = _np(val), np.array(info["cg_converged"])
    return out


def multihost_iterative_data(n=64):
    """``tests/parallel/test_multihost.py``'s iterative data: ``(x, v, y)``."""
    x = np.linspace(0.0, 10.0, n)
    v = np.sin(np.arange(2 * n, dtype=np.float64)).reshape(n, 2)
    return x, v, np.sin(x) + 0.05 * np.cos(3.0 * x)


ITER_CASES = (case_iter_matvec, case_iter_core, case_iter_nlml, case_iter_svgp,
              case_iter_pathwise, case_iter_chains)

SUITES = {
    "parallel": {f.__name__[5:]: f for f in (
        case_factors, case_untileable, case_nlml, case_nlml_matrix, case_multi_output,
        case_posterior, case_elbo, case_hybrid, case_jitter, case_entries, case_flops,
        case_memory, case_f5, case_f6, case_grid, case_grid_entries, *ITER_CASES)},
    "comm": {"comm_volume": case_comm_volume, "comm_volume_2d": case_comm_volume_2d,
             "comm_matvec": case_comm_matvec},
    "grid8": {f.__name__[5:]: f for f in (case_grid, case_grid_entries, case_comm_volume_2d)},
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
WORLDS = {"parallel": (2, 4), "comm": (4,), "multihost": (2,), "grid8": (8,)}


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


@functools.cache
def _iter_local(name):
    import stheno_torch.parallel as P

    return [SUITES["parallel"][name](P.make_data_mesh())]


def iter_results(name, world, tmp_path_factory):
    """``[rank 0's dict, ...]`` of the suite ``parallel``'s case ``name`` at
    ``world`` ranks: at one rank run here (once per process), at more read
    from the suite's pools (:func:`results`)."""
    if world == 1:
        return _iter_local(name)
    return results("parallel", world, tmp_path_factory)[name]


def rows(res, key):
    """A row-sharded result assembled from the ranks' blocks."""
    return np.concatenate([r[key] for r in res])


def grid(res, key):
    """A result sharded over an ``r x c`` grid (``key`` ``"grid:RxC/..."``)
    assembled from the ranks' blocks; ``"gridrows:..."``, sharded over the
    rows and replicated over the columns."""
    r, c = grid_of(key.split(":", 1)[1])
    if key.startswith("gridrows:"):
        return np.concatenate([res[i * c][key] for i in range(r)])
    return np.concatenate([np.concatenate([res[i * c + j][key] for j in range(c)], axis=1)
                           for i in range(r)])


if __name__ == "__main__":
    main(*sys.argv[1:])
