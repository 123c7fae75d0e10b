"""The float32 error of the NLML and its derivative in ell at N=4096 on one
GPU, by ell and by data set: the single-device path (``Measure.logpdf``),
the 1-D distributed path (``parallel.dist_nlml`` on the Gram of
``parallel.sharded_gram``, as ``entry.dist_nlml_16k``) on 1, 2 and 4 ranks,
and the 2-D path (``cholesky2d.nlml_cyclic`` on the tiles of
``cyclic_gram``, as ``entry.dist_nlml_2d_16k``) on the 1x1, 1x2 and 2x2
grids, each against the single-device path in float64. The ranks of a run
share the card: NCCL at one rank, gloo at two and four (NCCL refuses two
ranks on one GPU), as ``chip_smoke.py``'s phase ``item12b_2d_path`` runs
them. Beside the errors, the two terms of the float64 derivative, ``0.5
tr(K^{-1} dK)`` and ``0.5 alpha^T dK alpha`` (``alpha = K^{-1} y``), whose
difference it is.

    python3 scripts/torch_item12b.py [--n N] [--seeds S ...] [--ells E ...] [--cpu]

Data set 0 is ``entry.dist_nlml_16k_inputs`` (``bench_dense_nlml_grad``'s
``x = linspace(0, 10, N)``, ``y = sin x + 0.3 cos 3.2x``); data set ``s >
0`` draws ``x`` uniform on [0, 10] (sorted) and adds noise of variance 0.1
to the same ``y``, from a generator seeded with ``s``. Every path reads the
data in float32; the float64 reference reads the same numbers, widened, as
``chip_smoke.py``'s gates do. The model is the
entry points': ``GP(EQ().stretch(ell))`` at noise 0.1, panel block 256.
One JSON line per data set and ell (relative errors: ``|got - f64| /
|f64|``), then the card's name and power limit. ``--cpu`` runs the same on
the CPU, over gloo, for a check of the script at a small N.
"""

import argparse
import datetime
import json
import multiprocessing as mp
import os
import shutil
import subprocess
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

#: Each run's world size and the paths it measures: the 1-D path on all of
#: its ranks, the 2-D path on the grid.
RUNS = {1: (1, 1), 2: (1, 2), 4: (2, 2)}


def _data(n, seed, device):
    """Data set ``seed`` in float32 on ``device`` (the float64 reference
    reads the same numbers, widened)."""
    from stheno_torch import entry as E

    x, y = E.dist_nlml_16k_inputs(n, torch.float32, "cpu")
    if seed:
        gen = torch.Generator().manual_seed(seed)
        x = torch.sort(10.0 * torch.rand(n, generator=gen, dtype=torch.float64)).values
        y = (torch.sin(x) + 0.3 * torch.cos(3.2 * x)
             + E.DIST_NOISE ** 0.5 * torch.randn(n, generator=gen, dtype=torch.float64))
    return x.float().to(device), y.float().to(device)


def _value_grad(fn, ell):
    e = ell.detach().clone().requires_grad_(True)
    v = fn(e)
    (g,) = torch.autograd.grad(v, e)
    return float(v.detach()), float(g)


def _single(x, y, ell):
    from stheno_torch import EQ, GP
    from stheno_torch.entry import DIST_NOISE

    def fn(e):
        f = GP(EQ().stretch(e))
        return -f.measure.logpdf(f(x, DIST_NOISE), y)

    return _value_grad(fn, ell)


def _terms(x, y, ell):
    """``0.5 tr(K^{-1} dK)`` and ``0.5 alpha^T dK alpha`` in float64, ``dK``
    the derivative of the Gram in ell."""
    from stheno_torch.entry import DIST_NOISE

    d2 = (x[:, None] - x[None, :]).square()
    G = torch.exp(-0.5 * d2 / ell ** 2)
    dK = G * d2 / ell ** 3
    L = torch.linalg.cholesky(G + DIST_NOISE * torch.eye(len(x), dtype=x.dtype, device=x.device))
    alpha = torch.cholesky_solve(y[:, None], L)
    Kinv = torch.cholesky_inverse(L)
    return float(0.5 * (Kinv * dK).sum()), float(0.5 * (alpha.mT @ dK @ alpha))


def _one_d(mesh, x, y, ell):
    from stheno_torch import EQ
    from stheno_torch import parallel as P
    from stheno_torch.entry import DIST_NOISE

    def fn(e):
        K = P.sharded_gram(EQ().stretch(e), x[:, None], mesh, noise=DIST_NOISE)
        return P.dist_nlml(K, y, mesh)

    return _value_grad(fn, ell)


def _two_d(mesh, x, y, ell):
    from stheno_torch import EQ
    from stheno_torch.entry import DIST_NOISE
    from stheno_torch.parallel import cholesky2d as c2d

    g = c2d.grid(mesh, len(x), device=x.device)

    def fn(e):
        K = c2d.cyclic_gram(EQ().stretch(e), x[:, None], g, noise=DIST_NOISE)
        return c2d.nlml_cyclic(K, y, g)

    return _value_grad(fn, ell)


def _child(world, rank, store, out, args):
    """One rank of the run at ``world`` ranks: every path of the run at
    every data set and ell, written to ``out/<world>.<rank>.json``."""
    import torch.distributed as dist

    from stheno_torch import config
    from stheno_torch.parallel import initialize_hosts, make_data_mesh, make_grid_mesh

    device = "cpu" if args.cpu else "cuda"
    if args.cpu:
        config.set_default_device("cpu")
    else:
        torch.cuda.set_device(0)
    initialize_hosts(f"file://{store}", num_processes=world, process_id=rank,
                     backend="nccl" if world == 1 and not args.cpu else "gloo",
                     timeout=datetime.timedelta(seconds=600))
    try:
        mesh1, grid = make_data_mesh(), make_grid_mesh(*RUNS[world])
        r, c = RUNS[world]
        res = []
        with config.matmul_precision_ctx():
            for seed in args.seeds:
                x, y = _data(args.n, seed, device)
                x64, y64 = x.double(), y.double()
                for e in args.ells:
                    ell = torch.tensor(e, device=device)
                    got = {f"1d_{world}": _one_d(mesh1, x, y, ell),
                           f"2d_{r}x{c}": _two_d(grid, x, y, ell)}
                    if world == 1:
                        got["single"] = _single(x, y, ell)
                        got["f64"] = _single(x64, y64, ell.double())
                        got["terms_f64"] = _terms(x64, y64, e)
                    res.append({"seed": seed, "ell": e, **got})
        with open(os.path.join(out, f"{world}.{rank}.json"), "w") as f:
            json.dump(res, f)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _run(world, out, args):
    ctx = mp.get_context("spawn")
    store = os.path.join(tempfile.mkdtemp(dir=out), "store")
    procs = [ctx.Process(target=_child, args=(world, r, store, out, args)) for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(900)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    codes = [p.exitcode for p in procs]
    if any(codes):
        raise SystemExit(f"the run at {world} ranks exited {codes}")
    ranks = []
    for r in range(world):
        with open(os.path.join(out, f"{world}.{r}.json")) as f:
            ranks.append(json.load(f))
    if any(x != ranks[0] for x in ranks[1:]):
        raise SystemExit(f"the ranks of the run at {world} ranks disagree")
    return ranks[0]


def _rel(a, b):
    return abs(a - b) / abs(b)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--ells", type=float, nargs="+", default=[1.9, 2.0, 2.1])
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    if not args.cpu:
        from stheno_torch.ops import _build

        _build.library()
    out = tempfile.mkdtemp(prefix="item12b_study_")
    try:
        runs = [_run(world, out, args) for world in RUNS]
    finally:
        shutil.rmtree(out, ignore_errors=True)
    for rows in zip(*runs):
        merged = {k: v for row in rows for k, v in row.items()}
        (v64, g64), (tr, quad) = merged.pop("f64"), merged.pop("terms_f64")
        line = {"seed": merged.pop("seed"), "ell": merged.pop("ell"), "n": args.n,
                "value_f64": v64, "grad_f64": g64, "trace_term_f64": tr, "quad_term_f64": quad}
        for key in ("value", "grad"):
            line[f"{key}_rel"] = {path: _rel(vg[key == "grad"], (v64, g64)[key == "grad"])
                                  for path, vg in sorted(merged.items())}
        print(json.dumps(line), flush=True)
    if not args.cpu:
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"],
                             capture_output=True, text=True, check=True).stdout.strip())


if __name__ == "__main__":
    main()
