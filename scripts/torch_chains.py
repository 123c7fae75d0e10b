"""The samplers' chains on one GPU: what an evaluation of ``bench_nuts``'s
posterior costs by each form, and ``bench_nuts``'s run for two checkouts
side by side.

    python3 scripts/torch_chains.py forms [--n N] [--chains K] [--cpu]
    python3 scripts/torch_chains.py nuts [--root DIR] [--warmup W] [--samples S]
                                         [--n N] [--cpu]

``forms``: at ``entry._nuts_target``'s posterior (N=2000 by default,
float32, adaptive jitter on) and k positions for k = 1, 2 and K (4 by
default; the start jittered by 0.1 normals from
``Generator().manual_seed(0)``), the host-clock time (after a synchronise,
mean of 10 after one warm-up) of:

- ``in_turn``: k calls of ``Target.value_and_grad`` (the chains one at a
  time: each evaluation read back alone);
- ``batched``: ``Target.batch_value_and_grad`` of the k (the samplers'
  batched call: each member by ``torch.autograd``, one read);
- ``chunked_vmap``: ``torch.func.vmap(torch.func.grad_and_value(...),
  chunk_size=1)`` of the k, read once (the batched call's first form);
- ``full_vmap``: the same vmap in one batch, read once;

and whether each batched form's members are bitwise those of
``value_and_grad`` alone (``*_bitwise``).

``nuts``: imports ``stheno_torch`` from the checkout at ``--root``
(default: this one), builds its kernels (this checkout's
``chip_smoke.phase_card``) and runs ``entry.nuts_n2000(0)`` at ``--warmup``
+ ``--samples`` steps (96 + 64 by default, ``chip_smoke.NUTS_STEPS``) once:
wall time, the smallest ESS and largest split R-hat, ESS/s, the
evaluations and the host reads (batched calls where the checkout has
them, else one per evaluation), so that two checkouts compare in one run
on one card.

``--cpu`` runs either on the CPU (a rehearsal: the times are then the
CPU's). Each prints JSON lines with the card's name and power limit."""

import argparse
import json
import os
import subprocess
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _ms(fn, dev, reps=10):
    fn()
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    _sync(dev)
    return (time.perf_counter() - t0) / reps * 1e3


def _smi(dev):
    if dev.type != "cuda":
        return None
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def _chip_smoke():
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forms(a):
    sys.path.insert(0, REPO)
    from stheno_torch import config
    from stheno_torch import entry as E
    from stheno_torch.opt._flat import Target

    if a.cpu:
        config.set_default_device("cpu")
    dev = config.resolve_device(None)
    if dev.type == "cuda":
        _chip_smoke().phase_card()
    logpost, init = E._nuts_target(a.n, dev)
    prev = config.adaptive_jitter
    config.set_adaptive_jitter(True)
    try:
        with config.matmul_precision_ctx():
            t = Target(logpost, init)
            fn = torch.func.grad_and_value(lambda q: logpost(t.unravel(q)))

            def vmapped(qs, **kw):
                g, v = torch.func.vmap(fn, **kw)(qs.to(dev))
                both = torch.cat([v.detach().double()[:, None], g.detach().double()], 1).cpu()
                return both[:, 0], both[:, 1:].to(qs.dtype)

            def bitwise(got, qs):
                return all(float(got[0][i]) == v and torch.equal(got[1][i], g)
                           for i, (v, g) in enumerate(t.value_and_grad(q) for q in qs))

            gen = torch.Generator().manual_seed(0)
            base = t.q0 + 0.1 * torch.randn(a.chains, t.dim, generator=gen, dtype=t.dtype)
            for k in sorted({1, 2, a.chains}):
                qs = base[:k]
                out = {"form": "times", "n": a.n, "k": k, "device": str(dev),
                       "nvidia_smi": _smi(dev), "torch": torch.__version__,
                       "batched_bitwise": bitwise(t.batch_value_and_grad(qs), qs),
                       "chunked_vmap_bitwise": bitwise(vmapped(qs, chunk_size=1), qs),
                       "full_vmap_bitwise": bitwise(vmapped(qs), qs),
                       "in_turn_ms": _ms(lambda: [t.value_and_grad(q) for q in qs], dev),
                       "batched_ms": _ms(lambda: t.batch_value_and_grad(qs), dev),
                       "chunked_vmap_ms": _ms(lambda: vmapped(qs, chunk_size=1), dev),
                       "full_vmap_ms": _ms(lambda: vmapped(qs), dev)}
                print(json.dumps(out), flush=True)
    finally:
        config.set_adaptive_jitter(prev)


def nuts(a):
    root = os.path.abspath(a.root)
    sys.path.insert(0, root)
    from stheno_torch import config
    from stheno_torch import entry as E
    from stheno_torch.opt import _flat, effective_sample_size, potential_scale_reduction

    if a.cpu:
        config.set_default_device("cpu")
    dev = config.resolve_device(None)
    if dev.type == "cuda":
        _chip_smoke().phase_card()
    evals = [0]
    one = _flat.Target.value_and_grad

    def counted(self, q):
        evals[0] += 1
        return one(self, q)

    _flat.Target.value_and_grad = counted
    c0, p0 = getattr(_flat, "batch_calls", 0), getattr(_flat, "batch_points", 0)
    with config.matmul_precision_ctx():
        t0 = time.perf_counter()
        samples, accept = E.nuts_n2000(0, device=str(dev), n=a.n, num_warmup=a.warmup,
                                       num_samples=a.samples)
        _sync(dev)
        wall = time.perf_counter() - t0
    calls = getattr(_flat, "batch_calls", 0) - c0
    points = getattr(_flat, "batch_points", 0) - p0
    ess = min(effective_sample_size(v) for v in samples.values())
    rhat = max(potential_scale_reduction(v) for v in samples.values())
    print(json.dumps({
        "form": "nuts", "root": a.root, "nvidia_smi": _smi(dev), "n": a.n,
        "steps": [a.warmup, a.samples], "wall_s": wall, "min_ess": ess, "max_rhat": rhat,
        "ess_per_s": ess / wall, "accept": accept, "evaluations": evals[0] + points,
        "host_reads": evals[0] + calls, "batch_calls": calls,
        "s_per_evaluation": wall / max(evals[0] + points, 1)}), flush=True)


def main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("what", choices=["forms", "nuts"])
    ap.add_argument("--n", type=int, default=2000)
    ap.add_argument("--chains", type=int, default=4)
    ap.add_argument("--root", default=REPO)
    ap.add_argument("--warmup", type=int, default=96)
    ap.add_argument("--samples", type=int, default=64)
    ap.add_argument("--cpu", action="store_true")
    a = ap.parse_args(argv)
    forms(a) if a.what == "forms" else nuts(a)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
