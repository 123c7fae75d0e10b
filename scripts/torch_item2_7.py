"""Items 2 and 7's measurements on one GPU, and ``chip_smoke.py``'s phase
``item2_7_path`` alone.

    python3 scripts/torch_item2_7.py [check] [measure] [dense] [hessian] [--root DIR]

``check`` builds the kernels and runs ``chip_smoke.phase_item2_7_path``
(the tangent kernel against its plain version, K2's forward rule,
``entry.flagship_jacfwd`` against the reverse gradient and float64, the
Hessians, the captured adaptive-jitter and rq steps against eager ones,
the tangent kernel's row of the kernels line).

``measure`` prints one JSON line per measurement, each with the card's
``nvidia-smi`` name and power limit:

- ``value_nlml``: the value-only N=2000 NLML (``entry.nlml_n2000``) under
  the auto policy, which factors with the library (cuSOLVER) when no
  derivative is taken, and under ``cholesky_impl("fast")``, the
  carried-inverse recursion on K2: CUDA-event times and one profiled call
  of each (device kernels by name, busy time);
- ``dense_value_grad``: ``bench.py:bench_dense_nlml_grad``'s step (EQ
  stretched by 2, noise 0.1, ``x`` on [0, 10]) as a value and gradient by
  ``torch.autograd.grad`` at n = 8192, 16,384 and 32,768 in float32, which
  the auto policy takes through the recursion: the median CUDA-event time
  of one call, each after a garbage collection (the first call untimed),
  and the step's own peak memory;
- ``adam_adaptive``: the captured Adam driver of ``entry.adam_n2000`` (k =
  1), ``run(100)`` after ``run(2)``, steps/s with ``config.adaptive_jitter``
  off and on (two turns each, off, on, on, off), and the probe's jitter.

``dense`` runs ``dense_value_grad`` alone. ``hessian`` (alone too) traces
one ``entry.flagship_hessian`` call at N=2000 in float32 after three
warm-ups: its CUDA-event time (median of 10), the trace's span, busy time
and share, device launches and device ms by kernel, the wrappers' launch
counts, and the host's operators by self CPU time over one more call
(``torch.profiler``, CPU only): where the call's time goes. ``--root DIR`` imports
``stheno_torch`` from the checkout at DIR (default: this one) and measures
it with this checkout's ``chip_smoke.py``, so that two checkouts compare
in one run on one card (``dense`` and ``measure`` only).
"""

import gc
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

DENSE_N = (8192, 16_384, 32_768)
ADAM_STEPS = 100


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def _kernels(cs, fn, k=8):
    t = cs.trace("call", fn)
    top = sorted(t["by_name"].items(), key=lambda kv: -kv[1][1])[:k]
    return {"busy_us": t["busy_us"], "span_us": t["span_us"],
            "kernels": {name: [c, us] for name, (c, us) in top}}


def value_nlml(cs, smi):
    from stheno_torch import config
    from stheno_torch import entry as E

    x, y, ell = E.n2000_inputs()
    out = {"measure": "value_nlml", "nvidia_smi": smi, "n": 2000}
    for impl in ("auto", "fast", "fast", "auto"):
        config.set_cholesky_impl(impl)
        try:
            fn = lambda: E.nlml_n2000(x, y, ell)  # noqa: E731
            out.setdefault(f"{impl}_ms", []).append(cs.time_ms(fn, reps=20))
            if f"{impl}_profile" not in out:
                out[f"{impl}_profile"] = _kernels(cs, fn)
                out[f"{impl}_value"] = float(fn())
        finally:
            config.set_cholesky_impl("auto")
    print(json.dumps(out), flush=True)


def dense_value_grad(cs, smi, root=None):
    from stheno_torch import EQ, GP

    for n in DENSE_N:
        gc.collect()
        torch.cuda.empty_cache()
        x = torch.linspace(0.0, 10.0, n, device="cuda")
        y = torch.sin(x) + 0.3 * torch.cos(3.2 * x)
        ell = torch.tensor(2.0, device="cuda", requires_grad=True)

        def step():
            f = GP(EQ().stretch(ell))
            val = -f.measure.logpdf(f(x, torch.tensor(0.1, device="cuda")), y)
            return val, torch.autograd.grad(val, ell)[0]

        val, g = (t.detach() for t in step())
        ms = _collected_ms(step, 5 if n <= 16_384 else 3)
        gc.collect()
        out = {"measure": "dense_value_grad", "nvidia_smi": smi, "root": root, "n": n, "ms": ms,
               "own_peak_bytes": cs._own_peak(step), "value": float(val), "grad": float(g)}
        print(json.dumps(out), flush=True)
        del val, g


def _collected_ms(fn, reps):
    """Median CUDA-event ms of one call of ``fn``, each after a garbage
    collection outside the timed span: a model's objects hold reference
    cycles that keep a step's graph, and at n = 32,768 two uncollected
    steps do not fit in the card's 80 GB."""
    samples = []
    for _ in range(reps):
        gc.collect()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end))
    return sorted(samples)[len(samples) // 2]


def adam_adaptive(cs, smi):
    from stheno_torch import config
    from stheno_torch import entry as E
    from stheno_torch.matrix import ops

    out = {"measure": "adam_adaptive", "nvidia_smi": smi, "n": 2000, "steps": ADAM_STEPS}
    seen = []
    probe = ops.adaptive_jitter_eps

    def spy(mat, base):
        eps = probe(mat, base)
        seen.append(eps)
        return eps

    ops.adaptive_jitter_eps = spy
    try:
        for on in (False, True, True, False):
            config.set_adaptive_jitter(on)
            try:
                driver = E.adam_n2000()
                driver.run(2)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                driver.run(ADAM_STEPS)
                secs = time.perf_counter() - t0
            finally:
                config.set_adaptive_jitter(False)
            key = "adaptive" if on else "fixed"
            out.setdefault(f"{key}_steps_per_s", []).append(ADAM_STEPS / secs)
            if on:
                out["probe_eps"] = float(seen[-1])
            del driver
            gc.collect()
    finally:
        ops.adaptive_jitter_eps = probe
    print(json.dumps(out), flush=True)


def hessian_trace(cs, smi):
    from stheno_torch import entry as E

    x, y, params = E.flagship_n2000_inputs()
    call = lambda: E.flagship_hessian(x, y, params)  # noqa: E731
    for _ in range(3):
        call()
    torch.cuda.synchronize()
    ms = cs.time_ms(call, reps=10)
    t = cs.trace("flagship_hessian", call)
    kernels = sorted(t["by_name"].items(), key=lambda kv: -kv[1][1])
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        call()
        torch.cuda.synchronize()
    host = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)[:20]
    print(json.dumps({
        "what": "flagship_hessian_trace", "nvidia_smi": smi, "ms": ms,
        "span_ms": t["span_us"] / 1e3, "busy_ms": t["busy_us"] / 1e3,
        "busy_share": t["busy_us"] / t["span_us"],
        "device_launches": sum(c for _, (c, _) in kernels),
        "kernels": {k: [c, us / 1e3] for k, (c, us) in kernels},
        "wrapper_launches": t["launches"],
        "host_self_cpu": [{"op": e.key, "calls": e.count,
                           "self_cpu_ms": e.self_cpu_time_total / 1e3} for e in host],
    }), flush=True)


def main(argv):
    root = None
    if "--root" in argv:
        i = argv.index("--root")
        root, argv = argv[i + 1], argv[:i] + argv[i + 2:]
        sys.path.insert(0, str(Path(root).resolve()))
    what = argv or ["check", "measure"]
    cs = _chip_smoke()
    from stheno_torch import config

    smi = cs.phase_card()
    with config.matmul_precision_ctx():
        if "check" in what:
            t0 = time.perf_counter()
            row = cs.phase_item2_7_path(smi)
            print(json.dumps({"phase_s": time.perf_counter() - t0, "kernels": row}), flush=True)
        if "measure" in what:
            value_nlml(cs, smi)
            adam_adaptive(cs, smi)
        if "measure" in what or "dense" in what:
            dense_value_grad(cs, smi, root)
        if "hessian" in what:
            hessian_trace(cs, smi)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
