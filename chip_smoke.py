"""On-card smoke test of stheno_torch, the PyTorch/CUDA port, on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA H100 (sm_90a)
and the CUDA toolkit. It builds the hand-written kernels from
``stheno_torch/ops/csrc``, holds each against its plain PyTorch version
on the card, drives the port's main path (the exact-GP
training-and-prediction step) and checks it against the same port run in
float64 on the CPU, then times each kernel beside its bound, its plain
version and the nearest PyTorch library call, and profiles one N=2000
training step (device time by kernel, device busy share). Each phase
prints one JSON line; the line before the last lists the kernels, and
the last line is
``{"ok": true, "device": {...}}``. Any mismatch, build or launch error,
or a missing card ends it with a non-zero exit code and no result line.
"""

import json
import math
import statistics
import subprocess
import sys
import time

import torch

# Peak rates of one H100 SXM (NVIDIA data sheet): HBM3 bandwidth, and the
# non-tensor-core FP32 / FP64 rates (the kernels use no tensor cores).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}

KERNELS = {
    "gram": {
        "source": "stheno_torch/ops/csrc/gram.cu",
        "replaces": "stheno_tpu/ops/gram.py:92",
    },
    "chol_tile": {
        "source": "stheno_torch/ops/csrc/chol_tile.cu",
        "replaces": "stheno_tpu/ops/pallas_chol.py:112",
    },
}


class SmokeFailure(AssertionError):
    pass


def check(cond, what):
    if not cond:
        raise SmokeFailure(what)


def emit(obj):
    print(json.dumps(obj), flush=True)


def max_err(a, b):
    return float((a.double() - b.double()).abs().max())


def time_ms(fn, reps=20, inner=1, warmup=3):
    """Median over ``reps`` samples of the CUDA-event time of ``inner``
    back-to-back calls, per call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / inner)
    return statistics.median(samples)


def bound(bytes_moved, flops, dtype):
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over the peak rate."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------


def phase_card():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    from stheno_torch.ops import _build

    t0 = time.perf_counter()
    _build.library()
    emit(
        {
            "phase": "build",
            "nvidia_smi": smi,
            "torch": torch.__version__,
            "cuda": torch.version.cuda,
            "build_s": time.perf_counter() - t0,
        }
    )
    return smi


def _warped(n, ell=2.0):
    """The headline's Gram input: x on [0, 10] warped to (cos, sin) of
    period 1 and stretched by ell."""
    x = torch.linspace(0.0, 10.0, n, device="cuda")[:, None]
    a = 2 * math.pi * x
    return torch.cat([torch.cos(a), torch.sin(a)], dim=-1) / ell


def _gram_atol(kind, x, y):
    """Tolerance of the kernel against the plain version. Both compute
    d2 = |x|^2 + |y|^2 - 2 x.y with depth d, whose rounding differs by up
    to dd2 = 4 d eps (max |x|^2 + max |y|^2). EQ and RQ have |dg/dd2| <=
    1/2; the Matérn kinds take sqrt(d2), which turns dd2 into up to
    sqrt(dd2) near d2 = 0 (their |dg/dd| <= 1); linear differs by the
    inner product's rounding, 2 d eps max|x| max|y|."""
    eps = torch.finfo(x.dtype).eps
    d = x.shape[1]
    xn, yn = (x * x).sum(1).max().item(), (y * y).sum(1).max().item()
    dd2 = 4 * d * eps * (xn + yn)
    if kind == "linear":
        return 2 * d * eps * math.sqrt(xn * yn) + 4 * eps
    if kind.startswith("matern"):
        return math.sqrt(dd2) + 4 * eps
    return 0.5 * dd2 + 4 * eps


def phase_gram():
    from stheno_torch.ops import gram as K1

    gen = torch.Generator(device="cuda").manual_seed(0)
    xw = _warped(2000)
    xa = torch.randn(1000, 3, generator=gen, device="cuda")
    ya = torch.randn(777, 3, generator=gen, device="cuda")
    x1 = torch.linspace(0.0, 10.0, 1024, device="cuda")[:, None]
    # The main path's shapes (the N=2000 training Gram and posterior cross
    # Gram, the entry() step's cross Gram) and a ragged case.
    cases = [
        (xw, xw, "2000x2 by 2000x2 f32"),
        (xw, _warped(500), "2000x2 by 500x2 f32"),
        (x1, x1[::4].contiguous(), "1024x1 by 256x1 f32"),
        (xa, ya, "1000x3 by 777x3 f32"),
    ]
    results, path_err = [], 0.0
    for kind in K1.KINDS:
        for x, y, tag in cases:
            K = K1.gram(kind, x, y, 1.3)
            P = K1.gram_plain(kind, x, y, 1.3)
            torch.cuda.synchronize()
            err, tol = max_err(K, P), _gram_atol(kind, x, y)
            check(K.shape == P.shape and bool(torch.isfinite(K).all()), f"gram {kind} {tag}")
            check(err <= tol, f"gram {kind} {tag}: max |kernel - plain| {err} > {tol}")
            if kind == "eq" and x is not xa:
                path_err = max(path_err, err)
            results.append({"kind": kind, "case": tag, "max_abs_err": err, "atol": tol})
    x64, y64 = xa.double(), ya.double()
    err = max_err(K1.gram("matern32", x64, y64), K1.gram_plain("matern32", x64, y64))
    tol = _gram_atol("matern32", x64, y64)
    check(err <= tol, f"gram f64: {err} > {tol}")
    results.append({"kind": "matern32", "case": "1000x3 by 777x3 f64", "max_abs_err": err, "atol": tol})

    # The backward (plain torch W-trick) against autograd through the plain
    # version, at the path's shape. rtol 1e-3 of the largest gradient: the
    # JAX package's tolerance for its float32 W-trick (tests/test_pallas_gram.py).
    grads = []
    w = torch.randn(2000, 2000, generator=gen, device="cuda")
    for kind in ("eq", "matern32", "rq"):
        out = []
        for fn in (K1.gram, K1.gram_plain):
            x = xw.clone().requires_grad_(True)
            y = (xw.flip(0) * 1.1).requires_grad_(True)
            alpha = torch.tensor(1.3, device="cuda", requires_grad=True)
            g = torch.autograd.grad((w * fn(kind, x, y, alpha)).sum(), (x, y, alpha), allow_unused=True)
            out.append([torch.zeros(()) if t is None else t for t in g])
        for name, a, b in zip(("x", "y", "alpha"), *out):
            scale = max(float(b.abs().max()), 1e-30)
            rel = max_err(a.cpu(), b.cpu()) / scale
            check(rel <= 1e-3, f"gram {kind} d/d{name}: rel err {rel}")
            grads.append({"kind": kind, "wrt": name, "rel_err": rel})
    emit({"phase": "gram_vs_plain", "values": results, "grads": grads, "grad_rtol": 1e-3})
    return path_err


def _spd(n, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    B = torch.randn(n, n, generator=gen, device="cuda", dtype=torch.float64)
    return (B @ B.T / n + torch.eye(n, device="cuda", dtype=torch.float64)).float()


def phase_chol_tile():
    from stheno_torch.ops import chol_tile as K2

    # atol 5e-5: the JAX package holds its tile kernel to this against a
    # float64 factor (tests/test_pallas_chol.py); kernel and plain version
    # run the same blocked float32 algorithm.
    atol = 5e-5
    results, path_err = [], 0.0
    for n in (128, 200, 976, 1024):
        A = _spd(n, seed=n)
        L, Linv = K2.chol_tile(A)
        Lp, Linvp = K2.chol_tile_plain(A)
        torch.cuda.synchronize()
        eye = torch.eye(n, device="cuda")
        errs = {
            "L": max_err(L, Lp),
            "Linv": max_err(Linv, Linvp),
            "L_Linv_minus_I": max_err(L @ Linv, eye),
            "upper": float(torch.triu(L, 1).abs().max()),
        }
        for k, v in errs.items():
            check(v <= atol, f"chol_tile n={n} {k}: {v} > {atol}")
        if n >= 976:
            path_err = max(path_err, errs["L"], errs["Linv"])
        # Gradient of a loss of (L, inv L) through the kernel's adjoint
        # against autograd through a float64 library factorisation;
        # rtol 1e-3 of the largest entry (float32 against float64).
        W = torch.randn(n, n, device="cuda", generator=torch.Generator(device="cuda").manual_seed(1))
        At = A.clone().requires_grad_(True)
        L, Linv = K2.chol_tile(At)
        (g,) = torch.autograd.grad((L * W).sum() + (Linv * W.T).sum(), At)
        A64 = A.double().requires_grad_(True)
        L64 = torch.linalg.cholesky(0.5 * (A64 + A64.T))
        (g64,) = torch.autograd.grad(
            (L64 * W).sum() + (torch.linalg.inv(L64) * W.T).sum(), A64
        )
        rel = max_err(g, g64) / float(g64.abs().max())
        check(rel <= 1e-3, f"chol_tile n={n} gradient rel err {rel}")
        errs["grad_rel_err"] = rel
        results.append({"n": n, **errs})
    emit({"phase": "chol_tile_vs_plain", "atol": atol, "grad_rtol": 1e-3, "cases": results})
    return path_err


def _counts():
    from stheno_torch.ops import chol_tile as K2
    from stheno_torch.ops import gram as K1

    return {"gram": K1.launches, "chol_tile": K2.launches}


def _rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


def phase_main_path():
    """The main path, driven once through the user's entry points on the
    card: the flagship step at the entry() shapes, then the headline
    periodic-EQ model at N=2000 (value, value+grad, posterior marginals).
    Each result is held against the same port run in float64 on the CPU
    (plain kernels). NLML to rel 1e-3 and gradients to rel 5e-2: the JAX
    package measured 1.6e-4 and 2.2e-2 for float32 against float64 on its
    card (stheno_tpu/config.py:95-96). Posterior marginals to 1e-3 times
    the largest float64 value."""
    from stheno_torch import EQ, GP
    from stheno_torch import entry as E
    from stheno_torch.ops import chol_tile as K2
    from stheno_torch.ops import gram as K1

    fn, (x, y, x_new, params) = E.entry()
    x_nb = torch.linspace(0.0, 10.0, 500, device="cuda")
    xb, yb, ell = E.n2000_inputs()

    def posterior(x, y, ell, x_new):
        with torch.no_grad():
            f = GP(EQ().stretch(ell).periodic(torch.ones((), dtype=x.dtype, device=x.device)))
            noise = torch.full((), 0.1, dtype=x.dtype, device=x.device)
            return (f | (f(x, noise), y))(x_new).marginals()

    K1.launches = 0
    K2.launches = 0
    out_entry = fn(x, y, x_new, params)
    after_entry = _counts()
    val = E.nlml_n2000(xb, yb, ell)
    after_value = _counts()
    vg = E.nlml_n2000(xb, yb, ell, grad=True)
    after_vg = _counts()
    post = posterior(xb, yb, ell, x_nb)
    torch.cuda.synchronize()
    counts = _counts()

    check(after_entry["gram"] >= 1 and after_entry["chol_tile"] == 1,
          f"entry() step launches {after_entry}")
    check(after_value["chol_tile"] == after_entry["chol_tile"],
          "the value-only NLML ran the tile Cholesky")
    check(after_vg["gram"] - after_value["gram"] >= 1, "value+grad at N=2000 launched no gram")
    check(after_vg["chol_tile"] - after_value["chol_tile"] == 2,
          f"value+grad at N=2000 launched chol_tile {after_vg['chol_tile'] - after_value['chol_tile']} times, not 2")

    cpu = lambda t: t.detach().double().cpu()  # noqa: E731
    ref_entry = E.flagship_step(cpu(x), cpu(y), cpu(x_new), {k: cpu(v) for k, v in params.items()})
    ref_val = E.nlml_n2000(cpu(xb), cpu(yb), cpu(ell))
    ref_vg = E.nlml_n2000(cpu(xb), cpu(yb), cpu(ell), grad=True)
    ref_post = posterior(cpu(xb), cpu(yb), cpu(ell), cpu(x_nb))

    report = {"phase": "main_path", "launches": counts, "entry": {}, "n2000": {}}
    v, g, mean, var = out_entry
    rv, rg, rmean, rvar = ref_entry
    check(mean.shape == (256,) and var.shape == (256,), "entry() marginals shape")
    check(all(bool(torch.isfinite(t).all()) for t in (v, mean, var, *g.values())), "entry() not finite")
    report["entry"]["nlml_rel"] = _rel(v, rv)
    check(report["entry"]["nlml_rel"] <= 1e-3, f"entry() NLML {report['entry']}")
    for k in g:
        report["entry"][f"grad_{k}_rel"] = _rel(g[k], rg[k])
        check(report["entry"][f"grad_{k}_rel"] <= 5e-2, f"entry() grad {k}: {report['entry']}")
    for name, a, b in (("mean", mean, rmean), ("var", var, rvar)):
        err = max_err(a.cpu(), b)
        report["entry"][f"{name}_max_abs_err"] = err
        check(err <= 1e-3 * max(1.0, float(b.abs().max())), f"entry() {name}: {err}")

    report["n2000"] = {
        "nlml": float(val),
        "nlml_ref_f64": float(ref_val),
        "nlml_rel": _rel(val, ref_val),
        "vg_nlml_rel": _rel(vg[0], ref_vg[0]),
        "grad_ell": float(vg[1]),
        "grad_ell_ref_f64": float(ref_vg[1]),
        "grad_rel": _rel(vg[1], ref_vg[1]),
    }
    check(report["n2000"]["nlml_rel"] <= 1e-3 and report["n2000"]["vg_nlml_rel"] <= 1e-3,
          f"N=2000 NLML {report['n2000']}")
    check(report["n2000"]["grad_rel"] <= 5e-2, f"N=2000 gradient {report['n2000']}")
    for name, a, b in zip(("mean", "var"), post, ref_post):
        check(a.shape == (500,) and bool(torch.isfinite(a).all()), f"N=2000 {name} shape/finite")
        err = max_err(a.cpu(), b)
        report["n2000"][f"{name}_max_abs_err"] = err
        check(err <= 1e-3 * max(1.0, float(b.abs().max())), f"N=2000 posterior {name}: {err}")
    emit(report)
    return counts


def phase_times(errs, counts):
    """Times at the main path's shapes (CUDA events, 3 warm-up calls,
    median of 20 samples), beside each kernel's bound, its plain version
    and the nearest PyTorch library call (which the port never calls)."""
    from stheno_torch import entry as E
    from stheno_torch.ops import chol_tile as K2
    from stheno_torch.ops import gram as K1

    saved = _counts()
    kernels = []

    # K1 at the headline's Gram: (2000, 2) x (2000, 2), eq, float32.
    x = _warped(2000)
    n, d = x.shape
    byts = (2 * n * d + n * n) * 4
    flops = n * n * (2 * d + 4) + 4 * n * d
    b_ms, b_by = bound(byts, flops, torch.float32)

    def library():
        return torch.exp(-0.5 * torch.cdist(x, x).square())

    kernels.append(
        {
            "name": "gram",
            "ms": time_ms(lambda: K1.gram("eq", x, x), inner=20),
            "plain_ms": time_ms(lambda: K1.gram_plain("eq", x, x), inner=20),
            "library_ms": time_ms(library, inner=20),
            "bound_ms": b_ms,
            "bound_by": b_by,
            "shape": [n, n, d],
        }
    )

    # K2 at the tiles of the N=2000 factorisation: 1024 and 976.
    tiles = {}
    for n in (1024, 976):
        A = _spd(n, seed=7)
        eye = torch.eye(n, device="cuda")

        def library(A=A, eye=eye):
            L = torch.linalg.cholesky(A)
            return L, torch.linalg.solve_triangular(L, eye, upper=False)

        # (L, inv L): n^3/3 for the factor and n^3/3 for the inverse; A is
        # read once, L and inv L written once.
        b_ms, b_by = bound(3 * n * n * 4, 2 * n**3 / 3, torch.float32)
        tiles[n] = {
            "ms": time_ms(lambda A=A: K2.chol_tile(A)),
            "plain_ms": time_ms(lambda A=A: K2.chol_tile_plain(A), reps=20, warmup=1),
            "library_ms": time_ms(library),
            "bound_ms": b_ms,
            "bound_by": b_by,
        }
    kernels.append({"name": "chol_tile", **tiles[1024], "shape": [1024], "n976": tiles[976]})

    xb, yb, ell = E.n2000_inputs()
    fn, args = E.entry()
    step = {
        "n2000_value_ms": time_ms(lambda: E.nlml_n2000(xb, yb, ell)),
        "n2000_value_grad_ms": time_ms(lambda: E.nlml_n2000(xb, yb, ell, grad=True)),
        "entry_step_ms": time_ms(lambda: fn(*args)),
    }
    # Launches made by the timing runs do not count: restore the main
    # path's counts.
    K1.launches, K2.launches = saved["gram"], saved["chol_tile"]
    emit({"phase": "times", "kernels": kernels, "flagship": step})

    line = []
    for k in kernels:
        line.append(
            {
                "name": k["name"],
                "route": "cuda",
                "source": KERNELS[k["name"]]["source"],
                "replaces": KERNELS[k["name"]]["replaces"],
                "launches": counts[k["name"]],
                "max_abs_err": errs[k["name"]],
                "ms": k["ms"],
                "plain_ms": k["plain_ms"],
                "bound_ms": k["bound_ms"],
                "bound_by": k["bound_by"],
                "library_ms": k["library_ms"],
            }
        )
    return line


def _union_length(intervals):
    """Total length of the union of ``(start, end)`` intervals."""
    total, start, end = 0.0, None, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            if end is not None:
                total += end - start
            start, end = s, e
        else:
            end = max(end, e)
    return total if end is None else total + end - start


def _kernel_name(name):
    """A device event's kernel name without namespace, template arguments
    or parameter list."""
    head = name.replace("(anonymous namespace)::", "").split("(")[0].split("<")[0]
    return head.rsplit("::", 1)[-1].replace("void ", "").strip()[:80]


def phase_profile():
    """One N=2000 value+grad step under torch.profiler, after warm-up: the
    device time by kernel, and the share of the step's span (from its start
    on the host to the end of its last device activity) in which the device
    was busy. The profiler slows the host, so that share is a lower bound.
    The device launches seen must match the wrappers' counts."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from stheno_torch import entry as E
    from stheno_torch.ops import chol_tile as K2
    from stheno_torch.ops import gram as K1

    xb, yb, ell = E.n2000_inputs()
    for _ in range(3):
        E.nlml_n2000(xb, yb, ell, grad=True)
    torch.cuda.synchronize()
    before = _counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("n2000_value_grad"):
            E.nlml_n2000(xb, yb, ell, grad=True)
            torch.cuda.synchronize()
    after = _counts()
    events = prof.events()
    # The annotation is recorded twice, on the host and as a device span;
    # only the host one marks the step's start, and neither is a kernel.
    (step,) = [
        e for e in events if e.name == "n2000_value_grad" and e.device_type == DeviceType.CPU
    ]
    device = [
        e
        for e in events
        if e.device_type == DeviceType.CUDA
        and not e.is_user_annotation
        and e.name != "n2000_value_grad"
    ]
    check(device, "the profiler recorded no device activity")
    intervals = [(e.time_range.start, e.time_range.end) for e in device]
    span_us = max(step.time_range.end, max(e for _, e in intervals)) - step.time_range.start
    busy_us = _union_length(intervals)

    by_name = {}
    for e in device:
        n, us = by_name.get(_kernel_name(e.name), (0, 0.0))
        by_name[_kernel_name(e.name)] = (n + 1, us + e.time_range.end - e.time_range.start)
    k1_n, k1_us = by_name.get("gram_kernel", (0, 0.0))
    k2_names = ("diag_factor", "panel", "trailing")
    k2_us = sum(by_name.get(k, (0, 0.0))[1] for k in k2_names)
    tiles = after["chol_tile"] - before["chol_tile"]
    check(k1_n == after["gram"] - before["gram"] >= 1,
          f"profiled gram_kernel launches {k1_n} != wrapper count {after['gram'] - before['gram']}")
    check(by_name.get("diag_factor", (0, 0.0))[0] == 8 * tiles == 16,
          f"profiled diag_factor launches {by_name.get('diag_factor')} for {tiles} tiles")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    emit(
        {
            "phase": "profile",
            "step": "N=2000 periodic-EQ NLML value+grad, float32",
            "span_ms": span_us / 1e3,
            "device_busy_ms": busy_us / 1e3,
            "device_busy_share": busy_us / span_us,
            "gram_device_ms_per_launch": k1_us / k1_n / 1e3,
            "chol_tile_device_ms_per_tile": k2_us / tiles / 1e3,
            "kernels": [
                {"name": k, "launches": n, "device_ms": us / 1e3} for k, (n, us) in top
            ],
        }
    )


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this check needs a GPU.", file=sys.stderr)
        return 1
    try:
        import stheno_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: run from the root of a checkout ({e}).", file=sys.stderr)
        return 1
    from stheno_torch import config

    config.pin_matmul_precision()
    phase_card()
    errs = {"gram": phase_gram(), "chol_tile": phase_chol_tile()}
    counts = phase_main_path()
    kernels = phase_times(errs, counts)
    phase_profile()
    print(json.dumps({"kernels": kernels}), flush=True)
    print(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": "gpu",
                    "kind": torch.cuda.get_device_name(0),
                    "count": torch.cuda.device_count(),
                },
            }
        ),
        flush=True,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
