"""On-card smoke test of stheno_torch, the PyTorch/CUDA port, on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA H100 (sm_90a)
and the CUDA toolkit. It builds the hand-written kernels from
``stheno_torch/ops/csrc``, holds each against its plain PyTorch version
on the card, and drives the port's two paths through their entry points:

- the main path, the exact-GP training-and-prediction step at N=2000,
  checked against the same port run in float64 on the CPU;
- the matrix-free path at N=262,144 (``bench.py:bench_iterative_262k``:
  the stochastic NLML value and gradient with a fresh and an amortised
  preconditioner, the representer weights, the cached mean, the variance
  cache and its queries, the serving bundle), checked at N=8192 in
  float64 against the dense exact GP and at N=262,144 against the same
  step in float64 on the card.

The training step's surrogate, its Gram term's value and gradient, is
one launch of the fused Gram-gradient kernel (``csrc/gram_matvec_vjp.cu``),
with no K3 sweep: checked at N=262,144 against the same gradient by the
blocked sweep with accurate distances, and its value against K3's
float64 product. K3 has three routes (``ops/gram_matvec.py:route``), each
held against the plain version and timed on its own: float32 p >= 17 on
the tensor cores (the CG), float32 p <= 16 on FFMA and the exp unit (the
serving weights and mean), float64 on the FP64 tensor cores (float64
models, driven by the N=262,144 float64 step of the gates).

It then times each kernel beside its bound, its plain version and the
nearest PyTorch library call, times the matrix-free path's steps, and
profiles one N=2000 and one N=262,144 training step (device time by
kernel, device busy share). Each phase prints one JSON line; the line
before the last lists the kernels, and the last line is
``{"ok": true, "device": {...}}``. Any mismatch, build or launch error,
unconverged solve, or a missing card ends it with a non-zero exit code
and no result line.
"""

import gc
import json
import math
import statistics
import subprocess
import sys
import time

import torch

# Peak rates of one H100 SXM (NVIDIA data sheet): HBM3 bandwidth, the
# non-tensor-core FP32 / FP64 rates, and the dense TF32 and FP64
# tensor-core rates (K3's tensor-core route, the float64 Gram-gradient
# kernel's dots). The special-function unit does 16 exps per
# clock per SM; its rate takes the card's maximum SM clock from
# nvidia-smi (``sfu_exps_per_s``).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}
TF32_TC_FLOPS = 495e12
FP64_TC_FLOPS = 67e12
SM_COUNT = 132
EXPS_PER_CLOCK_PER_SM = 16

KERNELS = {
    "gram": {
        "source": "stheno_torch/ops/csrc/gram.cu",
        "replaces": "stheno_tpu/ops/gram.py:92",
    },
    # K1's backward: the JAX package's _gram_bwd is XLA (the W-trick).
    "gram_bwd": {
        "source": "stheno_torch/ops/csrc/gram_bwd.cu",
        "replaces": "stheno_tpu/ops/gram.py:198",
    },
    "chol_tile": {
        "source": "stheno_torch/ops/csrc/chol_tile.cu",
        "replaces": "stheno_tpu/ops/pallas_chol.py:112",
    },
    # K3's three routes (ops/gram_matvec.py:route), each with its own
    # launch count: float32 p >= 17, float32 p <= 16, float64.
    "gram_matvec_mma": {
        "source": "stheno_torch/ops/csrc/gram_matvec_mma.cu",
        "replaces": "stheno_tpu/ops/gram_matvec.py:53",
    },
    "gram_matvec_ffma": {
        "source": "stheno_torch/ops/csrc/gram_matvec.cu",
        "replaces": "stheno_tpu/ops/gram_matvec.py:53",
    },
    "gram_matvec_dmma": {
        "source": "stheno_torch/ops/csrc/gram_matvec_f64.cu",
        "replaces": "stheno_tpu/ops/gram_matvec.py:53",
    },
    # The backward of K3 on the surrogate gradient: it replaces the K1
    # tiles (and their W-trick VJP) that the JAX package differentiates.
    "gram_matvec_vjp": {
        "source": "stheno_torch/ops/csrc/gram_matvec_vjp.cu",
        "replaces": "stheno_tpu/ops/gram.py:92",
    },
}

# The matrix-free path's size (bench.py:bench_iterative_262k).
N_IT = 262_144


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


def device_ms(fn, reps=3):
    """Median over ``reps`` samples of the device time of one call of
    ``fn``: a spin kernel holds the stream while the host enqueues the
    start event, ``fn``'s launches and the end event, so no host time falls
    between the two events."""
    fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)  # tens of ms, against tens of us of enqueueing
        start.record()
        fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end))
    return statistics.median(samples)


def bound(bytes_moved, flops, dtype):
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over the peak rate."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sfu_exps_per_s():
    """The special-function unit's exp rate: 16 per clock per SM at the
    card's maximum SM clock (nvidia-smi ``clocks.max.sm``, MHz)."""
    mhz = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    return EXPS_PER_CLOCK_PER_SM * SM_COUNT * float(mhz) * 1e6, float(mhz)


def mma_bound(bytes_moved, n, m, d, p, exps_per_s):
    """The least time of K3's tensor-core design, in ms, and what binds
    it: the three TF32 products (6 n m p flops at the dense TF32 rate),
    the distance and epilogue (2d + 4 flops per entry at the FP32 rate),
    the exps (one per entry at the special-function rate), the bytes."""
    times = {
        "tf32_products": 6 * n * m * p / TF32_TC_FLOPS * 1e3,
        "fp32_distance_epilogue": n * m * (2 * d + 4) / PEAK_FLOPS[torch.float32] * 1e3,
        "exps": n * m / exps_per_s * 1e3,
        "bytes": bytes_moved / HBM_BYTES_PER_S * 1e3,
    }
    by = max(times, key=times.get)
    return times[by], by


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
    d2 = |x|^2 + |y|^2 - 2 x.y with depth d in the arithmetic dtype
    (float32 for bfloat16), whose rounding differs by up to dd2 = 4 d eps
    (max |x|^2 + max |y|^2). EQ and RQ have |dg/dd2| <= 1/2; the Matérn
    kinds take sqrt(d2), which turns dd2 into up to sqrt(dd2) near d2 = 0
    (their |dg/dd| <= 1); linear differs by the inner product's rounding,
    2 d eps max|x| max|y|. bfloat16 adds its one rounding of the result
    (``_bf16_tol``)."""
    from stheno_torch.ops.gram import arith_dtype

    eps = torch.finfo(arith_dtype(x.dtype)).eps
    d = x.shape[1]
    x, y = x.double(), y.double()
    xn, yn = (x * x).sum(1).max().item(), (y * y).sum(1).max().item()
    dd2 = 4 * d * eps * (xn + yn)
    if kind == "linear":
        return 2 * d * eps * math.sqrt(xn * yn) + 4 * eps
    if kind.startswith("matern"):
        return math.sqrt(dd2) + 4 * eps
    return 0.5 * dd2 + 4 * eps


def _bf16_tol(tol, ref):
    """A tolerance in float32 arithmetic widened by one bfloat16 rounding of
    the result: kernel and plain version each round once, so their results
    are equal or adjacent, at most 2^-7 of the value apart."""
    return tol + 2.0**-7 * (ref.double().abs() + tol)


def _bwd_tols(kind, x, y, gbar, alpha, block=512):
    """Per-entry tolerances ``(xbar, ybar, dalpha)`` of K1's backward
    against its plain version, in float64. The two sum the same terms in
    other orders (8 sqrt(terms) eps of the terms' absolute sum, as K3's
    tolerance) from d2 that each rounds within dd2 = 4 d eps (|x_i|^2 +
    |y_j|^2) of the exact one (``_gram_atol``), so each term's W may differ
    by |g'(d2 - dd2) - g'(d2 + dd2)| (g' is monotone in d2 for every kind),
    and rq's alpha factor h by |h(d2 +- dd2) - h(d2)|. Near d2 = 0 that
    spread is as large as the gradient of Matérn-1/2 is ill-conditioned
    there, in the JAX package's formula too."""
    from stheno_torch.ops.gram import _alpha_factor, _apply_kind, _g_prime, arith_dtype

    eps = torch.finfo(arith_dtype(x.dtype)).eps
    n, d = x.shape
    m = y.shape[0]
    xf, yf = x.double(), y.double()
    a = torch.as_tensor(float(alpha), dtype=torch.float64, device=x.device)
    rx, ry, ra = (8 * math.sqrt(k) * eps for k in (m, n, n * m))
    tx, ty, ta = torch.zeros_like(xf), torch.zeros_like(yf), 0.0
    yn = (yf * yf).sum(1)

    def gp(t):
        return _g_prime(kind, t, _apply_kind(kind, t, None, a), a)

    def h(t):
        return _alpha_factor(t, _apply_kind(kind, t, None, a), a)

    for s in range(0, n, block):
        xb, gb = xf[s:s + block], gbar[s:s + block].double().abs()
        if kind == "linear":
            tx[s:s + block] = rx * (gb @ yf.abs())
            ty += ry * (gb.T @ xb.abs())
            continue
        diff = xb[:, None, :] - yf[None, :, :]
        d2 = (diff * diff).sum(-1)
        dd2 = 4 * d * eps * ((xb * xb).sum(1)[:, None] + yn[None, :])
        g0 = gp(d2)
        spread = (gp(d2 + dd2) - gp(torch.clamp_min(d2 - dd2, 0.0))).abs()
        tx[s:s + block] = 2 * torch.einsum("ij,ijk->ik", gb * (g0.abs() * rx + spread), diff.abs())
        ty += 2 * torch.einsum("ij,ijk->jk", gb * (g0.abs() * ry + spread), diff.abs())
        if kind == "rq":
            h0 = h(d2)
            dh = (h(d2 + dd2) - h0).abs() + (h(torch.clamp_min(d2 - dd2, 0.0)) - h0).abs()
            ta += float((gb * (h0.abs() * ra + dh)).sum())
    return tx, ty, ta


def _hold(got, ref, tol, what):
    """``got`` within ``tol`` (a tensor or a number) of ``ref``, entry by
    entry; returns the largest error and the largest error over tol."""
    check(got.shape == ref.shape and bool(torch.isfinite(got).all()), f"{what}: shape or not finite")
    err = (got.double() - ref.double()).abs()
    tol = torch.as_tensor(tol, dtype=torch.float64, device=err.device)
    over = float((err / tol.clamp_min(1e-300)).max())
    check(over <= 1.0, f"{what}: max |kernel - plain| {float(err.max())} exceeds its tolerance "
          f"({over} of it)")
    return float(err.max()), over


def _hold_bwd(kind, x, y, gbar, tag, results, same=False, want_y=True):
    """K1's backward (with rq's alpha) against its plain version, within
    ``_bwd_tols``; run twice, with equal bits. Returns the largest
    absolute error of the gradients."""
    from stheno_torch.ops import gram_bwd as KB

    kw = dict(want_y=want_y, want_alpha=True, same=same)
    got = KB.gram_bwd(kind, x, y, gbar, 1.3, **kw)
    again = KB.gram_bwd(kind, x, y, gbar, 1.3, **kw)
    ref = KB.gram_bwd_plain(kind, x, y, gbar, 1.3, **kw)
    torch.cuda.synchronize()
    check(all((a is None and b is None) or (a is not None and b is not None and torch.equal(a, b))
              for a, b in zip(got, again)), f"gram_bwd {kind} {tag}: two runs differ")
    check((got[1] is None) == (same or not want_y), f"gram_bwd {kind} {tag}: ybar {got[1]}")
    tx, ty, ta = _bwd_tols(kind, x, y, gbar, 1.3)
    if same:
        tx = tx + ty
    bf16 = x.dtype == torch.bfloat16
    case = {"kind": kind, "case": tag}
    errs = []
    for name, g, r, t in (("x", got[0], ref[0], tx), ("y", got[1], ref[1], ty)):
        if g is None:
            continue
        err, over = _hold(g, r, _bf16_tol(t, r) if bf16 else t, f"gram_bwd {kind} {tag} d/d{name}")
        case[f"{name}_max_abs_err"], case[f"{name}_of_tol"] = err, over
        errs.append(err)
    if kind == "rq":
        err, over = _hold(got[2].reshape(1), ref[2].reshape(1), ta, f"gram_bwd rq {tag} d/dalpha")
        case["alpha_abs_err"], case["alpha_of_tol"] = err, over
    results.append(case)
    return max(errs)


def phase_gram():
    """K1 and its backward against their plain versions on the card.

    Forward: all six kinds in float32, float64 and bfloat16 at the main
    path's shapes (the N=2000 training Gram and posterior cross Gram, the
    entry() step's cross Gram) and at the ragged 1000xd by 777xd for d in
    1, 2, 3, 8, 9, 17 (every depth template and the generic loop), within
    ``_gram_atol`` (bfloat16: ``_bf16_tol``); where x is y, every exp
    kind's diagonal exactly 1. Backward: every kind, dtype and depth of
    that list at 1000xd by 777xd (rq's alpha included), at x is y (both
    roles in one launch) and with only x wanting a gradient, within
    ``_bwd_tols``, each run twice with equal bits; then the main path's
    N=2000 Gram (x is y) in float32, the gradient through both kernels
    against autograd through the plain version there (rtol 1e-3), and one
    tile of the blocked sweep (8192 rows of the N=262,144 inputs against
    all of them, eq, float64).
    Returns the largest absolute errors of the forward and of the
    backward at the main path's shapes."""
    from stheno_torch.ops import gram as K1

    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape, dtype):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    xw, x1 = _warped(2000), torch.linspace(0.0, 10.0, 1024, device="cuda")[:, None]
    path = [(xw, xw, "2000x2 by 2000x2"), (xw, _warped(500), "2000x2 by 500x2"),
            (x1, x1[::4].contiguous(), "1024x1 by 256x1")]
    depths = (1, 2, 3, 8, 9, 17)
    results, diag, path_err = [], {}, 0.0
    for dtype in K1.DTYPES:
        cases = [(x.to(dtype), y.to(dtype), tag, True) for x, y, tag in path]
        cases += [(randn(1000, d, dtype=dtype), randn(777, d, dtype=dtype),
                   f"1000x{d} by 777x{d}", False) for d in depths]
        for kind in K1.KINDS:
            for x, y, tag, on_path in cases:
                K = K1.gram(kind, x, y, 1.3)
                P = K1.gram_plain(kind, x, y, 1.3)
                tol = _gram_atol(kind, x, y)
                if dtype == torch.bfloat16:
                    tol = _bf16_tol(tol, P)
                err, over = _hold(K, P, tol, f"gram {kind} {tag} {dtype}")
                check(K.dtype == dtype, f"gram {kind} {tag}: output dtype {K.dtype}")
                if kind == "eq" and dtype == torch.float32 and on_path:
                    path_err = max(path_err, err)
                results.append({"kind": kind, "case": f"{tag} {dtype}", "max_abs_err": err,
                                "of_tol": over})
        for d in depths:
            xs = randn(1000, d, dtype=dtype)
            for kind in ("eq", "rq", "matern12", "matern32", "matern52"):
                diag[f"{kind} d={d} {dtype}"] = float(
                    (K1.gram(kind, xs, xs, 1.3).diagonal().double() - 1).abs().max())
    check(all(e == 0 for e in diag.values()), f"gram: a diagonal is not exactly 1: {diag}")

    bwd = []
    for dtype in K1.DTYPES:
        for d in depths:
            x, y = randn(1000, d, dtype=dtype), randn(777, d, dtype=dtype)
            g, gsq = randn(1000, 777, dtype=dtype), randn(1000, 1000, dtype=dtype)
            for kind in K1.KINDS:
                tag = f"1000x{d} by 777x{d} {dtype}"
                _hold_bwd(kind, x, y, g, tag, bwd)
                _hold_bwd(kind, x, y, g, tag + ", x only", bwd, want_y=False)
                _hold_bwd(kind, x, x, gsq, f"1000x{d}, x is y, {dtype}", bwd, same=True)
    gw = randn(2000, 2000, dtype=torch.float32)
    bwd_err = max(_hold_bwd(kind, xw, xw, gw, "2000x2, x is y (the main path's)", bwd, same=True)
                  for kind in K1.KINDS)
    # The gradient through the kernels against autograd through the plain
    # version, at the path's shape. rtol 1e-3 of the largest gradient: the
    # JAX package's tolerance for its float32 W-trick (tests/test_pallas_gram.py).
    grads = []
    for kind in ("eq", "matern32", "rq"):
        out = []
        for fn in (K1.gram, K1.gram_plain):
            x = xw.clone().requires_grad_(True)
            y = (xw.flip(0) * 1.1).requires_grad_(True)
            alpha = torch.tensor(1.3, device="cuda", requires_grad=True)
            g = torch.autograd.grad((gw * fn(kind, x, y, alpha)).sum(), (x, y, alpha),
                                    allow_unused=True)
            out.append([torch.zeros(()) if t is None else t for t in g])
        for name, a, b in zip(("x", "y", "alpha"), *out):
            rel = max_err(a.cpu(), b.cpu()) / max(float(b.abs().max()), 1e-30)
            check(rel <= 1e-3, f"gram {kind} d/d{name} through the kernels: rel err {rel}")
            grads.append({"kind": kind, "wrt": name, "rel_err": rel})
    x64 = _path_inputs(torch.float64)[0][:, None]
    g64 = randn(8192, N_IT, dtype=torch.float64)
    _hold_bwd("eq", x64[:8192], x64, g64, f"8192x1 by {N_IT}x1 float64 (a blocked-sweep tile)",
              bwd)
    del g64, gw
    emit({"phase": "gram_vs_plain", "values": results, "diagonal_max_abs_err": diag,
          "backward": bwd, "grads": grads, "grad_rtol": 1e-3})
    return path_err, bwd_err


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


def _kernel_modules():
    from stheno_torch.ops import chol_tile as K2
    from stheno_torch.ops import gram as K1
    from stheno_torch.ops import gram_bwd as K1B
    from stheno_torch.ops import gram_matvec as K3
    from stheno_torch.ops import gram_matvec_vjp as K3V

    return {"gram": K1, "gram_bwd": K1B, "chol_tile": K2, "gram_matvec": K3,
            "gram_matvec_vjp": K3V}


def _counts():
    """The wrappers' launch counts: one per kernel module (``gram_matvec``
    all of K3's routes) and one per K3 route (``gram_matvec_<route>``)."""
    mods = _kernel_modules()
    counts = {k: mod.launches for k, mod in mods.items()}
    counts.update({f"gram_matvec_{r}": n for r, n in mods["gram_matvec"].route_launches.items()})
    return counts


def _set_counts(counts):
    mods = _kernel_modules()
    for k, mod in mods.items():
        mod.launches = counts[k]
    for r in mods["gram_matvec"].route_launches:
        mods["gram_matvec"].route_launches[r] = counts[f"gram_matvec_{r}"]


ZERO_COUNTS = {k: 0 for k in ("gram", "gram_bwd", "chol_tile", "gram_matvec", "gram_matvec_vjp",
                              "gram_matvec_mma", "gram_matvec_ffma", "gram_matvec_dmma")}


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

    fn, (x, y, x_new, params) = E.entry()
    x_nb = torch.linspace(0.0, 10.0, 500, device="cuda")
    xb, yb, ell = E.n2000_inputs()

    def posterior(x, y, ell, x_new):
        with torch.no_grad():
            f = GP(EQ().stretch(ell).periodic(torch.ones((), dtype=x.dtype, device=x.device)))
            noise = torch.full((), 0.1, dtype=x.dtype, device=x.device)
            return (f | (f(x, noise), y))(x_new).marginals()

    _set_counts(ZERO_COUNTS)
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
    check(after_vg["gram_bwd"] - after_value["gram_bwd"] >= 1,
          "value+grad at N=2000 launched no gram_bwd")
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


def device_ms_per_call(fn, inner=20):
    """``device_ms`` of ``inner`` calls back to back, per call."""
    return device_ms(lambda: [fn() for _ in range(inner)]) / inner


def k1_forward_times(K1, n, dtype):
    """K1 (``K1``: a checkout's ``stheno_torch.ops.gram``) per call, eq, at
    ``n x 2`` by ``n x 2`` warped inputs in ``dtype``: its CUDA-event time
    (``time_ms``: 20 calls back to back, 3 warm-ups, median of 20), its
    device time (``device_ms_per_call``), its bound (each input byte read
    once, each output byte written once, at 3.35 TB/s: the operations, a
    few per entry, bind far less), its plain version and the PyTorch call
    ``exp(-0.5 cdist^2)``, which the port never makes."""
    x = _warped(n).to(dtype)
    byts = (2 * n * 2 + n * n) * x.element_size()
    flops = n * n * (2 * 2 + 4) + 4 * n * 2
    b_ms, b_by = bound(byts, flops, torch.float64 if dtype == torch.float64 else torch.float32)
    call = lambda: K1.gram("eq", x, x)  # noqa: E731

    def library():
        return torch.exp(-0.5 * torch.cdist(x, x).square())

    try:
        lib_ms = time_ms(library, inner=5)
    except RuntimeError:  # no cdist for this dtype on this build
        lib_ms = None
    return {
        "shape": [n, n, 2], "dtype": str(dtype),
        "ms": time_ms(call, inner=20),
        "device_ms": device_ms_per_call(call),
        "plain_ms": time_ms(lambda: K1.gram_plain("eq", x, x), inner=5),
        "library_ms": lib_ms,
        "bound_ms": b_ms,
        "bound_by": b_by,
    }


def k1_cotangent(n):
    return torch.randn(n, n, generator=torch.Generator(device="cuda").manual_seed(17),
                       device="cuda")


def k1_backward_call(K1, kind, gbar):
    """``autograd.grad`` of a built N=2000 Gram (x is y, float32) with the
    cotangent ``gbar``, as the value+grad step runs it."""
    x = _warped(gbar.shape[0]).requires_grad_(True)
    K = K1.gram(kind, x, x)
    return lambda: torch.autograd.grad(K, x, gbar, retain_graph=True)


def k1_backward_times(K1, kind, gbar, plain=None):
    """K1's backward per call (``k1_backward_call``): its CUDA-event and
    device times, its bound (x and gbar read once, xbar written once, at
    3.35 TB/s; about 20 flops an entry), its plain version ``plain`` (the
    checkout's ``gram_bwd_plain``, None where it has none) and
    ``autograd.grad`` through ``exp(-0.5 cdist^2)`` (matern32: ``(1 + r)
    exp(-r)`` of ``sqrt(3) cdist``)."""
    n, r3 = gbar.shape[0], math.sqrt(3.0)
    lib_g = {"eq": lambda r: torch.exp(-0.5 * r.square()),
             "matern32": lambda r: (1 + r3 * r) * torch.exp(-r3 * r)}
    call = k1_backward_call(K1, kind, gbar)
    xd = _warped(n)
    xl = xd.clone().requires_grad_(True)
    KL = lib_g[kind](torch.cdist(xl, xl))
    b_ms, b_by = bound((2 * n * 2 + n * n) * 4, 20 * n * n, torch.float32)
    return {
        "kind": kind, "shape": [n, n, 2], "dtype": "torch.float32",
        "ms": time_ms(call, inner=20),
        "device_ms": device_ms_per_call(call),
        "plain_ms": None if plain is None else time_ms(
            lambda: plain(kind, xd, xd, gbar, same=True), reps=5, warmup=1),
        "library_ms": time_ms(lambda: torch.autograd.grad(KL, xl, gbar, retain_graph=True),
                              inner=5),
        "bound_ms": b_ms,
        "bound_by": b_by,
    }


def _k1_times():
    """K1 per call at the headline's Gram, 2000x2 by 2000x2, and at 8192x2
    by 8192x2, in float32, float64 and bfloat16 (``k1_forward_times``); its
    backward at N=2000, eq and matern32 (``k1_backward_times``). Returns the
    kernels line's two rows (the headline forward in float32 and the
    backward of eq) and every shape's numbers."""
    from stheno_torch.ops import gram as K1
    from stheno_torch.ops import gram_bwd as K1B

    forward = {f"{n}x2 {dtype}": k1_forward_times(K1, n, dtype)
               for n in (2000, 8192) for dtype in K1.DTYPES}
    gbar = k1_cotangent(2000)
    backward = {kind: k1_backward_times(K1, kind, gbar, K1B.gram_bwd_plain)
                for kind in ("eq", "matern32")}
    rows = [{"name": "gram", **forward["2000x2 torch.float32"]},
            {"name": "gram_bwd", **backward["eq"]}]
    return rows, {"forward": forward, "backward": backward}


def phase_times(errs, counts):
    """Times at the main path's shapes (CUDA events, 3 warm-up calls,
    median of 20 samples), beside each kernel's bound, its plain version
    and the nearest PyTorch library call (which the port never calls)."""
    from stheno_torch import entry as E
    from stheno_torch.ops import chol_tile as K2

    saved = _counts()
    kernels = []

    k1, k1_shapes = _k1_times()
    kernels.extend(k1)

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
    k3, k3_shapes = _k3_times()
    kernels.extend(k3)
    kernels.append(_vjp_times())
    # Launches made by the timing runs do not count: restore the paths'
    # counts.
    _set_counts(saved)
    emit({"phase": "times", "kernels": kernels, "gram_shapes": k1_shapes,
          "gram_matvec_shapes": k3_shapes, "flagship": step})

    line = []
    for k in kernels:
        line.append(
            {
                "name": k["name"],
                "route": "cuda",
                "source": KERNELS[k["name"]]["source"],
                "replaces": KERNELS[k["name"]]["replaces"],
                "launches": counts[k["name"]],
                "max_abs_err": max(errs[k["name"]], k.get("full_shape_max_abs_err", 0.0)),
                "ms": k["ms"],
                "plain_ms": k["plain_ms"],
                "bound_ms": k["bound_ms"],
                "bound_by": k["bound_by"],
                "library_ms": k["library_ms"],
            }
        )
    return line


# ---------------------------------------------------------------------------
# Kernel K3 and the matrix-free path.


def _gmv_atol_scale(kind, x, y, v):
    """``|G| @ |v|``, the scale of K3's sum: the entries of every kind but
    linear are positive, so ``|G| = G`` there."""
    from stheno_torch.ops import gram_matvec as K3

    if kind == "linear":
        return (x.abs() @ y.abs().T) @ v.abs()
    return K3.gram_matvec_plain(kind, x, y, v.abs(), 1.3)


def _gmv_rtol(m, dtype):
    """K3 and its plain version sum the same m products in other orders:
    a random walk of roundings, about sqrt(m) eps of ``|G| @ |v|``; 8 times
    that is the tolerance."""
    return 8 * math.sqrt(m) * torch.finfo(dtype).eps


def _path_inputs(dtype=torch.float32):
    from stheno_torch import entry as E

    return E.iterative_inputs(N_IT, device="cuda", dtype=dtype)


def phase_gram_matvec():
    """K3 against its plain version on the card, each case within
    ``_gmv_rtol`` of ``|G| @ |v|`` and reported with its route: every kind
    at a ragged shape in float32 and float64 at p = 5, 17 and 64 (float32:
    the FFMA route, then the tensor-core route; float64: the FP64
    tensor-core route); the matrix-free path's shapes (an 8192-row slice of
    the N=262,144 inputs against all columns for p in 1, 17, 64, 256, the
    same at p = 17 and 1 in float64, the CG and weights of float64 models,
    and the 4096-point mean query). Then, where x is y, the diagonal of
    every exp kind exactly g(0) = 1 in both dtypes; and the float64
    route's exp against ``torch.exp`` (``_exp_f64_ulps``). Returns the
    largest absolute error at the path's shapes, by route."""
    from stheno_torch.ops import gram_matvec as K3
    from stheno_torch.ops.gram import KINDS

    gen = torch.Generator(device="cuda").manual_seed(3)
    results, path_err = [], {f"gram_matvec_{r}": 0.0 for r in K3.route_launches}

    def hold(kind, x, y, v, tag, alpha=1.3):
        out = K3.gram_matvec(kind, x, y, v, alpha)
        ref = K3.gram_matvec_plain(kind, x, y, v, alpha)
        torch.cuda.synchronize()
        check(out.shape == ref.shape and bool(torch.isfinite(out).all()), f"gram_matvec {kind} {tag}")
        rtol = _gmv_rtol(y.shape[0], x.dtype)
        rel = float(((out - ref).abs() / _gmv_atol_scale(kind, x, y, v).clamp_min(1e-30)).max())
        route = K3.route(x.shape[0], y.shape[0], v.shape[1], x.dtype)[0]
        check(rel <= rtol, f"gram_matvec {kind} {tag} ({route}): error {rel} of |G||v| > {rtol}")
        results.append({"kind": kind, "case": tag, "route": route, "max_rel_err": rel,
                        "rtol": rtol})
        return f"gram_matvec_{route}", max_err(out, ref)

    def hold_path(*args):
        name, err = hold(*args)
        path_err[name] = max(path_err[name], err)

    for dtype in (torch.float32, torch.float64):
        x = torch.randn(3000, 2, generator=gen, device="cuda", dtype=dtype)
        y = torch.randn(2500, 2, generator=gen, device="cuda", dtype=dtype)
        for p in (5, 17, 64):
            v = torch.randn(2500, p, generator=gen, device="cuda", dtype=dtype)
            for kind in KINDS:
                hold(kind, x, y, v, f"3000x2 by 2500x2 p={p} {dtype}")

    x, _, _ = _path_inputs()
    x = x[:, None]
    rows = x[:8192]
    for p in (1, 17, 64, 256):
        v = torch.randn(N_IT, p, generator=gen, device="cuda")
        hold_path("eq", rows, x, v, f"8192x1 by {N_IT}x1 p={p}")
    x64 = _path_inputs(torch.float64)[0][:, None]
    for p in (17, 1):
        v = torch.randn(N_IT, p, generator=gen, device="cuda", dtype=torch.float64)
        hold_path("eq", x64[:8192], x64, v, f"8192x1 by {N_IT}x1 p={p} float64")
    del x64
    xq = torch.linspace(0.0, 10.0, 4096, device="cuda")[:, None]
    v = torch.randn(N_IT, 1, generator=gen, device="cuda")
    hold_path("eq", xq, x, v, f"4096x1 by {N_IT}x1 p=1")

    # x is y: d2 is exactly 0 on the diagonal, so g(0) = 1 exactly.
    diag = {}
    for dtype in (torch.float32, torch.float64):
        xs = torch.randn(4000, 1, generator=gen, device="cuda", dtype=dtype)
        eye = torch.eye(4000, device="cuda", dtype=dtype)[:, :64]
        for kind in ("eq", "matern12", "matern32", "matern52"):
            d = K3.gram_matvec(kind, xs, xs, eye)[:64].diagonal()
            diag[f"{kind} {dtype}"] = float((d - 1).abs().max())
    check(all(e == 0 for e in diag.values()), f"gram_matvec: a diagonal is not exactly 1: {diag}")
    exp_ulps = _exp_f64_ulps()
    check(exp_ulps <= 2, f"the float64 route's exp is {exp_ulps} ulp from torch.exp (> 2)")
    emit({"phase": "gram_matvec_vs_plain", "cases": results, "diagonal_max_abs_err": diag,
          "exp_f64_max_ulps": exp_ulps})
    return path_err


def _exp_f64_ulps(points=1 << 20):
    """The float64 route's exp (``csrc/gram_matvec_f64.cu:exp_neg_half``)
    against ``torch.exp`` on the card, in units in the last place of
    ``torch.exp``, at ``points`` arguments evenly over [-745, 0]: K3 of eq
    with x = sqrt(-2 a) against the single column y = 0 and v = 1 gives
    each row exactly exp(-0.5 fl(x^2)) (d2 = fl(x^2), one product by 1),
    the argument that torch.exp is given."""
    from stheno_torch.ops import gram_matvec as K3

    a = torch.linspace(-745.0, 0.0, points, dtype=torch.float64, device="cuda")
    x = torch.sqrt(-2 * a)[:, None]
    one = torch.ones((1, 1), dtype=torch.float64, device="cuda")
    got = K3.gram_matvec("eq", x, torch.zeros_like(one), one)[:, 0]
    ref = torch.exp(-0.5 * (x[:, 0] * x[:, 0]))
    ulp = torch.nextafter(ref, torch.full_like(ref, math.inf)) - ref
    return float(((got - ref).abs() / ulp).max())


# ---------------------------------------------------------------------------
# The fused Gram-gradient x V kernel: the backward of K3.


def _vjp_scale(kind, x, y, A, V, alpha, block=1024):
    """The scales of the Gram-gradient kernel's sums: per gradient entry
    ``2 sum_j (|A| |V|^T)_ij |g'_ij| |x_ik - y_jk|`` (linear: ``|A| (|V|^T
    |y|)``); for rq ``sum_ij (|A| |V|^T)_ij |dK/d alpha|_ij`` (else None);
    and of the value, ``sum_ij (|A| |V|^T)_ij |K_ij|``."""
    from stheno_torch.ops.gram import _alpha_factor, _apply_kind, _g_prime

    Aa, Va = A.abs(), V.abs()
    if kind == "linear":
        return Aa @ (Va.T @ y.abs()), None, float(torch.sum((Aa.T @ x.abs()) * (Va.T @ y.abs())))
    rows, total, vtotal = [], 0.0, 0.0
    for xb, Ab in zip(torch.split(x, block), torch.split(Aa, block)):
        diff = xb[:, None, :] - y[None, :, :]
        d2 = torch.sum(diff * diff, dim=-1)
        K = _apply_kind(kind, d2, None, alpha)
        S = Ab @ Va.T
        rows.append(2 * torch.einsum("ij,ijk->ik", S * _g_prime(kind, d2, K, alpha).abs(),
                                     diff.abs()))
        if kind == "rq":
            total += float(torch.sum(S * _alpha_factor(d2, K, alpha).abs()))
        vtotal += float(torch.sum(S * K.abs()))
    return torch.cat(rows), (total if kind == "rq" else None), vtotal


def phase_gram_matvec_vjp():
    """The fused Gram-gradient kernel against its plain version on the
    card: every kind (linear through its torch product) in float32 and
    float64 at 3000x2 by 2500x2 with q = 18 (cross) and at 3000x2 with x
    is y and both roles in one launch (q = 2 x 18, as the autograd
    Function runs the square Gram), rq's alpha included; then the path's
    shape, an 8192-row slice of the N=262,144 inputs against all of them
    with both roles (q = 2 x 17), float64. The gradient, rq's alpha and the
    value ``sum_ij (A V^T)_ij K_ij`` each within ``_gmv_rtol`` of its
    ``_vjp_scale``: kernel and plain version sum the same terms in other
    orders, as K3 and its plain version do. Returns the largest absolute
    error of the gradient at the path's shape."""
    from stheno_torch.ops import gram_matvec_vjp as K3V
    from stheno_torch.ops.gram import KINDS

    gen = torch.Generator(device="cuda").manual_seed(21)
    results = []

    def hold(kind, x, y, A, V, tag):
        got, dal, val = K3V.gram_matvec_vjp(kind, x, y, A, V, 1.3, alpha_grad=True, value=True)
        ref, dal_ref, val_ref = K3V.gram_matvec_vjp_plain(kind, x, y, A, V, 1.3,
                                                          alpha_grad=True, value=True)
        torch.cuda.synchronize()
        check(got.shape == x.shape and bool(torch.isfinite(got).all())
              and bool(torch.isfinite(val)), f"gram_matvec_vjp {kind} {tag}: shape or not finite")
        scale, ascale, vscale = _vjp_scale(kind, x, y, A, V, 1.3)
        rtol = _gmv_rtol(y.shape[0], x.dtype)
        rel = float(((got - ref).abs() / scale.clamp_min(1e-30)).max())
        check(rel <= rtol, f"gram_matvec_vjp {kind} {tag}: error {rel} of its scale > {rtol}")
        vrel = abs(float(val) - float(val_ref)) / max(vscale, 1e-30)
        check(vrel <= rtol, f"gram_matvec_vjp {kind} {tag} value: error {vrel} of its scale")
        case = {"kind": kind, "case": tag, "max_rel_err": rel, "value_rel_err": vrel,
                "rtol": rtol}
        if kind == "rq":
            case["alpha_rel_err"] = abs(float(dal) - float(dal_ref)) / max(ascale, 1e-30)
            check(case["alpha_rel_err"] <= rtol, f"gram_matvec_vjp rq {tag} alpha: {case}")
        results.append(case)
        return max_err(got, ref)

    def randn(*shape, dtype=torch.float64):
        return torch.randn(*shape, generator=gen, device="cuda", dtype=dtype)

    for dtype in (torch.float32, torch.float64):
        x, y = randn(3000, 2, dtype=dtype), randn(2500, 2, dtype=dtype)
        A, Vx = randn(3000, 18, dtype=dtype), randn(3000, 18, dtype=dtype)
        V = randn(2500, 18, dtype=dtype)
        for kind in KINDS:
            hold(kind, x, y, A, V, f"3000x2 by 2500x2 q=18 {dtype}")
            hold(kind, x, x, torch.cat([A, Vx], 1), torch.cat([Vx, A], 1),
                 f"3000x2 square, both roles (q=36) {dtype}")
    x = _path_inputs(torch.float64)[0][:, None]
    A, V = randn(8192, 17), randn(N_IT, 17)
    Vx, Ax = randn(8192, 17), randn(N_IT, 17)
    path_err = hold("eq", x[:8192], x, torch.cat([A, Vx], 1), torch.cat([V, Ax], 1),
                    f"8192x1 by {N_IT}x1 q=34 float64")
    emit({"phase": "gram_matvec_vjp_vs_plain", "cases": results})
    return path_err


def _dense_posterior(x, y, params, x_new):
    """The exact NLML with its gradients and the posterior marginals at
    ``x_new`` through the ported dense path (``Measure.logpdf``,
    conditioning), for the matrix-free path's model."""
    from stheno_torch import GP
    from stheno_torch import entry as E

    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    noise = torch.tensor(E.ITERATIVE_NOISE, dtype=x.dtype, device=x.device)
    with torch.enable_grad():
        f = GP(E.iterative_kernel(leaves))
        val = -f.measure.logpdf(f(x, noise), y)
        grads = torch.autograd.grad(val, list(leaves.values()))
    with torch.no_grad():
        f = GP(E.iterative_kernel(params))
        mean, var = (f | (f(x, noise), y))(x_new).marginals()
    return val.detach(), dict(zip(leaves, grads)), mean, var


def phase_iterative():
    """The matrix-free path at N=262,144, float32, driven once through the
    entry points with every count at 0: the shared preconditioner, the
    fresh and the amortised training step, the weights, the cached mean at
    4096 points, the variance cache and the cached variance at 2048
    points, and the serving bundle. Every CG must converge and every
    output be finite; K3 must launch in each forward sweep and the fused
    Gram-gradient kernel, once, (not K1) in each step's backward. The
    variance-cache build is timed here (one run).
    Returns the path's launch counts, its preconditioner state and
    variance cache, and that time."""
    from stheno_torch import entry as E

    x, y, params = _path_inputs()
    gen = torch.Generator(device="cuda").manual_seed(7)
    x_mean = torch.linspace(0.0, 10.0, 4096, device="cuda")
    x_var = torch.linspace(0.0, 10.0, 2048, device="cuda")
    report, deltas = {"phase": "iterative_path", "n": N_IT}, {}

    def leg(name, fn):
        before = _counts()
        out = fn()
        torch.cuda.synchronize()
        after = _counts()
        deltas[name] = {k: after[k] - before[k] for k in after}
        check(deltas[name]["gram_matvec"] >= 1, f"{name}: K3 did not launch")
        return out

    _set_counts(ZERO_COUNTS)
    state = leg("precond_build", lambda: E.iterative_precond_state(x, params, gen))
    steps = {}
    for name, kw in (("step", {}), ("amortised_step", {"precond_state": state})):
        val, grads, info = leg(name, lambda kw=kw: E.iterative_step(x, y, params, gen, **kw))
        check(deltas[name]["gram_matvec_vjp"] == 1,
              f"{name}: the fused Gram-gradient kernel launched {deltas[name]['gram_matvec_vjp']} "
              "times in the surrogate backward, not once")
        check(deltas[name]["gram"] == 0, f"{name}: K1 launched {deltas[name]['gram']} times")
        check(info["cg_converged"], f"{name}: CG did not converge ({info})")
        check(all(bool(torch.isfinite(t)) for t in (val, *grads.values())), f"{name} not finite")
        steps[name] = {"nlml": float(val), "cg_iters": info["cg_iters"],
                       "cg_rel_residual": float(info["cg_rel_residual"]),
                       **{f"grad_{k}": float(g) for k, g in grads.items()}}
    alpha, winfo = leg("weights", lambda: E.serving_weights(x, y, params, state))
    check(float(winfo["rel_residual"]) <= 1e-4, f"weights: CG did not converge ({winfo})")
    # With libdevice's expf in K3's FFMA route this solve took 5
    # iterations; its base-2 exps may add at most one.
    check(winfo["iters"] <= 5 + 1, f"weights: CG took {winfo['iters']} iterations")
    mean = leg("cached_mean", lambda: E.serving_mean(x, params, alpha, x_mean))
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    cache = leg("var_cache_build", lambda: E.serving_variance_cache(x, params, gen))
    end.record()
    end.synchronize()
    build_s = start.elapsed_time(end) / 1e3
    var = E.serving_var(x, params, cache, x_var)
    bundle = leg("serving_bundle",
                 lambda: E.serving_bundle(x, y, params, gen, precond_state=state))
    b_mean, b_var = bundle.mean(x_var), bundle.var(x_var)
    torch.cuda.synchronize()
    counts = _counts()
    check(float(bundle.solve_info["rel_residual"]) <= 1e-4, "serving bundle: weights unconverged")
    for name, t, xq in (("mean", mean, x_mean), ("var", var, x_var), ("bundle_mean", b_mean, x_var),
                        ("bundle_var", b_var, x_var)):
        check(t.shape == xq.shape and bool(torch.isfinite(t).all()), f"{name}: shape or not finite")
    check(bool((var >= 0).all()), "cached variance negative")
    report.update({
        "launches": counts,
        "launches_by_leg": deltas,
        "steps": steps,
        "weights": {"cg_iters": winfo["iters"], "rel_residual": float(winfo["rel_residual"])},
        "mean_range": [float(mean.min()), float(mean.max())],
        "var_range": [float(var.min()), float(var.max())],
        "bundle_mean_vs_mean_max_abs": max_err(b_mean, E.serving_mean(x, params, alpha, x_var)),
        "var_cache_build_s": build_s,
    })
    emit(report)
    return counts, state, cache, build_s


def _rel_grads(grads, ref):
    return {k: _rel(grads[k], ref[k]) for k in grads}


def _surrogate_gate(x, y, params, state, gen):
    """The amortised step's surrogate gradient, float64 (as the step sweeps
    it), through the fused route (one launch of the fused Gram-gradient
    kernel for the Gram term's value and gradients, no K3) against the
    same gradient by the blocked sweep under ``config.accurate_dists()``
    (plain torch tiles of direct differences, 1024 rows at a time,
    checkpointed): one forward solve of the path's float32 step at
    N=262,144 gives both the same ``(U, w, alpha)``, so only the sweep
    differs. Gate: each leaf's gradient within rel 1e-6. Beside it the
    surrogate's Gram term ``sum(A * (K V))``, ``A = 0.5 [U / p, -alpha]``
    and ``V = [w, alpha]``, by the fused route and by the old route's
    forward, K3's float64 sweep (``_GramMatvecFn``'s forward): rel <=
    1e-10."""
    from stheno_torch import config
    from stheno_torch import entry as E
    from stheno_torch.iterative import matvec as M
    from stheno_torch.iterative import nlml as NL

    names = list(params)
    u = torch.randn(N_IT, 16, generator=gen, device="cuda")
    noise = torch.tensor(E.ITERATIVE_NOISE, device="cuda")

    def cfg(block):
        return NL._Config(names, E.iterative_kernel, block, 1e-2, 200, 30, 64, "eig", 1)

    with torch.no_grad():
        _, health, alpha, U, w = NL._nlml_forward(cfg(8192), params, y, noise, x[:, None], u,
                                                  None, state)
    check(health["cg_converged"], f"surrogate gate: CG did not converge ({health})")
    leaves = [t.double() for t in params.values()]
    need = [True] * len(leaves) + [False, False]
    grads, launches, secs = {}, {}, {}
    for route, block, accurate in (("fused", 8192, False), ("blocked_accurate_dists", 1024, True)):
        before, t0 = _counts(), time.perf_counter()
        with config.accurate_dists(accurate):
            g = NL._surrogate_grads(cfg(block), leaves, noise.double(), x.double()[:, None], U, w,
                                    alpha, need)
        torch.cuda.synchronize()
        secs[route] = time.perf_counter() - t0
        after = _counts()
        launches[route] = {k: after[k] - before[k] for k in after}
        grads[route] = dict(zip(names, g))
    kern = E.iterative_kernel(dict(zip(names, leaves)))
    p = w.shape[1]
    A = 0.5 * torch.cat([U / p, -alpha[:, None]], dim=1).double()
    V = torch.cat([w, alpha[:, None]], dim=1).double()
    with torch.no_grad():
        fused = M._kernel_bilinear(kern, x.double()[:, None], A, V)
        k3 = torch.sum(A * M.kernel_matvec(kern, x.double()[:, None], V))
    return {
        "grad_fused": {k: float(t) for k, t in grads["fused"].items()},
        "grad_blocked": {k: float(t) for k, t in grads["blocked_accurate_dists"].items()},
        "grad_rel": _rel_grads(grads["fused"], grads["blocked_accurate_dists"]),
        "gram_term_fused": float(fused),
        "gram_term_k3_f64": float(k3),
        "gram_term_rel": _rel(fused, k3),
        "launches": launches,
        "seconds": secs,
    }


def _check_surrogate_gate(gate):
    launches = gate["launches"]
    check(launches["fused"] == {**ZERO_COUNTS, "gram_matvec_vjp": 1},
          f"surrogate gate: the fused route's launches {launches['fused']}")
    check(launches["blocked_accurate_dists"]["gram_matvec_vjp"] == 0,
          f"surrogate gate: the blocked route launched the fused kernel {launches}")
    check(all(r <= 1e-6 for r in gate["grad_rel"].values()), f"surrogate gate {gate}")
    check(gate["gram_term_rel"] <= 1e-10, f"surrogate gate: the Gram term {gate}")


def phase_iterative_gates(state32):
    """Correctness gates of the matrix-free path, on the card:

    - N=8192, float64: the NLML and its gradients against the exact NLML
      of the ported dense path (``Measure.logpdf``), and the cached mean
      and variance against the dense posterior. 4096 probes keep the
      Hutchinson noise of the gradient estimate below the gate (16 probes
      alone scatter it by tens of percent at this size).
    - N=262,144: the float32 step against the same step in float64 on
      the card, with the same probes and state, both at cg_tol 1e-3 (the
      float64 run at block 2048 for memory). 1e-3 is about as far as the
      float32 solve of the probe columns gets here: each product sums
      some 65,000 entries of order 1 per row, so its rounding (about
      3e-5) against the noise term 0.1 v floors the whitened residual
      near 3e-4; runs at 1e-6 and 1e-4 wandered (residual 0.13 after 500
      iterations, 0.04 after 200). The weights solve (y alone) reaches
      1e-4.

    NLML rel <= 1e-3 and gradients rel <= 5e-2, as the main path's
    gates; the mean and variance within 1e-4 of the largest dense value.
    Then ``_surrogate_gate``: the fused surrogate gradient against the
    blocked sweep's, rel <= 1e-6. The N=262,144 float64 step is the
    float64 path: its wall seconds are reported, and it runs with every
    count at 0, so that K3's float64 route is read from it (and no other
    route may launch there). Returns those counts."""
    from stheno_torch import entry as E
    from stheno_torch.iterative import nlml as NL

    report = {"phase": "iterative_gates"}
    gen = torch.Generator(device="cuda").manual_seed(11)
    x, y, params = E.iterative_inputs(8192, device="cuda", dtype=torch.float64)
    x_new = torch.linspace(-0.5, 10.5, 1000, device="cuda", dtype=torch.float64)
    ref_v, ref_g, ref_mean, ref_var = _dense_posterior(x, y, params, x_new)
    state = E.iterative_precond_state(x, params, gen)
    val, grads, info = E.iterative_step(x, y, params, gen, precond_state=state, num_probes=4096,
                                        cg_tol=1e-8, max_cg_iters=500)
    alpha, winfo = E.serving_weights(x, y, params, state, cg_tol=1e-8, max_cg_iters=500)
    mean = E.serving_mean(x, params, alpha, x_new)
    cache = E.serving_variance_cache(x, params, gen, cg_tol=1e-6, max_cg_iters=50)
    var = E.serving_var(x, params, cache, x_new)
    g8 = {
        "nlml": float(val), "nlml_exact": float(ref_v), "nlml_rel": _rel(val, ref_v),
        "grad_rel": _rel_grads(grads, ref_g), "cg_iters": info["cg_iters"],
        "weights_cg_iters": winfo["iters"],
        "mean_max_abs_err": max_err(mean, ref_mean), "var_max_abs_err": max_err(var, ref_var),
    }
    report["n8192_f64"] = g8
    check(info["cg_converged"] and float(winfo["rel_residual"]) <= 1e-8, f"N=8192 CG {g8}")
    check(g8["nlml_rel"] <= 1e-3, f"N=8192 NLML {g8}")
    check(all(r <= 5e-2 for r in g8["grad_rel"].values()), f"N=8192 gradients {g8}")
    check(g8["mean_max_abs_err"] <= 1e-4 * max(1.0, float(ref_mean.abs().max())), f"N=8192 mean {g8}")
    check(g8["var_max_abs_err"] <= 1e-4 * max(1.0, float(ref_var.abs().max())), f"N=8192 var {g8}")

    x32, y32, p32 = _path_inputs()
    u32 = torch.randn(N_IT, 16, generator=gen, device="cuda")
    out, secs = {}, {}
    for dtype, block in ((torch.float32, 8192), (torch.float64, 2048)):
        leaves = {k: v.to(dtype).requires_grad_(True) for k, v in p32.items()}
        args = (y32.to(dtype), E.ITERATIVE_NOISE, x32.to(dtype)[:, None], u32.to(dtype), None,
                tuple(t.to(dtype) for t in state32))
        torch.cuda.synchronize()
        if dtype == torch.float64:
            # The float64 path: K3's float64 route is read from this step.
            _set_counts(ZERO_COUNTS)
        t0 = time.perf_counter()
        with torch.enable_grad():
            v, h = NL._nlml(leaves, *args, E.iterative_kernel, 1e-3, 200, 30, 64, "eig",
                            block=block)
            g = dict(zip(leaves, torch.autograd.grad(v, list(leaves.values()))))
        torch.cuda.synchronize()
        secs[dtype] = time.perf_counter() - t0
        check(h["cg_converged"], f"N={N_IT} {dtype} step at cg_tol 1e-3: {h}")
        out[dtype] = (v.detach(), g, h)
    f64_counts = _counts()
    check(f64_counts["gram_matvec_dmma"] >= 1 and f64_counts["gram_matvec"] ==
          f64_counts["gram_matvec_dmma"],
          f"the N={N_IT} float64 step's K3 launches {f64_counts}")
    (v32, g32, h32), (v64, g64, h64) = out[torch.float32], out[torch.float64]
    big = {
        "nlml_f32": float(v32), "nlml_f64": float(v64), "nlml_rel": _rel(v32, v64),
        "grad_f32": {k: float(t) for k, t in g32.items()},
        "grad_f64": {k: float(t) for k, t in g64.items()},
        "grad_rel": _rel_grads(g32, g64),
        "cg_iters_f32": h32["cg_iters"], "cg_iters_f64": h64["cg_iters"],
        "cg_rel_residual_f32": float(h32["cg_rel_residual"]),
        "cg_rel_residual_f64": float(h64["cg_rel_residual"]),
        "step_f32_wall_s": secs[torch.float32],
        "step_f64_wall_s": secs[torch.float64],
        "step_f64_launches": f64_counts,
    }
    report[f"n{N_IT}_f32_vs_f64"] = big
    gate = report[f"n{N_IT}_surrogate_fused_vs_blocked"] = _surrogate_gate(
        x32, y32, p32, state32, gen)
    emit(report)
    _check_surrogate_gate(gate)
    check(big["nlml_rel"] <= 1e-3, f"N={N_IT} f32 NLML {big}")
    # With the FFMA K3 this solve took 4 iterations in float32 (2 in
    # float64); the tensor-core product may add at most one: it must leave
    # the operator CG sees intact.
    check(big["cg_iters_f32"] <= 4 + 1, f"N={N_IT} f32 CG took {big['cg_iters_f32']} iterations")
    check(all(r <= 5e-2 for r in big["grad_rel"].values()), f"N={N_IT} f32 gradients {big}")
    return f64_counts


def _k3_times():
    """K3 per call at the matrix-free path's shapes (CUDA events, one
    warm-up, median of 3): the full N=262,144 square sweep at p = 17 (the
    CG solve), 64 (the preconditioner), 256 (the variance basis) and 1
    (the weights), and the 4096-point mean query, in float32; at p = 17
    and 1 in float64 (a float64 model's CG and weights). Beside each its
    route and launch shape, its device time (``device_ms``: the kernel and
    the column split's sum, no host time), its bounds, its plain version,
    and the sweep a PyTorch user would write over the same row blocks,
    ``exp(-0.5 cdist(xb, y)^2) @ v`` (the library call; the port never
    makes it). float32: ``bound_ms`` is the bound of the design on the
    card's units (``mma_bound``: the TF32 products, the FP32 distance, the
    exps at the special-function rate, the bytes), with the unit that
    binds; ``fp32_bound_ms`` the bound by operations at the FP32 rate
    alone (the exp charged as four flops), kept so that times against it
    stay comparable with earlier runs. float64: ``k3_f64_bound``.
    Returns the kernels line's three rows (p = 17, the tensor-core route;
    p = 1, the FFMA route; float64 p = 17, the float64 route) and every
    shape's numbers."""
    from stheno_torch.ops import gram_matvec as K3

    exps_per_s, mhz = sfu_exps_per_s()
    gen = torch.Generator(device="cuda").manual_seed(5)
    x = _path_inputs()[0][:, None]
    x64 = _path_inputs(torch.float64)[0][:, None]
    xq = torch.linspace(0.0, 10.0, 4096, device="cuda")[:, None]
    shapes = {}
    for tag, rows, p, cols in (("p17", x, 17, x), ("p64", x, 64, x), ("p256", x, 256, x),
                               ("p1", x, 1, x), ("query4096_p1", xq, 1, x),
                               ("p17_f64", x64, 17, x64), ("p1_f64", x64, 1, x64)):
        dtype = rows.dtype
        v = torch.randn(N_IT, p, generator=gen, device="cuda", dtype=dtype)
        n, m, d = rows.shape[0], N_IT, 1

        def library(rows=rows, v=v, cols=cols):
            return torch.cat([torch.exp(-0.5 * torch.cdist(xb, cols).square()) @ v
                              for xb in torch.split(rows, 8192)])

        byts = (n * d + m * d + m * p + n * p) * rows.element_size()
        if dtype == torch.float64:
            b_ms, b_unit, dfma_ms = k3_f64_bound(byts, n, m, d, p)
            extra = {"dfma_bound_ms": dfma_ms}
        else:
            b_ms, b_unit = mma_bound(byts, n, m, d, p, exps_per_s)
            f_ms, f_by = bound(byts, n * m * (2 * d + 4 + 2 * p) + 2 * (n + m) * d, dtype)
            extra = {"fp32_bound_ms": f_ms, "fp32_bound_by": f_by}
        slow = n * p > 8192 * 64 or dtype == torch.float64
        call = lambda rows=rows, v=v, cols=cols: K3.gram_matvec("eq", rows, cols, v)  # noqa: E731
        shapes[tag] = {
            "shape": [n, m, d, p],
            "dtype": str(dtype),
            "route": K3.route(n, m, p, dtype),
            "ms": time_ms(call, reps=3, warmup=1),
            "device_ms": device_ms(call, reps=1 if slow else 3),
            "plain_ms": time_ms(lambda: K3.gram_matvec_plain("eq", rows, cols, v),
                                reps=1 if slow else 3, warmup=1),
            "library_ms": time_ms(library, reps=1 if slow else 3, warmup=1),
            "bound_ms": b_ms,
            "bound_unit": b_unit,
            "bound_by": "bytes" if b_unit == "bytes" else "operations",
            **extra,
        }
    rows = [{"name": name, **shapes[tag], "sm_clock_mhz": mhz}
            for name, tag in (("gram_matvec_mma", "p17"), ("gram_matvec_ffma", "p1"),
                              ("gram_matvec_dmma", "p17_f64"))]
    return rows, shapes


def k3_f64_bound(bytes_moved, n, m, d, p):
    """The least time of K3's product in float64, in ms, and what binds
    it, in ``vjp_bound``'s style: per Gram entry the p-wide product (2p
    flops) at the FP64 tensor-core rate; the distance and epilogue (2d + 4
    flops, the exp charged 4 as in K3's FP32 bound) at the FP64 rate; the
    bytes. Also the bound with every flop at the FP64 (DFMA) rate, the
    bound of the FFMA route as built. Returns ``(ms, unit, dfma_ms)``."""
    entries = n * m
    times = {
        "fp64_tc_products": entries * 2 * p / FP64_TC_FLOPS * 1e3,
        "fp64_distance_epilogue": entries * (2 * d + 4) / PEAK_FLOPS[torch.float64] * 1e3,
        "bytes": bytes_moved / HBM_BYTES_PER_S * 1e3,
    }
    unit = max(times, key=times.get)
    dfma_ms = entries * (2 * p + 2 * d + 4) / PEAK_FLOPS[torch.float64] * 1e3
    return times[unit], unit, max(dfma_ms, times["bytes"])


def vjp_bound(n, m, d, q, symmetric=False, value=False):
    """The least time of the float64 fused Gram-gradient work, in ms, and
    what binds it, in ``mma_bound``'s style: per Gram entry the q-wide dot
    A_i . V_j (2q flops) at the FP64 tensor-core rate; the difference and
    d2 (3d flops), one exp (charged 4 flops, as K3's FP32 bound charges it;
    float64 has no special-function unit, so its exp runs on the FP64
    units), W = s g' (1), the gradient's FMAs (2d) and with ``value`` the
    value's one flop at the FP64 rate; the bytes of x, y, A and V read
    once and xbar (and the value) written once. Also the bound
    with every flop at the FP64 (DFMA) rate, the bound of a kernel without
    tensor cores. With ``symmetric`` (x is y, A = [A0, V0] and V = [V0,
    A0]: both roles of the square Gram in one call) the work is that of
    the n (n + 1) / 2 unordered pairs: A_i . V_j = A_j . V_i, and one exp
    and one difference serve both entries of a pair, whose term adds to
    both rows (3d flops for the gradient). Returns ``(ms, unit, dfma_ms,
    bytes)``."""
    entries = n * (n + 1) / 2 if symmetric else n * m
    rest = 3 * d + (3 * d if symmetric else 2 * d) + 1 + 4 + int(value)  # exp charged 4 flops
    byts = (2 * n * d + m * d + n * q + m * q + int(value)) * 8
    times = {
        "fp64_tc_dot": entries * 2 * q / FP64_TC_FLOPS * 1e3,
        "fp64_elementwise": entries * rest / PEAK_FLOPS[torch.float64] * 1e3,
        "bytes": byts / HBM_BYTES_PER_S * 1e3,
    }
    unit = max(times, key=times.get)
    dfma_ms = entries * (2 * q + rest) / PEAK_FLOPS[torch.float64] * 1e3
    return times[unit], unit, max(dfma_ms, times["bytes"]), byts


def _vjp_times():
    """The fused Gram-gradient kernel per call at the surrogate's shape, as
    the training step launches it: both roles of the N=262,144 square Gram
    in one launch (x is y, A' = [A, V], V' = [V, A] with q = 17 each, so 34
    panel columns), d = 1, float64, with the value. CUDA events (one
    warm-up, median of 3) and ``device_ms``; beside them its bounds
    (``vjp_bound`` with the value: ``bound_ms`` of the symmetric work,
    which the function needs, and ``ordered_bound_ms`` of all N^2 ordered
    entries, which the kernel sweeps), its plain version (one run, whose
    gradient and value the kernel's are held to within ``_gmv_rtol`` of
    ``_vjp_scale``: the path's own launch shape, entry by entry) and the
    library route a PyTorch user would take for the same gradient and
    value, one run: ``torch.autograd.grad`` of ``sum(A_b * (exp(-0.5
    cdist(x_b, x)^2) @ V))`` over row blocks of 2048 with x a leaf (both
    roles), which the port never calls."""
    from stheno_torch.ops import gram_matvec_vjp as K3V

    gen = torch.Generator(device="cuda").manual_seed(23)
    x = _path_inputs(torch.float64)[0][:, None]
    q = 17
    A, V = (torch.randn(N_IT, q, generator=gen, device="cuda", dtype=torch.float64)
            for _ in range(2))
    A2, V2 = torch.cat([A, V], 1), torch.cat([V, A], 1)
    call = lambda: K3V.gram_matvec_vjp("eq", x, x, A2, V2, value=True)  # noqa: E731

    def library():
        xl = x.detach().requires_grad_(True)
        total, value = torch.zeros_like(x), 0.0
        for s in range(0, N_IT, 2048):
            out = torch.sum(A[s:s + 2048] * (
                torch.exp(-0.5 * torch.cdist(xl[s:s + 2048], xl).square()) @ V))
            (g,) = torch.autograd.grad(out, xl)
            total += g
            value += out.detach()
        return total, value

    plain = {}

    def run_plain():
        plain["xbar"], _, plain["value"] = K3V.gram_matvec_vjp_plain("eq", x, x, A2, V2,
                                                                      value=True)

    plain_ms = time_ms(run_plain, reps=1, warmup=0)
    got, _, value = call()
    scale, _, vscale = _vjp_scale("eq", x, x, A2, V2, 1.0)
    rtol = _gmv_rtol(N_IT, torch.float64)
    rel = float(((got - plain["xbar"]).abs() / scale.clamp_min(1e-30)).max())
    vrel = abs(float(value) - float(plain["value"])) / vscale
    check(got.shape == x.shape and bool(torch.isfinite(got).all())
          and bool(torch.isfinite(value)), "gram_matvec_vjp at the path's shape: shape or not finite")
    check(rel <= rtol, f"gram_matvec_vjp at the path's shape: error {rel} of its scale > {rtol}")
    check(vrel <= rtol, f"gram_matvec_vjp value at the path's shape: error {vrel} of its scale")
    err = max_err(got, plain["xbar"])
    del plain, got, scale
    b_ms, b_unit, dfma_ms, byts = vjp_bound(N_IT, N_IT, 1, 2 * q, symmetric=True, value=True)
    o_ms, o_unit, o_dfma_ms, _ = vjp_bound(N_IT, N_IT, 1, 2 * q, value=True)
    return {
        "name": "gram_matvec_vjp",
        "shape": [N_IT, N_IT, 1, 2 * q],
        "launch_shape": K3V.launch_shape(N_IT, N_IT, 2 * q, 1, 8),
        "ms": time_ms(call, reps=3, warmup=1),
        "device_ms": device_ms(call),
        "plain_ms": plain_ms,
        "library_ms": time_ms(library, reps=1, warmup=0),
        "full_shape_max_abs_err": err,
        "full_shape_max_rel_err": rel,
        "full_shape_value_rel_err": vrel,
        "full_shape_rtol": rtol,
        "bound_ms": b_ms,
        "bound_unit": b_unit,
        "bound_by": "bytes" if b_unit == "bytes" else "operations",
        "dfma_bound_ms": dfma_ms,
        "ordered_bound_ms": o_ms,
        "ordered_bound_unit": o_unit,
        "ordered_dfma_bound_ms": o_dfma_ms,
        "bound_bytes": byts,
    }


def phase_path_times(state, cache, build_s):
    """The matrix-free path's steps under bench.py's suite names: CUDA
    events around each call, one warm-up and the median of 3 (the
    variance-cache build: its one timed run in ``phase_iterative``); the
    peak device memory of the amortised step, in all and less what was
    allocated when it started (its own)."""
    from stheno_torch import entry as E

    saved = _counts()
    x, y, params = _path_inputs()
    gen = torch.Generator(device="cuda").manual_seed(9)
    alpha, _ = E.serving_weights(x, y, params, state)
    x_mean = torch.linspace(0.0, 10.0, 4096, device="cuda")
    x_var = torch.linspace(0.0, 10.0, 2048, device="cuda")

    def secs(fn):
        return time_ms(fn, reps=3, warmup=1) / 1e3

    out = {
        "iterative_n262144_precond_build_s": secs(lambda: E.iterative_precond_state(x, params, gen)),
        "iterative_n262144_step_s": secs(lambda: E.iterative_step(x, y, params, gen)),
    }
    torch.cuda.synchronize()
    # Earlier phases leave reference cycles that hold tensors until the
    # collector next runs: free them, so that the peak counts live memory.
    gc.collect()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    before = _counts()
    out["iterative_n262144_amortised_step_s"] = secs(
        lambda: E.iterative_step(x, y, params, gen, precond_state=state))
    out["amortised_step_max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()
    # The step's own peak: what earlier phases leave allocated cannot move it.
    out["amortised_step_own_peak_bytes"] = torch.cuda.max_memory_allocated() - held
    out["amortised_step_held_bytes"] = held
    # Four steps ran (a warm-up and three samples): launches per step.
    per_step = {k: (v - before[k]) / 4 for k, v in _counts().items()}
    out["amortised_step_launches"] = per_step
    check(per_step["gram_matvec_vjp"] == 1 and per_step["gram"] == 0,
          f"the amortised step's launches {per_step}")
    out["posterior_weights_n262144_s"] = secs(lambda: E.serving_weights(x, y, params, state))
    out["cached_posterior_mean_n262144_s"] = secs(lambda: E.serving_mean(x, params, alpha, x_mean))
    out["var_cache_build_n262144_s"] = build_s
    out["cached_posterior_var_n262144_s"] = secs(lambda: E.serving_var(x, params, cache, x_var))
    _set_counts(saved)
    emit({"phase": "iterative_times", **out})


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


def _profile(label, fn):
    """Run ``fn`` once under torch.profiler: ``(span_us, busy_us,
    by_name, launches)``, with the step's span from its start on the host
    to the end of its last device activity, the device's busy time in it,
    ``{kernel: (launches, device_us)}`` and the wrappers' counts of the
    run. The profiler slows the host, so busy / span is a lower bound."""
    before = _counts()
    span_us, busy_us, by_name = trace(label, fn)
    after = _counts()
    return span_us, busy_us, by_name, {k: after[k] - before[k] for k in after}


def trace(label, fn):
    """``_profile`` without the wrappers' counts: ``(span_us, busy_us,
    by_name)`` of one run of ``fn``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        # The tracer can drop a session's first device records: give it a
        # kernel and a synchronise before the step, and count only what
        # starts after the step does.
        torch.cuda._sleep(1_000_000)
        torch.cuda.synchronize()
        with record_function(label):
            fn()
            torch.cuda.synchronize()
    events = prof.events()
    # The annotation is recorded twice, on the host and as a device span;
    # only the host one marks the step's start, and neither is a kernel.
    (step,) = [e for e in events if e.name == label and e.device_type == DeviceType.CPU]
    device = [
        e
        for e in events
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation and e.name != label
        and e.time_range.start >= step.time_range.start
    ]
    check(device, "the profiler recorded no device activity")
    intervals = [(e.time_range.start, e.time_range.end) for e in device]
    span_us = max(step.time_range.end, max(e for _, e in intervals)) - step.time_range.start
    by_name = {}
    for e in device:
        n, us = by_name.get(_kernel_name(e.name), (0, 0.0))
        by_name[_kernel_name(e.name)] = (n + 1, us + e.time_range.end - e.time_range.start)
    return span_us, _union_length(intervals), by_name


def _top(by_name, k=12):
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:k]
    return [{"name": n, "launches": c, "device_ms": us / 1e3} for n, (c, us) in top]


def _attribute(fn, names, depth=4):
    """For each kernel of ``names``, where the step launched it: one run of
    ``fn`` under ``torch.profiler`` with input shapes and Python stacks,
    each device kernel taken from the host op the profiler links it to
    (its ``kernels``): the op, its input shapes, the names of its first
    ``depth`` parents (an autograd node names the backward it runs) and
    the innermost frames of ``stheno_torch`` on its stack or its parents'.
    Returns ``{kernel: [{"op", "shapes", "parents", "frames",
    "launches"}]}`` (a separate run: shapes and stacks slow the host)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    # verbose: the Python frames of each op (with_stack alone records none
    # on this torch).
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], record_shapes=True,
                 with_stack=True,
                 experimental_config=torch._C._profiler._ExperimentalConfig(verbose=True)) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type != DeviceType.CPU:
            continue
        for k in e.kernels:
            name = _kernel_name(k.name)
            if name not in names:
                continue
            parents, frames, host = [], [], e.cpu_parent
            while host is not None:
                if len(parents) < depth:
                    parents.append(host.name)
                frames = frames or [f for f in (host.stack or []) if "stheno_torch" in f][:depth]
                host = host.cpu_parent
            frames = [f for f in (e.stack or []) if "stheno_torch" in f][:depth] or frames
            key = (e.name, str(e.input_shapes), tuple(parents), tuple(frames))
            sites = out.setdefault(name, {})
            sites[key] = sites.get(key, 0) + 1
    return {name: [{"op": op, "shapes": shapes, "parents": list(parents), "frames": list(frames),
                    "launches": c}
                   for (op, shapes, parents, frames), c in sorted(sites.items(),
                                                                 key=lambda kv: -kv[1])]
            for name, sites in out.items()}


def phase_profile():
    """One N=2000 value+grad step under torch.profiler, after warm-up: the
    device time by kernel, the device launches by kernel and in all, and
    the device busy share; then, in a second run with Python stacks, where
    the six kernels of most device time, and ``Kernel2`` and ``enable_if``
    (library kernels named by their templates), were launched
    (``_attribute``).
    The device launches of K1, its backward and K2 must match the
    wrappers' counts."""
    from stheno_torch import entry as E

    xb, yb, ell = E.n2000_inputs()
    for _ in range(3):
        E.nlml_n2000(xb, yb, ell, grad=True)
    span_us, busy_us, by_name, launches = _profile(
        "n2000_value_grad", lambda: E.nlml_n2000(xb, yb, ell, grad=True))
    k1_n, k1_us = by_name.get("gram_kernel", (0, 0.0))
    tiles = launches["chol_tile"]
    # K2 per tile of n = 1024 (both tiles pad to it): 8 factor_panel, 7
    # trailing, 1 finalize and 6 join_product (two per level of the
    # inverse's join tree).
    k2_want = {"factor_panel": 8, "trailing": 7, "finalize": 1, "join_product": 6}
    k2_us = sum(by_name.get(k, (0, 0.0))[1] for k in k2_want)
    check(k1_n == launches["gram"] >= 1,
          f"profiled gram_kernel launches {k1_n} != wrapper count {launches['gram']}")
    kb_n, kb_us = by_name.get("gram_bwd_kernel", (0, 0.0))
    check(kb_n == launches["gram_bwd"] >= 1,
          f"profiled gram_bwd_kernel launches {kb_n} != wrapper count {launches['gram_bwd']}")
    check(tiles == 2, f"the N=2000 value+grad ran {tiles} tiles, not 2")
    for name, per_tile in k2_want.items():
        got = by_name.get(name, (0, 0.0))[0]
        check(got == per_tile * tiles, f"profiled {name} launches {got} for {tiles} tiles")
    emit(
        {
            "phase": "profile",
            "step": "N=2000 periodic-EQ NLML value+grad, float32",
            "span_ms": span_us / 1e3,
            "device_busy_ms": busy_us / 1e3,
            "device_busy_share": busy_us / span_us,
            "gram_device_ms_per_launch": k1_us / k1_n / 1e3,
            "gram_bwd_launches": kb_n,
            "gram_bwd_device_ms_per_launch": kb_us / kb_n / 1e3,
            "device_launches": sum(c for c, _ in by_name.values()),
            "chol_tile_device_ms_per_tile": k2_us / tiles / 1e3,
            "chol_tile_share_of_busy": k2_us / busy_us,
            "kernels": _top(by_name),
            "kernels_by_launches": [
                {"name": k, "launches": c, "device_ms": us / 1e3}
                for k, (c, us) in sorted(by_name.items(), key=lambda kv: -kv[1][0])],
            "where_launched": _attribute(
                lambda: E.nlml_n2000(xb, yb, ell, grad=True),
                {t["name"] for t in _top(by_name, 6)} | {"Kernel2", "enable_if"}),
        }
    )


def phase_profile_iterative(state):
    """One amortised N=262,144 value+grad step under torch.profiler, after
    a warm-up: device time by kernel, K3's and the fused Gram-gradient
    kernel's device time per launch, and the device busy share. Their
    device launches must match the wrappers' counts; every K3 launch must
    be the CG's tensor-core one (no FFMA ``gmv_kernel`` and no float64
    ``gmv_dmma_kernel``), the fused kernel must launch once and K1 not at
    all."""
    from stheno_torch import entry as E

    saved = _counts()
    x, y, params = _path_inputs()
    gen = torch.Generator(device="cuda").manual_seed(13)
    E.iterative_step(x, y, params, gen, precond_state=state)
    span_us, busy_us, by_name, launches = _profile(
        "n262144_amortised_value_grad",
        lambda: E.iterative_step(x, y, params, gen, precond_state=state))
    _set_counts(saved)
    ffma_n, ffma_us = by_name.get("gmv_kernel", (0, 0.0))
    mma_n, mma_us = by_name.get("gmv_mma_kernel", (0, 0.0))
    dmma_n, dmma_us = by_name.get("gmv_dmma_kernel", (0, 0.0))
    k3_n, k3_us = ffma_n + mma_n + dmma_n, ffma_us + mma_us + dmma_us
    red_n, red_us = by_name.get("gmv_reduce", (0, 0.0))
    split_n, split_us = by_name.get("gmv_split_v", (0, 0.0))
    k1_n = by_name.get("gram_kernel", (0, 0.0))[0]
    # The float64 kernel is the tensor-core one; float32 takes gmv_vjp_kernel.
    vjp = [by_name.get(k, (0, 0.0)) for k in ("gmv_vjp_kernel", "gmv_vjp_dmma_kernel")]
    vjp_n, vjp_us = sum(n for n, _ in vjp), sum(us for _, us in vjp)
    vred_n, vred_us = by_name.get("gmv_vjp_reduce", (0, 0.0))
    check(split_n == mma_n, f"profiled gmv_split_v launches {split_n} != gmv_mma_kernel {mma_n}")
    check(k3_n == launches["gram_matvec"] >= 1,
          f"profiled K3 launches {ffma_n} (gmv_kernel) + {mma_n} (gmv_mma_kernel) + {dmma_n} "
          f"(gmv_dmma_kernel) != wrapper count {launches['gram_matvec']}")
    check(mma_n >= 1, "the amortised step's CG sweep did not take the tensor-core K3")
    check(ffma_n == 0 and dmma_n == 0 and launches["gram_matvec"] == mma_n,
          f"the amortised step launched the FFMA K3 {ffma_n} and the float64 K3 {dmma_n} "
          f"times; K3's wrapper count {launches['gram_matvec']} against {mma_n} tensor-core "
          "launches")
    check(vjp_n == launches["gram_matvec_vjp"] == 1,
          f"profiled gmv_vjp_kernel and gmv_vjp_dmma_kernel launches {vjp_n} != wrapper count "
          f"{launches['gram_matvec_vjp']}")
    check(k1_n == launches["gram"] == 0,
          f"the step launched K1: profiled {k1_n}, wrapper count {launches['gram']}")
    emit(
        {
            "phase": "profile_iterative",
            "step": f"N={N_IT} EQ stochastic NLML value+grad, amortised, float32",
            "span_ms": span_us / 1e3,
            "device_busy_ms": busy_us / 1e3,
            "device_busy_share": busy_us / span_us,
            "gram_matvec_launches": k3_n,
            "gram_matvec_mma_launches": mma_n,
            "gram_matvec_device_ms_per_launch": (k3_us + red_us + split_us) / k3_n / 1e3,
            "gram_matvec_reduce_device_ms": red_us / 1e3,
            "gram_matvec_split_v_device_ms": split_us / 1e3,
            "gram_launches": k1_n,
            "gram_matvec_vjp_launches": vjp_n,
            "gram_matvec_vjp_device_ms_per_launch": (vjp_us + vred_us) / vjp_n / 1e3,
            "gram_matvec_vjp_reduce_launches": vred_n,
            "kernels": _top(by_name, 16),
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

    with config.matmul_precision_ctx():
        return _run_phases()


def _run_phases():
    seconds = {}

    def run(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        return out

    smi = run("card_and_build", phase_card)
    gram_err, gram_bwd_err = run("gram", phase_gram)
    errs = {
        "gram": gram_err,
        "gram_bwd": gram_bwd_err,
        "chol_tile": run("chol_tile", phase_chol_tile),
        **run("gram_matvec", phase_gram_matvec),
        "gram_matvec_vjp": run("gram_matvec_vjp", phase_gram_matvec_vjp),
    }
    counts = run("main_path", phase_main_path)
    it_counts, state, cache, build_s = run("iterative_path", phase_iterative)
    f64_counts = run("iterative_gates", phase_iterative_gates, state)
    # Each kernel's launches are those of the path it serves: K1 and K2
    # on the main path, K3's float32 routes and its backward on the
    # matrix-free path, K3's float64 route on its float64 step.
    path = {k: it_counts[k] for k in ("gram_matvec_mma", "gram_matvec_ffma", "gram_matvec_vjp")}
    path["gram_matvec_dmma"] = f64_counts["gram_matvec_dmma"]
    kernels = run("times", phase_times, errs, {**counts, **path})
    idle = [k["name"] for k in kernels if k["launches"] < 1]
    check(not idle, f"kernels that their path never launched: {idle}")
    run("iterative_times", phase_path_times, state, cache, build_s)
    run("profile", phase_profile)
    run("profile_iterative", phase_profile_iterative, state)
    emit({"phase": "seconds", **seconds, "total": sum(seconds.values())})
    # The card's name and power limit again, beside the kernels' numbers.
    print(smi, flush=True)
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
