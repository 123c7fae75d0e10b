"""On-card smoke test of stheno_torch, the PyTorch/CUDA port, on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA H100 (sm_90a)
and the CUDA toolkit. It builds the hand-written kernels from
``stheno_torch/ops/csrc``, holds each against its plain PyTorch version
on the card, and drives the port's paths through their entry points:

- the main path, the exact-GP training-and-prediction step at N=2000,
  checked against the same port run in float64 on the CPU;
- the matrix-free path at N=262,144 (``bench.py:bench_iterative_262k``:
  the stochastic NLML value and gradient with a fresh and an amortised
  preconditioner, the representer weights, the cached mean, the variance
  cache and its queries, the serving bundle), checked at N=8192 in
  float64 against the dense exact GP and at N=262,144 against the same
  step in float64 on the card;
- the training paths of ``bench.py:bench_opt_steps`` and ``bench_nuts``:
  the N=2000 EQ GP trained by the Adam driver, whose step runs as a CUDA
  graph replay (K1, K1's backward and K2 inside it), checked against
  float64 on the CPU and against eager steps on the card, profiled and
  timed against an eager loop; and NUTS over its three
  log-hyperparameters, gated on ESS and R-hat;
- the pseudo-point path of ``bench.py:bench_vfe_n2000`` and
  ``bench_dist_elbo_1m``: the VFE, FITC and DTC ELBOs at N=2000, M=100
  and the VFE value and gradient, checked against float64 on the CPU; the
  VFE value and gradient and the sparse posterior at N=1,000,000, M=512,
  checked against the same step in float64 on the card within twice the
  JAX package's own float32 error; K1 and its backward at the path's
  512 x 10^6 shape, timed beside their bound;
- the modelling DSL through the reference's own example models: example
  6's Bayesian linear regression at N=10^6 (a Woodbury variance, never
  densified) and a Kronecker ``Normal`` on a 1024 x 1024 grid, unmasked
  and masked, against float64 on the card within twice the JAX package's
  own float32 error; example 2's decomposition and example 5's
  derivative model at N=2000 against float64 on the CPU; K1 (rq), its
  backward and K2 at their shapes;
- item 9 (phase ``item9_path``): the structured grids of
  ``bench.py:bench_structured_grids`` (the circulant NLML and gradient at
  N=2^20 and its posterior, the exact Kronecker NLML and gradient on the
  1024 x 1024 grid), each against float64 on the card within twice the
  JAX package's own float32 error; the compensated (small-noise) operator
  of ``bench_compensated_262k``, K3's float64 route on promoted inputs and
  the double-float tiles, against a float64 direct-difference reference,
  and its representer-weights solve at noise 0.01 gated at bench.py's true
  residual; the slice products' exactness; the tile options (bfloat16
  tiles from K1's float32-in, bfloat16-out instance, the bfloat16-basis
  variance cache, the symmetric sweep).

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
import warnings

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
    # K1 and its backward at the sparse path's 512 x 10^6 cross Gram.
    "gram_sparse": {
        "source": "stheno_torch/ops/csrc/gram.cu",
        "replaces": "stheno_tpu/ops/gram.py:92",
    },
    "gram_bwd_sparse": {
        "source": "stheno_torch/ops/csrc/gram_bwd.cu",
        "replaces": "stheno_tpu/ops/gram.py:198",
    },
    # K1, its backward and K2 on the modelling DSL's paths (phase
    # dsl_path): rq at the decomposition model's N=2000 Gram, and the
    # tile factorisation of a Kronecker factor.
    "gram_dsl": {
        "source": "stheno_torch/ops/csrc/gram.cu",
        "replaces": "stheno_tpu/ops/gram.py:92",
    },
    "gram_bwd_dsl": {
        "source": "stheno_torch/ops/csrc/gram_bwd.cu",
        "replaces": "stheno_tpu/ops/gram.py:198",
    },
    "chol_tile_dsl": {
        "source": "stheno_torch/ops/csrc/chol_tile.cu",
        "replaces": "stheno_tpu/ops/pallas_chol.py:112",
    },
    # Item 9 (phase item9_path): K1 and its backward at a Kronecker factor,
    # K1 at the grid variance's cross Gram, K3 at the grid mean's cross
    # product, K3's float64 route as the compensated operator, and K1's
    # float32-in, bfloat16-out tile.
    "gram_kron": {
        "source": "stheno_torch/ops/csrc/gram.cu",
        "replaces": "stheno_tpu/ops/gram.py:92",
    },
    "gram_bwd_kron": {
        "source": "stheno_torch/ops/csrc/gram_bwd.cu",
        "replaces": "stheno_tpu/ops/gram.py:198",
    },
    "gram_grid_var": {
        "source": "stheno_torch/ops/csrc/gram.cu",
        "replaces": "stheno_tpu/ops/gram.py:92",
    },
    "gram_matvec_grid_mean": {
        "source": "stheno_torch/ops/csrc/gram_matvec.cu",
        "replaces": "stheno_tpu/ops/gram_matvec.py:53",
    },
    "gram_matvec_compensated": {
        "source": "stheno_torch/ops/csrc/gram_matvec_f64.cu",
        "replaces": "stheno_tpu/ops/gram_matvec.py:53",
    },
    "gram_bf16_tiles": {
        "source": "stheno_torch/ops/csrc/gram.cu",
        "replaces": "stheno_tpu/ops/gram.py:92",
    },
}

# The matrix-free path's size (bench.py:bench_iterative_262k).
N_IT = 262_144

# The JAX package's own float32 error on the sparse path at N=500,000,
# M=512 on the CPU (the largest N held there; scripts/jax_sparse_f32_error.py,
# recorded in PERF.md): the ELBO's relative error, the normwise relative
# error of its gradient with respect to (log ell, log noise, z), and the
# largest error of the posterior mean and variance at 4096 points over the
# largest float64 value. The N=10^6 gate of phase sparse_path allows twice
# each. The variance's is taken as the port's entry points take it, in
# float32 under the adaptive jitter (under the fixed jitter the JAX
# package's float32 variance is NaN: the re-whitened subspace matrix
# L_z A L_z^T is indefinite in float32, and the adaptive probe puts 10 on
# its diagonal where the float64 run puts 1e-3).
JAX_F32_SPARSE = {
    "elbo_rel": 8.804825366593068e-04,
    "grad_rel": 4.415395150520416e-03,
    "mean_rel": 4.430042426939862e-03,
    "var_rel": 5.399060933981150e-02,
}


# The JAX package's own float32 error on the Kronecker logpdf on the 1024 x
# 1024 grid, unmasked and with 10% of each axis masked, on the CPU
# (scripts/jax_dsl_f32_error.py, recorded in PERF.md): the value's relative
# error and the gradient's normwise one. Phase dsl_path allows twice each.
# Its BLR run is held to the main path's gates instead (value rel 1e-3,
# each gradient entry 5e-2), which lie far below the JAX package's float32
# error there (value 14.6, gradient 598).
JAX_F32_DSL = {
    "kron_unmasked_value_rel": 3.7360543262625473e-07,
    "kron_unmasked_grad_rel": 7.994472308817081e-05,
    "kron_masked_value_rel": 6.489885134258344e-07,
    "kron_masked_grad_rel": 2.935846436159447e-04,
}


# The JAX package's own float32 error on item 8's paths, on the CPU
# (scripts/jax_item8_f32_error.py, recorded in PERF.md): the pathwise draws
# at N=262,144 from the same draws in both dtypes (largest error over the
# largest float64 draw); the SVGP minibatch (4096 of N=10^6, M=512) ELBO's
# relative error and its gradient's with respect to log s2, log ell and z
# (z normwise); and the full-batch rho=1 step's ELBO at N=500,000 (the
# largest N held there; 5.5e-5 at 250,000). Phase item8_path allows twice
# the pathwise and full-batch errors; the minibatch ELBO takes the main
# path's 1e-3, the larger. Float32 keeps no digit of the gradient, so that
# is only held finite, and its errors, scaled to float64's unit roundoff,
# set the gates of the card's float64 gradient against the CPU's.
JAX_F32_ITEM8 = {
    "pathwise_draws_rel": 7.74442266240203e-03,
    "svgp_minibatch_elbo_rel": 8.56196214138845e-05,
    "svgp_minibatch_grad_log_s2_rel": 2.195065726563069,
    "svgp_minibatch_grad_log_ell_rel": 1.7805776425600566,
    "svgp_minibatch_grad_z_rel": 201.78429295292173,
    "svgp_full_elbo_rel": 5.089796589591074e-04,
}


# The JAX package's own float32 error on the structured grids, on the CPU
# (scripts/jax_item9_f32_error.py, recorded in PERF.md): the N=2^20
# circulant step's NLML value and gradient (normwise, with respect to log
# s2 and log ell), float32 against float64 from the same probes, and the
# 1024 x 1024 Kronecker step's; and the grid posterior's mean at 4096
# points, largest error over the largest float64 value. Phase item9_path
# allows twice each. At the grid's settings the JAX package's CG stops at
# 100 iterations short of tol 1e-2 in both dtypes (relative residual 0.109
# in float32, 0.063 in float64), and float32 keeps almost no digit of
# either gradient. Its float32 posterior variance keeps none (error 1.0 of
# the largest float64 variance: float32's reduction exceeds the prior, and
# the clamp gives 0), so the port's is held finite and nonnegative only,
# and the posterior is gated in float64 at N=4096 against the dense GP.
JAX_F32_ITEM9 = {
    "grid_value_rel": 4.3947666746793206e-04,
    "grid_grad_rel": 6.205276198546918e-01,
    "kron_value_rel": 7.476384907853471e-05,
    "kron_grad_rel": 9.940651953351669e-01,
    "grid_mean_rel": 1.893446987080664e-01,
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
        v = torch.randn(N_IT, p, generator=gen, device="cuda", dtype=rows.dtype)
        shapes[tag] = k3_shape_times(rows, cols, v, exps_per_s)
    rows = [{"name": name, **shapes[tag], "sm_clock_mhz": mhz}
            for name, tag in (("gram_matvec_mma", "p17"), ("gram_matvec_ffma", "p1"),
                              ("gram_matvec_dmma", "p17_f64"))]
    return rows, shapes


def k3_shape_times(rows, cols, v, exps_per_s, block=None):
    """K3 (eq) per call for ``rows`` by ``cols`` (d = 1) times ``v``, as
    ``_k3_times`` describes: its route, CUDA-event and device times, plain
    version, the 8192-row-block library sweep and bounds (``block``: the
    plain version's and the library sweep's row block instead)."""
    from stheno_torch.ops import gram_matvec as K3

    dtype = rows.dtype
    n, m, d, p = rows.shape[0], cols.shape[0], 1, v.shape[1]

    def library():
        return torch.cat([torch.exp(-0.5 * torch.cdist(xb, cols).square()) @ v
                          for xb in torch.split(rows, block or 8192)])

    byts = (n * d + m * d + m * p + n * p) * rows.element_size()
    if dtype == torch.float64:
        b_ms, b_unit, dfma_ms = k3_f64_bound(byts, n, m, d, p)
        extra = {"dfma_bound_ms": dfma_ms}
    else:
        b_ms, b_unit = mma_bound(byts, n, m, d, p, exps_per_s)
        f_ms, f_by = bound(byts, n * m * (2 * d + 4 + 2 * p) + 2 * (n + m) * d, dtype)
        extra = {"fp32_bound_ms": f_ms, "fp32_bound_by": f_by}
    slow = n * p > 8192 * 64 or dtype == torch.float64
    call = lambda: K3.gram_matvec("eq", rows, cols, v)  # noqa: E731
    return {
        "shape": [n, m, d, p],
        "dtype": str(dtype),
        "route": K3.route(n, m, p, dtype),
        "ms": time_ms(call, reps=3, warmup=1),
        "device_ms": device_ms(call, reps=1 if slow else 3),
        "plain_ms": time_ms(lambda: K3.gram_matvec_plain("eq", rows, cols, v,
                                                         block=block or 4096),
                            reps=1 if slow else 3, warmup=1),
        "library_ms": time_ms(library, reps=1 if slow else 3, warmup=1),
        "bound_ms": b_ms,
        "bound_unit": b_unit,
        "bound_by": "bytes" if b_unit == "bytes" else "operations",
        **extra,
    }


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


#: Idle host time that a traced session holds on each side of the step,
#: and the most takes of a trace whose counts its caller refuses.
TRACE_MARGIN_S = 0.2
TRACE_TAKES = 3

#: Short spin kernels enqueued at the head of each traced step. Late in a
#: whole run the profiler lost the first 7-9 device records of a step in
#: every take, K1 launches among them, and more takes did not help: behind
#: a 50 ms spin kernel it lost the same records, behind 64 or 256 short
#: ones none (PERF.md): a head of records, not of time. These, which every
#: count leaves out, stand first in it.
TRACE_HEAD_SPINS = 64


def _head_spins():
    for _ in range(TRACE_HEAD_SPINS):
        torch.cuda._sleep(1000)


def _is_launch_call(e):
    """A CUDA runtime or driver call that puts work on the card."""
    return e.name.startswith("cu") and any(w in e.name for w in ("Launch", "Memcpy", "Memset"))


def _trace_once(label, fn, head_us):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    before = _counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(TRACE_MARGIN_S)
        torch.cuda._sleep(1_000_000)
        torch.cuda.synchronize()
        with record_function(label):
            _head_spins()
            fn()
            torch.cuda.synchronize()
        torch.cuda._sleep(1_000_000)
        torch.cuda.synchronize()
        time.sleep(TRACE_MARGIN_S)
    after = _counts()
    events = prof.events()
    # The annotation is recorded twice, on the host and as a device span;
    # only the host one marks the step, and neither is a kernel. The spin
    # kernels around the step and at its head are the session's own.
    (step,) = [e for e in events if e.name == label and e.device_type == DeviceType.CPU]
    device = [
        e
        for e in events
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation and e.name != label
        and _kernel_name(e.name) != "spin_kernel"
    ]
    check(device, "the profiler recorded no device activity")
    calls = [e.time_range.start for e in events if e.device_type == DeviceType.CPU
             and _is_launch_call(e) and e.time_range.start >= step.time_range.start]
    check(calls, "the profiler recorded no launch call in the step")
    intervals = [(e.time_range.start, e.time_range.end) for e in device]
    by_name = {}
    for e in device:
        n, us = by_name.get(_kernel_name(e.name), (0, 0.0))
        by_name[_kernel_name(e.name)] = (n + 1, us + e.time_range.end - e.time_range.start)
    return {
        "span_us": step.time_range.end - step.time_range.start - head_us,
        "busy_us": _union_length(intervals),
        "by_name": by_name,
        "lead_us": min(s for s, _ in intervals) - min(calls) - head_us,
        "launches": {k: after[k] - before[k] for k in after},
    }


def trace(label, fn, want=None):
    """One run of ``fn`` under torch.profiler, as a dict: ``span_us``, the
    step's span on the host (from its start to the return of the
    synchronise that ends it) less the head spins' time (``head_us``, CUDA
    events); ``busy_us``, the union of its device records' intervals;
    ``by_name``, ``{kernel: (launches, device_us)}``; ``lead_us``, the
    first device record's start less the first launch call's, less
    ``head_us`` (tens of microseconds where the profiler puts host and
    device records on one clock); ``launches``, the wrappers' counts in
    the run; and ``refused``, one entry for each earlier take that
    ``want(by_name, launches)`` refused, with its lead and the kernels
    whose launches it saw otherwise than the last take. The step is traced
    again, up to ``TRACE_TAKES`` takes in all, while ``want`` refuses it.

    The profiler both misplaces and loses device records. It has put a
    record 2 ms before the call that launched it, so no record is cut by
    its time: the session holds ``TRACE_MARGIN_S`` of idle host time on
    each side of the step, nothing runs on the card when it starts, and
    every record in it but the spin kernels around the step and at its
    head is the step's. And late in a whole run of this script a trace of
    the 10^6 sparse step lacked both of its K1 launches, its first record
    21 ms after its first launch call (PERF.md): a take that misses
    launches shows that records were lost, not that a kernel did not run.
    Those lost records are the step's first: the ``TRACE_HEAD_SPINS`` spin
    kernels at its head take their place."""
    head_us = time_ms(_head_spins, reps=3, warmup=1) * 1e3
    refused = []
    for _ in range(TRACE_TAKES):
        out = _trace_once(label, fn, head_us)
        if want is None or want(out["by_name"], out["launches"]):
            break
        refused.append(out)
    last = out["by_name"]
    out["head_us"] = head_us
    out["refused"] = [
        {"lead_us": r["lead_us"],
         "launches": {k: [c, last.get(k, (0, 0.0))[0]] for k, (c, _) in r["by_name"].items()
                      if c != last.get(k, (0, 0.0))[0]}
         | {k: [0, c] for k, (c, _) in last.items() if k not in r["by_name"]}}
        for r in refused
    ]
    return out


def _traced(by_name, kernel):
    return by_name.get(kernel, (0, 0.0))[0]


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
    # K2 per tile of n = 1024 (both tiles pad to it): 8 factor_panel, 7
    # trailing, 1 finalize and 6 join_product (two per level of the
    # inverse's join tree).
    k2_want = {"factor_panel": 8, "trailing": 7, "finalize": 1, "join_product": 6}
    t = trace("n2000_value_grad", lambda: E.nlml_n2000(xb, yb, ell, grad=True),
              lambda b, n: _traced(b, "gram_kernel") == n["gram"]
              and _traced(b, "gram_bwd_kernel") == n["gram_bwd"]
              and all(_traced(b, k) == c * n["chol_tile"] for k, c in k2_want.items()))
    span_us, busy_us, by_name, launches = t["span_us"], t["busy_us"], t["by_name"], t["launches"]
    k1_n, k1_us = by_name.get("gram_kernel", (0, 0.0))
    tiles = launches["chol_tile"]
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
            "clock_lead_us": t["lead_us"],
            "refused_traces": t["refused"],
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
    t = trace("n262144_amortised_value_grad",
              lambda: E.iterative_step(x, y, params, gen, precond_state=state),
              lambda b, n: sum(_traced(b, k) for k in ("gmv_kernel", "gmv_mma_kernel",
                                                       "gmv_dmma_kernel")) == n["gram_matvec"]
              and sum(_traced(b, k) for k in ("gmv_vjp_kernel", "gmv_vjp_dmma_kernel"))
              == n["gram_matvec_vjp"] and _traced(b, "gram_kernel") == n["gram"])
    span_us, busy_us, by_name, launches = t["span_us"], t["busy_us"], t["by_name"], t["launches"]
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
            "clock_lead_us": t["lead_us"],
            "refused_traces": t["refused"],
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


# ---------------------------------------------------------------------------
# The training paths: Adam captured in CUDA graphs, and NUTS
# (bench.py:bench_opt_steps and bench_nuts).

# bench.py:bench_opt_steps's iterations per steps_per_dispatch.
ADAM_ITERS = {1: 60, 50: 400, 100: 400}
ADAM_GATE_STEPS = 20


def _latent(vs):
    return {k: v.detach().double().cpu() for k, v in vs.latent_dict().items()}


def _eager_adam(timed, untimed=1):
    """``untimed`` then ``timed`` Adam steps of ``adam_n2000_objective``
    on the card, eagerly: plain code, the driver's optimiser settings and
    no graph. Returns ``(latent values after, seconds of the timed steps,
    launches of one step)``."""
    from stheno_torch import entry as E

    f, vs = E.adam_n2000_objective()
    with torch.no_grad():
        f(vs)
    params = {k: v.clone().requires_grad_(True) for k, v in vs.latent_dict().items()}
    opt = torch.optim.Adam(list(params.values()), lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                           capturable=True)

    def step():
        opt.zero_grad(set_to_none=True)
        val = f(vs.with_latent(params))
        val.backward()
        opt.step()

    before = _counts()
    step()
    per_step = {k: v - before[k] for k, v in _counts().items()}
    for _ in range(untimed - 1):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(timed):
        step()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return {k: v.detach().double().cpu() for k, v in params.items()}, secs, per_step


def _exp_avg(driver):
    """Adam's first moment of each latent parameter: a weighted sum of
    the gradients, so linear in them (the parameters' changes are near
    ``-rate * sign(g)`` a step, blind to the gradient's size)."""
    return {k: driver.opt.state[p]["exp_avg"].detach().double().cpu()
            for k, p in driver.params.items()}


def phase_opt_adam():
    """The Adam path of ``bench.py:bench_opt_steps`` (EQ, N=2000, float32,
    rate 1e-3) through ``entry.adam_n2000``, whose step is captured as a
    CUDA graph when the driver is built:

    (a) 20 captured steps (20 replays of the step's graph) against the
        port's eager float64 steps on the CPU from the same initial values:
        each parameter's change and Adam's first moment of it (linear in
        the gradient) within rel 5e-2 (the JAX package's float32 gradient
        error, stheno_tpu/config.py:95-96), and the objective at the last
        step's start within rel 1e-3;
    (b) the same 20 steps run eagerly on the card in float32: parameters
        within rel 1e-5 of the captured run's;
    (c) 50 replays profiled: K1, K1's backward and K2's kernels run inside
        them, as many times as 50 eager steps launch them (so their ctypes
        launches landed on the capturing stream; a replay runs no Python
        wrapper, so the trace, not the wrappers' counts, gives the path's
        launches), and the device is busy for most of the run; around 50
        bare replays the memory allocated is the same (the capture, in
        global mode, also refused any cudaMalloc or sync by the kernels'
        library);
    (d) bench.py's protocol for k = 1, 50, 100: build the driver, run(2k),
        then time run(iters) (60, 400, 400 iterations); beside it an eager
        loop's steps/s on the card, timed over as many steps after 2k
        untimed ones.
    """
    from stheno_torch import entry as E

    driver = E.adam_n2000()
    start = _latent(driver.vs)
    val = driver.run(ADAM_GATE_STEPS)
    captured = _latent(driver.vs)
    captured_m = _exp_avg(driver)
    report = {"phase": "opt_adam", "gate_steps": ADAM_GATE_STEPS}
    checks = []

    # (a) against float64 on the CPU.
    ref = E.adam_n2000(device="cpu", dtype=torch.float64)
    check(all(torch.equal(_latent(ref.vs)[k], start[k]) for k in start),
          "the CPU reference starts elsewhere")
    ref_val = ref.run(ADAM_GATE_STEPS)
    ref_latent = _latent(ref.vs)
    ref_m = _exp_avg(ref)
    report["vs_cpu_float64"] = {
        "value": float(val), "value_ref": float(ref_val), "value_rel": _rel(val, ref_val),
        **{f"delta_{k}": float(captured[k] - start[k]) for k in start},
        **{f"delta_{k}_ref": float(ref_latent[k] - start[k]) for k in start},
        **{f"delta_{k}_rel": _rel(captured[k] - start[k], ref_latent[k] - start[k])
           for k in start},
        **{f"exp_avg_{k}": float(captured_m[k]) for k in start},
        **{f"exp_avg_{k}_ref": float(ref_m[k]) for k in start},
        **{f"exp_avg_{k}_rel": _rel(captured_m[k], ref_m[k]) for k in start},
    }
    gate = report["vs_cpu_float64"]
    checks.append((gate["value_rel"] <= 1e-3, "captured Adam objective against float64"))
    checks.extend((gate[f"delta_{k}_rel"] <= 5e-2, f"captured Adam change of {k} against float64")
                  for k in start)
    checks.extend((gate[f"exp_avg_{k}_rel"] <= 5e-2,
                   f"captured Adam's first moment of {k} against float64") for k in start)

    # (b) against the same steps run eagerly on the card.
    eager_latent, _, per_step = _eager_adam(ADAM_GATE_STEPS - 1)
    report["vs_eager_card"] = {f"{k}_rel": _rel(captured[k].exp(), eager_latent[k].exp())
                               for k in start}
    checks.extend((report["vs_eager_card"][f"{k}_rel"] <= 1e-5,
                   f"captured Adam's {k} against eager steps on the card") for k in start)
    report["eager_launches_per_step"] = per_step
    checks.extend((per_step[name] >= 1, f"an eager Adam step launched no {name}")
                  for name in ("gram", "gram_bwd", "chol_tile"))

    # (c) 50 replays profiled, and 50 bare replays' memory.
    reps = 50
    prof_driver = E.adam_n2000()
    prof_driver.run(2 * reps)
    want = {"gram_kernel": reps * per_step["gram"], "gram_bwd_kernel": reps * per_step["gram_bwd"],
            # 8 factor_panel launches per n=1024 tile (both tiles pad to it).
            "factor_panel": 8 * reps * per_step["chol_tile"]}
    t = trace("adam_replays", lambda: prof_driver.run(reps),
              lambda b, _: all(_traced(b, k) == n for k, n in want.items()))
    span_us, busy_us, by_name = t["span_us"], t["busy_us"], t["by_name"]
    graph, _ = prof_driver._graph
    gc.collect()
    torch.cuda.synchronize()
    mem = (torch.cuda.memory_allocated(), torch.cuda.mem_get_info()[0])
    for _ in range(reps):
        graph.replay()
    torch.cuda.synchronize()
    mem_after = (torch.cuda.memory_allocated(), torch.cuda.mem_get_info()[0])
    k1_n = by_name.get("gram_kernel", (0, 0.0))[0]
    kb_n = by_name.get("gram_bwd_kernel", (0, 0.0))[0]
    k2_n = by_name.get("factor_panel", (0, 0.0))[0]
    checks += [
        (k1_n == want["gram_kernel"], "gram_kernel launches in the replays"),
        (kb_n == want["gram_bwd_kernel"], "gram_bwd_kernel launches in the replays"),
        (k2_n == want["factor_panel"], "factor_panel launches in the replays"),
        (busy_us / span_us >= 0.5, "the replays' device busy share"),
        (mem_after[0] == mem[0], "the replays changed the allocated device memory"),
    ]
    report["replay_profile"] = {
        "steps": reps, "span_ms": span_us / 1e3, "clock_lead_us": t["lead_us"],
        "refused_traces": t["refused"],
        "device_busy_ms": busy_us / 1e3,
        "device_busy_share": busy_us / span_us, "device_ms_per_step": busy_us / reps / 1e3,
        "device_launches_per_step": sum(c for c, _ in by_name.values()) / reps,
        "launches_per_step": {"gram_kernel": k1_n / reps, "gram_bwd_kernel": kb_n / reps,
                              "factor_panel": k2_n / reps},
        "memory_allocated_before_after": [mem[0], mem_after[0]],
        "device_free_before_after": [mem[1], mem_after[1]],
        "kernels": _top(by_name, 10),
    }
    del prof_driver, graph

    # (d) bench.py's protocol.
    rates = {}
    for k, iters in ADAM_ITERS.items():
        d = E.adam_n2000(k)
        d.run(2 * k)
        t0 = time.perf_counter()
        d.run(iters)
        captured_s = time.perf_counter() - t0
        _, eager_s, _ = _eager_adam(iters, untimed=2 * k)
        rates[f"k{k}"] = {"iters": iters, "captured_steps_per_s": iters / captured_s,
                          "eager_steps_per_s": iters / eager_s}
        del d
    report["steps_per_s"] = rates
    emit(report)
    failed = [what for ok, what in checks if not ok]
    check(not failed, f"opt_adam: {failed}")


def phase_opt_nuts():
    """The NUTS path of ``bench.py:bench_nuts`` through
    ``entry.nuts_n2000`` (N=2000, float32, 4 chains, 192 warm-up and 128
    sampling steps, depth 6, dense metric, adaptive jitter): wall time,
    the smallest ESS and largest split R-hat over the three
    log-hyperparameters, ESS/s; gated as bench.py gates it (finite ESS,
    R-hat < 1.7)."""
    from stheno_torch import entry as E
    from stheno_torch.opt import effective_sample_size, potential_scale_reduction

    _set_counts(ZERO_COUNTS)
    t0 = time.perf_counter()
    samples, accept = E.nuts_n2000(0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counts()
    for name in ("gram", "gram_bwd", "chol_tile"):
        check(counts[name] >= 1, f"NUTS launched no {name}: {counts}")
    for k, v in samples.items():
        check(v.shape == (4, 128) and v.is_cuda and bool(torch.isfinite(v).all()),
              f"NUTS samples of {k}: {tuple(v.shape)}, {v.device}")
    ess = min(effective_sample_size(v) for v in samples.values())
    rhat = max(potential_scale_reduction(v) for v in samples.values())
    report = {"phase": "opt_nuts", "launches": counts, "wall_s": wall, "min_ess": ess,
              "max_rhat": rhat, "ess_per_s": ess / wall, "accept": accept,
              "posterior_mean": {k: float(v.double().mean()) for k, v in samples.items()},
              "cut": None}
    emit(report)
    check(math.isfinite(ess) and rhat < 1.7, f"NUTS mixing: ESS {ess}, R-hat {rhat}")
    return counts


# ---------------------------------------------------------------------------
# The pseudo-point (sparse) path.


def _sparse_grad_rels(g, ref):
    """Relative errors of a sparse gradient against ``ref``: each
    log-hyperparameter's, z's (normwise) and the whole vector's
    (normwise)."""
    def vec(d):
        return torch.cat([d["log_ell"].reshape(1), d["log_noise"].reshape(1),
                          d["z"].reshape(-1)]).double().cpu()

    def rel(a, b):
        a, b = a.double().cpu().reshape(-1), b.double().cpu().reshape(-1)
        return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))

    out = {k: rel(g[k], ref[k]) for k in ("log_ell", "log_noise", "z")}
    out["whole"] = rel(vec(g), vec(ref))
    return out


def _sparse_pred_rels(pred, ref):
    """The largest error of the posterior mean and variance, absolute and
    over the largest reference value."""
    out = {}
    for name, a, b in zip(("mean", "var"), pred, ref):
        check(a.shape == (4096,) and bool(torch.isfinite(a).all()),
              f"sparse posterior {name}: shape {tuple(a.shape)} or not finite")
        b = b.double().cpu()
        out[f"{name}_max_abs_err"] = max_err(a.cpu(), b)
        out[f"{name}_ref_max"] = float(b.abs().max())
        out[f"{name}_rel"] = out[f"{name}_max_abs_err"] / out[f"{name}_ref_max"]
    return out


def k1_sparse_times(zs, xs):
    """K1 at the sparse path's cross Gram, ``zs (512, 1)`` by ``xs (10^6,
    1)`` float32 (z / ell and x / ell; SVGP's minibatch passes 4096 rows of
    x), against its plain version within
    ``_gram_atol``; its CUDA-event time (5 calls back to back, median of
    20), device time, plain version, ``exp(-0.5 cdist^2)`` and bound
    (inputs read once, the 2.05 GB output written once)."""
    from stheno_torch.ops import gram as K1

    n, m = zs.shape[0], xs.shape[0]
    K, P = K1.gram("eq", zs, xs), K1.gram_plain("eq", zs, xs)
    err, over = _hold(K, P, _gram_atol("eq", zs, xs), f"gram eq {n}x1 by {m}x1")
    del K, P
    b_ms, b_by = bound((n + m + n * m) * 4, n * m * (2 + 4), torch.float32)
    call = lambda: K1.gram("eq", zs, xs)  # noqa: E731
    return {
        "shape": [n, m, 1], "dtype": "torch.float32", "max_abs_err": err, "of_tol": over,
        "ms": time_ms(call, inner=5),
        "device_ms": device_ms_per_call(call, inner=5),
        "plain_ms": time_ms(lambda: K1.gram_plain("eq", zs, xs), reps=5, warmup=1),
        "library_ms": time_ms(lambda: torch.exp(-0.5 * torch.cdist(zs, xs).square()), reps=5),
        "bound_ms": b_ms,
        "bound_by": b_by,
    }


def k1_bwd_sparse_times(zs, xs):
    """K1's backward at the sparse path's cross Gram (both roles, a random
    512 x 10^6 cotangent): against its plain version within ``_bwd_tols``
    (run twice, equal bits); ``autograd.grad`` through K1 per call (CUDA
    events and device time), the plain version, ``autograd.grad`` through
    ``exp(-0.5 cdist^2)``, and the bound (x, y and the cotangent read once,
    both gradients written once)."""
    from stheno_torch.ops import gram as K1
    from stheno_torch.ops import gram_bwd as KB

    n, m = zs.shape[0], xs.shape[0]
    gbar = torch.randn(n, m, generator=torch.Generator(device="cuda").manual_seed(23),
                       device="cuda")
    got = KB.gram_bwd("eq", zs, xs, gbar)
    again = KB.gram_bwd("eq", zs, xs, gbar)
    ref = KB.gram_bwd_plain("eq", zs, xs, gbar)
    tag = f"gram_bwd eq {n}x1 by {m}x1"
    check(all(torch.equal(a, b) for a, b in zip(got[:2], again[:2])), f"{tag}: two runs differ")
    tx, ty, _ = _bwd_tols("eq", zs, xs, gbar, 1.0, block=32)
    ex, ox = _hold(got[0], ref[0], tx, f"{tag} d/dx")
    ey, oy = _hold(got[1], ref[1], ty, f"{tag} d/dy")
    del got, again, ref, tx, ty
    zg, xg = zs.clone().requires_grad_(True), xs.clone().requires_grad_(True)
    K = K1.gram("eq", zg, xg)
    call = lambda: torch.autograd.grad(K, (zg, xg), gbar, retain_graph=True)  # noqa: E731
    b_ms, b_by = bound(2 * (n + m) * 4 + n * m * 4, 20 * n * m, torch.float32)
    out = {
        "kind": "eq", "shape": [n, m, 1], "dtype": "torch.float32",
        "max_abs_err": max(ex, ey), "x_of_tol": ox, "y_of_tol": oy,
        "launch_shape": list(KB.launch_shape(n, m, 1, torch.float32)),
        "ms": time_ms(call, inner=5),
        "device_ms": device_ms_per_call(call, inner=5),
        "plain_ms": time_ms(lambda: KB.gram_bwd_plain("eq", zs, xs, gbar), reps=3, warmup=1),
    }
    del K
    zl, xl = zs.clone().requires_grad_(True), xs.clone().requires_grad_(True)
    KL = torch.exp(-0.5 * torch.cdist(zl, xl).square())
    out["library_ms"] = time_ms(
        lambda: torch.autograd.grad(KL, (zl, xl), gbar, retain_graph=True), reps=5)
    out["bound_ms"], out["bound_by"] = b_ms, b_by
    return out


def phase_sparse_path(smi):
    """The pseudo-point path through the user's entry points
    (``entry.sparse_elbo``, ``sparse_predict``), float32, on the card.

    N=2000, M=100 (``bench.py:bench_vfe_n2000``): the VFE, FITC and DTC
    ELBOs and the VFE value and gradient with respect to (log ell, log
    noise, z), against the same port run in float64 on the CPU with the
    jitter the float32 run's adaptive probe picked (so both factor the
    same inducing Gram): ELBO rel <= 1e-3, and rel <= 5e-2 for each
    log-hyperparameter's gradient and for the whole gradient (normwise).
    z's own gradient is reported, not gated: its float64 value is near 0
    on this grid and the JAX package's float32 z-gradient is off by far
    more than its size (PERF.md).

    N=1,000,000, M=512 (``bench_dist_elbo_1m``'s data): the VFE value and
    gradient and the posterior marginals at 4096 points, against the same
    step in float64 on the card with the same jitter, each within twice
    the JAX package's own float32 error (``JAX_F32_SPARSE``). K1 and K1's
    backward must launch in each size's run. Then the times (CUDA events:
    median of 20 after 3 warm-ups, the 10^6 steps of 5), one profiled
    10^6 value+grad step, and K1 and its backward at the 512 x 10^6 cross
    Gram beside their bounds, each report with the card's ``smi`` line.
    Returns the kernels line's two rows."""
    from stheno_torch import entry as E

    gc.collect()
    torch.cuda.empty_cache()
    cpu64 = lambda t: t.detach().double().cpu()  # noqa: E731
    report = {"phase": "sparse_path", "nvidia_smi": smi}

    # N=2000, M=100.
    x, y, z, ell = E.vfe_n2000_inputs()
    eps = E.sparse_jitter(z, ell)
    _set_counts(ZERO_COUNTS)
    vals = {m: E.sparse_elbo(x, y, z, ell, method=m) for m in ("vfe", "fitc", "dtc")}
    vg = E.sparse_elbo(x, y, z, ell, grad=True)
    torch.cuda.synchronize()
    counts = _counts()
    check(counts["gram"] >= 1 and counts["gram_bwd"] >= 1,
          f"the N=2000 sparse path's launches {counts}")
    xc, yc, zc, ec = (cpu64(t) for t in (x, y, z, ell))
    small = {"jitter": eps, "launches": counts}
    for m, v in vals.items():
        ref = E.sparse_elbo(xc, yc, zc, ec, method=m, jitter=eps)
        check(bool(torch.isfinite(v)), f"N=2000 {m} ELBO not finite")
        small[f"{m}_elbo"], small[f"{m}_elbo_ref_f64"] = float(v), float(ref)
        small[f"{m}_elbo_rel"] = _rel(v, ref)
        check(small[f"{m}_elbo_rel"] <= 1e-3, f"N=2000 {m} ELBO {small}")
    ref_v, ref_g = E.sparse_elbo(xc, yc, zc, ec, grad=True, jitter=eps)
    small["vg_elbo_rel"] = _rel(vg[0], ref_v)
    small["grad_rel"] = _sparse_grad_rels(vg[1], ref_g)
    small["grad_ref_f64"] = {k: float(ref_g[k]) for k in ("log_ell", "log_noise")}
    small["grad_z_ref_f64_norm"] = float(torch.linalg.norm(ref_g["z"]))
    check(small["vg_elbo_rel"] <= 1e-3, f"N=2000 VFE value+grad ELBO {small}")
    for k in ("log_ell", "log_noise", "whole"):
        check(small["grad_rel"][k] <= 5e-2, f"N=2000 VFE gradient {k}: {small['grad_rel']}")
    small["value_ms"] = {m: time_ms(lambda m=m: E.sparse_elbo(x, y, z, ell, method=m))
                         for m in ("vfe", "fitc", "dtc")}
    small["value_grad_ms"] = time_ms(lambda: E.sparse_elbo(x, y, z, ell, grad=True))
    report["n2000_m100"] = small

    # N=1,000,000, M=512.
    x, y, z, ell = E.sparse_1m_inputs()
    x_new = torch.linspace(0.0, 10.0, 4096, device="cuda")
    eps = E.sparse_jitter(z, ell)
    _set_counts(ZERO_COUNTS)
    v, g = E.sparse_elbo(x, y, z, ell, grad=True)
    pred = E.sparse_predict(x, y, z, ell, x_new)
    torch.cuda.synchronize()
    counts = _counts()
    check(counts["gram"] >= 1 and counts["gram_bwd"] >= 1,
          f"the N=10^6 sparse path's launches {counts}")
    check(bool(torch.isfinite(v)) and all(bool(torch.isfinite(t).all()) for t in g.values()),
          "N=10^6 ELBO or gradient not finite")
    big = {"jitter": eps, "launches": counts, "elbo": float(v)}
    x64, y64, z64, e64, n64 = (t.double() for t in (x, y, z, ell, x_new))
    ref_v, ref_g = E.sparse_elbo(x64, y64, z64, e64, grad=True, jitter=eps)
    ref_pred = E.sparse_predict(x64, y64, z64, e64, n64, jitter=eps)
    del x64, y64, z64, e64, n64
    big["elbo_ref_f64"] = float(ref_v)
    big["elbo_rel"] = _rel(v, ref_v)
    big["grad_rel"] = _sparse_grad_rels(g, ref_g)
    big["grad_ref_f64"] = {k: float(ref_g[k]) for k in ("log_ell", "log_noise")}
    big["grad_z_ref_f64_norm"] = float(torch.linalg.norm(ref_g["z"]))
    big.update(_sparse_pred_rels(pred, ref_pred))
    big["tolerance"] = {k: 2 * t for k, t in JAX_F32_SPARSE.items()}
    emit({"phase": "sparse_path_gates", "nvidia_smi": smi, "n2000_m100": small,
          "n1e6_m512": big})
    for k, got in (("elbo_rel", big["elbo_rel"]), ("grad_rel", big["grad_rel"]["whole"]),
                   ("mean_rel", big["mean_rel"]), ("var_rel", big["var_rel"])):
        check(got <= 2 * JAX_F32_SPARSE[k], f"N=10^6 {k} {got} exceeds twice the JAX "
              f"package's float32 error {JAX_F32_SPARSE[k]}")
    del ref_pred, ref_g, pred, g
    gc.collect()
    torch.cuda.empty_cache()
    big["value_ms"] = time_ms(lambda: E.sparse_elbo(x, y, z, ell), reps=5)
    big["value_grad_ms"] = time_ms(lambda: E.sparse_elbo(x, y, z, ell, grad=True), reps=5)
    big["predict_ms"] = time_ms(lambda: E.sparse_predict(x, y, z, ell, x_new), reps=5)
    torch.cuda.reset_peak_memory_stats()
    E.sparse_elbo(x, y, z, ell, grad=True)
    big["value_grad_peak_bytes"] = torch.cuda.max_memory_allocated()
    step = lambda: E.sparse_elbo(x, y, z, ell, grad=True)  # noqa: E731
    t = trace("sparse_1m_value_grad", step,
              lambda b, n: all(_traced(b, f"{k}_kernel") == n[k] for k in ("gram", "gram_bwd")))
    span_us, busy_us, by_name, launches = t["span_us"], t["busy_us"], t["by_name"], t["launches"]
    traced = {k: _traced(by_name, f"{k}_kernel") for k in ("gram", "gram_bwd")}
    big["profile"] = {
        "span_ms": span_us / 1e3, "clock_lead_us": t["lead_us"], "refused_traces": t["refused"],
        "device_busy_ms": busy_us / 1e3,
        "device_busy_share": busy_us / span_us,
        "device_launches": sum(c for c, _ in by_name.values()),
        "launches": traced,
        "kernels": _top(by_name),
    }
    check(all(traced[k] == launches[k] >= 1 for k in traced),
          f"the profiled 10^6 step's K1 launches {traced} against the wrappers' "
          f"{ {k: launches[k] for k in traced} } (clock lead {t['lead_us']} us; refused "
          f"takes {t['refused']})")
    zs, xs = (z / ell)[:, None], (x / ell)[:, None]
    del x, y
    k1 = k1_sparse_times(zs, xs)
    k1b = k1_bwd_sparse_times(zs, xs)
    report["n1e6_m512"] = big
    report["gram_512x1e6"], report["gram_bwd_512x1e6"] = k1, k1b
    emit(report)
    return [
        {"name": name, "route": "cuda", "source": KERNELS[name]["source"],
         "replaces": KERNELS[name]["replaces"], "launches": counts[base],
         **{k: row[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                "library_ms")}}
        for name, base, row in (("gram_sparse", "gram", k1), ("gram_bwd_sparse", "gram_bwd", k1b))
    ]


# ---------------------------------------------------------------------------
# The modelling DSL: the reference's example models.

#: K2's launches per tile padded to 1024 (``phase_profile``).
K2_PER_TILE = {"factor_panel": 8, "trailing": 7, "finalize": 1, "join_product": 6}


def _grad_rel(g, ref):
    """The normwise relative error of a gradient dict, and each entry's."""
    keys = list(ref)
    a = torch.stack([g[k].double().cpu().reshape(()) for k in keys])
    b = torch.stack([ref[k].double().cpu().reshape(()) for k in keys])
    each = {k: _rel(g[k], ref[k]) for k in keys}
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b)), each


def _launched(fn):
    """``fn()`` with the wrappers' counts set to 0 first; returns its output
    and the counts it left."""
    _set_counts(ZERO_COUNTS)
    out = fn()
    torch.cuda.synchronize()
    return out, _counts()


def _own_peak(fn):
    """The peak memory that ``fn()`` allocates above what was allocated
    before it, in bytes."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


def _traced_exact(label, fn, kernels):
    """One traced run of ``fn`` (``trace``): for each ``(device kernel,
    wrapper, per launch)`` of ``kernels``, the device launches must equal
    the wrapper's count times ``per launch`` (the device launches one
    wrapper call makes). Returns the profile's summary."""
    def want(b, n):
        return all(_traced(b, k) == c * n[w] for k, w, c in kernels)

    t = trace(label, fn, want)
    by_name, launches = t["by_name"], t["launches"]
    traced = {k: _traced(by_name, k) for k, _, _ in kernels}
    wrappers = {w: launches[w] for _, w, _ in kernels}
    check(want(by_name, launches),
          f"{label}: traced launches {traced} against the wrappers' {wrappers} (clock lead "
          f"{t['lead_us']} us; {sum(c for c, _ in by_name.values())} device records; refused "
          f"takes {t['refused']})")
    return {"span_ms": t["span_us"] / 1e3, "head_spins_us": t["head_us"],
            "device_busy_ms": t["busy_us"] / 1e3,
            "device_busy_share": t["busy_us"] / t["span_us"], "clock_lead_us": t["lead_us"],
            "refused_traces": t["refused"], "traced_launches": traced,
            "wrapper_launches": wrappers,
            "device_launches": sum(c for c, _ in by_name.values()), "kernels": _top(by_name, 8)}


#: K1's and K1-backward's device kernels, their wrappers' counts and the
#: device launches of one wrapper call (``_traced_exact``).
K1_KERNELS = (("gram_kernel", "gram", 1), ("gram_bwd_kernel", "gram_bwd", 1))


def _traced_dsl(label, fn):
    """One traced run of the float32 step ``fn`` (``_traced_exact``): its
    K1, K1-backward and K2 launches on the device must equal the wrappers'
    counts (K2: ``K2_PER_TILE`` per tile)."""
    return _traced_exact(label, fn, K1_KERNELS + tuple(
        (k, "chol_tile", c) for k, c in K2_PER_TILE.items()))


def _blr_exact(x, y, params):
    """Example 6's posterior in its information form, in float64 on the
    host: with ``X = [x, 1]``, the weights' precision is ``diag(1 / s_slope,
    1 / s_intercept) + X^T X / noise`` and their mean ``cov X^T y / noise``;
    ``f``'s marginals at ``blr_predict``'s 1024 points follow from ``[x_new,
    1]``. No Woodbury difference: a plain reference for ``blr_predict``."""
    x, y = x.detach().double().cpu(), y.detach().double().cpu()
    s = {k: float(torch.exp(v)) for k, v in params.items()}
    X = torch.stack([x, torch.ones_like(x)], 1)
    prec = torch.diag(torch.tensor([1 / s["log_s_slope"], 1 / s["log_s_intercept"]],
                                   dtype=torch.float64)) + X.T @ X / s["log_noise"]
    cov = torch.linalg.inv(prec)
    mean = cov @ (X.T @ y) / s["log_noise"]
    xn = torch.linspace(0.0, 10.0, 1024, dtype=x.dtype, device=x.device)
    Xn = torch.stack([xn, torch.ones_like(xn)], 1)
    return {"slope": (mean[0:1], cov[0:1, 0]), "intercept": (mean[1:2], cov[1:2, 1]),
            "f": (Xn @ mean, torch.einsum("ij,jk,ik->i", Xn, cov, Xn))}


def _k1_rq_dsl(x, alpha):
    """K1 and its backward, rq, at the decomposition model's N=2000 Gram (x
    is y): each against its plain version (``_gram_atol``, ``_hold_bwd``),
    CUDA-event times, plain and library times (``(1 + cdist^2 / 2 alpha)^
    -alpha`` and ``autograd.grad`` through it) and bounds (inputs and the
    output read or written once; the forward's ``exp``/``log`` pair and a
    dozen flops an entry, the backward's about 20)."""
    from stheno_torch.ops import gram as K1
    from stheno_torch.ops import gram_bwd as KB

    n = x.shape[0]
    K, P = K1.gram("rq", x, x, alpha), K1.gram_plain("rq", x, x, alpha)
    err, over = _hold(K, P, _gram_atol("rq", x, x), "gram rq at the decomposition's 2000x1")
    lib = lambda z: (1 + torch.cdist(z, z).square() / (2 * alpha)) ** (-alpha)  # noqa: E731
    b_ms, b_by = bound((2 * n + n * n) * 4, 12 * n * n, torch.float32)
    fwd = {"kind": "rq", "shape": [n, n, 1], "max_abs_err": err, "of_tol": over,
           "ms": time_ms(lambda: K1.gram("rq", x, x, alpha), inner=20),
           "device_ms": device_ms_per_call(lambda: K1.gram("rq", x, x, alpha)),
           "plain_ms": time_ms(lambda: K1.gram_plain("rq", x, x, alpha), inner=5),
           "library_ms": time_ms(lambda: lib(x), inner=5), "bound_ms": b_ms, "bound_by": b_by}
    gbar = k1_cotangent(n)
    cases = []
    bwd_err = _hold_bwd("rq", x, x, gbar, "2000x1, x is y (the decomposition's)", cases, same=True)
    xg, xl = x.clone().requires_grad_(True), x.clone().requires_grad_(True)
    Kg, KL = K1.gram("rq", xg, xg, alpha), lib(xl)
    b_ms, b_by = bound((2 * n + n * n) * 4, 20 * n * n, torch.float32)
    bwd = {"kind": "rq", "shape": [n, n, 1], "max_abs_err": bwd_err, "cases": cases,
           "ms": time_ms(lambda: torch.autograd.grad(Kg, xg, gbar, retain_graph=True), inner=20),
           "plain_ms": time_ms(lambda: KB.gram_bwd_plain("rq", x, x, gbar, alpha, same=True),
                               reps=5, warmup=1),
           "library_ms": time_ms(lambda: torch.autograd.grad(KL, xl, gbar, retain_graph=True),
                                 inner=5),
           "bound_ms": b_ms, "bound_by": b_by}
    return fwd, bwd


def _k2_kron_dsl(A):
    """K2 at a Kronecker factor of the DSL's grid (``A``: the EQ Gram of an
    axis plus 0.1 I, 1024 x 1024, float32): ``(L, inv L)`` against the
    plain version (atol 5e-5, as phase chol_tile), times beside the library
    factorisation and inverse and the bound (``phase_times``'s)."""
    from stheno_torch.ops import chol_tile as K2

    n = A.shape[0]
    (L, Linv), (Lp, Linvp) = K2.chol_tile(A), K2.chol_tile_plain(A)
    err = max(max_err(L, Lp), max_err(Linv, Linvp))
    check(err <= 5e-5, f"chol_tile at the Kronecker factor: {err}")
    eye = torch.eye(n, device="cuda")

    def library():
        Ll = torch.linalg.cholesky(A)
        return Ll, torch.linalg.solve_triangular(Ll, eye, upper=False)

    b_ms, b_by = bound(3 * n * n * 4, 2 * n**3 / 3, torch.float32)
    return {"shape": [n], "max_abs_err": err, "ms": time_ms(lambda: K2.chol_tile(A)),
            "device_ms": device_ms(lambda: K2.chol_tile(A)),
            "plain_ms": time_ms(lambda: K2.chol_tile_plain(A), reps=5, warmup=1),
            "library_ms": time_ms(library), "bound_ms": b_ms, "bound_by": b_by}


def phase_dsl_path(smi):
    """The modelling DSL through the reference's own example models, each
    through its entry point (``stheno_torch.entry``), in float32 on the
    card:

    - example 6's Bayesian linear regression at N=10^6 (``blr_logpdf``
      value and gradient, ``blr_predict``), whose variance is a
      ``Woodbury`` held closed-form: value and gradient against the same
      step in float64 on the card at the main path's gates; the float64
      posterior means against the information form (``_blr_exact``) at
      1e-3 of its largest value; every posterior marginal, float32 and
      float64, finite and of its shape (float32 keeps no digit of them
      at this N); with each step's own peak memory;
    - example 2's decomposition at N=2000 (``decomposition_logpdf``: value,
      gradient and the posterior means of the two components and their
      sum) and example 5's derivative model at N=2000
      (``derivative_condition``: the log-density of the second
      derivative's observations, its gradient and the posterior
      marginals), each against the port in float64 on the CPU at the main
      path's gates (value rel 1e-3, each gradient entry 5e-2, marginals
      1e-3 of the largest float64 value), and ``mean_s + mean_w = mean_f``;
    - ``Normal(0, Kronecker(A + 0.1 I, B + 0.1 I)).logpdf`` on the 1024 x
      1024 grid (``kronecker_logpdf``), value and gradient, unmasked and
      with 10% of each axis masked, against float64 on the card within
      twice the JAX package's float32 error.

    Each float32 step is traced once (``_traced_dsl``: K1, K1-backward and
    K2 launches on the device equal the wrappers' counts) and timed. K1
    (rq) and its backward at the decomposition's Gram and K2 at a
    Kronecker factor are held against their plain versions and timed
    beside their bounds. Returns the kernels line's three rows, whose
    launches are the three kernel-running models' float32 steps'."""
    from stheno_torch import entry as E

    gc.collect()
    torch.cuda.empty_cache()
    cpu64 = lambda t: t.detach().double().cpu()  # noqa: E731
    dev64 = lambda d: {k: v.double() for k, v in d.items()}  # noqa: E731
    report = {"phase": "dsl_path", "nvidia_smi": smi}
    gates, path_counts = [], {k: 0 for k in ("gram", "gram_bwd", "chol_tile")}

    def gate(what, got, limit):
        gates.append({"what": what, "got": got, "limit": limit})
        check(got <= limit, f"dsl_path {what}: {got} exceeds {limit}")

    # Bayesian linear regression, N=10^6.
    x, y, p = E.blr_inputs()
    (v, g), counts = _launched(lambda: E.blr_logpdf(x, y, p, grad=True))
    pred = E.blr_predict(x, y, p)
    check(bool(torch.isfinite(v)) and all(bool(torch.isfinite(t)) for t in g.values()),
          "BLR logpdf or gradient not finite")
    x64, y64, p64 = x.double(), y.double(), dev64(p)
    v64, g64 = E.blr_logpdf(x64, y64, p64, grad=True)
    pred64 = E.blr_predict(x64, y64, p64)
    exact = _blr_exact(x64, y64, p64)
    blr = {"n": x.shape[0], "launches": counts, "value": float(v), "value_f64": float(v64),
           "value_rel": _rel(v, v64), "grad_f64": {k: float(t) for k, t in g64.items()}}
    blr["grad_rel"], blr["grad_rel_each"] = _grad_rel(g, g64)
    gate("BLR value rel", blr["value_rel"], 1e-3)
    for k, r in blr["grad_rel_each"].items():
        gate(f"BLR gradient {k} rel", r, 5e-2)
    # The posterior against its information form. Each variance, and in
    # float32 each mean, is a difference of Woodbury terms about N / noise
    # times larger, so float32 keeps no digit of any of them and float64
    # none of the variances (README): those are held to their shape and
    # finiteness, and their errors recorded. The float64 means are gated.
    for name in ("slope", "intercept", "f"):
        for i, q in enumerate(("mean", "var")):
            ref = exact[name][i]
            blr[f"{name}_{q}_exact_max"] = float(ref.abs().max())
            for tag, out in (("f32", pred), ("f64", pred64)):
                a = out[name][i]
                check(a.shape == ref.shape and bool(torch.isfinite(a).all()),
                      f"BLR {name} {q} ({tag}): shape {tuple(a.shape)} or not finite")
                blr[f"{name}_{q}_{tag}_max_abs_err"] = max_err(a.cpu(), ref)
            blr[f"{name}_{q}_f32_vs_f64_max_abs_err"] = max_err(pred[name][i], pred64[name][i])
        gate(f"BLR {name} mean (f64) against the information form",
             blr[f"{name}_mean_f64_max_abs_err"], 1e-3 * blr[f"{name}_mean_exact_max"])
    del pred64, g64
    gc.collect()
    torch.cuda.empty_cache()
    blr["value_grad_peak_bytes"] = _own_peak(lambda: E.blr_logpdf(x, y, p, grad=True))
    blr["predict_peak_bytes"] = _own_peak(lambda: E.blr_predict(x, y, p))
    blr["value_grad_ms"] = time_ms(lambda: E.blr_logpdf(x, y, p, grad=True), reps=5)
    blr["predict_ms"] = time_ms(lambda: E.blr_predict(x, y, p), reps=3, warmup=1)
    blr["profile"] = _traced_dsl("blr_1e6_value_grad", lambda: E.blr_logpdf(x, y, p, grad=True))
    report["blr_n1e6"] = blr
    del x, y, x64, y64, pred
    gc.collect()
    torch.cuda.empty_cache()

    # Example 2's decomposition, N=2000.
    x, y, p = E.decomposition_inputs()
    (v, g, means), counts = _launched(lambda: E.decomposition_logpdf(x, y, p, grad=True))
    check(counts["gram"] >= 1 and counts["gram_bwd"] >= 1 and counts["chol_tile"] == 2,
          f"the decomposition's launches {counts}")
    rv, rg, rmeans = E.decomposition_logpdf(cpu64(x), cpu64(y), {k: cpu64(t) for k, t in p.items()},
                                            grad=True)
    dec = {"n": x.shape[0], "launches": counts, "value": float(v), "value_f64": float(rv),
           "value_rel": _rel(v, rv), "grad_f64": {k: float(t) for k, t in rg.items()}}
    dec["grad_rel"], dec["grad_rel_each"] = _grad_rel(g, rg)
    gate("decomposition value rel", dec["value_rel"], 1e-3)
    for k, r in dec["grad_rel_each"].items():
        gate(f"decomposition gradient {k} rel", r, 5e-2)
    for k in means:
        err = max_err(means[k].cpu(), rmeans[k])
        dec[f"mean_{k}_max_abs_err"] = err
        gate(f"decomposition mean {k}", err, 1e-3 * max(1.0, float(rmeans[k].abs().max())))
    dec["sum_of_components_max_abs_err"] = max_err(means["smooth"] + means["wiggly"], means["f"])
    gate("decomposition mean_s + mean_w - mean_f", dec["sum_of_components_max_abs_err"],
         1e-3 * max(1.0, float(rmeans["f"].abs().max())))
    dec["value_grad_ms"] = time_ms(lambda: E.decomposition_logpdf(x, y, p, grad=True), reps=5)
    dec["value_grad_peak_bytes"] = _own_peak(lambda: E.decomposition_logpdf(x, y, p, grad=True))
    dec["profile"] = _traced_dsl("decomposition_n2000_value_grad",
                                 lambda: E.decomposition_logpdf(x, y, p, grad=True))
    for k in path_counts:
        path_counts[k] += counts[k]
    report["decomposition_n2000"] = dec
    x_rq = (x / torch.exp(p["log_ell_wiggly"]))[:, None].contiguous()

    # Example 5's derivative model, N=2000.
    x, y, p = E.derivative_inputs()
    (v, g, marg), counts = _launched(lambda: E.derivative_condition(x, y, p, grad=True))
    check(counts["gram"] >= 1 and counts["gram_bwd"] >= 1 and counts["chol_tile"] == 2,
          f"the derivative model's launches {counts}")
    rv, rg, rmarg = E.derivative_condition(cpu64(x), cpu64(y), {k: cpu64(t) for k, t in p.items()},
                                           grad=True)
    der = {"n": x.shape[0], "launches": counts, "value": float(v), "value_f64": float(rv),
           "value_rel": _rel(v, rv), "grad_f64": {k: float(t) for k, t in rg.items()}}
    der["grad_rel"], der["grad_rel_each"] = _grad_rel(g, rg)
    gate("derivative value rel", der["value_rel"], 1e-3)
    for k, r in der["grad_rel_each"].items():
        gate(f"derivative gradient {k} rel", r, 5e-2)
    for name, a, b in zip(("mean", "var"), marg, rmarg):
        check(a.shape == (x.shape[0],) and bool(torch.isfinite(a).all()), f"derivative {name}")
        err = max_err(a.cpu(), b)
        der[f"{name}_max_abs_err"] = err
        gate(f"derivative posterior {name}", err, 1e-3 * max(1.0, float(b.abs().max())))
    der["value_grad_ms"] = time_ms(lambda: E.derivative_condition(x, y, p, grad=True), reps=5)
    der["value_grad_peak_bytes"] = _own_peak(lambda: E.derivative_condition(x, y, p, grad=True))
    der["profile"] = _traced_dsl("derivative_n2000_value_grad",
                                 lambda: E.derivative_condition(x, y, p, grad=True))
    for k in path_counts:
        path_counts[k] += counts[k]
    report["derivative_n2000"] = der

    # The Kronecker Normal on the 1024 x 1024 grid.
    a1, a2, y, p, masks = E.kronecker_inputs()
    kron = {}
    for tag, mask in (("unmasked", None), ("masked", masks)):
        (v, g), counts = _launched(lambda: E.kronecker_logpdf(a1, a2, y, p, grad=True, mask=mask))
        check(counts["gram"] == 2 and counts["gram_bwd"] >= 1 and counts["chol_tile"] == 2,
              f"the Kronecker {tag} run's launches {counts}")
        v64, g64 = E.kronecker_logpdf(a1.double(), a2.double(), y.double(), dev64(p), grad=True,
                                      mask=mask)
        run = {"launches": counts, "value": float(v), "value_f64": float(v64),
               "value_rel": _rel(v, v64), "grad_f64": {k: float(t) for k, t in g64.items()}}
        run["grad_rel"], run["grad_rel_each"] = _grad_rel(g, g64)
        gate(f"Kronecker {tag} value rel", run["value_rel"],
             2 * JAX_F32_DSL[f"kron_{tag}_value_rel"])
        gate(f"Kronecker {tag} gradient rel", run["grad_rel"],
             2 * JAX_F32_DSL[f"kron_{tag}_grad_rel"])
        step = lambda mask=mask: E.kronecker_logpdf(a1, a2, y, p, grad=True, mask=mask)  # noqa: E731
        run["value_grad_ms"] = time_ms(step, reps=5)
        run["value_grad_peak_bytes"] = _own_peak(step)
        run["profile"] = _traced_dsl(f"kronecker_{tag}_value_grad", step)
        for k in path_counts:
            path_counts[k] += counts[k]
        kron[tag] = run
    report["kronecker_1024x1024"] = kron
    emit({"phase": "dsl_path_gates", "nvidia_smi": smi, "gates": gates})

    # The kernels at the DSL's shapes.
    from stheno_torch import EQ, dense, pairwise

    k1, k1b = _k1_rq_dsl(x_rq, 0.1)
    A = dense(pairwise(EQ(), a1)) + 0.1 * torch.eye(a1.shape[0], device="cuda")
    k2 = _k2_kron_dsl(A)
    report.update(gram_rq_2000=k1, gram_bwd_rq_2000=k1b, chol_tile_kron_1024=k2,
                  path_launches=path_counts)
    emit(report)
    return [
        {"name": name, "route": "cuda", "source": KERNELS[name]["source"],
         "replaces": KERNELS[name]["replaces"], "launches": path_counts[base],
         **{k: row[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                "library_ms")}}
        for name, base, row in (("gram_dsl", "gram", k1), ("gram_bwd_dsl", "gram_bwd", k1b),
                                ("chol_tile_dsl", "chol_tile", k2))
    ]


# ---------------------------------------------------------------------------
# Item 8: pathwise posterior draws and SVGP (bench.py:bench_pathwise_262k,
# the sparse path's N=10^6 data), and derivatives of a conditioned process.


def _k3_item8_times(x, xq, v):
    """K3's FFMA route at the pathwise path's two shapes, ``x (262,144, 1)``
    square at p = 8 (a CG sweep) and ``xq (4096, 1)`` by ``x`` at p = 8 (the
    evaluation's cross term): each held against its plain version
    (``_gmv_rtol`` of ``|G| @ |v|``, as phase gram_matvec), then timed by
    ``k3_shape_times``."""
    from stheno_torch.ops import gram_matvec as K3

    exps_per_s, mhz = sfu_exps_per_s()
    out = {}
    for tag, rows in (("cg_262144_p8", x), ("eval_4096_p8", xq)):
        got = K3.gram_matvec("eq", rows, x, v)
        ref = K3.gram_matvec_plain("eq", rows, x, v)
        rtol = _gmv_rtol(x.shape[0], rows.dtype)
        rel = float(((got - ref).abs() / _gmv_atol_scale("eq", rows, x, v).clamp_min(1e-30)).max())
        check(rel <= rtol, f"gram_matvec eq {tag}: error {rel} of |G||v| > {rtol}")
        out[tag] = {"max_abs_err": max_err(got, ref), "max_rel_err_of_scale": rel, "rtol": rtol,
                    **k3_shape_times(rows, x, v, exps_per_s), "sm_clock_mhz": mhz}
        del got, ref
    return out


#: K3's three routes' device kernels, their wrappers' counts and the
#: device launches of one wrapper call (``_traced_exact``).
K3_KERNELS = (("gmv_kernel", "gram_matvec_ffma", 1), ("gmv_mma_kernel", "gram_matvec_mma", 1),
              ("gmv_dmma_kernel", "gram_matvec_dmma", 1))


def phase_item8_path(smi):
    """Item 8 through the user's entry points (``stheno_torch.entry``) and
    the modelling DSL, on the card, in float32 unless stated:

    (a) pathwise draws at ``bench_pathwise_262k``'s size (N=262,144, EQ,
        noise 0.1, 8 draws, 2048 features, the whitened CG at tol 1e-4,
        preconditioner rank 64, blocks of 8192): the CG's residual gated at
        bench.py's 1e-4, the build's seconds (host clock around a
        synchronised build, median of 3 after the first), the evaluation at
        4096 points (CUDA events, median of 20 after 3 warm-ups; traced: one
        FFMA K3 launch and no K1), the draws finite, and against a float64
        build on the card from the same draws (cast up) within twice the
        JAX package's own float32 error (``JAX_F32_ITEM8``); K3's FFMA route
        at the CG's and the evaluation's shapes beside its bound;
    (b) pathwise with the dense solver at N=2000: the build's time and its
        K1 and K2 launches, the draws against the same draws through the
        port in float64 on the CPU at the main path's 1e-3;
    (c) SVGP on the sparse path's N=10^6, M=512 data: the minibatch (4096)
        ELBO against float64 on the card for the same batch and state
        (the main path's 1e-3), its float32 gradient with respect to (log
        s2, log ell, z) finite (the JAX package's keeps no digit), the
        card's float64 value and gradient against the port's float64 on
        the CPU (``_svgp_f64_limit``), one natural-gradient
        step at that batch, timed; at full batch, a ``rho = 1`` step and the
        ELBO in float64 against the port's collapsed VFE ELBO
        (``entry.sparse_elbo``) under the same jitter (rel 1e-6), and in
        float32 against float64 (within twice the JAX package's float32
        error where that is finite, else finite); each step's time, busy
        share, own peak memory and K1 and K1-backward launches (traced); K1
        and its backward at the minibatch's 512 x 4096 Gram;
    (d) derivative conditioning (``tests/model/test_cases.py``'s story) at
        N=2000 in float64: the posterior mean of ``f.diff(0)`` after
        conditioning on sin within 1e-3 of cos, its time and launches.

    Every traced count equals the wrappers'. Each part prints its line as
    it ends, and the gates one line at the close."""
    from stheno_torch import EQ, GP
    from stheno_torch import entry as E
    from stheno_torch.model import pathwise as TP

    gc.collect()
    torch.cuda.empty_cache()
    gates = []

    def part(name, **numbers):
        emit({"phase": "item8_path", "part": name, "nvidia_smi": smi, **numbers})

    def gate(what, got, limit):
        gates.append({"what": what, "got": got, "limit": limit})
        check(got <= limit, f"item8_path {what}: {got} exceeds {limit}")

    def gen():
        return torch.Generator(device="cuda").manual_seed(0)

    # (a) Pathwise at N=262,144.
    x, y = E.pathwise_262k_inputs()
    x_new = torch.linspace(-1.0, 11.0, 4096, device="cuda")
    (fn, info), counts = _launched(lambda: E.pathwise_build(x, y, gen()))
    pw = {"n": x.shape[0], "build_launches": counts, "cg_iters": info["iters"],
          "cg_rel_residual": float(info["rel_residual"])}
    gate("pathwise CG relative residual", pw["cg_rel_residual"], 1e-4)
    builds = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        E.pathwise_build(x, y, gen())
        torch.cuda.synchronize()
        builds.append(time.perf_counter() - t0)
    pw["build_s"], pw["build_s_samples"] = statistics.median(builds), builds
    draws = fn(x_new)
    check(draws.shape == (4096, 8) and bool(torch.isfinite(draws).all()),
          f"pathwise draws: shape {tuple(draws.shape)} or not finite")
    pw["eval_4096x8_ms"] = time_ms(lambda: fn(x_new))
    pw["eval_profile"] = _traced_exact("pathwise_eval_4096x8", lambda: fn(x_new),
                                       K1_KERNELS + K3_KERNELS)
    ev = pw["eval_profile"]["wrapper_launches"]
    check(ev["gram_matvec_ffma"] == 1 and ev["gram"] == 0 and ev["gram_matvec_mma"] == 0
          and ev["gram_matvec_dmma"] == 0,
          f"the evaluation's launches {ev}: one FFMA K3 and nothing else")
    pw["v5e_tpu"] = {"pathwise_build_n262144_s": 2.41, "pathwise_n262144_eval4096x8_s": 0.003,
                     "source": "BENCH_r05.json, TPU v5e"}
    opts = dict(num_features=2048, solver="cg", block=8192, cg_tol=1e-4, max_cg_iters=200,
                precond_rank=64, compensated="auto")
    same = TP._draw(EQ(), gen(), x.shape[0], 1, torch.float32, num_samples=8, num_features=2048)
    up = (same[0].double(), same[1].double(), same[2].double())
    fn64, info64 = TP._build(EQ(), x.double(), y.double(), 0.1, up, **opts)
    ref = fn64(x_new.double())
    pw["cg_f64"] = {"iters": info64["iters"], "rel_residual": float(info64["rel_residual"])}
    pw["draws_rel_f64"] = max_err(draws, ref) / float(ref.abs().max())
    gate("pathwise float32 draws against float64 (same draws)", pw["draws_rel_f64"],
         2 * JAX_F32_ITEM8["pathwise_draws_rel"])
    del fn64, ref, up, same
    gc.collect()
    torch.cuda.empty_cache()
    v8 = torch.randn(x.shape[0], 8, generator=gen(), device="cuda")
    part("pathwise_n262144", **pw,
         gram_matvec_ffma=_k3_item8_times(x[:, None], x_new[:, None], v8))
    del fn, draws, x, y, v8
    gc.collect()
    torch.cuda.empty_cache()

    # (b) Pathwise with the dense solver at N=2000.
    x, y = E.pathwise_262k_inputs(n=2000)
    xq = torch.linspace(-1.0, 11.0, 500, device="cuda")
    (fn, _), counts = _launched(lambda: E.pathwise_build(x, y, gen(), solver="chol"))
    check(counts["gram"] >= 1, f"the dense pathwise build's launches {counts}")
    same = TP._draw(EQ(), gen(), 2000, 1, torch.float32, num_samples=8, num_features=2048)
    cpu64 = tuple(t.double().cpu() for t in same)
    fn_cpu, _ = TP._build(EQ(), x.double().cpu(), y.double().cpu(), 0.1, cpu64,
                          **{**opts, "solver": "chol"})
    got, ref = fn(xq), fn_cpu(xq.double().cpu())
    check(bool(torch.isfinite(got).all()), "dense pathwise draws not finite")
    chol = {"n": 2000, "launches": counts, "draws_max_abs_err": max_err(got.cpu(), ref),
            "draws_max_abs_f64": float(ref.abs().max()),
            "build_ms": time_ms(lambda: E.pathwise_build(x, y, gen(), solver="chol"), reps=5)}
    gate("dense pathwise draws against float64 on the CPU", chol["draws_max_abs_err"],
         1e-3 * max(1.0, chol["draws_max_abs_f64"]))
    part("pathwise_chol_n2000", **chol)

    # (c) SVGP at N=10^6, M=512.
    x, y, theta, params = E.svgp_1m_inputs()
    dev64 = lambda d: {k: v.double() for k, v in d.items()}  # noqa: E731
    x64, y64, th64, p64 = x.double(), y.double(), dev64(theta), dev64(params)
    one = torch.ones((), device="cuda")
    eps32 = E.sparse_jitter(params["z"][:, 0], one)
    eps64 = E.sparse_jitter(p64["z"][:, 0], one.double())
    state64 = E.svgp_1m_natgrad(x64, y64, th64, p64, rho=1.0, jitter=eps32)
    state32 = {k: v.float() for k, v in state64.items()}
    step = lambda: E.svgp_1m_step(x, y, theta, state32, grad=True, jitter=eps32)  # noqa: E731
    (v32, g32), counts = _launched(step)
    check(counts["gram"] >= 1 and counts["gram_bwd"] >= 1, f"the SVGP step's launches {counts}")
    v64, g64 = E.svgp_1m_step(x64, y64, th64, state64, grad=True, jitter=eps32)
    mb = {"batch": 4096, "jitter": eps32, "launches": counts, "elbo": float(v32),
          "elbo_f64": float(v64), "elbo_rel": _rel(v32, v64),
          "grad_f64": {k: float(g64[k]) for k in ("log_s2", "log_ell")},
          "grad_z_f64_norm": float(torch.linalg.norm(g64["z"]))}
    for k in ("log_s2", "log_ell"):
        mb[f"grad_{k}_rel"] = _rel(g32[k], g64[k])
    mb["grad_z_rel"] = float(torch.linalg.norm(g32["z"].double() - g64["z"])
                             / torch.linalg.norm(g64["z"]))
    check(bool(torch.isfinite(v32)) and all(bool(torch.isfinite(t).all()) for t in g32.values()),
          "the SVGP minibatch ELBO or gradient is not finite")
    gate("SVGP minibatch float32 ELBO rel", mb["elbo_rel"], 1e-3)
    # The float32 gradient keeps no digit in the JAX package either (its
    # error is 2.2, 1.8 and 202 relative): only its finiteness is gated
    # above. The card's float64 value and gradient are held against the
    # port's float64 on the CPU for the same batch and state instead.
    cpu = lambda d: {k: v.cpu() for k, v in d.items()}  # noqa: E731
    vc, gc64 = E.svgp_1m_step(x64.cpu(), y64.cpu(), cpu(th64), cpu(state64), grad=True,
                              jitter=eps32)
    mb["f64_card_vs_cpu"] = {"elbo_rel": _rel(v64.cpu(), vc),
                             **{f"grad_{k}_rel": _rel(g64[k].cpu(), gc64[k])
                                for k in ("log_s2", "log_ell")},
                             "grad_z_rel": float(torch.linalg.norm(g64["z"].cpu() - gc64["z"])
                                                 / torch.linalg.norm(gc64["z"]))}
    for k in ("elbo", "grad_log_s2", "grad_log_ell", "grad_z"):
        gate(f"SVGP minibatch float64 {k} on the card against the CPU",
             mb["f64_card_vs_cpu"][f"{k}_rel"], _svgp_f64_limit(k))
    mb["value_grad_ms"] = time_ms(step, reps=5)
    mb["value_grad_peak_bytes"] = _own_peak(step)
    mb["profile"] = _traced_exact("svgp_minibatch_value_grad", step, K1_KERNELS)
    nat = lambda: E.svgp_1m_natgrad(x, y, theta, state32, rho=0.3, jitter=eps32)  # noqa: E731
    (_, counts) = _launched(nat)
    mb["natgrad_launches"] = counts
    mb["natgrad_ms"] = time_ms(nat, reps=5)
    mb["natgrad_profile"] = _traced_exact("svgp_minibatch_natgrad", nat, K1_KERNELS)
    del state64, g64
    part("svgp_minibatch", **mb)

    full = {"n": x.shape[0]}
    pf64 = E.svgp_1m_natgrad(x64, y64, th64, p64, batch=None, rho=1.0, jitter=eps64)
    e64 = E.svgp_1m_step(x64, y64, th64, pf64, batch=None, jitter=eps64)
    vfe64 = E.sparse_elbo(x64, y64, p64["z"][:, 0], one.double(), jitter=eps64)
    full.update(jitter_f64=eps64, elbo_f64=float(e64), vfe_f64=float(vfe64),
                identity_rel_f64=_rel(e64, vfe64))
    gate("SVGP full-batch rho=1 ELBO against the collapsed VFE (float64)",
         full["identity_rel_f64"], 1e-6)
    del pf64
    gc.collect()
    torch.cuda.empty_cache()
    nat_full = lambda: E.svgp_1m_natgrad(x, y, theta, params, batch=None, rho=1.0,  # noqa: E731
                                         jitter=eps32)
    pf32, counts = _launched(nat_full)
    e32 = E.svgp_1m_step(x, y, theta, pf32, batch=None, jitter=eps32)
    pf64 = E.svgp_1m_natgrad(x64, y64, th64, p64, batch=None, rho=1.0, jitter=eps32)
    e64b = E.svgp_1m_step(x64, y64, th64, pf64, batch=None, jitter=eps32)
    full.update(jitter_f32=eps32, natgrad_launches=counts, elbo_f32=float(e32),
                elbo_f64_same_jitter=float(e64b), elbo_rel_f32=_rel(e32, e64b))
    check(bool(torch.isfinite(e32)), "the float32 full-batch SVGP ELBO is not finite")
    if math.isfinite(JAX_F32_ITEM8["svgp_full_elbo_rel"]):
        gate("SVGP full-batch float32 ELBO against float64", full["elbo_rel_f32"],
             2 * JAX_F32_ITEM8["svgp_full_elbo_rel"])
    del pf64, x64, y64, p64, th64
    gc.collect()
    torch.cuda.empty_cache()
    val_full = lambda: E.svgp_1m_step(x, y, theta, pf32, batch=None, jitter=eps32)  # noqa: E731
    full["natgrad_ms"] = time_ms(nat_full, reps=3, warmup=1)
    full["elbo_ms"] = time_ms(val_full, reps=3, warmup=1)
    full["natgrad_peak_bytes"] = _own_peak(nat_full)
    full["elbo_peak_bytes"] = _own_peak(val_full)
    full["natgrad_profile"] = _traced_exact("svgp_full_natgrad", nat_full, K1_KERNELS)
    full["elbo_profile"] = _traced_exact("svgp_full_elbo", val_full, K1_KERNELS)
    part("svgp_full_batch", **full)
    zs = params["z"]
    xb = E._svgp_batch(x, y, 4096)[0]
    part("gram_svgp_512x4096", gram=k1_sparse_times(zs, xb), gram_bwd=k1_bwd_sparse_times(zs, xb))
    del x, y, pf32
    gc.collect()
    torch.cuda.empty_cache()

    # (d) F2: the derivative of a conditioned process, N=2000, float64.
    xd = torch.linspace(0.0, 6.0, 2000, device="cuda", dtype=torch.float64)
    x_check = torch.linspace(1.0, 5.0, 2000, device="cuda", dtype=torch.float64)

    def derivative():
        f = GP(EQ())
        post = f.measure.condition(f(xd, 1e-8), torch.sin(xd))
        return post(f.diff(0))(x_check).marginals()

    (mean, var), counts = _launched(derivative)
    check(bool(torch.isfinite(mean).all()) and bool(torch.isfinite(var).all()),
          "the derivative's posterior marginals are not finite")
    der = {"n": 2000, "launches": counts,
           "mean_max_abs_err_vs_cos": max_err(mean, torch.cos(x_check)),
           "var_max": float(var.max()), "ms": time_ms(derivative, reps=3, warmup=1),
           "peak_bytes": _own_peak(derivative)}
    gate("F2: posterior mean of f.diff(0) against cos", der["mean_max_abs_err_vs_cos"], 1e-3)
    der["profile"] = _traced_exact("derivative_conditioning_n2000", derivative, K1_KERNELS)
    part("derivative_conditioning_n2000", **der)
    emit({"phase": "item8_path_gates", "nvidia_smi": smi, "gates": gates})


def _svgp_f64_limit(what):
    """The gate of the card's float64 SVGP minibatch ``what`` (the ELBO,
    or the gradient's log_s2, log_ell or z entry, z's normwise) against
    the port's float64 on the CPU: twice the JAX package's own float32
    error scaled down by the ratio of the unit roundoffs (2^-29), and no
    less than 1e-8."""
    key = "svgp_minibatch_elbo_rel" if what == "elbo" else f"svgp_minibatch_{what}_rel"
    return max(1e-8, 2 * JAX_F32_ITEM8[key] * 2.0 ** -29)


# ---------------------------------------------------------------------------
# Item 9: the structured-grid (circulant FFT) and Kronecker paths of
# bench.py:bench_structured_grids, the small-noise (compensated) operator of
# bench_compensated_262k, and the tile options.


def _grid_value_grad(axis, y, params, u, om):
    """``grid_iterative_nlml``'s step (``entry.grid_nlml_1m_step``'s
    settings) on given probes ``u`` and ``om``: the NLML core with the FFT
    matvec, so a float32 and a float64 run share their probes."""
    from stheno_torch import entry as E
    from stheno_torch.iterative import nlml as NL
    from stheno_torch.iterative import toeplitz as TZ

    shape = (axis.shape[0],)

    def mv(k, xx, v, nz):
        return TZ.grid_matvec(k, TZ._axes_from_coords(xx, shape), v, noise=nz)

    def fn(p):
        return NL._nlml(p, y, E.GRID_NOISE, TZ.grid_coords((axis,)), u, om, None, E.grid_kernel,
                        1e-2, 100, 20, 64, "eig", 1, matvec_fn=mv)[0]

    return E._value_and_grad(fn, params, True)


def _f64_direct_rows(x, v, rows, noise, gram):
    """``(G + noise I) v`` on the first ``rows`` rows, in float64, by direct
    differencing: ``gram(d2)`` of ``d2 = (x_i - x_j)^2``, 512 rows at once."""
    xd, vd = x.double(), v.double()
    out = []
    for r0 in range(0, rows, 512):
        d = xd[r0:r0 + 512, None] - xd[None, :]
        out.append(gram(d * d) @ vd + noise * vd[r0:r0 + 512])
    return torch.cat(out)


def _slice_exactness():
    """The Ozaki split's slice products on the card, at the largest
    magnitudes ``split_two_slices`` allows (entries 128 times their
    power-of-two scale, some rows and columns all 128, so partial sums reach
    2^23 over a 512-wide block): the route the code takes (float32 storage,
    full-float32 products, ``compensated._exact_slice_matmul``) held bitwise
    against float64 products of the same slices; bfloat16 storage through
    ``torch.bmm`` (whose result is bfloat16) and ``aten::bmm.dtype`` with a
    float32 output recorded beside it."""
    from stheno_torch.iterative import compensated as CP

    gen = torch.Generator(device="cuda").manual_seed(0)
    m, c, p = 256, 8192, 8
    A = torch.randint(-128, 129, (m, c), generator=gen, device="cuda").float()
    B = torch.randint(-128, 129, (c, p), generator=gen, device="cuda").float()
    A[:8], A[8:16], B[:, :4] = 128.0, -128.0, 128.0
    A = A * torch.ldexp(torch.ones(m, 1, device="cuda"),
                        torch.randint(-40, 40, (m, 1), generator=gen, device="cuda"))
    B = B * torch.ldexp(torch.ones(1, p, device="cuda"),
                        torch.randint(-40, 40, (1, p), generator=gen, device="cuda"))
    blocks = lambda t, dt: (t.to(dt).reshape(m, -1, 512).transpose(0, 1),  # noqa: E731
                            B.to(dt).reshape(-1, 512, p))
    exact = torch.bmm(*blocks(A, torch.float64))
    out = {"shape": [m, c, p], "sub": 512, "largest_partial_sum": 2.0**23}
    out["float32_parts_bitwise"] = bool(torch.equal(torch.bmm(*blocks(A, torch.float32)).double(),
                                                    exact))
    hi, lo = CP._exact_slice_matmul(A, B, 512)
    out["float32_pair_exact"] = bool(torch.equal(hi.double() + lo.double(), exact.sum(0)))
    bf = torch.bmm(*blocks(A, torch.bfloat16))
    out["bfloat16_bmm_dtype"] = str(bf.dtype)
    out["bfloat16_bmm_bitwise"] = bool(torch.equal(bf.double(), exact))
    try:
        od = torch.ops.aten.bmm.dtype(*blocks(A, torch.bfloat16), torch.float32)
        out["bmm_dtype_float32_bitwise"] = bool(torch.equal(od.double(), exact))
    except (AttributeError, RuntimeError) as e:
        out["bmm_dtype_float32_bitwise"] = f"not available ({type(e).__name__})"
    check(out["float32_parts_bitwise"] and out["float32_pair_exact"],
          f"the float32 slice products are not exact on this card: {out}")
    return out


def _bf16_tile_plain(x, v, params, rows=2048):
    """The plain version of the bfloat16-tile matvec on its first ``rows``
    rows: the float32 plain tile rounded once to bfloat16, times ``v``
    rounded, summed in float32; and its tolerance against the card, entry
    by entry: the two tiles within ``_gram_atol`` plus one bfloat16 rounding
    (``_bf16_tol``) of each other, times ``|v|``, plus the float32 sums'
    order (``_gmv_rtol`` of the scale)."""
    from stheno_torch.ops import gram as K1

    xw = (x / torch.exp(params["log_ell"]))[:, None].contiguous()
    G = K1.gram_plain("eq", xw[:rows], xw)
    vb = v.to(torch.bfloat16).float()
    ref = G.to(torch.bfloat16).float() @ vb
    atol = _gram_atol("eq", xw, xw)
    scale = G.abs() @ vb.abs()
    tol = (atol + 2.0**-7 * (G.abs() + atol)) @ vb.abs() + _gmv_rtol(x.shape[0], v.dtype) * scale
    return ref, tol


def _k1_bf16_tile_times(xb, x):
    """K1's float32-in, bfloat16-out instance at the tile option's tile,
    ``xb (8192, 1)`` by ``x (262,144, 1)``: against its plain version (the
    float32 plain tile rounded once, ``_bf16_tol`` of ``_gram_atol``), its
    CUDA-event and device times, the plain version, ``exp(-0.5 cdist^2)``
    cast to bfloat16, and the bound (the float32 inputs read once, the
    bfloat16 tile written once)."""
    from stheno_torch.ops import gram as K1

    n, m = xb.shape[0], x.shape[0]
    call = lambda: K1.gram("eq", xb, x, out_dtype=torch.bfloat16)  # noqa: E731
    plain = lambda: K1.gram_plain("eq", xb, x).to(torch.bfloat16)  # noqa: E731
    K = call()
    check(K.dtype == torch.bfloat16, f"the bfloat16 tile's dtype {K.dtype}")
    # Held in chunks of 1024 rows: the whole tile's float64 differences
    # would take about 70 GB.
    atol, held = _gram_atol("eq", xb, x), []
    for r0 in range(0, n, 1024):
        P = K1.gram_plain("eq", xb[r0:r0 + 1024], x).to(torch.bfloat16)
        held.append(_hold(K[r0:r0 + 1024], P, _bf16_tol(atol, P), "gram eq f32 -> bf16 tile"))
        del P
    err, over = max(e for e, _ in held), max(o for _, o in held)
    del K
    b_ms, b_by = bound((n + m) * 4 + n * m * 2, n * m * 6, torch.float32)
    return {"shape": [n, m, 1], "dtype": "float32 -> torch.bfloat16", "max_abs_err": err,
            "of_tol": over, "ms": time_ms(call, inner=5),
            "device_ms": device_ms_per_call(call, inner=5),
            "plain_ms": time_ms(plain, reps=5, warmup=1),
            "library_ms": time_ms(
                lambda: torch.exp(-0.5 * torch.cdist(xb, x).square()).to(torch.bfloat16), reps=5),
            "bound_ms": b_ms, "bound_by": b_by}


def _k3_item9_times(rows, cols, v, tag, exps_per_s, block=4096):
    """K3 (eq, d = 1) at an item-9 shape: held against its plain version
    (``_gmv_rtol`` of ``|G| @ |v|``, as phase gram_matvec), then timed by
    ``k3_shape_times`` (the plain version and library sweep in row blocks of
    ``block``)."""
    from stheno_torch.ops import gram_matvec as K3

    got = K3.gram_matvec("eq", rows, cols, v)
    ref = torch.cat([K3.gram_matvec_plain("eq", rb, cols, v) for rb in torch.split(rows, block)])
    rtol = _gmv_rtol(cols.shape[0], rows.dtype)
    scale = torch.cat([_gmv_atol_scale("eq", rb, cols, v) for rb in torch.split(rows, block)])
    rel = float(((got - ref).abs() / scale.clamp_min(1e-30)).max())
    check(rel <= rtol, f"gram_matvec eq {tag}: error {rel} of |G||v| > {rtol}")
    out = {"max_abs_err": max_err(got, ref), "max_rel_err_of_scale": rel, "rtol": rtol}
    del got, ref, scale
    return {**out, **k3_shape_times(rows, cols, v, exps_per_s, block=block)}


def phase_item9_path(smi):
    """Item 9 through the user's entry points (``stheno_torch.entry``), on
    the card, in float32 unless stated (one JSON line per part, then the
    gates):

    (a) the circulant grid of ``bench_structured_grids``: the N=2^20 NLML
        value and gradient (the step's settings: 8 probes, CG tol 1e-2 at
        most 100 iterations, rank 64), traced (no K1 or K3: FFTs only),
        timed (median of 3) and its own peak memory read; against float64
        on the card from the same probes (drawn in float64, cast down, the
        core of ``grid_iterative_nlml``), value and gradient within twice
        the JAX package's own float32 error (``JAX_F32_ITEM9``); at N=4096
        (rank 256, 16 probes, tol 1e-8) the float64 step against the dense
        GP's exact logpdf
        (``tests/test_toeplitz.py``'s bounds: value rtol 2e-3, gradient
        rtol 0.25 with atol 0.5); the posterior mean at 4096 points (K3)
        against float64 on the card within twice the JAX package's float32
        error, the variance at 512 (K1 cross Grams) held finite and
        nonnegative (float32 keeps no digit of it in either package), and
        at N=4096 in float64 the posterior at 128 points against the dense
        GP's marginals (mean rtol 1e-6, variance 1e-4, atol 1e-8);
    (b) the Kronecker 1024 x 1024 grid: value and gradient traced, timed,
        peak memory, against float64 on the card within twice the JAX
        package's float32 error; ``eigh``'s and a mode product's time
        beside K1's at the factor; the exact posterior at 4096 points;
    (c) the compensated operator: the slice products' exactness
        (``_slice_exactness``); ``compensated_matvec8_262k`` (K3's float64
        route), timed once after a warm call and traced, against a float64
        direct-difference reference on 8192 rows (3e-7 of the largest
        entry, ``tests/test_compensated.py``'s bound), its own peak
        memory; the double-float route for ``EQ() + 0.5 Matern32()`` at
        N=65,536, p=8, timed and gated the same way; the small-noise weights
        at N=262,144 (true residual <= 1e-4, ``bench.py``'s gate), the
        plain float32 path's residual beside it; pathwise draws at n=512,
        noise 1e-5 through the compensated solve within 0.05 of ``y``;
    (d) the tile options: ``kernel_matvec(tile_dtype=bf16)`` at N=262,144,
        p=17 against its plain version (the same rounded tiles) and
        against float32 (bfloat16's 2^-6 of the largest float32 entry);
        ``variance_cache(basis_tile_dtype=bf16)`` at ``bench.py``'s
        settings, timed, its variance within 5e-4 of the float32 basis's
        (``bench.py:373``); ``symmetric=True`` at N=65,536 against the row
        sweep (``_gmv_rtol`` of ``|G| @ |v|``).

    Every traced K1, K1-backward and K3 count equals the wrappers'. Returns
    the kernels line's rows: K1 at the Kronecker factor and at the grid
    variance's 2^20 x 512 cross Gram, K1's backward at the factor, K3 at
    the grid mean's 4096 x 2^20, p=1, K3's float64 route at the compensated
    matvec's 262,144^2, p=8, and K1's bfloat16 tile at the tile option's
    8192 x 262,144."""
    from stheno_torch import EQ, GP, Matern32
    from stheno_torch import entry as E
    from stheno_torch import iterative as it
    from stheno_torch.iterative import kron as KR

    gc.collect()
    torch.cuda.empty_cache()
    gates, path, pending = [], {}, []
    kernels_all = K1_KERNELS + K3_KERNELS

    def part(name, **numbers):
        # The part's numbers first, then its gates: a failed gate's line
        # still carries every number beside it.
        emit({"phase": "item9_path", "part": name, "nvidia_smi": smi, **numbers})
        for what, got, limit in pending:
            check(got <= limit, f"item9_path {what}: {got} exceeds {limit}")
        pending.clear()

    def gate(what, got, limit):
        gates.append({"what": what, "got": got, "limit": limit})
        pending.append((what, got, limit))

    def gen(seed=0):
        return torch.Generator(device="cuda").manual_seed(seed)

    def synced_s(fn, reps=3):
        out = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append(time.perf_counter() - t0)
        return statistics.median(out), out

    # (a) The circulant grid, N=2^20.
    axis, y, params = E.grid_1m_inputs()
    n = axis.shape[0]
    step = lambda: E.grid_nlml_1m_step(axis, y, params, gen())  # noqa: E731
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        (v32, g32), counts = _launched(step)
    grid = {"n": n, "launches": counts, "value": float(v32),
            "grad": {k: float(t) for k, t in g32.items()},
            "warnings": sorted({str(w.message)[:160] for w in rec})}
    check(bool(torch.isfinite(v32)) and all(bool(torch.isfinite(t)) for t in g32.values()),
          "the grid NLML or its gradient is not finite")
    grid["value_grad_s"], grid["value_grad_s_samples"] = synced_s(step)
    grid["value_grad_peak_bytes"] = _own_peak(step)
    grid["profile"] = _traced_exact("grid_nlml_1m_value_grad", step, kernels_all)
    u64 = torch.randn(n, 8, generator=gen(1), device="cuda", dtype=torch.float64)
    om64 = torch.randn(n, 64, generator=gen(1), device="cuda", dtype=torch.float64)
    f32 = _grid_value_grad(axis, y, params, u64.float(), om64.float())
    a64, y64, p64 = E.grid_1m_inputs(dtype=torch.float64)
    f64 = _grid_value_grad(a64, y64, p64, u64, om64)
    grid["same_probes"] = {"value_f32": float(f32[0]), "value_f64": float(f64[0]),
                           "value_rel": _rel(f32[0], f64[0]),
                           "grad_f64": {k: float(t) for k, t in f64[1].items()}}
    grid["same_probes"]["grad_rel"], grid["same_probes"]["grad_rel_each"] = _grad_rel(f32[1],
                                                                                      f64[1])
    gate("grid N=2^20 value (same probes) against float64", grid["same_probes"]["value_rel"],
         2 * JAX_F32_ITEM9["grid_value_rel"])
    gate("grid N=2^20 gradient (same probes) against float64", grid["same_probes"]["grad_rel"],
         2 * JAX_F32_ITEM9["grid_grad_rel"])
    del u64, om64, a64, y64, f64
    # The float64 step against the dense GP at N=4096.
    a4, y4, p4 = E.grid_1m_inputs(n=4096, dtype=torch.float64)
    v4, g4 = E.grid_nlml_1m_step(a4, y4, p4, gen(), num_probes=16, cg_tol=1e-8,
                                 max_cg_iters=500, slq_steps=30, precond_rank=256)
    leaves = {k: t.clone().requires_grad_(True) for k, t in p4.items()}
    with torch.enable_grad():
        f = GP(E.grid_kernel(leaves))
        dense_v = -f.measure.logpdf(f(a4, E.GRID_NOISE), y4)
        dense_g = dict(zip(leaves, torch.autograd.grad(dense_v, list(leaves.values()))))
    grid["n4096_f64"] = {"value": float(v4), "dense_value": float(dense_v.detach()),
                         "value_rel": _rel(v4, dense_v),
                         "grad": {k: float(t) for k, t in g4.items()},
                         "dense_grad": {k: float(t) for k, t in dense_g.items()}}
    gate("grid N=4096 float64 value against the dense logpdf", grid["n4096_f64"]["value_rel"],
         2e-3)
    for k in g4:
        gate(f"grid N=4096 float64 gradient {k} against the dense one",
             abs(float(g4[k]) - float(dense_g[k])), 0.5 + 0.25 * abs(float(dense_g[k])))
    # The posterior on the grid.
    post = lambda: E.grid_posterior_1m(axis, y, params)  # noqa: E731
    (mean, var, minfo), counts = _launched(post)
    path["grid_posterior"] = counts
    a64, y64, p64 = E.grid_1m_inputs(dtype=torch.float64)
    mean64, var64, minfo64 = E.grid_posterior_1m(a64, y64, p64, chunk=128)
    check(bool(torch.isfinite(mean).all()) and bool(torch.isfinite(var).all())
          and mean.shape == (4096,) and var.shape == (512,), "the grid posterior's shapes")
    check(bool((var >= 0).all()), "the grid posterior variance is negative")
    gp = {"launches": counts, "mean_cg_iters": minfo["iters"],
          "mean_cg_rel_residual": float(minfo["rel_residual"]),
          "mean_cg_iters_f64": minfo64["iters"],
          "mean_rel": max_err(mean, mean64) / float(mean64.abs().max()),
          "mean_f64_max": float(mean64.abs().max()),
          "var_rel": max_err(var, var64) / float(var64.abs().max()),
          "var_f64_max": float(var64.abs().max())}
    gate("grid posterior mean against float64", gp["mean_rel"],
         2 * JAX_F32_ITEM9["grid_mean_rel"])
    del a64, y64, mean64, var64
    # The posterior in float64 at N=4096 against the dense GP's marginals
    # (tests/test_toeplitz.py's bounds: mean rtol 1e-6, variance 1e-4).
    xn4 = torch.linspace(0.5, 99.5, 128, dtype=torch.float64, device="cuda")
    with torch.no_grad():
        m4 = it.grid_posterior_mean(E.grid_kernel, p4, a4, y4, E.GRID_NOISE, xn4, cg_tol=1e-10,
                                    precond_rank=256)[0]
        s4 = it.grid_posterior_var(E.grid_kernel, p4, a4, y4, E.GRID_NOISE, xn4, cg_tol=1e-10,
                                   precond_rank=256)
        f = GP(E.grid_kernel(p4))
        dm, dv = (f | (f(a4, E.GRID_NOISE), y4))(xn4).marginals()
    gp["n4096_f64"] = {"mean_max_abs_err": max_err(m4, dm), "var_max_abs_err": max_err(s4, dv)}
    gate("grid N=4096 float64 posterior mean against the dense one, of its tolerance",
         float(((m4 - dm).abs() / (1e-6 * dm.abs() + 1e-8)).max()), 1.0)
    gate("grid N=4096 float64 posterior variance against the dense one, of its tolerance",
         float(((s4 - dv).abs() / (1e-4 * dv.abs() + 1e-8)).max()), 1.0)
    gc.collect()
    torch.cuda.empty_cache()
    gp["s"], gp["s_samples"] = synced_s(post, reps=1)
    gp["peak_bytes"] = _own_peak(post)
    gp["profile"] = _traced_exact("grid_posterior_1m", post, kernels_all)
    grid["posterior"] = gp
    exps_per_s, mhz = sfu_exps_per_s()
    xq = torch.linspace(0.0, 100.0, 4096, device="cuda")[:, None]
    rows = {"gram_matvec_grid_mean": _k3_item9_times(
        xq, axis[:, None], torch.randn(n, 1, generator=gen(2), device="cuda"),
        "grid mean 4096 x 2^20 p=1", exps_per_s, block=1024),
        "gram_grid_var": k1_sparse_times(axis[:, None],
                                         torch.linspace(0.0, 100.0, 512, device="cuda")[:, None])}
    rows["gram_matvec_grid_mean"]["sm_clock_mhz"] = mhz
    part("grid_n1048576", **grid)
    del axis, y, mean, var
    gc.collect()
    torch.cuda.empty_cache()

    # (b) The Kronecker grid, 1024 x 1024.
    ax1, ax2, yk, pk = E.kron_1m_inputs()
    kstep = lambda: E.kron_nlml_1m_step(ax1, ax2, yk, pk)  # noqa: E731
    (kv, kg), counts = _launched(kstep)
    path["kron"] = counts
    check(counts["gram"] == 2 and counts["gram_bwd"] == 2, f"the Kronecker step's launches {counts}")
    k64 = E.kron_nlml_1m_step(ax1.double(), ax2.double(), yk.double(),
                              {k: t.double() for k, t in pk.items()})
    kr = {"n": [1024, 1024], "launches": counts, "value": float(kv), "value_f64": float(k64[0]),
          "value_rel": _rel(kv, k64[0]), "grad_f64": {k: float(t) for k, t in k64[1].items()}}
    kr["grad_rel"], kr["grad_rel_each"] = _grad_rel(kg, k64[1])
    gate("Kronecker value against float64", kr["value_rel"], 2 * JAX_F32_ITEM9["kron_value_rel"])
    gate("Kronecker gradient against float64", kr["grad_rel"], 2 * JAX_F32_ITEM9["kron_grad_rel"])
    kr["value_grad_s"], kr["value_grad_s_samples"] = synced_s(kstep)
    kr["value_grad_peak_bytes"] = _own_peak(kstep)
    kr["profile"] = _traced_exact("kron_1m_value_grad", kstep, kernels_all)
    K = KR.kron_gram_factors(E.kron_kernels(pk), (ax1, ax2))[0]
    T = yk.reshape(1024, 1024)
    kr["eigh_1024_ms"] = time_ms(lambda: torch.linalg.eigh(K), reps=5)
    kr["mode_product_1024_ms"] = time_ms(lambda: KR._mode_apply(K, T, 1), reps=5)
    (km, kvar), counts = _launched(lambda: E.kron_posterior_1m(ax1, ax2, yk, pk))
    check(bool(torch.isfinite(km).all()) and bool((kvar >= 0).all()),
          "the Kronecker posterior is not finite")
    kr["posterior_4096"] = {"launches": counts,
                            "ms": time_ms(lambda: E.kron_posterior_1m(ax1, ax2, yk, pk), reps=3)}
    xs = (ax1 / torch.exp(pk["log_ell1"]))[:, None].contiguous()
    rows["gram_kron"] = k1_sparse_times(xs, xs.clone())
    rows["gram_bwd_kron"] = k1_bwd_sparse_times(xs, xs.clone())
    kr["gram_factor_ms"] = rows["gram_kron"]["ms"]
    part("kron_1024x1024", **kr)
    del K, T
    gc.collect()
    torch.cuda.empty_cache()

    # (c) The compensated operator.
    part("slice_products", **_slice_exactness())
    x, yc, v = E.compensated_262k_inputs()
    mv8 = lambda: E.compensated_matvec8_262k(x, v)  # noqa: E731
    got, counts = _launched(mv8)
    path["compensated"] = counts
    check(counts["gram_matvec_dmma"] == 1 and counts["gram"] == 0,
          f"the compensated matvec's launches {counts}: one float64 K3")
    eq = lambda d2: torch.exp(-0.5 * d2)  # noqa: E731
    ref = _f64_direct_rows(x, v, 8192, E.SMALL_NOISE, eq)
    comp = {"n": x.shape[0], "p": 8, "launches": counts,
            "rel_err_8192_rows": max_err(got[:8192], ref) / float(ref.abs().max())}
    gate("compensated matvec8 (K3 float64 route) against float64", comp["rel_err_8192_rows"],
         3e-7)
    comp["ms"] = time_ms(mv8, reps=1, warmup=1)
    comp["peak_bytes"] = _own_peak(mv8)
    comp["profile"] = _traced_exact("compensated_matvec8_262k", mv8, kernels_all)
    del got, ref
    x65, v65 = x[::4].contiguous(), v[::4].contiguous()
    k2 = EQ() + 0.5 * Matern32()
    r3 = math.sqrt(3.0)
    k2_gram = lambda d2: (torch.exp(-0.5 * d2)  # noqa: E731
                          + 0.5 * (1 + r3 * d2.sqrt()) * torch.exp(-r3 * d2.sqrt()))
    with torch.no_grad():
        df = lambda: it.kernel_matvec(k2, x65, v65, noise=E.SMALL_NOISE, block=8192,  # noqa: E731
                                      compensated=True)
        got, counts = _launched(df)
        ref = _f64_direct_rows(x65, v65, 8192, E.SMALL_NOISE, k2_gram)
        dfr = {"n": x65.shape[0], "p": 8, "kernel": "EQ() + 0.5 * Matern32()",
               "launches": counts,
               "rel_err_8192_rows": max_err(got[:8192], ref) / float(ref.abs().max())}
        gate("compensated matvec (double-float tiles) against float64",
             dfr["rel_err_8192_rows"], 3e-7)
        dfr["ms"] = time_ms(df, reps=1, warmup=0)
        dfr["peak_bytes"] = _own_peak(df)
        del got, ref
    comp["double_float_route_n65536"] = dfr
    t0 = time.perf_counter()
    alpha, info, res = E.smallnoise_weights_262k(x, yc, gen(1))
    torch.cuda.synchronize()
    sn = {"n": x.shape[0], "s": time.perf_counter() - t0, "cg_iters": info["iters"],
          "cg_rel_residual": float(info["rel_residual"]), "true_residual": float(res)}
    gate("small-noise weights' true residual (compensated operator)", sn["true_residual"], 1e-4)
    with torch.no_grad():
        state = it.eig_precond_state(lambda p_: EQ(), None, x, 256, gen(1), block=8192)
        plain, pinfo = it.posterior_weights(lambda p_: EQ(), None, x, yc, E.SMALL_NOISE,
                                            cg_tol=1e-5, max_cg_iters=40, precond_state=state,
                                            block=8192, compensated=False)
        pres = yc - it.kernel_matvec(EQ(), x, plain, noise=E.SMALL_NOISE, block=8192,
                                     compensated=True)
    sn["plain_f32"] = {"cg_iters": pinfo["iters"],
                       "true_residual": float(torch.linalg.vector_norm(pres)
                                              / torch.linalg.vector_norm(yc))}
    comp["smallnoise_weights"] = sn
    del alpha, state, plain, pres
    xs = torch.sort(torch.rand(512, generator=gen(6), device="cuda"))[0] * 10
    from stheno_torch import pathwise_sampler

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        fn, _, pinfo = pathwise_sampler(EQ(), xs, torch.sin(xs), 1e-5, gen(), num_samples=4,
                                        num_features=2048, solver="cg", cg_tol=1e-8,
                                        max_cg_iters=600, precond_rank=128, compensated=True,
                                        return_info=True)
    comp["pathwise_n512"] = {"cg_iters": pinfo["iters"],
                             "cg_rel_residual": float(pinfo["rel_residual"]),
                             "interp_max_abs_err": max_err(fn(xs), torch.sin(xs)[:, None]
                                                           .expand(512, 4))}
    gate("compensated pathwise draws interpolate y (n=512, noise 1e-5)",
         comp["pathwise_n512"]["interp_max_abs_err"], 0.05)
    x64 = x.double()[:, None]
    rows["gram_matvec_compensated"] = _k3_item9_times(
        x64, x64, v.double(), "compensated 262,144^2 p=8 f64", exps_per_s)
    part("compensated", **comp)
    gc.collect()
    torch.cuda.empty_cache()

    # (d) The tile options.
    xi, yi, pi = E.iterative_inputs()
    v17 = torch.randn(xi.shape[0], 17, generator=gen(3), device="cuda")
    kt = E.iterative_kernel(pi)
    kb = EQ().stretch(torch.exp(pi["log_ell"]))
    tiles = {}
    with torch.no_grad():
        bf = lambda: it.kernel_matvec(kb, xi, v17, block=8192,  # noqa: E731
                                      tile_dtype=torch.bfloat16)
        got, counts = _launched(bf)
        path["bf16_tiles"] = counts
        check(counts["gram"] == 32, f"the bfloat16-tile matvec's launches {counts}")
        ref, tol = _bf16_tile_plain(xi, v17, pi)
        f32 = it.kernel_matvec(kb, xi, v17, block=8192)
        over = float(((got[:2048] - ref).abs() / tol).max())
        tiles["bf16_matvec"] = {"n": xi.shape[0], "p": 17, "launches": counts,
                                "max_abs_err_vs_plain_2048_rows": max_err(got[:2048], ref),
                                "of_tol_vs_plain": over,
                                "rel_err_vs_float32": max_err(got, f32)
                                / float(f32.abs().max()),
                                "ms": time_ms(bf, reps=3, warmup=1),
                                "float32_ms": time_ms(
                                    lambda: it.kernel_matvec(kb, xi, v17, block=8192), reps=3,
                                    warmup=1)}
        gate("bfloat16-tile matvec against its plain version (2048 rows), of its tolerance",
             over, 1.0)
        gate("bfloat16-tile matvec against float32", tiles["bf16_matvec"]["rel_err_vs_float32"],
             2.0**-6)
        tiles["bf16_matvec"]["profile"] = _traced_exact("bf16_tile_matvec_262k", bf, kernels_all)
        del got, ref, f32
    rows["gram_bf16_tiles"] = _k1_bf16_tile_times(
        (xi[:8192] / torch.exp(pi["log_ell"]))[:, None].contiguous(),
        (xi / torch.exp(pi["log_ell"]))[:, None].contiguous())
    cache_bf = lambda: E.serving_variance_cache(xi, pi, gen(11),  # noqa: E731
                                                basis_tile_dtype=torch.bfloat16)
    c16 = cache_bf()
    c32 = E.serving_variance_cache(xi, pi, gen(11))
    xv = torch.linspace(0.0, 10.0, 2048, device="cuda")
    agree = max_err(E.serving_var(xi, pi, c16, xv), E.serving_var(xi, pi, c32, xv))
    tiles["bf16_basis_cache"] = {"rank": 256, "agree_max_abs": agree}
    gate("bfloat16-basis cache's variance against the float32 basis's", agree, 5e-4)
    del c16, c32
    tiles["bf16_basis_cache"]["build_s"], tiles["bf16_basis_cache"]["build_s_samples"] = \
        synced_s(cache_bf, reps=1)
    tiles["bf16_basis_cache"]["float32_build_s"] = synced_s(
        lambda: E.serving_variance_cache(xi, pi, gen(11)), reps=1)[0]
    x65 = xi[::4].contiguous()
    v8 = torch.randn(x65.shape[0], 8, generator=gen(4), device="cuda")
    with torch.no_grad():
        sym = it.kernel_matvec(kt, x65, v8, block=8192, symmetric=True)
        row = it.kernel_matvec(kt, x65, v8, block=8192)
        scale = it.kernel_matvec(kt, x65, v8.abs(), block=8192)
        rel = float(((sym - row).abs() / scale.clamp_min(1e-30)).max())
        tiles["symmetric_n65536"] = {
            "rel_err_of_scale": rel, "rtol": _gmv_rtol(x65.shape[0], torch.float32),
            "ms": time_ms(lambda: it.kernel_matvec(kt, x65, v8, block=8192, symmetric=True),
                          reps=3, warmup=1),
            "row_sweep_ms": time_ms(lambda: it.kernel_matvec(kt, x65, v8, block=8192), reps=3,
                                    warmup=1)}
    gate("symmetric sweep against the row sweep (N=65,536)", rel,
         _gmv_rtol(x65.shape[0], torch.float32))
    part("tile_options", **tiles)
    part("kernels", **rows)
    emit({"phase": "item9_path_gates", "nvidia_smi": smi, "gates": gates,
          "path_launches": path})
    launches = {
        "gram_kron": path["kron"]["gram"], "gram_bwd_kron": path["kron"]["gram_bwd"],
        "gram_grid_var": path["grid_posterior"]["gram"],
        "gram_matvec_grid_mean": path["grid_posterior"]["gram_matvec_ffma"],
        "gram_matvec_compensated": path["compensated"]["gram_matvec_dmma"],
        "gram_bf16_tiles": path["bf16_tiles"]["gram"],
    }
    return [
        {"name": name, "route": "cuda", "source": KERNELS[name]["source"],
         "replaces": KERNELS[name]["replaces"], "launches": launches[name],
         **{k: rows[name][k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                       "library_ms")}}
        for name in launches
    ]


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
    run("opt_adam", phase_opt_adam)
    run("opt_nuts", phase_opt_nuts)
    sparse = run("sparse_path", phase_sparse_path, smi)
    idle = [k["name"] for k in sparse if k["launches"] < 1]
    check(not idle, f"kernels that the sparse path never launched: {idle}")
    kernels.extend(sparse)
    dsl = run("dsl_path", phase_dsl_path, smi)
    idle = [k["name"] for k in dsl if k["launches"] < 1]
    check(not idle, f"kernels that the DSL paths never launched: {idle}")
    kernels.extend(dsl)
    run("item8_path", phase_item8_path, smi)
    item9 = run("item9_path", phase_item9_path, smi)
    idle = [k["name"] for k in item9 if k["launches"] < 1]
    check(not idle, f"kernels that item 9's paths never launched: {idle}")
    kernels.extend(item9)
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
