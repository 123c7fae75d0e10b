"""Item 9's measurements on the card that ``chip_smoke.py`` does not make:
the two routes of the compensated (small-noise) operator timed beside each
other, and the small-noise solve at full N.

    python3 scripts/torch_item9.py [routes] [smallnoise [N]] [slices]

Without arguments: ``routes slices``. Each part prints one JSON line with
the card's name and power limit (``nvidia-smi``).

``routes``: ``bench.py:bench_compensated_262k``'s matvec (N=262,144,
sorted uniform x on [0, 10], EQ, noise 0.01, 8 right-hand sides, row
blocks of 8192) through K3's float64 route on the promoted inputs (what
``kernel_matvec(compensated=True)`` runs for a fused form) and through the
JAX package's double-float tiles (``matvec._compensated_tiles``: the
double-float EQ tile per block and column chunk of 32,768, then the
Ozaki-split product): each one call after a warm call (the double-float
route once), CUDA events, its own peak memory, and its error against a
float64 direct-difference reference on 8192 of the rows, over the largest
entry. Then the eig preconditioner's compensated application at rank 256
on the same N (``compensated.f64_scaled_apply`` against
``compensated.compensated_scaled_apply``, 1 and 8 right-hand sides),
median of 20 after 3 warm-ups, and their agreement.

``smallnoise [N]``: ``entry.smallnoise_weights_262k`` at N (default
262,144): the rank-256 state, the compensated whitened CG at noise 0.01,
tol 1e-5, at most 40 iterations, and the true residual through the
compensated operator; the seconds of the build and of the solve, and the
plain float32 path's true residual at the same settings (no gate).

``slices``: the exactness of the Ozaki split's slice products on the
card: products of 512-wide slices at the largest magnitudes
``split_two_slices`` allows (every entry 128 times its scale, the sums at
2^23), held bitwise against float64, by the route the code takes (float32
storage, full-float32 products) and by the alternatives (bfloat16 storage
with ``torch.matmul``, and ``aten::bmm.dtype`` with a float32 output
where this torch has it).
"""

import json
import os
import statistics
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

N = 262_144


def smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def emit(obj):
    print(json.dumps({"nvidia_smi": smi(), **obj}), flush=True)


def event_ms(fn, reps=1, warmup=1):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out)


def own_peak(fn):
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


def f64_reference(x, v, rows, noise):
    """``(K + noise I) v`` on ``rows`` by direct differencing in float64."""
    xd, vd = x.double(), v.double()
    out = []
    for r0 in range(0, rows, 512):
        d = xd[r0:r0 + 512, None] - xd[None, :]
        out.append(torch.exp(-0.5 * d * d) @ vd + noise * vd[r0:r0 + 512])
    return torch.cat(out)


def routes():
    from stheno_torch import EQ
    from stheno_torch import entry as E
    from stheno_torch.iterative import compensated as C
    from stheno_torch.iterative import eig_precond_state
    from stheno_torch.iterative import matvec as M

    x, y, v = E.compensated_262k_inputs()
    ref = f64_reference(x, v, 8192, E.SMALL_NOISE)
    den = float(ref.abs().max())
    out = {"n": x.shape[0], "p": v.shape[1], "block": 8192}
    with torch.no_grad():
        k3 = lambda: E.compensated_matvec8_262k(x, v)  # noqa: E731
        tiles = lambda: M._compensated_tiles(EQ(), x[:, None], x[:, None], v,  # noqa: E731
                                             E.SMALL_NOISE, 8192, 32768)
        got = k3()
        out["k3_f64"] = {"ms": event_ms(k3, reps=3), "peak_bytes": own_peak(k3),
                         "rel_err_8192_rows": float((got[:8192].double() - ref).abs().max()) / den}
        t0 = time.perf_counter()
        got = tiles()
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        out["double_float_tiles"] = {
            "ms": event_ms(tiles, reps=1, warmup=0), "first_call_s": first_s,
            "peak_bytes": own_peak(tiles),
            "rel_err_8192_rows": float((got[:8192].double() - ref).abs().max()) / den}
        out["tiles_over_k3"] = out["double_float_tiles"]["ms"] / out["k3_f64"]["ms"]
        del got
        gen = torch.Generator(device="cuda").manual_seed(1)
        U, lam = eig_precond_state(lambda p: EQ(), None, x, 256, gen, block=8192)
        noise = torch.tensor(E.SMALL_NOISE, device="cuda")
        coeff = 1.0 / torch.sqrt(lam + noise) - 1.0 / torch.sqrt(noise)
        base = 1.0 / torch.sqrt(noise)
        apply = {}
        for p in (1, 8):
            w = v[:, :p]
            a = C.f64_scaled_apply(U, coeff, base, w)
            b = C.compensated_scaled_apply(U, coeff, base, w)
            apply[f"p{p}"] = {
                "f64_ms": event_ms(lambda: C.f64_scaled_apply(U, coeff, base, w), 20, 3),
                "faithful_ms": event_ms(lambda: C.compensated_scaled_apply(U, coeff, base, w),
                                        20, 3),
                "max_rel_diff": float((a.double() - b.double()).abs().max()
                                      / b.double().abs().max()),
            }
        out["scaled_apply_rank256"] = apply
    emit({"part": "compensated_routes", **out})


def smallnoise(n):
    from stheno_torch import EQ
    from stheno_torch import entry as E
    from stheno_torch import iterative as it

    x, y, _ = E.compensated_262k_inputs(n)
    gen = lambda: torch.Generator(device="cuda").manual_seed(1)  # noqa: E731
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    alpha, info, res = E.smallnoise_weights_262k(x, y, gen())
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    with torch.no_grad():
        state = it.eig_precond_state(lambda p: EQ(), None, x, 256, gen(), block=8192)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        it.posterior_weights(lambda p: EQ(), None, x, y, E.SMALL_NOISE, cg_tol=1e-5,
                             max_cg_iters=40, precond_state=state, block=8192, compensated=True)
        torch.cuda.synchronize()
        solve_s = time.perf_counter() - t1
        plain, pinfo = it.posterior_weights(lambda p: EQ(), None, x, y, E.SMALL_NOISE,
                                            cg_tol=1e-5, max_cg_iters=40, precond_state=state,
                                            block=8192, compensated=False)
        pres = y - it.kernel_matvec(EQ(), x, plain, noise=E.SMALL_NOISE, block=8192,
                                    compensated=True)
        pres = float(torch.linalg.vector_norm(pres) / torch.linalg.vector_norm(y))
    emit({"part": "smallnoise_weights", "n": n, "seconds_with_state": total,
          "solve_s": solve_s, "cg_iters": info["iters"],
          "cg_rel_residual": float(info["rel_residual"]), "true_residual": float(res),
          "gate": 1e-4, "passes": float(res) <= 1e-4,
          "plain_cg_iters": pinfo["iters"], "plain_true_residual": pres})


def slices():
    from stheno_torch.iterative import compensated as C

    gen = torch.Generator(device="cuda").manual_seed(0)
    m, C_, p = 256, 8192, 8
    ints = lambda shape: torch.randint(-128, 129, shape, generator=gen,  # noqa: E731
                                       device="cuda").float()
    A, B = ints((m, C_)), ints((C_, p))
    A[:8] = 128.0  # Rows and columns at the largest magnitude: sums of 2^23.
    B[:, :4] = 128.0
    A[8:16] = -128.0
    scale_a = torch.ldexp(torch.ones(m, 1, device="cuda"),
                          torch.randint(-40, 40, (m, 1), generator=gen, device="cuda"))
    scale_b = torch.ldexp(torch.ones(1, p, device="cuda"),
                          torch.randint(-40, 40, (1, p), generator=gen, device="cuda"))
    A_sl, B_sl = A * scale_a, B * scale_b
    exact_parts = torch.bmm(A_sl.double().reshape(m, -1, 512).transpose(0, 1),
                            B_sl.double().reshape(-1, 512, p))
    out = {"shape": [m, C_, p], "sub": 512, "largest_partial_sum": 2.0**23}
    parts = torch.bmm(A_sl.reshape(m, -1, 512).transpose(0, 1), B_sl.reshape(-1, 512, p))
    out["float32_storage_parts_bitwise"] = bool(torch.equal(parts.double(), exact_parts))
    hi, lo = C._exact_slice_matmul(A_sl, B_sl, 512)
    out["float32_storage_pair_exact"] = bool(torch.equal(
        hi.double() + lo.double(), exact_parts.sum(0)))
    bf = torch.bmm(A_sl.bfloat16().reshape(m, -1, 512).transpose(0, 1),
                   B_sl.bfloat16().reshape(-1, 512, p))
    out["bfloat16_matmul_dtype"] = str(bf.dtype)
    out["bfloat16_matmul_parts_bitwise"] = bool(torch.equal(bf.double(), exact_parts))
    try:
        od = torch.ops.aten.bmm.dtype(A_sl.bfloat16().reshape(m, -1, 512).transpose(0, 1),
                                      B_sl.bfloat16().reshape(-1, 512, p), torch.float32)
        out["bmm_dtype_float32_parts_bitwise"] = bool(torch.equal(od.double(), exact_parts))
    except (AttributeError, RuntimeError) as e:
        out["bmm_dtype_float32_parts_bitwise"] = f"not available: {type(e).__name__}: {e}"[:200]
    emit({"part": "slice_products", **out})
    if not (out["float32_storage_parts_bitwise"] and out["float32_storage_pair_exact"]):
        raise SystemExit("the float32 slice products are not exact on this card")


def main(argv):
    from stheno_torch import config

    if not torch.cuda.is_available():
        raise SystemExit("torch_item9.py needs a GPU")
    argv = argv or ["routes", "slices"]
    with config.matmul_precision_ctx():
        i = 0
        while i < len(argv):
            if argv[i] == "routes":
                routes()
            elif argv[i] == "slices":
                slices()
            elif argv[i] == "smallnoise":
                n = N
                if i + 1 < len(argv) and argv[i + 1].isdigit():
                    n = int(argv[i + 1])
                    i += 1
                smallnoise(n)
            else:
                raise SystemExit(f"unknown part {argv[i]!r}")
            i += 1


if __name__ == "__main__":
    main(sys.argv[1:])
