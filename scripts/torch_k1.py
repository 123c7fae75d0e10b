"""K1 (the fused Gram of stheno_torch), its backward and the backward's
tangent kernel on one GPU: checks against the plain versions, times of two
checkouts side by side, what the compiler made of the kernels, and where
chip_smoke.py's device memory goes.

    python3 scripts/torch_k1.py check
    python3 scripts/torch_k1.py times [--root DIR]
    python3 scripts/torch_k1.py jvb [--root DIR] [--check] [--library]
    python3 scripts/torch_k1.py bwd [--root DIR]
    python3 scripts/torch_k1.py ptxas [--out DIR]
    python3 scripts/torch_k1.py mem [--root DIR]

``check`` builds the kernels and runs ``chip_smoke.py``'s phase ``gram``
alone (the forward in three dtypes, six kinds and depths 1, 2, 3, 8, 9,
17 against its plain version; the backward against its plain version,
twice with equal bits).

``times`` imports ``stheno_torch`` from the checkout at ``--root``
(default: this one) and times it with this checkout's ``chip_smoke.py``
(``k1_forward_times``, ``k1_backward_times``), so that two checkouts can
be compared in one run on one card. One JSON line: the card's
``nvidia-smi`` name and power limit; K1's forward (eq) at 2000x2 by
2000x2 and 8192x2 by 8192x2 in float32, float64 and bfloat16 (a dtype the
checkout refuses is marked so), and its backward at N=2000 (eq and
matern32), each with chip_smoke's numbers and the device kernels of one
call with their profiled device times (``trace``); then the N=2000
value+grad step's device launches, busy time and kernels by launch count.

``jvb`` imports ``stheno_torch`` from the checkout at ``--root`` and
times the backward's tangent kernel (``ops/gram_bwd_jvp.py``) with this
checkout's ``chip_smoke.bwd_jvp_times`` at its ``BWD_JVP_TIMED`` cases (the
flagship's 2000 x 2000, x as y, eq: B = 3 and 1 in float32, B = 3 in
float64), each with its device kernels of one call and their profiled
times (``trace``); with ``--library`` also its plain version and the
PyTorch yardstick. One JSON line, with the build's seconds. ``--check``
first runs ``chip_smoke._bwd_jvp_kernel_checks`` (every kind, both dtypes,
``BWD_JVP_SHAPES``) against the checkout's plain version. Run it for two
checkouts in turns in one call to compare them.

``bwd`` imports ``stheno_torch`` from the checkout at ``--root`` and
times K1's backward (``ops/gram_bwd.py:gram_bwd``, called directly) at
every shape where the paths launch it (``BWD_SHAPES``: 2000x2 at x is y,
eq and matern32 in float32, eq in float64 and bfloat16; rq at 2000x1, x
is y; 512x1 by 10^6x1; 16,384x1 at x is y; the 8192x1 by 8192x1 tile set;
the 1024x1 Kronecker factor, both roles; 512x1 by 4096x1), each with its
CUDA-event and device times per call, its device kernels of one call and
their profiled times (``trace``; the sum, a programmatic dependent launch,
is recorded from its early start, so its time includes its wait for the
sweep), its bound (inputs and cotangent read
once, gradients written once, at 3.35 TB/s; 20 flops an entry) and
``autograd.grad`` through the PyTorch expression of the same Gram
(``exp(-0.5 cdist^2)``; matern32's and rq's forms), which the port never
calls. Then three records of the paths that launch it: the N=2000
value+grad step's device busy time and launches (traced), the captured
Adam step's replay device time per step (50 replays traced) and the
N=10^6 sparse value+grad (CUDA events, median of 5). One JSON line with the
card's ``nvidia-smi`` name and power limit and the build's seconds. Run it
for two checkouts in turns in one call to compare them.

``mem`` takes the peak device memory of one amortised N=262,144 step
apart. For the checkout at ``--root`` (default: this one), in a fresh
process: the step's own peak (``max_memory_allocated`` less what was
allocated when the peak was reset). For this checkout, also within
``chip_smoke.py``'s phases, stopped where phase ``iterative_times`` would
start: what is allocated there, the step's own peak, and the live blocks
grouped by the innermost frame of this repository that allocated them
(``torch.cuda.memory._record_memory_history``).

``ptxas`` compiles ``gram.cu``, ``gram_bwd.cu``, ``gram_bwd_f64.cu``,
``gram_bwd_jvp.cu`` and ``gram_bwd_jvp_f64.cu`` with the build's flags and
``-Xptxas -v`` (written to ``DIR/ptxas_<source>.txt``) and prints the
registers and spills of every kernel, demangled where ``cu++filt`` is
there, and each source's compile seconds; for K1's backward's instances
on the paths (eq, depths 1 and 2) and the backward's tangent kernel's on
the Hessian's (eq, depth 1, B = 1 and 3) also the instructions of their
step loops (``cuobjdump -sass``, written to ``DIR/sass_*.txt``) per entry
and by unit: one JSON line.
"""

import argparse
import gc
import importlib.util
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import torch

from torch_k3 import _count, _loop_body, _ptxas, _smi

REPO = Path(__file__).resolve().parents[1]


def _chip_smoke():
    """This checkout's ``chip_smoke.py``, whichever ``stheno_torch`` is on
    the path."""
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _kernels(cs, fn):
    """``{kernel: [launches, device_ms]}`` of one call of ``fn``."""
    by_name = cs.trace("call", fn)["by_name"]
    return {k: [c, us / 1e3] for k, (c, us) in by_name.items()}


def times(root):
    sys.path.insert(0, str(Path(root).resolve()))
    cs = _chip_smoke()
    from stheno_torch import config
    from stheno_torch import entry as E
    from stheno_torch.ops import gram as K1

    try:
        from stheno_torch.ops.gram_bwd import gram_bwd_plain as plain
    except ImportError:  # a checkout from before K1's backward kernel
        plain = None
    out = {"nvidia_smi": _smi(), "root": str(root), "forward": [], "backward": []}
    with config.matmul_precision_ctx():
        for n in (2000, 8192):
            for dtype in (torch.float32, torch.float64, torch.bfloat16):
                x = cs._warped(n).to(dtype)
                try:
                    K1.gram("eq", x, x)
                except TypeError as e:
                    out["forward"].append({"shape": [n, n, 2], "dtype": str(dtype),
                                           "taken": False, "error": str(e)})
                    continue
                rec = cs.k1_forward_times(K1, n, dtype)
                rec["kernels"] = _kernels(cs, lambda x=x: K1.gram("eq", x, x))
                out["forward"].append(rec)
        gbar = cs.k1_cotangent(2000)
        for kind in ("eq", "matern32"):
            rec = cs.k1_backward_times(K1, kind, gbar, plain)
            rec["kernels"] = _kernels(cs, cs.k1_backward_call(K1, kind, gbar))
            out["backward"].append(rec)

        xb, yb, ell = E.n2000_inputs()
        step = lambda: E.nlml_n2000(xb, yb, ell, grad=True)  # noqa: E731
        for _ in range(3):
            step()
        t = cs.trace("n2000_value_grad", step)
        span_us, busy_us, by_name = t["span_us"], t["busy_us"], t["by_name"]
        out["n2000_value_grad"] = {
            "span_ms": span_us / 1e3,
            "device_busy_ms": busy_us / 1e3,
            "device_launches": sum(c for c, _ in by_name.values()),
            "kernels_by_launches": {k: [c, us / 1e3] for k, (c, us) in
                                    sorted(by_name.items(), key=lambda kv: -kv[1][0])},
        }
    print(json.dumps(out), flush=True)


def jvb(root, run_check, library):
    sys.path.insert(0, str(Path(root).resolve()))
    cs = _chip_smoke()
    from stheno_torch import config
    from stheno_torch.ops import _build
    from stheno_torch.ops import gram_bwd_jvp as KBJ

    t0 = time.perf_counter()
    _build.library()
    out = {"nvidia_smi": _smi(), "root": str(root), "build_s": time.perf_counter() - t0}
    with config.matmul_precision_ctx():
        if run_check:
            t0 = time.perf_counter()
            err32, cases = cs._bwd_jvp_kernel_checks()
            worst = max(cases, key=lambda c: max(v for k, v in c.items() if k.endswith("of_tol")))
            out["check"] = {"cases": len(cases), "err32": err32, "worst": worst,
                            "seconds": time.perf_counter() - t0}
        out["cases"] = []
        for B, dtype in cs.BWD_JVP_TIMED:
            out["cases"].append(cs.bwd_jvp_times(KBJ, B, dtype, library=library,
                                                 traced=lambda fn: _kernels(cs, fn)))
    print(json.dumps(out), flush=True)


#: K1's backward's shapes on the paths (PERF.md §6): name, kind, n, m, d,
#: storage dtype, x is y, calls timed back to back.
BWD_SHAPES = (
    ("n2000 eq", "eq", 2000, 2000, 2, torch.float32, True, 20),
    ("n2000 matern32", "matern32", 2000, 2000, 2, torch.float32, True, 20),
    ("n2000 eq float64", "eq", 2000, 2000, 2, torch.float64, True, 20),
    ("n2000 eq bfloat16", "eq", 2000, 2000, 2, torch.bfloat16, True, 20),
    ("dsl rq 2000x1", "rq", 2000, 2000, 1, torch.float32, True, 20),
    ("sparse 512x1e6", "eq", 512, 1_000_000, 1, torch.float32, False, 3),
    ("dist 16384", "eq", 16_384, 16_384, 1, torch.float32, True, 3),
    ("tiles 8192", "eq", 8192, 8192, 1, torch.float32, False, 5),
    ("kron 1024", "eq", 1024, 1024, 1, torch.float32, False, 20),
    ("svgp 512x4096", "eq", 512, 4096, 1, torch.float32, False, 20),
)


def _bwd_inputs(cs, n, m, d, dtype, same):
    """Seeded inputs of one shape: the main path's warped 2000x2 points, or
    points on [0, 10] at depth 1, and a standard normal cotangent."""
    gen = torch.Generator(device="cuda").manual_seed(31)
    if d == 2:
        x = cs._warped(n)
        y = x if same else cs._warped(m)
    else:
        x = torch.rand(n, 1, generator=gen, device="cuda") * 10
        y = x if same else torch.rand(m, 1, generator=gen, device="cuda") * 10
    gbar = torch.randn(n, m, generator=gen, device="cuda")
    return x.to(dtype), y.to(dtype), gbar.to(dtype)


def _library_bwd(kind, x, y, gbar, same, alpha):
    """``autograd.grad`` of the Gram written in PyTorch (``cdist``), with
    ``gbar``; None where ``cdist`` refuses the dtype."""
    r3 = math.sqrt(3.0)
    forms = {"eq": lambda r: torch.exp(-0.5 * r.square()),
             "matern32": lambda r: (1 + r3 * r) * torch.exp(-r3 * r),
             "rq": lambda r: (1 + r.square() / (2 * alpha)) ** -alpha}
    xl = x.clone().requires_grad_(True)
    yl = xl if same else y.clone().requires_grad_(True)
    try:
        K = forms[kind](torch.cdist(xl, yl))
    except RuntimeError:
        return None
    wrt = (xl,) if same else (xl, yl)
    return lambda: torch.autograd.grad(K, wrt, gbar, retain_graph=True)


def _bwd_shape_times(cs, KB, name, kind, n, m, d, dtype, same, inner):
    x, y, gbar = _bwd_inputs(cs, n, m, d, dtype, same)
    alpha = 1.3
    call = lambda: KB.gram_bwd(kind, x, y, gbar, alpha, same=same)  # noqa: E731
    item = torch.empty((), dtype=dtype).element_size()
    grads = (n if same else n + m) * d
    byts = (n * d + (0 if same else m * d) + n * m) * item + grads * 4
    b_ms, b_by = cs.bound(byts, 20 * n * m, torch.float64 if dtype == torch.float64
                          else torch.float32)
    lib = _library_bwd(kind, x, y, gbar, same, alpha)
    rec = {"case": name, "kind": kind, "shape": [n, m, d], "dtype": str(dtype), "x_is_y": same,
           "ms": cs.time_ms(call, inner=inner),
           "device_ms": cs.device_ms_per_call(call, inner=inner),
           "kernels": _kernels(cs, call),
           "library_ms": None if lib is None else cs.time_ms(lib, reps=5),
           "bound_ms": b_ms, "bound_by": b_by}
    try:
        rec["launch_shape"] = list(KB.launch_shape(n, m, d, dtype, same))
    except TypeError:  # a checkout whose shape takes no fold
        rec["launch_shape"] = list(KB.launch_shape(n, m, d, dtype))
    del x, y, gbar, lib
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def _bwd_paths(cs, E):
    """The paths' records: the N=2000 value+grad step traced, 50 captured
    Adam replays traced, the N=10^6 sparse value+grad timed."""
    out = {}
    xb, yb, ell = E.n2000_inputs()
    step = lambda: E.nlml_n2000(xb, yb, ell, grad=True)  # noqa: E731
    for _ in range(3):
        step()
    t = cs.trace("n2000_value_grad", step)
    out["n2000_value_grad"] = {
        "span_ms": t["span_us"] / 1e3, "device_busy_ms": t["busy_us"] / 1e3,
        "device_launches": sum(c for c, _ in t["by_name"].values()),
        "gram_bwd": _named(t["by_name"], "gram_bwd_kernel"),
        "gmv_reduce": _named(t["by_name"], "gmv_reduce")}
    reps = 50
    adam = E.adam_n2000()
    adam.run(2 * reps)
    t = cs.trace("adam_replays", lambda: adam.run(reps))
    out["adam_replay"] = {
        "steps": reps, "device_busy_ms_per_step": t["busy_us"] / reps / 1e3,
        "device_busy_share": t["busy_us"] / t["span_us"],
        "device_launches_per_step": sum(c for c, _ in t["by_name"].values()) / reps,
        "gram_bwd": _named(t["by_name"], "gram_bwd_kernel")}
    del adam
    x, y, z, ell = E.sparse_1m_inputs()
    out["sparse_1m_value_grad_ms"] = cs.time_ms(lambda: E.sparse_elbo(x, y, z, ell, grad=True),
                                                reps=5, warmup=2)
    del x, y, z, ell
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _named(by_name, kernel):
    """``[launches, device_ms]`` of one kernel in a trace."""
    c, us = by_name.get(kernel, (0, 0.0))
    return [c, us / 1e3]


def bwd(root):
    sys.path.insert(0, str(Path(root).resolve()))
    cs = _chip_smoke()
    from stheno_torch import config
    from stheno_torch import entry as E
    from stheno_torch.ops import _build
    from stheno_torch.ops import gram_bwd as KB

    t0 = time.perf_counter()
    _build.library()
    out = {"nvidia_smi": _smi(), "root": str(root), "build_s": time.perf_counter() - t0,
           "shapes": []}
    with config.matmul_precision_ctx():
        for case in BWD_SHAPES:
            out["shapes"].append(_bwd_shape_times(cs, KB, *case))
        out["paths"] = _bwd_paths(cs, E)
    print(json.dumps(out), flush=True)


def check():
    sys.path.insert(0, str(REPO))
    cs = _chip_smoke()
    from stheno_torch import config
    from stheno_torch.ops import _build

    t0 = time.perf_counter()
    _build.library()
    print(json.dumps({"nvidia_smi": _smi(), "build_s": time.perf_counter() - t0}), flush=True)
    with config.matmul_precision_ctx():
        t0 = time.perf_counter()
        errs = cs.phase_gram()
    print(json.dumps({"gram_path_err": errs[0], "gram_bwd_path_err": errs[1],
                      "seconds": time.perf_counter() - t0}), flush=True)


def _own_peak(E, x, y, params, state, gen):
    """``(allocated, own peak)`` of one amortised step, after a warm-up:
    the bytes allocated when the peak is reset, and the peak less them."""
    E.iterative_step(x, y, params, gen, precond_state=state)
    torch.cuda.synchronize()
    gc.collect()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    E.iterative_step(x, y, params, gen, precond_state=state)
    torch.cuda.synchronize()
    return base, torch.cuda.max_memory_allocated() - base


def _live_blocks(snapshot, top=25):
    """The live blocks of a memory snapshot summed by the innermost frame
    of this repository on their allocation stack (else the innermost
    frame): ``[{"site", "blocks", "bytes"}]``, largest first."""
    sites = {}
    for seg in snapshot["segments"]:
        for blk in seg["blocks"]:
            if blk["state"] != "active_allocated":
                continue
            frames = blk.get("frames") or []
            ours = [f for f in frames if "stheno_torch" in f["filename"]
                    or f["filename"].endswith("chip_smoke.py")]
            f = (ours or frames or [None])[0]
            site = "unknown" if f is None else f"{f['filename'].split('/repo/')[-1]}:{f['line']} {f['name']}"
            n, b = sites.get(site, (0, 0))
            sites[site] = (n + 1, b + blk["size"])
    ranked = sorted(sites.items(), key=lambda kv: -kv[1][1])[:top]
    return [{"site": s, "blocks": n, "bytes": b} for s, (n, b) in ranked]


def mem(root):
    this = Path(root).resolve() == REPO
    sys.path.insert(0, str(Path(root).resolve()))
    cs = _chip_smoke()
    from stheno_torch import config
    from stheno_torch import entry as E
    from stheno_torch.ops import _build

    _build.library()
    out = {"nvidia_smi": _smi(), "root": str(root)}
    with config.matmul_precision_ctx():
        x, y, params = cs._path_inputs()
        gen = torch.Generator(device="cuda").manual_seed(7)
        state = E.iterative_precond_state(x, params, gen)
        out["fresh_allocated_bytes"], out["fresh_own_peak_bytes"] = _own_peak(
            E, x, y, params, state, gen)
        del x, y, params, state
        gc.collect()
        if this:
            class Stop(Exception):
                pass

            def at_step(state, cache, build_s):
                x, y, params = cs._path_inputs()
                gen = torch.Generator(device="cuda").manual_seed(9)
                base, own = _own_peak(E, x, y, params, state, gen)
                out["in_run_allocated_bytes"], out["in_run_own_peak_bytes"] = base, own
                out["in_run_live_blocks"] = _live_blocks(torch.cuda.memory._snapshot())
                raise Stop

            torch.cuda.memory._record_memory_history(enabled="state", context="alloc",
                                                     stacks="python")
            cs.phase_path_times = at_step
            try:
                cs._run_phases()
            except Stop:
                pass
            torch.cuda.memory._record_memory_history(enabled=None)
    print(json.dumps(out), flush=True)


def _demangle(names):
    """``{mangled: readable}`` by ``cu++filt`` beside nvcc, or the names as
    they are where it is missing."""
    from stheno_torch.ops import _build

    filt = Path(_build._nvcc()).with_name("cu++filt")
    if not names or not filt.exists():
        return {n: n for n in names}
    got = subprocess.run([str(filt)], input="\n".join(names), capture_output=True, text=True)
    lines = got.stdout.splitlines()
    return dict(zip(names, lines)) if got.returncode == 0 and len(lines) == len(names) else {
        n: n for n in names}


def _step_loops(obj, out_dir, pattern, entries, tag):
    """The step loop of each kernel instance of ``obj`` whose mangled name
    matches ``pattern`` (groups: the arithmetic type's letter and a
    template count): instructions, entries a lane computes an iteration
    (``entries(dtype, count)``), and both per entry and by unit."""
    from stheno_torch.ops import _build

    cuobjdump = str(Path(_build._nvcc()).with_name("cuobjdump"))
    dump = subprocess.run([cuobjdump, "-sass", str(obj)], capture_output=True, text=True,
                          check=True).stdout
    out = {}
    for block in re.split(r"\n\s*Function : ", dump)[1:]:
        name, *lines = block.split("\n")
        m = re.search(pattern, name)
        if not m:
            continue
        dtype, count = m.group(1), int(m.group(2))
        (out_dir / f"sass_{tag}_eq_{dtype}_{count}.txt").write_text(block)
        total, by_unit, by_op = _count(_loop_body(lines))
        per = entries(dtype, count)
        out[f"eq {'float32' if dtype == 'f' else 'float64'} {count}"] = {
            "loop_instructions": total, "entries_per_iteration": per,
            "instructions_per_entry": total / per,
            "by_unit_per_entry": {k: v / per for k, v in by_unit.items()},
            "by_op": dict(by_op)}
    return out


def _jvb_loops(obj, out_dir):
    """The step loop of ``gram_bwd_jvp_kernel<eq, T, NB, 1>`` for NB = 1
    and 3 (directions): a lane's 4 columns of its rows (float32 at NB = 1
    takes 2 rows a step, else 1)."""
    return _step_loops(obj, out_dir, r"gram_bwd_jvp_kernelILi0E([fd])Li([13])ELi1E",
                       lambda dt, nb: (2 if dt == "f" and nb == 1 else 1) * 4, "jvb")


def _bwd_loops(obj, out_dir):
    """The step loop of ``gram_bwd_kernel<eq, T, D>`` for depths D = 1 and
    2 (csrc/gram_bwd.cuh:kBwdRows: 4 rows a step in float32, 2 in float64,
    of a lane's 4 columns)."""
    return _step_loops(obj, out_dir, r"gram_bwd_kernelILi0E([fd])Li([12])EE",
                       lambda dt, depth: (4 if dt == "f" else 2) * 4, "bwd")


def ptxas(out_dir):
    sys.path.insert(0, str(REPO))
    from stheno_torch.ops import _build

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    procs = {}
    t0 = time.perf_counter()
    for src in ("gram.cu", "gram_bwd.cu", "gram_bwd_f64.cu", "gram_bwd_jvp.cu",
                "gram_bwd_jvp_f64.cu"):
        obj = out_dir / (Path(src).stem + ".o")
        procs[src] = subprocess.Popen(
            [nvcc, *_build._FLAGS, "-Xptxas", "-v", "-c", str(_build._CSRC / src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    report = {"nvidia_smi": _smi(), "sources": {}}
    for src, proc in procs.items():
        log, _ = proc.communicate()
        (out_dir / f"ptxas_{Path(src).stem}.txt").write_text(log)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {src}:\n{log}")
        kernels = _ptxas(log)
        entry = {
            "kernels": len(kernels),
            "max_registers": max((k["registers"] or 0) for k in kernels.values()),
            "spilling": {name: k for name, k in kernels.items() if k["spill_bytes"]},
            "done_s": time.perf_counter() - t0,
        }
        if "bwd" in src:
            names = _demangle(sorted(kernels))
            entry["each"] = {names[k]: v for k, v in kernels.items()}
            loops = _jvb_loops if "jvp" in src else _bwd_loops
            entry["step_loops"] = loops(out_dir / (Path(src).stem + ".o"), out_dir)
        report["sources"][src] = entry
    print(json.dumps(report), flush=True)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("what", choices=("check", "times", "jvb", "bwd", "ptxas", "mem"))
    parser.add_argument("--root", default=str(REPO))
    parser.add_argument("--check", action="store_true")
    parser.add_argument("--library", action="store_true")
    parser.add_argument("--out", default=str(REPO / "build" / "k1_ptxas"))
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_k1: CUDA is not available; this script needs a GPU.", file=sys.stderr)
        return 1
    if args.what == "check":
        check()
    elif args.what == "times":
        times(args.root)
    elif args.what == "jvb":
        jvb(args.root, args.check, args.library)
    elif args.what == "bwd":
        bwd(args.root)
    elif args.what == "mem":
        mem(args.root)
    else:
        ptxas(args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
