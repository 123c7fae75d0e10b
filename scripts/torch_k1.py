"""K1 (the fused Gram of stheno_torch) and its backward on one GPU: checks
against the plain versions, times of two checkouts side by side, what the
compiler made of the kernels, and where chip_smoke.py's device memory
goes.

    python3 scripts/torch_k1.py check
    python3 scripts/torch_k1.py times [--root DIR]
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

``mem`` takes the peak device memory of one amortised N=262,144 step
apart. For the checkout at ``--root`` (default: this one), in a fresh
process: the step's own peak (``max_memory_allocated`` less what was
allocated when the peak was reset). For this checkout, also within
``chip_smoke.py``'s phases, stopped where phase ``iterative_times`` would
start: what is allocated there, the step's own peak, and the live blocks
grouped by the innermost frame of this repository that allocated them
(``torch.cuda.memory._record_memory_history``).

``ptxas`` compiles ``gram.cu``, ``gram_bwd.cu`` and ``gram_bwd_f64.cu``
with the build's flags and ``-Xptxas -v`` (written to
``DIR/ptxas_<source>.txt``) and prints the registers and spills of every
kernel: one JSON line.
"""

import argparse
import gc
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

from torch_k3 import _ptxas, _smi

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


def ptxas(out_dir):
    sys.path.insert(0, str(REPO))
    from stheno_torch.ops import _build

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    procs = {}
    for src in ("gram.cu", "gram_bwd.cu", "gram_bwd_f64.cu"):
        obj = out_dir / (Path(src).stem + ".o")
        procs[src] = subprocess.Popen(
            [nvcc, *_build._FLAGS, "-Xptxas", "-v", "-c", str(_build._CSRC / src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    report = {"nvidia_smi": _smi(), "sources": {}}
    for src, proc in procs.items():
        t0 = time.perf_counter()
        log, _ = proc.communicate()
        (out_dir / f"ptxas_{Path(src).stem}.txt").write_text(log)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {src}:\n{log}")
        kernels = _ptxas(log)
        report["sources"][src] = {
            "kernels": len(kernels),
            "max_registers": max((k["registers"] or 0) for k in kernels.values()),
            "spilling": {name: k for name, k in kernels.items() if k["spill_bytes"]},
            "wait_s": time.perf_counter() - t0,
        }
    print(json.dumps(report), flush=True)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("what", choices=("check", "times", "ptxas", "mem"))
    parser.add_argument("--root", default=str(REPO))
    parser.add_argument("--out", default=str(REPO / "build" / "k1_ptxas"))
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_k1: CUDA is not available; this script needs a GPU.", file=sys.stderr)
        return 1
    if args.what == "check":
        check()
    elif args.what == "times":
        times(args.root)
    elif args.what == "mem":
        mem(args.root)
    else:
        ptxas(args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
