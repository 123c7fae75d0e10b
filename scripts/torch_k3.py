"""K3 (the fused Gram x V kernel of stheno_torch) on one GPU: per-route
times at the matrix-free path's shapes, and what the compiler made of the
float32 p <= 16 and float64 kernels.

    python3 scripts/torch_k3.py times [--root DIR]
    python3 scripts/torch_k3.py steps [--root DIR]
    python3 scripts/torch_k3.py sass [--out DIR]

``times`` imports ``stheno_torch`` from the checkout at ``--root``
(default: this one), so that two checkouts can be compared in one run on
one card, and prints one JSON line: the card's ``nvidia-smi`` name and
power limit, and for each shape the route (``gram_matvec.route`` where
the checkout has it), the CUDA-event time per call (one warm-up, median
of 3, each sample one call after a spin kernel has taken the host out of
it) and the error against the plain version on an 8192-row slice of the
same sweep, relative to ``|G| @ |v|``. Shapes: N=262,144 x 262,144, eq, d
= 1, x as ``entry.iterative_inputs`` makes it, at p = 1 and 17 in float64
and p = 1 in float32, and the 4096-point mean query at p = 1.

``steps`` times, for the checkout at ``--root``, the steps that K3's
float64 route and the float32 precision pin reach: the N=262,144 float64
training step of ``chip_smoke.py``'s gates (the stochastic NLML and its
gradient in float64 at cg_tol 1e-3, block 2048, on the float32 step's
preconditioner state: K3's CG sweeps and the fused Gram-gradient kernel),
wall seconds with a synchronise, one warm-up, median of 3; and the N=2000
NLML value+grad (``entry.nlml_n2000``), CUDA events, 3 warm-ups, median
of 20. One JSON line.

``sass`` compiles ``gram_matvec.cu`` and ``gram_matvec_f64.cu`` with the
build's flags and ``-Xptxas -v`` (registers, shared memory and spills of
every kernel, written to ``DIR/ptxas_<source>.txt``), disassembles them
with ``cuobjdump -sass`` (the kernels below to ``DIR/sass_<kernel>.txt``),
and counts, in the innermost loop of the eq
kernel at depth 1 (float32 at PC = 1, one exp per entry; float64 at
widths 1 and 17, a k-step of 8 entries a lane per pass of the loop), the
instructions by unit per Gram entry a thread builds: one JSON line.
"""

import argparse
import collections
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
N = 262_144


def _smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def _device_ms(fn, reps=3):
    fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end))
    return statistics.median(samples)


def times(root):
    sys.path.insert(0, str(Path(root).resolve()))
    from stheno_torch import entry as E
    from stheno_torch.ops import gram_matvec as K3

    gen = torch.Generator(device="cuda").manual_seed(5)
    out = {"nvidia_smi": _smi(), "root": str(root), "shapes": {}}
    xq = torch.linspace(0.0, 10.0, 4096, device="cuda")[:, None]
    for tag, dtype, p, query in (("p1_f64", torch.float64, 1, False),
                                 ("p17_f64", torch.float64, 17, False),
                                 ("p1", torch.float32, 1, False),
                                 ("query4096_p1", torch.float32, 1, True)):
        x = E.iterative_inputs(N, device="cuda", dtype=dtype)[0][:, None]
        rows = xq if query else x
        v = torch.randn(N, p, generator=gen, device="cuda", dtype=dtype)
        route = K3.route(rows.shape[0], N, p, dtype) if hasattr(K3, "route") else None
        ms = _device_ms(lambda: K3.gram_matvec("eq", rows, x, v))
        got = K3.gram_matvec("eq", rows[:8192], x, v)
        ref = K3.gram_matvec_plain("eq", rows[:8192], x, v)
        scale = K3.gram_matvec_plain("eq", rows[:8192], x, v.abs())
        out["shapes"][tag] = {
            "shape": [rows.shape[0], N, 1, p], "dtype": str(dtype), "route": route,
            "device_ms": ms, "max_rel_err": float(((got - ref).abs() / scale).max()),
        }
    print(json.dumps(out), flush=True)


def steps(root):
    sys.path.insert(0, str(Path(root).resolve()))
    from stheno_torch import entry as E
    from stheno_torch.iterative import nlml as NL

    out = {"nvidia_smi": _smi(), "root": str(root)}
    x, y, params = E.iterative_inputs(N, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(11)
    state = E.iterative_precond_state(x, params, gen)
    u = torch.randn(N, 16, generator=gen, device="cuda")
    d = torch.float64

    def step64():
        leaves = {k: v.to(d).requires_grad_(True) for k, v in params.items()}
        with torch.enable_grad():
            v, h = NL._nlml(leaves, y.to(d), E.ITERATIVE_NOISE, x.to(d)[:, None], u.to(d), None,
                            tuple(t.to(d) for t in state), E.iterative_kernel, 1e-3, 200, 30, 64,
                            "eig", block=2048)
            torch.autograd.grad(v, list(leaves.values()))
        return h

    secs = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        h = step64()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    out["n262144_f64_step_s"] = statistics.median(secs[1:])
    out["n262144_f64_step_samples_s"] = secs[1:]
    out["n262144_f64_cg_iters"] = h["cg_iters"]

    xb, yb, ell = E.n2000_inputs()
    for _ in range(3):
        E.nlml_n2000(xb, yb, ell, grad=True)
    torch.cuda.synchronize()
    samples = []
    for _ in range(20):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        E.nlml_n2000(xb, yb, ell, grad=True)
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end))
    out["n2000_value_grad_ms"] = statistics.median(samples)
    print(json.dumps(out), flush=True)


_UNITS = {
    "MUFU": "mufu", "DMMA": "fp64_tensor", "HMMA": "tensor",
    "DFMA": "fp64", "DADD": "fp64", "DMUL": "fp64", "DSETP": "fp64", "DMNMX": "fp64",
    "FFMA": "fp32", "FADD": "fp32", "FMUL": "fp32", "FMNMX": "fp32", "FSETP": "fp32",
    "FSEL": "fp32", "LDS": "shared", "LDSM": "shared",
}


def _loop_body(lines):
    """The instructions of the innermost loop that builds entries: the
    shortest span from a backward branch's target address to the branch
    that holds a MUFU.EX2 (float32) or at least 8 DFMAs (float64)."""
    addr = [re.search(r"/\*([0-9a-f]{4,})\*/", line) for line in lines]
    addr = [int(m.group(1), 16) if m else None for m in addr]
    best = None
    for i, line in enumerate(lines):
        m = re.search(r"BRA\s+(0x[0-9a-f]+)", line)
        if not m or addr[i] is None or int(m.group(1), 16) > addr[i]:
            continue
        body = [b for b, a in zip(lines, addr) if a is not None and int(m.group(1), 16) <= a <= addr[i]]
        if any("MUFU.EX2" in b for b in body) or sum("DFMA" in b for b in body) >= 8:
            if best is None or len(body) < len(best):
                best = body
    return best or []


def _count(body):
    ops = [re.search(r"/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", b) for b in body]
    ops = [m.group(2) for m in ops if m]
    by_unit = collections.Counter(_UNITS.get(o.split(".")[0], "other") for o in ops)
    return len(ops), dict(by_unit), collections.Counter(o.split(".")[0] for o in ops)


def _ptxas(log):
    """``{mangled name: {registers, smem_bytes, spill_bytes}}`` from
    ``-Xptxas -v``."""
    out = {}
    for block in log.split("Compiling entry function '")[1:]:
        name = block.split("'", 1)[0]
        regs = re.search(r"Used (\d+) registers", block)
        smem = re.search(r"(\d+) bytes smem", block)
        spill = re.search(r"(\d+) bytes spill stores", block)
        out[name] = {"registers": int(regs.group(1)) if regs else None,
                     "smem_bytes": int(smem.group(1)) if smem else 0,
                     "spill_bytes": int(spill.group(1)) if spill else None}
    return out


def sass(out_dir):
    from stheno_torch.ops import _build

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    cuobjdump = str(Path(nvcc).with_name("cuobjdump"))
    report = {"nvidia_smi": _smi(), "kernels": {}}
    srcs = ("gram_matvec.cu", "gram_matvec_f64.cu")
    procs = {}
    for src in srcs:
        obj = out_dir / (Path(src).stem + ".o")
        procs[src] = (obj, subprocess.Popen(
            [nvcc, *_build._FLAGS, "-Xptxas", "-v", "-c", str(_build._CSRC / src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for src, (obj, proc) in procs.items():
        log, _ = proc.communicate()
        (out_dir / f"ptxas_{Path(src).stem}.txt").write_text(log)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {src}:\n{log}")
        dump = subprocess.run([cuobjdump, "-sass", str(obj)], capture_output=True, text=True,
                              check=True).stdout
        # Function blocks: "Function : <mangled name>" up to the next one.
        blocks = re.split(r"\n\s*Function : ", dump)[1:]
        for block in blocks:
            name, *lines = block.split("\n")
            # eq (KIND 0), depth 1: gmv_kernel<0, 1, 1>, gmv_dmma_kernel<0, 1, 1 | 17>.
            m = re.search(r"(gmv_kernel|gmv_dmma_kernel)ILi0ELi1ELi(\d+)E", name)
            if not m or (m.group(1) == "gmv_kernel" and m.group(2) != "1") or (
                    m.group(1) == "gmv_dmma_kernel" and m.group(2) not in ("1", "17")):
                continue
            (out_dir / f"sass_{m.group(1)}_{m.group(2)}.txt").write_text(block)
            body = _loop_body(lines)
            total, by_unit, by_op = _count(body)
            if m.group(1) == "gmv_kernel":
                entries = by_op["MUFU"]  # one exp per entry
            else:
                entries = 8  # a lane's entries per k-step, the loop's one pass
            info = _ptxas(log).get(name.strip(), {})
            report["kernels"][f"{m.group(1)}<eq, d=1, {m.group(2)}>"] = {
                "loop_instructions": total, "entries_per_iteration": entries,
                "instructions_per_entry": total / entries if entries else math.nan,
                "by_unit_per_entry": {k: v / entries for k, v in by_unit.items()} if entries
                else {},
                "by_op": dict(by_op),
                **info,
            }
    print(json.dumps(report), flush=True)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("what", choices=("times", "steps", "sass"))
    parser.add_argument("--root", default=str(REPO))
    parser.add_argument("--out", default=str(REPO / "chiprun_out" / "k3_sass"))
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_k3: CUDA is not available; this script needs a GPU.", file=sys.stderr)
        return 1
    if args.what == "times":
        times(args.root)
    elif args.what == "steps":
        steps(args.root)
    else:
        sys.path.insert(0, str(REPO))
        sass(args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
