"""Readings of the numbers that decide ``correct``, over many seeds in one
process: the program's, the control's (the program with its TF32
products switched on) and each fault's, at the cell's own size, on the
card. The limits in ``limits/<cell>.json`` are set from them (PERF.md).

    python3 gpbench/tools/readings.py --workload <cell> --plan program:12,control:3 \
        [--seconds S] [--first-seed N] [--out FILE]

Each entry of ``--plan`` is ``mode:count``; a mode is ``program``,
``control`` or a fault of the cell's path (``half_batch``,
``state_unchanged``, ``answer_altered``). Each run gets a seed of its own.
Prints one JSON line a run and, per mode and number, the largest and the
smallest reading.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--plan", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--first-seed", type=int, default=2_500_000_001)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    from gpbench.harness import bench

    seed = args.first_seed
    readings = {}
    out = open(args.out, "a") if args.out else None
    for entry in args.plan.split(","):
        mode, count = entry.split(":")
        for _ in range(int(count)):
            keep = {}
            t = time.perf_counter()
            res = bench.run_cell(args.workload, seed, args.seconds, False,
                                 control=mode == "control",
                                 fault=None if mode in ("program", "control") else mode, keep=keep)
            line = {"workload": args.workload, "mode": mode, "seed": seed,
                    "seconds": time.perf_counter() - t, "correct": res["correct"],
                    "checks": {k: v["value"] for k, v in res["checks"].items()},
                    "metrics": {k: v["value"] for k, v in res["metrics"].items()},
                    "attempted": res["attempted"]}
            iters = [r["cg_iters"] for r in keep["records"] if "cg_iters" in r]
            if iters:
                line["cg_iters"] = sorted(set(iters))
                line["cg_rel_residual_max"] = max(r["cg_rel_residual"] for r in keep["records"])
            print(json.dumps(line), flush=True)
            if out:
                out.write(json.dumps(line) + "\n")
                out.flush()
            for k, v in line["checks"].items():
                readings.setdefault((mode, k), []).append(v)
            seed += 1
    for (mode, k), vs in sorted(readings.items()):
        print(f"{args.workload} {mode} {k}: max {max(vs)!r} min {min(vs)!r} n {len(vs)}")
    if out:
        out.close()


if __name__ == "__main__":
    main()
