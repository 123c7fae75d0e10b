"""Run one cell of the benchmark of stheno_torch once, on the card.

    python3 gpbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. Prints, as the last line of standard output,
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``, each
number that decided ``correct`` beside its limit (also the last lines of
standard error). Exits 2, with no result, where the cell's cards are
missing; 3 where the process has loaded the JAX package or JAX.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# Kernel and build caches at fixed paths inside the checkout, so that only
# a checkout's first run builds (the program's own CUDA library is cached
# under build/stheno_torch/, which it fixes itself).
_CACHE = ROOT / "build" / "gpbench"
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = str(_CACHE / sub)
sys.path.insert(0, str(ROOT))


def _parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None):
    args = _parse(argv)
    from gpbench.harness import bench, device, imports

    try:
        result = bench.run_cell(args.workload, args.seed, args.seconds, bool(args.trace), t0=T0)
    except device.NoCard as e:
        print(f"gpbench: {e}", file=sys.stderr)
        return 2
    found = imports.forbidden_loaded()
    if found:
        print(f"gpbench: the process has loaded {', '.join(found)}: no result", file=sys.stderr)
        return 3
    print(f"gpbench: {args.workload} seed {args.seed} on {device.power_limit()}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
