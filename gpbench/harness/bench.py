"""One run of one cell: set-up, the window, the metrics, the check.

:func:`run_cell` does the work and returns the result line's object; it
raises :class:`~gpbench.harness.device.NoCard` where the cell's cards are
missing. Everything that belongs to a configuration, a traffic mix or a
metric is found by name:

- ``BENCHMARK.json`` at the root of the checkout names the cell's
  configuration (``configs/<name>.json``, whose ``path`` names the program
  side ``paths/<path>.py``, the plain reference ``reference/<path>.py`` and
  the work counts ``work/<path>.py``), its traffic (``traffic/<name>.json``)
  and its metrics (``metrics/<name>.py``, each with ``read(run)``);
- the limits of the numbers that decide ``correct``: ``limits/<cell>.json``.
"""

import gc
import importlib
import importlib.util
import json
import math
import time
from pathlib import Path

import torch

from . import device as devmod
from . import trace as tracemod
from . import traffic as trafficmod

__all__ = ["ROOT", "load_benchmark", "run_cell", "cell_metrics", "load_cell"]

ROOT = Path(__file__).resolve().parents[2]
PKG = ROOT / "gpbench"


def load_benchmark(root=ROOT):
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def _by_name(entries, name, what):
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"BENCHMARK.json names no {what} {name!r}")


def load_cell(name, bench=None, root=ROOT):
    """``(workload, config, traffic, limits)`` of cell ``name``."""
    bench = load_benchmark(root) if bench is None else bench
    cell = _by_name(bench["workloads"], name, "workload")
    cfg_entry = _by_name(bench["configs"], cell["config"], "configuration")
    config = json.loads((Path(root) / cfg_entry["file"]).read_text())
    traffic = trafficmod.load(PKG / "traffic" / f"{cell['traffic']}.json")
    limits = json.loads((PKG / "limits" / f"{name}.json").read_text())
    return cell, config, traffic, limits


def cell_metrics(bench, cell_name, trace):
    """The metric entries a run of ``cell_name`` reports: with ``trace`` its
    per-layer metrics, else its end-to-end ones. A metric with a
    ``workloads`` key is reported in those cells; an end-to-end metric
    without one in every cell; a per-layer metric without one in every
    cell that reports the end-to-end metric it moves."""
    e2e = [m for m in bench["end_to_end"] if cell_name in m.get("workloads", [cell_name])]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell_name in m["workloads"] if "workloads" in m else m["moves"] in moved)]


def _module(kind, name):
    return importlib.import_module(f"gpbench.{kind}.{name}")


def _metric_reader(name):
    path = PKG / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"gpbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Run:
    """What a metric's reader sees of a run: the cell's configuration and
    traffic, the window's unit records (host clock, with what the program
    returned of each unit, such as its CG iterations), ``window_s``,
    ``setup_s``, the device trace (``None`` without ``--trace 1``) and the
    work counts of the configuration's path."""

    def __init__(self, config, traffic, records, window_s, setup_s, trace, work):
        self.config, self.traffic = config, traffic
        self.records, self.window_s, self.setup_s = records, window_s, setup_s
        self.trace, self.work = trace, work


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _window(session, traffic, seconds, trace, device):
    """Run units back to back until ``seconds`` have passed (with ``trace``,
    at most ``trace_units`` of them). Returns ``(records, window_s)``."""
    limit = traffic["trace_units"] if trace else None
    records = []
    with torch.profiler.record_function(tracemod.WINDOW_SPAN):
        _sync(device)
        start = time.perf_counter()
        deadline = start + seconds
        i = 0
        while True:
            records.append(session.unit(i))
            i += 1
            if time.perf_counter() >= deadline or (limit is not None and i >= limit):
                break
        _sync(device)
        window_s = time.perf_counter() - start
    return records, window_s


def run_cell(name, seed, seconds, trace, *, control=False, fault=None, device="cuda",
             overrides=None, traffic_overrides=None, t0=None, require_card=True, root=ROOT,
             keep=None):
    """Run cell ``name`` once and return the result line's object.

    ``control``: run the program with its TF32 products switched on (the
    control of the check, never in the benchmark's own runs). ``fault``:
    break the timed path underneath (the check's tests). ``overrides``:
    configuration values to replace, and ``traffic_overrides`` traffic
    values (the CPU tests' small sizes). ``keep``: a dict that receives the
    window's records (the readings tool)."""
    t0 = time.perf_counter() if t0 is None else t0
    bench = load_benchmark(root)
    cell, config, traffic, limits = load_cell(name, bench, root)
    config = {**config, **(overrides or {})}
    traffic = {**traffic, **(traffic_overrides or {})}
    if require_card:
        devmod.require(cell["chips"])
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    paths = _module("paths", config["path"])
    session = paths.Session(config, traffic, seed, device, control=control, fault=fault)
    _sync(device)
    setup_s = time.perf_counter() - t0

    holder = {}
    if trace:
        with tracemod.traced(holder):
            records, window_s = _window(session, traffic, seconds, True, device)
    else:
        records, window_s = _window(session, traffic, seconds, False, device)
    run = Run(config, traffic, records, window_s, setup_s, holder.get("trace"),
              _module("work", config["path"]))
    metrics = {}
    for m in cell_metrics(bench, name, trace):
        value = _metric_reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    memory_peak = (torch.cuda.max_memory_allocated(device)
                   if torch.device(device).type == "cuda" else 0)
    failed = sum(r["n_units"] for r in records if not r["ok"])
    if keep is not None:
        keep["records"] = records

    # The check: the program's answers, then its state freed, then the
    # plain reference on the same inputs.
    answers = session.answers(records)
    inputs = session.inputs()
    session.close()
    del session
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    numbers = _module("reference", config["path"]).check(config, traffic, seed, inputs, answers,
                                                          device)
    checks = {k: {"value": float(v), "limit": float(limits[k])} for k, v in numbers.items()}
    correct = failed == 0 and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    result = {
        "correct": correct,
        "attempted": sum(r["n_units"] for r in records),
        "failed": failed,
        "metrics": metrics,
        "device": devmod.describe(device, cell["chips"], memory_peak),
    }
    if trace:
        tr = run.trace
        result["device"].update(busy_s=tr.busy_s, window_s=tr.window_s)
        result["breakdown"] = tr.breakdown()
    result["checks"] = checks
    return result
