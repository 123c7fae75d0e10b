"""The end-to-end metrics' arithmetic: rates over the whole window (never
over medians of chunks)."""

import importlib.util

import pytest

from gpbench.harness import stats
from gpbench.harness.bench import PKG, Run


def _reader(name):
    spec = importlib.util.spec_from_file_location(name, PKG / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _run(records, window_s=10.0, setup_s=3.0):
    return Run({}, {}, records, window_s, setup_s, None, None)


def test_rate_is_over_the_whole_window():
    assert stats.rate(50, 20.0) == 2.5
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


def test_steps_per_s_counts_every_step_over_the_window():
    recs = [{"n_units": 100, "t0": 0, "t1": 1, "ok": True}] * 7
    assert _reader("steps_per_s")(_run(recs, window_s=3.5)) == pytest.approx(200.0)


def test_setup_s_is_the_runs_setup():
    assert _reader("setup_s")(_run([], setup_s=12.5)) == 12.5
