"""The reduction of a device trace to busy time, kernel times and the
breakdown (``gpbench/harness/trace.py``), on a synthetic Chrome trace."""

import pytest

from gpbench.harness.readers import idle_share, roofline_per_launch
from gpbench.harness.trace import WINDOW_SPAN, Trace, kernel_name, union_length
from gpbench.work import Work


def _ev(cat, name, ts, dur, tid=1, pid=0):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "pid": pid}


def _trace():
    return Trace.from_chrome({"traceEvents": [
        _ev("user_annotation", WINDOW_SPAN, 100, 100),
        _ev("cpu_op", "aten::mm", 105, 20),
        _ev("cpu_op", "aten::item", 150, 40),
        _ev("user_annotation", "gpbench.step", 101, 98),
        _ev("cpu_op", "other_thread_op", 100, 100, tid=2),
        _ev("kernel", "void (anonymous namespace)::gmv_mma_kernel<float, 4>(float const*)", 110, 20,
            tid=7),
        _ev("kernel", "void gmv_reduce<float>(float*)", 125, 10, tid=8),
        _ev("gpu_memcpy", "Memcpy DtoH", 180, 5, tid=7),
        _ev("kernel", "outside_window", 300, 5, tid=7),
        _ev("gpu_user_annotation", "gpbench.step", 100, 100, tid=7),
    ]})


def test_kernel_name_strips_namespace_templates_and_parameters():
    assert kernel_name("void (anonymous namespace)::gmv_mma_kernel<float, 4>(float const*)") \
        == "gmv_mma_kernel"
    assert kernel_name("ampere_sgemm_128x64_nn") == "ampere_sgemm_128x64_nn"


def test_union_counts_overlaps_once():
    assert union_length([(0, 10), (5, 12), (20, 21)]) == 13


def test_busy_is_the_union_inside_the_window():
    tr = _trace()
    assert tr.window_s == pytest.approx(100e-6)
    # 110-135 (two overlapping kernels) and 180-185.
    assert tr.busy_s == pytest.approx(30e-6)
    assert tr.launches({"gmv_mma_kernel"}) == 1
    assert tr.device_time({"gmv_mma_kernel", "gmv_reduce"}) == pytest.approx(30e-6)


def test_breakdown_names_gaps_by_the_innermost_host_event():
    tr = _trace()
    ops = dict(tr.device_ops())
    assert ops["gmv_mma_kernel"] == pytest.approx(20e-6)
    gaps = dict(tr.idle_gaps())
    # 100-110: its midpoint 105 lies in aten::mm; 135-180: aten::item at
    # 157.5; 185-200: the step span at 192.5.
    assert gaps["aten::mm"] == pytest.approx(10e-6)
    assert gaps["aten::item"] == pytest.approx(45e-6)
    assert gaps["gpbench.step"] == pytest.approx(15e-6)
    assert sum(gaps.values()) == pytest.approx(tr.window_s - tr.busy_s)


class _Run:
    def __init__(self, trace):
        self.trace = trace


def test_idle_share_and_roofline_per_launch():
    tr = _trace()
    assert idle_share(_Run(tr)) == pytest.approx(70.0)
    # One K3 launch of 30 us (its reduction included) against 3 us of bytes.
    w = Work(bytes=3e-6 * 3.35e12)
    assert roofline_per_launch(_Run(tr), "gram_matvec", w) == pytest.approx(10.0)
    assert roofline_per_launch(_Run(tr), "chol_tile", w) is None
    assert roofline_per_launch(_Run(None), "chol_tile", w) is None
