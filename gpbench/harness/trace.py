"""The device trace of a window: ``torch.profiler`` over it, reduced from
the exported Chrome trace to what the per-layer metrics read.

- busy: the union of the device's kernel, copy and set intervals inside the
  window (the benchmark's own ``gpbench.window`` span), so that
  overlapping streams count once;
- device time and launches by kernel name;
- the breakdown: the ten device operations that took most time, and the
  ten longest sums of idle gaps, each gap named by the innermost host
  operation or span running at its midpoint.
"""

import bisect
import contextlib
import json
import os
import tempfile

import torch

__all__ = ["Trace", "traced", "kernel_name", "union_length", "WINDOW_SPAN"]

WINDOW_SPAN = "gpbench.window"
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
# How far back the gap labelling looks for the innermost enclosing host event.
_LOOKBACK = 256


def kernel_name(name):
    """A device event's name without namespace, template arguments or
    parameter list (the rule of ``chip_smoke.py:_kernel_name``)."""
    head = name.replace("(anonymous namespace)::", "").split("(")[0].split("<")[0]
    return head.rsplit("::", 1)[-1].replace("void ", "").strip()[:80]


def union_length(intervals):
    """Total length of the union of ``(start, end)`` intervals (the rule of
    ``chip_smoke.py:_union_length``)."""
    total, start, end = 0.0, None, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            if end is not None:
                total += end - start
            start, end = s, e
        else:
            end = max(end, e)
    return total if end is None else total + end - start


def _merged(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class Trace:
    """A traced window: device events ``(name, start_us, end_us)`` and host
    events ``(name, start_us, end_us)`` of the main thread, clipped to the
    window ``(w0, w1)`` in microseconds."""

    def __init__(self, device_events, host_events, window):
        self.w0, self.w1 = window
        self.device = [(n, max(s, self.w0), min(e, self.w1)) for n, s, e in device_events
                       if e > self.w0 and s < self.w1]
        self.host = sorted(host_events, key=lambda h: h[1])
        self._host_starts = [h[1] for h in self.host]

    @classmethod
    def from_chrome(cls, data):
        events = data["traceEvents"] if isinstance(data, dict) else data
        window = None
        for ev in events:
            if ev.get("cat") == "user_annotation" and ev.get("name") == WINDOW_SPAN:
                window = (float(ev["ts"]), float(ev["ts"]) + float(ev["dur"]), ev.get("tid"))
        if window is None:
            raise RuntimeError(f"the trace holds no {WINDOW_SPAN!r} span")
        device, host = [], []
        for ev in events:
            if ev.get("ph") != "X" or "dur" not in ev:
                continue
            s = float(ev["ts"])
            e = s + float(ev["dur"])
            if ev.get("cat") in _DEVICE_CATS:
                device.append((kernel_name(ev.get("name", "")), s, e))
            elif ev.get("cat") in _HOST_CATS and ev.get("tid") == window[2]:
                host.append((ev.get("name", "")[:80], s, e))
        return cls(device, host, window[:2])

    @property
    def window_s(self):
        return (self.w1 - self.w0) * 1e-6

    @property
    def busy_s(self):
        return union_length([(s, e) for _, s, e in self.device]) * 1e-6

    def device_time(self, names):
        """Seconds of device time of the events named in ``names``."""
        names = set(names)
        return sum(e - s for n, s, e in self.device if n in names) * 1e-6

    def launches(self, names):
        """Number of device events named in ``names``."""
        names = set(names)
        return sum(1 for n, _, _ in self.device if n in names)

    def device_ops(self, top=10):
        """The ``top`` device operations by total time: ``[[name, s], ...]``."""
        by = {}
        for n, s, e in self.device:
            by[n] = by.get(n, 0.0) + (e - s) * 1e-6
        return [[n, t] for n, t in sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def _host_at(self, t):
        """The innermost host event running at ``t``: of those that contain
        it, the one that started last."""
        i = bisect.bisect_right(self._host_starts, t) - 1
        for j in range(i, max(-1, i - _LOOKBACK), -1):
            name, s, e = self.host[j]
            if s <= t <= e:
                return name
        return "host outside any operator"

    def idle_gaps(self, top=10):
        """Idle device time by what the host was doing: ``[[name, s], ...]``,
        the ``top`` largest sums of gaps."""
        busy = _merged([(s, e) for _, s, e in self.device])
        edges = [self.w0] + [v for iv in busy for v in iv] + [self.w1]
        by = {}
        for k in range(0, len(edges), 2):
            s, e = edges[k], edges[k + 1]
            if e > s:
                label = self._host_at(0.5 * (s + e))
                by[label] = by.get(label, 0.0) + (e - s) * 1e-6
        return [[n, t] for n, t in sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def breakdown(self):
        return {"device_ops": self.device_ops(), "idle_gaps": self.idle_gaps()}


@contextlib.contextmanager
def traced(holder):
    """Profile the enclosed code (host and device); on exit put its
    :class:`Trace` in ``holder["trace"]``. The enclosed code opens the
    ``gpbench.window`` span around the window itself. The exported trace
    goes to a temporary file (``TMPDIR``), which is removed once read."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    with prof:
        yield
    fd, path = tempfile.mkstemp(prefix="gpbench-trace-", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            holder["trace"] = Trace.from_chrome(json.load(f))
    finally:
        os.remove(path)
