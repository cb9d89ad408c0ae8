"""The device trace of a traced window: busy time, kernels and idle gaps.

``DeviceTrace`` profiles a block with ``torch.profiler`` (CPU and CUDA
activity) and reads the profiler's raw events.  The arithmetic is a copy
of the port's ``tools/profile_stages.py::trace_summary``: the device is
busy in the union of its events' intervals (kernels, copies, sets), over
the block's wall time.  Beside it: device time by kernel name, and each
idle gap of the device labelled with the innermost host operation that
was running at its middle (what the host was doing while the card
waited), summed by label.
"""

from __future__ import annotations

import heapq


def union_seconds(intervals) -> float:
    """The length of the union of (start, end) intervals, in their unit."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def gaps(intervals, lo: float, hi: float) -> list:
    """The (start, end) spans of [lo, hi] that no interval covers."""
    out, cur = [], lo
    for a, b in sorted(intervals):
        if a > cur:
            out.append((cur, min(a, hi)))
        cur = max(cur, b)
        if cur >= hi:
            break
    if cur < hi:
        out.append((cur, hi))
    return [(a, b) for a, b in out if b > a]


def _labels(spans: list, host: list) -> tuple:
    """(spans, the label of each): the innermost host event covering each
    span's middle (the latest-started one still running), in one sweep over
    both in time order; "python between operations" where none is."""
    host = sorted(host)
    out, active, k = [], [], 0
    for a, b in spans:
        t = 0.5 * (a + b)
        while k < len(host) and host[k][0] <= t:
            heapq.heappush(active, (-host[k][0], host[k][1], host[k][2]))
            k += 1
        while active and active[0][1] < t:  # ended: it covers no later middle
            heapq.heappop(active)
        out.append(active[0][2] if active else "python between operations")
    return spans, out


def summarize(device: list, host: list, lo: float, hi: float, top: int = 10) -> dict:
    """device: [(start_ns, end_ns, name)] device events; host: [(start_ns,
    end_ns, name)] host events; [lo, hi]: the traced window, in ns.

    Returns {"busy_s", "window_s", "kernels": {name: [seconds, calls]},
    "device_ops": top [name, seconds], "idle_gaps": top [label, seconds]}.
    """
    inside = [(max(a, lo), min(b, hi), n) for a, b, n in device if b > lo and a < hi]
    kernels: dict = {}
    for a, b, n in inside:
        k = kernels.setdefault(n, [0.0, 0])
        k[0] += (b - a) * 1e-9
        k[1] += 1
    spans = [(a, b) for a, b, _ in inside]
    by_label: dict = {}
    for (a, b), lab in zip(*_labels(gaps(spans, lo, hi), host)):
        by_label[lab] = by_label.get(lab, 0.0) + (b - a) * 1e-9
    ops = sorted(((n[:160], s) for n, (s, _) in kernels.items()), key=lambda x: -x[1])
    idle = sorted(((n[:160], s) for n, s in by_label.items()), key=lambda x: -x[1])
    return {"busy_s": union_seconds(spans) * 1e-9, "window_s": (hi - lo) * 1e-9,
            "kernels": kernels, "device_ops": [list(x) for x in ops[:top]],
            "idle_gaps": [list(x) for x in idle[:top]]}


class DeviceTrace:
    """``with DeviceTrace() as tr: ...`` then ``tr.summary``: the block's
    device busy time, kernels and idle gaps (``summarize``)."""

    WINDOW = "benchmark_traced_window"

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.start()
        self.span = torch.profiler.record_function(self.WINDOW)
        self.span.__enter__()
        return self

    def __exit__(self, *exc):
        import torch

        try:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
        finally:
            self.span.__exit__(None, None, None)
            self.prof.stop()
        if exc[0] is None:
            self.summary = self._read()
        return False

    def _read(self) -> dict:
        device, host, lo, hi = [], [], None, None
        for e in self.prof.profiler.kineto_results.events():
            a, d = e.start_ns(), e.duration_ns()
            on_device = str(e.device_type()).endswith("CUDA")
            if e.name() == self.WINDOW or e.is_user_annotation():
                if not on_device and e.name() == self.WINDOW:
                    lo, hi = a, a + d
            elif on_device:
                device.append((a, a + d, e.name()))
            else:
                host.append((a, a + d, e.name()))
        if lo is None:
            raise RuntimeError("the profiler recorded no window span")
        return summarize(device, host, lo, hi)
