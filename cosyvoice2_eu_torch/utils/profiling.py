"""Per-stage timers and device traces.

Counterpart of ``cosyvoice2_eu_tpu/utils/profiling.py``: ``StageTimer``
and ``device_trace`` (``torch.profiler`` where JAX takes ``jax.profiler``:
the CPU's activity and, where there is a card, CUDA's, written as a Chrome
trace).  Each stage of a ``StageTimer`` is also an event of the profiler,
so a trace shows the stages on the card's clock.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from collections import defaultdict
from typing import Callable, Dict, Optional

import torch

try:  # a CPU event of the profiler, not a user annotation; ~0.5 us a span
    from torch._C._profiler import _RecordFunctionFast as _Span
except ImportError:  # a user annotation, which readers that skip annotations do not see
    from torch.profiler import record_function as _Span


def _allocator_counts() -> tuple:
    """(cudaMalloc calls, allocation retries) of the caching allocator on
    the current device since the process began; (0, 0) before CUDA is
    initialised."""
    if not torch.cuda.is_initialized():
        return 0, 0
    s = torch.cuda.memory_stats_as_nested_dict()
    return s["segment"]["all"]["allocated"], s["num_alloc_retries"]


class StageTimer:
    """Accumulates wall-clock per named stage; one per model, not thread-safe.

    ``sync`` (e.g. ``torch.cuda.synchronize``) runs at the end of each stage,
    so a stage's time includes the device work it queued.  Each stage is a
    profiler event ``stage:<name>`` for its whole span: a CPU event that is
    not a user annotation, so a reader that labels the card's idle gaps by
    the host events around them (``benchmark/harness/trace.py``) names the
    stage.  On a torch without ``_RecordFunctionFast`` the span is a
    ``record_function``, a user annotation, and those labels are lost.

    ``summary()`` gives each stage ``total_s``, ``count`` and ``mean_ms``;
    ``host_s``, the host's time in the stage up to the call of ``sync`` (all
    of ``total_s`` without a sync); and ``mallocs`` and ``alloc_retries``,
    the caching allocator's new segments (cudaMalloc calls) and retries over
    the stage (0 on a process without CUDA).  Under a synced timer a stage
    starts on an empty queue, so ``host_s`` is its enqueue, with every wait
    of the host inside it (a device value read, a launch blocked on a full
    queue), and ``total_s - host_s`` the wait for the card after it.  A
    nested stage's time counts in the stage around it as well.

    ``count(name, value)`` adds to a counter what the program counts (a
    number, or a tensor, kept where it is: a device tensor is added on the
    device, with no sync); ``counters()`` reads them, tensors as lists.
    ``reset()`` clears the counters with the stages.
    """

    def __init__(self, sync: Optional[Callable[[], None]] = None):
        self.sync = sync
        self.totals: Dict[str, float] = defaultdict(float)
        self.host: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.mallocs: Dict[str, int] = defaultdict(int)
        self.retries: Dict[str, int] = defaultdict(int)
        self._counters: Dict[str, object] = {}

    def count(self, name: str, value) -> None:
        self._counters[name] = value + self._counters[name] if name in self._counters else value

    def counters(self) -> dict:
        return {k: v.tolist() if isinstance(v, torch.Tensor) else v
                for k, v in self._counters.items()}

    @contextlib.contextmanager
    def stage(self, name: str):
        mallocs, retries = _allocator_counts()
        with _Span("stage:" + name):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                host = time.perf_counter()
                end = host
                if self.sync is not None:
                    self.sync()
                    end = time.perf_counter()
                m, r = _allocator_counts()
                self.totals[name] += end - t0
                self.host[name] += host - t0
                self.counts[name] += 1
                self.mallocs[name] += m - mallocs
                self.retries[name] += r - retries

    def summary(self) -> Dict[str, dict]:
        return {
            k: {"total_s": v, "count": self.counts[k],
                "mean_ms": 1e3 * v / max(self.counts[k], 1), "host_s": self.host[k],
                "mallocs": self.mallocs[k], "alloc_retries": self.retries[k]}
            for k, v in self.totals.items()
        }

    def log(self, prefix: str = "stages"):
        logging.info("%s: %s", prefix, self.summary())

    def reset(self):
        for d in (self.totals, self.host, self.counts, self.mallocs, self.retries,
                  self._counters):
            d.clear()


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Profile the block with ``torch.profiler`` (CPU activity, and CUDA's
    where a card is present) and write a Chrome trace into ``log_dir``
    (``trace_<pid>_<n>.json``, its path then in the profiler's
    ``trace_path``); yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        n = len([f for f in os.listdir(log_dir) if f.startswith(f"trace_{os.getpid()}_")])
        prof.trace_path = os.path.join(log_dir, f"trace_{os.getpid()}_{n}.json")
        prof.export_chrome_trace(prof.trace_path)
