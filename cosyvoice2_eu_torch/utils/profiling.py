"""Per-stage wall-clock timers and device traces.

Counterpart of ``cosyvoice2_eu_tpu/utils/profiling.py``: ``StageTimer``,
``device_trace`` (``torch.profiler`` where JAX takes ``jax.profiler``: the
CPU's activity and, where there is a card, CUDA's, written as a Chrome
trace) and the reference's per-yield ``log_rtf``.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from collections import defaultdict
from typing import Callable, Dict, Optional


class StageTimer:
    """Accumulates wall-clock per named stage; one per model, not thread-safe.

    ``sync`` (e.g. ``torch.cuda.synchronize``) runs at the end of each stage,
    so a stage's time includes the device work it queued.
    """

    def __init__(self, sync: Optional[Callable[[], None]] = None):
        self.sync = sync
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.sync is not None:
                self.sync()
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> Dict[str, dict]:
        return {
            k: {"total_s": v, "count": self.counts[k],
                "mean_ms": 1e3 * v / max(self.counts[k], 1)}
            for k, v in self.totals.items()
        }

    def log(self, prefix: str = "stages"):
        logging.info("%s: %s", prefix, self.summary())

    def reset(self):
        self.totals.clear()
        self.counts.clear()


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Profile the block with ``torch.profiler`` (CPU activity, and CUDA's
    where a card is present) and write a Chrome trace into ``log_dir``
    (``trace_<pid>_<n>.json``, its path then in the profiler's
    ``trace_path``); yields the profiler."""
    import torch
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


def log_rtf(start_time: float, audio_seconds: float, tag: str = "synthesis"):
    """Reference-style per-yield RTF logging (cli/cosyvoice.py:88):
    ``start_time`` from ``time.time()``; returns the RTF."""
    elapsed = time.time() - start_time
    rtf = elapsed / max(audio_seconds, 1e-9)
    logging.info("%s: yield speech len %.2fs, rtf %.4f", tag, audio_seconds, rtf)
    return rtf
