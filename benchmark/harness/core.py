"""What every run shares: the cache directories, the card check, the
outcome of a driver, the comparison records and the result line."""

from __future__ import annotations

import json
import math
import os
import sys
from dataclasses import dataclass, field

FORBIDDEN = ("jax", "jaxlib", "flax", "cosyvoice2_eu_tpu")


def set_cache_dirs(bench_dir: str) -> None:
    """Every build and kernel cache of the program at a fixed path inside the
    checkout, so that only a checkout's first run builds; libraries that
    could load JAX are told not to."""
    cache = os.path.join(bench_dir, ".cache")
    os.environ["COSY_AOT_CACHE"] = os.path.join(cache, "aot")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    os.environ["USE_TF"] = "0"
    for k in ("COSY_AOT_CACHE", "TRITON_CACHE_DIR", "TORCH_EXTENSIONS_DIR"):
        os.makedirs(os.environ[k], exist_ok=True)


def forbidden_modules(modules=None) -> list:
    """The JAX-side packages among the loaded modules, compared by whole
    top-level name (``cosyvoice2_eu_torch`` is not ``cosyvoice2_eu_tpu``)."""
    tops = {name.split(".")[0] for name in (sys.modules if modules is None else modules)}
    return sorted(tops.intersection(FORBIDDEN))


@dataclass
class Check:
    """One number compared with its limit: it passes when value <= limit."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclass
class Outcome:
    """What a driver hands back.  ``e2e``: the end-to-end metrics it
    measured (setup_s among them); ``ctx``: what the per-layer readers read;
    ``checks``: the comparison with the reference."""

    e2e: dict
    ctx: dict
    checks: list
    attempted: int
    failed: int
    memory_peak_bytes: int
    trace: dict | None = None
    notes: dict = field(default_factory=dict)

    @property
    def correct(self) -> bool:
        return bool(self.checks) and self.failed == 0 and all(c.ok for c in self.checks)


def device_info(chips: int, memory_peak_bytes: int, trace: dict | None) -> dict:
    import torch

    gpu = torch.cuda.is_available()  # a run on the CPU is a test's, and says so
    d = {"platform": "gpu" if gpu else "cpu",
         "kind": torch.cuda.get_device_name(0) if gpu else "cpu", "count": chips,
         "memory_peak_bytes": int(memory_peak_bytes)}
    if trace is not None:
        d["busy_s"] = trace["busy_s"]
        d["window_s"] = trace["window_s"]
    return d


def result_line(outcome: Outcome, metrics: dict, chips: int) -> str:
    res = {"correct": outcome.correct, "attempted": outcome.attempted, "failed": outcome.failed,
           "metrics": metrics,
           "device": device_info(chips, outcome.memory_peak_bytes, outcome.trace)}
    if outcome.trace is not None:
        res["breakdown"] = {"device_ops": outcome.trace["device_ops"],
                            "idle_gaps": outcome.trace["idle_gaps"]}
    res["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in outcome.checks}
    return json.dumps(res)


def checks_text(checks: list) -> str:
    return "\n".join(f"check {c.name}: {c.value!r} limit {c.limit!r} "
                     f"{'ok' if c.ok else 'FAILED'}" for c in checks)
