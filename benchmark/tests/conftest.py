"""The benchmark's own tests, on the CPU at tiny sizes.

  python -m pytest -q benchmark/tests

Tests that need the card carry the ``cuda`` marker and skip without one,
deciding inside the ``cuda_device`` fixture.  ``tiny_root`` builds a
benchmark root in a temporary directory: a copy of ``benchmark/`` with a
tiny configuration, small traffic mixes and a ``BENCHMARK.json`` naming
one cell a driver.
"""

from __future__ import annotations

import json
import os
import shutil
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH)
sys.path[:0] = [BENCH, REPO]


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (skips without one; run on the card)")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: run on the card")
    return "cuda"


# the offline-synthesis mix that the ``tts_batch`` driver reads (no cell of
# BENCHMARK.json runs it yet), and its per-layer metrics
BATCH_MIX = {"driver": "tts_batch", "generator": "tts_requests", "why": "tests",
             "batch": 16, "batches": 10, "prompt_tokens": [75, 250],
             "prompt_text_tokens": [10, 40], "text_tokens": [5, 20], "greedy": 4,
             "limits": {"lm_logit_gap": 0.1, "flow_mel_rel": 0.04, "hift_wav_rel": 0.0001,
                        "special_margin": 0.1, "min_served_tokens": 200}}
BATCH_METRICS = [("lm_decode_ms_per_step.batch", "ms"), ("flow_ms_per_call.batch", "ms"),
                 ("hift_ms_per_audio_s.batch", "ms"), ("k1_roofline_pct.serve", "%"),
                 ("mfu.serve", "%"), ("device_idle_pct.serve", "%")]

TINY_TRAFFIC = {
    "batch16": dict(batch=4, batches=6, prompt_tokens=[6, 10], prompt_text_tokens=[3, 5],
                    text_tokens=[2, 4], greedy=2),
    "lm_train": dict(utterances=24, speech_tokens=[20, 80], cap_padded_tokens=200),
    "flow_train": dict(utterances=24, frames=[20, 160], cap_padded_frames=400),
}
TINY_E2E = {"batch16": ("audio_s_per_s", "audio_s/s"),
            "lm_train": ("lm_train_tokens_per_s", "tokens/s"),
            "flow_train": ("flow_train_frames_per_s", "frames/s")}


def make_tiny_root(path: str) -> str:
    """A benchmark root at ``path`` with the cells ``tiny.<mix>``: the tiny
    configuration of the port's tests under small copies of each mix."""
    from cosyvoice2_eu_torch.config import TrainConfig, config_to_dict, tiny_test_config

    bench = os.path.join(path, "benchmark")
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns(".cache", "__pycache__", "tests"))
    with open(os.path.join(bench, "configs", "tiny.json"), "w") as f:
        json.dump({"name": "tiny", "source": "tests", "assumed": [],
                   "precision": {"llm": "float32", "flow": "float32", "hift": "float32",
                                 "train": "float32", "tf32": False},
                   "model": config_to_dict(tiny_test_config()),
                   "train": config_to_dict(TrainConfig())}, f)
    spec = {"command": ["python3", "benchmark/run.py"], "paths": ["benchmark"], "run_seconds": 1,
            "configs": [{"name": "tiny", "source": "tests", "file": "benchmark/configs/tiny.json",
                         "reduced": [], "why": "tests"}],
            "workloads": [], "end_to_end": [], "per_layer": []}
    for mix, sizes in TINY_TRAFFIC.items():
        if mix == "batch16":
            t = json.loads(json.dumps(BATCH_MIX))
        else:
            with open(os.path.join(bench, "traffic", mix + ".json")) as f:
                t = json.load(f)
        t.update(sizes)
        if "min_served_tokens" in t["limits"]:
            t["limits"] = dict(t["limits"], min_served_tokens=10)
        with open(os.path.join(bench, "traffic", "tiny_" + mix + ".json"), "w") as f:
            json.dump(t, f)
        cell = "tiny." + mix
        spec["workloads"].append({"name": cell, "config": "tiny", "traffic": "tiny_" + mix,
                                  "chips": 1, "why": "tests"})
        name, unit = TINY_E2E[mix]
        spec["end_to_end"].append({"name": name, "unit": unit, "better": "higher", "bound": 0.05,
                                   "source": "host_clock", "workloads": [cell]})
    spec["end_to_end"].append({"name": "setup_s", "unit": "s", "better": "lower", "bound": 0.25,
                               "source": "host_clock"})
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        real = json.load(f)
    for m in real["per_layer"]:
        kind = m["name"].rsplit(".", 1)[1]
        mix = {"serve": "batch16", "batch": "batch16"}.get(kind, kind)
        spec["per_layer"].append(dict(m, workloads=["tiny." + mix]))
    for name, unit in BATCH_METRICS:
        spec["per_layer"].append({"name": name, "unit": unit, "better": "lower",
                                  "source": "program_span", "layer": "tests",
                                  "moves": "audio_s_per_s", "workloads": ["tiny.batch16"]})
    with open(os.path.join(path, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f, indent=1)
    return path


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return make_tiny_root(str(tmp_path_factory.mktemp("bench")))
