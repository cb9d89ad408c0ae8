"""The readers of the port's stage spans and allocator counters, and the
spans in the device trace's idle-gap labels, on the CPU."""

from __future__ import annotations

import json
import os
import time

import pytest

from harness import registry
from harness.trace import DeviceTrace

NEW = ["fwd_bwd_host_ms_per_step", "optimizer_host_ms_per_step", "allocator_mallocs_per_step"]
CELLS = {"lm_train": "q3.lm_train", "flow_train": "cv2.flow_train"}


def _stage(total, count, host, mallocs, retries=0) -> dict:
    return {"total_s": total, "count": count, "mean_ms": 1e3 * total / count, "host_s": host,
            "mallocs": mallocs, "alloc_retries": retries}


TIMER = {"forward": _stage(0.8, 4, 0.2, 1), "backward": _stage(1.2, 4, 0.5, 2),
         "optimizer": _stage(0.4, 4, 0.3, 5)}
WANT = {"fwd_bwd_host_ms_per_step": 1e3 * (0.2 + 0.5) / 4,
        "optimizer_host_ms_per_step": 1e3 * 0.3 / 4,
        "allocator_mallocs_per_step": (1 + 2 + 5) / 4}


def _reader(name: str):
    return registry.load_module(os.path.join(registry.BENCH_DIR, "metrics", name + ".py"), name)


@pytest.mark.parametrize("kind", sorted(CELLS))
@pytest.mark.parametrize("base", NEW)
def test_reader_reads_the_timer(base, kind):
    read = _reader(f"{base}.{kind}").read
    assert read({"timer": TIMER}) == pytest.approx(WANT[base])
    # a timer without the new keys (the parent's), or with no stages
    old = {k: {f: v[f] for f in ("total_s", "count", "mean_ms")} for k, v in TIMER.items()}
    assert read({"timer": old}) is None
    assert read({"timer": {}}) is None
    assert read({}) is None


@pytest.mark.parametrize("kind", sorted(CELLS))
def test_host_readings_stay_within_the_synced_ones(kind):
    """The host's share of a stage never passes the stage's synced time."""
    for base, total in (("fwd_bwd_host_ms_per_step", "fwd_bwd_ms_per_step"),
                        ("optimizer_host_ms_per_step", "optimizer_ms_per_step")):
        ctx = {"timer": TIMER}
        assert _reader(f"{base}.{kind}").read(ctx) <= _reader(f"{total}.{kind}").read(ctx)


def test_new_entries_name_their_cells_and_layers():
    spec = json.load(open(os.path.join(registry.ROOT, "BENCHMARK.json")))
    by_name = {m["name"]: m for m in spec["per_layer"]}
    layers = {"fwd_bwd_host_ms_per_step": ("train step", "ms", "program_span"),
              "optimizer_host_ms_per_step": ("optimizer", "ms", "program_span"),
              "allocator_mallocs_per_step": ("allocator", "1", "program_counter")}
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    for base in NEW:
        for kind, cell in CELLS.items():
            m = by_name[f"{base}.{kind}"]
            assert (m["layer"], m["unit"], m["source"]) == layers[base]
            assert m["workloads"] == [cell] and m["better"] == "lower"
            assert cell in e2e[m["moves"]]["workloads"]
            assert m in registry.Cell(cell).per_layer()


def test_an_idle_gap_inside_a_stage_is_labelled_by_the_stage():
    """On the CPU the whole window is one idle gap of the device; the stage
    running at its middle names it."""
    from cosyvoice2_eu_torch.utils.profiling import StageTimer

    timer = StageTimer()
    with DeviceTrace() as tr:
        with timer.stage("nap"):
            time.sleep(0.05)
    labels = dict(tr.summary["idle_gaps"])
    assert max(labels, key=labels.get) == "stage:nap"
    assert labels["stage:nap"] >= 0.04
