"""Each driver's whole run on the tiny configuration through the CPU path
(``run.execute``, past the look for a card), and the same run with the
timed path broken underneath: ``correct`` has to come out false."""

from __future__ import annotations

import json
import time

import pytest

import run as bench_run
from harness import faults, registry

CELLS = ["tiny.batch16", "tiny.lm_train", "tiny.flow_train"]


def _run(root, cell, trace=False, seed=2**31 + 7):
    c = registry.Cell(cell, root=root)
    line, checks = bench_run.execute(c, seed, 0.5, trace, time.perf_counter(), device="cpu")
    return json.loads(line), checks


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_run_is_correct_and_reports_its_metrics(tiny_root, cell, trace):
    res, checks = _run(tiny_root, cell, trace)
    assert res["correct"] is True, checks
    assert res["failed"] == 0 and res["attempted"] > 0
    assert list(res)[-1] == "checks" and res["checks"]
    c = registry.Cell(cell, root=tiny_root)
    want = ({m["name"] for m in c.per_layer()} if trace
            else {m["name"] for m in c.end_to_end()})
    # on the CPU nothing reads the device trace's kernels
    got = set(res["metrics"])
    assert got <= want and got
    if not trace:
        assert got == want
        assert all(v["value"] > 0 for v in res["metrics"].values())
    else:
        assert res["device"]["window_s"] > 0 and "breakdown" in res


FAULT_CELLS = {"tts_batch": "tiny.batch16", "lm_train": "tiny.lm_train",
               "flow_train": "tiny.flow_train"}


@pytest.mark.parametrize("driver,fault", sorted(faults.FAULTS))
def test_broken_timed_path_is_not_correct(tiny_root, driver, fault):
    restore = faults.plant(driver, fault)
    try:
        res, checks = _run(tiny_root, FAULT_CELLS[driver])
    finally:
        restore()
    assert res["correct"] is False, checks
