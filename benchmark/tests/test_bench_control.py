"""The control of the output check: the reference computed one precision
below the configuration's, in the program's place, reads worse than the
program on the numbers the check compares.  At the cells' own sizes it is
read on the card by ``tools/readings.py``; here at the tiny size."""

from __future__ import annotations

import time

import pytest

from harness import registry


def _readings(root, cell, device):
    c = registry.Cell(cell, root=root)
    out = c.driver().run(c, 2**31 + 99, 0.5, False, time.perf_counter(), device=device,
                         control=True)
    return {ch.name: ch.value for ch in out.checks}, out.notes["control"]


def test_fp8_control_reads_worse_than_the_program_on_the_cpu(tiny_root):
    """The fp8 reference, in the program's place."""
    prog, ctl = _readings(tiny_root, "tiny.batch16", "cpu")
    assert ctl["lm_logit_gap"] > 3 * prog["lm_logit_gap"]
    assert ctl["flow_mel_rel"] > 3 * prog["flow_mel_rel"]


@pytest.mark.cuda
def test_tf32_control_reads_worse_on_the_card(tiny_root, cuda_device):
    """TF32 exists only on the card (the tiny LM has no hand-written kernel)."""
    prog, ctl = _readings(tiny_root, "tiny.lm_train", cuda_device)
    assert any(ctl[k] > 3 * prog[k] for k in prog)
