"""The port's upload and profiling tools (``tools/upload_weights.py``,
``tools/profile_stages.py``) and profiling helpers (``utils/profiling.py``)
against the JAX package's, on the CPU.  Nothing is uploaded: the upload
tool runs its dry run, and its real upload without ``huggingface_hub``.
``log_rtf`` returns exactly JAX's value under the same clock."""

import json
import logging
import os
import sys
import time

import numpy as np
import pytest

from cosyvoice2_eu_torch.tools import profile_stages, upload_weights
from cosyvoice2_eu_torch.train.executor import save_checkpoint
from cosyvoice2_eu_torch.utils import profiling
from cosyvoice2_eu_tpu.utils import profiling as jax_profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jax_upload():
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        import upload_weights as tool
    finally:
        sys.path.remove(os.path.join(REPO, "tools"))
    return tool


def _exp(tmp_path):
    """An experiment of port checkpoints: llm with two CV losses, flow with
    none (the latest wins), hifigan with one, and sidecars at the root."""
    import torch

    exp = tmp_path / "exp"
    w = {"w": torch.zeros(2)}
    for model, infos in {"llm": [("epoch_1", 3.2, 1, 10), ("epoch_2", 2.9, 2, 20),
                                 ("epoch_3", 3.0, 3, 30)],
                         "flow": [("epoch_1", None, 1, 10), ("epoch_2", None, 2, 20)],
                         "hifigan": [("epoch_0_step_5", 1.5, 0, 5)]}.items():
        (exp / model).mkdir(parents=True)
        for tag, cv, epoch, step in infos:
            info = {"epoch": epoch, "step": step}
            if cv is not None:
                info["cv_loss"] = cv
            save_checkpoint(str(exp / model), tag, w, info)
    (exp / "config.json").write_text("{}")
    (exp / "tokenizer.json").write_text("{}")
    return exp


def test_dry_run_equals_jax_tools(tmp_path, jax_upload, capsys):
    """The upload set of the port's tool equals the JAX tool's on the same
    tree of port checkpoints: the lowest CV loss, else the latest, ``hift``
    for hifigan, the sidecars; an averaged directory (JAX's first name)
    takes precedence over both."""
    exp = _exp(tmp_path)
    argv = ["--exp_dir", str(exp), "--hf_repo_id", "x/y", "--dry-run"]
    got = upload_weights.main(argv)
    assert got == jax_upload.main(argv)
    assert got == {"llm": str(exp / "llm" / "epoch_2"), "flow": str(exp / "flow" / "epoch_2"),
                   "hift": str(exp / "hifigan" / "epoch_0_step_5"),
                   "config.json": str(exp / "config.json"),
                   "tokenizer.json": str(exp / "tokenizer.json")}
    assert "llm  <-  " in capsys.readouterr().out
    for name in ("averaged", "averaged_model", "llm_averaged"):  # each outranks those before
        (exp / "llm" / name).mkdir()
        got = upload_weights.main(argv)
        assert got == jax_upload.main(argv) and got["llm"] == str(exp / "llm" / name)
    assert upload_weights.main(argv + ["--models", "llm"]) == \
        jax_upload.main(argv + ["--models", "llm"])


def test_dry_run_takes_the_ports_averaged_file(tmp_path):
    """``train/select.py average --out flow_averaged`` writes a file, not a
    directory: the port's tool takes it before the latest checkpoint."""
    import torch

    exp = _exp(tmp_path)
    save_checkpoint(str(exp / "flow"), "flow_averaged", {"w": torch.ones(2)},
                    {"averaged_from": ["epoch_1", "epoch_2"]})
    assert upload_weights.find_best_checkpoint(str(exp / "flow")) == \
        str(exp / "flow" / "flow_averaged")


def test_upload_without_huggingface_hub_exits_as_jax(tmp_path, jax_upload, monkeypatch):
    """Without ``huggingface_hub`` the upload stops with JAX's message
    (nothing is sent); an experiment with nothing to upload stops first."""
    exp = _exp(tmp_path)
    monkeypatch.setitem(sys.modules, "huggingface_hub", None)
    argv = ["--exp_dir", str(exp), "--hf_repo_id", "x/y"]
    with pytest.raises(SystemExit) as got:
        upload_weights.main(argv)
    with pytest.raises(SystemExit) as want:
        jax_upload.main(argv)
    assert str(got.value) == str(want.value) and "--dry-run" in str(got.value)
    with pytest.raises(SystemExit, match="nothing to upload"):
        upload_weights.main(["--exp_dir", str(tmp_path / "none"), "--hf_repo_id", "x/y"])


def test_profile_stages_prints_every_stage(tmp_path):
    """On the CPU's small config (the tiny one with the 1000-id text
    vocabulary the prefill's random ids need) every stage of JAX's tool is
    timed and printed, and ``--trace`` writes one trace a traced block and
    reports that there is no device to share."""
    import dataclasses

    from cosyvoice2_eu_torch.config import tiny_test_config

    cfg = tiny_test_config()
    cfg = dataclasses.replace(cfg, llm=dataclasses.replace(
        cfg.llm, backbone=dataclasses.replace(cfg.llm.backbone, vocab_size=1000)))
    lines = []
    out = profile_stages.run(cfg, device="cpu", trace_dir=str(tmp_path / "trace"),
                             compute_dtype="float32", log=lines.append)
    stages = ["lm_prefill(256)", "lm_decode 100 steps", "lm_decode next 100 steps",
              "flow_inference(tok_bucket=1024, mel=2048)", "flow_inference(tok_bucket=128)",
              "hift(2048 mel)", "hift(256 mel)"]
    assert [k for k in out if k != "trace"] == stages
    assert all(out[k] > 0 for k in stages)
    assert all(any(line.startswith(f"{k}: ") for line in lines) for k in stages)
    assert set(out["trace"]) == {"decode", "flow"}
    for s in out["trace"].values():
        assert s["busy_share"] is None and s["device_events"] == 0 and s["wall_ms"] > 0
    assert len(os.listdir(tmp_path / "trace")) == 2
    assert sum("no device events" in line for line in lines) == 2


def test_device_trace_writes_a_chrome_trace(tmp_path):
    """``device_trace`` profiles its block and writes a Chrome trace that
    holds the block's operators."""
    import torch

    with profiling.device_trace(str(tmp_path)) as prof:
        a = torch.ones(64, 64)
        (a @ a).sum()
    files = os.listdir(tmp_path)
    assert len(files) == 1 and files[0].endswith(".json")
    assert prof.trace_path == str(tmp_path / files[0])
    events = json.loads((tmp_path / files[0]).read_text())["traceEvents"]
    assert any("aten::mm" in str(e.get("name")) for e in events)
    assert any(k.key == "aten::mm" for k in prof.key_averages())


def test_log_rtf_and_stage_timer_log_match_jax(monkeypatch, caplog):
    """``log_rtf`` returns JAX's value (elapsed over audio seconds, with
    JAX's floor on the audio) and logs JAX's line; ``StageTimer.log`` logs
    the summary."""
    monkeypatch.setattr(time, "time", lambda: 1000.0)
    with caplog.at_level(logging.INFO):
        for start, audio in ((990.0, 4.0), (999.5, 0.0), (1000.0, 2.5)):
            got = profiling.log_rtf(start, audio, tag="t")
            assert got == jax_profiling.log_rtf(start, audio, tag="t")
        timer = profiling.StageTimer()
        with timer.stage("flow"):
            pass
        timer.log("req")
    assert np.isclose(profiling.log_rtf(990.0, 4.0), 2.5)
    msgs = [r.getMessage() for r in caplog.records]
    assert msgs[0] == msgs[1] == "t: yield speech len 4.00s, rtf 2.5000"
    assert msgs[-1].startswith("req: {'flow': {'total_s'")
