"""The port's trainer command line (tiny config, CPU, synthetic parquet):
``load_config`` against the JAX package's, ``train.main`` end to end for
the LM (plain, ``--lora`` from ``--init_checkpoint``, ``--dpo``) and the
flow with ``--resume``, ``train_gan.main`` on one batch, ``select``, the
host-side distributed guards and ``Executor.on_step``."""

import dataclasses
import json
import logging
import os
import time

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from cosyvoice2_eu_torch import config as port_config
from cosyvoice2_eu_torch.parallel import distributed as dist
from cosyvoice2_eu_torch.train import executor as port_executor
from cosyvoice2_eu_torch.train import select as port_select
from cosyvoice2_eu_torch.train import train as port_train
from cosyvoice2_eu_torch.train import train_gan as port_train_gan
from cosyvoice2_eu_torch.utils.profiling import StageTimer
from cosyvoice2_eu_tpu import config as jax_config


def _tiny16(cfg_mod):
    """The tiny config with 16 mel bins, the tiny flow's and HiFT's width."""
    cfg = cfg_mod.tiny_test_config()
    return dataclasses.replace(cfg, mel=dataclasses.replace(cfg.mel, num_mels=16))


# ---------------------------------------------------------------------------
# load_config
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["whole", "partial", "overrides", "file_and_overrides", "none"])
def test_load_config_matches_jax(tmp_path, case):
    whole = jax_config.config_to_dict(jax_config.tiny_test_config())
    partial = {"llm": {"top_p": 0.9, "backbone": {"num_layers": 3}}, "chunk_size": 50,
               "hift": {"f0_predictor": {"num_layers": 2}, "upsample_rates": [8, 5, 3]}}
    overrides = {"flow": {"encoder": {"num_blocks": 1}}, "mel": {"num_mels": 16}}
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(whole if case == "whole" else partial))
    kw = {"whole": dict(path=str(path)), "partial": dict(path=str(path)),
          "overrides": dict(overrides=overrides),
          "file_and_overrides": dict(path=str(path), overrides=overrides), "none": {}}[case]
    got = port_config.config_to_dict(port_config.load_config(**kw))
    want = jax_config.config_to_dict(jax_config.load_config(**kw))
    assert got == want
    if case == "whole":
        assert port_config.load_config(**kw) == port_config.tiny_test_config()


# ---------------------------------------------------------------------------
# the command lines
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """One parquet shard of 6 utterances (1.1-1.9 s at 24 kHz, tokens at 25
    Hz, rejected continuations, 192-d embeddings), its list file and the
    tiny config's JSON (16 mel bins)."""
    root = tmp_path_factory.mktemp("cli")
    rng = np.random.default_rng(0)
    rows = {k: [] for k in ("utt", "text", "speech", "sample_rate", "speech_token",
                            "reject_speech_token", "utt_embedding", "spk_embedding")}
    for i in range(6):
        n = int(rng.integers(26400, 45600))
        t = np.arange(n) / 24000
        wav = 0.3 * np.sin(2 * np.pi * rng.uniform(110, 240) * t) + rng.standard_normal(n) * 0.02
        rows["utt"].append(f"utt{i}")
        rows["text"].append("bonjour le monde")
        rows["speech"].append(wav.astype(np.float32).tolist())
        rows["sample_rate"].append(24000)
        rows["speech_token"].append(rng.integers(0, 81, n // 960).astype(np.int32).tolist())
        rows["reject_speech_token"].append(rng.integers(0, 81, n // 960).astype(np.int32).tolist())
        rows["utt_embedding"].append(rng.standard_normal(192).astype(np.float32).tolist())
        rows["spk_embedding"].append(rng.standard_normal(192).astype(np.float32).tolist())
    shard = root / "shard_0.parquet"
    pq.write_table(pa.table(rows), str(shard))
    lst = root / "data.list"
    lst.write_text(str(shard) + "\n")
    gan_shard = root / "gan_0.parquet"  # two utterances: one small GAN batch
    pq.write_table(pa.table({k: v[:2] for k, v in rows.items()}), str(gan_shard))
    gan_lst = root / "gan.list"
    gan_lst.write_text(str(gan_shard) + "\n")
    cfg = root / "tiny.json"
    cfg.write_text(json.dumps(port_config.config_to_dict(_tiny16(port_config))))
    return {"list": str(lst), "gan_list": str(gan_lst), "config": str(cfg), "root": root}


def _common(data, model, model_dir, frames, max_epoch=1, device="cpu"):
    return ["--model", model, "--train_data", data["list"], "--cv_data", data["list"],
            "--config", data["config"], "--max_epoch", str(max_epoch), "--max_frames_in_batch",
            str(frames), "--seed", "3", "--device", device, "--model_dir", str(model_dir)]


def _infos(model_dir):
    return {i["tag"]: i for i in port_executor.list_checkpoints(str(model_dir))}


@pytest.fixture(scope="module")
def llm_runs(data):
    """train.main for the LM: plain, LoRA from the plain run's checkpoint, DPO."""
    root = data["root"]
    out = {}
    for mode, extra in (("plain", []), ("lora", ["--lora", "--init_checkpoint",
                                                 str(root / "exp_plain" / "epoch_0_whole")]),
                        ("dpo", ["--dpo"])):
        model_dir = root / f"exp_{mode}"
        out[mode] = port_train.main(_common(data, "llm", model_dir, 100000) + extra)
        out[mode]["dir"] = model_dir
    return out


@pytest.mark.parametrize("mode", ["plain", "lora", "dpo"])
def test_train_main_llm_modes(llm_runs, mode):
    run = llm_runs[mode]
    infos = _infos(run["dir"])
    assert set(infos) == {"epoch_0_whole"}
    info = infos["epoch_0_whole"]
    assert info["step"] == run["executor"].step == 1 and info["has_opt"]
    assert np.isfinite(info["cv_loss"])
    assert run["beats"] == 1  # the watchdog saw the step
    saved = torch.load(str(run["dir"] / "epoch_0_whole"), weights_only=True)
    if mode == "lora":  # rank-8 adapters (over the plain run's weights)
        assert set(saved) == {"layers"} and saved["layers"][0]["q_proj"]["A"].shape == (8, 64)
    assert os.listdir(run["dir"] / "tb")  # the tensorboard sink wrote its events


def test_train_main_flow_with_resume(data, tmp_path):
    """At least two steps an epoch (a budget of 400 mel frames a batch); the
    resumed run continues at epoch 1 with the restored step count and
    optimizer state."""
    model_dir = tmp_path / "exp_flow"
    args = _common(data, "flow", model_dir, 400)
    timer = StageTimer()
    first = port_train.run(port_train.parse_args(args), _opener(), timer)
    steps = first["executor"].step
    assert steps >= 2 and timer.counts["step"] == steps and timer.counts["cv_step"] >= 1
    info0 = _infos(model_dir)["epoch_0_whole"]
    assert info0["step"] == steps and np.isfinite(info0["cv_loss"])
    resumed = port_train.main(_common(data, "flow", model_dir, 400, max_epoch=2) + ["--resume"])
    infos = _infos(model_dir)
    assert set(infos) == {"epoch_0_whole", "epoch_1_whole"}
    assert infos["epoch_0_whole"]["save_time"] == info0["save_time"]
    assert resumed["executor"].step == infos["epoch_1_whole"]["step"] == 2 * steps
    assert resumed["beats"] == steps
    # the optimizer state went on from the checkpoint: 2 x steps micro-steps
    opt = torch.load(str(model_dir / "epoch_1_whole-opt"), weights_only=True)
    assert opt["gradient_step"] * 4 + opt["mini_step"] == 2 * steps


def test_train_main_llm_on_a_moe_backbone(data, tmp_path, monkeypatch):
    """``--config`` with a deepseek_v3 backbone (1 dense + 2 MoE layers, 16
    experts of which 4 held): the trainer logs every step (the routes stay
    out of the log), its checkpoint holds the trained tree without the
    routers' biases, and ``--init_checkpoint`` starts a second run from it."""
    tiny = _tiny16(port_config)
    backbone = port_config.DeepseekV3Config(
        vocab_size=tiny.llm.backbone.vocab_size, hidden_size=64, intermediate_size=128,
        moe_intermediate_size=24, num_layers=3, num_heads=4, kv_lora_rank=32,
        qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16, n_routed_experts=16,
        num_experts_per_tok=3, n_shared_experts=1, held_experts=4)
    cfg = tmp_path / "moe.json"
    cfg.write_text(json.dumps(port_config.config_to_dict(dataclasses.replace(
        tiny, llm=dataclasses.replace(tiny.llm, backbone=backbone)))))
    monkeypatch.setattr(port_train, "TrainConfig",
                        lambda **kw: port_config.TrainConfig(log_interval=1, **kw))
    logged = []

    class Logger:
        __call__, close = logged.append, lambda self: None

    monkeypatch.setattr(port_train, "make_logger", lambda *a, **k: Logger())
    common = lambda d: _common(dict(data, config=str(cfg)), "llm", tmp_path / d, 100000)  # noqa: E731
    first = port_train.main(common("a"))
    assert first["executor"].step == 1 and [m["step"] for m in logged] == [1]
    assert logged[0]["balance_loss"] > 0 and "routes" not in logged[0]
    saved = torch.load(str(tmp_path / "a" / "epoch_0_whole"), weights_only=True)
    assert "e_score_correction_bias" not in saved["backbone"]
    second = port_train.main(common("b") + ["--init_checkpoint",
                                             str(tmp_path / "a" / "epoch_0_whole")])
    assert second["executor"].step == 1 and len(logged) == 2


def _opener():
    from cosyvoice2_eu_torch.train import dataset as ds

    return lambda list_path, epoch: ds.parquet_opener(ds.shard_list(
        port_train.read_list(list_path), 0, 1, epoch))


def test_train_main_refuses_what_is_not_ported(data, tmp_path, monkeypatch):
    """``hifigan`` belongs to ``train_gan``.  Since multi-process training
    is ported (tests/test_torch_distributed.py), what is refused is a
    layout the processes cannot make: ``--fsdp 2`` in one process, and a
    ``WORLD_SIZE`` of 2 whose process group cannot form (no rendezvous
    address): that raises and never falls back to one process."""
    with pytest.raises(SystemExit, match="train_gan"):
        port_train.main(_common(data, "hifigan", tmp_path / "g", 400))
    with pytest.raises(ValueError, match=r"fsdp\(2\) != world size \(1\)"):
        port_train.main(_common(data, "flow", tmp_path / "f", 400) + ["--fsdp", "2"])
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    with pytest.raises(ValueError, match="MASTER_ADDR"):
        port_train.main(_common(data, "flow", tmp_path / "f", 400))
    assert not torch.distributed.is_initialized()


def test_train_main_raises_without_a_gpu_unless_asked_for_the_cpu(data, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_train.main(_common(data, "flow", tmp_path / "f", 400, device="cuda"))


def test_train_gan_main_one_batch(data, tmp_path, monkeypatch):
    """``train_gan.main`` on a shard of two utterances (its command line has no --config: the
    tiny config stands in for TTSConfig): one batch of 24480-sample crops
    with F0 targets, a discriminator turn and a generator turn, and the
    epoch's checkpoint of both networks."""
    monkeypatch.setattr(port_train_gan, "TTSConfig", lambda: _tiny16(port_config))
    seen = []
    make = port_train_gan.make_gan_steps

    def spy(cfg, tx_g, tx_d, mesh=None):
        assert mesh is None  # one process: no data-parallel mesh
        gen_step, disc_step = make(cfg, tx_g, tx_d, mesh)

        def g(*a):
            out = gen_step(*a)
            seen.append(("gen", a[3]["speech"].shape, float(out[2]["loss"])))
            return out

        def d(*a):
            out = disc_step(*a)
            seen.append(("disc", a[3]["speech"].shape, float(out[2]["loss"])))
            return out

        return g, d

    monkeypatch.setattr(port_train_gan, "make_gan_steps", spy)
    model_dir = tmp_path / "exp_gan"
    port_train_gan.main(["--train_data", data["gan_list"], "--model_dir", str(model_dir),
                         "--max_epoch", "1", "--seed", "0", "--device", "cpu"])
    assert [s[0] for s in seen] == ["disc", "gen"]
    assert all(s[1] == (2, 24480) and np.isfinite(s[2]) for s in seen)
    info = _infos(model_dir)["epoch_0_whole"]
    assert info["step"] == 1 and not info["has_opt"]
    saved = torch.load(str(model_dir / "epoch_0_whole"), weights_only=True)
    assert set(saved) == {"generator", "discriminator"}


# ---------------------------------------------------------------------------
# select
# ---------------------------------------------------------------------------

def _write_checkpoints(model_dir):
    trees = {}
    for i, cv in enumerate((0.7, 0.3, 0.5, None)):
        tree = {"w": torch.full((2, 3), float(i)), "b": [torch.tensor([i, -i], dtype=torch.float32)]}
        info = {"epoch": i, "step": 10 * i}
        if cv is not None:
            info["cv_loss"] = cv
        port_executor.save_checkpoint(str(model_dir), f"epoch_{i}_whole", tree, info)
        trees[i] = tree
    return trees


def test_select_best_and_average(tmp_path, capsys):
    model_dir = tmp_path / "exp"
    model_dir.mkdir()
    _write_checkpoints(model_dir)
    best = port_select.main(["best", "--model_dir", str(model_dir)])
    assert best["tag"] == "epoch_1_whole" and best["cv_loss"] == 0.3
    assert json.loads(capsys.readouterr().out)["tag"] == "epoch_1_whole"
    out = port_select.main(["average", "--model_dir", str(model_dir), "--num", "2"])
    assert out == {"tag": "averaged_top2", "averaged_from": ["epoch_1_whole", "epoch_2_whole"]}
    avg = torch.load(str(model_dir / "averaged_top2"), weights_only=True)
    assert torch.equal(avg["w"], torch.full((2, 3), 1.5))
    assert torch.equal(avg["b"][0], torch.tensor([1.5, -1.5]))
    # the average has no CV loss: never itself the best, nor the latest
    assert port_select.select_best(str(model_dir))["tag"] == "epoch_1_whole"
    assert port_executor.latest_checkpoint(str(model_dir))["tag"] == "epoch_3_whole"


def test_select_on_a_directory_without_checkpoints_raises(tmp_path):
    with pytest.raises(ValueError, match="no checkpoints with cv_loss"):
        port_select.select_best(str(tmp_path))
    with pytest.raises(ValueError):
        port_select.main(["average", "--model_dir", str(tmp_path)])


# ---------------------------------------------------------------------------
# the host-side distributed guards and Executor.on_step
# ---------------------------------------------------------------------------

def test_init_distributed_single_process(monkeypatch):
    monkeypatch.delenv("RANK", raising=False)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert dist.init_distributed() == (0, 1)
    tree = {"a": 1}
    assert dist.broadcast_from_host0(tree) is tree
    dist.host_barrier("x")


def test_join_uneven_inputs_breaks_together():
    """When any process runs dry, every process stops at the same step."""
    peer_remaining = {"n": 3}

    def agree(mine):
        peer = peer_remaining["n"] > 0
        peer_remaining["n"] -= 1
        return mine and peer

    assert list(dist.join_uneven_inputs(iter(range(5)), agree_fn=agree, tag="t")) == [0, 1, 2]
    assert list(dist.join_uneven_inputs(iter([]), agree_fn=lambda m: m, tag="t")) == []
    assert list(dist.join_uneven_inputs(iter(range(4)))) == [0, 1, 2, 3]


def test_straggler_guard_detects_stall(caplog):
    with caplog.at_level(logging.ERROR):
        with dist.StragglerGuard(timeout_s=0.3, tag="unit", first_beat_grace_s=0.1) as g:
            g.beat(1)
            time.sleep(1.2)  # no further beats -> the watchdog fires
    assert any("NO step progress" in r.message for r in caplog.records)
    assert not g._thread.is_alive()


def test_straggler_guard_quiet_when_beating():
    records = []
    handler = logging.Handler()
    handler.emit = lambda r: records.append(r)
    logging.getLogger().addHandler(handler)
    try:
        with dist.StragglerGuard(timeout_s=0.6, tag="unit2", first_beat_grace_s=0.1) as g:
            for i in range(6):
                g.beat(i)
                time.sleep(0.1)
    finally:
        logging.getLogger().removeHandler(handler)
    assert not any("NO step progress" in r.getMessage() for r in records)
    assert g.beats == 6


def test_executor_calls_on_step_after_each_step(tmp_path):
    from cosyvoice2_eu_torch.parallel.train_step import TrainState

    seen = []
    ex = port_executor.Executor(port_config.TrainConfig(log_interval=100, save_per_step=0),
                                lambda s, b: (TrainState(s.params, s.opt_state, s.step + 1),
                                              {"loss": torch.tensor(0.0)}),
                                model_dir=str(tmp_path))
    ex.on_step = seen.append
    state = ex.train_epoch(TrainState({"w": torch.zeros(1)}, {}, 0), [{"x": torch.zeros(1)}] * 3)
    assert seen == [1, 2, 3] and state.step == 3
