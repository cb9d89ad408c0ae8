"""The port's command line (``cosyvoice2_eu_torch/cli.py``) and the hub
snapshot of ``load`` on the CPU, with ``load`` and ``snapshot_download``
monkeypatched: nothing is downloaded."""

import dataclasses
import os
import sys
import wave

import jax
import numpy as np
import pytest
from test_torch_aux_models import _perturbed_bn
from test_torch_frontend import PCAM, PTOK, _mel_at_flow_width, write_wav
from torch_parity import jax_tts_params, to_numpy

import cosyvoice2_eu_torch as port
from cosyvoice2_eu_torch import cli
from cosyvoice2_eu_torch.config import tiny_test_config as port_tiny
from cosyvoice2_eu_torch.frontend import frontend as port_fe
from cosyvoice2_eu_torch.runtime import model as port_model
from cosyvoice2_eu_tpu.config import tiny_test_config
from cosyvoice2_eu_tpu.models import campplus as jax_cam
from cosyvoice2_eu_tpu.models import speech_tokenizer as jax_st

PCFG = _mel_at_flow_width(port_tiny())


@pytest.fixture(scope="module")
def weights():
    st = to_numpy(jax_st.init_speech_tokenizer(jax.random.key(0), dataclasses.replace(
        jax_st.tiny_tokenizer_config(), fsq_dim=4)))
    cam = _perturbed_bn(to_numpy(jax_cam.init_campplus(jax.random.key(1), dataclasses.replace(
        jax_cam.tiny_campplus_config(), embedding_size=192))), np.random.default_rng(5))
    return to_numpy(jax_tts_params(tiny_test_config(), seed=0)), st, cam


def _api(weights):
    """A tiny model on the CPU with a wav-capable frontend; two calls give
    two equal models."""
    params, st, cam = weights
    pm = port_model.TTSModel(PCFG, params, seed=7, compute_dtype=None, device="cpu")
    fe = port_fe.Frontend(PCFG, speech_tokenizer_fn=port_fe.make_speech_tokenizer_fn(
        st, PTOK, device="cpu"), spk_embedding_fn=port_fe.make_spk_embedding_fn(
        cam, PCAM, device="cpu"), device="cpu")
    return port.Cosy2EU(pm, fe, PCFG)


@pytest.fixture
def fake_load(monkeypatch, weights):
    """``load`` replaced by the tiny model; records its keyword arguments."""
    calls = []

    def load(**kw):
        calls.append(kw)
        return _api(weights)

    monkeypatch.setattr(port, "load", load)
    monkeypatch.setattr(cli, "_cached_model", None)
    monkeypatch.setattr(cli, "_cached_key", None)
    return calls


def _read(path):
    with wave.open(path, "rb") as w:
        assert (w.getnchannels(), w.getsampwidth(), w.getframerate()) == (1, 2, 24000)
        return np.frombuffer(w.readframes(w.getnframes()), np.int16)


@pytest.mark.parametrize("stream", [False, True])
def test_main_writes_what_cosy2eu_synthesizes(fake_load, weights, tmp_path, stream):
    """``main`` on a wav prompt with the CPU asked for: the file holds
    ``save_wav`` of the same model's ``tts`` (or joined ``stream``) output,
    and ``load`` got the flags."""
    prompt = write_wav(tmp_path / "prompt.wav", 0.4, seed=1)
    out = str(tmp_path / "out" / "a.wav")
    argv = ["--text", "Il y a 3 chats.", "--prompt", prompt, "--out", out, "--device", "cpu",
            "--text-frontend", "--prompt-text", "Salut.", "--mode", "zero_shot",
            "--model-dir", str(tmp_path), "--backbone", "blanken"]
    cli.main(argv + (["--stream"] if stream else []))
    kw = dict(prompt_text="Salut.", text_frontend=True, mode="zero_shot")
    ref = _api(weights)
    audio = np.concatenate([c[0] for c in ref.stream("Il y a 3 chats.", prompt, **kw)]) \
        if stream else ref.tts("Il y a 3 chats.", prompt, **kw)[0][0]
    cli.save_wav(str(tmp_path / "want.wav"), audio, 24000)
    np.testing.assert_array_equal(_read(out), _read(str(tmp_path / "want.wav")))
    assert len(_read(out)) == ref._model.last_n_tokens * 960
    assert fake_load == [dict(model_dir=str(tmp_path), setting="llm_flow_hifigan",
                              llm_run_id=None, flow_run_id=None, hifigan_run_id=None,
                              final=None, backbone="blanken", device="cpu")]


def test_main_keeps_one_model(fake_load, tmp_path):
    """The same flags reuse the cached model; ``--clear-cache`` loads anew."""
    prompt = write_wav(tmp_path / "prompt.wav", 0.4, seed=2)
    argv = ["--text", "Oui.", "--prompt", prompt, "--out", str(tmp_path / "o.wav"),
            "--device", "cpu"]
    cli.main(argv)
    cli.main(argv)
    assert len(fake_load) == 1
    cli.main(argv + ["--clear-cache"])
    assert len(fake_load) == 2


def test_save_wav_clips_to_16_bit(tmp_path):
    cli.save_wav(str(tmp_path / "x.wav"), np.array([-2.0, -1.0, 0.0, 0.5, 1.0, 3.0]), 24000)
    np.testing.assert_array_equal(_read(str(tmp_path / "x.wav")),
                                  [-32767, -32767, 0, 16383, 32767, 32767])


def test_main_paths_not_in_the_port_raise(tmp_path):
    """``warmup`` (ROADMAP item 10).  Alternative backbones are ported now:
    ``test_main_passes_the_backbone_to_load``."""
    with pytest.raises(NotImplementedError, match="ROADMAP item 10"):
        cli.main(["warmup"])


def test_main_passes_the_backbone_to_load(fake_load, tmp_path):
    """``--backbone hf:Qwen/Qwen3-0.6B`` reaches ``load`` as the JAX CLI passes it."""
    prompt = write_wav(tmp_path / "prompt.wav", 0.4, seed=3)
    cli.main(["--text", "Oui.", "--prompt", prompt, "--out", str(tmp_path / "o.wav"),
              "--device", "cpu", "--backbone", "hf:Qwen/Qwen3-0.6B"])
    assert fake_load[0]["backbone"] == "hf:Qwen/Qwen3-0.6B"


def test_snapshot_download_contract(tmp_path, monkeypatch):
    """Downloads into ``$COSY2EU_CACHE``; offline and opportunistic: None, or
    the snapshot cached earlier; required: the failure surfaces."""
    import huggingface_hub

    target = tmp_path / "hub_cache"
    monkeypatch.setenv("COSY2EU_CACHE", str(target))
    calls = {}

    def fake_snapshot(repo_id, local_dir, **kw):
        calls["repo_id"], calls["local_dir"] = repo_id, local_dir
        os.makedirs(local_dir, exist_ok=True)

    monkeypatch.setattr(huggingface_hub, "snapshot_download", fake_snapshot)
    assert port._snapshot_download("hi-paris/CosyVoice2-0.5B-EU") == str(target)
    assert calls == {"repo_id": "hi-paris/CosyVoice2-0.5B-EU", "local_dir": str(target)}

    def failing_snapshot(*a, **kw):
        raise OSError("no network")

    monkeypatch.setattr(huggingface_hub, "snapshot_download", failing_snapshot)
    assert port._snapshot_download("x/y") is None
    with pytest.raises(OSError):
        port._snapshot_download("x/y", required=True)
    (target / "llm.pt").write_bytes(b"")
    assert port._snapshot_download("x/y") == str(target)


def test_snapshot_download_without_the_hub_client(monkeypatch):
    monkeypatch.setitem(sys.modules, "huggingface_hub", None)  # import fails
    assert port._snapshot_download("x/y") is None
    with pytest.raises(ImportError, match="huggingface_hub"):
        port._snapshot_download("x/y", required=True)


class _Stop(Exception):
    pass


@pytest.mark.parametrize("download,required", [(None, False), (True, True), (False, None)])
def test_load_fetches_the_snapshot_only_without_weights(monkeypatch, download, required):
    """With no model_dir, config or params, ``load`` asks for the snapshot
    (required when ``download=True``); ``download=False`` goes straight to
    random weights.  Both are stopped before any model is built."""
    import cosyvoice2_eu_torch.models.llm as port_llm

    seen = []

    def fake(repo_id, required=False):
        seen.append((repo_id, required))
        raise _Stop

    def no_init(*a, **kw):
        raise _Stop

    monkeypatch.setattr(port, "_snapshot_download", fake)
    monkeypatch.setattr(port_llm, "init_lm", no_init)
    with pytest.raises(_Stop):
        port.load(device="cpu", download=download, repo_id="a/b")
    assert seen == ([] if required is None else [("a/b", required)])  # None: not asked
    with pytest.raises(_Stop):  # weights given: never a download
        port.load(device="cpu", download=download, config=port_tiny())
    assert len(seen) == (0 if required is None else 1)
